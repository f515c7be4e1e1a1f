"""The port's bench entry points (dcora_tpu_torch.tools.{spmm_bench,
spmm_ab,hotloop_bench,bench,profile_slice,btd_bench}) on the CPU: what they can show
without a card.  Both read .g2o and .pyfg inputs (tools.common.load_graph),
and report what Q holds (tools.common.q_stats).  Every
backend that spmm_bench times computes the plain tile path's W (its plain
versions here, at tolerance 1e-12 of max|W| in f64 and F32_ATOL in f32),
the CPU baseline of bench runs and is cached where asked, and each tool
refuses to measure without CUDA."""

import numpy as np
import pytest
import torch

import dcora_tpu_torch.core.tiled as ttiled
from dcora_tpu_torch import datasets
from dcora_tpu_torch.io import read_g2o_file
from dcora_tpu_torch.tools import (
    bench,
    btd_bench,
    common,
    hotloop_bench,
    profile_slice,
    spmm_ab,
    spmm_bench,
)
from torch_port_common import F32_ATOL, assert_close, build_graphs, \
    random_graph_spec


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spmm_bench_backends_agree(dtype):
    rng = np.random.default_rng(9)
    _, gt = build_graphs(random_graph_spec(rng, n=110, l=8, b=4))
    TP = ttiled.build_tiled(gt.problem_data(), gt.dims, dtype=dtype,
                            pack="bucketed")
    X = torch.as_tensor(rng.standard_normal((8, TP.meta.kpad)), dtype=dtype)
    backends = spmm_bench.layouts(TP, X)
    assert len(backends) == 6
    ref = backends["plain tile path"][0]()
    for label, (fn, nbytes) in backends.items():
        assert nbytes > 0, label
        assert_close(fn(), ref, rtol=1e-12 if dtype == torch.float64
                     else F32_ATOL)
    # the sub-block layouts read a small part of the dense tiles' bytes
    tile_bytes = backends["plain tile path"][1]
    kernels = [k for k in backends if "kernel" in k]
    assert [k.split(",")[0][-1] for k in kernels] == ["1", "2", "3", "3"]
    assert all(backends[k][1] < tile_bytes / 4 for k in kernels)
    rows, cols, tiles = spmm_bench.padded_tile_list(TP.Q)
    assert rows.dtype == torch.int32 and rows.shape[0] % 8 == 0
    assert not tiles[TP.Q.tiles.shape[0]:].any()


def test_bench_cpu_baseline_is_cached(tmp_path, monkeypatch):
    path = datasets.generate_grid_g2o(str(tmp_path / "g.g2o"),
                                      shape=(3, 3, 3), seed=2)
    cache = tmp_path / "build" / "bench_baseline.json"
    monkeypatch.setattr(bench, "BASELINE_CACHE", str(cache))
    ds = read_g2o_file(path)
    t = bench.cpu_baseline(ds, path)
    assert t > 0 and cache.exists()
    monkeypatch.setattr(bench, "measure_cpu_baseline",
                        lambda *a: pytest.fail("not cached"))
    assert bench.cpu_baseline(ds, path) == t


def test_tools_refuse_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "missing.g2o")
    for call in (lambda: spmm_bench.run(path),
                 lambda: spmm_ab.run(str(tmp_path), str(tmp_path / "ab")),
                 lambda: hotloop_bench.run(path),
                 lambda: bench.run(path),
                 lambda: btd_bench.main([path])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_load_graph_reads_g2o_and_pyfg(tmp_path):
    """A .pyfg file gives the global RA graph (spheres and landmarks in Q)
    and its Q statistics; a .g2o file the PGO graph."""
    g2o = datasets.generate_grid_g2o(str(tmp_path / "g.g2o"),
                                     shape=(3, 3, 3), seed=2)
    pyfg = common.ra_set(str(tmp_path), 8)
    assert pyfg.endswith("ra40.pyfg")
    gp, gr = common.load_graph(g2o, 5), common.load_graph(pyfg, 3)
    assert (gp.n, gp.l, gp.b, gp.r) == (27, 0, 0, 5)
    assert (gr.n, gr.l, gr.b, gr.r) == (40, 52, 4, 3)
    assert not gr.is_pgo_compatible()
    stats = {}
    for name, g in (("grid", gp), ("ra", gr)):
        TP = ttiled.build_tiled(g.problem_data(), g.dims, dtype=torch.float32)
        stats[name] = common.q_stats(TP)
        Q = TP.Q
        assert stats[name]["stored_tiles"] == Q.tiles.shape[0]
        assert stats[name]["stored_nnz"] == int((Q.tiles != 0).sum())
        assert stats[name]["blocks"] == Q.strips.src.shape[0]
        assert stats[name]["strips"] == TP.meta.kpad // 4
        assert 0 < stats[name]["strip_mb"] < Q.tiles.numel() * 4 / 1e6
    assert stats["ra"]["k"] == 4 * 40 + 52 + 4


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_btd_bound(dtype):
    """The BTD solve's bound at ra10k's nt = 366: bytes (the two [nt, T,
    T] factors) dominate at r_pad 8, operations grow with r_pad."""
    dt = getattr(torch, dtype)
    esize = 4 if dtype == "float32" else 8
    ms, by = common.btd_bound_ms(366, 128, 8, dt, 3350.0)
    assert by == "bytes"
    expect = (2 * 366 * 128 * 128 + 2 * 8 * 366 * 128) * esize / 3350e6
    np.testing.assert_allclose(ms, expect, rtol=1e-12)
    ms_ops, by_ops = common.btd_bound_ms(366, 128, 512, dt, 3350.0)
    assert by_ops == "operations"
    np.testing.assert_allclose(
        ms_ops, 3 * 366 * 2 * 512 * 128 * 128 / common.PEAK_FLOPS[dt] * 1e3,
        rtol=1e-12)


def test_profile_slice_refuses_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], [str(tmp_path / "ra.pyfg")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_slice.main(argv)


def test_solve_pgo_defaults_to_the_card(tmp_path, monkeypatch):
    """solvers.solve_pgo runs on the card unless the CPU is asked for, and
    raises when CUDA is absent."""
    from dcora_tpu_torch.solvers import solve_pgo

    path = datasets.generate_grid_g2o(str(tmp_path / "g.g2o"),
                                      shape=(2, 2, 2), seed=2)
    ms = read_g2o_file(path).pose_pose_measurements
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_pgo(ms)
    T = solve_pgo(ms, device="cpu")
    assert T.shape == (8, 3, 4) and np.isfinite(T).all()
