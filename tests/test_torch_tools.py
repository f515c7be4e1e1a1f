"""The port's bench entry points (dcora_tpu_torch.tools.{spmm_bench,
spmm_ab,hotloop_bench,bench}) on the CPU: what they can show without a card.  Every
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
from dcora_tpu_torch.tools import bench, hotloop_bench, spmm_ab, spmm_bench
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
    assert all(backends[k][1] < tile_bytes / 4 for k in backends
               if "kernel 1" in k or "kernel 3" in k)
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
                 lambda: bench.run(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
