"""The certificate's supernodal LDL^T (core/ldlt.py) on the CPU: the
analysis, the plain factorization csrc/ldlt.cu is held to, and the proof's
dispatch in core/certify.py.

  * The analysis: the ordering is a permutation that keeps every node's
    columns adjacent, the supernodes partition the columns, each front's
    rows lie in its parent's front, fronts alive at once do not share
    storage, the schedule covers every panel once and level by level, and
    the predicted nnz(L) is what the plain factorization stores, whose
    L D L^T is S + tI permuted.
  * The plain factorization's verdict is SuperLU's (ldl_psd_proof), and
    its negative pivots are numpy.linalg.eigvalsh's negative eigenvalues,
    on S of a small grid PGO and of a small range-aided problem at four
    shifts: S + tI positive definite, indefinite with one negative
    eigenvalue, and the two ends of the inertia bracket.
  * The bracket of _inertia_bracket_min_eig is the same through both
    factorizations; one analysis serves every shift.
  * On the CPU, _min_eig_host proves with SuperLU (counter "ldlt.host").
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dcora_tpu_torch import datasets
from dcora_tpu_torch.core import certify, kernels, ldlt, lifted
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
from dcora_tpu_torch.io.remap import get_global_measurements
from dcora_tpu_torch.types import GraphType
from dcora_tpu_torch.utils import timing

PROBLEMS = ["grid", "grid6", "ra"]
SHIFTS = ["pd", "one_negative", "bracket_lo", "bracket_hi"]
ETA = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_state(dims, seed):
    """A point of the manifold at rank d (random rotations, unit spheres,
    translations): its certificate S is indefinite."""
    rng = np.random.default_rng(seed)
    d = dims.d
    rot = np.linalg.qr(rng.standard_normal((dims.n, d, d)))[0]
    sph = rng.standard_normal((dims.l, d))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    trn = rng.standard_normal((dims.num_trans, d))
    return lifted.RAState(*(torch.as_tensor(a) for a in (rot, sph, trn)))


def doubled_entries(S):
    """S in CSR with every entry stored twice, each holding half of it."""
    S = S.tocsr()
    return sp.csr_matrix((np.repeat(0.5 * S.data, 2),
                          np.repeat(S.indices, 2), 2 * S.indptr),
                         shape=S.shape)


def _case(P, dims, seed):
    X = _random_state(dims, seed)
    C = certify.dual_certificate_blocks(P, X)
    S = certify._assemble_S_host(P, C, dims)
    return dict(dims=dims, S=S, an=ldlt.analyse(S, dims),
                ev=np.linalg.eigvalsh(S.toarray()))


def build_cases(tmp):
    """{name: dims, S, its analysis, its eigenvalues, the inertia bracket
    of S + ETA I} of the PROBLEMS, their files written under `tmp`."""
    out = {}
    for name, shape in (("grid", (4, 4, 3)), ("grid6", (6, 6, 6))):
        path = datasets.generate_grid_g2o(str(tmp / f"{name}.g2o"),
                                          shape=shape, rot_noise=0.05,
                                          trans_noise=0.02, seed=5)
        g = LocalGraph(0, 3, 3)
        g.set_measurements(read_g2o_file(path).pose_pose_measurements)
        out[name] = _case(g.problem_data(), g.dims, 1)
    path = datasets.generate_ra_slam_pyfg(
        str(tmp / "ra.pyfg"), num_robots=2, poses_per_robot=12,
        num_landmarks=2, range_prob=1.0, rot_noise=0.05, trans_noise=0.02,
        range_noise=0.02, seed=3)
    g = LocalGraph(0, 3, 3, GraphType.RangeAidedSLAMGraph)
    g.set_measurements(
        get_global_measurements(read_pyfg_file(path)).relative_measurements)
    assert g.dims.l > 0 and g.dims.b > 0
    out["ra"] = _case(g.problem_data(), g.dims, 2)
    for c in out.values():
        c["bracket"] = certify._inertia_bracket_min_eig(c["S"], ETA)
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return build_cases(tmp_path_factory.mktemp("ldlt"))


def _shift(c, kind):
    ev = c["ev"]
    return {"pd": -ev[0] + 1e-2 * (ev[1] - ev[0]),
            "one_negative": -0.5 * (ev[0] + ev[1]),
            "bracket_lo": c["bracket"][0],
            "bracket_hi": c["bracket"][1]}[kind]


def test_node_columns_cover_every_column_once():
    dims = certify.ProblemDims(d=3, n=5, l=4, b=2)
    ptr, cols = ldlt.node_columns(dims)
    assert np.array_equal(np.sort(cols), np.arange(dims.k))
    assert list(np.diff(ptr)) == [4] * 5 + [1] * 6
    assert list(cols[:4]) == [0, 1, 2, 3 * 5 + 4]  # pose 0: rot, trn


@pytest.mark.parametrize("name", PROBLEMS)
def test_analysis_invariants(cases, name):
    c = cases[name]
    an, k = c["an"], c["S"].shape[0]
    assert np.array_equal(np.sort(an.perm), np.arange(k))
    pinv = np.empty(k, np.int64)
    pinv[an.perm] = np.arange(k)
    ptr, cols = ldlt.node_columns(c["dims"])
    for v in range(len(ptr) - 1):
        at = np.sort(pinv[cols[ptr[v]:ptr[v + 1]]])
        assert at[-1] - at[0] == len(at) - 1, v
    ends = an.first + an.width
    assert an.first[0] == 0 and np.array_equal(an.first[1:], ends[:-1])
    assert ends[-1] == k and (an.width > 0).all()
    for s in range(len(an.first)):
        rows = an.rows[an.rows_ptr[s]:an.rows_ptr[s + 1]]
        assert (np.diff(rows) > 0).all() and (rows >= ends[s]).all()
        p = an.parent[s]
        if p < 0:
            assert len(rows) == 0
            continue
        assert an.level[p] > an.level[s] and p > s
        front = np.concatenate([np.arange(an.first[p], ends[p]),
                                an.rows[an.rows_ptr[p]:an.rows_ptr[p + 1]]])
        rel = an.rel[an.rows_ptr[s]:an.rows_ptr[s + 1]]
        assert np.array_equal(front[rel], rows)
        assert s in an.child[an.child_ptr[p]:an.child_ptr[p + 1]]
    # S's lower entries land inside their fronts, once each
    words = an.size.astype(np.int64) ** 2
    owner = np.repeat(np.arange(len(an.first)), an.width)
    s_of = owner[np.repeat(np.arange(k), np.diff(an.amap_ptr))]
    assert (an.amap_dst < words[s_of]).all()
    assert len(np.unique(an.amap_dst + s_of * words.max())) == \
        len(an.amap_dst)
    assert len(an.amap_dst) == sp.tril(
        c["S"][an.perm][:, an.perm]).nnz


@pytest.mark.parametrize("name", PROBLEMS)
def test_fronts_alive_together_share_no_storage(cases, name):
    an = cases[name]["an"]
    top = an.level.max() + 1
    until = np.where(an.parent >= 0, an.level[np.maximum(an.parent, 0)],
                     top)
    words = an.size.astype(np.int64) ** 2
    for s in range(len(an.first)):
        live = (an.level <= until[s]) & (an.level[s] <= until)
        live[s] = False
        clash = (an.off < an.off[s] + words[s]) & (an.off[s] < an.off + words)
        assert not (live & clash).any(), s
    assert an.front_words <= words.sum()


@pytest.mark.parametrize("name", PROBLEMS)
def test_schedule_covers_every_panel_once_level_by_level(cases, name):
    an = cases[name]["an"]
    jobs, launches = an.jobs.astype(np.int64), an.launches
    seen = {ldlt.ASSEMBLE: [], ldlt.PANEL: [], ldlt.UPDATE: []}
    last_level = -1
    for kind, j0, nj, tiles in launches:
        js = jobs[j0:j0 + nj]
        lv = an.level[js[:, 0]]
        assert (lv == lv[0]).all() and lv[0] >= last_level
        last_level = lv[0]
        assert js[0, 3] == 0 and (np.diff(js[:, 3]) > 0).all()
        assert tiles > js[-1, 3]
        seen[int(kind)] += [tuple(j[:3]) for j in js]
    ns = len(an.first)
    assert sorted(s for s, _, _ in seen[ldlt.ASSEMBLE]) == list(range(ns))
    want = sorted((s, p0, min(ldlt.NB, w - p0)) for s, w in
                  enumerate(an.width) for p0 in range(0, w, ldlt.NB))
    assert sorted(seen[ldlt.PANEL]) == want
    assert sorted(seen[ldlt.UPDATE]) == [
        j for j in want if j[1] + j[2] < an.size[j[0]]]


@pytest.mark.parametrize("name", PROBLEMS)
def test_plain_factor_reconstructs_S_and_stores_predicted_nnz(cases, name):
    c = cases[name]
    an, S = c["an"], c["S"]
    t = _shift(c, "pd")
    panels = {}
    piv = ldlt.factor_plain(an, torch.as_tensor(S.data), t, panels=panels)
    k = S.shape[0]
    L = np.zeros((k, k))
    stored = 0
    for s, panel in panels.items():
        f0, w = an.first[s], an.width[s]
        idx = np.concatenate([np.arange(f0, f0 + w),
                              an.rows[an.rows_ptr[s]:an.rows_ptr[s + 1]]])
        L[np.ix_(idx, np.arange(f0, f0 + w))] = panel.numpy()
        stored += int(np.tril(np.ones(panel.shape)).sum())
    assert stored == an.nnz_L
    D = np.diag(L).copy()
    assert np.array_equal(D, piv.numpy())
    np.fill_diagonal(L, 1.0)
    A = (S + t * sp.identity(k)).toarray()[np.ix_(an.perm, an.perm)]
    err = np.abs(L @ np.diag(D) @ L.T - A).max()
    assert err <= 1e-9 * np.abs(A).max(), err


@pytest.mark.parametrize("kind", SHIFTS)
@pytest.mark.parametrize("name", PROBLEMS)
def test_plain_verdict_is_superlus_and_inertia_eigvalshs(cases, name, kind):
    c = cases[name]
    S, t = c["S"], _shift(c, kind)
    piv = ldlt.factor_plain(c["an"], torch.as_tensor(S.data), t)
    superlu = certify.ldl_psd_proof(S + t * sp.identity(S.shape[0]))
    assert ldlt.verdict(piv) == superlu
    assert superlu is (kind in ("pd", "bracket_hi"))
    assert int((piv < 0).sum()) == int((c["ev"] + t < 0).sum())


@pytest.mark.parametrize("name", PROBLEMS)
def test_bracket_same_through_both_factorizations(cases, name):
    c = cases[name]
    an, vals = c["an"], torch.as_tensor(c["S"].data)
    timing.reset_counters()
    br = certify._inertia_bracket_min_eig(
        c["S"], ETA, prove=lambda t: ldlt.verdict(
            ldlt.factor_plain(an, vals, t)))
    assert br == c["bracket"]
    lo, hi = br
    assert lo <= -c["ev"][0] <= hi
    # the bracket's default oracle (the verifier's) counts no proof either
    assert certify._inertia_bracket_min_eig(c["S"], ETA) == br
    assert not any(k.startswith("ldlt.") for k in timing.counters())


def test_shifted_proof_is_cuda_only(cases):
    """The CPU's proof is SuperLU, dispatched in certify._shifted_proof."""
    c = cases["grid"]
    with pytest.raises(ValueError, match="CUDA device"):
        ldlt.ShiftedProof(c["S"], c["dims"], "cpu")


def test_analyse_refuses_duplicate_entries(cases):
    """The maps assign S's values into the fronts, so a duplicate entry
    would be lost: the analysis takes S in canonical form only."""
    c = cases["grid"]
    dup = doubled_entries(c["S"])
    assert not dup.has_canonical_format
    assert abs(dup - c["S"]).max() == 0
    with pytest.raises(ValueError, match="duplicate"):
        ldlt.analyse(dup, c["dims"])


def test_cpu_min_eig_host_proves_with_superlu(tmp_path):
    """P on the CPU: the proof is SuperLU's, as in the JAX package, and no
    analysis or kernel runs."""
    path = datasets.generate_grid_g2o(str(tmp_path / "g.g2o"),
                                      shape=(3, 3, 2), seed=3)
    g = LocalGraph(0, 3, 3)
    g.set_measurements(read_g2o_file(path).pose_pose_measurements)
    P, dims = g.problem_data(), g.dims
    X = _random_state(dims, 4)
    C = certify.dual_certificate_blocks(P, X)
    timing.reset_counters()
    before = kernels.launch_counts()["ldlt"]
    times = {}
    ok, theta, _ = certify._min_eig_host(P, C, dims, ETA, times=times)
    counts = timing.counters()
    assert not ok and theta < -ETA
    assert counts.get("ldlt.host", 0) >= 2  # the proof, then the bracket
    assert "ldlt.analyses" not in counts and "ldlt.device" not in counts
    assert kernels.launch_counts()["ldlt"] == before
    assert "certify/ldlt" in times and "certify/ldlt_analyse" not in times


@pytest.mark.parametrize("piv,want", [
    ([3.0, 1e-3, 2.0], True),
    ([3.0, -1e-3, 2.0], False),
    ([3.0, 1e-15, 2.0], None),
    ([3.0, 0.0, 2.0], None),
    ([3.0, 0.0, -2.0], None),
    ([3.0, float("nan"), 2.0], None),
    ([3.0, float("inf"), -2.0], None),
])
def test_verdict_rule(piv, want):
    assert ldlt.verdict(torch.tensor(piv, dtype=torch.float64)) is want


@pytest.mark.parametrize("bad", ["float32", "short", "strided"])
def test_kernel_wrapper_refuses_bad_values(cases, bad):
    """The checks before any pointer reaches csrc/ldlt.cu (run on the CPU:
    they raise before the library is loaded)."""
    c = cases["grid"]
    plan = ldlt.DeviceFactor(c["an"], "cpu")
    v = torch.as_tensor(c["S"].data)
    v = {"float32": v.float(), "short": v[:-1],
         "strided": torch.stack([v, v], 1)[:, 0]}[bad]
    with pytest.raises(ValueError, match="values must be"):
        plan.factor(v, 0.0)
