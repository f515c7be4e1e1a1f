"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the seven kernel libraries from ``dcora_tpu_torch/csrc/`` (the three
SpMM kernels, the edge path's deterministic segment sum, the
block-tridiagonal preconditioner solve, the flat layout's per-pose ops and
the certificate's supernodal LDL^T, which the certified solves use;
one nvcc per source, all started together; ``-Xptxas -v``'s registers and
spills are printed) and holds
every SpMM kernel against its plain PyTorch version on
the card at the 10,648-pose grid's shapes, timed in turns with the library
yardstick ``torch.sparse.mm`` on the same Q and beside the product's bound.
Before that it holds the certificate's LDL^T kernel (``csrc/ldlt.cu``,
through ``core.ldlt.DeviceFactor``) against its plain version
(``ldlt.factor_plain`` on the host, the same analysis and values) on
SE-Sync's grid3D pattern (the benchmark's 20^3 graph, k = 32,000: Q + eta I,
positive definite, and S + eta I at a random state, indefinite) and on
ra10k's S + eta I at its odometry init, pivots, negative count and verdict,
and times it at grid3D's Q + eta I beside its plain version and its bound.
Then it drives the port's paths, each with the kernels' launch counts set
to 0 just before it and read just after (a launch recorded in a CUDA graph
counts once per replay); every path that certifies must have proved its
certificate with the LDL^T kernel, whose launches are printed per path:

  * the certified single-robot PGO staircase of
    ``dcora_tpu_torch.drivers.single_robot_pgo.run(..., certify=True,
    device="cuda")`` on the generated smallGrid3D set (125 poses) and on the
    10,648-pose grid (``generate_large_scale_g2o(target_poses=10_000)``),
    through the owner-computes strip kernel (``csrc/spmm_sym.cu``), one
    launch per tile product;
  * the same certified 10,648-pose solve under ``DCORA_SPMM_PACK=paired``,
    through the grouped kernel (``csrc/spmm_grouped.cu``: the two-row packs
    and their single-row leftovers, compacted to their non-empty
    sub-blocks), one launch per tile product;
  * the bench entry points: ``tools.spmm_bench`` (every SpMM backend, the
    per-tile kernel ``csrc/spmm_tile.cu`` on the tile list's non-empty
    sub-blocks included) and ``tools.bench`` for both packs;
  * the certified single-robot RA-SLAM staircase of
    ``dcora_tpu_torch.drivers.single_robot_raslam.run(..., device="cuda")``
    at the driver's own budget on two generated PyFG sets
    (``tools.common.ra_set``): ``ra500`` (500 poses, 420 ranges) and
    ``ra10k`` (9,750 poses, 7,820 ranges, the size of the reference's
    tiers.pyfg), through the strip kernel on the range-aided tiles, one
    launch per tile product, with the block-tridiagonal preconditioner
    solved by its kernel (``csrc/btd_solve.cu``, one launch per
    application) and the edge path's tCG iterations replayed as a CUDA
    graph.  ra500 climbs
    the whole staircase and is held to certification, the independent
    LDL^T witness and the JAX package's f* (tests/data/
    torch_port_ra_reference.json); ra10k runs its first rank (it does not
    certify in a run's time).  Both are held to the independent verifier's
    cost, gradient norm and verdict;
  * the robust and multi-robot paths (tests/data/
    torch_port_robust_reference.json holds the JAX package's results on
    the same generated sets): chordal initialization of the 10,648-pose
    grid on the card against the CPU, timed both ways; the centralized GNC
    of ``drivers.single_robot_gnc.run(..., device="cuda")`` on gnc2500 (a
    2,500-pose grid with 15 % planted outliers, tools.robust_bench), whose
    every stage runs kernel 1 once per tile product, held to JAX's rejected
    set, final weights and weighted cost, with the clean-problem cost and
    the verifier's verdict printed beside JAX's, and kernel 1 against its
    plain version on its last stage's Q (zero-weight edges); one agent's
    GNC-TLS local init on a 500-pose block (kernel 1 again); DC2-PGO on
    smallGrid3D with 5 robots (certified, JAX's rank and f*); the
    distributed GNC on gnc2500 through its first weight update, held to
    JAX's costs and weights; DCORA at JAX's cuts on ra500 (no block
    optimizes there) and on ra500_nl (ra500 without its landmarks, where
    every block optimizes), held to JAX's cost per round;
  * the parallel scaling mode (tests/data/
    torch_port_parallel_reference.json): synchronous-parallel RBCD through
    ``drivers.parallel_pgo.run`` on the 10,648-pose grid in 8 agents (edge
    path and f64 tiles held to JAX's cost per round, then the driver's
    default f32 tiles timed, every batched tile product one launch of
    kernel 1 for all agents), 20 of its rounds under the profiler, kernel 1
    on the 8 agents' stacked strips against its plain version and the
    agents' own launches, ``drivers.parallel_raslam.run`` on ra500_nl and
    on ra10k_nl (ra10k without landmarks; the parallel RA mode of both
    engines cannot run a set with landmarks, and ra500 must raise JAX's
    KeyError), the round inside a one-rank NCCL group (bitwise the local
    round), the edge-sharded certificate (``parallel.certify``) against
    the central one, and ``tools.scaling_bench`` over 1-16 agents;
  * g2o100k, the 97,336-pose grid of ``generate_large_scale_g2o`` (46^3,
    k = 389,344): read by the native parser (``dcora_tpu_torch.native``),
    chordal init on the card, both ``build_tiled`` dtypes (host seconds and
    peak RSS), kernel 1 against its plain version (``spmm_strips_plain``)
    on its Q at f32 and f64 beside ``torch.sparse.mm``, the bound and the
    profiler's device time, the same for the two flat kernels (against
    their plain versions, share of the bound), then the first rank's
    solve at the ``tools.g2o100k_certify`` budget (rank 5, 200 outers x
    50 tCG), one
    launch of kernel 1 per tile product, Lambda(X) on the card and S's host
    assembly, held to the independent verifier's cost (1e-8) and gradient
    norm (the LDL^T proof and the staircase's climb run in the tool);
  * the parity harness: ``tools.parity.run_config`` on the generated
    tinyGrid3D and smallGrid3D sets, certified by the independent LDL^T
    witness.

Before the RA solves the kernel phase also holds the strip kernel against
its plain version on the ra10k Q, beside ``torch.sparse.mm`` and the bound;
the BTD phase holds the preconditioner's kernel against its plain loop
there (f32 and f64, r_pad 8, 16 and 24, two applications bitwise equal),
the flat phase the two kernels of ``csrc/flat_ops.cu`` (``flat_rhess``:
the Hessian's projection with its Weingarten term; ``flat_precond``: the
per-pose Jacobi solve with the projection) against their plain versions
on grid10k, ra10k and par_grid10k's stack of 8 agents (f32 and f64, r_pad
8 and 16, each timed; on grid10k and the stack, poses alone, the plain
version's bits) and the flat tCG's CUDA graph bitwise against its
iterations issued one by one (every flat tiled path replays it: the PGO, GNC, RA and
g2o100k tile phases and the parallel tiled rounds, each of which must
launch both kernels, or flat_rhess alone under BTD),
and the tCG phase the edge path's tCG graph against its iterations issued
one by one, and times one application or iteration of each.  The
repeat phase holds the segment-sum kernel (``csrc/segment_sum.cu``) against
its plain version (``index_add_`` on the card) on one ``apply_Q``'s three
blocks of edge contributions at ra10k rank 3, in one launch, timed beside
the three blocks launched one by one, three ``index_add_`` calls and the
bound, and checks that two runs are bitwise equal: ``apply_Q`` at ra10k
rank 3, the 200-iteration graph tCG solve, grid10k's chordal init,
DC2-PGO's ``central_eval``, kernels 2 and 3 on grid10k (r_pad 8 and 16,
f32 and f64), a flat-backend tCG through kernel 3 on grid10k's paired
f32 tiles and the BTD kernel on ra10k's tiles.  The paired solve prints
its iterate's SHA-256.

Sequential and fail-closed: every phase prints a line and any failure
raises, so the exit code is non-zero and the result line is not printed.
Imports nothing of JAX.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, "tests", "data",
                         "torch_port_pgo_reference.json")
RA_REFERENCE = os.path.join(HERE, "tests", "data",
                            "torch_port_ra_reference.json")
ROBUST_REFERENCE = os.path.join(HERE, "tests", "data",
                                "torch_port_robust_reference.json")
# name -> (poses per robot, r_max).  ra500 climbs the whole staircase.
# ra10k runs its first rank only: at the driver's budget each of its ranks
# takes 2-3 min on the card and the staircase climbed past rank 7
# uncertified (PERF.md), beyond this script's time; its rank-3 solve and
# certificate are held to the independent verifier instead
RA_SETS = {"ra500": (100, 20), "ra10k": (1950, 3)}
KERNELS = {
    "spmm_sym": dict(name="spmm_sym", route="cuda",
                     source="dcora_tpu_torch/csrc/spmm_sym.cu",
                     replaces="dcora_tpu/core/pallas_spmm.py:307"),
    "spmm_tile": dict(name="spmm_tile", route="cuda",
                      source="dcora_tpu_torch/csrc/spmm_tile.cu",
                      replaces="dcora_tpu/core/pallas_spmm.py:37"),
    "spmm_paired": dict(name="spmm_paired", route="cuda",
                        source="dcora_tpu_torch/csrc/spmm_grouped.cu",
                        replaces="dcora_tpu/core/pallas_spmm.py:515"),
    # the port's own kernel: it replaces XLA's segment_sum of the edge path,
    # not a Pallas kernel
    "segment_sum": dict(name="segment_sum", route="cuda",
                        source="dcora_tpu_torch/csrc/segment_sum.cu",
                        replaces="dcora_tpu/core/problem.py:318",
                        note="port's own kernel; replaces XLA's segment_sum, "
                        "not a Pallas kernel"),
    # the port's own kernel: it replaces the two lax.scans of the JAX
    # package's block-tridiagonal solve, not a Pallas kernel
    "btd_solve": dict(name="btd_solve", route="cuda",
                      source="dcora_tpu_torch/csrc/btd_solve.cu",
                      replaces="dcora_tpu/core/tiled.py:822",
                      note="port's own kernel; replaces the lax.scans of "
                      "dcora_tpu/core/tiled.py:822 (XLA), not a Pallas "
                      "kernel"),
    # the port's own kernels (one library, two kernels): they replace the
    # XLA fusions of the JAX package's per-pose flat ops, not a Pallas
    # kernel; the line's numbers are one flat tCG iteration's pair (a launch
    # of each), with each kernel's own under "parts"
    "flat_ops": dict(name="flat_ops", route="cuda",
                     source="dcora_tpu_torch/csrc/flat_ops.cu",
                     replaces="dcora_tpu/core/tiled.py:743",
                     note="port's own kernels flat_rhess and flat_precond; "
                     "replace the XLA fusions of tangent_project_flat "
                     "(dcora_tpu/core/tiled.py:743), weingarten_setup / "
                     "weingarten_apply (:772, :792) and precondition_flat "
                     "(:860), not a Pallas kernel; ms, plain_ms and bound_ms "
                     "are one launch of each at grid10k f32 r_pad 8"),
    # the port's own kernels (one library, three kernels issued by one C
    # call): the JAX package proves the certificate with scipy's SuperLU on
    # the host, so they replace no TPU kernel
    "ldlt": dict(name="ldlt", route="cuda",
                 source="dcora_tpu_torch/csrc/ldlt.cu",
                 replaces="dcora_tpu/core/certify.py:366",
                 note="port's own kernels ldlt_assemble, ldlt_panel and "
                 "ldlt_update; replace the host's SuperLU call of "
                 "ldl_psd_proof (dcora_tpu/core/certify.py:366, scipy), "
                 "not a Pallas kernel; ms, plain_ms (factor_plain on the "
                 "host) and bound_ms are one factorization of grid3D's "
                 "Q + eta I; launches are those of every certified path"),
}
LIBRARY = "library"  # torch.sparse.mm on the full symmetric Q, CSR
# relative to max|W|: a different summation order, plus f32 rounding
TOL = {"float32": 1e-5, "float64": 1e-12}
F_RTOL = 1e-8  # certified f* against the JAX reference values
# RA: f* against the JAX reference; the JAX package's edge and tiled paths
# certify ra500 1.3e-7 apart (the slack of gradnorm_tol 1e-4)
RA_F_RTOL = 1e-6
RA_ETA = 1e-4  # the RA driver's certificate tolerance and the witness's
# the BTD kernel against its plain loop, relative to max|Y| (another
# summation order, carried along 2 nt - 1 dependent products)
BTD_TOL = {"float32": 1e-4, "float64": 1e-10}
# the tCG graph against its iterations issued one by one, relative to
# max|eta| (the two issue the same kernels; the tolerance dates from the
# edge path's index_add_, which summed in another order from call to call)
TCG_TOL = 1e-9
# the segment-sum kernel against its plain version (index_add_ on the card,
# float atomics), relative to max|out|: another order, plus f32 rounding
SEG_TOL = {"float32": 1e-5, "float64": 1e-13}
# the LDL^T kernel's pivots against its plain version's, relative to
# max|pivot|: the kernel sums the panel solves and the rank-32 updates in
# another order, on the f64 tensor cores (the CUDA tests hold it to the
# same on small problems)
LDLT_TOL = 1e-9
LDLT_ETA = 1e-3  # the shift of the LDL^T phase: the certificate's eta
# chordal init on the card against the CPU, relative to max|T| (two CG
# solves to 1e-12 that sum in different orders)
INIT_TOL = 1e-8
G2O100K_POSES = 97_336  # generate_large_scale_g2o's default: a 46^3 grid
# the centralized GNC's end state against JAX's.  Its last stages stop at
# gradnorm 1e-2 of the weighted problem, and each stage's weights come from
# the stage before, so every quantity of the end state but the rejected set
# moves with where those stages stopped, which moves with summation order.
# Across five runs on one H100 (when the edge path summed with index_add_,
# in another order from run to run) and a CPU run of the port: the final
# weights 1.4e-3 to 6.8e-3 apart from JAX's on the card (1.6e-2 on the
# CPU), the weighted problem's cost 6.3e-6 to 4.8e-5 relative (2.1e-4),
# the clean problem's cost 1.4e-6 to 2.2e-5 over eleven card runs (5.6e-5).
# One GNC step of mu more or less moves the undecided weights by ~0.1 and
# the weighted cost by ~2e-2.  The 1e-6 asked of the clean cost is not met
GNC_W_ATOL = 3e-2
GNC_FW_RTOL = 5e-4
GNC_F_RTOL = 1e-4
# DC2-PGO's certified f* against JAX's, as the single-robot slice
MR_F_RTOL = 1e-8
# DCORA's f at the cut against JAX's, as the RA slice
MR_RA_F_RTOL = 1e-6
# the distributed GNC against JAX's, through its first weight update at
# round 30: every round's cost and every weight after the update, relative
# (each weight is ~c sqrt(mu) / r at the update's small mu, so it carries
# the residual's relative error).  The port agrees to 2e-13 in the costs
# and 2.5e-11 in the weights, on a CPU and on one H100 alike; on the card
# the costs part from JAX's from round 33 on when no update intervenes
DIST_RTOL = 1e-8
DIST_W_RTOL = 1e-6
PAR_REFERENCE = os.path.join(HERE, "tests", "data",
                             "torch_port_parallel_reference.json")
# the synchronous-parallel RBCD's central cost after every round against
# JAX's, at float64 (edge path and f64 tiles).  On a CPU the port agrees
# to 8.1e-14 (edge) and 1.8e-11 (f64 tiles) over ra500_nl's 30 rounds,
# where the parallel RA rounds oscillate and amplify a difference ~10x
# every few rounds
PAR_RTOL = 1e-8
# par_grid10k after its first round: from round 2 on the agents' tCG runs
# long on ill-conditioned blocks and carries a summation order's rounding
# into the iterate at ~1e-4 of its size, in either engine: JAX's own
# vmapped round 2 differs from the same agents updated one by one by up
# to 2.3e-3 of max|X| ("jax_alone_round2_rel" in the reference), and the
# port on a CPU differs from JAX's costs by up to 6.1e-5 over 30 rounds
# ("port_cpu_rel").  Round 1 is held to PAR_RTOL, every round to this
PAR_GRID_RTOL = 5e-4
# the driver's default, float32 tiles, against the f64-tile rounds on the
# card over the first 30 rounds of par_grid10k (f32 rounding moves the
# accepted steps: 5.4e-4 on one H100 80GB HBM3 at 700 W, PERF.md)
PAR_F32_RTOL = 5e-3
# the sharded certificate's lambda_min against the central one at
# DC2-PGO's certified optimum, relative to the largest-magnitude
# eigenvalue of S (the spectrum's scale): there lambda_min is ~0, and each
# Lanczos run stops when a sweep gains less than 1e-9 of that scale (the
# two estimates were 1.5e-5 apart, 7.1e-10 of that scale, on one H100
# 80GB HBM3 at 700 W)
PAR_EIG_TOL = 1e-6
# the f32 rounds' largest rise of the central cost from one round to the
# next, relative: their steps are accepted on the f32 tile cost, so a step
# can raise the f64 central cost by f32 rounding (1.1e-6 on smallGrid3D
# near its optimum, on a CPU)
PAR_F32_RISE = 1e-5
PAR_AGENTS = 8
SCALING_AGENTS = (1, 2, 4, 8, 16)


def phase(msg: str):
    print(msg, flush=True)


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def device_phase(torch):
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is false; this script runs only on "
            "a CUDA device")
    from dcora_tpu_torch.tools.common import card

    name = torch.cuda.get_device_name(0)
    phase(f"[device] {name}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    power = card()
    print(power, flush=True)
    return name, power


def ptxas_lines(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1))) + spill)
            fn, spill = None, (0, 0)
    return out


def build_phase(spmm):
    t0 = time.perf_counter()
    libs = spmm.build_all()
    phase(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f}s"
          " (one nvcc per source, in parallel): " + ", ".join(
              f"{os.path.basename(lib.path())} (nvcc "
              f"{lib.build_seconds or 0.0:.2f}s)" for lib in libs.values()))
    for name, lib in libs.items():
        for fn, regs, st, ld in ptxas_lines(lib.build_log):
            block = f" (B={spmm.BLOCK})" if name.startswith("spmm") else ""
            phase(f"[ptxas] {name}{block} {fn}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B")
            require(st == 0 and ld == 0, f"{fn} spills registers")


def compare_and_time(torch, problem, cases, library, dense, X, live,
                     bound):
    """Hold each kernel of `cases` (name -> (kernel, plain version)) and the
    library call against its plain version and the dense-tile reference on
    the same X, then time them all in turns; one row per kernel."""
    from dcora_tpu_torch.tools import common

    dt = str(X.dtype).split(".")[-1]
    r_pad = X.shape[0]
    errs = {}
    for name, (kern, plain) in [*cases.items(),
                                (LIBRARY, (lambda: library().t(), None))]:
        W = kern()
        Wp = plain() if plain else dense
        torch.cuda.synchronize()
        require(bool(torch.isfinite(W).all()), f"{name} output not finite")
        scale = float(dense.abs().max())
        abs_err = max(float((W - Wp).abs().max()),
                      float((W - dense).abs().max()))
        require(abs_err <= TOL[dt] * scale,
                f"{name} disagrees with plain ({problem}, {dt}, r_pad "
                f"{r_pad}, live {live}): {abs_err:.3e} > {TOL[dt]:.0e} * "
                f"{scale:.3e}")
        require(not W[live:].any(), f"{name}: zero rows not zero")
        errs[name] = (abs_err, abs_err / scale)
    ms = common.time_turns_ms(
        [f for pair in cases.values() for f in pair] + [library])
    rows = []
    for i, name in enumerate(cases):
        rows.append(dict(kernel=name, problem=problem, dtype=dt, r_pad=r_pad,
                         live=live, max_abs_err=errs[name][0],
                         ms=ms[2 * i], plain_ms=ms[2 * i + 1],
                         library_ms=ms[-1], bound_ms=bound[0],
                         bound_by=bound[1]))
        phase(f"[kernel] {name} {problem} {dt} r_pad={r_pad} live_rows={live} "
              f"max_abs_err={errs[name][0]:.3e} (rel {errs[name][1]:.2e}) "
              f"kernel_ms={ms[2 * i]:.4f} plain_ms={ms[2 * i + 1]:.4f} "
              f"library_ms={ms[-1]:.4f} (rel err {errs[LIBRARY][1]:.2e}) "
              f"bound_ms={bound[0]:.4f} ({bound[1]}) (per launch, "
              f"{common.LAUNCHES} back to back, median of 3 turns)")
    return rows


def hbm_gbs(torch):
    from dcora_tpu_torch.tools import common

    return common.nominal_hbm_gbs(torch.cuda.get_device_name(0)) or \
        common.NOMINAL_HBM_GBS[0][1]


def ldlt_launches():
    """Launches of csrc/ldlt.cu so far in this process."""
    from dcora_tpu_torch.core import kernels

    return kernels.launch_counts()["ldlt"]


def ldlt_phase(torch, tmp, ra_path):
    """[ldlt] The certificate's LDL^T kernel (csrc/ldlt.cu through
    ldlt.DeviceFactor) against its plain version (ldlt.factor_plain on the
    host, the same analysis and values) at the main path's shapes: SE-Sync's
    grid3D pattern (the benchmark's 20^3 graph, k = 32,000) with Q + eta I
    (positive definite) and S + eta I at a random rank-3 state
    (indefinite), and ra10k's S + eta I at its odometry init (its sphere
    and landmark columns).  The pivots within LDLT_TOL of max|pivot|, the
    same negative count and verdict, two factorizations bitwise equal, the
    launch count moved by the schedule's launches.  Timed at grid3D's
    Q + eta I: the kernel (CUDA events, median of 3 turns of 10), the plain
    version (one run on the host) and the bound (common.ldlt_bound_ms).
    Returns the rows."""
    import numpy as np

    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import certify, ldlt, lifted
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global)
    from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.tools import common
    from dcora_tpu_torch.types import GraphType

    path = datasets.generate_grid_g2o(os.path.join(tmp, "grid3d.g2o"),
                                      shape=(20, 20, 20), loop_prob=0.962,
                                      seed=199)
    g = LocalGraph(0, 3, 3)
    g.set_measurements(read_g2o_file(path).pose_pose_measurements)
    P, dims = g.problem_data(), g.dims
    rng = np.random.default_rng(7)
    X = lifted.RAState(
        rot=torch.as_tensor(np.linalg.qr(rng.standard_normal(
            (dims.n, 3, 3)))[0]),
        sph=torch.zeros((0, 3), dtype=torch.float64),
        trn=torch.as_tensor(rng.standard_normal((dims.num_trans, 3))))
    ds = read_pyfg_file(ra_path)
    gm = get_global_measurements(ds)
    gr = LocalGraph(0, 3, 3, GraphType.RangeAidedSLAMGraph)
    gr.set_measurements(gm.relative_measurements)
    cases = {
        "grid3D Q + eta I": (certify._Q_host(P, dims), dims, True),
        "grid3D S + eta I, random state": (certify._assemble_S_host(
            P, certify.dual_certificate_blocks(P, X), dims), dims, False),
        "ra10k S + eta I, odometry init": (certify._assemble_S_host(
            gr.problem_data(), certify.dual_certificate_blocks(
                gr.problem_data(), odometry_init_global(ds, gm)),
            gr.dims), gr.dims, False),
    }
    rows = []
    for name, (S, sdims, expect) in cases.items():
        timed = name == "grid3D Q + eta I"
        t0 = time.perf_counter()
        an = ldlt.analyse(S, sdims)
        analyse_s = time.perf_counter() - t0
        plan = ldlt.DeviceFactor(an, "cuda")
        vals = torch.as_tensor(S.data, device="cuda")
        before = ldlt_launches()
        got = plan.factor(vals, LDLT_ETA).clone()
        plan.fronts.fill_(float("nan"))  # nothing may be read unwritten
        again = plan.factor(vals, LDLT_ETA).clone()
        require(ldlt_launches() - before == 2 * len(an.launches),
                f"[ldlt] {name}: the launch count did not move by the "
                f"schedule's {len(an.launches)} launches a factorization")
        t0 = time.perf_counter()
        want = ldlt.factor_plain(an, torch.as_tensor(S.data), LDLT_ETA)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got = got.cpu()
        err = float((got - want).abs().max() / want.abs().max())
        neg = (int((got < 0).sum()), int((want < 0).sum()))
        verdicts = (ldlt.verdict(got), ldlt.verdict(want))
        row = dict(kernel="ldlt", problem=name, dtype="float64", r_pad=None,
                   live=None, max_abs_err=err, ms=None, plain_ms=plain_ms,
                   library_ms=None, bound_ms=None, bound_by=None)
        bound = common.ldlt_bound_ms(an, hbm_gbs(torch))
        timing = ""
        if timed:
            ms = common.time_turns_ms(
                [lambda: plan.factor(vals, LDLT_ETA)], n=10)[0]  # noqa: B023
            row.update(ms=ms, bound_ms=bound[0], bound_by=bound[1])
            timing = (f"; kernel {ms:.3f} ms a factorization (CUDA events, "
                      f"median of 3 turns of 10), bound {bound[0]:.4f} ms "
                      f"({bound[1]}, {bound[0] / ms:.1%} of it)")
        rows.append(row)
        phase(f"[ldlt] {name}: k={S.shape[0]} nnz(S)={S.nnz} "
              f"nnz(L)={an.nnz_L} {common.ldlt_ops(an):.4g} operations, "
              f"{len(an.first)} supernodes in {int(an.level.max()) + 1} "
              f"levels, largest front {int(an.size.max())}, "
              f"{len(an.launches)} launches, fronts "
              f"{8 * an.front_words / 1e9:.3f} GB; analysis "
              f"{analyse_s:.3f}s; verdict {verdicts[0]} (plain "
              f"{verdicts[1]}), negative pivots {neg[0]} (plain {neg[1]}), "
              f"max|pivot - plain| {err:.2e} of max|pivot|; plain version "
              f"{plain_ms:.0f} ms on the host{timing}")
        require(torch.equal(got, again.cpu()),
                f"[ldlt] {name}: two factorizations differ")
        require(err <= LDLT_TOL, f"[ldlt] {name}: the pivots differ from "
                f"the plain version's: {err:.2e} > {LDLT_TOL:.0e}")
        require(neg[0] == neg[1] and verdicts[0] == verdicts[1],
                f"[ldlt] {name}: the inertia differs from the plain "
                f"version's")
        require(verdicts[0] is expect, f"[ldlt] {name}: verdict "
                f"{verdicts[0]}, expected {expect}")
        del plan, vals
    return rows


def kernel_phase(torch, path10k):
    """Every kernel against its plain version on the card, at the main
    paths' shapes: r_pad 8 and 16 in f32 and f64, and r_pad 8 with one live
    row (the tiled Lanczos operand).  Kernel 1 (spmm_sym) on the strip CSR
    of the default build, kernel 2 (spmm_tile) on the per-tile list padded
    to 8-tile chunks and compacted to its non-empty sub-blocks (no dense
    tile reaches the card's kernel), kernel 3 (spmm_grouped.cu) on the
    paired pack's compacted sub-blocks (two-row groups and single-row
    leftovers in one launch), as apply_tiled runs them.  All timed in turns
    on the same X with the library call torch.sparse.mm(Q_csr, X^T) (X^T
    made outside the timed call); each row carries the product's bound."""
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.solvers import make_preconditioner
    from dcora_tpu_torch.tools import common
    from dcora_tpu_torch.tools.spmm_bench import tile_blocks

    ds = read_g2o_file(path10k)
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.float64):
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M,
                               pack="paired")
        Q, kpad = TP.Q, TP.meta.kpad
        tb = tile_blocks(Q)
        nblk = int(spmm.nonempty_blocks(Q.tiles.cpu().numpy()).sum())
        require(tb.vals.numel() == spmm.BLOCK ** 2 * nblk,
                f"kernel 2's layout holds {tb.vals.numel()} values, not the "
                f"{nblk} non-empty blocks' {spmm.BLOCK ** 2 * nblk}")
        csr, stored_nnz = common.symmetric_csr(Q, kpad)
        masked = (Q.pairs.run_col & 1).bool()
        require(bool(masked.any()) and not bool(masked.all()),
                "the paired pack has no masked or no unmasked run")
        for r_pad, live in ((8, 8), (16, 16), (8, 1)):
            X = torch.zeros((r_pad, kpad), dtype=dtype, device="cuda")
            X[:live] = torch.randn((live, kpad), generator=gen,
                                   dtype=dtype, device="cuda")
            Xt = X.t().contiguous()
            cases = {
                "spmm_sym": (
                    lambda: spmm.spmm_sym(Q.strips, X),
                    lambda: spmm.spmm_strips_plain(Q.strips, X)),
                "spmm_tile": (
                    lambda: spmm.spmm_symmetric(tb, X),
                    lambda: spmm.spmm_symmetric_plain(tb, X)),
                "spmm_paired": (
                    lambda: spmm.spmm_paired(Q.pairs, X),
                    lambda: spmm.spmm_paired_plain(Q.pairs, X)),
            }
            dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
            bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(),
                                         r_pad, kpad, dtype, hbm_gbs(torch))
            rows += compare_and_time(
                torch, "grid10k", cases,
                lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
                dense, X, live, bound)
    return rows


def ra_kernel_phase(torch, path):
    """Kernel 1 (spmm_sym) on the range-aided tiles of the ra10k Q, as the
    RA solve builds them (BTD preconditioner), against its plain version,
    torch.sparse.mm and the bound, at f32/f64 x r_pad 8/16.  Returns the
    rows and the two TiledProblems (for the BTD phase)."""
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.solvers import make_preconditioner, precond_reg
    from dcora_tpu_torch.tools import common

    g = common.load_graph(path, 3)
    P = g.problem_data(device="cuda")
    M, reg = make_preconditioner(g, P), precond_reg(g, P)
    rows, tps = [], {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M, reg=reg,
                               tile_precond="btd", pack="bucketed")
        build_s = time.perf_counter() - t0
        Q, kpad = TP.Q, TP.meta.kpad
        tps[dtype] = TP
        csr, stored_nnz = common.symmetric_csr(Q, kpad)
        phase(f"[ra tiles] ra10k {str(dtype).split('.')[-1]}: n={g.n} "
              f"l={g.l} b={g.b} {common.q_stats(TP)} ({spmm.BLOCK}x"
              f"{spmm.BLOCK} blocks), host build with the BTD factor "
              f"{build_s:.2f}s")
        for r_pad in (8, 16):
            X = torch.randn((r_pad, kpad), generator=gen, dtype=dtype,
                            device="cuda")
            Xt = X.t().contiguous()
            cases = {"spmm_sym": (
                lambda: spmm.spmm_sym(Q.strips, X),
                lambda: spmm.spmm_strips_plain(Q.strips, X))}
            dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
            bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(),
                                         r_pad, kpad, dtype, hbm_gbs(torch))
            rows += compare_and_time(
                torch, "ra10k", cases,
                lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
                dense, X, r_pad, bound)
    return rows, tps


def btd_phase(torch, tps):
    """The BTD preconditioner on the ra10k tiles: its kernel (one launch
    per application) against the plain loop on the card (the CPU path), and
    one application of each timed in turns (events) and the kernel's on the
    device (profiler), at f32/f64 x r_pad 8/16/24; two applications must be
    bitwise equal.  Returns (kernel rows, {check: bitwise equal}) for the
    kernels line and the [repeat] phase."""
    from dcora_tpu_torch.core import tiled
    from dcora_tpu_torch.tools import common

    rows, checks = [], {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype, TP in tps.items():
        dt = str(dtype).split(".")[-1]
        for r_pad in (8, 16, 24):
            V = torch.randn((r_pad, TP.meta.kpad), generator=gen, dtype=dtype,
                            device="cuda")
            before = tiled.btd_solve.launches
            Y = tiled.precondition_flat(TP, V)
            again = tiled.precondition_flat(TP, V)
            Yp = tiled._precondition_btd(TP, V)
            torch.cuda.synchronize()
            require(tiled.btd_solve.launches == before + 2, "the BTD "
                    "kernel did not launch once per application")
            require(bool(torch.isfinite(Y).all()), "BTD kernel not finite")
            err = float((Y - Yp).abs().max())
            rel = err / float(Yp.abs().max())
            require(rel <= BTD_TOL[dt], f"BTD kernel disagrees with the loop "
                    f"({dt}, r_pad {r_pad}): rel {rel:.3e}")
            checks[f"btd_solve ra10k {dt} r_pad {r_pad}"] = \
                torch.equal(Y, again)
            kernel_ms, plain_ms = common.time_turns_ms(
                [lambda: tiled.precondition_flat(TP, V),  # noqa: B023
                 lambda: tiled._precondition_btd(TP, V)], n=10)  # noqa: B023
            dev_ms = common.device_ms(
                lambda: tiled.precondition_flat(TP, V))  # noqa: B023
            bound = common.btd_bound_ms(TP.meta.nt, TP.meta.T, r_pad, dtype,
                                        hbm_gbs(torch))
            rows.append(dict(kernel="btd_solve", problem="ra10k", dtype=dt,
                             r_pad=r_pad, live=r_pad, max_abs_err=err,
                             ms=kernel_ms, plain_ms=plain_ms,
                             device_ms=dev_ms, library_ms=None,
                             bound_ms=bound[0], bound_by=bound[1]))
            phase(f"[btd] ra10k {dt} r_pad={r_pad} nt={TP.meta.nt}: kernel "
                  f"{kernel_ms:.4f} ms (device {dev_ms:.4f}), plain loop "
                  f"{plain_ms:.4f} ms per application (CUDA events, 10 back "
                  f"to back, median of 3 turns), bound {bound[0]:.4f} ms "
                  f"({bound[1]}), max_abs_err={err:.3e} (rel {rel:.2e}), two "
                  f"applications bitwise equal {torch.equal(Y, again)}")
    return rows, checks


def _flat_state(torch, tiled, meta, shape, rank, gen):
    """A point on the flat manifold with zero rows from `rank` on, and two
    random arrays with the same zero rows, at the tiles' dtype (the polar
    factor taken in f64: a nearly singular random 3 x 3 block has none in
    f32)."""
    X0, V, E = (torch.randn(shape, generator=gen[0], dtype=torch.float64,
                            device="cuda") for _ in range(3))
    for A in (X0, V, E):
        A[rank:] = 0.0
    X = tiled.retract_flat(meta, torch.zeros_like(X0), X0)
    return tuple(A.to(gen[1]).contiguous() for A in (X, V, E))


def flat_phase(torch, path10k, tps_ra, pp10k):
    """[flat] The two kernels of csrc/flat_ops.cu against their plain
    versions on the card: flat_rhess (the Hessian's projection with the
    Weingarten term; and its project-only and Gram modes, checked beside
    it) and flat_precond (the per-pose Jacobi solve fused with the
    projection), on grid10k (rank 5, per-pose Jacobi), ra10k (rank 3,
    spheres and landmarks; the BTD solve, so flat_precond does not run
    there) and par_grid10k's stack of 8 agents, in f32 and f64 at r_pad 8
    and 16: within TOL of max|plain|, the plain version's bits on grid10k
    and the stack (poses alone), two launches bitwise equal, and each
    timed per launch in turns with its plain version (CUDA events) and on
    the device (profiler) beside its bound.  Then the flat tCG through its
    CUDA graph against the same iterations issued one by
    one, bitwise over 6 iterations with the Weingarten term (grid10k f64
    and f32, ra10k f32, the stack f32), and the ms per iteration of both
    over a 100-iteration solve (the Weingarten term left out, so no solve
    stops early).  Returns (kernel rows, {problem: (graph ms, eager ms)
    per iteration})."""
    from dcora_tpu_torch.core import rtr, tiled
    from dcora_tpu_torch.parallel.rbcd import (STACKED_FLAT,
                                               build_stacked_tiled)
    from dcora_tpu_torch.solvers import make_preconditioner
    from dcora_tpu_torch.tools import common

    g = common.load_graph(path10k, 5)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    problems = {}
    for dtype in (torch.float32, torch.float64):
        problems[("grid10k", dtype)] = (tiled.build_tiled(
            P, g.dims, dtype=dtype, precond=M, tile_precond=False), 5,
            rtr.FLAT_BACKEND)
        problems[("ra10k", dtype)] = (tps_ra[dtype], 3, rtr.FLAT_BACKEND)
        problems[("par_grid10k", dtype)] = (build_stacked_tiled(
            pp10k, 0, pp10k.num_agents, dtype, "cuda"), 5, STACKED_FLAT)
    rows, hbm = [], hbm_gbs(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (name, dtype), (TP, rank, be) in problems.items():
        meta, dt = TP.meta, str(dtype).split(".")[-1]
        A = pp10k.num_agents if be is STACKED_FLAT else 1
        for r_pad in (8, 16):
            shape = (r_pad, A, meta.kpad) if A > 1 else (r_pad, meta.kpad)
            X, V, E = _flat_state(torch, tiled, meta, shape, rank,
                                  (gen, dtype))
            aux = tiled.weingarten_setup(meta, X, V)
            aux_p = tiled._weingarten_setup_plain(meta, X, V)
            HV = tiled.apply_tiled(TP, E)
            cases = {
                "flat_rhess": (
                    lambda: tiled.flat_rhess(meta, X, HV, E, aux),  # noqa
                    lambda: tiled._rhess_plain(meta, X, HV, E, aux)),
                "flat_rhess tangent": (
                    lambda: tiled.tangent_project_flat(meta, X, V),  # noqa
                    lambda: tiled._tangent_project_plain(meta, X, V)),
                "flat_rhess hess": (
                    lambda: tiled.flat_rhess(meta, None, HV, E,  # noqa
                                             aux, project=False),
                    lambda: tiled._rhess_plain(meta, None, HV, E, aux,
                                               project=False)),
            }
            if TP.btd_ltil is None:
                cases["flat_precond"] = (
                    lambda: tiled.flat_precond(TP, X, V),  # noqa: B023
                    lambda: tiled._tangent_project_plain(  # noqa: B023
                        meta, X, tiled._precondition_pose_plain(TP, V)))
            errs = {"gram": max(
                float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-300)
                for a, b in zip(aux, aux_p) if b.numel())}
            same = {"gram": all(torch.equal(a, b) for a, b in zip(aux, aux_p))}
            for kname, (kern, plain) in cases.items():
                out, again, ref = kern(), kern(), plain()
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out).all()),
                        f"{kname} {name} {dt}: not finite")
                err = float((out - ref).abs().max())
                scale = float(ref.abs().max())
                errs[kname] = err / scale
                same[kname] = torch.equal(out, ref)
                require(err <= TOL[dt] * scale, f"{kname} disagrees with "
                        f"its plain version ({name}, {dt}, r_pad {r_pad}): "
                        f"{err:.3e} > {TOL[dt]:.0e} * {scale:.3e}")
                require(torch.equal(out, again), f"{kname} {name} {dt}: "
                        "two launches differ")
                require(not out[rank:].any(), f"{kname}: zero rows not zero")
                # poses alone: every per-pose sum in the plain version's
                # order, so its bits (gnc2500's gates rest on them)
                require(same[kname] or name == "ra10k",
                        f"{kname} {name} {dt} r_pad {r_pad}: not the plain "
                        "version's bits on a problem of poses alone")
                if kname not in ("flat_rhess", "flat_precond"):
                    continue
                ms, plain_ms = common.time_turns_ms([kern, plain])
                dev_ms = common.device_ms(kern)
                bound = common.flat_bound_ms(kname, meta, r_pad, A, dtype,
                                             hbm)
                rows.append(dict(kernel=kname, problem=name, dtype=dt,
                                 r_pad=r_pad, live=rank, max_abs_err=err,
                                 ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                 library_ms=None, bound_ms=bound[0],
                                 bound_by=bound[1]))
                phase(f"[flat] {kname} {name} {dt} r_pad={r_pad} agents={A}"
                      f": kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
                      f"{plain_ms:.4f} ms per launch (CUDA events, "
                      f"{common.LAUNCHES} back to back, median of 3 turns), "
                      f"bound {bound[0]:.4f} ms ({bound[1]}), "
                      f"max_abs_err={err:.3e} (rel {err / scale:.2e})")
            phase(f"[flat] {name} {dt} r_pad={r_pad}: rel err against the "
                  "plain versions " + ", ".join(
                      f"{k} {v:.2e}" for k, v in errs.items())
                  + "; bitwise the plain version's: " + ", ".join(
                      f"{k} {v}" for k, v in same.items())
                  + "; two launches bitwise equal")
    # the flat tCG: graph against eager, bitwise, then timed
    tcg = {}
    for name, dtype in (("grid10k", torch.float64), ("grid10k", torch.float32),
                        ("ra10k", torch.float32),
                        ("par_grid10k", torch.float32)):
        TP, rank, be = problems[(name, dtype)]
        meta, dt = TP.meta, str(dtype).split(".")[-1]
        A = pp10k.num_agents if be is STACKED_FLAT else 1
        shape = (8, A, meta.kpad) if A > 1 else (8, meta.kpad)
        X, _, _ = _flat_state(torch, tiled, meta, shape, rank, (gen, dtype))
        egrad = tiled.egrad_flat(TP, X)
        grad = be.tangent(TP, X, egrad)
        radius = torch.full((A,) if A > 1 else (), 1e8, dtype=dtype,
                            device="cuda")
        short = rtr.TCGGraph(be, TP, None, 6)
        runs = [rtr.truncated_cg(TP, X, grad, egrad, None, radius, 6, 1e-12,
                                 1.0, be=be, graph=gr)
                for gr in (short, None)]
        steps = runs[0].inner_iters
        require(torch.equal(steps, runs[1].inner_iters)
                and bool((steps > 0).all()), f"flat tCG {name} {dt}: the "
                f"graph ran {steps.tolist()} iterations, the loop "
                f"{runs[1].inner_iters.tolist()}")
        require(torch.equal(runs[0].eta, runs[1].eta)
                and torch.equal(runs[0].Heta, runs[1].Heta),
                f"flat tCG {name} {dt}: the graph and the loop differ")
        zero = torch.zeros_like(X)
        graph = rtr.TCGGraph(be, TP, None, 100)

        def solve(gr, TP=TP, X=X, grad=grad, zero=zero, radius=radius,
                  be=be):
            return rtr.truncated_cg(TP, X, grad, zero, None, radius, 100,
                                    1e-12, 1.0, be=be, graph=gr)

        full = solve(graph).inner_iters
        require(bool((full == 100).all())
                and torch.equal(full, solve(None).inner_iters),
                f"flat tCG {name} {dt}: the timed solves stopped early")
        g_ms, e_ms = common.time_turns_ms(
            [lambda: solve(graph), lambda: solve(None)], n=1)  # noqa: B023
        tcg[f"{name} {dt}"] = (g_ms / 100, e_ms / 100)
        phase(f"[flat tcg] {name} {dt} r_pad=8 agents={A}: graph "
              f"{g_ms / 100:.4f} ms, eager {e_ms / 100:.4f} ms per iteration "
              f"(100 iterations per solve, CUDA events, median of 3 turns); "
              f"over {steps.max().item()} iterations with the Weingarten "
              f"term the graph equals the loop bitwise; per replay "
              f"{graph.per_replay}")
    del problems
    return rows, tcg


def counting_products(tiled):
    """Wrap tiled.apply_tiled (every tile product of the solve goes through
    it) to count products, those recorded in a tCG graph once per replay
    (tools.common.count_products); returns (count holder, restore)."""
    from dcora_tpu_torch.tools import common

    return common.count_products()


def slice_phase(torch, name, path, ref):
    """The certified staircase on the card, held to the JAX reference."""
    import numpy as np

    from dcora_tpu_torch.drivers.single_robot_pgo import run
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.tools import common
    from dcora_tpu_torch.verification import verify_solution

    res = {}
    before = ldlt_launches()
    t0 = time.perf_counter()
    T, f = run(path, certify=True, device="cuda", verbose=False, result=res)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ldlt = ldlt_launches() - before
    st = res["staircase"]
    require(st.X.rot.is_cuda and st.rounded.rot.is_cuda,
            f"{name}: state tensors are not on CUDA")
    require(T.shape == (ref["n"], 3, 4) and bool(np.isfinite(T).all()),
            f"{name}: bad trajectory shape or values")
    require(st.certified, f"{name}: not certified")
    require(n_ldlt > 0, f"{name}: certified without the LDL^T kernel")
    require(st.final_rank == ref["rank"],
            f"{name}: rank {st.final_rank} != reference {ref['rank']}")
    rel = abs(f - ref["f"]) / abs(ref["f"])
    require(rel <= F_RTOL, f"{name}: f* {f!r} vs reference {ref['f']!r} "
            f"(rel {rel:.2e} > {F_RTOL:.0e})")
    t1 = time.perf_counter()
    rep = verify_solution(read_g2o_file(path).pose_pose_measurements, st.X,
                          3, eta=1e-3)
    require(rep["certified_indep"] is True,
            f"{name}: the LDL^T verifier does not witness S + eta I >= 0")
    stages = " ".join(f"{k}={v:.2f}s" for k, v in st.stage_seconds.items())
    sha = common.state_sha256(st.X)
    phase(f"[slice] {name}: n={ref['n']} certified={st.certified} "
          f"rank={st.final_rank} f*={f!r} (reference {ref['f']!r}, rel "
          f"{rel:.1e}) ldl_witness=True ldlt_launches={n_ldlt} "
          f"wall={wall:.2f}s "
          f"(init {res['init_s']:.2f}s, staircase "
          f"{res['staircase_s']:.2f}s: {stages}) "
          f"verify={time.perf_counter() - t1:.2f}s x_sha256={sha}")
    return wall, sha, n_ldlt


def paired_phase(torch, path, ref):
    """The certified 10,648-pose solve under DCORA_SPMM_PACK=paired: every
    tile product of the f32 and f64 phases and of the tiled Lanczos runs on
    the compacted paired packs, one launch each."""
    from dcora_tpu_torch.core import spmm, tiled

    old = os.environ.get("DCORA_SPMM_PACK")
    os.environ["DCORA_SPMM_PACK"] = "paired"
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        wall, sha, _ = slice_phase(torch, "grid10k paired pack", path,
                                   ref)
        counts = spmm.launch_counts()
    finally:
        restore()
        if old is None:
            del os.environ["DCORA_SPMM_PACK"]
        else:
            os.environ["DCORA_SPMM_PACK"] = old
    require(counts["spmm_paired"] == products[0] > 0,
            f"the paired solve did not launch the grouped kernel once per "
            f"tile product: {counts}, {products[0]} products")
    require(counts["spmm_sym"] == 0 and counts["spmm_symmetric"] == 0,
            f"the paired solve launched another SpMM kernel: {counts}")
    phase(f"[launches] paired solve: {counts}, {products[0]} tile products "
          f"(wall {wall:.2f}s)")
    phase(f"[paired] grid10k paired pack: rank {ref['rank']}, iterate "
          f"x_sha256={sha}")
    return counts


def bench_phase(torch, path):
    """The bench entry points in process: spmm_bench (the path of the
    per-tile kernel), then tools.bench for both packs."""
    from dcora_tpu_torch.core import spmm
    from dcora_tpu_torch.tools import bench, spmm_bench

    spmm.reset_launches()
    res = spmm_bench.run(path)
    counts = spmm.launch_counts()
    require(counts["spmm_symmetric"] > 0,
            f"spmm_bench never launched the per-tile kernel: {counts}")
    require(max(r["rel_err"] for r in res["rows"]) <= TOL["float32"],
            "an spmm_bench row disagrees with the plain tile path")
    phase(f"[launches] spmm_bench: {counts}")
    for pack in ("bucketed", "paired"):
        out = bench.run(path, pack=pack)
        require(out["value"] > 0, f"bench ({pack}) measured nothing")
        print(json.dumps(out), flush=True)
    return counts


def tcg_phase(torch, path):
    """The edge path's tCG on the ra10k problem at rank 3, at the odometry
    init: its CUDA graph (core/rtr.TCGGraph) against the iterations issued
    one by one on the same inputs, over at most 6 iterations;
    then one 200-iteration solve of each, timed in turns.  The timed
    solves take the Hessian without its Weingarten term (a zero Euclidean
    gradient), which is positive semidefinite on the tangent space, so
    neither stops before its 200 iterations; they run the same kernels.
    Returns ms per iteration through the graph and the loop."""
    from dcora_tpu_torch.core import rtr
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global)
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.solvers import make_preconditioner
    from dcora_tpu_torch.tools import common

    ds = read_pyfg_file(path)
    gm = get_global_measurements(ds)
    g = common.load_graph(path, 3)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    X = odometry_init_global(ds, gm).to("cuda")
    egrad = rtr.RA_BACKEND.applyQ(P, X)
    grad = rtr.RA_BACKEND.tangent(P, X, egrad)
    flat = rtr.tmap(torch.zeros_like, egrad)
    radius = torch.tensor(1e8, dtype=torch.float64, device="cuda")
    short = rtr.TCGGraph(rtr.RA_BACKEND, P, M, 6)
    graph = rtr.TCGGraph(rtr.RA_BACKEND, P, M, 200)

    def solve(gr, eg=flat, n=200):
        return rtr.truncated_cg(P, X, grad, eg, M, radius, n, 1e-12, 1.0,
                                graph=gr)

    res_g, res_l = solve(short, egrad, 6), solve(None, egrad, 6)
    steps = int(res_g.inner_iters)
    require(steps == int(res_l.inner_iters) > 0,
            f"tCG graph ran {steps} iterations, the loop "
            f"{int(res_l.inner_iters)}")
    rel = max(float((a - b).abs().max()) / float(b.abs().max())
              for x, y in ((res_g.eta, res_l.eta), (res_g.Heta, res_l.Heta))
              for a, b in zip(x, y) if b.numel() and b.abs().max() > 0)
    require(rel <= TCG_TOL, f"tCG graph disagrees with the loop over "
            f"{steps} iterations: rel {rel:.3e}")
    t0 = time.perf_counter()
    full = int(solve(graph).inner_iters)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    require(full == int(solve(None).inner_iters) == 200,
            f"the timed tCG solves stopped early: {full} iterations")
    graph_ms, loop_ms = common.time_turns_ms(
        [lambda: solve(graph), lambda: solve(None)], n=1)
    phase(f"[tcg] ra10k edge path r=3: graph {graph_ms / full:.4f} ms, "
          f"loop {loop_ms / full:.4f} ms per iteration ({full} iterations "
          f"per solve, CUDA events, median of 3 turns); over {steps} "
          f"iterations with the Weingarten term graph vs loop rel err "
          f"{rel:.2e}; first 200-iteration solve with capture "
          f"{capture_s:.2f}s")
    return graph_ms / full, loop_ms / full


def repeat_phase(torch, paths, mr, btd_checks):
    """[repeat] With torch's deterministic switch off, two runs of each of
    these are bitwise equal: apply_Q on ra10k at rank 3 (odometry init),
    the 200-iteration tCG solve through its CUDA graph there, grid10k's
    chordal init, and DC2-PGO's central_eval (at its certified smallGrid3D
    optimum, 25 poses per robot, and at grid10k's chordal init at rank 5 in
    5 robots, rows of ~2,130 poses), and on grid10k's paired build kernels
    2 and 3 and a flat-backend tCG (spmm_repeats), and the BTD kernel on
    ra10k's tiles (btd_checks, from btd_phase).  Then the segment-sum
    kernel against its plain version (index_add_ per part on the card): on
    grid10k's per-robot rows, and on one apply_Q's three blocks of edge
    contributions at ra10k rank 3 (seg_rows).  Returns the kernel's
    rows."""
    import numpy as np

    from dcora_tpu_torch.core import lifted, problem as prob, rtr, segment
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.drivers.multi_robot_pgo import central_eval
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.tools import common

    t0 = time.perf_counter()
    require(not torch.are_deterministic_algorithms_enabled(),
            "torch's deterministic algorithms are on")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    checks = {}
    tcg = common.edge_tcg(paths["ra10k"], 3, 200)
    P, X = tcg.P, tcg.X
    checks["apply_Q ra10k r=3"] = same(prob.apply_Q(P, X),
                                       prob.apply_Q(P, X))
    runs = [tcg.solve() for _ in range(2)]
    require(all(int(r.inner_iters) == 200 for r in runs),
            "a repeated tCG solve stopped before 200 iterations")
    checks["tCG graph ra10k 200 iterations"] = \
        same(runs[0].eta, runs[1].eta) and same(runs[0].Heta, runs[1].Heta)
    ms = read_g2o_file(paths["grid10k"]).pose_pose_measurements
    T = [chordal_initialization(ms, device="cuda") for _ in range(2)]
    checks["chordal init grid10k"] = bool(np.array_equal(T[0], T[1]))

    def evals(path, X, robots):
        gc = LocalGraph(0, X.r, 3)
        gc.set_measurements(read_g2o_file(path).pose_pose_measurements)
        n = gc.n
        blocks = segment.build_map([[min(i // max(n // robots, 1),
                                         robots - 1) for i in range(n)]],
                                   "cuda")
        Pc = gc.problem_data(device="cuda")
        G0 = lifted.zeros(gc.dims, X.r, device="cuda")
        return ([central_eval(Pc, G0, X, blocks, robots) for _ in range(2)],
                (Pc, G0, X, blocks))

    checks.update(spmm_repeats(torch, paths["grid10k"]))
    checks.update(btd_checks)
    path, res = mr
    e_small, _ = evals(path, res.X, 5)
    e_grid, grid = evals(paths["grid10k"], lifted.pad_rank(
        lifted.from_pose_array(T[0]), 5).to("cuda"), 5)
    for name, e in (("DC2-PGO central_eval smallGrid3D", e_small),
                    ("central_eval grid10k 5 robots", e_grid)):
        checks[name] = repr(e[0]) == repr(e[1])
    torch.cuda.synchronize()
    phase("[repeat] two runs bitwise equal: " + ", ".join(
        f"{k} {v}" for k, v in checks.items())
        + f" ({time.perf_counter() - t0:.2f}s)")
    for k, v in checks.items():
        require(v, f"{k}: two runs differ")

    # the long rows: grid10k's per-robot sum of squared gradient norms
    # (5 rows of ~2,130 poses each), kernel against its plain version
    Pc, G0, Xg, pose_blocks = grid
    RG = rtr.riemannian_gradient(Pc, Xg, G0)
    sq = (RG.rot ** 2).sum(dim=(1, 2)) + (RG.trn ** 2).sum(dim=1)
    out, plain = (segment.segment_sum(sq, pose_blocks, 5),
                  segment.segment_sum_plain(sq, pose_blocks, 5))
    torch.cuda.synchronize()
    err, scale = float((out - plain).abs().max()), float(plain.abs().max())
    longest = int((pose_blocks.ptr[1:] - pose_blocks.ptr[:-1]).max())
    phase(f"[repeat] segment_sum grid10k per-robot rows (longest {longest} "
          f"entries) against index_add_: max_abs_err={err:.3e} (rel "
          f"{err / scale:.2e})")
    require(bool(torch.isfinite(out).all()) and err <= SEG_TOL["float64"]
            * scale, f"segment_sum grid10k per-robot rows disagree with "
            f"index_add_: {err:.3e} > {SEG_TOL['float64']:.0e} * "
            f"{scale:.3e}")

    return seg_rows(torch, P, X)


def seg_rows(torch, P, X):
    """One apply_Q's segment sums on ra10k at rank 3 (rotations,
    translations, spheres), in f64 (the edge path's type) and f32: the
    one launch of segment.segment_sums against the three blocks launched
    one by one (segment.segment_sum each), the plain version (index_add_
    per part on the card) and three index_add_ calls (the library call),
    each held to the plain version, the one launch bitwise to the three;
    timed in turns (events), on the device (profiler), and the wrapper's
    host us per call (issue time of 1,000 calls); the bound is the three
    blocks' bytes at the data-sheet HBM rate."""
    from dcora_tpu_torch.core import problem as prob, segment
    from dcora_tpu_torch.tools import common

    rows, gbs = [], hbm_gbs(torch)
    nums = (X.rot.shape[0], X.trn.shape[0], X.sph.shape[0])
    for dt in (torch.float64, torch.float32):
        dts = str(dt).split(".")[-1]
        blocks = [(c.to(dt).contiguous(), m, num) for c, m, num in
                  zip(prob.edge_contributions(P, X), P.seg, nums)]
        # the index arrays on the card, so that neither the plain version
        # nor index_add_ times a copy from the host
        on_card = [(c, m._replace(idx=m.idx.to("cuda")), num)
                   for c, m, num in blocks]
        Z = [torch.zeros((max(num, m.nseg),) + c.shape[1:], dtype=dt,
                         device="cuda") for c, m, num in blocks]
        fns = [lambda b=blocks: segment.segment_sums(b),
               lambda b=blocks: [segment.segment_sum(*x) for x in b],
               lambda b=on_card: [segment.segment_sum_plain(*x) for x in b],
               lambda b=on_card, Z=Z: [z.index_add(0, m.idx, c)
                                       for (c, m, _), z in zip(b, Z)]]
        one, three, plain, lib = (f() for f in fns)
        again = fns[0]()
        torch.cuda.synchronize()
        err, scale = 0.0, 0.0
        for o, t, p, li, a, (_, _, num), part in zip(
                one, three, plain, lib, again, blocks, ("rot", "trn", "sph")):
            s = float(p.abs().max())
            e = max(float((o - p).abs().max()), float((o - li[:num])
                                                      .abs().max()))
            require(bool(torch.isfinite(o).all()),
                    f"segment_sums {part} {dts}: output not finite")
            require(e <= SEG_TOL[dts] * s, f"segment_sums {part} {dts} "
                    f"disagrees with index_add_: {e:.3e} > "
                    f"{SEG_TOL[dts]:.0e} * {s:.3e}")
            require(torch.equal(o, t), f"segment_sums {part} {dts}: the one "
                    "launch differs from the block's own launch")
            require(torch.equal(o, a), f"segment_sums {part} {dts}: two "
                    "launches differ")
            err, scale = max(err, e), max(scale, s)
        ms = common.time_turns_ms(fns)
        dev_ms = [common.device_ms(f) for f in fns]
        host_us = []
        for f in fns[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                f()
            host_us.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        K = [c.shape[0] for c, _, _ in blocks]
        W = [c[0].numel() for c, _, _ in blocks]
        esize = torch.empty((), dtype=dt).element_size()
        nbytes = sum((k + num) * w * esize + 4 * (k + m.nseg + 1)
                     for k, w, (_, m, num) in zip(K, W, blocks))
        flops = sum(k * w for k, w in zip(K, W))
        bound = max((nbytes / (gbs * 1e6), "bytes"),
                    (flops / common.PEAK_FLOPS[dt] * 1e3, "operations"))
        rows.append(dict(kernel="segment_sum", problem="ra10k apply_Q",
                         dtype=dts, max_abs_err=err, ms=ms[0],
                         three_launches_ms=ms[1], plain_ms=ms[2],
                         library_ms=ms[3], bound_ms=bound[0],
                         bound_by=bound[1], device_ms=dev_ms,
                         host_us=host_us))
        phase(f"[kernel] segment_sum ra10k r=3 apply_Q's three blocks "
              f"{dts}: K={K} w={W} rows={list(nums)} max_abs_err={err:.3e} "
              f"(rel {err / scale:.2e}); per apply_Q (events, "
              f"{common.LAUNCHES} back to back, median of 3 turns): one "
              f"launch {ms[0]:.4f} ms, three launches {ms[1]:.4f}, plain "
              f"{ms[2]:.4f}, three index_add_ {ms[3]:.4f}; device ms "
              f"(profiler) one launch {dev_ms[0]:.5f}, three launches "
              f"{dev_ms[1]:.5f}, plain {dev_ms[2]:.5f}, three index_add_ "
              f"{dev_ms[3]:.5f}; wrapper host us per call (issue, 1,000 "
              f"calls) one launch {host_us[0]:.1f}, three launches "
              f"{host_us[1]:.1f}; bound_ms={bound[0]:.5f} ({bound[1]}, "
              f"{nbytes / 1e6:.3f} MB)")
    return rows


def spmm_repeats(torch, path10k):
    """Kernels 2 and 3 on grid10k's paired build, two products each at
    r_pad 8 and 16 in f32 and f64, and two runs of a 100-iteration
    flat-backend tCG (rtr.FLAT_BACKEND, through kernel 3) on its f32
    tiles: {check: bitwise equal}.  The tCG takes the Hessian without its
    Weingarten term (a zero Euclidean gradient in its setup), positive
    semidefinite on the tangent space, so it runs all its iterations."""
    from dcora_tpu_torch.core import rtr, spmm, tiled
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.tools.spmm_bench import tile_blocks

    g = LocalGraph(0, 5, 3)
    g.set_measurements(read_g2o_file(path10k).pose_pose_measurements)
    P = g.problem_data(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    checks = {}
    for dtype in (torch.float32, torch.float64):
        dts = str(dtype).split(".")[-1]
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, pack="paired")
        tb = tile_blocks(TP.Q)
        for r_pad in (8, 16):
            X = torch.randn((r_pad, TP.meta.kpad), generator=gen,
                            dtype=dtype, device="cuda")
            for name, fn, blocks in (("spmm_tile", spmm.spmm_symmetric, tb),
                                     ("spmm_paired", spmm.spmm_paired,
                                      TP.Q.pairs)):
                checks[f"{name} grid10k {dts} r_pad {r_pad}"] = \
                    torch.equal(fn(blocks, X), fn(blocks, X))
        if dtype == torch.float32:
            Xf = tiled.retract_flat(TP.meta, torch.zeros_like(X[:8]),
                                    X[:8].clone())
            egrad = tiled.egrad_flat(TP, Xf)
            grad = rtr.FLAT_BACKEND.tangent(TP, Xf, egrad)
            radius = torch.tensor(1e8, dtype=torch.float64, device="cuda")
            before = spmm.spmm_paired.launches
            flat = torch.zeros_like(egrad)
            runs = [rtr.truncated_cg(TP, Xf, grad, flat, None, radius, 100,
                                     1e-12, 1.0, be=rtr.FLAT_BACKEND)
                    for _ in range(2)]
            require(spmm.spmm_paired.launches > before
                    and int(runs[0].inner_iters) == 100,
                    f"the flat tCG ran {int(runs[0].inner_iters)} of 100 "
                    f"iterations through kernel 3")
            checks[f"flat tCG grid10k paired f32 "
                   f"{int(runs[0].inner_iters)} iterations"] = \
                int(runs[0].inner_iters) == int(runs[1].inner_iters) \
                and torch.equal(runs[0].eta, runs[1].eta) \
                and torch.equal(runs[0].Heta, runs[1].Heta)
    return checks


def raslam_phase(torch, name, path, ref, r_max):
    """The RA-SLAM staircase on the card through the driver, at full size
    and the driver's own budget (200 RTR iterations, 200 tCG iterations,
    eta 1e-4) up to rank r_max.  At the result, the independent verifier
    (scipy, verification.verify_solution) must give the same lifted cost,
    the same Riemannian gradient norm and the same verdict as the port's
    certificate, and the cost must lie below the initial estimate's.  At
    r_max 20 (the driver's default) the result must certify, so the
    verifier's LDL^T witness of S + eta I >= 0 must hold, and its f* (the
    rounded and refined cost, as for PGO) must be the JAX package's where
    tests/data/torch_port_ra_reference.json has the set.  Every tile
    product must launch kernel 1 once, and no other SpMM kernel may run.
    Returns (launch counts, wall)."""
    import numpy as np

    from dcora_tpu_torch.core import lifted, problem as prob
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.core.manifold import manifold_error
    from dcora_tpu_torch.drivers.single_robot_raslam import (
        odometry_init_global, run)
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.verification import (
        sparse_Q_ra, split_measurements, verify_solution)

    res = {}
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        t0 = time.perf_counter()
        st, g, gm = run(path, r_max=r_max, device="cuda", verbose=False,
                        result=res)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = spmm.launch_counts()
    finally:
        restore()
    require(st.X.rot.is_cuda and st.rounded.sph.is_cuda,
            f"{name}: state tensors are not on CUDA")
    require(st.rounded.rot.shape == (g.n, 3, 3)
            and st.rounded.sph.shape == (g.l, 3)
            and st.rounded.trn.shape == (g.n + g.b, 3)
            and all(bool(torch.isfinite(x).all()) for x in st.rounded)
            and all(bool(torch.isfinite(x).all()) for x in st.X),
            f"{name}: bad state shape or values")
    require(float(manifold_error(st.X)) < 1e-10
            and float(manifold_error(st.rounded)) < 1e-10,
            f"{name}: the result is off the manifold")
    require(counts["spmm_sym"] == products[0] > 0,
            f"{name}: the strip kernel did not run once per tile product: "
            f"{counts}, {products[0]} products")
    require(counts["spmm_paired"] == 0 and counts["spmm_symmetric"] == 0,
            f"{name}: the RA solve launched another SpMM kernel: {counts}")
    require(counts["btd_solve"] > 0, f"{name}: the RA tile phases never "
            f"launched the BTD kernel: {counts}")
    require(counts["ldlt"] > 0 or not st.certified,
            f"{name}: certified without the LDL^T kernel: {counts}")
    t1 = time.perf_counter()
    rep = verify_solution(gm.relative_measurements, st.X, 3, eta=RA_ETA)
    verify_s = time.perf_counter() - t1
    # the verifier sums 0.5 <X Q, X> over Q's entries, whose terms grow
    # with the squared coordinates and cancel down to f: its rounding
    # error scales with 0.5 <|X| |Q|, |X|>, not with f (4.8e-7 of f on
    # ra10k's rank-3 iterate on the card); 1e-12 of it lies below the
    # worst case for ~1e5 terms per sum (1e5 * 2.2e-16)
    Q = sparse_Q_ra(*split_measurements(gm.relative_measurements), g.n, g.l,
                    g.b, 3)
    Xa = np.abs(lifted.to_flat(st.X).cpu().numpy())
    f_scale = 0.5 * float(np.sum((Xa @ abs(Q)) * Xa))
    f_tol = 1e-9 * abs(rep["f_indep"]) + 1e-12 * f_scale
    rel_f = abs(rep["f_indep"] - st.f_final) / abs(rep["f_indep"])
    # relative above 1, absolute below: both sum the gradient's terms in
    # f64, in another order, so small norms agree only to rounding
    rel_gn = abs(rep["gradnorm_indep"] - st.gradnorm_final) / \
        max(rep["gradnorm_indep"], 1.0)
    f, f_lifted = res["f_rounded"], st.f_final
    f_init = float(prob.cost(
        g.problem_data(device="cuda"),
        odometry_init_global(read_pyfg_file(path), gm).to("cuda")))
    stages = " ".join(f"{k}={v:.2f}s" for k, v in st.stage_seconds.items())
    phase(f"[raslam] {name}: n={g.n} l={g.l} b={g.b} r_max={r_max} "
          f"certified={st.certified} rank={st.final_rank} f*={f!r} lifted "
          f"f={f_lifted!r} (init {f_init!r}) gradnorm="
          f"{st.gradnorm_final:.3e} min_eig_history={st.min_eig_history} "
          f"ldl_witness={rep['certified_indep']} verifier: gradnorm "
          f"{rep['gradnorm_indep']:.3e} (rel {rel_gn:.1e}), min eig "
          f"{rep['min_eig_indep']:.3e}, f rel {rel_f:.1e} (tolerance "
          f"{f_tol / abs(rep['f_indep']):.1e}, 0.5<|X||Q|,|X|> "
          f"{f_scale:.3e}); "
          f"wall={wall:.2f}s (read {res['read_s']:.2f}s, init "
          f"{res['init_s']:.2f}s, staircase {res['staircase_s']:.2f}s: "
          f"{stages}) verify={verify_s:.2f}s; tile products {products[0]}, "
          f"launches {counts}")
    require(abs(rep["f_indep"] - f_lifted) <= f_tol, f"{name}: the lifted "
            f"cost {f_lifted!r} is not the independent verifier's "
            f"{rep['f_indep']!r}")
    require(rel_gn <= 1e-6, f"{name}: the gradient norm "
            f"{st.gradnorm_final!r} is not the verifier's "
            f"{rep['gradnorm_indep']!r}")
    require(bool(rep["certified_indep"]) == bool(st.certified),
            f"{name}: the port's "
            f"certificate says {st.certified}, the LDL^T verifier "
            f"{rep['certified_indep']}")
    require(f_lifted < f_init, f"{name}: the cost did not fall below the "
            f"initial estimate's ({f_lifted!r} >= {f_init!r})")
    if not st.certified:
        require(r_max < 20 and st.final_rank == r_max
                and st.min_eig_history[-1] < -RA_ETA,
                f"{name}: not certified (rank {st.final_rank})")
    if ref is not None and ref["certified"]:
        require(ref["n"] == g.n and ref["l"] == g.l,
                f"{name}: the reference is for another set")
        rel = abs(f - ref["f"]) / abs(ref["f"])
        rel_l = abs(f_lifted - ref["f_lifted"]) / abs(ref["f_lifted"])
        phase(f"[raslam] {name}: reference rank {ref['rank']} "
              f"f*={ref['f']!r}, rel {rel:.1e}; lifted {ref['f_lifted']!r} "
              f"at gradnorm {ref['gradnorm']:.3e}, rel {rel_l:.1e}")
        require(rel <= RA_F_RTOL, f"{name}: f* {f!r} vs reference "
                f"{ref['f']!r} (rel {rel:.2e} > {RA_F_RTOL:.0e})")
    return counts, wall


def init_phase(torch, path):
    """Chordal initialization of the 10,648-pose grid on the card and on the
    CPU (where the port ran it before it took the caller's device), timed
    both ways; the card's result is held to the CPU's."""
    import numpy as np

    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.io import read_g2o_file

    ms = read_g2o_file(path).pose_pose_measurements
    out = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = chordal_initialization(ms, device=dev)
        out[dev] = (time.perf_counter() - t0, T)
    ref = out["cpu"][1]
    err = float(np.abs(out["cuda"][1] - ref).max()) / float(np.abs(ref).max())
    phase("[init] grid10k chordal init: " + ", ".join(
        f"{k} {v[0]:.3f}s" for k, v in out.items()) + f", card vs CPU rel "
        f"{err:.1e} (n={len(ref)})")
    require(err <= INIT_TOL, f"chordal init on the card differs from the "
            f"CPU's: rel {err:.2e}")
    return {k: v[0] for k, v in out.items()}


def g2o100k_flat_rows(torch, TP, gen):
    """[g2o100k] flat_rhess (with the Weingarten term) and flat_precond on
    the 97,336-pose tiles at r_pad 8: against their plain versions (TOL;
    bitwise printed), timed in turns with them (CUDA events), on the
    device (profiler) beside the bound, and with CUDA events behind a
    sleep (common.queued_ms, device_ms's fallback).  Returns the kernel
    rows."""
    from dcora_tpu_torch.core import tiled
    from dcora_tpu_torch.tools import common

    meta, dt = TP.meta, str(TP.dtype).split(".")[-1]
    X, V, E = _flat_state(torch, tiled, meta, (8, meta.kpad), 5,
                          (gen, TP.dtype))
    aux = tiled.weingarten_setup(meta, X, V)
    cases = {
        "flat_rhess": (lambda: tiled.flat_rhess(meta, X, V, E, aux),
                       lambda: tiled._rhess_plain(meta, X, V, E, aux)),
        "flat_precond": (lambda: tiled.flat_precond(TP, X, V),
                         lambda: tiled._tangent_project_plain(
                             meta, X, tiled._precondition_pose_plain(TP, V)))}
    rows = []
    for kname, (kern, plain) in cases.items():
        out, ref = kern(), plain()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        require(bool(torch.isfinite(out).all()) and err <= TOL[dt] * scale,
                f"{kname} g2o100k {dt} disagrees with its plain version: "
                f"{err:.3e} > {TOL[dt]:.0e} * {scale:.3e}")
        same = torch.equal(out, ref)
        del out, ref
        ms, plain_ms = common.time_turns_ms([kern, plain], n=20)
        dev_ms = common.device_ms(kern)
        queued = common.queued_ms(kern)
        bound, by = common.flat_bound_ms(kname, meta, 8, 1, TP.dtype,
                                         hbm_gbs(torch))
        rows.append(dict(kernel=kname, problem="g2o100k", dtype=dt, r_pad=8,
                         live=5, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, library_ms=None, bound_ms=bound,
                         bound_by=by))
        phase(f"[g2o100k] {kname} {dt} r_pad=8: device {dev_ms:.4f} ms per "
              f"launch (common.device_ms), {bound / dev_ms:.1%} of its "
              f"bound {bound:.4f} ms ({by}); queued events {queued:.4f} ms"
              f"; events {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (20 back to back, median of 3 turns); "
              f"max_abs_err={err:.3e} (rel {err / scale:.2e}), bitwise the "
              f"plain version's: {same}")
    return rows


def g2o100k_phase(torch, tmp):
    """[g2o100k] The 97,336-pose grid (generate_large_scale_g2o, seed 100;
    46^3) on the card: the native reader, chordal init, both build_tiled
    dtypes (host seconds and peak RSS), kernel 1 against its plain version
    (spmm_strips_plain, not the dense tiles) on its Q at f32 and f64, r_pad
    8, beside torch.sparse.mm, the bound and the profiler's device time,
    and the two flat kernels likewise (g2o100k_flat_rows); then the first
    rank's solve (rank 5, solvers.rtr_fast at the g2o100k tool's budget:
    200 outers, 50 tCG) from the chordal init,
    Lambda(X) on the card and S's host assembly, each timed, held to the
    independent verifier's own functions (cost, Riemannian gradient norm)
    and the manifold.  Every tile product of the solve must launch kernel 1
    once, and kernels 2 and 3 never.  Returns (kernel rows, launch counts).
    The LDL^T proof and the staircase's climb run in
    tools/g2o100k_certify.py, not here."""
    import numpy as np

    from dcora_tpu_torch import datasets, solvers
    from dcora_tpu_torch import verification as V
    from dcora_tpu_torch.core import lifted, spmm, tiled
    from dcora_tpu_torch.core.certify import (
        _assemble_S_host, dual_certificate_blocks)
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.init import chordal_initialization
    from dcora_tpu_torch.core.manifold import manifold_error
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.tools import common
    from dcora_tpu_torch.tools.g2o100k_certify import rss_peak
    from dcora_tpu_torch.types import ROptParameters
    from dcora_tpu_torch.utils.timing import PhaseTimer, SimpleTimer

    pt, mem = PhaseTimer(), {}
    with pt.phase("generate"):
        path = datasets.generate_large_scale_g2o(
            os.path.join(tmp, "g2o100k.g2o"))
    with pt.phase("read"):
        ds = read_g2o_file(path)
    require(ds.reader == "native", f"g2o100k was read by the {ds.reader} "
            "parser, not the native one")
    ms = ds.pose_pose_measurements
    require(ds.num_poses == G2O100K_POSES, f"g2o100k has {ds.num_poses} "
            f"poses, not {G2O100K_POSES}")
    g = LocalGraph(0, 5, 3)
    g.set_measurements(ms)
    P = g.problem_data(device="cuda")
    iters = []
    with pt.phase("init"):
        T0 = chordal_initialization(ms, device="cuda", cg_iters=iters)
    with pt.phase("precond"):
        M = solvers.make_preconditioner(g, P)
    tile_pc = solvers._tile_preconditioner(g, P)
    reg = solvers.precond_reg(g, P) if tile_pc else 0.1
    tps = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).split(".")[-1]
        with rss_peak(mem, dt), pt.phase(f"build {dt}"):
            tps[dtype] = tiled.build_tiled(P, g.dims, dtype=dtype,
                                           precond=M, reg=reg,
                                           tile_precond=tile_pc)
            torch.cuda.synchronize()
    stats = common.q_stats(tps[torch.float64])
    phase(f"[g2o100k] n={g.n} edges={len(ms)} k={g.dims.k} reader="
          f"{ds.reader} precond={solvers.precond_build()}: generate "
          f"{pt.ms['generate'] / 1e3:.2f}s, read {pt.ms['read'] / 1e3:.2f}s, "
          f"chordal init on the card {pt.ms['init'] / 1e3:.2f}s (CG "
          f"iterations {iters}), precond {pt.ms['precond'] / 1e3:.2f}s, "
          f"build_tiled f32 {pt.ms['build float32'] / 1e3:.2f}s (host peak "
          f"RSS {mem['float32']:.2f} GB), f64 "
          f"{pt.ms['build float64'] / 1e3:.2f}s ({mem['float64']:.2f} GB); "
          f"{stats}; device memory {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, TP in tps.items():
        Q, kpad = TP.Q, TP.meta.kpad
        csr, stored_nnz = common.symmetric_csr(Q, kpad)
        X = torch.randn((8, kpad), generator=gen, dtype=dtype,
                        device="cuda")
        Xt = X.t().contiguous()
        cases = {"spmm_sym": (
            lambda: spmm.spmm_sym(Q.strips, X),  # noqa: B023
            lambda: spmm.spmm_strips_plain(Q.strips, X))}  # noqa: B023
        ref = spmm.spmm_strips_plain(Q.strips, X)
        bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(), 8,
                                     kpad, dtype, hbm_gbs(torch))
        rows += compare_and_time(
            torch, "g2o100k", cases,
            lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
            ref, X, 8, bound)
        dev_ms = common.device_ms(
            lambda: spmm.spmm_sym(Q.strips, X))  # noqa: B023
        rows[-1]["device_ms"] = dev_ms
        phase(f"[g2o100k] kernel 1 {str(dtype).split('.')[-1]} r_pad=8: "
              f"device {dev_ms:.4f} ms per product (common.device_ms), "
              f"{rows[-1]['bound_ms'] / dev_ms:.1%} of its bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
              f"stored nnz {stored_nnz}, full nnz {csr.values().numel()}")
        del csr, Xt, ref
        rows += g2o100k_flat_rows(torch, TP, gen)
    # the first rank's solve at the tool's budget, from the chordal init
    X0 = lifted.pad_rank(lifted.from_pose_array(T0, device="cuda"), 5)
    cfg = solvers.rtr_config_from_params(ROptParameters(
        gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=50))
    cache = solvers.TileCache(f32=tps[torch.float32],
                              f64=tps[torch.float64])
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        with pt.phase("solve"):
            res, _ = solvers.rtr_fast(g, P, M, X0, cfg, TP=cache)
            torch.cuda.synchronize()
        counts = spmm.launch_counts()
    finally:
        restore()
    del cache, tps
    timer = SimpleTimer()
    timer.tic()
    C = dual_certificate_blocks(P, res.X)
    lambda_ms = timer.toc(block_on=C)
    with rss_peak(mem, "S"), pt.phase("S"):
        S = _assemble_S_host(P, C, g.dims)
    # the independent verifier's own cost and gradient norm (scipy Q)
    with pt.phase("verifier"):
        Qv = V.sparse_Q_ra(*V.split_measurements(ms), g.n, 0, 0, 3)
        Xf = lifted.to_flat(res.X).cpu().numpy()
        f_v = 0.5 * float(np.sum((Xf @ Qv) * Xf))
        gn_v = V.riemannian_gradnorm(Qv, Xf, g.n, 0, 3)
    f_e, gn_e = float(res.f_final), float(res.gradnorm_final)
    rel_f = abs(f_v - f_e) / abs(f_v)
    rel_gn = abs(gn_v - gn_e) / max(gn_v, 1.0)
    man = float(manifold_error(res.X))
    phase(f"[g2o100k] rank-5 solve (rtr_fast, 200 outers x 50 tCG): "
          f"{pt.ms['solve'] / 1e3:.2f}s, f={f_e!r} gradnorm={gn_e:.3e} "
          f"outers {res.outer_iters}; verifier f={f_v!r} (rel {rel_f:.1e}), "
          f"gradnorm {gn_v:.3e} (|diff| {abs(gn_v - gn_e):.1e}, rel "
          f"{abs(gn_v - gn_e) / gn_v:.1e}), manifold error {man:.1e}; "
          f"Lambda(X) on the card {lambda_ms:.2f} ms, S host assembly "
          f"{pt.ms['S'] / 1e3:.2f}s (nnz {S.nnz}, peak RSS {mem['S']:.2f} "
          f"GB), verifier {pt.ms['verifier'] / 1e3:.2f}s; tile products "
          f"{products[0]}, launches {counts}")
    require(rel_f <= 1e-8, f"g2o100k: the engine's cost {f_e!r} is not the "
            f"verifier's {f_v!r} (rel {rel_f:.2e} > 1e-8)")
    # relative above 1, absolute below (as [raslam]): near the optimum the
    # gradient is what is left of sums of terms ~1e6 in size, so each
    # engine's rounding is ~1e-7 in absolute terms
    require(rel_gn <= 1e-6, f"g2o100k: the gradient norm {gn_e!r} is not "
            f"the verifier's {gn_v!r}")
    require(man <= 1e-10, f"g2o100k: manifold error {man:.2e}")
    require(bool(np.isfinite(Xf).all()) and Xf.shape == (5, g.dims.k),
            "g2o100k: bad state shape or values")
    require(counts["spmm_sym"] == products[0] > 0,
            f"g2o100k: kernel 1 did not run once per tile product: "
            f"{counts}, {products[0]} products")
    require(counts["spmm_paired"] == 0 and counts["spmm_symmetric"] == 0,
            f"g2o100k: the solve launched another SpMM kernel: {counts}")
    del S, C, P, res
    torch.cuda.empty_cache()
    return rows, counts


def parity_phase(torch, tmp):
    """[parity] tools.parity.run_config on tinyGrid3D and smallGrid3D (the
    generated test sets) on the card: the staircase, rounding and the
    independent verifier, whose LDL^T witness must certify; the port's own
    proof must run the LDL^T kernel.  Returns its launches per set."""
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.tools import parity

    data = datasets.ensure_test_datasets(os.path.join(tmp, "parity_data"))
    launches = {}
    for name in ("tinyGrid3D", "smallGrid3D"):
        t0 = time.perf_counter()
        before = ldlt_launches()
        rec = parity.run_config(name, data, "cuda", state_dir=os.path.join(
            tmp, "parity_state"), checkpoint_dir=tmp)
        launches[f"parity {name}"] = ldlt_launches() - before
        phase(f"[parity] {name}: certified={rec['certified']} "
              f"certified_indep={rec['certified_indep']} rank="
              f"{rec['final_rank']} f*={rec['f_final']!r} (scipy "
              f"{rec['f_indep']!r}), indep gradnorm "
              f"{rec['gradnorm_indep']:.2e}, ATE {rec.get('ate_vs_gt')}, "
              f"platform {rec['platform']!r}, ldlt launches "
              f"{launches[f'parity {name}']}, "
              f"{time.perf_counter() - t0:.2f}s")
        require(rec["certified_indep"] is True and rec["certified"],
                f"[parity] {name} is not certified")
        require(launches[f"parity {name}"] > 0,
                f"[parity] {name}: certified without the LDL^T kernel")
    return launches


def _robust_refs():
    with open(ROBUST_REFERENCE) as fh:
        return json.load(fh)


def _lifting(refs):
    import numpy as np

    mats = refs["lifting_matrices"]
    return lambda r: np.array(mats[str(r)])


def gnc_phase(torch, tmp, refs):
    """The centralized GNC (drivers.single_robot_gnc.run, solveRobustPGO at
    the driver's parameters) on gnc2500 (tools.robust_bench.gnc_set, 15 %
    planted outliers, seed 7): every stage a solve_pgo at 2,500 poses, so
    every stage's tile products run kernel 1, once each.  Held to the JAX
    package's rejected set, its final weights (GNC_W_ATOL) and the weighted
    problem's cost at the result (GNC_FW_RTOL), and coarsely to its cost on
    the clean problem (GNC_F_RTOL; the 1e-6 asked of it is not met on the
    card) and its verifier's verdict there.  Returns (launch counts, the
    corrupted measurements at their final weights, wall)."""
    import numpy as np

    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.tools import robust_bench

    ref = refs["gnc2500"]
    require(ref["kwargs"] == dict(robust_bench.GNC_GRID, shape=[10, 10, 25]),
            "gnc2500: the reference was made from another set")
    path = robust_bench.gnc_set(tmp)
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        rec, ms = robust_bench.central(path, device="cuda")
        torch.cuda.synchronize()
        counts = spmm.launch_counts()
    finally:
        restore()
    rel = abs(rec["f_on_clean"] - ref["f_on_clean"]) / abs(ref["f_on_clean"])
    got = {tuple(k) for k in rec["rejected"]}
    want = {tuple(k) for k in ref["rejected"]}
    n = max(rec["stages"], 1)
    keys = sorted(ref["weights"])
    require(sorted(rec["weights"]) == keys,
            "gnc2500: the weighted edges differ from JAX's")
    wj = np.array([ref["weights"][k] for k in keys])
    wt = np.array([rec["weights"][k] for k in keys])
    undecided = (wj >= 1e-8) & (wj <= 1 - 1e-8)
    w_err = float(np.abs(wt - wj).max())
    rel_w = abs(rec["f_weighted"] - ref["f_weighted"]) / \
        abs(ref["f_weighted"])
    phase(f"[gnc] gnc2500: n={rec['n']} edges={rec['edges']} planted "
          f"outliers={rec['outliers']} stages={rec['stages']} rejected "
          f"{len(got)} (JAX {len(want)}, {len(got ^ want)} differ) "
          f"classification {rec['classification']}; final weights against "
          f"JAX's: max diff {w_err:.2e} over {len(keys)} ("
          f"{int(undecided.sum())} undecided in JAX: max diff "
          f"{float(np.abs(wt - wj)[undecided].max(initial=0.0)):.2e}); "
          f"weighted problem f {rec['f_weighted']!r} (JAX "
          f"{ref['f_weighted']!r}, rel {rel_w:.1e}), gradnorm "
          f"{rec['gradnorm_weighted']:.3e} (JAX "
          f"{ref['gradnorm_weighted']:.3e}); clean-problem f "
          f"{rec['f_on_clean']!r} (JAX {ref['f_on_clean']!r}, rel "
          f"{rel:.1e}), gradnorm {rec['gradnorm_on_clean']:.3e}, verifier "
          f"certified={rec['certified_on_clean']} (JAX "
          f"{ref['certified_on_clean']}); wall {rec['wall_s']:.2f}s: chordal "
          f"init {rec['init_s']:.2f}s, build_tiled {rec['build_s']:.2f}s, "
          f"rtr_fast and the rest {rec['solve_s']:.2f}s; per stage "
          f"{rec['wall_s'] / n:.2f}s = {rec['init_s'] / n:.2f} + "
          f"{rec['build_s'] / n:.2f} + {rec['solve_s'] / n:.2f}s; tile "
          f"products {products[0]}, launches {counts}")
    require(got == want, f"gnc2500: the rejected set differs from JAX's in "
            f"{len(got ^ want)} edges")
    require(w_err <= GNC_W_ATOL, f"gnc2500: the final weights differ from "
            f"JAX's by {w_err:.2e}")
    require(rel_w <= GNC_FW_RTOL, f"gnc2500: the weighted problem's cost "
            f"differs from JAX's: rel {rel_w:.2e}")
    require(rel <= GNC_F_RTOL, f"gnc2500: the clean-problem cost differs "
            f"from JAX's: rel {rel:.2e}")
    require(rec["certified_on_clean"] == ref["certified_on_clean"],
            "gnc2500: the verifier's verdict differs from JAX's")
    require(counts["spmm_sym"] == products[0] > 0,
            f"gnc2500: kernel 1 did not run once per tile product: "
            f"{counts}, {products[0]} products")
    require(counts["spmm_paired"] == 0 and counts["spmm_symmetric"] == 0,
            f"gnc2500: another SpMM kernel ran: {counts}")
    return counts, ms, rec["wall_s"]


def gnc_kernel_phase(torch, ms):
    """Kernel 1 on the last GNC stage's Q (the rejected edges at weight 0)
    against its plain version, torch.sparse.mm and the bound, at f32/f64 x
    r_pad 8/16; the strips drop the sub-blocks that the zero weights
    empty, the dense tiles keep them."""
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.solvers import build_pgo_graph, make_preconditioner
    from dcora_tpu_torch.tools import common

    g = build_pgo_graph(ms)
    P = g.problem_data(device="cuda")
    M = make_preconditioner(g, P)
    saved = [m.weight for m in ms]
    for m in ms:
        m.weight = 1.0
    g1 = build_pgo_graph(ms)
    P1 = g1.problem_data(device="cuda")  # reads the weights: before restore
    for m, w in zip(ms, saved):
        m.weight = w
    full = tiled.build_tiled(P1, g1.dims, dtype=torch.float32,
                             precond=make_preconditioner(g1, P1))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.float64):
        TP = tiled.build_tiled(P, g.dims, dtype=dtype, precond=M)
        Q, kpad = TP.Q, TP.meta.kpad
        csr, stored_nnz = common.symmetric_csr(Q, kpad)
        phase(f"[gnc tiles] gnc2500 last stage {str(dtype).split('.')[-1]}: "
              f"{common.q_stats(TP)}; unit weights: "
              f"{full.Q.strips.src.numel()} blocks")
        require(Q.strips.src.numel() < full.Q.strips.src.numel(),
                "the zero weights emptied no sub-block")
        for r_pad in (8, 16):
            X = torch.randn((r_pad, kpad), generator=gen, dtype=dtype,
                            device="cuda")
            Xt = X.t().contiguous()
            cases = {"spmm_sym": (
                lambda: spmm.spmm_sym(Q.strips, X),  # noqa: B023
                lambda: spmm.spmm_strips_plain(Q.strips, X))}  # noqa: B023
            dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
            bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(),
                                         r_pad, kpad, dtype, hbm_gbs(torch))
            rows += compare_and_time(
                torch, "gnc2500", cases,
                lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
                dense, X, r_pad, bound)
    return rows


def agent_gnc_phase(torch, tmp, refs):
    """One agent's GNC-TLS local initialization (agent.Agent, Agent.cpp:
    379-418) on robot 0's 500-pose block of the corrupted gnc2500: a
    solveRobustPGO on the card whose stages run kernel 1 once per tile
    product.  Held to the JAX agent's rejected loop closures."""
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.agent import Agent
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.drivers.multi_robot_pgo import partition_measurements
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.tools import robust_bench
    from dcora_tpu_torch.types import AgentParameters, InitializationMethod

    ref = refs["gnc2500_agent"]
    ds = read_g2o_file(robust_bench.gnc_set(tmp))
    corrupted, _ = datasets.corrupt_with_outliers(
        ds.pose_pose_measurements, **robust_bench.GNC_CORRUPT)
    odo, priv, shared, _ = partition_measurements(corrupted, ds.num_poses, 5)
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        t0 = time.perf_counter()
        a = Agent(0, AgentParameters(
            d=3, r=5, robotIDs=frozenset(range(5)),
            localInitializationMethod=InitializationMethod.GNC_TLS),
            device="cuda", lifting_matrix=_lifting(refs)(5))
        a.set_measurements(odo[0] + priv[0] + shared[0])
        a.initialize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = spmm.launch_counts()
    finally:
        restore()
    got = sorted([m.p1, m.p2] for m in priv[0] if m.weight < 1e-8)
    t_sum = float(abs(a.trajectory_local_init).sum())
    phase(f"[gnc agent] robot 0 of gnc2500: n={a.num_poses}, "
          f"{len(priv[0])} private loop closures, GNC-TLS init rejects "
          f"{len(got)} (JAX {len(ref['rejected'])}); sum|T| {t_sum!r} (JAX "
          f"{ref['T_sum']!r}); wall {wall:.2f}s; tile products "
          f"{products[0]}, launches {counts}")
    require(a.num_poses == ref["n"] >= 500, "the agent's block is not the "
            "reference's or is below the tiled solver's threshold")
    require(got == ref["rejected"], "the agent's GNC-TLS init rejects "
            "other loop closures than JAX's")
    require(counts["spmm_sym"] == products[0] > 0,
            f"the agent's GNC-TLS init did not run kernel 1 once per tile "
            f"product: {counts}, {products[0]} products")
    require(counts["spmm_paired"] == 0 and counts["spmm_symmetric"] == 0,
            f"the agent's GNC-TLS init ran another SpMM kernel: {counts}")
    return counts


def mr_phase(torch, tmp, refs):
    """DC2-PGO (drivers.multi_robot_pgo.run) with 5 robots on smallGrid3D
    from the Chordal init at the driver's defaults, on the card: it must
    certify at JAX's rank with JAX's f* (1e-8).  Returns (the file, the
    result): [parallel certify] certifies its optimum again, sharded."""
    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.drivers import multi_robot_pgo
    from dcora_tpu_torch.types import InitializationMethod

    ref = refs["mr_smallGrid3D"]
    kw = dict(ref["kwargs"], shape=tuple(ref["kwargs"]["shape"]))
    path = datasets.generate_grid_g2o(os.path.join(tmp, "mr_small.g2o"),
                                      **kw)
    t0 = time.perf_counter()
    res = multi_robot_pgo.run(ref["robots"], path,
                              init_method=InitializationMethod.Chordal,
                              device="cuda", lifting_matrix=_lifting(refs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    f = res.cost_trace[-1]
    rel = abs(f - ref["f"]) / abs(ref["f"])
    rounds = len(res.cost_trace)
    ms_round = 1e3 * res.rbcd_s / max(rounds, 1)
    phase(f"[multi-robot] smallGrid3D, {ref['robots']} robots: certified="
          f"{res.certified} rank={res.final_rank} (JAX {ref['rank']}) f*="
          f"{f!r} (JAX {ref['f']!r}, rel {rel:.1e}) rounds {rounds} "
          f"(JAX {ref['rounds']}); wall {wall:.2f}s, RBCD {res.rbcd_s:.2f}s"
          f" = {ms_round:.3f} ms per round")
    require(res.X.rot.is_cuda, "DC2-PGO: the state is not on the card")
    require(res.certified and ref["certified"], "DC2-PGO: not certified")
    require(res.final_rank == ref["rank"], "DC2-PGO: rank differs")
    require(rel <= MR_F_RTOL, f"DC2-PGO: f* rel {rel:.2e} > {MR_F_RTOL}")
    return path, res


def dist_gnc_phase(torch, tmp, refs):
    """The distributed GNC (multi_robot_pgo.run with GNC-TLS at the JAX
    tool's parameters) on gnc2500, 5 robots of 500 poses, at the JAX
    reference's cut: 32 rounds at rank 5, with a weight update after 6
    inner iterations, so that the first update runs at round 30, while the
    two engines' iterates still agree.  Every round's cost is held to JAX's
    (DIST_RTOL), every weight after the update to JAX's (DIST_W_RTOL), and
    two classifications to JAX's: weight < 0.5 (after the first update
    every weight lies below it in both engines, since the adaptive mu comes
    from the team's largest residual) and the split of the edges into the
    as many lowest weights as there are planted outliers and the rest.
    Returns ms per round."""
    import numpy as np

    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.tools import robust_bench

    ref = refs["gnc2500_dist"]
    path = robust_bench.gnc_set(tmp)
    rec = robust_bench.distributed(
        path, tmp, ref["rounds_per_rank"], device="cuda", r_max=ref["r_max"],
        robust_inner_iters=ref["robust_inner_iters"],
        lifting_matrix=_lifting(refs))
    require(len(rec["cost_trace"]) == len(ref["cost_trace"]),
            f"distributed GNC: {len(rec['cost_trace'])} rounds, JAX "
            f"{len(ref['cost_trace'])}")
    rels = np.abs(np.subtract(rec["cost_trace"], ref["cost_trace"])) / \
        np.abs(ref["cost_trace"])
    keys = sorted(ref["weights"])
    require(sorted(rec["weights"]) == keys,
            "distributed GNC: the weighted edges differ from JAX's")
    wj = np.array([ref["weights"][k] for k in keys])
    wt = np.array([rec["weights"][k] for k in keys])
    w_rel = float((np.abs(wt - wj) / np.maximum(wj, 1e-300)).max())
    k = ref["classification"]["tp"] + ref["classification"]["fn"]
    low_j = {keys[i] for i in np.argsort(wj, kind="stable")[:k]}
    low_t = {keys[i] for i in np.argsort(wt, kind="stable")[:k]}
    _, outliers = datasets.corrupt_with_outliers(
        read_g2o_file(path).pose_pose_measurements,
        **robust_bench.GNC_CORRUPT)
    planted = {f"{a},{b}" for a, b in outliers}
    phase(f"[multi-robot] distributed GNC on gnc2500, 5 robots, "
          f"{ref['rounds_per_rank']} rounds per rank, inner budget "
          f"{ref['robust_inner_iters']}, r_max {ref['r_max']}: rank "
          f"{rec['final_rank']} (JAX {ref['final_rank']}), rounds "
          f"{rec['rounds']} (JAX {ref['rounds']}); cost per round against "
          f"JAX's: max rel {rels.max():.1e}; cost at the cap "
          f"{rec['final_cost']!r} (JAX {ref['final_cost']!r}); "
          f"{int((wt < 1).sum())} weights below 1 (JAX "
          f"{int((wj < 1).sum())}), in [{wt.min():.2e}, {wt.max():.2e}], "
          f"max rel diff {w_rel:.1e}; classification at 0.5 "
          f"{rec['classification']} (JAX {ref['classification']}); the {k} "
          f"lowest weights: {len(low_t & planted)} planted (JAX "
          f"{len(low_j & planted)}), {len(low_t ^ low_j)} edges differ; "
          f"wall {rec['wall_s']:.2f}s, {rec['ms_per_round']:.3f} ms per "
          f"round")
    require(rec["final_rank"] == ref["final_rank"]
            and rec["rounds"] == ref["rounds"],
            "distributed GNC: rank or rounds differ from JAX's")
    require(rels.max() <= DIST_RTOL, f"distributed GNC: the costs per round "
            f"differ from JAX's: {rels.max():.2e}")
    require(int((wt < 1).sum()) == int((wj < 1).sum()) > 0,
            "distributed GNC: the weight update did not run as JAX's")
    require(w_rel <= DIST_W_RTOL, f"distributed GNC: the weights differ "
            f"from JAX's: rel {w_rel:.2e}")
    require(rec["classification"] == ref["classification"],
            "distributed GNC: the classification differs from JAX's")
    require(low_t == low_j,
            "distributed GNC: the lowest weights are not JAX's edges")
    return rec["ms_per_round"]


def mr_ra_phase(torch, name, path, refs):
    """DCORA (drivers.multi_robot_raslam.run) on the card at the JAX
    reference's cut (rank 3 only: ``while r < r_max`` stops at r_max 4):
    every round's cost against JAX's (MR_RA_F_RTOL), the certificate, rank
    and rounds as JAX's, and the independent verifier's verdict at the
    result as the driver's.  On ra500 no robot's block is ever optimized,
    in either engine: every robot ranges to the landmarks, whose states the
    map agent never shares (the driver gives it no measurements), so its
    cost stays at the initial estimate's.  ra500_nl is ra500 without its
    landmarks: the robots range to each other only, every block optimizes
    and the cost must fall.  A certificate must run the LDL^T kernel.
    Returns (the wall, its launches)."""
    import numpy as np

    from dcora_tpu_torch.drivers import multi_robot_raslam
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.verification import verify_solution

    ref = refs["mr_" + name]
    before = ldlt_launches()
    t0 = time.perf_counter()
    res = multi_robot_raslam.run(path, device="cuda",
                                 lifting_matrix=_lifting(refs),
                                 num_iters=ref["num_iters"],
                                 r_max=ref["r_max"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ldlt = ldlt_launches() - before
    trace, rounds = np.array(res.cost_trace), len(res.cost_trace)
    require(rounds == ref["rounds"] == len(ref["cost_trace"]),
            f"DCORA {name}: {rounds} rounds, JAX {ref['rounds']}")
    rels = np.abs(trace - ref["cost_trace"]) / np.abs(ref["cost_trace"])
    gm = get_global_measurements(read_pyfg_file(path))
    rep = verify_solution(gm.relative_measurements, res.X, 3, eta=1e-3)
    phase(f"[multi-robot-ra] {name} (num_iters {ref['num_iters']}, r_max "
          f"{ref['r_max']}): certified={res.certified} (JAX "
          f"{ref['certified']}) rank={res.final_rank} (JAX {ref['rank']}) "
          f"rounds {rounds} (JAX {ref['rounds']}); cost {float(trace[0])!r} "
          f"-> {float(trace[-1])!r} (JAX {ref['f']!r}), per round against JAX's: max "
          f"rel {rels.max():.1e}; verifier at the result: certified="
          f"{rep['certified_indep']}, gradnorm {rep['gradnorm_indep']:.3e}; "
          f"ldlt launches {n_ldlt}; "
          f"wall {wall:.2f}s, {1e3 * res.rbcd_s / max(rounds, 1):.3f} "
          f"ms per round")
    require(n_ldlt > 0 or not res.certified,
            f"DCORA {name}: certified without the LDL^T kernel")
    require(res.X.rot.is_cuda, f"DCORA {name}: the state is not on the card")
    require(res.certified == ref["certified"]
            and res.final_rank == ref["rank"],
            f"DCORA {name}: certificate or rank differ from JAX's")
    require(rels.max() <= MR_RA_F_RTOL, f"DCORA {name}: the costs per round "
            f"differ from JAX's: rel {rels.max():.2e}")
    require(bool(rep["certified_indep"]) == bool(res.certified),
            f"DCORA {name}: the verifier's verdict differs from the "
            f"driver's")
    if name == "ra500_nl":
        require(trace[-1] < 1e-3 * trace[0],
                f"DCORA {name}: the cost did not fall")
    return wall, n_ldlt


def _cost_trace(res):
    import numpy as np

    return np.array([c for _, c, _ in res.trace])


def _held(name, got, want, tol):
    """max relative difference of two cost traces, required <= tol."""
    import numpy as np

    want = np.asarray(want)
    require(len(got) == len(want), f"{name}: {len(got)} rounds, reference "
            f"{len(want)}")
    rel = float((np.abs(got - want) / np.abs(want)).max())
    require(rel <= tol, f"{name}: the costs per round differ from the "
            f"reference: rel {rel:.2e} > {tol:.0e}")
    return rel


def _grid_fleet(path, A):
    """The par_grid10k ParallelRBCDProblem, as drivers.parallel_pgo builds
    it."""
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.drivers.multi_robot_pgo import partition_measurements
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.parallel.rbcd import build_parallel_problem

    ds = read_g2o_file(path)
    ms = ds.pose_pose_measurements
    odo, priv, shared, _ = partition_measurements(ms, ds.num_poses, A)
    graphs = []
    for a in range(A):
        g = LocalGraph(a, 5, ds.dim)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    return build_parallel_problem(graphs)


def par_grid_phase(torch, path, ref):
    """[parallel] drivers.parallel_pgo.run on grid10k in 8 agents of 1,331
    poses at rank 5, the driver's RTR settings, on the card: (a) the edge
    path at f64 and (b) the tiled path at f64 tiles, each 30 rounds with
    every round's central cost held to JAX's (round 1 to PAR_RTOL, every
    round to PAR_GRID_RTOL); (c) the driver's
    default, f32 tiles, 100 rounds timed, its first 30 rounds' costs held
    to (b)'s (PAR_F32_RTOL) and its cost never rising.  Kernel 1 must
    launch once per batched tile product across (b) and (c), for all eight
    agents together, and kernels 2 and 3 never.  Returns (launch counts,
    the result of (a), the padded problem)."""
    import numpy as np

    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.drivers import parallel_pgo

    A, n = ref["agents"], 10_648

    def run(backend, dtype, rounds):
        t0 = time.perf_counter()
        res = parallel_pgo.run(A, path, max_rounds=rounds,
                               rgrad_norm_tol=0.0, check_every=1,
                               backend=backend, tile_dtype=dtype,
                               device="cuda")
        require(res.X.rot.is_cuda, "parallel PGO: the state is not on the "
                "card")
        return res, time.perf_counter() - t0

    res_a, wall_a = run("edge", torch.float64, 30)
    rel_a = [_held("par_grid10k edge", _cost_trace(res_a)[:k],
                   ref["edge"]["cost_trace"][:k], tol)
             for k, tol in ((1, PAR_RTOL), (30, PAR_GRID_RTOL))]
    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        res_b, wall_b = run("tiled", torch.float64, 30)
        res_c, wall_c = run("tiled", torch.float32, 100)
        counts = spmm.launch_counts()
    finally:
        restore()
    require(counts["spmm_sym"] == products[0] > 0,
            f"parallel tiled rounds: kernel 1 did not launch once per "
            f"batched tile product: {counts}, {products[0]} products")
    require(counts["spmm_symmetric"] == counts["spmm_paired"] == 0,
            f"parallel tiled rounds launched another kernel: {counts}")
    cb, cc = _cost_trace(res_b), _cost_trace(res_c)
    rel_b = [_held("par_grid10k tiled f64", cb[:k],
                   ref["tiled"]["cost_trace"][:k], tol)
             for k, tol in ((1, PAR_RTOL), (30, PAR_GRID_RTOL))]
    rel_c = float((np.abs(cc[:30] - cb) / np.abs(cb)).max())
    rise = float((np.diff(cc) / np.abs(cc[:-1])).max())
    pp = _grid_fleet(path, A)
    real, padded = res_c.columns
    ms = {k: 1e3 * r.rounds_s / r.rounds
          for k, r in (("edge", res_a), ("tiled_f64", res_b),
                       ("tiled_f32", res_c))}
    phase(f"[parallel] grid10k, {A} agents of {pp.n_max} poses, rank 5: "
          f"(a) edge f64 30 rounds, cost {float(cb[0])!r} -> "
          f"{float(_cost_trace(res_a)[-1])!r}, against JAX's: round 1 rel "
          f"{rel_a[0]:.1e}, every round max rel {rel_a[1]:.1e}, "
          f"{ms['edge']:.3f} ms per round (wall {wall_a:.2f}s); (b) tiled "
          f"f64 30 rounds, round 1 rel {rel_b[0]:.1e}, every round max rel "
          f"{rel_b[1]:.1e}, "
          f"{ms['tiled_f64']:.3f} ms per round (wall {wall_b:.2f}s); (c) "
          f"tiled f32 (the driver's default) 100 rounds, "
          f"{ms['tiled_f32']:.3f} ms per round, "
          f"{res_c.rounds * n / res_c.rounds_s:.0f} pose-updates/s (wall "
          f"{wall_c:.2f}s), first 30 rounds against (b) max rel "
          f"{rel_c:.1e}, largest rise {rise:.1e}, cost {float(cc[0])!r} -> "
          f"{float(cc[-1])!r}; kernel 1 {counts['spmm_sym']} launches = "
          f"{products[0]} batched tile products; padding: {real} real "
          f"scalar columns of {padded} ({100 * (1 - real / padded):.2f} %)")
    require(rel_c <= PAR_F32_RTOL, f"par_grid10k: the f32 rounds part from "
            f"the f64 rounds: rel {rel_c:.2e} > {PAR_F32_RTOL:.0e}")
    require(rise <= PAR_F32_RISE and cc[-1] < cc[0],
            f"par_grid10k: the f32 rounds' cost rose (rel {rise:.2e})")
    return counts, res_a, pp


def par_profile_phase(torch, pp, X):
    """[parallel profile] 20 rounds of par_grid10k's edge path and 10 of
    its tiled f32 path under torch.profiler (device activity only): the
    device's busy share (the union of kernel intervals over the host's
    wall, after a synchronize) and the host's share."""
    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG
    from dcora_tpu_torch.parallel.rbcd import ParallelRound
    from dcora_tpu_torch.tools.profile_slice import _kernel_summary

    out = {}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for name, rounds, kw in (
            ("edge", 20, dict(backend="edge")),
            ("tiled f32", 10, dict(backend="tiled",
                                   tile_dtype=torch.float32))):
        rnd = ParallelRound(pp, ROUND_CFG, device="cuda", **kw)
        Xr = X
        for _ in range(2):
            Xr, _ = rnd(Xr)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                Xr, _ = rnd(Xr)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k = _kernel_summary(prof)
        busy = k["kernel_busy_s"] / wall
        out[name] = (wall, busy)
        top = ", ".join(f"{e['name'][:40]} {e['count']}x "
                        f"{1e3 * e['seconds']:.1f}ms"
                        for e in k["by_name"][:4])
        phase(f"[parallel profile] grid10k {name}, {rounds} rounds: wall "
              f"{1e3 * wall:.1f} ms ({1e3 * wall / rounds:.3f} ms per round "
              f"under the profiler), device busy {100 * busy:.1f} %, host "
              f"{100 * (1 - busy):.1f} %; {k['kernels']} kernels; top: "
              f"{top}")
    return out


def par_kernel_phase(torch, pp):
    """[parallel kernel] kernel 1 on the 8 agents' stacked strips against
    spmm_strips_plain, f32 and f64 at r_pad 8, timed in turns beside
    torch.sparse.mm on the same block-diagonal Q and the bytes bound; and
    the eight agents' own launches in a row, event and device time."""
    from dcora_tpu_torch.core import spmm
    from dcora_tpu_torch.parallel.rbcd import build_stacked_tiled
    from dcora_tpu_torch.tools import common

    rows = []
    A = pp.num_agents
    gen = torch.Generator(device="cuda").manual_seed(8)
    for dtype in (torch.float32, torch.float64):
        TP = build_stacked_tiled(pp, 0, A, dtype, "cuda")
        Q, width = TP.Q, A * TP.meta.kpad
        X = torch.randn((8, width), generator=gen, dtype=dtype,
                        device="cuda")
        csr, stored_nnz = common.symmetric_csr(Q, width)
        Xt = X.t().contiguous()
        dense = spmm.spmm_sym_plain(Q.tiles, Q.tile_rows, Q.tile_cols, X)
        bound = common.spmm_bound_ms(stored_nnz, csr.values().numel(), 8,
                                     width, dtype, hbm_gbs(torch))
        st = common.q_stats(TP)
        phase(f"[parallel kernel] {str(dtype).split('.')[-1]}: {A} agents' "
              f"strips side by side: {st['strips']} strips, {st['blocks']} "
              f"non-empty 4x4 blocks, {st['strip_mb']:.2f} MB")
        rows += compare_and_time(
            torch, "par_grid10k", {"spmm_sym": (
                lambda: spmm.spmm_sym(Q.strips, X),  # noqa: B023
                lambda: spmm.spmm_strips_plain(Q.strips, X))},  # noqa: B023
            lambda: torch.sparse.mm(csr, Xt),  # noqa: B023
            dense, X, 8, bound)
        per = [build_stacked_tiled(pp, a, a + 1, dtype, "cuda").Q.strips
               for a in range(A)]
        kp = TP.meta.kpad
        Xa = [X[:, a * kp:(a + 1) * kp].contiguous() for a in range(A)]
        W = spmm.spmm_sym(Q.strips, X)
        for a in range(A):
            Wa = spmm.spmm_sym(per[a], Xa[a])
            require(torch.equal(Wa, W[:, a * kp:(a + 1) * kp]),
                    f"kernel 1: agent {a}'s own product differs from its "
                    f"part of the stacked product")

        def each():
            for a in range(A):
                spmm.spmm_sym(per[a], Xa[a])  # noqa: B023

        def stacked():
            spmm.spmm_sym(Q.strips, X)  # noqa: B023

        ev = common.time_turns_ms([stacked, each])
        dev = [common.device_ms(stacked), common.device_ms(each)]
        dt = str(dtype).split(".")[-1]
        rows[-1].update(per_agent_ms=ev[1], device_ms=dev[0],
                        per_agent_device_ms=dev[1])
        phase(f"[parallel kernel] {dt} r_pad=8: {A} agents' strips "
              f"stacked, one launch: {ev[0]:.4f} ms event, {dev[0]:.4f} ms "
              f"device; the agents' {A} own launches in a row: {ev[1]:.4f} "
              f"ms event, {dev[1]:.4f} ms device; each agent's part of the "
              f"stacked product bitwise its own")
    return rows


def par_ra_phase(torch, paths, ref):
    """[parallel-ra] drivers.parallel_raslam.run on the card: ra500_nl at
    rank 3, 30 rounds on the edge path and on f64 tiles, every round's
    central cost held to JAX's (PAR_RTOL); ra10k_nl (9,750 poses, no
    landmarks) 10 edge rounds held to JAX's, then 50 rounds at the
    driver's default (f32 tiles) timed; ra500, which has landmarks, raises
    the JAX package's KeyError.  Returns the kernel launch counts of its
    tiled runs."""
    import numpy as np

    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.drivers import parallel_raslam

    def run(name, backend, dtype, rounds):
        t0 = time.perf_counter()
        res = parallel_raslam.run(paths[name], max_rounds=rounds,
                                  rgrad_norm_tol=0.0, check_every=1,
                                  backend=backend, tile_dtype=dtype,
                                  device="cuda")
        require(res.X.rot.is_cuda, "parallel RA: the state is not on the "
                "card")
        return res, time.perf_counter() - t0

    products, restore = counting_products(tiled)
    try:
        spmm.reset_launches()
        out = {}
        for backend in ("edge", "tiled"):
            out[backend] = run("ra500_nl", backend, torch.float64, 30)
        ra10k = run("ra10k_nl", "edge", torch.float64, 10)
        ra10k_def = run("ra10k_nl", "tiled", torch.float32, 50)
        counts = spmm.launch_counts()
    finally:
        restore()
    require(counts["spmm_sym"] == products[0] > 0
            and counts["spmm_symmetric"] == counts["spmm_paired"] == 0,
            f"parallel RA: not one kernel-1 launch per tile product: "
            f"{counts}, {products[0]} products")
    msg = []
    for name, res in (("ra500_nl", out["edge"][0]), ("ra10k_nl", ra10k[0])):
        real, padded = res.columns
        msg.append(f"{name} padding: {real} real scalar columns of "
                   f"{padded} ({100 * (1 - real / padded):.2f} %)")
    for backend, (res, wall) in out.items():
        c = _cost_trace(res)
        rel = _held(f"par_ra500_nl {backend}", c,
                    ref["par_ra500_nl"][backend]["cost_trace"], PAR_RTOL)
        msg.append(f"{backend} f64 30 rounds {float(c[0])!r} -> "
                   f"{float(c[-1])!r}, max "
                   f"rel {rel:.1e}, {1e3 * res.rounds_s / res.rounds:.3f} "
                   f"ms per round")
    c10 = _cost_trace(ra10k[0])
    rel10 = _held("par_ra10k_nl edge", c10,
                  ref["par_ra10k_nl"]["edge"]["cost_trace"], PAR_RTOL)
    cd = _cost_trace(ra10k_def[0])
    rel_d = float((np.abs(cd[:10] - c10) / np.abs(c10)).max())
    key = None
    try:
        parallel_raslam.run(paths["ra500"], max_rounds=1, device="cuda")
    except KeyError as e:
        key = repr(e.args[0])
    require(key is not None and "Landmark" in key,
            f"parallel RA on ra500: expected the JAX package's KeyError on "
            f"a landmark, got {key}")
    n10 = 9750
    phase(f"[parallel-ra] ra500_nl, 5 agents, rank 3: " + "; ".join(msg)
          + f"; ra10k_nl edge f64 10 rounds {float(c10[0])!r} -> "
          f"{float(c10[-1])!r}, "
          f"max rel {rel10:.1e}, "
          f"{1e3 * ra10k[0].rounds_s / 10:.3f} ms per round; at the "
          f"driver's default (f32 tiles) 50 rounds "
          f"{1e3 * ra10k_def[0].rounds_s / 50:.3f} ms per round, "
          f"{50 * n10 / ra10k_def[0].rounds_s:.0f} state-updates/s (wall "
          f"{ra10k_def[1]:.2f}s), first 10 rounds against JAX's edge max "
          f"rel {rel_d:.1e}, cost -> {float(cd[-1])!r}; ra500 (landmarks) "
          f"raises KeyError {key}, as JAX; kernel 1 {counts['spmm_sym']} launches "
          f"= {products[0]} tile products")
    return counts


def par_dist_phase(torch, pp, X):
    """[parallel dist] the 8-agent grid10k round (the driver's default,
    f32 tiles) inside a one-rank NCCL group on a TCP store on localhost,
    bitwise equal to the round with no group, and two rounds with no group
    bitwise equal, with torch's deterministic switch off (the edge path's
    segment sums are the deterministic kernel)."""
    import socket

    import torch.distributed as dist

    from dcora_tpu_torch.drivers.parallel_pgo import ROUND_CFG
    from dcora_tpu_torch.parallel.rbcd import ParallelRound, init_group

    kw = dict(backend="tiled", tile_dtype=torch.float32, device="cuda")
    require(not torch.are_deterministic_algorithms_enabled(),
            "torch's deterministic algorithms are on")
    local = ParallelRound(pp, ROUND_CFG, **kw)(X)
    again = ParallelRound(pp, ROUND_CFG, **kw)(X)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    group = init_group("cuda", f"tcp://localhost:{port}", 1, 0)
    try:
        backend = dist.get_backend(group)
        t0 = time.perf_counter()
        in_group = ParallelRound(pp, ROUND_CFG, group=group, **kw)(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(in_group[0], local[0])) \
        and torch.equal(in_group[1], local[1])
    repeat = all(torch.equal(a, b) for a, b in zip(again[0], local[0])) \
        and torch.equal(again[1], local[1])
    phase(f"[parallel dist] grid10k, {pp.num_agents} agents, f32 tiles: "
          f"the round in a one-rank {backend} group bitwise equal to the "
          f"local round: {same} (two local rounds bitwise equal: {repeat}); "
          f"build and round {wall:.2f}s")
    require(backend == "nccl", f"the group's backend is {backend}")
    require(same, "the one-rank NCCL round differs from the local round")
    require(repeat, "two local rounds differ")


def par_certify_phase(torch, path10k, X10k, mr):
    """[parallel certify] the edge-sharded S matvec with 8 shards against
    the central apply_S on grid10k, at par_grid10k's state after 30 edge
    rounds (1e-12 of max|S v| at f64); fast_verification_sharded at
    DC2-PGO's certified smallGrid3D optimum ([multi-robot]) certifies, and
    minimum_eigen_pair_sharded there agrees with the central
    minimum_eigen_pair (PAR_EIG_TOL of the largest-magnitude eigenvalue).
    Returns the LDL^T kernel's launches of the sharded verification."""
    import numpy as np

    from dcora_tpu_torch.core import certify, lifted
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.io import read_g2o_file
    from dcora_tpu_torch.parallel.certify import (
        fast_verification_sharded,
        make_sharded_matvec,
        minimum_eigen_pair_sharded,
        shard_problem_edges,
    )

    g = LocalGraph(0, 5, 3)
    g.set_measurements(read_g2o_file(path10k).pose_pose_measurements)
    P = g.problem_data(device="cuda")
    C = certify.dual_certificate_blocks(P, X10k)
    dims = X10k.dims
    gen = torch.Generator(device="cuda").manual_seed(3)
    v = torch.randn(dims.k, generator=gen, dtype=torch.float64,
                    device="cuda")
    w = make_sharded_matvec(shard_problem_edges(P, PAR_AGENTS), C, dims)(
        v, torch.zeros((), dtype=torch.float64, device="cuda"))
    want = lifted.to_flat(certify.apply_S(
        P, C, lifted.from_flat(v[None], dims)))[0]
    err = float((w - want).abs().max()) / float(want.abs().max())
    require(err <= 1e-12, f"sharded S matvec: rel {err:.2e} > 1e-12")
    path, res = mr
    gs = LocalGraph(0, res.final_rank, 3)
    gs.set_measurements(read_g2o_file(path).pose_pose_measurements)
    Ps = gs.problem_data(device="cuda")
    before = ldlt_launches()
    t0 = time.perf_counter()
    ok, theta, _ = fast_verification_sharded(Ps, res.X, 1e-3, PAR_AGENTS)
    t_ver = time.perf_counter() - t0
    n_ldlt = ldlt_launches() - before
    Cs = certify.dual_certificate_blocks(Ps, res.X)
    lam_s, _, _ = minimum_eigen_pair_sharded(Ps, Cs, res.X.dims, PAR_AGENTS)
    lam_c, _, _ = certify.minimum_eigen_pair(Ps, Cs, res.X.dims)
    k = res.X.dims.k
    lam_lm = float(certify._ritz_extreme(*certify._lanczos(
        certify._flat_matvec(Ps, Cs, res.X.dims, 0.0),
        torch.as_tensor(np.random.default_rng(0).standard_normal(k),
                        dtype=torch.float64, device="cuda"), min(64, k),
        1e-12, torch.Generator(device="cuda").manual_seed(0)))[0])
    diff = abs(lam_s - lam_c) / abs(lam_lm)
    phase(f"[parallel certify] grid10k S matvec over {PAR_AGENTS} edge "
          f"shards against apply_S: rel {err:.1e}; DC2-PGO's smallGrid3D "
          f"optimum (rank {res.final_rank}): sharded verification certified="
          f"{ok} ({t_ver:.2f}s, ldlt launches {n_ldlt}), lambda_min "
          f"sharded {lam_s!r} vs central "
          f"{lam_c!r} (diff {diff:.1e} of |lambda_lm| = {abs(lam_lm):.4g})")
    require(ok, "the sharded verification does not certify DC2-PGO's "
            "optimum")
    require(n_ldlt > 0, "the sharded verification certified without the "
            "LDL^T kernel")
    require(diff <= PAR_EIG_TOL, f"sharded lambda_min {lam_s} vs central "
            f"{lam_c}")
    return n_ldlt


def par_scaling_phase(torch, path):
    """[scaling] tools.scaling_bench on grid10k at A in SCALING_AGENTS, 20
    rounds each (f32 tiles, odometry init): rounds/s, pose-updates/s and
    kernel-1 launches per round; JSON under chiprun_out/."""
    from dcora_tpu_torch.tools import scaling_bench
    from dcora_tpu_torch.tools.common import card

    sweep = []
    for A in SCALING_AGENTS:
        rec = scaling_bench.measure(path, A, 20)
        sweep.append(rec)
        phase(f"[scaling] grid10k A={A}: {rec['ms_per_round']:.3f} ms per "
              f"round, {rec['rounds_per_s']:.2f} rounds/s, "
              f"{rec['pose_updates_per_s']:.0f} pose-updates/s, kernel 1 "
              f"{rec['spmm_sym_per_round']:.1f} launches per round, padding "
              f"{100 * rec['padding_share']:.2f} %")
        require(rec["other_kernel_launches"] == 0,
                "the scaling bench launched kernel 2 or 3")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "scaling_grid10k.json"),
              "w") as fh:
        json.dump(dict(dataset="grid10k", card=card(), devices=1,
                       sweep=sweep), fh, indent=1)


def main() -> int:
    require(os.path.isdir(os.path.join(HERE, "dcora_tpu_torch")),
            "dcora_tpu_torch/ is not beside this script: run it from a "
            "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    kind, _ = device_phase(torch)
    t_start = time.perf_counter()

    from dcora_tpu_torch import datasets
    from dcora_tpu_torch.core import spmm, tiled
    from dcora_tpu_torch.tools import common

    build_phase(spmm)

    with open(REFERENCE) as fh:
        refs = json.load(fh)
    robust_refs = _robust_refs()
    with open(PAR_REFERENCE) as fh:
        par_refs = json.load(fh)
    ra_refs = {}
    if os.path.exists(RA_REFERENCE):
        with open(RA_REFERENCE) as fh:
            ra_refs = json.load(fh)
    rows, counts, paired, benched, ra = [], {}, {}, {}, {}
    gnc_counts, agent_counts, par_counts, par_ra_counts = {}, {}, {}, {}
    g2o_counts, mr_counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name in ("smallGrid3D", "grid10k"):
            kw = dict(refs[name]["kwargs"])
            if "shape" in kw:
                kw["shape"] = tuple(kw["shape"])
            paths[name] = getattr(datasets, refs[name]["generator"])(
                os.path.join(tmp, name + ".g2o"), **kw)
        for name, (per_robot, _) in RA_SETS.items():
            paths[name] = common.ra_set(tmp, per_robot)
            if name in ra_refs:
                require(ra_refs[name]["kwargs"] == dict(
                    common.RA_KW, poses_per_robot=per_robot),
                    f"{name}: the reference was made from another set")
        paths["ra500_nl"] = datasets.generate_ra_slam_pyfg(
            os.path.join(tmp, "ra500_nl.pyfg"), poses_per_robot=100,
            **dict(common.RA_KW, num_landmarks=0))
        for name, lm in (("ra500", {}), ("ra500_nl", {"num_landmarks": 0})):
            require(robust_refs["mr_" + name]["kwargs"] == dict(
                common.RA_KW, poses_per_robot=100, **lm),
                f"mr_{name}: the reference was made from another set")
        phase("[data] generated " + ", ".join(
            f"{k} ({refs[k]['n']} poses, {refs[k]['m']} edges)"
            for k in ("smallGrid3D", "grid10k")) + "; " + ", ".join(
            f"{k} (PyFG, {5 * v} poses, tools.common.ra_set, reference "
            f"{'recorded' if k in ra_refs else 'absent'})"
            for k, (v, _) in RA_SETS.items())
            + ", ra500_nl (PyFG, ra500 without landmarks)")

        rows = ldlt_phase(torch, tmp, paths["ra10k"])
        rows += kernel_phase(torch, paths["grid10k"])
        init_phase(torch, paths["grid10k"])
        g2o_rows, g2o_counts = g2o100k_phase(torch, tmp)
        rows += g2o_rows
        os.environ.pop("DCORA_SPMM_PACK", None)  # the default strip pack
        products, restore = counting_products(tiled)
        try:
            spmm.reset_launches()
            slices = {name: slice_phase(torch, name, paths[name],
                                        refs[name])
                      for name in ("smallGrid3D", "grid10k")}
            counts = spmm.launch_counts()
        finally:
            restore()
        require(counts["spmm_sym"] == products[0] > 0,
                f"the main path did not launch the strip kernel once per "
                f"tile product: {counts}, {products[0]} products")
        require(counts["spmm_paired"] == 0
                and counts["spmm_symmetric"] == 0,
                f"the default solve launched another SpMM kernel: "
                f"{counts}")
        require(counts["segment_sum"] > 0, f"the PGO solves' edge path "
                f"never launched the segment-sum kernel: {counts}")
        phase(f"[launches] default pack: {counts}, {products[0]} tile "
              f"products (10,648-pose grid wall {slices['grid10k'][0]:.2f}s)")
        ldlt_paths = {f"pgo {k}": v[2] for k, v in slices.items()}
        ldlt_paths.update(parity_phase(torch, tmp))
        paired = paired_phase(torch, paths["grid10k"], refs["grid10k"])
        ldlt_paths["paired pgo"] = paired["ldlt"]
        benched = bench_phase(torch, paths["grid10k"])
        gnc_counts, gnc_ms, _ = gnc_phase(torch, tmp, robust_refs)
        phase(f"[launches] gnc2500: {gnc_counts}")
        rows += gnc_kernel_phase(torch, gnc_ms)
        agent_counts = agent_gnc_phase(torch, tmp, robust_refs)
        spmm.reset_launches()
        mr = mr_phase(torch, tmp, robust_refs)
        mr_counts = spmm.launch_counts()
        phase(f"[launches] DC2-PGO: {mr_counts}")
        require(mr_counts["segment_sum"] > 0, "DC2-PGO never launched the "
                "segment-sum kernel")
        require(mr_counts["ldlt"] > 0, "DC2-PGO certified without the "
                "LDL^T kernel")
        ldlt_paths["DC2-PGO"] = mr_counts["ldlt"]
        dist_gnc_phase(torch, tmp, robust_refs)
        for name in ("ra500", "ra500_nl"):
            ldlt_paths[f"DCORA {name}"] = mr_ra_phase(
                torch, name, paths[name], robust_refs)[1]
        # the parallel scaling mode
        paths["ra10k_nl"] = datasets.generate_ra_slam_pyfg(
            os.path.join(tmp, "ra10k_nl.pyfg"), poses_per_robot=1950,
            **dict(common.RA_KW, num_landmarks=0))
        for name, kw in (("par_grid10k", refs["grid10k"]["kwargs"]),
                         ("par_ra500_nl", dict(common.RA_KW, num_landmarks=0,
                                               poses_per_robot=100)),
                         ("par_ra10k_nl", dict(common.RA_KW, num_landmarks=0,
                                               poses_per_robot=1950))):
            require(par_refs[name]["kwargs"] == kw,
                    f"{name}: the reference was made from another set")
        par_counts, par_a, pp10k = par_grid_phase(
            torch, paths["grid10k"], par_refs["par_grid10k"])
        par_profile_phase(torch, pp10k, par_a.X_stack)
        rows += par_kernel_phase(torch, pp10k)
        par_ra_counts = par_ra_phase(torch, paths, par_refs)
        par_dist_phase(torch, pp10k, par_a.X_stack)
        ldlt_paths["parallel certify"] = par_certify_phase(
            torch, paths["grid10k"], par_a.X, mr)
        par_scaling_phase(torch, paths["grid10k"])
        ra_rows, tps = ra_kernel_phase(torch, paths["ra10k"])
        rows += ra_rows
        btd_rows, btd_checks = btd_phase(torch, tps)
        rows += btd_rows
        flat_rows, _ = flat_phase(torch, paths["grid10k"], tps, pp10k)
        rows += flat_rows
        del tps
        tcg_phase(torch, paths["ra10k"])
        rows += repeat_phase(torch, paths, mr, btd_checks)
        os.environ.pop("DCORA_SPMM_PACK", None)
        for name, (_, r_max) in RA_SETS.items():
            ra[name] = raslam_phase(torch, name, paths[name],
                                    ra_refs.get(name), r_max)
            phase(f"[launches] {name}: {ra[name][0]} (wall "
                  f"{ra[name][1]:.2f}s)")
            ldlt_paths[name] = ra[name][0]["ldlt"]

    elapsed = time.perf_counter() - t_start
    # the row each kernel's path launches most: f64 at r_pad 8 on the grid
    # for the certified solves (the f64-tile phase's tCG product), f32 at
    # r_pad 8 for spmm_bench; kernel 1's launches are those of the PGO, the
    # GNC (centralized and the agent's init), the RA solves, the parallel
    # rounds (PGO and RA) and the g2o100k solve together
    # the segment sum's and the BTD kernel's are those of every path read,
    # DC2-PGO's too (only the RA solves take the BTD preconditioner)
    path_counts = [counts, paired, benched, gnc_counts, agent_counts,
                   mr_counts, par_counts, par_ra_counts, g2o_counts,
                   *(c for c, _ in ra.values())]
    path_names = ("pgo", "paired pgo", "bench", "gnc2500", "gnc agent init",
                  "DC2-PGO", "parallel grid10k", "parallel ra", "g2o100k",
                  *ra)
    launches = dict(spmm_sym=counts["spmm_sym"] + sum(
                        c["spmm_sym"] for c, _ in ra.values())
                    + gnc_counts["spmm_sym"] + agent_counts["spmm_sym"]
                    + par_counts["spmm_sym"] + par_ra_counts["spmm_sym"]
                    + g2o_counts["spmm_sym"],
                    spmm_tile=benched["spmm_symmetric"],
                    spmm_paired=paired["spmm_paired"],
                    segment_sum=sum(c["segment_sum"] for c in path_counts),
                    btd_solve=sum(c["btd_solve"] for c in path_counts),
                    flat_ops=sum(c["flat_rhess"] + c["flat_precond"]
                                 for c in path_counts),
                    ldlt=sum(ldlt_paths.values()))
    phase("[launches] spmm_sym per path: " + ", ".join(
        [f"pgo {counts['spmm_sym']}", f"gnc2500 {gnc_counts['spmm_sym']}",
         f"gnc agent init {agent_counts['spmm_sym']}"]
        + [f"{k} {c['spmm_sym']}" for k, (c, _) in ra.items()]
        + [f"parallel grid10k {par_counts['spmm_sym']}",
           f"parallel ra {par_ra_counts['spmm_sym']}",
           f"g2o100k {g2o_counts['spmm_sym']}"]))
    require(all(c["btd_solve"] > 0 for c, _ in ra.values()),
            "an RA path never launched the BTD kernel")
    # every flat tiled path runs flat_rhess in each tCG iteration; those on
    # the per-pose Jacobi (PGO, the GNC, the parallel grid, g2o100k) also
    # flat_precond
    flat_paths = dict(pgo=counts, gnc2500=gnc_counts,
                      par_grid10k=par_counts, g2o100k=g2o_counts,
                      **{k: c for k, (c, _) in ra.items()})
    for k, c in flat_paths.items():
        require(c["flat_rhess"] > 0, f"{k} never launched flat_rhess: {c}")
        require(c["flat_precond"] > 0 or k in ra,
                f"{k} never launched flat_precond: {c}")
    for kern in ("segment_sum", "btd_solve", "flat_rhess", "flat_precond"):
        phase(f"[launches] {kern} per path: " + ", ".join(
            f"{k} {c[kern]}" for k, c in zip(path_names, path_counts)))
    # every path that certified proved with the LDL^T kernel (required in
    # its phase); one that did not certify (ra10k runs its first rank only)
    # may not have reached the proof
    phase("[launches] ldlt per certified path: " + ", ".join(
        f"{k} {v}" for k, v in ldlt_paths.items()))
    main_dtype = dict(spmm_sym="float64", spmm_tile="float32",
                      spmm_paired="float64")
    entries = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        if name == "segment_sum":  # one apply_Q's sums at ra10k rank 3
            main_row = next(r for r in mine if r["dtype"] == "float64"
                            and r["problem"] == "ra10k apply_Q")
        elif name == "btd_solve":  # the RA f32 tile phase's application
            main_row = next(r for r in mine if r["dtype"] == "float32"
                            and r["r_pad"] == 8)
        elif name == "ldlt":  # one factorization of grid3D's Q + eta I
            main_row = next(r for r in mine
                            if r["problem"] == "grid3D Q + eta I")
        elif name == "flat_ops":  # grid10k's f32 tile phase: one of each
            parts = {k: next(r for r in rows if r["kernel"] == k
                             and r["problem"] == "grid10k"
                             and r["dtype"] == "float32" and r["r_pad"] == 8)
                     for k in ("flat_rhess", "flat_precond")}
            mine = [r for r in rows if r["kernel"] in parts]
            main_row = {k: sum(p[k] for p in parts.values())
                        for k in ("ms", "plain_ms", "bound_ms")}
            main_row.update(bound_by="bytes", library_ms=None)
            meta = dict(meta, parts={k: {f: p[f] for f in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
                for k, p in parts.items()}, launches_each={
                k: sum(c[k] for c in path_counts) for k in parts})
        else:
            main_row = next(r for r in mine
                            if r["dtype"] == main_dtype[name]
                            and r["r_pad"] == 8 and r["live"] == 8
                            and r["problem"] == "grid10k")
        entries.append(dict(meta, launches=launches[name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            **{k: main_row[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}))
    phase(f"[done] {elapsed:.1f}s after the device check")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
