"""Entry ``rtr``: rtr.rtr at a fixed budget from the benchmark's own start
(port_bench/reference/start.py), on the flat tiled backend as rtr_fast's
first phase builds it (``"backend": "flat"``) or on the edge path as
rtr_fast's last phase runs it (``"backend": "edge"``), for a pose graph
or a range-aided problem (the mix's "rank" and "start" per kind).

End-to-end: ``pose_iters_per_s``, poses x outer iterations of every solve
in the window over its wall.  Compared, over the sampled answers: the cost
the program reports against the reference's at the same iterate, over the
cost's absolute magnitude (``cost_err``); the manifold error; the share of
the reference solve's decrease (same start and budget) the answer lacks
(``shortfall``); ``stalled``, 1 unless the answer is 1 % below the start.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.harness import budget
from port_bench.reference import graph as ref_graph
from port_bench.reference import start
from port_bench.reference.problem import Problem
from port_bench.reference.rtr import Solver


class Entry:
    samples = 8

    def __init__(self, traffic, paths, seeds, device):
        from dcora_tpu_torch import solvers
        from dcora_tpu_torch.core import lifted, problem as prob, rtr, tiled
        from dcora_tpu_torch.core.graph import LocalGraph
        from dcora_tpu_torch.io import read_g2o_file, read_pyfg_file
        from dcora_tpu_torch.io.remap import get_global_measurements
        from dcora_tpu_torch.types import GraphType

        self.rtr, self.tiled = rtr, tiled
        if len(paths) != 1:
            raise ValueError("an rtr mix solves one instance")
        path, ref = paths[0], ref_graph.read(paths[0])
        kind = "pose_graph" if ref.is_pgo else "range_aided"
        r = traffic["rank"][kind]
        d = ref.d
        if ref.is_pgo:
            meas = read_g2o_file(path).pose_pose_measurements
            g = LocalGraph(0, r, d)
        else:
            meas = get_global_measurements(
                read_pyfg_file(path)).relative_measurements
            g = LocalGraph(0, r, d, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(meas)
        s = start.STARTS[traffic["start"][kind]](ref, r, seeds[0])
        self.start = s
        P = g.problem_data(device=device)
        M = solvers.make_preconditioner(g, P)
        G = prob.linear_term(P, None, g.n, g.l, g.dims.num_trans)
        X0 = lifted.RAState(*(torch.as_tensor(a, device=device)
                              for a in s))
        self.cfg = rtr.RTRConfig(
            gradnorm_tol=traffic["gradnorm_tol"],
            max_outer=traffic["max_outer"], max_inner=traffic["max_inner"],
            initial_radius=traffic["initial_radius"])
        self.r = r  # what the roofline readers count the work at
        self.graph = ref
        self.poses = g.n
        if traffic["backend"] == "flat":
            tile_pc = solvers._tile_preconditioner(g, P)
            reg = solvers.precond_reg(g, P) if tile_pc else 0.1
            dt = getattr(torch, traffic["dtype"])
            TP = tiled.build_tiled(P, g.dims, dtype=dt, precond=M, reg=reg,
                                   tile_precond=tile_pc)
            r_pad = max(8, -(-r // 8) * 8)
            self.args = (TP, None if G is None else
                         tiled.to_flat(TP, G, r_pad=r_pad).to(dt), None,
                         tiled.to_flat(TP, X0, r_pad=r_pad).to(dt))
            self.kw = dict(be=rtr.FLAT_BACKEND)
            self.TP = TP
        elif traffic["backend"] == "edge":
            self.args = (P, G, M, X0)
            self.kw = {}
            self.TP = None
        else:
            raise ValueError(f"unknown backend {traffic['backend']!r}")
        self.dtype = traffic["dtype"]
        self.budget = budget(traffic)

    def release(self):
        del self.args, self.kw, self.rtr
        self.TP = None

    def solve(self, i: int = 0):
        res = self.rtr.rtr(*self.args, self.cfg, **self.kw)
        return dict(X=res.X, f=float(res.f_final),
                    work=self.poses * int(res.outer_iters), stages={})

    def ok(self, ans) -> bool:
        return True

    def end_to_end(self, elapsed, answers) -> Dict[str, float]:
        return {"pose_iters_per_s": sum(a["work"] for a in answers)
                / elapsed}

    def keep(self, ans):
        X = ans["X"]
        if self.TP is not None:
            X = self.tiled.from_flat(self.TP, X.to(torch.float64), r=self.r)
        ans["X"] = tuple(x.detach().cpu() for x in X)

    def check(self, answers, sampled, device, log) -> Dict[str, float]:
        P = Problem(self.graph, device=device)
        X0 = P.flat(*(torch.as_tensor(a) for a in self.start))
        f0 = P.cost(X0)
        _, f_ref, gn_ref, it = Solver(P, self.budget).solve(X0)
        log(f"reference solve: f0 {f0!r} -> {f_ref!r} (gradnorm "
            f"{gn_ref:.3e}, {it} outer iterations)")
        out = {"cost_err": 0.0, "manifold_err": 0.0, "shortfall": 0.0,
               "stalled": 0.0}
        for a in sampled:
            X = P.flat(*a["X"])
            f = P.cost(X)
            out["cost_err"] = max(out["cost_err"],
                                  abs(a["f"] - f) / P.magnitude(X))
            out["manifold_err"] = max(out["manifold_err"],
                                      P.manifold_err(X))
            out["shortfall"] = max(out["shortfall"],
                                   max(0.0, f - f_ref) / (f0 - f_ref))
            if f > 0.99 * f0:  # not 1 % below the start: no solve
                out["stalled"] = 1.0
        return out
