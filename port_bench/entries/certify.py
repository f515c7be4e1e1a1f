"""Entry ``certify``: the user's certified solve,
single_robot_pgo.run(certify=True), over the run's instances in turn.

End-to-end: ``certified_solve_s``, the window's wall over the certified
solves in it.  Compared: the reference's Riemannian gradient norm of each
rounded estimate (``gradnorm``), and ``uncertified``, 0 when the program
says certified and the reference's own LDL^T proves the certificate at the
sampled solve's lifted answer.  ``cost_err`` and ``manifold_err`` are read
too (reported, compared only where the cell's limits name them).
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference import graph as ref_graph
from port_bench.reference.problem import Problem, certificate_psd


class Entry:
    samples = 1  # the certificate proof is the reference's longest step

    def __init__(self, traffic, paths, seeds, device):
        from dcora_tpu_torch.drivers import single_robot_pgo

        self.run = single_robot_pgo.run
        self.paths, self.device = paths, device
        self.eta, self.r_max = traffic["eta"], traffic["r_max"]
        self.dtype = "float64"

    def release(self):
        del self.run

    def solve(self, i: int):
        res: dict = {}
        T, f = self.run(self.paths[i], certify=True, device=self.device,
                        verbose=False, result=res, r_max=self.r_max,
                        eta=self.eta)
        st = res["staircase"]
        return dict(T=T, f=float(f), certified=bool(st.certified),
                    instance=i, rank=int(st.final_rank), X=st.X,
                    stages=dict(init_s=res["init_s"], **st.stage_seconds))

    def ok(self, ans) -> bool:
        return ans["certified"]

    def end_to_end(self, elapsed, answers) -> Dict[str, float]:
        done = sum(1 for a in answers if a["certified"])
        return {"certified_solve_s": elapsed / max(done, 1)}

    def keep(self, ans):
        ans["X"] = tuple(x.detach().cpu() for x in ans["X"])

    def check(self, answers, sampled, device, log) -> Dict[str, float]:
        refs = [ref_graph.read(p) for p in self.paths]
        problems = {}
        out = {"cost_err": 0.0, "gradnorm": 0.0, "manifold_err": 0.0,
               "uncertified": 0.0}
        for a in answers:
            i = a["instance"]
            g = refs[i]
            P = problems.get(i) or problems.setdefault(
                i, Problem(g, device=device))
            T = a["T"]
            X = P.flat(torch.as_tensor(T[:, :, :g.d]),
                       torch.zeros((0, g.d), dtype=torch.float64),
                       torch.as_tensor(T[:, :, g.d]))
            f = P.cost(X)
            out["cost_err"] = max(out["cost_err"], abs(a["f"] - f) / abs(f))
            out["gradnorm"] = max(out["gradnorm"], P.gradnorm(X))
            out["manifold_err"] = max(out["manifold_err"],
                                      P.manifold_err(X))
        for a in sampled:
            g = refs[a["instance"]]
            Xl = problems[a["instance"]].flat(*a["X"]).cpu().numpy()
            psd = certificate_psd(g, Xl, self.eta)
            log(f"certificate of a sampled solve at rank {a['rank']}: "
                f"program {a['certified']}, reference {psd}")
            if psd is not True or not a["certified"]:
                out["uncertified"] = 1.0
        return out
