"""Entry ``rbcd``: the synchronous-parallel RBCD of a pose graph shared by
a team of robots, through the program's own set-up
(drivers/parallel_pgo.prepare: the contiguous partition, every agent's
graph, the benchmark's start packed per agent, the batched problem, the
ParallelRound) and its own loop (parallel/rbcd.run_rounds), a fixed number
of rounds from the start each solve, with the central check every
"check_every" rounds.

End-to-end: ``pose_iters_per_s``, poses x rounds of every solve in the
window over its wall (a round updates every pose once, by one accepted
step of its robot's block).  Compared, over the sampled answers (the
gathered global state after the last round): the program's central cost
at the answer against the reference's (``cost_err``, over the cost's
absolute magnitude); the manifold error; the share of the reference's own
synchronous RBCD decrease (reference/rbcd.py: same start, partition and
rounds, float64) the answer lacks (``shortfall``); ``stalled``, 1 unless
the answer is 1 % below the start; and ``block_rise``: the states before
and after one round of each sampled solve (the round drawn per solve from
the instance's seed and the solve's place in the run, so the run's seed,
which picks the sampled solves, picks the rounds judged), the largest
rise of an agent's block cost over it, each block against its neighbours
at the round's start, over the cost's magnitude.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from port_bench.reference import graph as ref_graph
from port_bench.reference import start
from port_bench.reference.problem import Problem
from port_bench.reference.rbcd import Fleet, partition
from port_bench.reference.rtr import Budget


class RoundTap:
    """The program's round, keeping the states before and after its
    round `at` (references: a round makes new tensors)."""

    def __init__(self, rnd, at: int):
        self.rnd, self.at, self.k = rnd, at, 0
        self.before = self.after = None

    def __getattr__(self, name):
        return getattr(self.rnd, name)

    def __call__(self, X):
        out = self.rnd(X)
        if self.k == self.at:
            self.before, self.after = X, out[0]
        self.k += 1
        return out


class Entry:
    samples = 4

    def __init__(self, traffic, paths, seeds, device):
        from dcora_tpu_torch.core.lifted import RAState
        from dcora_tpu_torch.core.rtr import RTRConfig
        from dcora_tpu_torch.drivers import parallel_pgo
        from dcora_tpu_torch.io import read_g2o_file
        from dcora_tpu_torch.parallel import rbcd

        if len(paths) != 1:
            raise ValueError("an rbcd mix solves one instance")
        ref = ref_graph.read(paths[0])
        if not ref.is_pgo:
            raise ValueError("an rbcd mix solves a pose graph")
        agents, r = traffic["agents"], traffic["rank"]
        self.start = start.STARTS[traffic["start"]](ref, r, seeds[0])
        self.seed = seeds[0]
        self.rounds, self.check_every = traffic["rounds"], \
            traffic["check_every"]
        self.tol = traffic["tol"]
        self.budget = Budget(max_outer=1, max_inner=traffic["max_inner"],
                             gradnorm_tol=traffic["gradnorm_tol"],
                             initial_radius=traffic["initial_radius"])
        self.max_rejections = traffic["max_rejections"]
        # the reference steps as the mix says; the program as its driver
        # does, which has to be the same step
        cfg = RTRConfig(gradnorm_tol=traffic["gradnorm_tol"],
                        max_inner=traffic["max_inner"],
                        initial_radius=traffic["initial_radius"],
                        single_accepted_step=True,
                        max_rejections=self.max_rejections)
        if cfg != parallel_pgo.ROUND_CFG:
            raise ValueError(f"the mix's block update {cfg} is not the "
                             f"driver's {parallel_pgo.ROUND_CFG}")
        ds = read_g2o_file(paths[0])
        X0 = RAState(*(torch.as_tensor(a, device=device)
                       for a in self.start))
        self.setup = parallel_pgo.prepare(
            agents, ds.pose_pose_measurements, ds.num_poses, ds.dim, r,
            backend=traffic["backend"],
            tile_dtype=getattr(torch, traffic["dtype"]), device=device,
            start=X0)
        self.run_rounds = rbcd.run_rounds
        self.agents = agents
        self.poses = ds.num_poses
        # what the roofline readers count the work from: the problem with
        # its robots' slices, at rank r
        self.graph = dataclasses.replace(ref, robots=partition(ref.n,
                                                               agents))
        self.r = r
        self.dtype = traffic["dtype"]
        self.solves = 0

    def release(self):
        del self.setup, self.run_rounds

    def solve(self, i: int = 0):
        at = int(np.random.default_rng([self.seed, self.solves]).integers(
            self.rounds))
        self.solves += 1
        tap = RoundTap(self.setup.rnd, at)
        Xb, rounds, trace, _, _ = self.run_rounds(
            tap, self.setup.Xb, self.rounds, self.check_every, self.tol,
            self.setup.evaluate)
        return dict(X=dict(state=Xb, round=at, before=tap.before,
                           after=tap.after),
                    f=0.5 * trace[-1][1], work=self.poses * rounds,
                    stages={})

    def ok(self, ans) -> bool:
        return True

    def end_to_end(self, elapsed, answers) -> Dict[str, float]:
        return {"pose_iters_per_s": sum(a["work"] for a in answers)
                / elapsed}

    def keep(self, ans):
        def host(Xs):
            return tuple(x.detach().cpu()
                         for x in self.setup.global_state(Xs))

        X = ans["X"]
        ans["X"] = dict(state=host(X["state"]), round=X["round"],
                        before=host(X["before"]), after=host(X["after"]))

    def check(self, answers, sampled, device, log) -> Dict[str, float]:
        P = Problem(self.graph, device=device)
        fleet = Fleet(P, self.agents, self.budget, self.max_rejections)
        X0 = P.flat(*(torch.as_tensor(a) for a in self.start))
        f0 = P.cost(X0)
        Xr = X0
        for _ in range(self.rounds):
            Xr = fleet.round(Xr)
        f_ref = P.cost(Xr)
        log(f"reference RBCD: f0 {f0!r} -> {f_ref!r} after {self.rounds} "
            f"rounds of {self.agents} agents")
        out = {"cost_err": 0.0, "manifold_err": 0.0, "shortfall": 0.0,
               "stalled": 0.0, "block_rise": 0.0}
        for a in sampled:
            X = P.flat(*a["X"]["state"])
            f = P.cost(X)
            out["cost_err"] = max(out["cost_err"],
                                  abs(a["f"] - f) / P.magnitude(X))
            out["manifold_err"] = max(out["manifold_err"],
                                      P.manifold_err(X))
            out["shortfall"] = max(out["shortfall"],
                                   max(0.0, f - f_ref) / (f0 - f_ref))
            if f > 0.99 * f0:  # not 1 % below the start: no solve
                out["stalled"] = 1.0
            out["block_rise"] = max(out["block_rise"], fleet.block_rise(
                P.flat(*a["X"]["before"]), P.flat(*a["X"]["after"])))
        return out
