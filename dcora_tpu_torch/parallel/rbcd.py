"""Synchronous-parallel RBCD: every agent's block update at once.

Counterpart of ``dcora_tpu.parallel.rbcd``, the scaling mode of the
reference's block-coordinate descent (SURVEY.md 2.3).  Instead of the
greedy single-block update of ``agent.py`` (MultiRobotExample.cpp:219-307),
every agent's block updates in every round against its neighbours' public
states of the round before (Jacobi-style RBCD).

All agents are padded to common shapes (``n_max``, ``l_max``, ``b_max``, the
fixed-slot and public-buffer maxima) and stacked along a leading agent axis
A, as the JAX package does; where the JAX package runs ``jax.vmap`` of one
agent's update inside ``shard_map``, here the stack is one problem:

  * the edge path lays the agents side by side in one index space, agent
    a's slot i at ``a * (slots per agent + 1) + i`` (the ``+ 1`` is its zero
    pad slot), so one ``index_select`` / segment-sum pass of
    ``problem.apply_Q`` serves the whole fleet (:func:`fleet_operator`);
  * the tiled path lays the agents' flat states side by side along the
    scalar axis, ``[r_pad, A, kpad]``, with a block-diagonal strip CSR
    (:func:`stack_tiled`), so one launch of kernel 1 (``csrc/spmm_sym.cu``)
    computes every agent's tile product;
  * the one-accepted-step RTR runs on the stack with one radius, try count
    and tCG stopping state per agent (``core.rtr.rtr_stacked``), so each
    agent gets what it would get alone.

The separator exchange (four ``all_gather``s over the mesh axis in JAX) is
one buffer per agent: gathered locally with no process group, and with
``torch.distributed`` across ranks, each of which owns A/W contiguous agents
(:class:`ParallelRound`).

The JAX tiled backend runs each agent on its planar layout with a
Newton-Schulz polar retraction; the port's flat backend is the same math
with the exact polar factor.  Kept as the JAX package has it: the
``KeyError`` that a set with landmarks raises at build time (the map agent,
which owns the landmarks, is not one of the agents, so no agent publishes
them), and priors, which the batched problem drops.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dcora_tpu_torch.core import problem as prob
from dcora_tpu_torch.core import tiled
from dcora_tpu_torch.core.graph import LocalGraph
from dcora_tpu_torch.core.lifted import RAState
from dcora_tpu_torch.core.manifold import retract, tangent_project
from dcora_tpu_torch.core.rtr import (
    RTRConfig,
    TCGGraph,
    _FlatBackend,
    _RABackend,
    rtr_stacked,
)
from dcora_tpu_torch.core.spmm import BLOCK, StripCSR
from dcora_tpu_torch.types import ProblemDims, StateType

# trans-source kinds in fix_trans_src[..., 2]
_KIND_POSE = 0
_KIND_LMK = 1

# the edge fields of ProblemData, and the index space each index field
# addresses (0 rotations, 1 translations, 2 spheres)
_EDGE_FIELDS = prob.ProblemData._fields[:24]
_SPACE = dict(pp_ri=0, pp_rj=0, pl_ri=0, pp_ti=1, pp_tj=1, pl_ti=1,
              pl_tj=1, rg_ti=1, rg_tj=1, rg_q=2)


@dataclasses.dataclass
class ParallelRBCDProblem:
    """Every agent's subproblem padded to common shapes and stacked along a
    leading agent axis [A, ...], on the host (float64, int64 indices).

    Index contract per agent (see problem.apply_Q): local slots [0, n_max)
    / [0, t_max) / [0, l_max); fixed-neighbour slots [n_max, n_max +
    fp_max) etc.; the pad slot is the last index of whichever state is
    passed in."""

    P: prob.ProblemData         # augmented index spaces
    # the local block Q_bb: fixed slots remapped onto the pad slot
    P_loc: prob.ProblemData
    M: prob.Preconditioner      # block-Jacobi of each agent's Q_bb
    # separator gather maps: for each fixed slot, the owning agent and its
    # slot in that agent's public buffer (and for translations the kind)
    fix_pose_src: torch.Tensor  # [A, fp_max, 2]
    fix_trans_src: torch.Tensor  # [A, ft_max, 3]
    fix_sph_src: torch.Tensor   # [A, fs_max, 2]
    # public buffers: the local states each agent publishes, padded with
    # the pad slot
    pub_pose_idx: torch.Tensor  # [A, pp_max]
    pub_lmk_idx: torch.Tensor   # [A, plm_max]
    pub_sph_idx: torch.Tensor   # [A, ps_max]
    n_max: int
    l_max: int
    b_max: int
    t_max: int
    fp_max: int
    ft_max: int
    fs_max: int
    pp_max: int
    plm_max: int
    ps_max: int
    d: int
    num_agents: int
    graphs: List[LocalGraph]
    regs: np.ndarray            # preconditioner regularization per agent

    @property
    def dims(self) -> ProblemDims:
        """The padded per-agent dims every agent's tiles share."""
        return ProblemDims(d=self.d, n=self.n_max, l=self.l_max,
                           b=self.b_max)

    def scalar_columns(self) -> Tuple[int, int]:
        """(real scalar columns of all agents, A * kpad of the stacked
        tiled layout): the padding the common shapes cost."""
        dh = self.d + 1
        real = int(sum(dh * g.n + g.l + g.b for g in self.graphs))
        kpad = -(-self.dims.k // 128) * 128
        return real, self.num_agents * kpad


def _pad(arr, size, pad_value=0, dtype=np.float64, extra=()):
    out = np.full((size,) + tuple(extra), pad_value, dtype=dtype)
    arr = np.asarray(arr, dtype=dtype).reshape((-1,) + tuple(extra))
    out[:len(arr)] = arr
    return out


def _local_problem(g: LocalGraph) -> prob.ProblemData:
    """g's augmented problem with its fixed slots clamped onto the zero pad
    slot: the JAX package's gathers clamp them there and its segment sums
    drop them."""
    from dcora_tpu_torch.agent import pad_problem_for_local

    return pad_problem_for_local(g.problem_data(), g)


def build_parallel_problem(graphs: List[LocalGraph]) -> ParallelRBCDProblem:
    """Compile per-agent LocalGraphs into one padded batched problem
    (dcora_tpu/parallel/rbcd.py:116-366).  Raises KeyError when an agent
    needs a state that no agent publishes."""
    from dcora_tpu_torch.solvers import precond_reg

    A = len(graphs)
    d = graphs[0].d
    n_max = max(g.n for g in graphs)
    l_max = max(g.l for g in graphs)
    b_max = max(g.b for g in graphs)
    t_max = n_max + b_max
    compiled = [g._compile() for g in graphs]
    fp_max = max(c["n_fix_pose"] for c in compiled)
    ft_max = max(c["n_fix_trans"] for c in compiled)
    fs_max = max(c["n_fix_sphere"] for c in compiled)

    # public buffers: deterministic order by StateID
    pubs = [g.my_public_state_ids() for g in graphs]
    pub_poses = [sorted(p[0]) for p in pubs]
    pub_sphs = [sorted(p[1]) for p in pubs]
    pub_lmks = [sorted(p[2]) for p in pubs]
    pp_max = max(1, max(len(x) for x in pub_poses))
    ps_max = max(1, max(len(x) for x in pub_sphs))
    plm_max = max(1, max(len(x) for x in pub_lmks))
    pub_slot = {}
    for a in range(A):
        for buf in (pub_poses[a], pub_sphs[a], pub_lmks[a]):
            for s, sid in enumerate(buf):
                pub_slot[sid] = (a, s)

    mpp_max = max(1, max(len(c["pp_meas"]) for c in compiled))
    mpl_max = max(1, max(len(c["pl_meas"]) for c in compiled))
    mrg_max = max(1, max(len(c["rg_meas"]) for c in compiled))
    rot_pad, trn_pad = n_max + fp_max, t_max + ft_max
    sph_pad = l_max + fs_max

    fields = {name: [] for name in _EDGE_FIELDS}
    fps_l, fts_l, fss_l, pubp_l, publ_l, pubs_l, regs = ([] for _ in range(7))
    for a, (g, c) in enumerate(zip(graphs, compiled)):
        n, b, l = g.n, g.b, g.l  # noqa: E741
        nt = n + b

        def remap_rot(idx):
            return np.where(idx < n, idx, n_max + (idx - n))

        def remap_trn(idx):
            out = np.where(idx < n, idx, 0)
            out = np.where((idx >= n) & (idx < nt), n_max + (idx - n), out)
            return np.where(idx >= nt, t_max + (idx - nt), out)

        def remap_sph(idx):
            return np.where(idx < l, idx, l_max + (idx - l))

        def w_act(meas, nbrs):
            return ([m.weight for m in meas],
                    [1.0 if (x is None or g.neighbor_active.get(x, True))
                     else 0.0 for x in nbrs])

        pp, pl, rg = c["pp_idx"], c["pl_idx"], c["rg_idx"]
        ppm, plm, rgm = c["pp_meas"], c["pl_meas"], c["rg_meas"]
        pp_w, pp_a = w_act(ppm, c["pp_nbr"])
        pl_w, pl_a = w_act(plm, c["pl_nbr"])
        rg_w, rg_a = w_act(rgm, c["rg_nbr"])
        i64 = dict(dtype=np.int64)
        vals = dict(
            pp_ri=_pad(remap_rot(pp[:, 0]), mpp_max, rot_pad, **i64),
            pp_rj=_pad(remap_rot(pp[:, 1]), mpp_max, rot_pad, **i64),
            pp_ti=_pad(remap_trn(pp[:, 2]), mpp_max, trn_pad, **i64),
            pp_tj=_pad(remap_trn(pp[:, 3]), mpp_max, trn_pad, **i64),
            pp_R=_pad([m.R for m in ppm], mpp_max, extra=(d, d)),
            pp_t=_pad([m.t for m in ppm], mpp_max, extra=(d,)),
            pp_kappa=_pad([m.kappa for m in ppm], mpp_max),
            pp_tau=_pad([m.tau for m in ppm], mpp_max),
            pp_w=_pad(pp_w, mpp_max), pp_active=_pad(pp_a, mpp_max),
            pl_ri=_pad(remap_rot(pl[:, 0]), mpl_max, rot_pad, **i64),
            pl_ti=_pad(remap_trn(pl[:, 1]), mpl_max, trn_pad, **i64),
            pl_tj=_pad(remap_trn(pl[:, 2]), mpl_max, trn_pad, **i64),
            pl_t=_pad([m.t for m in plm], mpl_max, extra=(d,)),
            pl_tau=_pad([m.tau for m in plm], mpl_max),
            pl_w=_pad(pl_w, mpl_max), pl_active=_pad(pl_a, mpl_max),
            rg_ti=_pad(remap_trn(rg[:, 0]), mrg_max, trn_pad, **i64),
            rg_tj=_pad(remap_trn(rg[:, 1]), mrg_max, trn_pad, **i64),
            rg_q=_pad(remap_sph(rg[:, 2]), mrg_max, sph_pad, **i64),
            rg_rho=_pad([m.range for m in rgm], mrg_max),
            rg_prec=_pad([m.precision for m in rgm], mrg_max),
            rg_w=_pad(rg_w, mrg_max), rg_active=_pad(rg_a, mrg_max),
        )
        for name in _EDGE_FIELDS:
            fields[name].append(vals[name])

        # separator gather maps; a state no agent publishes raises KeyError,
        # as in the JAX package
        fps = np.zeros((fp_max, 2), np.int64)
        for sid, slot in c["fixed_pose"].items():
            fps[slot] = pub_slot[sid]
        fts = np.zeros((ft_max, 3), np.int64)
        for sid, slot in c["fixed_trans"].items():
            fts[slot] = (*pub_slot[sid], _KIND_POSE
                         if sid.state_type == StateType.Pose else _KIND_LMK)
        fss = np.zeros((fs_max, 2), np.int64)
        for sid, slot in c["fixed_sphere"].items():
            fss[slot] = pub_slot[sid]
        fps_l.append(fps)
        fts_l.append(fts)
        fss_l.append(fss)
        pubp_l.append(_pad([s.frame_id for s in pub_poses[a]], pp_max,
                           n_max, **i64))
        publ_l.append(_pad([n_max + s.frame_id for s in pub_lmks[a]],
                           plm_max, t_max, **i64))
        pubs_l.append(_pad([s.frame_id for s in pub_sphs[a]], ps_max,
                           l_max, **i64))
        # reference rule (Graph.cpp:1901-1960): 1e-1 for PGO,
        # lambda_max / (1e6 - 1) of the agent's local Q for RA-SLAM
        regs.append(1e-1 if g.is_pgo_compatible()
                    else precond_reg(g, _local_problem(g)))

    P = prob.ProblemData(**{k: torch.as_tensor(np.stack(v))
                            for k, v in fields.items()})
    limit = (n_max, t_max, l_max)
    P_loc = P._replace(**{k: torch.clamp(getattr(P, k), max=limit[sp])
                          for k, sp in _SPACE.items()})
    Ms = [prob.build_preconditioner_host(
        prob.with_segments(prob.ProblemData(*(x[a] for x in P_loc[:24]))),
        n_max, l_max, b_max, d, regs[a]) for a in range(A)]

    def ints(xs):
        return torch.as_tensor(np.stack(xs))

    return ParallelRBCDProblem(
        P=P, P_loc=P_loc,
        M=prob.Preconditioner(*(torch.stack(x) for x in zip(*Ms))),
        fix_pose_src=ints(fps_l), fix_trans_src=ints(fts_l),
        fix_sph_src=ints(fss_l), pub_pose_idx=ints(pubp_l),
        pub_lmk_idx=ints(publ_l), pub_sph_idx=ints(pubs_l),
        n_max=n_max, l_max=l_max, b_max=b_max, t_max=t_max, fp_max=fp_max,
        ft_max=ft_max, fs_max=fs_max, pp_max=pp_max, plm_max=plm_max,
        ps_max=ps_max, d=d, num_agents=A, graphs=graphs,
        regs=np.array(regs, dtype=np.float64))


def pack_states(pp: ParallelRBCDProblem, states: List[RAState],
                device=None) -> RAState:
    """Stack per-agent local states into padded [A, ...] tensors (local
    trans layout: poses at [0, n_max), landmarks at [n_max, n_max + b))."""
    r = states[0].r
    device = states[0].device if device is None else device
    kw = dict(dtype=torch.float64, device=device)
    A = len(states)
    rot = torch.zeros((A, pp.n_max, r, pp.d), **kw)
    sph = torch.zeros((A, pp.l_max, r), **kw)
    trn = torch.zeros((A, pp.t_max, r), **kw)
    for a, X in enumerate(states):
        g = pp.graphs[a]
        rot[a, :g.n] = X.rot
        sph[a, :g.l] = X.sph
        trn[a, :g.n] = X.trn[:g.n]
        trn[a, pp.n_max:pp.n_max + g.b] = X.trn[g.n:]
    return RAState(rot=rot, sph=sph, trn=trn)


def unpack_states(pp: ParallelRBCDProblem, X: RAState) -> List[RAState]:
    out = []
    for a in range(pp.num_agents):
        g = pp.graphs[a]
        out.append(RAState(
            rot=X.rot[a, :g.n], sph=X.sph[a, :g.l],
            trn=torch.cat([X.trn[a, :g.n],
                           X.trn[a, pp.n_max:pp.n_max + g.b]])))
    return out


# --------------------------------------------------------------------------
# The fleet on the edge path: one index space, agent after agent
# --------------------------------------------------------------------------


def fleet_operator(Pst: prob.ProblemData, lo: int, hi: int,
                   strides: Tuple[int, int, int], device
                   ) -> prob.ProblemData:
    """Agents lo..hi-1 of a stacked ProblemData as one ProblemData over the
    fleet's index spaces: agent a's slot i of the rotation, translation or
    sphere space at (a - lo) * stride + i, each stride one more than the
    agent's slots (its pad slot).  problem.apply_Q then runs every agent's
    product in one pass (fleet_apply)."""
    A = hi - lo
    out = {}
    for name in _EDGE_FIELDS:
        x = getattr(Pst, name)[lo:hi]
        if name in _SPACE:
            x = x + strides[_SPACE[name]] * torch.arange(A)[:, None]
        out[name] = x.reshape(-1, *x.shape[2:]).to(device)
    return prob.with_segments(prob.ProblemData(**out))


def _merge(X: RAState) -> RAState:
    """[A, s, ...] leaves -> [A s, ...] (one pose per row, agent after
    agent)."""
    return RAState(*(x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
                     for x in X))


def _split(Y: RAState, A: int) -> RAState:
    return RAState(*(y.reshape(A, y.shape[0] // A, *y.shape[1:])
                     for y in Y))


def _pad_slot(x: torch.Tensor) -> torch.Tensor:
    """[A, s, ...] -> [A, s + 1, ...]: each agent's zero pad slot."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1) + x.shape[2:])], 1)


def fleet_apply(P: prob.ProblemData, X: RAState) -> RAState:
    """W = X Q of every agent at once: X's leaves are [A, s, ...] (s slots
    per agent); P is a fleet_operator of stride s + 1."""
    A = X.rot.shape[0]
    Xp = _merge(RAState(*(_pad_slot(x) for x in X)))
    W = _split(prob.apply_Q(P, Xp), A)
    return RAState(*(w[:, :-1].contiguous() for w in W))


def fleet_precondition(M: prob.Preconditioner, V: RAState) -> RAState:
    """problem.apply_preconditioner of every agent: M's leaves are [A, ...]."""
    n = M.pose_inv.shape[1]
    pose_v = torch.cat([V.rot, V.trn[:, :n, :, None]], dim=3)
    sol = torch.einsum("anrd,ande->anre", pose_v, M.pose_inv.to(V.rot.dtype))
    sd = M.sph_diag
    sph = V.sph / torch.where(sd == 0, torch.ones_like(sd), sd)[..., None]
    return RAState(rot=sol[..., :-1], sph=sph,
                   trn=torch.cat([sol[..., -1],
                                  V.trn[:, n:] / M.lmk_diag[..., None]], 1))


class FleetEdgeBackend(_RABackend):
    """The edge path over a stack of agents: RAState leaves [A, ...], P a
    fleet_operator, M a Preconditioner with [A, ...] leaves.  The per-pose
    ops are the single problem's, on the stack merged to one pose axis."""

    agent_dim = 0

    def applyQ(self, P, X):
        return fleet_apply(P, X)

    def hessvec(self, P, V):
        return fleet_apply(P, V)

    def tangent(self, P, X, V):
        return _split(tangent_project(_merge(X), _merge(V)), X.rot.shape[0])

    def hess_setup(self, P, X, egrad):
        return super().hess_setup(P, _merge(X), _merge(egrad))

    def weingarten(self, P, X, eta, aux):
        return _split(super().weingarten(P, _merge(X), _merge(eta), aux),
                      eta.rot.shape[0])

    def precond(self, P, M, X, V):
        return self.tangent(P, X, fleet_precondition(M, V))

    def retract(self, P, X, V):
        return _split(retract(_merge(X), _merge(V)), X.rot.shape[0])


class StackedFlatBackend(_FlatBackend):
    """The flat tiled backend over a stack of agents: [r_pad, A, kpad]
    tensors and a stack_tiled problem; every tile product is one launch of
    kernel 1 for all agents."""

    agent_dim = 1


FLEET_EDGE = FleetEdgeBackend()
STACKED_FLAT = StackedFlatBackend()


# --------------------------------------------------------------------------
# The fleet on the tiled path: agents side by side along the scalar axis
# --------------------------------------------------------------------------


def stack_tiled(per_agent: List[tiled.TiledProblem], device
                ) -> tiled.TiledProblem:
    """The agents' TiledProblems (one shared meta) as one problem over
    [r_pad, A, kpad] states: the strip CSRs side by side (agent a's source
    strips offset by a * kpad / BLOCK), block-diagonal; the dense tiles
    offset by a * nt (the plain reference's); the scalar-order maps and the
    preconditioner stacked along a leading agent axis."""
    meta = per_agent[0].meta
    nstrip = meta.kpad // BLOCK
    ptrs, srcs, vals, rows, cols = [], [], [], [], []
    off = 0
    for a, tp in enumerate(per_agent):
        if tp.meta != meta:
            raise ValueError("stack_tiled: the agents' layouts differ")
        ptr, src, v = tp.Q.strips
        ptrs.append(ptr[:-1].long() + off)
        srcs.append(src.long() + a * nstrip)
        vals.append(v)
        rows.append(tp.Q.tile_rows + a * meta.nt)
        cols.append(tp.Q.tile_cols + a * meta.nt)
        off += v.shape[0]
    ptrs.append(torch.tensor([off]))

    def dev(x, dtype=None):
        return x.to(device=device, dtype=dtype).contiguous()

    def stack(name):
        xs = [getattr(tp, name) for tp in per_agent]
        return None if xs[0] is None else dev(torch.stack(xs))

    strips = StripCSR(dev(torch.cat(ptrs), torch.int32),
                      dev(torch.cat(srcs), torch.int32),
                      dev(torch.cat(vals)))
    Q = tiled.TiledQ(
        tiles=dev(torch.cat([tp.Q.tiles for tp in per_agent])),
        tile_rows=dev(torch.cat(rows)), tile_cols=dev(torch.cat(cols)),
        strips=strips,
        ra_of_fl=dev(torch.stack([tp.Q.ra_of_fl for tp in per_agent])),
        fl_of_ra=dev(torch.stack([tp.Q.fl_of_ra for tp in per_agent])))
    return tiled.TiledProblem(
        Q=Q, meta=meta, pose_inv=stack("pose_inv"), sph_inv=stack("sph_inv"),
        lmk_inv=stack("lmk_inv"), diag_inv=stack("diag_inv"))


def agent_tiled(TPs: tiled.TiledProblem, a: int) -> tiled.TiledProblem:
    """Agent a's own TiledProblem out of a stack of one agent, or agent a's
    preconditioner and scalar-order maps beside the whole stack's Q."""
    return dataclasses.replace(
        TPs, pose_inv=TPs.pose_inv[a], sph_inv=TPs.sph_inv[a],
        lmk_inv=TPs.lmk_inv[a],
        diag_inv=None if TPs.diag_inv is None else TPs.diag_inv[a],
        Q=TPs.Q._replace(ra_of_fl=TPs.Q.ra_of_fl[a],
                         fl_of_ra=TPs.Q.fl_of_ra[a]))


def build_stacked_tiled(pp: ParallelRBCDProblem, lo: int, hi: int,
                        dtype=torch.float64, device="cpu", T: int = 128
                        ) -> tiled.TiledProblem:
    """Agents lo..hi-1's tiled forms of Q_bb at the common padded dims,
    stacked (dcora_tpu/parallel/rbcd.py:369-413): per-tile block-Jacobi
    when the agents have spheres, per-pose otherwise; no BTD."""
    per = []
    for a in range(lo, hi):
        P_a = prob.with_segments(
            prob.ProblemData(*(x[a] for x in pp.P_loc[:24])))
        per.append(tiled.build_tiled(
            P_a, pp.dims, T=T, dtype=dtype, reg=float(pp.regs[a]),
            tile_precond=pp.l_max > 0, device="cpu", pack="bucketed"))
    return stack_tiled(per, device)


def stack_to_flat(TP: tiled.TiledProblem, X: RAState, r_pad: int
                  ) -> torch.Tensor:
    """A stack's RAState ([A, ...] leaves) -> flat [r_pad, A, kpad]."""
    A, n, r, d = X.rot.shape
    ra = torch.cat([X.rot.permute(0, 2, 1, 3).reshape(A, r, n * d),
                    X.sph.transpose(1, 2), X.trn.transpose(1, 2)], dim=2)
    ra = torch.nn.functional.pad(ra, (0, 1, 0, r_pad - r))  # zero column k
    idx = TP.Q.ra_of_fl[:, None, :].expand(A, r_pad, -1)
    return torch.gather(ra, 2, idx).transpose(0, 1).contiguous()


def stack_from_flat(TP: tiled.TiledProblem, Xf: torch.Tensor, r: int
                    ) -> RAState:
    """Flat [r_pad, A, kpad] -> the stack's RAState at rank r."""
    m = TP.meta
    A = Xf.shape[1]
    idx = TP.Q.fl_of_ra[:, None, :].expand(A, r, -1)
    ra = torch.gather(Xf.transpose(0, 1)[:, :r], 2, idx)  # [A, r, k]
    nd = m.n * m.d
    return RAState(
        rot=ra[..., :nd].reshape(A, r, m.n, m.d).permute(0, 2, 1, 3)
        .contiguous(),
        sph=ra[..., nd:nd + m.l].transpose(1, 2).contiguous(),
        trn=ra[..., nd + m.l:].transpose(1, 2).contiguous())


# --------------------------------------------------------------------------
# The round and the separator exchange
# --------------------------------------------------------------------------


def group_shape(group) -> Tuple[int, int]:
    """(world size, rank) of a torch.distributed group; (1, 0) for None."""
    if group is None:
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(group), dist.get_rank(group)


class ParallelRound:
    """One synchronous-parallel RBCD round, X -> (X', block gradnorms)
    (dcora_tpu/parallel/rbcd.py:539-662): publish, exchange, gather the
    fixed states per agent, the linear term G on the edge path, then the
    one-accepted-step RTR of every agent at once on the chosen backend
    ("edge" at float64, or "tiled" at `tile_dtype`).

    With no process group the public buffers are gathered locally (the
    JAX package's one-device mesh).  In a torch.distributed group of world
    size W this rank owns agents [rank A/W, (rank + 1) A/W) and takes and
    returns their states only; the buffers go through
    all_gather_into_tensor (NCCL) or all_gather (gloo).  W must divide A,
    as shard_map requires."""

    def __init__(self, pp: ParallelRBCDProblem, cfg: RTRConfig,
                 backend: str = "edge", tile_dtype=torch.float64,
                 device="cpu", group=None):
        if backend not in ("edge", "tiled"):
            raise ValueError(f"unknown backend {backend!r}")
        self.pp, self.cfg, self.backend = pp, cfg, backend
        self.group = group
        self.world, self.rank = group_shape(group)
        A = pp.num_agents
        if A % self.world:
            raise ValueError(f"{A} agents do not split over {self.world} "
                             "ranks")
        lo = self.rank * (A // self.world)
        hi = lo + A // self.world
        self.agents = (lo, hi)
        self.device = dev = torch.device(device)
        self.P_aug = fleet_operator(
            pp.P, lo, hi, (pp.n_max + pp.fp_max + 1, pp.t_max + pp.ft_max + 1,
                           pp.l_max + pp.fs_max + 1), dev)
        self.pub = [x[lo:hi].to(dev) for x in (
            pp.pub_pose_idx, pp.pub_pose_idx, pp.pub_lmk_idx,
            pp.pub_sph_idx)]
        # fixed-slot gathers as rows of the exchanged buffers: pose rows of
        # the pose buffer, translations from the pose or landmark buffer by
        # kind (the other read clamped to row 0), spheres
        fps, fts, fss = (x[lo:hi] for x in (
            pp.fix_pose_src, pp.fix_trans_src, pp.fix_sph_src))
        is_pose = fts[..., 2] == _KIND_POSE
        self.fix_rot = (fps[..., 0] * pp.pp_max + fps[..., 1]).to(dev)
        self.fix_ptr = torch.where(
            is_pose, fts[..., 0] * pp.pp_max + fts[..., 1], 0).to(dev)
        self.fix_lmk = torch.where(
            is_pose, 0, fts[..., 0] * pp.plm_max + fts[..., 1]).to(dev)
        self.fix_is_pose = is_pose[..., None].to(dev)
        self.fix_sph = (fss[..., 0] * pp.ps_max + fss[..., 1]).to(dev)
        self.TP = self.P_loc = self.M = self.graph = None
        if backend == "tiled":
            self.TP = build_stacked_tiled(pp, lo, hi, tile_dtype, dev)
        else:
            self.P_loc = fleet_operator(
                pp.P_loc, lo, hi, (pp.n_max + 1, pp.t_max + 1,
                                   pp.l_max + 1), dev)
            self.M = prob.Preconditioner(*(x[lo:hi].to(dev) for x in pp.M))

    # -- exchange ----------------------------------------------------------

    def exchange(self, buf: torch.Tensor) -> torch.Tensor:
        """[A/W, F] rows of this rank's agents -> [A, F] of all agents."""
        if self.group is None:
            return buf
        import torch.distributed as dist

        buf = buf.contiguous()
        if dist.get_backend(self.group) == "nccl":
            out = torch.empty((self.world * buf.shape[0], buf.shape[1]),
                              dtype=buf.dtype, device=buf.device)
            dist.all_gather_into_tensor(out, buf, group=self.group)
            return out
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts)

    def gather_states(self, X: RAState) -> RAState:
        """This rank's agents' states -> every agent's, on every rank."""
        A_l = X.rot.shape[0]
        full = self.exchange(torch.cat([x.reshape(A_l, -1) for x in X], 1))
        out, at = [], 0
        for x in X:
            w = x[0].numel()
            out.append(full[:, at:at + w].reshape(full.shape[0],
                                                   *x.shape[1:]))
            at += w
        return RAState(*out)

    def reduce_sq(self, gnorms: torch.Tensor) -> float:
        """sqrt of the sum of every agent's squared block gradnorm."""
        sq = (gnorms ** 2).sum()
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(sq, group=self.group)
        return float(torch.sqrt(sq))

    def publish(self, X: RAState) -> torch.Tensor:
        """[A/W, F]: each agent's public poses (rotation and translation),
        landmarks and spheres, in StateID order, as one row."""
        A_l = X.rot.shape[0]
        rows = torch.arange(A_l, device=X.rot.device)[:, None]
        parts = []
        for x, idx in zip((X.rot, X.trn, X.trn, X.sph), self.pub):
            parts.append(_pad_slot(x)[rows, idx].reshape(A_l, -1))
        return torch.cat(parts, 1)

    def fixed_states(self, g: torch.Tensor, r: int) -> RAState:
        """The fixed-slot states of this rank's agents from the exchanged
        buffers [A, F]."""
        pp, d = self.pp, self.pp.d
        sizes = [pp.pp_max * r * d, pp.pp_max * r, pp.plm_max * r,
                 pp.ps_max * r]
        g_rot, g_ptr, g_lmk, g_sph = torch.split(g, sizes, 1)
        g_rot = g_rot.reshape(-1, r, d)
        g_ptr, g_lmk, g_sph = (x.reshape(-1, r) for x in (g_ptr, g_lmk,
                                                         g_sph))
        return RAState(
            rot=g_rot[self.fix_rot],
            sph=g_sph[self.fix_sph],
            trn=torch.where(self.fix_is_pose, g_ptr[self.fix_ptr],
                            g_lmk[self.fix_lmk]))

    def linear_term(self, X: RAState, fixed: RAState) -> RAState:
        """G of every agent: its fixed states through the augmented Q,
        restricted to its local slots."""
        X_aug = RAState(*(torch.cat([torch.zeros_like(x), f], 1)
                          for x, f in zip(X, fixed)))
        W = fleet_apply(self.P_aug, X_aug)
        pp = self.pp
        return RAState(rot=W.rot[:, :pp.n_max].contiguous(),
                       sph=W.sph[:, :pp.l_max].contiguous(),
                       trn=W.trn[:, :pp.t_max].contiguous())

    # -- the round ---------------------------------------------------------

    def __call__(self, X: RAState) -> Tuple[RAState, torch.Tensor]:
        r = X.rot.shape[2]
        fixed = self.fixed_states(self.exchange(self.publish(X)), r)
        G = self.linear_term(X, fixed)
        if self.backend == "edge":
            if X.rot.is_cuda and self.graph is None:
                # the tCG iterations replay a CUDA graph, captured once
                self.graph = TCGGraph(FLEET_EDGE, self.P_loc, self.M,
                                      self.cfg.max_inner)
            res = rtr_stacked(self.P_loc, G, self.M, X, self.cfg,
                              FLEET_EDGE, graph=self.graph)
            return res.X, res.gradnorm_final
        dt = self.TP.dtype
        r_pad = max(8, -(-r // 8) * 8)
        Xf = stack_to_flat(self.TP, X, r_pad).to(dt)
        Gf = stack_to_flat(self.TP, G, r_pad).to(dt)
        res = rtr_stacked(self.TP, Gf, None, Xf, self.cfg, STACKED_FLAT)
        return (stack_from_flat(self.TP, res.X.to(X.rot.dtype), r),
                res.gradnorm_final.to(X.rot.dtype))


def round_per_agent(pp: ParallelRBCDProblem, cfg: RTRConfig, X: RAState,
                    backend: str = "edge", tile_dtype=torch.float64
                    ) -> Tuple[RAState, torch.Tensor]:
    """The plain version of a round, for tests: the same exchange and G,
    then each agent alone through the single-agent core.rtr.rtr (on its
    padded local problem, or its own TiledProblem on the flat backend)."""
    from dcora_tpu_torch.core.rtr import FLAT_BACKEND, rtr

    rnd = ParallelRound(pp, cfg, backend="edge", device=X.rot.device)
    r = X.rot.shape[2]
    G = rnd.linear_term(X, rnd.fixed_states(rnd.exchange(rnd.publish(X)),
                                            r))
    outs, gn = [], []
    for a in range(pp.num_agents):
        Xa = RAState(*(x[a] for x in X))
        Ga = RAState(*(x[a] for x in G))
        Pa = fleet_operator(pp.P_loc, a, a + 1, (pp.n_max + 1, pp.t_max + 1,
                                                 pp.l_max + 1), X.rot.device)
        if backend == "edge":
            Ma = prob.Preconditioner(*(x[a].to(X.rot.device) for x in pp.M))
            res = rtr(Pa, Ga, Ma, Xa, cfg)
            outs.append(res.X)
        else:
            TPa = agent_tiled(build_stacked_tiled(
                pp, a, a + 1, tile_dtype, X.rot.device), 0)
            r_pad = max(8, -(-r // 8) * 8)
            dt = TPa.dtype
            res = rtr(TPa, tiled.to_flat(TPa, Ga, r_pad).to(dt), None,
                      tiled.to_flat(TPa, Xa, r_pad).to(dt), cfg,
                      be=FLAT_BACKEND)
            outs.append(tiled.from_flat(TPa, res.X.to(X.rot.dtype), r=r))
        gn.append(res.gradnorm_final.to(X.rot.dtype))
    return (RAState(*(torch.stack(xs) for xs in zip(*outs))),
            torch.stack(gn))


# --------------------------------------------------------------------------
# What the parallel drivers share: the process group and the round loop
# --------------------------------------------------------------------------


def init_group(device, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None):
    """The torch.distributed group of a parallel run, or None for one
    process: from the arguments (init_method such as
    ``tcp://localhost:PORT``, world size and rank), else from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  The backend
    is nccl on cuda and gloo on cpu."""
    import os

    import torch.distributed as dist

    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return None
        init_method = "env://"
    if not dist.is_initialized():
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        kw = {} if init_method == "env://" else dict(
            world_size=world_size, rank=rank)
        dist.init_process_group(backend, init_method=init_method, **kw)
    return dist.group.WORLD


def resolve_backend(backend: str, tile_dtype, device: torch.device):
    """"auto": tiled with float32 tiles on cuda, edge with float64 on the
    CPU, as the JAX drivers pick for an accelerator and for the CPU."""
    if backend == "auto":
        backend = "tiled" if device.type == "cuda" else "edge"
    if tile_dtype is None:
        tile_dtype = torch.float32 if device.type == "cuda" else \
            torch.float64
    return backend, tile_dtype


@dataclasses.dataclass
class ParallelResult:
    X: Optional[RAState]      # the global state (None across ranks)
    X_stack: RAState          # every agent's [A, ...] state
    cost: float               # 2 f at the end (nan across ranks)
    gradnorm: float
    rounds: int
    # (round, cost, gradnorm) of every central evaluation
    trace: List[Tuple[int, float, float]]
    rounds_s: float           # seconds in the rounds themselves
    elapsed_s: float
    # (real scalar columns, A * kpad): what the common padded shapes cost
    columns: Tuple[int, int] = (0, 0)


def run_rounds(rnd: ParallelRound, Xb: RAState, max_rounds: int,
               check_every: int, tol: float, evaluate,
               verbose: bool = False):
    """The drivers' loop (dcora_tpu/drivers/parallel_pgo.py:150-180): a
    round, and every check_every rounds (and at the last) a central
    evaluation -- evaluate(Xb) -> (2 f, gradnorm) with one process, the
    reduced block gradnorms and a nan cost across ranks -- until the
    gradnorm falls below tol.  Returns (Xb, rounds, trace, gradnorm,
    rounds_s)."""
    import time

    gradnorm, rounds, trace, rounds_s = float("inf"), 0, [], 0.0
    sync = Xb.rot.is_cuda
    for it in range(max_rounds):
        t0 = time.perf_counter()
        Xb, gnorms = rnd(Xb)
        if sync:
            torch.cuda.synchronize(Xb.rot.device)
        rounds_s += time.perf_counter() - t0
        rounds += 1
        if it % check_every == 0 or it == max_rounds - 1:
            if rnd.world > 1:
                cost, gradnorm = float("nan"), rnd.reduce_sq(gnorms)
            else:
                cost, gradnorm = evaluate(Xb)
            trace.append((it, cost, gradnorm))
            if verbose:
                print(f"round = {it} | cost = {cost:.6f} | "
                      f"gradnorm = {gradnorm:.4f}")
            if gradnorm < tol:
                break
    return Xb, rounds, trace, gradnorm, rounds_s


def add_group_args(ap):
    """The process-group options of the parallel drivers' main()."""
    ap.add_argument("--dist-url", default=None,
                    help="torch.distributed init method, e.g. "
                    "tcp://localhost:29500 (default: torchrun's "
                    "environment, else one process)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--dist-rank", type=int, default=None)
