"""ctypes bindings of the native runtime library (native/ in the repository).

Counterpart of ``dcora_tpu.native``: the host-side data path in C++ --
the g2o and PyFG loaders and the block-Jacobi preconditioner assembly
(reference: DCORA_utils.cpp:179-1167, Graph.cpp:1888-1960) -- through the
C ABI of ``native/include/dcora_native.h``.

The library is compiled from ``native/src/*.cpp`` at first use, with
``native/Makefile``'s ``-O3 -std=c++17 -fPIC`` and, on a CPU with
AVX-512, ``-march=x86-64-v4``, else ``-march=native``: on AVX-512 hosts
the parsed numbers and the Jacobi blocks are then bit for bit those of the
JAX package's committed ``native/build/libdcora_native.so`` (the compiler
contracts products into FMAs and vectorizes the block inversions as that
build does; -O2 or another -march differs in the last ulps, which the GNC
loops amplify).  It goes into ``dcora_tpu_torch/build/native/``; the file
name carries a hash of the sources, the flags and the host CPU's feature
flags.  It never runs the Makefile of ``native/``, whose
``build/`` holds the JAX package's own committed objects.  When no compiler is found or the build fails, the
compiler's message is logged once and the callers run their numpy paths;
which path ran is theirs to report (``io.g2o.read_g2o_file`` and
``io.pyfg.read_pyfg_file`` set the dataset's ``reader``, and
``solvers.precond_build`` names the preconditioner's).

Set ``DCORA_NATIVE=0`` to turn the native path off.
"""

from __future__ import annotations

import ctypes as ct
import glob
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "build", "native")
AVX512 = ("avx512f", "avx512bw", "avx512cd", "avx512dq", "avx512vl")

_lib = None
_tried = False
_lock = threading.Lock()
build_error: Optional[str] = None  # the compiler's message of a failed build

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _sources():
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "src", "*.cpp")))


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            return next((line for line in fh if line.startswith("flags")),
                        "")
    except OSError:
        return ""


def cxx_flags() -> list:
    cpu = _cpu_flags().split()
    march = "x86-64-v4" if all(f in cpu for f in AVX512) else "native"
    return ["-O3", f"-march={march}", "-std=c++17", "-shared", "-fPIC"]


def library_path() -> str:
    """Where the build of the current sources, flags and CPU goes."""
    h = hashlib.sha256(" ".join(cxx_flags()).encode())
    h.update(_cpu_flags().encode())
    for f in (*_sources(), os.path.join(NATIVE_DIR, "src", "util.h"),
              os.path.join(NATIVE_DIR, "include", "dcora_native.h")):
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libdcora_native_{h.hexdigest()[:12]}.so")


def _build() -> Optional[str]:
    """Compile the library unless this build exists; its path, or None
    (the reason logged once, and kept in ``build_error``)."""
    global build_error
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        build_error = "no C++ compiler (g++ or c++) on PATH"
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *cxx_flags(), "-o", tmp, *_sources()],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: concurrent builds agree
            return out
        build_error = (f"{cxx} failed ({proc.returncode}):\n{proc.stdout}"
                       f"{proc.stderr}")
    logger.warning("native library not built, numpy paths run instead: %s",
                   build_error)
    return None


def _declare(lib) -> None:
    lib.dcora_g2o_parse.restype = ct.c_void_p
    lib.dcora_g2o_parse.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
    lib.dcora_g2o_dim.restype = ct.c_int
    lib.dcora_g2o_dim.argtypes = [ct.c_void_p]
    lib.dcora_g2o_num_vertices.restype = ct.c_int64
    lib.dcora_g2o_num_vertices.argtypes = [ct.c_void_p]
    lib.dcora_g2o_num_edges.restype = ct.c_int64
    lib.dcora_g2o_num_edges.argtypes = [ct.c_void_p]
    lib.dcora_g2o_get_vertices.restype = None
    lib.dcora_g2o_get_vertices.argtypes = [ct.c_void_p, _i64p, _f64p, _f64p]
    lib.dcora_g2o_get_edges.restype = None
    lib.dcora_g2o_get_edges.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_g2o_free.restype = None
    lib.dcora_g2o_free.argtypes = [ct.c_void_p]

    lib.dcora_pyfg_parse.restype = ct.c_void_p
    lib.dcora_pyfg_parse.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
    lib.dcora_pyfg_dim.restype = ct.c_int
    lib.dcora_pyfg_dim.argtypes = [ct.c_void_p]
    lib.dcora_pyfg_count.restype = ct.c_int64
    lib.dcora_pyfg_count.argtypes = [ct.c_void_p, ct.c_int]
    lib.dcora_pyfg_get_gt_poses.restype = None
    lib.dcora_pyfg_get_gt_poses.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_gt_landmarks.restype = None
    lib.dcora_pyfg_get_gt_landmarks.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p,
    ]
    lib.dcora_pyfg_get_pose_priors.restype = None
    lib.dcora_pyfg_get_pose_priors.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_landmark_priors.restype = None
    lib.dcora_pyfg_get_landmark_priors.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_rel_pose_pose.restype = None
    lib.dcora_pyfg_get_rel_pose_pose.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p,
        _f64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_rel_pose_landmark.restype = None
    lib.dcora_pyfg_get_rel_pose_landmark.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_ranges.restype = None
    lib.dcora_pyfg_get_ranges.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
        _i64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_free.restype = None
    lib.dcora_pyfg_free.argtypes = [ct.c_void_p]

    lib.dcora_ldlt_analyse.restype = ct.c_void_p
    lib.dcora_ldlt_analyse.argtypes = [ct.c_int64, _i64p, _i64p, _i64p,
                                       ct.c_char_p, ct.c_int]
    lib.dcora_ldlt_sizes.restype = None
    lib.dcora_ldlt_sizes.argtypes = [ct.c_void_p, _i64p]
    lib.dcora_ldlt_get.restype = None
    lib.dcora_ldlt_get.argtypes = [ct.c_void_p] + [_i64p] * 6
    lib.dcora_ldlt_free.restype = None
    lib.dcora_ldlt_free.argtypes = [ct.c_void_p]
    lib.dcora_ldlt_place.restype = ct.c_int
    lib.dcora_ldlt_place.argtypes = [ct.c_int64] + [_i64p] * 5

    lib.dcora_jacobi_precond.restype = ct.c_int
    lib.dcora_jacobi_precond.argtypes = [
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int, ct.c_double,
        ct.c_int64, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p,
        ct.c_int64, _i64p, _i64p, _f64p, _f64p, _f64p,
        ct.c_int64, _i64p, _i64p, _i64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, _f64p,
    ]


def get_library():
    """The loaded native library (built at first use), or None when
    DCORA_NATIVE=0 or the build failed."""
    global _lib, _tried, build_error
    if os.environ.get("DCORA_NATIVE", "1") == "0":
        return None
    with _lock:
        if not _tried:
            _tried = True
            path = _build()
            if path is not None:
                try:
                    lib = ct.CDLL(path)
                except OSError as e:  # a build of another machine's
                    build_error = f"cannot load {path}: {e}"
                    logger.warning("native library not loaded, numpy "
                                   "paths run instead: %s", build_error)
                    return None
                _declare(lib)
                _lib = lib
    return _lib


def available() -> bool:
    return get_library() is not None


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------


class G2oArrays:
    """Flat-array view of a parsed g2o file."""

    def __init__(self, dim, v_ids, v_R, v_t, e_i, e_j, e_R, e_t, e_kappa,
                 e_tau):
        self.dim = dim
        self.v_ids = v_ids
        self.v_R = v_R
        self.v_t = v_t
        self.e_i = e_i
        self.e_j = e_j
        self.e_R = e_R
        self.e_t = e_t
        self.e_kappa = e_kappa
        self.e_tau = e_tau


def parse_g2o(path: str) -> Optional[G2oArrays]:
    lib = get_library()
    if lib is None:
        return None
    err = ct.create_string_buffer(512)
    h = lib.dcora_g2o_parse(path.encode(), err, len(err))
    if not h:
        raise ValueError(err.value.decode() or f"g2o parse failed: {path}")
    try:
        d = lib.dcora_g2o_dim(h)
        nv = lib.dcora_g2o_num_vertices(h)
        ne = lib.dcora_g2o_num_edges(h)
        v_ids = np.empty(nv, np.int64)
        v_R = np.empty((nv, d, d))
        v_t = np.empty((nv, d))
        lib.dcora_g2o_get_vertices(h, v_ids, v_R, v_t)
        e_i = np.empty(ne, np.int64)
        e_j = np.empty(ne, np.int64)
        e_R = np.empty((ne, d, d))
        e_t = np.empty((ne, d))
        e_kappa = np.empty(ne)
        e_tau = np.empty(ne)
        lib.dcora_g2o_get_edges(h, e_i, e_j, e_R, e_t, e_kappa, e_tau)
        return G2oArrays(d, v_ids, v_R, v_t, e_i, e_j, e_R, e_t, e_kappa,
                         e_tau)
    finally:
        lib.dcora_g2o_free(h)


class PyfgArrays:
    """Flat-array view of a parsed PyFG file.  ``seq`` arrays give the
    file-order position of each relative measurement across all kinds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def parse_pyfg(path: str) -> Optional[PyfgArrays]:
    lib = get_library()
    if lib is None:
        return None
    err = ct.create_string_buffer(512)
    h = lib.dcora_pyfg_parse(path.encode(), err, len(err))
    if not h:
        raise ValueError(err.value.decode() or f"pyfg parse failed: {path}")
    try:
        d = lib.dcora_pyfg_dim(h)
        ngp, ngl, npp, npl, mpp, mpl, mrg = (lib.dcora_pyfg_count(h, k)
                                             for k in range(7))

        gp_robot = np.empty(ngp, np.int64)
        gp_state = np.empty(ngp, np.int64)
        gp_R = np.empty((ngp, d, d))
        gp_t = np.empty((ngp, d))
        lib.dcora_pyfg_get_gt_poses(h, gp_robot, gp_state, gp_R, gp_t)

        gl_robot = np.empty(ngl, np.int64)
        gl_state = np.empty(ngl, np.int64)
        gl_t = np.empty((ngl, d))
        lib.dcora_pyfg_get_gt_landmarks(h, gl_robot, gl_state, gl_t)

        prp_robot = np.empty(npp, np.int64)
        prp_state = np.empty(npp, np.int64)
        prp_R = np.empty((npp, d, d))
        prp_t = np.empty((npp, d))
        prp_kappa = np.empty(npp)
        prp_tau = np.empty(npp)
        lib.dcora_pyfg_get_pose_priors(
            h, prp_robot, prp_state, prp_R, prp_t, prp_kappa, prp_tau)

        prl_robot = np.empty(npl, np.int64)
        prl_state = np.empty(npl, np.int64)
        prl_t = np.empty((npl, d))
        prl_tau = np.empty(npl)
        lib.dcora_pyfg_get_landmark_priors(
            h, prl_robot, prl_state, prl_t, prl_tau)

        pp = {k: np.empty(mpp, np.int64) for k in
              ("seq", "r1", "p1", "r2", "p2")}
        pp_R = np.empty((mpp, d, d))
        pp_t = np.empty((mpp, d))
        pp_kappa = np.empty(mpp)
        pp_tau = np.empty(mpp)
        lib.dcora_pyfg_get_rel_pose_pose(
            h, pp["seq"], pp["r1"], pp["p1"], pp["r2"], pp["p2"],
            pp_R, pp_t, pp_kappa, pp_tau)

        pl = {k: np.empty(mpl, np.int64) for k in
              ("seq", "r1", "p1", "r2", "p2")}
        pl_t = np.empty((mpl, d))
        pl_tau = np.empty(mpl)
        lib.dcora_pyfg_get_rel_pose_landmark(
            h, pl["seq"], pl["r1"], pl["p1"], pl["r2"], pl["p2"],
            pl_t, pl_tau)

        rg = {k: np.empty(mrg, np.int64) for k in
              ("seq", "r1", "p1", "st1", "r2", "p2", "st2", "l")}
        rg_range = np.empty(mrg)
        rg_prec = np.empty(mrg)
        rg_u = np.empty((mrg, d))
        lib.dcora_pyfg_get_ranges(
            h, rg["seq"], rg["r1"], rg["p1"], rg["st1"], rg["r2"],
            rg["p2"], rg["st2"], rg["l"], rg_range, rg_prec, rg_u)

        return PyfgArrays(
            dim=d,
            gp_robot=gp_robot, gp_state=gp_state, gp_R=gp_R, gp_t=gp_t,
            gl_robot=gl_robot, gl_state=gl_state, gl_t=gl_t,
            prp_robot=prp_robot, prp_state=prp_state, prp_R=prp_R,
            prp_t=prp_t, prp_kappa=prp_kappa, prp_tau=prp_tau,
            prl_robot=prl_robot, prl_state=prl_state, prl_t=prl_t,
            prl_tau=prl_tau,
            pp=pp, pp_R=pp_R, pp_t=pp_t, pp_kappa=pp_kappa, pp_tau=pp_tau,
            pl=pl, pl_t=pl_t, pl_tau=pl_tau,
            rg=rg, rg_range=rg_range, rg_prec=rg_prec, rg_u=rg_u,
        )
    finally:
        lib.dcora_pyfg_free(h)


# --------------------------------------------------------------------------
# preconditioner assembly
# --------------------------------------------------------------------------


def jacobi_precond(n: int, nsph: int, nlmk: int, d: int, reg: float,
                   pp_ri, pp_rj, pp_t, pp_kappa, pp_tau, pp_w,
                   pl_ri, pl_tj, pl_t, pl_tau, pl_w,
                   rg_ti, rg_tj, rg_q, rg_rho, rg_prec, rg_w):
    """Native block-Jacobi assembly and inversion of numpy arrays.  Returns
    (pose_inv [n,d+1,d+1], sph_diag [nsph], lmk_diag [nlmk]), or None when
    the native library is unavailable.  A prior's quadratic diagonal is
    left out, as in the JAX package's native build."""
    lib = get_library()
    if lib is None:
        return None

    def i64(a):
        return np.ascontiguousarray(np.asarray(a), np.int64)

    def f64(a):
        return np.ascontiguousarray(np.asarray(a), np.float64)

    pose_inv = np.zeros((n, d + 1, d + 1))
    sph_diag = np.zeros(nsph)
    lmk_diag = np.zeros(nlmk)
    rc = lib.dcora_jacobi_precond(
        n, nsph, nlmk, d, reg,
        len(pp_ri), i64(pp_ri), i64(pp_rj), f64(pp_t), f64(pp_kappa),
        f64(pp_tau), f64(pp_w),
        len(pl_ri), i64(pl_ri), i64(pl_tj), f64(pl_t), f64(pl_tau),
        f64(pl_w),
        len(rg_ti), i64(rg_ti), i64(rg_tj), i64(rg_q), f64(rg_rho),
        f64(rg_prec), f64(rg_w),
        pose_inv, sph_diag, lmk_diag,
    )
    if rc != 0:
        raise ValueError("preconditioner pose block not positive definite")
    return pose_inv, sph_diag, lmk_diag


# --------------------------------------------------------------------------
# symbolic analysis of the LDL^T inertia proof
# --------------------------------------------------------------------------


def ldlt_analyse(adj_ptr, adj_idx, weight):
    """Ordering and supernodal symbolic analysis of a variable graph
    (``native/src/ldlt_analyse.cpp``): the symmetric adjacency (adj_ptr,
    adj_idx) of nn nodes without self loops, each node weighing its number
    of scalar columns.  Returns (perm, sn_ptr, sn_parent, sn_level, rs_ptr,
    rs_idx) as int64 arrays in node positions (perm[k] = the node placed
    k-th), or None when the native library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    adj_ptr = np.ascontiguousarray(adj_ptr, np.int64)
    adj_idx = np.ascontiguousarray(adj_idx, np.int64)
    weight = np.ascontiguousarray(weight, np.int64)
    nn = len(weight)
    err = ct.create_string_buffer(512)
    h = lib.dcora_ldlt_analyse(nn, adj_ptr, adj_idx, weight, err, len(err))
    if not h:
        raise MemoryError(err.value.decode())
    try:
        sizes = np.zeros(2, np.int64)
        lib.dcora_ldlt_sizes(h, sizes)
        ns, nrs = (int(x) for x in sizes)
        out = (np.empty(nn, np.int64), np.empty(ns + 1, np.int64),
               np.empty(ns, np.int64), np.empty(ns, np.int64),
               np.empty(ns + 1, np.int64), np.empty(nrs, np.int64))
        lib.dcora_ldlt_get(h, *out)
        return out
    finally:
        lib.dcora_ldlt_free(h)


def ldlt_place(order, gsize, gfrom, guntil):
    """Offsets of groups of fronts in one buffer
    (``native/src/ldlt_analyse.cpp``, dcora_ldlt_place): group g holds
    gsize[g] words alive from level gfrom[g] to guntil[g]; placed in
    `order` (gfrom ascending), each first-fit beside the groups whose lives
    overlap its own.  Returns the int64 offsets, or None when the native
    library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    order, gsize, gfrom, guntil = (np.ascontiguousarray(a, np.int64)
                                   for a in (order, gsize, gfrom, guntil))
    goff = np.zeros(len(gsize), np.int64)
    if lib.dcora_ldlt_place(len(order), order, gsize, gfrom, guntil,
                            goff) != 0:
        raise ValueError("ldlt_place: the order is not by first level")
    return goff
