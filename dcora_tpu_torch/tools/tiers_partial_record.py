"""Record an honest in-progress RA parity row from a staircase checkpoint.

Counterpart of the JAX package's ``tools/tiers_partial_record.py``.  When a
long RA-SLAM staircase (tiers.pyfg: 9,769 vertices) outlives the time it was
given, this records the truth about where it stands: the checkpointed
iterate (the NPZ of ``utils.checkpoint``, written by either engine's
staircase), independently verified (cost, Riemannian gradient norm, the
LDL^T-based certificate verdict of ``verification.verify_solution``),
marked ``certified: false`` / ``in_progress: true``, with the checkpoint
copied beside the record so the run can resume from it
(``tools.parity --configs tiers`` checkpoints under the same name).

Usage:
  python -m dcora_tpu_torch.tools.tiers_partial_record [CHECKPOINT.npz]
      [--pyfg FILE] [--out-dir DIR] [--name tiers] [--eta 1e-4]
      [--device cuda|cpu]

--pyfg defaults to tiers.pyfg in $DCORA_DATA_DIR (the JAX tool's dataset);
the JAX package's artifacts/tiers_checkpoint_r5.npz is such a checkpoint.
Writes OUT_DIR/parity/NAME.json and OUT_DIR/NAME_checkpoint.npz (OUT_DIR:
artifacts/torch).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ART = os.path.join(REPO, "artifacts", "torch")


def record(pyfg: str, checkpoint: str, eta: float = 1e-4,
           device="cuda") -> dict:
    """The in-progress row of the RA problem of `pyfg` at the state of
    `checkpoint`."""
    from dcora_tpu_torch import verification as V
    from dcora_tpu_torch.core import lifted, problem as prob
    from dcora_tpu_torch.core.certify import round_solution
    from dcora_tpu_torch.core.device import resolve_device
    from dcora_tpu_torch.core.graph import LocalGraph
    from dcora_tpu_torch.core.manifold import tangent_project
    from dcora_tpu_torch.io import read_pyfg_file
    from dcora_tpu_torch.io.remap import get_global_measurements
    from dcora_tpu_torch.tools.common import platform
    from dcora_tpu_torch.types import GraphType
    from dcora_tpu_torch.utils.checkpoint import load_checkpoint

    dev = resolve_device(device)
    ds = read_pyfg_file(pyfg)
    gm = get_global_measurements(ds)
    g = LocalGraph(0, ds.dim, ds.dim, GraphType.RangeAidedSLAMGraph)
    g.set_measurements(gm.relative_measurements)
    X, rank, _, _ = load_checkpoint(checkpoint, dev)
    P = g.problem_data(device=dev)
    G = lifted.zeros(X.dims, X.r, device=dev)
    f = float(prob.cost(P, X, G))
    gn = float(lifted.to_flat(tangent_project(
        X, prob.euclidean_gradient(P, X, G))).norm())
    f_rounded = float(prob.cost(P, round_solution(X)))
    rep = V.verify_solution(gm.relative_measurements, X, ds.dim, eta=eta)
    rec = {
        "certified": False,
        "in_progress": True,
        "final_rank": int(X.r),
        "checkpoint_rank": rank,
        "f_final": f,
        "f_rounded": f_rounded,
        "gradnorm_final": gn,
        "note": (
            f"staircase in progress: the checkpointed iterate at rank "
            f"{X.r} ({os.path.basename(checkpoint)}), independently "
            f"verified; resume with tools.parity --configs "
            f"{os.path.splitext(os.path.basename(pyfg))[0]}"),
    }
    rec.update(rep)
    rec["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    rec["platform"] = platform(dev)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "dcora_torch_ckpt_tiers.pyfg.npz"))
    ap.add_argument("--pyfg", default=os.path.join(
        os.environ.get("DCORA_DATA_DIR", ""), "tiers.pyfg"))
    ap.add_argument("--out-dir", default=ART)
    ap.add_argument("--name", default="tiers")
    ap.add_argument("--eta", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the cost evaluation (the "
                    "verifier runs on the host; default: cuda)")
    args = ap.parse_args(argv)
    if not os.path.exists(args.pyfg):
        raise FileNotFoundError(args.pyfg)
    rec = record(args.pyfg, args.checkpoint, args.eta, args.device)
    os.makedirs(os.path.join(args.out_dir, "parity"), exist_ok=True)
    shutil.copy(args.checkpoint, os.path.join(
        args.out_dir, f"{args.name}_checkpoint.npz"))
    with open(os.path.join(args.out_dir, "parity", f"{args.name}.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1, default=float)
    print(json.dumps(rec, indent=1, default=float))
    return rec


if __name__ == "__main__":
    main()
