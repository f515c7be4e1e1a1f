"""Solver checkpointing.

Counterpart of ``dcora_tpu.utils.checkpoint``, in its NPZ format: the
lifted iterate (``rot``, ``sph``, ``trn``), the active ``rank``, robust
weights (``w_<name>``) and extra state (``x_<name>``) in one file, so a
checkpoint written by either engine loads in the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from dcora_tpu_torch.core.lifted import RAState


def save_checkpoint(path: str, X: RAState, rank: int,
                    weights: Optional[Dict[str, np.ndarray]] = None,
                    extra: Optional[Dict[str, Any]] = None):
    payload = {
        "rot": X.rot.detach().cpu().numpy(),
        "sph": X.sph.detach().cpu().numpy(),
        "trn": X.trn.detach().cpu().numpy(),
        "rank": np.asarray(rank),
    }
    for k, v in (weights or {}).items():
        payload[f"w_{k}"] = np.asarray(v)
    for k, v in (extra or {}).items():
        payload[f"x_{k}"] = np.asarray(v)
    # np.savez appends .npz to a name without it; write beside, then rename
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str, device="cpu"):
    """Returns (X on `device`, rank, weights, extra)."""
    with np.load(path) as z:
        X = RAState(*(torch.as_tensor(z[k], dtype=torch.float64,
                                      device=device)
                      for k in ("rot", "sph", "trn")))
        rank = int(z["rank"])
        weights = {k[2:]: z[k] for k in z.files if k.startswith("w_")}
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    return X, rank, weights, extra
