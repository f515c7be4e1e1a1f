"""dcora_tpu_torch: certifiably-correct pose-graph optimization in PyTorch.

The PyTorch and CUDA counterpart of ``dcora_tpu`` (the JAX package, which
stays in the repository as the reference).  Module names mirror the JAX
package one for one, so each module's counterpart is found by name.  The
package imports torch, numpy and scipy, and never JAX.

Numerics policy
---------------
* float64 is the working type everywhere except the float32 tile phase of
  ``solvers.rtr_fast``.  Every builder takes its dtype explicitly (the
  process-wide torch default dtype is left alone).
* TF32 is off: a float32 matrix product on the card runs in full float32.
  Both switches are set here, on import, because a float32 convolution or
  matmul that silently drops to TF32 (about three decimal digits) would
  break the certified-optimum parity with the reference.
* The hand-written SpMM kernels (``core/spmm.py``; ``csrc/spmm_sym.cu``,
  ``csrc/spmm_tile.cu``, ``csrc/spmm_grouped.cu``) accumulate in the
  working type with plain FMA: no TF32, no bf16.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float64

from dcora_tpu_torch.types import (  # noqa: E402
    GraphType,
    ROptParameters,
    StateType,
)

__version__ = "0.1.0"

__all__ = ["DTYPE", "GraphType", "ROptParameters", "StateType"]
