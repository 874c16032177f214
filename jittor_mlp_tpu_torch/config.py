"""Global numeric configuration of the PyTorch port.

Counterpart of ``jittor_mlp_tpu/config.py``:

- ``compute_dtype``: the activation dtype ``Model.__call__`` casts its input
  to. ``torch.bfloat16`` selects the serving path whose Mixer blocks run in
  the hand-written CUDA kernel (ops/kernels/mixer_block.py).
- ``parity_mode()``: float32 activations and full-precision float32 matmuls.
  On CUDA, float32 products may otherwise run in TF32 (cuDNN convolutions
  do by default), which keeps about three decimal digits; the context turns
  TF32 off for both matmuls and cuDNN and restores the previous settings on
  exit.
- ``bf16_mode()``: bfloat16 activations.
"""

from contextlib import contextmanager

import torch

compute_dtype = torch.float32


@contextmanager
def parity_mode():
    """float32 activations, TF32 off: for comparison against a reference."""
    global compute_dtype
    old = (compute_dtype, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    compute_dtype = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (compute_dtype, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextmanager
def bf16_mode():
    """bfloat16 activations (the serving path)."""
    global compute_dtype
    old = compute_dtype
    compute_dtype = torch.bfloat16
    try:
        yield
    finally:
        compute_dtype = old
