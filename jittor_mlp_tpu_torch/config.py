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
- ``int8_mode()``: dynamic W8A8 int8 inference for the calling thread. The
  JAX package reads its global ``int8_matmul`` flag once, at trace time; an
  eager forward reads it at every dense op, so a process-global flag would
  let one serving thread switch int8 off while another thread's forward is
  half done. The flag is therefore thread-local: ``int8_enabled()`` reads
  it, ``int8_mode()`` sets it for the calling thread only.
- ``pallas_bwd``: in bf16 training, False (the default, as in the JAX
  package) runs each Mixer block as the forward kernel with the autograd
  of the plain block as its backward (the recompute route); True runs the
  kernel route, ``ops.kernels.mixer_block_bwd.fused_mixer_block_train``,
  whose backward is three kernels. The name is the JAX package's.
- ``remat_mode()``: activation checkpointing of every block
  (``torch.utils.checkpoint``, non-reentrant), the counterpart of the JAX
  ``remat_mode`` and ``nnf.scan_blocks``'s ``jax.checkpoint``: the forward
  keeps only each block's input, and the backward runs each block's
  forward again. It is read at every forward, so it takes effect on the
  next step.
"""

import threading
from contextlib import contextmanager

import torch

compute_dtype = torch.float32
pallas_bwd = False  # bf16 training: the Mixer block's kernel route
remat = False  # checkpoint every block (set by remat_mode())
_local = threading.local()


def int8_enabled():
    """True inside ``int8_mode()`` on the calling thread."""
    return getattr(_local, "int8", False)


@contextmanager
def int8_mode():
    """Dynamic W8A8 int8 inference on every dense op, for this thread.

    Inside the context, ``nnf.linear`` / ``conv1d_token`` / ``patch_embed``
    quantize activations per token and weights per output channel and
    contract int8 values exactly (``quant.dynamic_int8_matmul``), and in
    bf16 eval the Mixer / ResMLP / gMLP blocks run their W8A8 kernels. Eval
    only."""
    old = int8_enabled()
    _local.int8 = True
    try:
        yield
    finally:
        _local.int8 = old


@contextmanager
def remat_mode():
    """Checkpoint every block of every model: activations are recomputed in
    the backward instead of kept (training memory)."""
    global remat
    old = remat
    remat = True
    try:
        yield
    finally:
        remat = old


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
