"""The serving-path kernels as registered ``torch.library`` ops.

Each op ``jittor_mlp_tpu_torch::<name>`` has three implementations:

- CUDA: the wrapper's ctypes launch of the hand-written kernel, which counts
  the module's ``LAUNCHES``;
- CPU: the kernel's plain twin, taken only for a CPU tensor;
- fake: the output's shape and dtype alone, so that ``torch.export`` (and
  any tracer with fake tensors) records the call as one node of the graph
  instead of running a ctypes launch on ``data_ptr``s it does not have.

A CUDA tensor that reaches an op launches the kernel or raises; there is no
fallback. The ops are registered when their module is imported (nothing is
built then); an exported program that holds them loads once this package is
imported. The Python wrappers (``fused_mixer_block`` …) check their
arguments and call the op through ``torch.ops``.
"""

from __future__ import annotations

import torch

NAMESPACE = "jittor_mlp_tpu_torch"


def register(name, args, cuda, cpu):
    """Define op ``NAMESPACE::name`` with the arguments ``args`` (schema
    fragments such as ``"Tensor x"`` or ``"int axis"``), returning one
    Tensor shaped and typed like its first argument; ``cuda`` and ``cpu``
    are its implementations. Returns the op's overload packet,
    ``torch.ops.<NAMESPACE>.<name>``."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cuda, mutates_args=(),
                                 device_types="cuda", schema=f"({', '.join(args)}) -> Tensor")
    op.register_kernel("cpu")(cpu)
    op.register_fake(lambda x, *rest: torch.empty_like(x))
    return getattr(getattr(torch.ops, NAMESPACE), name)


def tensor_args(names):
    """Schema fragments for the Tensor arguments ``names``."""
    return [f"Tensor {n}" for n in names]
