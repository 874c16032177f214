"""Base module with the surface of ``jittor_mlp_tpu.core.model.Model``.

A zoo model is an ``nn.Module`` whose ``state_dict`` names are the torch
reference's; the factories build it on the card by default (``place``).
``Model`` adds what the JAX facade offers on top: torch
state-dict import/export by those names, ``to_bf16``, ``param_count``,
``flops`` and a
``__call__`` that also takes a numpy NCHW batch and casts it to
``config.compute_dtype`` (as the JAX ``Model.__call__`` does).

Drop-path: a submodule with a float attribute ``drop_path_rate`` (its
rate, the JAX model's ``_dpr`` leaf or setting) owns ``drop_paths``
residual branches that stochastic depth may drop (1 unless the class says
otherwise). A model with such modules sets ``stochastic = True``, takes
``forward(x, generator=None)`` and draws every mask up front with
``drop_path_masks``, so that a checkpointed block recomputes with the
masks of its forward. Under ``nnf.sample_window_scope`` the masks cover
the window's global batch, and ``nnf.drop_path`` gives each row the bit of
its global row index: a data-parallel or microbatched forward drops the
samples that the dense forward drops with the same generator seed.

Parallel execution: a factory's ``block_runner=`` sets ``block_runner``,
which the model passes to each of its ``nnf.run_blocks`` stacks;
``shard(mesh)`` makes ``__call__`` a data-parallel forward over the mesh.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import config
from . import nnf


def place(module, device):
    """Move ``module`` to ``device``. The factories call this with their
    ``device`` argument ("cuda" unless the caller asks for the CPU); a CUDA
    device with no card raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{type(module).__name__}: device {str(device)!r} asked for, but "
            f"torch.cuda.is_available() is false; pass device='cpu' to "
            f"build the model on the CPU")
    return module.to(device)


class Model(nn.Module):
    name = None  # zoo key, e.g. "mlp_mixer" (tuned.serve_settings looks it up)
    stochastic = False  # True: the train forward takes a drop-path `generator`
    block_runner = None  # fn(fn, blocks, x) running this model's block stacks

    def __init__(self):
        super().__init__()
        self.init_sd = None  # flat torch-name → numpy array, from SDBuilder
        self.mesh = None  # set by shard()

    def _load_init(self, sd):
        """Take the SDBuilder state dict as this module's parameters. The
        submodules were built on the meta device, so this is their only
        initialization (no torch RNG is drawn). Each BatchNorm's
        ``num_batches_tracked``, which SDBuilder does not draw, is int64 0,
        as the JAX export writes it."""
        self.init_sd = sd
        tensors = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
        for k in self.state_dict(keep_vars=True):
            if k.endswith(".num_batches_tracked"):
                tensors[k] = torch.zeros((), dtype=torch.int64)
        self.load_state_dict(tensors, strict=True, assign=True)

    def place(self, device):
        """Move the model to ``device`` (``place``)."""
        return place(self, device)

    def with_runner(self, runner):
        """Install ``runner`` as this model's ``block_runner`` (None: the
        block loop, or ``nnf.block_runner_scope``'s); returns the model."""
        self.block_runner = runner
        return self

    @property
    def device(self):
        return next(self.parameters()).device

    def drop_path_masks(self, x, generator):
        """module → a tuple of its ``drop_paths`` per-sample keep masks
        (``nnf.drop_path_mask``), drawn from ``generator`` in module order
        for each module whose ``drop_path_rate`` is above 0; empty in eval
        or without a generator. ``x``: the activation, for its batch and
        device. Under a sample window each mask has a bit for every row of
        the window's global batch, so that each rank or microbatch draws
        the same bits and its rows take their own (``nnf.window_rows``)."""
        if not self.training or generator is None:
            return {}
        win = nnf.sample_window()
        n = x.shape[0] if win is None else win[0]
        return {m: tuple(nnf.drop_path_mask(n, m.drop_path_rate, generator, x.device)
                         for _ in range(getattr(m, "drop_paths", 1)))
                for m in self.modules() if getattr(m, "drop_path_rate", 0) > 0}

    # -- torch-compat surface -------------------------------------------------

    def load_torch_state_dict(self, state_dict):
        """Import a torch ``state_dict`` (tensors or ndarrays), strictly."""
        ref = self.state_dict()
        sd = {}
        for k, v in state_dict.items():
            t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            sd[k] = t.to(ref[k].device, ref[k].dtype) if k in ref else t
        self.load_state_dict(sd, strict=True)
        return self

    def export_torch_state_dict(self, tensors=True):
        """The parameters as a torch ``state_dict`` on the CPU; numpy arrays
        with ``tensors=False`` (float32, and int64 for ``num_batches_tracked``)."""
        sd = {k: v.detach().cpu() for k, v in self.state_dict().items()}
        if not tensors:
            sd = {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in sd.items()}
        return sd

    def to_bf16(self):
        return self.to(torch.bfloat16)

    def shard(self, mesh, min_dim=512):
        """Distribute the model over a ('data', 'model') mesh (the JAX
        ``Model.shard``): ``__call__`` then takes the global batch, runs this
        rank's rows of the data split (under their sample window and the
        data group's BatchNorm statistics) and all-gathers the logits over
        the data group, so every rank returns the global batch's. A 'model'
        axis replicates the model; where the JAX heuristic
        (``parallel.train.shard_params`` at ``min_dim``) would shard a
        tensor over a 'model' axis larger than 1, NotImplementedError
        names the tensors (tensor parallelism is not ported). The model
        must be on the mesh's device type."""
        from ..parallel.train import check_replicated
        from ..parallel.mesh import check_device

        check_device(mesh, self.device)
        check_replicated(self, mesh, min_dim)
        self.mesh = mesh
        return self

    def param_count(self):
        return sum(p.numel() for p in self.parameters())

    def flops(self, input_shape=(1, 3, 224, 224)):
        """Forward FLOPs of one eval forward on zeros of ``input_shape``,
        counted by ``torch.utils.flop_counter.FlopCounterMode`` on the
        model's device, in the model's dtype (the JAX ``Model.flops``).

        The counter counts products and convolutions, 2·M·N·K each; a
        block kernel's op counts its plain twin's products (its flop
        formula, ``ops/kernels/_op.register``), so the count after
        ``to_bf16()``, or on the card, equals the f32 forward's. XLA's
        ``cost_analysis``, which the JAX package reads, also counts
        elementwise work and GFNet's DFT products: the port's count is
        0.6–0.8 of JAX's on small Mixers. FFTs (GFNet) count 0, and so
        does cuDNN's LSTM (Sequencer2D on the card; the CPU's LSTM counts
        its products)."""
        from torch.utils.flop_counter import FlopCounterMode

        dtype = next(p.dtype for p in self.parameters() if p.is_floating_point())
        x = torch.zeros(input_shape, dtype=dtype, device=self.device)
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad(), FlopCounterMode(display=False) as counter:
                self.forward(x)
        finally:
            self.train(was_training)
        return float(counter.get_total_flops())

    # -- forward --------------------------------------------------------------

    def __call__(self, x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device, config.compute_dtype)
        if self.mesh is None:
            return super().__call__(x, *args, **kwargs)
        from ..parallel import _comm
        from ..parallel.mesh import axis_group
        from ..parallel.multihost import process_batch_offset, process_batch_size
        from ..parallel.train import data_parallel

        b = process_batch_size(self.mesh, x.shape[0])
        off = process_batch_offset(self.mesh, x.shape[0])
        with data_parallel(self.mesh, b):
            y = super().__call__(x[off:off + b], *args, **kwargs)
        return _comm.all_gather(y, axis_group(self.mesh, "data"))
