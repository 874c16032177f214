"""The parallel layer of the port (counterpart of ``jittor_mlp_tpu/parallel``):
the train step, the ('data', 'model') mesh over ``torch.distributed``,
data-parallel steps, tensor parallelism over the 'model' axis (the JAX
placement, executed by ``tensor``: slices gathered at the forward's
boundary, the Mixer's channel MLP split across the ranks), the GPipe and
token-parallel block runners, and multi-process bring-up.
"""

from . import multihost, tensor
from .mesh import make_mesh
from .pipeline import (gather_optimizer_state, gather_state_dict, pipeline_runner,
                       pipeline_shardings)
from .sequence import token_parallel_mixer_runner, token_parallel_runner
from .tensor import gather_tp
from .train import (cast_floating, cross_entropy_loss, init_sharded, loss_fn, make_train_step,
                    place_model, shard_params)

# zoo-wide runner installation (nnf.run_blocks consults this scope), for
# families without an explicit block_runner= kwarg; the split sites' group
from ..core.nnf import block_runner_scope, tensor_parallel_scope

__all__ = [
    "multihost",
    "tensor",
    "make_mesh",
    "make_train_step",
    "shard_params",
    "cross_entropy_loss",
    "pipeline_runner",
    "pipeline_shardings",
    "token_parallel_mixer_runner",
    "token_parallel_runner",
    "block_runner_scope",
    "tensor_parallel_scope",
    "gather_tp",
    "place_model",
    "cast_floating",
    "gather_optimizer_state",
    "gather_state_dict",
    "init_sharded",
    "loss_fn",
]
