"""The parallel layer of the port (counterpart of ``jittor_mlp_tpu/parallel``):
the train step, the ('data', 'model') mesh over ``torch.distributed``,
data-parallel steps, the GPipe and token-parallel block runners, and
multi-process bring-up. Tensor parallelism (a tensor sharded over a
'model' axis larger than 1) is not ported: the placement helpers raise
NotImplementedError where the JAX heuristic would shard.
"""

from . import multihost
from .mesh import make_mesh
from .pipeline import (gather_optimizer_state, gather_state_dict, pipeline_runner,
                       pipeline_shardings)
from .sequence import token_parallel_mixer_runner, token_parallel_runner
from .train import (cast_floating, cross_entropy_loss, init_sharded, loss_fn, make_train_step,
                    shard_params)

# zoo-wide runner installation (nnf.run_blocks consults this scope), for
# families without an explicit block_runner= kwarg
from ..core.nnf import block_runner_scope

__all__ = [
    "multihost",
    "make_mesh",
    "make_train_step",
    "shard_params",
    "cross_entropy_loss",
    "pipeline_runner",
    "pipeline_shardings",
    "token_parallel_mixer_runner",
    "token_parallel_runner",
    "block_runner_scope",
    "cast_floating",
    "gather_optimizer_state",
    "gather_state_dict",
    "init_sharded",
    "loss_fn",
]
