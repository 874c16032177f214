"""Training helpers of the port (counterpart of ``jittor_mlp_tpu/parallel``).

Only the single-card train step is ported so far; the mesh, pipeline,
sequence-parallel and sharding helpers are not.
"""

from .train import cast_floating, cross_entropy_loss, loss_fn, make_train_step

__all__ = ["cast_floating", "cross_entropy_loss", "loss_fn", "make_train_step"]
