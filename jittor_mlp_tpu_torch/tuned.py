"""Measured best-known train/serve settings per zoo model, for the port.

The tables start empty: the JAX package's rows (``jittor_mlp_tpu/tuned.py``)
were measured on another accelerator and do not carry over. A row is added
only from a measurement of the port on its own card. With ``SERVE`` empty,
``Predictor`` serves every model in bf16 by default.

``train_settings(name)`` / ``serve_settings(name)`` resolve either a sweep
key ("mlp_mixer") or a factory name ("MLPMixerForImageClassification") and
return None for a model without a row.
"""

TRAIN: dict = {}
SERVE: dict = {}


def train_settings(name):
    """Best-known train settings for ``name`` (keys ``factory, remat,
    batch, img_s``), or None."""
    by_factory = {rec["factory"]: rec for rec in TRAIN.values()}
    return TRAIN.get(name) or by_factory.get(name)


def serve_settings(name):
    """Serving recommendation for ``name`` (``dtype`` "bf16"/"int8"/"f32"
    plus the measurements behind it), or None."""
    by_factory = {rec["factory"]: rec for rec in SERVE.values()}
    return SERVE.get(name) or by_factory.get(name)
