from ..core.init import trunc_normal
from .tools import check_sizes, pair, sized_kwargs


def trunc_normal_(shape, mean=0.0, std=1.0, a=-2.0, b=2.0, seed=0):
    """A fresh truncated-normal float32 array of ``shape`` (the JAX
    ``utils.trunc_normal_``, bit for bit): ``trunc_normal`` from
    ``numpy.random.default_rng(seed)``."""
    import numpy as np

    return trunc_normal(np.random.default_rng(seed), shape, mean, std, a, b)


__all__ = ["check_sizes", "pair", "sized_kwargs", "trunc_normal", "trunc_normal_"]
