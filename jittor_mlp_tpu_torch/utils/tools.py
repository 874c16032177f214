"""Shape helpers (counterpart of ``jittor_mlp_tpu/utils/tools.py``)."""

import inspect


def pair(t):
    return t if isinstance(t, (tuple, list)) else (t, t)


def check_sizes(image_size, patch_size):
    ih, iw = pair(image_size)
    ph, pw = pair(patch_size)
    if ih % ph or iw % pw:
        raise ValueError("image size must be divisible by patch size")
    return (ih // ph) * (iw // pw)


def sized_kwargs(factory, image_size=None, num_classes=None):
    """kwargs sizing ``factory`` to the requested input and classes, under
    whichever parameter names it accepts (image_size or img_size,
    num_classes or n_classes); a factory that takes no such argument (as
    ConvMixer takes no image size) gets none. The JAX ``sized_kwargs``."""
    accepted = inspect.signature(factory).parameters
    out = {}
    for names, value in ((("image_size", "img_size"), image_size),
                         (("num_classes", "n_classes"), num_classes)):
        if value is not None:
            for k in names:
                if k in accepted:
                    out[k] = value
                    break
    return out
