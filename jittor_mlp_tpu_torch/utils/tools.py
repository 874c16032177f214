"""Shape helpers (counterpart of ``jittor_mlp_tpu/utils/tools.py``)."""


def pair(t):
    return t if isinstance(t, (tuple, list)) else (t, t)


def check_sizes(image_size, patch_size):
    ih, iw = pair(image_size)
    ph, pw = pair(patch_size)
    if ih % ph or iw % pw:
        raise ValueError("image size must be divisible by patch size")
    return (ih // ph) * (iw // pw)
