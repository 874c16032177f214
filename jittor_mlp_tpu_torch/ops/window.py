"""Window partition and reverse on NHWC tensors (counterpart of
``jittor_mlp_tpu/ops/window.py``), for SwinMLP."""

from __future__ import annotations


def window_partition(x, ws):
    """(B, H, W, C) → (B·nW, ws, ws, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows, ws, H, W):
    """(B·nW, ws, ws, C) → (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H // ws) // (W // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
