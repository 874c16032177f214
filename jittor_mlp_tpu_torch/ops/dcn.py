"""DCNv2's module surface in PyTorch (counterpart of ``jittor_mlp_tpu/ops/dcn.py``):
the deformable convolution and deformable PSROI pooling on NCHW tensors.

- ``dcn_v2_conv`` and the torchvision-signature ``deform_conv2d_jt`` run
  ``ops/deform.deform_conv2d`` (four row gathers a tap, float32 sampling
  positions, one grouped product) on the NHWC view. The offsets are
  (B, 2·G·kh·kw, Ho, Wo), (Δy, Δx) interleaved per group and tap, the
  mask (B, G·kh·kw, Ho, Wo).
- ``dcn_v2_pooling``: deformable position-sensitive RoI pooling, the JAX
  function's arithmetic over (RoI, output channel, bin row, bin column,
  sample row, sample column) in float32 positions; returns (out,
  top_count), the count of samples inside the map in each bin.
- Modules with the reference's parameter names: ``DeformConv`` (``weight``,
  ``bias``; offsets given, mask ones), ``DCNv2`` (offsets and mask
  given), ``DCN`` (registered in ``HEADS``; ``conv_offset_mask`` predicts
  the offsets and the sigmoid mask), ``DCNv2Pooling`` (trans given) and
  ``DCNPooling`` (``offset_mask_fc``: Linears at indices 0, 2 and 4 with
  ReLUs between, predicting trans and the mask from a first pooling
  without trans). Their seeded initial weights are the JAX objects'.
  Each builds on the card unless the caller passes ``device="cpu"``.
  ``load_torch_state_dict`` takes a reference state dict (tensors or
  arrays; DeformConv's ``bias`` may be absent), ``from_jax`` the arrays of
  the JAX object.

None of these reaches a kernel of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core import nnf
from ..core.model import place
from .deform import deform_conv2d as _deform_conv2d_nhwc


class Registry:
    """A name → class registry (the reference's ``Registry``)."""

    def __init__(self, name):
        self.name = name
        self._modules = {}

    def register_module(self, cls=None):
        def _register(c):
            self._modules[c.__name__] = c
            return c

        return _register(cls) if cls is not None else _register

    def get(self, name):
        return self._modules[name]


HEADS = Registry("heads")


def dcn_v2_conv(x, offset, mask, weight, bias, stride=1, padding=0, dilation=1,
                deformable_groups=1):
    """The deformable convolution on NCHW tensors; the offset groups are
    read from the offsets' channels (``deformable_groups`` is accepted, as
    in the JAX function)."""
    out = _deform_conv2d_nhwc(
        x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1), weight, bias, stride=stride,
        padding=padding, dilation=dilation,
        mask=None if mask is None else mask.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


def deform_conv2d_jt(input, offset, weight, bias=None, stride=(1, 1), padding=(0, 0),
                     dilation=(1, 1), mask=None):
    """torchvision's ``deform_conv2d`` signature: NCHW tensors, interleaved
    offsets, an optional modulation mask."""
    return dcn_v2_conv(input, offset, mask, weight, bias, stride, padding, dilation)


def dcn_v2_pooling(input, rois, trans, spatial_scale, pooled_size, output_dim, no_trans,
                   group_size=1, part_size=None, sample_per_part=4, trans_std=0.0):
    """Deformable PSROI pooling. input: (B, C, H, W); rois: (R, 5) [batch
    index, x1, y1, x2, y2] in image pixels; trans: (R, 2·classes, part,
    part), unused with ``no_trans``. Returns (out, top_count), each (R,
    output_dim, pooled, pooled), in input's dtype; positions, bilinear
    weights and sums are float32."""
    B, C, H, W = input.shape
    dev = input.device
    R, P = rois.shape[0], pooled_size
    S = sample_per_part
    part_size = part_size or pooled_size
    n_cls = 1 if no_trans else trans.shape[1] // 2
    class_id = torch.arange(output_dim, device=dev) // (output_dim // n_cls)

    rois = rois.float()
    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp_min(x2 - x1, 0.1)
    roi_h = torch.clamp_min(y2 - y1, 0.1)
    bin_w, bin_h = roi_w / P, roi_h / P
    sub_w, sub_h = bin_w / S, bin_h / S

    p = torch.arange(P, device=dev)
    part = torch.floor(p / P * part_size).long()
    grp = torch.clamp(torch.floor(p * group_size / P), 0, group_size - 1).long()

    def per_roi(v):  # (R,) → (R, 1, 1, 1)
        return v.reshape(R, 1, 1, 1)

    if no_trans:
        tx = ty = torch.zeros(R, 1, P, P, device=dev)
    else:  # per class: trans[r, class, 0 / 1, part(bin row), part(bin column)]
        t = trans.float().reshape(R, n_cls, 2, part_size, part_size)[:, :, :, part][..., part]
        tx, ty = t[:, :, 0] * trans_std, t[:, :, 1] * trans_std
    wstart = p.reshape(1, 1, 1, P) * per_roi(bin_w) + per_roi(x1)
    wstart = wstart + tx * per_roi(roi_w)  # (R, classes, P, P)
    hstart = p.reshape(1, 1, P, 1) * per_roi(bin_h) + per_roi(y1)
    hstart = hstart + ty * per_roi(roi_h)
    s = torch.arange(S, device=dev)
    # samples (R, classes, P, P, S rows, S columns)
    w_s = wstart[..., None, None] + s.reshape(1, S) * sub_w.reshape(R, 1, 1, 1, 1, 1)
    h_s = hstart[..., None, None] + (s * 1.0).reshape(S, 1) * sub_h.reshape(R, 1, 1, 1, 1, 1)
    valid = (w_s >= -0.5) & (w_s <= W - 0.5) & (h_s >= -0.5) & (h_s <= H - 0.5)
    w_c = torch.clamp(w_s, 0.0, W - 1.0)
    h_c = torch.clamp(h_s, 0.0, H - 1.0)
    x0, y0 = torch.floor(w_c), torch.floor(h_c)
    dx, dy = w_c - x0, h_c - y0
    x0, y0, x1i, y1i = (v.long() for v in (x0, y0, torch.ceil(w_c), torch.ceil(h_c)))

    # channel of (output channel, bin row, bin column); rows of the flat map
    ctop = torch.arange(output_dim, device=dev)
    chan = (ctop.reshape(-1, 1, 1) * group_size + grp.reshape(1, P, 1)) * group_size \
        + grp.reshape(1, 1, P)
    plane = (batch_idx.reshape(R, 1, 1, 1) * C + chan) * (H * W)  # (R, O, P, P)
    flat = input.reshape(-1)

    def g(yy, xx):  # (R, classes, P, P, S, S) positions → (R, O, P, P, S, S) values
        pix = (yy * W + xx)[:, class_id]
        return flat[plane[..., None, None] + pix].float()

    val = ((1 - dx) * (1 - dy))[:, class_id] * g(y0, x0) \
        + ((1 - dx) * dy)[:, class_id] * g(y1i, x0) \
        + (dx * (1 - dy))[:, class_id] * g(y0, x1i) \
        + (dx * dy)[:, class_id] * g(y1i, x1i)
    valid = valid[:, class_id]
    cnt = valid.sum((-1, -2)).float()
    total = torch.where(valid, val, 0.0).sum((-1, -2))
    out = torch.where(cnt > 0, total / torch.clamp_min(cnt, 1), 0.0)
    return out.to(input.dtype), cnt.to(input.dtype)


def state_dict_of_jax(obj):
    """The torch state dict of a JAX ``ops.dcn`` object, from its arrays:
    ``weight`` and ``bias``, DCN's ``conv_offset_mask`` dict, DCNPooling's
    ``offset_mask_fc`` list (indices 0, 2, 4)."""
    sd = {k: np.asarray(getattr(obj, k)) for k in ("weight", "bias") if hasattr(obj, k)}
    for k, v in getattr(obj, "conv_offset_mask", {}).items():
        sd[f"conv_offset_mask.{k}"] = np.asarray(v)
    for i, lin in zip((0, 2, 4), getattr(obj, "offset_mask_fc", ())):
        for k, v in lin.items():
            sd[f"offset_mask_fc.{i}.{k}"] = np.asarray(v)
    return sd


class _Loadable(nn.Module):
    _optional = ()  # keys a reference state dict may leave out

    def load_torch_state_dict(self, state_dict):
        """Import a reference state dict (tensors or arrays) by name."""
        own = self.state_dict()
        extra = set(state_dict) - set(own)
        missing = set(own) - set(state_dict) - set(self._optional)
        if extra or missing:
            raise KeyError(f"{type(self).__name__}: unexpected keys {sorted(extra)}, "
                           f"missing {sorted(missing)}")
        self.load_state_dict({k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v)) for k, v in state_dict.items()}, strict=False)
        return self

    def from_jax(self, obj):
        """Take the arrays of the JAX object ``obj`` of the same class."""
        return self.load_torch_state_dict(state_dict_of_jax(obj))


class DeformConv(_Loadable):
    """Deformable conv with offsets given (mask ones)."""

    _optional = ("bias",)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, deformable_groups=1, bias=False, seed=0, device="cuda"):
        super().__init__()
        self.kernel_size = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups = deformable_groups
        stdv = 1.0 / math.sqrt(in_channels * self.kernel_size[0] * self.kernel_size[1])
        w = np.random.default_rng(seed).uniform(
            -stdv, stdv, (out_channels, in_channels, *self.kernel_size))
        self.weight = nn.Parameter(torch.from_numpy(w.astype(np.float32)))
        self.bias = nn.Parameter(torch.zeros(out_channels))  # as the JAX object, also for bias=False
        place(self, device)

    def _conv(self, x, offset, mask):
        return dcn_v2_conv(x, offset, mask, self.weight, self.bias, self.stride, self.padding,
                           self.dilation, self.deformable_groups)

    def forward(self, x, offset):
        return self._conv(x, offset, None)


class DCNv2(DeformConv):
    """Modulated deformable conv, offsets and mask given."""

    _optional = ()

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, dilation=1,
                 deformable_groups=1, seed=0, device="cuda"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         deformable_groups, bias=True, seed=seed, device=device)

    def forward(self, x, offset, mask):
        return self._conv(x, offset, mask)


@HEADS.register_module()
class DCN(DCNv2):
    """Modulated deformable conv whose offsets and mask come from an inner
    conv, ``conv_offset_mask`` (zeros at first): its output split in three
    along the channels, the first two the offsets, the sigmoid of the third
    the mask."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, dilation=1,
                 deformable_groups=1, seed=0, device="cuda"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         deformable_groups, seed=seed, device=device)
        ch = deformable_groups * 3 * self.kernel_size[0] * self.kernel_size[1]
        self.conv_offset_mask = nn.Conv2d(in_channels, ch, self.kernel_size, stride, padding,
                                          device=self.weight.device)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x):
        com = self.conv_offset_mask
        om = nnf.conv2d(x.permute(0, 2, 3, 1), com.weight, com.bias, stride=self.stride,
                        padding=self.padding).permute(0, 3, 1, 2)
        o1, o2, mask = torch.chunk(om, 3, dim=1)
        return self._conv(x, torch.cat([o1, o2], 1), torch.sigmoid(mask))


class DCNv2Pooling(_Loadable):
    """Deformable PSROI pooling with trans given (zeros when None)."""

    def __init__(self, spatial_scale, pooled_size, output_dim, no_trans, group_size=1,
                 part_size=None, sample_per_part=4, trans_std=0.0, device="cuda"):
        super().__init__()
        self.spatial_scale = spatial_scale
        self.pooled_size = pooled_size
        self.output_dim = output_dim
        self.no_trans = no_trans
        self.group_size = group_size
        self.part_size = part_size or pooled_size
        self.sample_per_part = sample_per_part
        self.trans_std = trans_std
        place(self, device)

    def _pool(self, input, rois, trans, no_trans):
        return dcn_v2_pooling(input, rois, trans, self.spatial_scale, self.pooled_size,
                              self.output_dim, no_trans, self.group_size, self.part_size,
                              self.sample_per_part, self.trans_std)[0]

    def forward(self, input, rois, trans=None):
        if trans is None:
            trans = torch.zeros(rois.shape[0], 2, self.part_size, self.part_size,
                                device=input.device)
        return self._pool(input, rois, trans, self.no_trans)


class DCNPooling(DCNv2Pooling):
    """Deformable PSROI pooling that predicts its own trans and modulation
    mask from a first pooling without trans (``offset_mask_fc``; its last
    Linear zeros at first: trans 0, mask 0.5)."""

    def __init__(self, spatial_scale, pooled_size, output_dim, no_trans, group_size=1,
                 part_size=None, sample_per_part=4, trans_std=0.0, deform_fc_dim=1024, seed=0,
                 device="cuda"):
        super().__init__(spatial_scale, pooled_size, output_dim, no_trans, group_size,
                         part_size, sample_per_part, trans_std, device="cpu")
        self.deform_fc_dim = deform_fc_dim
        if not no_trans:
            rng = np.random.default_rng(seed)
            dims = [(pooled_size * pooled_size * output_dim, deform_fc_dim),
                    (deform_fc_dim, deform_fc_dim),
                    (deform_fc_dim, pooled_size * pooled_size * 3)]
            layers = []
            for n, (i, o) in enumerate(dims):
                lin = nn.Linear(i, o)
                bound = 1.0 / math.sqrt(i)
                with torch.no_grad():  # the JAX object's draws: weight, then bias
                    for t in (lin.weight, lin.bias):
                        t.copy_(torch.zeros(t.shape) if n == 2 else torch.from_numpy(
                            rng.uniform(-bound, bound, tuple(t.shape)).astype(np.float32)))
                layers += [lin, nn.ReLU()] if n < 2 else [lin]
            self.offset_mask_fc = nn.Sequential(*layers)
        place(self, device)

    def forward(self, input, rois):
        P = self.pooled_size
        n = rois.shape[0]
        zeros = torch.zeros(n, 2, self.part_size, self.part_size, device=input.device)
        roi = self._pool(input, rois, zeros, True)
        if self.no_trans:
            return roi
        fc = self.offset_mask_fc
        h = torch.relu(nnf.linear(roi.reshape(n, -1), fc[0].weight, fc[0].bias))
        h = torch.relu(nnf.linear(h, fc[2].weight, fc[2].bias))
        om = nnf.linear(h, fc[4].weight, fc[4].bias).reshape(n, 3, P, P)
        out = self._pool(input, rois, om[:, :2], False)
        return out * torch.sigmoid(om[:, 2:3])
