"""Tensor parallelism in one process: the placement on every factory of the
parallel cases, and the Mixer's split channel MLP summed over its slices
against the whole block (the port's twins and the JAX ``_plain_block``).
The collectives run in ``test_torch_parallel_dist.py``'s gloo worlds, and
the split kernel on the card (chip_smoke.py phase 14)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch_parallel_cases import ALL_CASES, build

import jittor_mlp_tpu.ops.pallas.mixer_block as jmb
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb
from jittor_mlp_tpu_torch.parallel import tensor
from jittor_mlp_tpu_torch.parallel import train as ptrain

PORT = "jittor_mlp_tpu_torch"
B, N, D, TD, CD = 3, 20, 32, 24, 64
WC1, BC1, WC2 = 8, 9, 10  # the split weights' positions among the block's twelve


class _Mesh:
    """The mesh surface the placement reads: dim names, the rank grid and
    this rank's coordinate (no process group: the placement runs none)."""

    def __init__(self, n, mp, rank):
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.arange(n).reshape(n // mp, mp)
        self.rank = rank

    def get_coordinate(self):
        return [self.rank // self.mesh.shape[1], self.rank % self.mesh.shape[1]]


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_placement_keeps_each_rank_its_slice(name):
    """``place_model`` at ``min_dim=8`` on a 'model' axis of 2: on each rank,
    every tensor that ``shard_params`` puts on 'model' is exactly its
    chunk of the whole tensor along the spec's axis (half the elements),
    every other tensor is whole, and the model records the specs and the
    whole shapes. The Mixer names its channel MLPs' W1, b1 and W2 as split."""
    whole = build(PORT, name).state_dict()
    for rank in (0, 1):
        model = build(PORT, name)
        specs = ptrain.place_model(model, _Mesh(4, 2, rank), min_dim=8)
        placed = {k: s for k, s in specs.items() if "model" in s}
        assert placed and model.tp_specs == placed
        local = model.state_dict()
        for k, w in whole.items():
            if k in placed:
                axis = placed[k].index("model")
                assert model.tp_shapes[k] == tuple(w.shape)
                assert local[k].numel() * 2 == w.numel(), k
                assert torch.equal(local[k], w.chunk(2, axis)[rank]), k
            else:
                assert torch.equal(local[k], w), k
        if ALL_CASES[name][0] == "MLPMixerForImageClassification":
            depth = ALL_CASES[name][1]["depth"]
            assert len(model.tp_split) == 3 * depth
            assert all(".1.fn.net." in k for k in model.tp_split)
        else:
            assert not model.tp_split


def test_placement_cuts_the_optimizer_state():
    """AdamW moments of a placed parameter (a resumed run's) are cut like it;
    a placed model is left as it is by a second placement alike, and a
    second placement over another model group (a 4 × 1 mesh) or at another
    ``min_dim`` raises ValueError."""
    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters())
    name = "model.0.1.fn.net.0.weight"
    p = model.state_dict(keep_vars=True)[name]
    moment = torch.arange(p.numel(), dtype=torch.float32).reshape(p.shape)
    opt.state[p] = {"step": torch.tensor(3.0), "exp_avg": moment.clone(),
                    "exp_avg_sq": moment.clone()}
    mesh = _Mesh(2, 2, 1)
    ptrain.place_model(model, mesh, min_dim=8, optimizer=opt)
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(opt.state[p][k], moment.chunk(2, 0)[1])
    assert float(opt.state[p]["step"]) == 3.0
    before = p.detach().clone()
    ptrain.place_model(model, mesh, min_dim=8, optimizer=opt)
    assert torch.equal(p, before)
    for other, min_dim in ((_Mesh(4, 1, 1), 8), (mesh, 512)):
        with pytest.raises(ValueError, match="placed over the model group"):
            ptrain.place_model(model, other, min_dim=min_dim)
    assert torch.equal(p, before)


def _inputs(seed=0):
    r = np.random.default_rng(seed)

    def rn(*s, scale=0.1):
        return (r.standard_normal(s) * scale).astype(np.float32)

    x = r.standard_normal((B, N, D)).astype(np.float32)
    return x, (1 + rn(D), rn(D), rn(TD, N, scale=N ** -0.5), rn(TD), rn(N, TD, scale=TD ** -0.5),
               rn(N), 1 + rn(D), rn(D), rn(CD, D, scale=D ** -0.5), rn(CD, scale=0.5),
               rn(D, CD, scale=CD ** -0.5), rn(D, scale=0.5))


def _slices(weights, P):
    """The twelve weights of each of P ranks: Wc1, bc1 cut on the hidden
    axis, Wc2 on its input axis, the rest whole."""
    out = []
    for r in range(P):
        w = list(weights)
        w[WC1], w[BC1] = weights[WC1].chunk(P, 0)[r], weights[BC1].chunk(P, 0)[r]
        w[WC2] = weights[WC2].chunk(P, 1)[r]
        out.append(w)
    return out


def _ulp(v):
    """One bf16 ulp at magnitude ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _rank_order_sum(others):
    """``split_mixer_block``'s ``reduce`` for rank 0 in one process: its
    partial, then the other ranks' ``others`` added in rank order."""
    def reduce(p):
        for q in others:
            p = p + q
        return p
    return reduce


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_block_sums_to_the_whole_block(P, dtype):
    """The Mixer block with its channel MLP in P slices
    (``tensor.split_mixer_block`` on rank 0's, the partials summed in rank
    order), against the whole block: the plain split
    (``mixer_block_plain_partial`` / ``_finish``) against
    ``mixer_block_plain`` and the kernel's twins (the ops
    ``fused_mixer_block_partial`` and ``mixer_block_tp_finish`` on the CPU)
    against ``mixer_block_ref``: float32 within 1e-5 of max(1, max|out|),
    bf16 within one bf16 ulp of max|out| (only the f32 sum's order
    changes). In float32 the plain split is also held to the JAX
    ``_plain_block`` within 1e-4."""
    x, weights = _inputs()
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), [torch.from_numpy(w).to(tdt) for w in weights]
    pairs = {"plain": (tmb.mixer_block_plain_partial, tmb.mixer_block_plain),
             "twin": (tmb.PARTIAL_OP, tmb.mixer_block_ref)}
    for tag, (partial, whole) in pairs.items():
        slices = _slices(wt, P)
        others = [partial(xt, *w[:-1])[1] for w in slices[1:]]
        got = tensor.split_mixer_block(xt, slices[0], _rank_order_sum(others),
                                       plain=tag == "plain").float().numpy()
        want = whole(xt, *wt).float().numpy()
        scale = np.abs(want).max()
        lim = 1e-5 * max(1.0, scale) if dtype == "float32" else _ulp(scale)
        assert np.abs(got - want).max() <= lim, (tag, np.abs(got - want).max(), lim)
        if dtype == "float32" and tag == "plain":
            jax_out = np.asarray(jmb._plain_block(jnp.asarray(x), *map(jnp.asarray, weights)))
            assert np.abs(got - jax_out).max() <= 1e-4 * max(1.0, np.abs(jax_out).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_block_with_one_rank_is_the_block(dtype):
    """With no group (one rank, the whole hidden axis) the split wrappers
    are the whole block: ``fused_mixer_block_tp`` equals the twin
    ``mixer_block_ref`` and ``mixer_block_plain_tp`` equals
    ``mixer_block_plain``, bit for bit in bf16, and the trainable form's
    gradients are the plain split block's for one upstream gradient."""
    x, weights = _inputs(1)
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), [torch.from_numpy(w).to(tdt) for w in weights]
    tol = 0 if dtype == "bfloat16" else 1e-5
    assert (tensor.fused_mixer_block_tp(xt, *wt) - tmb.mixer_block_ref(xt, *wt)).abs().max() <= tol
    assert (tensor.mixer_block_plain_tp(xt, *wt) - tmb.mixer_block_plain(xt, *wt)).abs().max() <= tol
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape)).to(tdt)
    inputs = [t.clone().requires_grad_() for t in (xt, *wt)]
    got = torch.autograd.grad(tensor.fused_mixer_block_tp_trainable(*inputs), inputs, g)
    want = torch.autograd.grad(tensor.mixer_block_plain_tp(*inputs), inputs, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_split_ops_trace_with_fake_tensors():
    """The two ops' fake implementations: the partial is (h like x, an f32
    tensor of x's shape), the finish like h; the partial's flop formula
    counts its products at this rank's hidden width."""
    x, weights = _inputs()
    wt = [w.bfloat16() for w in _slices([torch.from_numpy(w) for w in weights], 2)[0]]
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(torch.from_numpy(x).bfloat16())
        fw = [mode.from_tensor(w) for w in wt]
        h, p = tmb.PARTIAL_OP(fx, *fw[:-1])
        out = tmb.FINISH_OP(h, p, fw[-1])
    assert (h.shape, h.dtype, p.shape, p.dtype) == (fx.shape, torch.bfloat16, fx.shape,
                                                    torch.float32)
    assert out.shape == fx.shape and out.dtype == torch.bfloat16
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        tmb.PARTIAL_OP(torch.from_numpy(x).bfloat16(), *wt[:-1])
    assert counter.get_total_flops() == 4 * B * N * D * (TD + CD // 2)


def test_a_model_not_placed_has_nothing_to_gather():
    """The rule's base case: a model that was not placed passes its tensors
    through ``boundary`` as they are, and its scope is empty."""
    model = build(PORT, "mixer")
    tensors = dict(model.named_parameters())
    got, scope = tensor.boundary(model, tensors, torch.zeros(1, 3, 16, 16))
    assert got is tensors
    with scope:
        assert tensor.tensor_parallel_group() is None
