"""The plain twin of the channel products' GEMM core against the block it serves.

``gemm_tn_ref`` (ops/kernels/gemm_sm90.py) is the plain version of one
channel product on the Hopper core (csrc/gemm_sm90.cuh): an f32 product,
then ``GeluBias``'s or ``ResidualBias``'s arithmetic and one rounding. Here:

- composed twice (GELU, then residual) it is the channel half of
  ``mixer_block_ref`` bit for bit, in bf16 and float32;
- the whole block built from ``layer_norm_f32`` and ``gemm_tn_ref`` (the
  token products as transposed channel-style products) matches the JAX
  ``fused_mixer_block`` run in Pallas interpret mode on the CPU, on the same
  seeded numpy inputs: float32 within 1e-5, bf16 within two bf16 ulps of
  the output scale (1.6e-2 of max(1, max|want|)), the tolerances of
  tests/test_torch_mixer_block.py;
- the CPU wrapper runs the twin without a launch, and bad inputs raise.

The kernel itself runs only on the card (chip_smoke.py phases 2 and 5).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jittor_mlp_tpu.ops.pallas.mixer_block as jmb
from jittor_mlp_tpu import config as jconfig
from jittor_mlp_tpu_torch.ops.kernels import gemm_sm90 as tg
from jittor_mlp_tpu_torch.ops.kernels import mixer_block as tmb


def _block_inputs(B, N, D, TD, CD, seed=0):
    r = np.random.default_rng(seed)

    def rn(*s):
        return (r.standard_normal(s) * 0.1).astype(np.float32)

    x = r.standard_normal((B, N, D)).astype(np.float32)
    ln1w, ln2w = 1 + rn(D), 1 + rn(D)
    weights = (ln1w, rn(D), rn(TD, N), rn(TD), rn(N, TD), rn(N), ln2w, rn(D),
               rn(CD, D), rn(CD), rn(D, CD), rn(D))
    return x, weights


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _act(dtype):
    return "gelu_erf" if dtype == torch.float32 else "gelu_tanh"


@pytest.mark.parametrize("shape", [(3, 20, 40, 24, 72), (5, 33, 136, 50, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_composes_to_the_channel_half_of_the_block_twin(dtype, shape):
    B, N, D, TD, CD = shape
    dt = getattr(torch, dtype)
    x, weights = _block_inputs(*shape, seed=sum(shape))
    tx, tw = _torch(x, dt), [_torch(w, dt) for w in weights]
    want, h = tmb.mixer_block_ref(tx, *tw, with_h=True)
    ln2w, ln2b, wc1, bc1, wc2, bc2 = tw[6:]
    hn = tmb.layer_norm_f32(h, ln2w, ln2b).to(dt).reshape(B * N, D)
    c = tg.gemm_tn_ref(hn, wc1, bc1, act=_act(dt))
    got = tg.gemm_tn_ref(c, wc2, bc2, residual=h.reshape(B * N, D))
    assert got.dtype == dt and got.shape == (B * N, D)
    assert torch.equal(got.reshape(B, N, D), want)


def _block_from_gemm_ref(x, ln1w, ln1b, wt1, bt1, wt2, bt2, ln2w, ln2b, wc1, bc1, wc2, bc2):
    """The Mixer block from layer_norm_f32 and gemm_tn_ref alone: the token
    products per image transposed, tᵀ = act(xnᵀ · Wt1ᵀ + bt1) and
    hᵀ = xᵀ + (tᵀ · Wt2ᵀ + bt2), over all B·D rows at once."""
    B, N, D = x.shape
    dt, act = x.dtype, _act(x.dtype)
    xn = tmb.layer_norm_f32(x, ln1w, ln1b).to(dt)
    t = tg.gemm_tn_ref(xn.transpose(1, 2).reshape(B * D, N), wt1, bt1, act=act)
    xt = x.transpose(1, 2).reshape(B * D, N)
    h = tg.gemm_tn_ref(t, wt2, bt2, residual=xt).reshape(B, D, N).transpose(1, 2)
    hn = tmb.layer_norm_f32(h, ln2w, ln2b).to(dt).reshape(B * N, D)
    c = tg.gemm_tn_ref(hn, wc1, bc1, act=act)
    return tg.gemm_tn_ref(c, wc2, bc2, residual=h.reshape(B * N, D)).reshape(B, N, D)


def _pallas_interpret(x, weights, dtype):
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = jmb.fused_mixer_block(jnp.asarray(x, dtype),
                                    *(jnp.asarray(w, dtype) for w in weights), bt=2)
    finally:
        pl.pallas_call = orig
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_from_the_ref_matches_the_pallas_kernel(dtype):
    shape = (4, 20, 32, 24, 64)
    x, weights = _block_inputs(*shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jconfig.parity_mode():
        want = _pallas_interpret(x, weights, jdt)
    got = _block_from_gemm_ref(_torch(x, tdt), *(_torch(w, tdt) for w in weights))
    assert got.dtype == tdt and got.shape == shape[:3]
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= 1.6e-2 * max(1.0, np.abs(want).max()), err


def _gemm_inputs(M=9, N=16, K=24, dtype=torch.bfloat16, seed=0):
    r = np.random.default_rng(seed)
    a, b = r.standard_normal((M, K)), r.standard_normal((N, K)) * K ** -0.5
    bias, res = r.standard_normal(N) * 0.5, r.standard_normal((M, N))
    return [torch.from_numpy(v.astype(np.float32)).to(dtype) for v in (a, b, bias, res)]


@pytest.mark.parametrize("core", ["auto", "sm90", "legacy"])
@pytest.mark.parametrize("epilogue", ["gelu_tanh", "residual"])
def test_cpu_wrapper_runs_twin_without_launch(epilogue, core):
    a, b, bias, res = _gemm_inputs(seed=1)
    kw = {"residual": res} if epilogue == "residual" else {"act": "gelu_tanh"}
    got = tg.gemm_tn(a, b, bias, core=core, **kw)
    assert tg.LAUNCHES == 0
    assert not tg._LIB.loaded
    assert tg.routes() == {"sm90": 0, "wmma": 0}  # read without loading the library
    assert torch.equal(got, tg.gemm_tn_ref(a, b, bias, **kw))
    assert got.dtype == torch.bfloat16 and got.shape == (9, 16)


def test_ref_epilogues_round_once():
    a, b, bias, res = _gemm_inputs(dtype=torch.float32, seed=2)
    acc = a.double() @ b.double().t() + bias.double()
    ab = [v.bfloat16() for v in (a, b, bias, res)]
    accb = ab[0].double() @ ab[1].double().t() + ab[2].double()
    got = tg.gemm_tn_ref(*ab[:3], residual=ab[3])
    # one rounding of the f32 result: within half a bf16 ulp (plus f32 noise)
    want = ab[3].double() + accb
    assert (got.double() - want).abs().max() <= want.abs().max() * 2 ** -8 + 1e-5
    g = tg.gemm_tn_ref(a, b, bias, act="gelu_erf")
    exact = 0.5 * acc * (1 + torch.erf(acc / 2 ** 0.5))
    assert (g.double() - exact).abs().max() <= 1e-5


@pytest.mark.parametrize("case", ["k_mismatch", "bias_shape", "residual_shape", "both", "neither",
                                  "act", "core", "dtype_mix", "int", "one_dim", "device"])
def test_wrapper_rejects_bad_inputs(case):
    a, b, bias, res = _gemm_inputs()
    kw = {"act": "gelu_tanh"}
    err = ValueError
    if case == "k_mismatch":
        b = b[:, :-1]
    elif case == "bias_shape":
        bias = bias[:-1]
    elif case == "residual_shape":
        kw = {"residual": res[:, :-1]}
    elif case == "both":
        kw = {"act": "gelu_tanh", "residual": res}
    elif case == "neither":
        kw = {}
    elif case == "act":
        kw = {"act": "relu"}
    elif case == "core":
        kw = {"act": "gelu_tanh", "core": "cublas"}
    elif case == "dtype_mix":
        b, err = b.float(), TypeError
    elif case == "int":
        a, b, bias = (torch.zeros(v.shape, dtype=torch.int32) for v in (a, b, bias))
        err = TypeError
    elif case == "one_dim":
        a = a[0]
    elif case == "device":  # no kernel for the meta device
        a, b, bias = (v.to("meta") for v in (a, b, bias))
    with pytest.raises(err):
        tg.gemm_tn(a, b, bias, **kw)
    assert tg.LAUNCHES == 0


# ---- the core's bf16 modes and int8 form: plain twins ------------------------


def _bf16_pair(M, N, K, seed=0, dtype=torch.bfloat16):
    r = np.random.default_rng(seed)
    a = torch.from_numpy(r.standard_normal((M, K)).astype(np.float32)).to(dtype)
    b = torch.from_numpy((r.standard_normal((N, K)) * K ** -0.5).astype(np.float32)).to(dtype)
    return a, b


@pytest.mark.parametrize("a_mn", [False, True], ids=["a_k", "a_mn"])
@pytest.mark.parametrize("b_mn", [False, True], ids=["b_k", "b_mn"])
def test_bf16_ref_reads_mn_major_operands_as_their_transposes(a_mn, b_mn):
    """An MN-major operand is the K-major one transposed: the same product,
    bit for bit, and within f32 rounding of the float64 product."""
    a, b = _bf16_pair(37, 52, 45, seed=3)
    ga = a.t().contiguous() if a_mn else a
    gb = b.t().contiguous() if b_mn else b
    got = tg.gemm_bf16_ref(ga, gb, a_mn=a_mn, b_mn=b_mn)
    assert got.dtype == torch.float32 and got.shape == (1, 37, 52)
    assert torch.equal(got, tg.gemm_bf16_ref(a, b))
    exact = a.double() @ b.double().t()
    assert (got[0].double() - exact).abs().max() <= 1e-5 * max(1.0, exact.abs().max().item())


@pytest.mark.parametrize("K,slab", [(165, 66), (132, 66), (40, 64)], ids=["short_last", "even", "one"])
def test_bf16_ref_slab_partials_add_in_order(K, slab):
    """Row slabs of K: one f32 partial each (the last may be shorter), each
    the product over its rows; sum_slabs_ref adds them in slab order, and
    the sum is the whole product within f32 rounding."""
    a, b = _bf16_pair(24, 40, K, seed=K)
    at, bt = a.t().contiguous(), b.t().contiguous()  # (K, M), (K, N): MN-major
    parts = tg.gemm_bf16_ref(at, bt, a_mn=True, b_mn=True, slab=slab)
    n = -(-K // slab)
    assert parts.shape == (n, 24, 40)
    for z in range(n):
        rows = slice(z * slab, min(K, (z + 1) * slab))
        assert torch.equal(parts[z], at[rows].float().t() @ bt[rows].float())
    want = parts[0]
    for z in range(1, n):
        want = want + parts[z]
    assert torch.equal(tg.sum_slabs_ref(parts), want)
    full = a.double() @ b.double().t()
    assert (tg.sum_slabs_ref(parts).double() - full).abs().max() <= 1e-5 * full.abs().max()


def _s8_operands(nz, M, N, K, a_batched, b_batched, seed=0):
    r = np.random.default_rng(seed)

    def codes(*s):
        return torch.from_numpy(r.integers(-127, 128, s).astype(np.int8))

    def scales(*s):
        return torch.from_numpy((r.random(s) * 2e-3 + 1e-4).astype(np.float32))

    a = codes(nz, M, K) if a_batched else codes(M, K)
    b = codes(nz, N, K) if b_batched else codes(N, K)
    return a, b, scales(nz, M) if a_batched else scales(M), scales(nz, N) if b_batched else scales(N)


@pytest.mark.parametrize("case", [(1, 9, 16, 64, False, False), (3, 7, 40, 32, False, True),
                                  (2, 5, 24, 1536, True, True)],
                         ids=["one", "shared_a", "batched_k1536"])
def test_s8_ref_scales_the_exact_product_by_row_then_column(case):
    """gemm_s8_ref: the exact integer product rounded once to f32, times the
    row scale, then times the column scale, each rounded in f32 (the
    kernel's __fmul_rn order), per entry with shared operands broadcast."""
    nz, M, N, K, ab, bb = case
    a, b, rs, cs = _s8_operands(*case, seed=sum(case[:4]))
    got = tg.gemm_s8_ref(a, b, rs, cs)
    assert got.dtype == torch.float32 and got.shape == ((nz, M, N) if ab or bb else (M, N))
    A = a.numpy().astype(np.int64) if ab else np.broadcast_to(a.numpy(), (nz, M, K)).astype(np.int64)
    B = b.numpy().astype(np.int64) if bb else np.broadcast_to(b.numpy(), (nz, N, K)).astype(np.int64)
    R = rs.numpy() if ab else np.broadcast_to(rs.numpy(), (nz, M))
    C = cs.numpy() if bb else np.broadcast_to(cs.numpy(), (nz, N))
    acc = (A @ B.transpose(0, 2, 1)).astype(np.float32)
    want = (acc * R[:, :, None]).astype(np.float32) * C[:, None, :]
    want = want if ab or bb else want[0]
    assert np.array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("case", [(1, 9, 16, 128, 32, False), (2, 5, 24, 288, 96, True),
                                  (1, 6, 40, 2176, 544, False)],
                         ids=["chunk32", "batched_chunk96", "chunk544"])
def test_s8_ref_chunks_add_their_dequantized_products_in_order(case):
    """gemm_s8_ref with chunk: each piece's exact integer product rounded
    once to f32, times its own row scale, then the column scale, and the
    pieces added in order from zero, each step rounded in f32, bit for bit
    a numpy int64 computation; chunks of 96 and 544 codes end inside the
    core's 128-code K step."""
    nz, M, N, K, chunk, batched = case
    r = np.random.default_rng(K)
    a = torch.from_numpy(r.integers(-127, 128, (nz, M, K) if batched else (M, K)).astype(np.int8))
    b = torch.from_numpy(r.integers(-127, 128, (nz, N, K)).astype(np.int8))
    pieces = K // chunk
    rs = torch.from_numpy((r.random((nz, M, pieces) if batched else (M, pieces)) * 2e-3 + 1e-4)
                          .astype(np.float32))
    cs = torch.from_numpy((r.random((nz, N)) * 2e-3 + 1e-4).astype(np.float32))
    got = tg.gemm_s8_ref(a, b, rs, cs, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (nz, M, N)
    A = np.broadcast_to(a.numpy(), (nz, M, K)).astype(np.int64)
    B = b.numpy().astype(np.int64)
    R = np.broadcast_to(rs.numpy(), (nz, M, pieces))
    want = np.zeros((nz, M, N), np.float32)
    for p in range(pieces):
        k = slice(p * chunk, (p + 1) * chunk)
        acc = (A[..., k] @ B[..., k].transpose(0, 2, 1)).astype(np.float32)
        want = want + (acc * R[..., p:p + 1]).astype(np.float32) * cs.numpy()[:, None, :]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared_a"])
def test_s8_ref_in_one_chunk_is_the_unchunked_twin(shared):
    """One piece (chunk = K, one row scale a row): 0 + p_0 is p_0, so the
    chunked twin is the unchunked one bit for bit."""
    a, b, rs, cs = _s8_operands(3, 7, 40, 96, not shared, True, seed=11)
    got = tg.gemm_s8_ref(a, b, rs[..., None], cs, chunk=96)
    assert torch.equal(got, tg.gemm_s8_ref(a, b, rs, cs))


@pytest.mark.parametrize("a_batched,b_mn", [(False, True), (True, False), (True, True)],
                         ids=["shared_a_b_mn", "batched_a", "both_batched_b_mn"])
def test_bf16_ref_entries_are_their_matrices_products(a_batched, b_mn):
    """Batch entries: entry z is the product of op(a[z]) and op(b[z]) (a
    2-D operand shared by every entry), bit for bit the 2-D twin of that
    entry's matrices: the bf16 gMLP block's token product (Wsp shared, vn
    N-major an entry an image)."""
    r = np.random.default_rng(12)
    nz, M, N, K = 3, 13, 40, 21

    def t(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).bfloat16()

    a = t(nz, M, K) if a_batched else t(M, K)
    b = t(nz, K, N) if b_mn else t(nz, N, K)
    got = tg.gemm_bf16_ref(a, b, b_mn=b_mn)
    assert got.shape == (nz, M, N) and got.dtype == torch.float32
    for z in range(nz):
        az = a[z] if a_batched else a
        assert torch.equal(got[z], tg.gemm_bf16_ref(az, b[z], b_mn=b_mn)[0])
    assert torch.equal(tg.gemm_bf16(a, b, b_mn=b_mn), got)  # the CPU wrapper: the twin


def test_cpu_core_wrappers_run_twins_without_launch():
    a, b = _bf16_pair(10, 16, 24, seed=5)
    got = tg.gemm_bf16(a.t().contiguous(), b.t().contiguous(), a_mn=True, b_mn=True, slab=10)
    assert torch.equal(got, tg.gemm_bf16_ref(a.t().contiguous(), b.t().contiguous(),
                                             a_mn=True, b_mn=True, slab=10))
    q = _s8_operands(2, 6, 8, 32, False, True, seed=6)
    assert torch.equal(tg.gemm_s8(*q), tg.gemm_s8_ref(*q))
    a, b, rs, cs = _s8_operands(2, 6, 8, 64, False, True, seed=7)
    rs2 = torch.stack([rs, rs * 2], -1)  # two pieces of 32 codes
    assert torch.equal(tg.gemm_s8(a, b, rs2, cs, chunk=32),
                       tg.gemm_s8_ref(a, b, rs2, cs, chunk=32))
    assert tg.LAUNCHES == 0
    assert not tg._LIB.loaded
    assert tg.s8_routes() == {"sm90_s8": 0, "mma_s8": 0}  # read without loading the library


@pytest.mark.parametrize("case", ["k_mismatch", "slab_k_major", "slab_zero", "bf16_dtype_mix",
                                  "bf16_one_dim", "bf16_core", "bf16_batch_mismatch",
                                  "bf16_slab_batched", "s8_k_mismatch", "s8_scale_shape",
                                  "s8_batch", "s8_core", "s8_device", "s8_chunk_divides",
                                  "s8_chunk_32", "s8_chunk_scales"])
def test_core_wrappers_reject_bad_inputs(case):
    a, b = _bf16_pair(8, 16, 24)
    q = list(_s8_operands(2, 6, 8, 32, False, True))
    err = ValueError
    if case.startswith("s8"):
        if case == "s8_k_mismatch":
            q[1] = q[1][..., :-1]
        elif case == "s8_scale_shape":
            q[2] = q[2][:-1]
        elif case == "s8_batch":  # 2 entries of b, 3 of cs
            q[3] = torch.ones((3, 8))
        elif case == "s8_device":
            q = [t.to("meta") for t in q]
        kw = {"core": "cublas"} if case == "s8_core" else {}
        if case == "s8_chunk_divides":  # K = 32 in pieces of 64
            q[2], kw = q[2][:, None], {"chunk": 64}
        elif case == "s8_chunk_32":  # pieces end on a wgmma's 32-code K slice
            q[2], kw = q[2][:, None].repeat(1, 2), {"chunk": 16}
        elif case == "s8_chunk_scales":  # one row scale, two pieces
            q = list(_s8_operands(2, 6, 8, 64, False, True))
            q[2], kw = q[2][:, None], {"chunk": 32}
        with pytest.raises(err):
            tg.gemm_s8(*q, **kw)
    else:
        kw = {}
        if case == "k_mismatch":
            b = b[:, :-1]
        elif case == "slab_k_major":
            kw = {"a_mn": False, "b_mn": False, "slab": 8}
        elif case == "slab_zero":
            a, b, kw = a.t().contiguous(), b.t().contiguous(), {"a_mn": True, "b_mn": True,
                                                                "slab": 0}
        elif case == "bf16_dtype_mix":
            b, err = b.float(), TypeError
        elif case == "bf16_one_dim":
            a = a[0]
        elif case == "bf16_core":
            kw = {"core": "cublas"}
        elif case == "bf16_batch_mismatch":  # 2 entries of a, 3 of b
            a, b = a.expand(2, 8, 24), b.expand(3, 16, 24)
        elif case == "bf16_slab_batched":
            a, b = a.t().expand(2, 24, 8), b.t().contiguous()
            kw = {"a_mn": True, "b_mn": True, "slab": 8}
        with pytest.raises(err):
            tg.gemm_bf16(a, b, **kw)
    assert tg.LAUNCHES == 0


# ---- the core's dual and Group modes (the Mixer backwards'): plain twins ----


def _bf16_t(r, *shape):
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("layout", ["k_major", "b_mn_batched", "a_mn", "both_batched"])
def test_dual_ref_is_two_products_under_one_epilogue(layout):
    """gemm_bf16_dual_ref: epi(v1, v2) with v1 and v2 the two gemm_bf16_ref
    products, bit for bit (by default the pair), for the channel data
    backward's layout (K-major), the token backward's (a shared A, an
    N-major B an entry an image), an MN-major A and both operands batched."""
    r = np.random.default_rng(21)
    nz, M, N, K = 3, 13, 24, 19
    a_mn, b_mn = layout == "a_mn", layout == "b_mn_batched"
    ab, bb = layout == "both_batched", layout in ("b_mn_batched", "both_batched")

    def a():
        shape = (K, M) if a_mn else (M, K)
        return _bf16_t(r, nz, *shape) if ab else _bf16_t(r, *shape)

    def b():
        shape = (K, N) if b_mn else (N, K)
        return _bf16_t(r, nz, *shape) if bb else _bf16_t(r, *shape)

    a1, b1, a2, b2 = a(), b(), a(), b()
    kw = dict(a_mn=a_mn, b_mn=b_mn)

    def epi(v1, v2):
        return (v2 * torch.tanh(v1 + 0.5)).bfloat16()

    got = tg.gemm_bf16_dual_ref(a1, b1, a2, b2, epi, **kw)
    want = epi(tg.gemm_bf16_ref(a1, b1, **kw), tg.gemm_bf16_ref(a2, b2, **kw))
    assert got.dtype == torch.bfloat16 and got.shape == ((nz if ab or bb else 1), M, N)
    assert torch.equal(got, want)
    v1, v2 = tg.gemm_bf16_dual_ref(a1, b1, a2, b2, **kw)
    assert torch.equal(v1, tg.gemm_bf16_ref(a1, b1, **kw))
    assert torch.equal(v2, tg.gemm_bf16_ref(a2, b2, **kw))


@pytest.mark.parametrize("images,per", [(5, 2), (4, 4), (3, 1)],
                         ids=["short_last", "one_group", "one_image_each"])
def test_group_ref_adds_each_groups_images_in_order(images, per):
    """gemm_bf16_group_ref: partial g is the per-image products a_i·b_iᵀ of
    its images added in image order (the last group may hold fewer), bit
    for bit; the partials added in order are the einsum over all images
    within f32 rounding."""
    r = np.random.default_rng(images * 10 + per)
    M, N, K = 11, 7, 30
    a, b = _bf16_t(r, images, M, K), _bf16_t(r, images, N, K)
    got = tg.gemm_bf16_group_ref(a, b, per)
    groups = -(-images // per)
    assert got.dtype == torch.float32 and got.shape == (groups, M, N)
    for g in range(groups):
        want = None
        for i in range(g * per, min((g + 1) * per, images)):
            p = torch.einsum("mk,nk->mn", a[i].float(), b[i].float())
            want = p if want is None else want + p
        assert torch.equal(got[g], want), g
    full = torch.einsum("bmk,bnk->mn", a.double(), b.double())
    err = (tg.sum_slabs_ref(got).double() - full).abs().max().item()
    assert err <= 1e-5 * max(1.0, full.abs().max().item())


def test_cpu_mode_wrappers_run_twins_without_launch():
    r = np.random.default_rng(22)
    w1, w2 = _bf16_t(r, 6, 9), _bf16_t(r, 6, 9)
    x1, x2 = _bf16_t(r, 2, 9, 16), _bf16_t(r, 2, 9, 16)
    got = tg.gemm_bf16_dual(w1, x1, w2, x2, b_mn=True)
    want = tg.gemm_bf16_dual_ref(w1, x1, w2, x2, b_mn=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    a, b = _bf16_t(r, 5, 4, 8), _bf16_t(r, 5, 3, 8)
    assert torch.equal(tg.gemm_bf16_group(a, b, 2), tg.gemm_bf16_group_ref(a, b, 2))
    assert tg.LAUNCHES == 0
    assert not tg._LIB.loaded


@pytest.mark.parametrize("case", ["dual_shapes", "dual_strides", "group_k", "group_per",
                                  "group_core"])
def test_mode_wrappers_reject_bad_inputs(case):
    r = np.random.default_rng(23)
    w, x = _bf16_t(r, 6, 9), _bf16_t(r, 2, 9, 16)
    a, b = _bf16_t(r, 5, 4, 8), _bf16_t(r, 5, 3, 8)
    with pytest.raises(ValueError):
        if case == "dual_shapes":  # the second product one column narrower
            tg.gemm_bf16_dual(w, x, w, x[..., :-1], b_mn=True)
        elif case == "dual_strides":  # the second A a view of rows 12 long
            tg.gemm_bf16_dual(w, x, _bf16_t(r, 6, 12)[:, :9], x, b_mn=True)
        elif case == "group_k":
            tg.gemm_bf16_group(a, b[..., :-1], 2)
        elif case == "group_per":
            tg.gemm_bf16_group(a, b, 0)
        else:
            tg.gemm_bf16_group(a, b, 2, core="cublas")
    assert tg.LAUNCHES == 0
