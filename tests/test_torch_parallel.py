"""The port's parallel layer in one process, against the JAX package: the
placement heuristic, the per-process batch split, the eight factories'
``block_runner=``, the sample window of the drop-path and dropout draws,
a rank's rows of the data feed, the axes the runners take, and
multi-process bring-up off a pod and without a card. The collectives run in
``test_torch_parallel_dist.py``'s gloo worlds, and the runner hook on the
20 families that the JAX ``scan_blocks`` reaches is held there to the JAX
dense forwards that file computes anyway."""

import types

import jax
import numpy as np
import pytest
import torch
from torch_parallel_cases import build, images

import jittor_mlp_tpu as jm
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu.parallel import make_mesh as jax_make_mesh
from jittor_mlp_tpu.parallel import multihost as jmh
from jittor_mlp_tpu.parallel.train import _leaf_spec as jax_leaf_spec
from jittor_mlp_tpu.parallel.train import shard_params as jax_shard_params
from jittor_mlp_tpu_torch import config
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.parallel import multihost, train as ptrain

FULL = {  # the chip smoke's configurations, at full width
    "mixer_b16": ("MLPMixerForImageClassification", dict(d_model=768, depth=12, token_dim=384)),
    "gmlp_s": ("gMLPForImageClassification", dict(image_size=224, d_model=256, d_ffn=1536,
                                                  depth=30)),
    "resmlp_s24": ("ResMLPForImageClassification", dict(d_model=384, depth=24,
                                                        expansion_factor=4)),
}
_FULL_BUILT = {}


def _full(name):
    if name not in _FULL_BUILT:
        factory, kw = FULL[name]
        _FULL_BUILT[name] = (getattr(jm, factory)(**kw), getattr(jt, factory)(**kw, device="cpu"))
    return _FULL_BUILT[name]


def _padded(spec, ndim):
    """A PartitionSpec as a tuple of one entry per axis."""
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("min_dim", [512, 16])
@pytest.mark.parametrize("model_size", [1, 2, 4])
@pytest.mark.parametrize("name", list(FULL))
def test_leaf_spec_and_shard_params_match_jax(name, model_size, min_dim):
    """Per leaf: ``_leaf_spec`` of each JAX parameter shape equals JAX's,
    and the port's ``shard_params`` on its model (a block's tensor judged at
    its JAX shape, the stack's depth in front) chooses JAX's placement for
    every leaf: the multisets of (JAX shape, spec) agree."""
    jmodel, tmodel = _full(name)
    mesh = jax_make_mesh(4, model_parallel=model_size)
    want = []
    jspecs = jax_shard_params(jmodel.params, mesh, min_dim=min_dim)
    for leaf, sh in zip(jax.tree_util.tree_leaves(jmodel.params),
                        jax.tree_util.tree_leaves(jspecs)):
        spec = _padded(sh.spec, leaf.ndim)
        want.append((tuple(leaf.shape), spec))
        port = ptrain._leaf_spec(tuple(leaf.shape), model_size, min_dim)
        assert port == _padded(jax_leaf_spec(leaf, model_size, min_dim), leaf.ndim) == spec
    stacks = ptrain._stack_depths(tmodel)
    got = []
    for k, spec in ptrain.shard_params(tmodel, model_size, min_dim).items():
        t = tmodel.state_dict()[k]
        prefix = max((p for p in stacks if k.startswith(p)), key=len, default=None)
        if prefix is None:
            got.append((tuple(t.shape), spec))
        elif prefix.endswith(".0."):  # a stack's first block stands for the stack
            got.append(((stacks[prefix], *t.shape), (None, *spec)))
    assert sorted(got, key=repr) == sorted(want, key=repr)
    if model_size == 1:
        assert all("model" not in s for _, s in got)


class _Mesh:
    """The mesh surface the port's helpers read: dim names, the rank grid
    and this rank's coordinate."""

    def __init__(self, n, mp, rank):
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.arange(n).reshape(n // mp, mp)
        self.rank = rank

    def get_coordinate(self):
        return [self.rank // self.mesh.shape[1], self.rank % self.mesh.shape[1]]


@pytest.mark.parametrize("hosts,per_host,mp", [(2, 4, 2), (4, 2, 1), (2, 2, 2), (1, 8, 4),
                                               (4, 2, 2)])
def test_process_batch_split_matches_jax(hosts, per_host, mp, monkeypatch):
    """The port's per-rank rows against the JAX formulas on the same layout
    (``hosts`` × ``per_host`` devices, model groups of ``mp`` inside a
    host): the ranks of a JAX host together hold that host's rows, and
    each rank its data index's."""
    n, G = hosts * per_host, 8 * hosts * per_host
    devs = np.array([types.SimpleNamespace(process_index=i // per_host, id=i)
                     for i in range(n)]).reshape(n // mp, mp)
    jmesh = types.SimpleNamespace(devices=devs)
    for host in range(hosts):
        monkeypatch.setattr(jax, "process_index", lambda host=host: host)
        size, off = jmh.process_batch_size(jmesh, G), jmh.process_batch_offset(jmesh, G)
        rows = set()
        for rank in range(host * per_host, (host + 1) * per_host):
            mesh = _Mesh(n, mp, rank)
            s, o = multihost.process_batch_size(mesh, G), multihost.process_batch_offset(mesh, G)
            assert s == G // (n // mp) and o == (rank // mp) * s
            rows |= set(range(o, o + s))
        assert rows == set(range(off, off + size))


class _Counter:
    """A pass-through block runner that counts its stacks."""

    def __init__(self):
        self.stacks = 0

    def __call__(self, fn, blocks, x):
        self.stacks += 1
        for blk in blocks:
            x = fn(blk, x)
        return x


FACTORY_CASES = ["mlp_mixer", "res_mlp", "g_mlp", "vip", "s2_mlp_v1", "s2_mlp_v2", "swin_mlp",
                 "as_mlp"]


@pytest.mark.parametrize("name", FACTORY_CASES)
def test_factory_block_runner(name):
    """Each of the eight factories' ``block_runner=`` runs that model's
    stacks (one per stage), ahead of an outer ``block_runner_scope``, and a
    pass-through runner leaves the logits as the dense forward's."""
    dense = build("jittor_mlp_tpu_torch", name).eval()
    runner, outer = _Counter(), _Counter()
    model = build("jittor_mlp_tpu_torch", name, block_runner=runner).eval()
    assert model.block_runner is runner
    x = images(name)
    with torch.no_grad():
        want = dense(x)
        with nnf.block_runner_scope(outer):
            got = model(x)
    assert runner.stacks >= 1 and outer.stacks == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sample_window_draws_the_dense_rows():
    """Under ``sample_window_scope(8, 4)`` a 4-row forward draws the dense
    8-row masks and takes rows 4..7: ``drop_path_masks`` covers the global
    batch, ``nnf.drop_path`` gives each row its global bit, and ``dropout``
    keeps its own rows of the global draw."""
    model = jt.SwinMLP(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2],
                       num_heads=[2, 4], window_size=4, drop_path_rate=0.5,
                       device="cpu").train()
    x = torch.randn(8, 64, 16, generator=torch.Generator().manual_seed(0))
    dense = model.drop_path_masks(x, torch.Generator().manual_seed(3))
    want = {m: [nnf.drop_path(x, m.drop_path_rate, True, mask=a)[4:] for a in dense[m]]
            for m in dense}
    want_dropout = nnf.dropout(x, 0.3, True, torch.Generator().manual_seed(5))[4:]
    with nnf.sample_window_scope(8, 4):
        window = model.drop_path_masks(x[4:], torch.Generator().manual_seed(3))
        assert list(window) == list(dense)
        for m in dense:
            for a, b, w in zip(dense[m], window[m], want[m]):
                assert torch.equal(a, b) and a.shape == (8,)
                assert torch.equal(nnf.drop_path(x[4:], m.drop_path_rate, True, mask=b), w)
        assert torch.equal(nnf.dropout(x[4:], 0.3, True, torch.Generator().manual_seed(5)),
                           want_dropout)
        with pytest.raises(ValueError, match="sample window"):
            nnf.drop_path(x[4:], 0.5, True, mask=torch.ones(4, dtype=torch.bool))
    assert any(not bool(b.all()) for masks in dense.values() for b in masks)  # something dropped


def test_remat_recomputes_inside_the_window():
    """A checkpointed block recomputes in the backward with its forward's
    sample window: the gradients under ``remat_mode()`` equal those
    without, with live drop-path in a window."""
    model = jt.SwinMLP(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=[2, 2],
                       num_heads=[2, 4], window_size=4, drop_path_rate=0.5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 32, 32))
                         .astype(np.float32))
    grads = []
    for remat in (False, True):
        model.zero_grad()
        with nnf.sample_window_scope(8, 4), (config.remat_mode() if remat
                                             else nnf.block_runner_scope(None)):
            out = model.train()(x, generator=torch.Generator().manual_seed(1))
        out.square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-7)


def test_initialize_off_pod_and_on_a_pod_marker(monkeypatch):
    """``multihost.initialize`` is a no-op without torchrun's environment,
    and raises where a pod marker says the process is one of several."""
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
              "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "TPU_WORKER_HOSTNAMES",
              *multihost._POD_ENV_MARKERS):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    for marker, value in [("WORLD_SIZE", "4"), ("SLURM_NTASKS", "2"),
                          ("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234"),
                          ("TPU_WORKER_HOSTNAMES", "a,b")]:
        with monkeypatch.context() as m:
            m.setenv(marker, value)
            assert jmh._looks_like_pod() or marker == "WORLD_SIZE"
            with pytest.raises(RuntimeError, match="torchrun"):
                multihost.initialize()
    assert not dist.is_initialized()


def test_initialize_needs_a_card_for_nccl(monkeypatch):
    """Under torchrun's environment, ``initialize`` joins NCCL on the rank's
    card or raises: with no card visible it raises rather than fall back
    to gloo on the CPU, and it takes no backend but NCCL and gloo."""
    import torch.distributed as dist

    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT="1",
                     LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        multihost.initialize()
    with pytest.raises(ValueError, match="'nccl' .* or 'gloo'"):
        multihost.initialize(backend="mpi")
    assert not dist.is_initialized()


@pytest.mark.parametrize("call", ["pipeline_runner", "pipeline_blocks", "pipeline_data_axis",
                                  "pipeline_shardings", "gather_state_dict",
                                  "gather_optimizer_state", "token_parallel_runner",
                                  "token_parallel_resmlp_block"])
def test_axis_other_than_model_raises(call):
    """The runners and the placement helpers keep the JAX ``axis=`` names
    and refuse any other axis than the one their loss scale and stage
    ownership assume, before touching the mesh."""
    from jittor_mlp_tpu_torch.parallel import pipeline, sequence

    calls = {
        "pipeline_runner": lambda: pipeline.pipeline_runner(None, 2, axis="data"),
        "pipeline_blocks": lambda: pipeline.pipeline_blocks(None, None, axis="data"),
        "pipeline_data_axis": lambda: pipeline.pipeline_runner(None, 2, data_axis="model"),
        "pipeline_shardings": lambda: pipeline.pipeline_shardings(None, None, (1,), axis="x"),
        "gather_state_dict": lambda: pipeline.gather_state_dict(None, None, axis="data"),
        "gather_optimizer_state": lambda: pipeline.gather_optimizer_state(None, None, None,
                                                                          axis="data"),
        "token_parallel_runner": lambda: sequence.token_parallel_runner(None, "res_mlp",
                                                                        axis="data"),
        "token_parallel_resmlp_block": lambda: sequence.token_parallel_resmlp_block(
            None, axis="data"),
    }
    with pytest.raises(ValueError, match="axis only"):
        calls[call]()


@pytest.mark.parametrize("offset,size", [(0, 8), (0, 4), (4, 4), (6, 2)])
def test_a_rank_feeds_only_its_rows(offset, size):
    """``BatchIterator(rows=)`` yields the rows of each batch that a rank
    owns, and ``make_augment``'s ``window=`` gives them the crops and
    flips of the whole batch's augmentation."""
    from jittor_mlp_tpu_torch.data import ArrayDataset, BatchIterator, make_augment

    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.integers(0, 256, (24, 12, 12, 3), dtype=np.uint8),
                      np.arange(24, dtype=np.int32))
    augment = make_augment(image_size=8)
    full = list(BatchIterator(ds, 8, seed=3))
    part = list(BatchIterator(ds, 8, seed=3, rows=(offset, size)))
    assert len(full) == len(part) == 3
    for k, (f, p) in enumerate(zip(full, part)):
        assert np.array_equal(p["label"], f["label"][offset:offset + size])
        assert np.array_equal(p["image"], f["image"][offset:offset + size])
        want = augment(torch.Generator().manual_seed(k), torch.from_numpy(f["image"]))
        got = augment(torch.Generator().manual_seed(k), torch.from_numpy(p["image"]),
                      window=(8, offset))
        assert torch.equal(got, want[offset:offset + size])


def test_train_step_mesh_preconditions():
    """The mesh step refuses a model on another device type than the mesh's,
    and ``check_replicated`` names the tensors a 'model' axis would
    shard."""
    mesh = _Mesh(2, 2, 0)
    mesh.device_type = "cuda"
    model = jt.MLPMixerForImageClassification(d_model=32, depth=2, patch_size=4, image_size=16,
                                              num_classes=8, device="cpu")
    with pytest.raises(ValueError, match="mesh on 'cuda'"):
        ptrain.check_mesh_step(model, mesh, 0.1)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        ptrain.check_replicated(model, mesh, min_dim=16)
    assert all("model" not in s for s in ptrain.check_replicated(model, mesh).values())
