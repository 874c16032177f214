"""The port's parallel layer across processes: two gloo worlds, one of 4 ranks
(a 2 × 2 ('data', 'model') mesh) and one of 2 (a 2 × 1 mesh), run every
check in ``torch_parallel_worker.py`` and write what it returns; each check
is a case here, held to the JAX dense forward or step and to the port's
dense step on the same seed's weights and batch:

- in this process, a counting pass-through runner under
  ``block_runner_scope`` on the 20 families that the JAX ``scan_blocks``
  reaches: called, and f32 logits within 1e-4 of the JAX dense forward;

- pipelined forwards (2 stages × 2 microbatches, data-parallel over 2)
  of tests/test_pp_zoo.py's 20 families and of test_parallel_features.py's
  Mixer, gMLP and hierarchical AS-MLP: f32 logits within 1e-4 of JAX's;
- pipelined Mixer and gMLP SGD steps: the port's dense step within loss
  rtol 1e-5 and parameters rtol 1e-4 / atol 1e-6 (JAX's own bands), and
  the JAX dense step within 1e-4; Swin-MLP with live drop-path 0.5
  against the dense step with the same generator seed;
- a pipelined AdamW run cut after one step and resumed from the train
  example's checkpoint against the uncut run;
- the BatchNorm contract under a runner; a data-parallel WaveMLP step,
  running statistics included; token-parallel Mixer and ResMLP forwards
  and a token-parallel Mixer step; each rank keeping 1/P of the blocks;
- tensor parallelism on the 2 × 2 mesh's 'model' axis (``Model.shard``
  and ``init_sharded`` at the JAX tests' ``min_dim=8``): f32 forwards of
  the 20 families and the three shard cases against the JAX dense forward
  (1e-4) and the port's dense forward (rtol = atol = 1e-5, JAX's band), the
  Mixer also against the JAX package's own sharded forward; the Mixer's
  channel MLPs split (one split a block), bf16 through the split kernel's
  twin and int8 (gathered, bit-equal); Mixer, gMLP and WaveMLP SGD steps
  (the running statistics too) against the dense steps, and the Mixer's
  bf16 recompute-route step; an AdamW step whose gathered weights and
  moments resume as a dense model; ``gather_tp`` and its backward, its
  slices bucketed; a placement kept on the same mesh and refused on
  another; the train example with ``--model-parallel 2`` and its
  checkpoint in a dense model;
- on the 2-rank mesh: ``Model.shard`` forwards of WaveMLP, Swin-MLP and
  CycleMLP, and the recipe step, mixup and cutmix on, against the dense
  recipe step; and ``multihost.run_local_selftest()``.

The worlds start first and the references are computed while they run.
Every world has a 60 s collective timeout and a 150 s join timeout; a rank
that fails fails its checks with its stderr.
"""

import os
import socket
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import assert_close
from torch_parallel_cases import PP_CASES, add_pp_settings, build, images, labels

import jittor_mlp_tpu_torch.train_recipes as tr
from jittor_mlp_tpu.parallel import make_mesh as jax_make_mesh
from jittor_mlp_tpu.parallel.train import make_train_step as jax_train_step
from jittor_mlp_tpu.parallel.train import split_params
from jittor_mlp_tpu_torch.core import nnf
from jittor_mlp_tpu_torch.parallel import make_train_step, multihost

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLDS = {"dp2pp2": 4, "dp2": 2}
JAX = "jittor_mlp_tpu"
PORT = "jittor_mlp_tpu_torch"
sys.path.insert(0, HERE)
import torch_parallel_worker as worker  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(name, seed=2):
    return {"image": torch.from_numpy(images(name, seed=seed)), "label": torch.from_numpy(labels())}


def _dense_step(name, generator_seed=None, compute_dtype=None):
    model = build(PORT, name)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    loss = make_train_step(model, opt, compute_dtype=compute_dtype)(_batch(name), gen)
    return float(loss), model.state_dict()


def _dense_adamw():
    """Two dense AdamW steps of the Mixer on the batches of seeds 300, 301."""
    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters(), **worker.ADAMW)
    step = make_train_step(model, opt)
    losses = [float(step(_batch("mixer", seed=s))) for s in (300, 301)]
    return losses, model.state_dict()


def _jax_step(name):
    model = build(JAX, name)
    params = jax.tree.map(jnp.array, model.params)
    opt = optax.sgd(0.1)
    b = _batch(name)
    params, _, loss = jax_train_step(model.apply, opt)(
        params, opt.init(split_params(params)[0]),
        {"image": jnp.asarray(b["image"].numpy()), "label": jnp.asarray(b["label"].numpy())},
        jax.random.PRNGKey(0))
    model.params = params
    return float(loss), model.export_torch_state_dict(tensors=False)


def _dense_recipe():
    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters(), **worker.ADAMW)
    state = tr.init_recipe_state(model, opt, recipe=worker.RECIPE)
    step = tr.make_recipe_train_step(model, opt, 8, worker.RECIPE)
    metrics = []
    for s in range(worker.RECIPE_STEPS):
        b = {"image": torch.from_numpy(images("mixer", seed=100 + s)),
             "label": torch.from_numpy(labels())}
        state, m = step(state, b, torch.Generator().manual_seed(worker.RECIPE_SEED))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model.state_dict(), state.ema


def _references():
    add_pp_settings(JAX)  # before the threads: build() would add them in each
    names = [*worker.TP_CASES, "mixer", "gmlp", "asmlp", "resmlp"]
    with ThreadPoolExecutor(4) as pool:  # XLA compiles the forwards side by side
        logits = list(pool.map(lambda n: np.asarray(build(JAX, n)(images(n))), names))
    ref = {f"jax_logits/{n}": v for n, v in zip(names, logits)}
    ref["jax_sharded_logits/mlp_mixer"] = np.asarray(build(JAX, "mlp_mixer").shard(
        jax_make_mesh(4, model_parallel=2), min_dim=worker.TP_MIN_DIM)(images("mlp_mixer")))
    for name in worker.TP_CASES:
        with torch.no_grad():
            ref[f"logits/{name}"] = build(PORT, name).eval()(images(name)).numpy()
    for name in ("mixer", "gmlp"):
        ref[f"jax_step/{name}"] = _jax_step(name)
    for name in ("mixer", "gmlp", "wave_xs"):
        ref[f"step/{name}"] = _dense_step(name)
    ref["step/swin_dp"] = _dense_step("swin_dp", generator_seed=7)
    ref["step_bf16/mixer"] = _dense_step("mixer", compute_dtype=torch.bfloat16)
    ref["adamw/mixer"] = _dense_adamw()
    model = build(PORT, "swin_dp").train()
    with torch.no_grad():
        x = torch.from_numpy(images("swin_dp"))
        ref["swin_dp/dropped"] = not torch.equal(
            model(x, generator=torch.Generator().manual_seed(7)), model(x))
    ref["recipe"] = _dense_recipe()
    return ref


@pytest.fixture(scope="module")
def run():
    """{"results": {world: [per-rank {key: array}]}, "errors": {world:
    stderr or None}, "ref": the references}."""
    with tempfile.TemporaryDirectory() as out:
        procs = {}
        env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        for world, size in WORLDS.items():
            port = _free_port()
            procs[world] = []
            for r in range(size):
                with open(os.path.join(out, f"{world}.{r}.err"), "w") as err:
                    procs[world].append(subprocess.Popen(
                        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"), world,
                         str(r), str(size), str(port), out],
                        env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=err))
        try:
            ref = _references()
        finally:
            errors, results = {}, {}
            for world, ps in procs.items():
                errs = []
                for r, p in enumerate(ps):
                    try:
                        p.wait(timeout=150)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                    with open(os.path.join(out, f"{world}.{r}.err")) as f:
                        se = f.read()[-4000:]
                    if p.returncode != 0:
                        errs.append(f"rank {r} exited {p.returncode} (killed at 150 s if "
                                    f"negative):\n{se}")
                errors[world] = "\n".join(errs) or None
                results[world] = []
                for r in range(len(ps)):
                    path = os.path.join(out, f"{world}.{r}.npz")
                    results[world].append(dict(np.load(path)) if os.path.exists(path) else {})
    return {"results": results, "errors": errors, "ref": ref}


def _get(run, world, check):
    """{field: per-rank arrays} of ``check``; fails with the world's errors
    if a rank did not return it."""
    per_rank = []
    for r, res in enumerate(run["results"][world]):
        if f"{check}/error" in res:
            pytest.fail(f"{check} raised on rank {r}:\n{res[f'{check}/error']}")
        fields = {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith(check + "/")}
        if not fields:
            pytest.fail(f"{check}: rank {r} returned nothing\n{run['errors'][world]}")
        per_rank.append(fields)
    return per_rank


def _close_sd(got, want, rtol, atol, what):
    keys = sorted(k[3:] for k in got if k.startswith("sd."))
    assert keys == sorted(want), what
    for k in keys:
        w = want[k]
        w = w.detach().float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_allclose(got["sd." + k], w, rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


class _Counter:
    """A pass-through block runner that counts its stacks."""

    def __init__(self):
        self.stacks = 0

    def __call__(self, fn, blocks, x):
        self.stacks += 1
        for blk in blocks:
            x = fn(blk, x)
        return x


@pytest.mark.parametrize("name", list(PP_CASES))
def test_block_runner_scope_reaches_family(run, name):
    """In this process: ``block_runner_scope`` reaches every stack of the 20
    families that the JAX ``scan_blocks`` reaches (at tests/test_pp_zoo.py's
    sizes): the runner is called, and the f32 logits stay within 1e-4 of the
    JAX dense forward."""
    model = build(PORT, name).eval()
    runner = _Counter()
    with torch.no_grad(), nnf.block_runner_scope(runner):
        got = model(images(name)).numpy()
    assert runner.stacks > 0
    assert_close(got, run["ref"][f"jax_logits/{name}"], tol=1e-4, name=name)


PP_FORWARD = [*PP_CASES, "mixer", "gmlp", "asmlp"]


@pytest.mark.parametrize("name", PP_FORWARD)
def test_pipelined_forward_matches_jax(run, name):
    for r, res in enumerate(_get(run, "dp2pp2", f"pp_forward[{name}]")):
        assert_close(res["logits"], run["ref"][f"jax_logits/{name}"], tol=1e-4,
                     name=f"{name} rank {r}")


@pytest.mark.parametrize("name", ["mixer", "gmlp"])
def test_pipelined_train_step_matches_dense(run, name):
    dense_loss, dense_sd = run["ref"][f"step/{name}"]
    jax_loss, jax_sd = run["ref"][f"jax_step/{name}"]
    for r, res in enumerate(_get(run, "dp2pp2", f"pp_train[{name}]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"{name} rank {r} vs the port's dense step")
        assert abs(float(res["loss"]) - jax_loss) < 1e-4
        for k, w in jax_sd.items():
            assert_close(res["sd." + k], w, tol=1e-4, name=f"{name} rank {r} vs JAX: {k}")


def test_pipelined_train_step_live_drop_path(run):
    """Swin-MLP at drop-path 0.5: the pipelined step takes each sample's
    bit of the dense draw, so it equals the dense step with the same
    generator seed, and the masks did drop something."""
    assert run["ref"]["swin_dp/dropped"]
    dense_loss, dense_sd = run["ref"]["step/swin_dp"]
    for r, res in enumerate(_get(run, "dp2pp2", "pp_train[swin_dp]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"swin_dp rank {r}")


def test_pipelined_resume_matches_uninterrupted(run):
    """The train example's checkpoints under a pipeline: a run cut after
    its first AdamW step and resumed (each stage's weights and optimizer
    moments gathered into rank 0's file) takes the same second step as a
    run that was never cut."""
    for r, res in enumerate(_get(run, "dp2pp2", "pp_resume")):
        np.testing.assert_allclose(float(res["resumed_loss"]), float(res["loss"]), rtol=1e-6)
        keys = sorted(k for k in res if k.startswith("sd."))
        assert keys and keys == sorted(k[len("resumed."):] for k in res
                                       if k.startswith("resumed."))
        for k in keys:
            np.testing.assert_allclose(res["resumed." + k], res[k], rtol=1e-6, atol=1e-8,
                                       err_msg=f"rank {r} {k}")


def test_pipeline_keeps_a_stage_of_blocks(run):
    """Each rank keeps 1/P of the block tensors (P = 2)."""
    full = sum(v.numel() for k, v in build(PORT, "mixer").state_dict().items()
               if k.startswith("model."))
    for res in _get(run, "dp2pp2", "pp_train[mixer]"):
        assert int(res["block_numel"]) * 2 == full


def test_bn_under_runner_raises_and_trains_frozen(run):
    for res in _get(run, "dp2pp2", "bn_contract"):
        assert "bn_momentum=None" in str(res["message"])
        assert np.isfinite(float(res["loss"]))


def test_data_parallel_bn_step_matches_dense(run):
    """WaveMLP PP_XS on the 2 × 2 mesh (the model axis replicates): the
    global batch's BatchNorm statistics, so the running statistics too
    equal the dense step's."""
    dense_loss, dense_sd = run["ref"]["step/wave_xs"]
    for r, res in enumerate(_get(run, "dp2pp2", "dp_train[wave_xs]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"wave_xs rank {r}")


@pytest.mark.parametrize("name", ["mixer", "resmlp"])
def test_token_parallel_forward_matches_jax(run, name):
    for r, res in enumerate(_get(run, "dp2pp2", f"sp_forward[{name}]")):
        assert_close(res["logits"], run["ref"][f"jax_logits/{name}"], tol=1e-4,
                     name=f"{name} rank {r}")


def test_token_parallel_train_step_matches_dense(run):
    dense_loss, dense_sd = run["ref"]["step/mixer"]
    for r, res in enumerate(_get(run, "dp2pp2", "sp_train[mixer]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"sp mixer rank {r}")


@pytest.mark.parametrize("name", ["wave_mlp", "swin_mlp", "cycle_mlp"])
def test_model_shard_forward_matches_dense(run, name):
    """JAX's test_shard_generalizes_across_families models: the 2-rank
    data-parallel forward of the global batch against the dense one,
    rtol 1e-5 and atol 1e-5 (JAX's band there)."""
    for r, res in enumerate(_get(run, "dp2", f"shard_forward[{name}]")):
        np.testing.assert_allclose(res["logits"], run["ref"][f"logits/shard_{name}"],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{name} rank {r}")


def test_recipe_step_on_a_data_mesh_matches_dense(run):
    """The recipe step on the 2-rank data mesh, mixup and cutmix on, for
    four steps against the dense recipe step: each rank mixes its rows
    with their partners of the global batch reversed; metrics, parameters
    and EMA as the dense step's."""
    metrics, dense_sd, dense_ema = run["ref"]["recipe"]
    modes = {tr.mix_draws(tr.mix_generator(torch.Generator().manual_seed(worker.RECIPE_SEED), s),
                          8, 16, 16, 0.8, 1.0, 0.5).cutmix for s in range(worker.RECIPE_STEPS)}
    assert modes == {True, False}  # both modes ran
    for r, res in enumerate(_get(run, "dp2", "recipe")):
        for s, m in enumerate(metrics):
            for k, v in m.items():
                np.testing.assert_allclose(float(res[f"{k}{s}"]), v, rtol=1e-5,
                                           err_msg=f"rank {r} step {s} {k}")
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"recipe rank {r}")
        for k, v in dense_ema.items():
            np.testing.assert_allclose(res["ema." + k], v.numpy(), rtol=1e-4, atol=1e-6)


TP_BF16_STEP = 2e-3  # of max|param|: bf16 products summed per rank vs whole (one SGD step)


@pytest.mark.parametrize("name", worker.TP_CASES)
def test_tensor_parallel_forward_matches_dense(run, name):
    """``Model.shard(mesh, min_dim=8)`` over the 2 × 2 mesh: each tensor the
    JAX heuristic shards keeps half on each rank, and the f32 logits of the
    global batch agree with the JAX dense forward within 1e-4 and with the
    port's dense forward at JAX's band (rtol = atol = 1e-5); the Mixer also
    with the JAX package's own sharded forward, its channel MLPs split (one
    split site a block)."""
    dense = sum(t.numel() for t in build(PORT, name).state_dict().values())
    for r, res in enumerate(_get(run, "dp2pp2", f"tp_forward[{name}]")):
        assert int(res["placed"]) > 0
        assert int(res["numel"]) == dense - int(res["whole"]) // 2  # half of each placed one
        assert_close(res["logits"], run["ref"][f"jax_logits/{name}"], tol=1e-4,
                     name=f"{name} rank {r} vs JAX")
        np.testing.assert_allclose(res["logits"], run["ref"][f"logits/{name}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} rank {r} vs the port")
        if name == "mlp_mixer":
            assert int(res["split"]) == PP_CASES[name][1]["depth"]
            assert_close(res["logits"], run["ref"]["jax_sharded_logits/mlp_mixer"], tol=1e-4,
                         name=f"rank {r} vs the JAX sharded forward")
        else:
            assert int(res["split"]) == 0


def test_tensor_parallel_bf16_and_int8(run):
    """The Mixer (depth 4) under TP against its data-parallel forward
    unplaced: bf16 through the split kernel's twin within the kernel-vs-twin
    band (1.6e-2 of max(1, max|ref|)), 4 splits; int8, f32 and bf16 models,
    bit-equal (the split mode does not apply: the boundary gathers the
    split sites' slices and the blocks run whole, 0 splits)."""
    for r, res in enumerate(_get(run, "dp2pp2", "tp_bf16_and_int8")):
        want = res["bf16.want"]
        assert np.abs(res["bf16.got"] - want).max() <= 1.6e-2 * max(1.0, np.abs(want).max())
        assert int(res["bf16.split"]) == 4
        for tag in ("int8_f32", "int8_bf16"):
            assert np.array_equal(res[f"{tag}.got"], res[f"{tag}.want"]), f"{tag} rank {r}"
            assert int(res[f"{tag}.split"]) == 0


@pytest.mark.parametrize("name", ["mixer", "gmlp"])
def test_tensor_parallel_train_step_matches_dense(run, name):
    """A TP SGD step (``init_sharded(min_dim=8)``): loss within rtol 1e-5 and
    the gathered parameters within rtol 1e-4 / atol 1e-6 of the port's dense
    step and of the JAX dense step; the Mixer's four channel MLPs split."""
    dense_loss, dense_sd = run["ref"][f"step/{name}"]
    jax_loss, jax_sd = run["ref"][f"jax_step/{name}"]
    for r, res in enumerate(_get(run, "dp2pp2", f"tp_train[{name}]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-5)
        np.testing.assert_allclose(float(res["loss"]), jax_loss, rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"{name} rank {r} vs the port's dense step")
        _close_sd(res, jax_sd, 1e-4, 1e-6, f"{name} rank {r} vs the JAX dense step")
        assert int(res["split"]) == (4 if name == "mixer" else 0)


def test_tensor_parallel_bn_step_matches_dense(run):
    """WaveMLP PP_XS under TP: its wide BatchNorm buffers are slices, each
    folding its chunk of the global batch's statistics: the running
    statistics and the parameters as the dense step's."""
    dense_loss, dense_sd = run["ref"]["step/wave_xs"]
    for r, res in enumerate(_get(run, "dp2pp2", "tp_train[wave_xs]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"wave_xs rank {r}")


def test_tensor_parallel_bf16_step_matches_dense(run):
    """The Mixer's bf16 recompute-route step under TP (the split kernel's
    twin forward, autograd of the plain split block backward) against the
    dense bf16 step: loss within rtol 1e-3, parameters within 2e-3 of each
    tensor's max (the ranks' bf16 partial gradients round apart)."""
    dense_loss, dense_sd = run["ref"]["step_bf16/mixer"]
    for r, res in enumerate(_get(run, "dp2pp2", "tp_train_bf16[mixer]")):
        np.testing.assert_allclose(float(res["loss"]), dense_loss, rtol=1e-3)
        assert int(res["split"]) == 4
        for k, w in dense_sd.items():
            w = w.float().numpy()
            assert np.abs(res["sd." + k] - w).max() <= TP_BF16_STEP * max(1.0, np.abs(w).max()), k


def test_tensor_parallel_other_routes_match_dense(run):
    """The Mixer's TP step under ``config.remat_mode()`` (f32: the blocks
    recompute inside the tensor-parallel scope, four splits in the forward
    and four in the recompute) against the dense step at JAX's bands, and
    on the backward-kernel route (bf16, ``config.pallas_bwd``: no split,
    the boundary gathers the four channel MLPs' slices and the training
    kernels' twins run whole) within
    the bf16 step's band of the dense bf16 step."""
    dense_loss, dense_sd = run["ref"]["step/mixer"]
    bf16_loss, bf16_sd = run["ref"]["step_bf16/mixer"]
    for r, res in enumerate(_get(run, "dp2pp2", "tp_routes")):
        np.testing.assert_allclose(float(res["remat.loss"]), dense_loss, rtol=1e-5)
        remat = {k[len("remat."):]: v for k, v in res.items() if k.startswith("remat.")}
        _close_sd(remat, dense_sd, 1e-4, 1e-6, f"remat rank {r}")
        assert int(res["remat.split"]) == 8
        np.testing.assert_allclose(float(res["pallas_bwd.loss"]), bf16_loss, rtol=1e-3)
        assert int(res["pallas_bwd.split"]) == 0
        for k, w in bf16_sd.items():
            w = w.float().numpy()
            got = res[f"pallas_bwd.sd.{k}"]
            assert np.abs(got - w).max() <= TP_BF16_STEP * max(1.0, np.abs(w).max()), k


def test_tensor_parallel_recipe_step_matches_dense(run):
    """The recipe step (mixup, cutmix, EMA) of the Mixer under TP for four
    steps against the dense recipe step: metrics, the gathered parameters
    and the gathered EMA as the data-mesh recipe test holds them."""
    metrics, dense_sd, dense_ema = run["ref"]["recipe"]
    for r, res in enumerate(_get(run, "dp2pp2", "tp_recipe")):
        for s, m in enumerate(metrics):
            for k, v in m.items():
                np.testing.assert_allclose(float(res[f"{k}{s}"]), v, rtol=1e-5,
                                           err_msg=f"rank {r} step {s} {k}")
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"tp recipe rank {r}")
        for k, v in dense_ema.items():
            np.testing.assert_allclose(res["ema." + k], v.numpy(), rtol=1e-4, atol=1e-6)


def test_tensor_parallel_checkpoint_resumes_dense(run):
    """A TP AdamW step of the Mixer whose gathered weights and AdamW state
    (``gather_state_dict``, ``gather_optimizer_state``) load into a dense
    model that takes the second step: as two dense steps."""
    (loss1, loss2), dense_sd = run["ref"]["adamw/mixer"]
    whole = sum(v.numel() for k, v in dense_sd.items() if "num_batches" not in k)
    for r, res in enumerate(_get(run, "dp2pp2", "tp_adamw_dense")):
        np.testing.assert_allclose([float(res["loss1"]), float(res["loss2"])], [loss1, loss2],
                                   rtol=1e-5)
        _close_sd(res, dense_sd, 1e-4, 1e-6, f"rank {r}")
        assert int(res["moments"]) < 2 * whole  # each rank keeps a slice of the moments


def test_gather_tp_backward_matches_dense(run):
    """``gather_tp`` under the mesh step's 1/P loss scale, with three f32
    slices in one bucket (along axes 1, 0 and 0) and a bf16 one in its
    own: each gathered tensor is the whole one, and each rank's slice gets
    its part of the dense gradient."""
    whole, x = worker.gather_inputs()
    whole = {k: t.clone().requires_grad_() for k, t in whole.items()}
    worker.gather_loss(whole, x).backward()
    for res in _get(run, "dp2pp2", "tp_gather_grad"):
        for k, t in whole.items():
            axis = worker.GATHER_SPECS[k].index("model")
            np.testing.assert_array_equal(res[f"whole.{k}"], t.detach().float().numpy())
            want = t.grad.chunk(2, axis)[int(res["rank"])].float().numpy()
            np.testing.assert_allclose(res[f"grad.{k}"], want, rtol=1e-6, atol=1e-6, err_msg=k)


def test_tensor_parallel_placement_is_kept_or_refused(run):
    """A model placed on the 2 × 2 mesh at ``min_dim=8``, sharded again:
    a 4 × 1 mesh (each rank its own model group) and the default
    ``min_dim`` (other specs) raise ValueError, where keeping the slices
    would sum other rows' partials; the same mesh and ``min_dim`` keep
    the slices, and the logits are the port's dense forward's at JAX's
    band."""
    dense = sum(t.numel() for t in build(PORT, "mlp_mixer").state_dict().values())
    for r, res in enumerate(_get(run, "dp2pp2", "tp_reshard")):
        for tag in ("4x1", "min_dim"):
            assert "placed over the model group" in str(res[tag]), (tag, str(res[tag]))
        assert int(res["numel"]) < dense
        np.testing.assert_allclose(res["logits"], run["ref"]["logits/mlp_mixer"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")


def test_tensor_parallel_train_example(run):
    """``examples/train.py --model-parallel 2`` in the 4-rank world: tensor
    parallelism over the 2 × 2 mesh, its default Mixer's channel MLPs split
    at ``min_dim`` 512; two finite steps; its checkpoint (the slices and
    moments gathered) loads into a dense model whose logits are the placed
    model's."""
    for r, res in enumerate(_get(run, "dp2pp2", "tp_example")):
        assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 2
        assert int(res["step"]) == 2 and int(res["placed"]) > 0
        assert int(res["split"]) == 3 * 6  # W1, b1, W2 of six blocks
        np.testing.assert_allclose(res["got"], res["want"], rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")


def test_worlds_exit_cleanly(run):
    assert run["errors"] == {w: None for w in WORLDS}


def test_local_selftest():
    res = multihost.run_local_selftest(num_processes=2, timeout=120)
    assert set(res) == {"w0", "w1", "ref"}
