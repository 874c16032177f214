"""One rank of the gloo worlds of ``test_torch_parallel_dist.py``.

    python tests/torch_parallel_worker.py WORLD RANK SIZE PORT OUT_DIR

runs every check of world WORLD ("dp2pp2": 4 ranks, a 2 × 2 ('data',
'model') mesh, whose 'model' axis also carries the tensor-parallel
checks; "dp2": 2 ranks, a 2 × 1 mesh) in a gloo process group of
SIZE ranks on a loopback PORT, and writes what each check returns to
``OUT_DIR/WORLD.RANK.npz`` as ``check/field`` arrays (``check/error`` with
the traceback where a check raised: the rank then stops, and its peers'
collectives fail within the group's timeout). Imports neither JAX nor the
JAX package: the parent test holds the results to both packages' dense
references.
"""

import contextlib
import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parallel_cases import (FEATURE_CASES, PP_CASES, SHARD_CASES, build,  # noqa: E402
                                  images, labels)

import jittor_mlp_tpu_torch.train_recipes as tr  # noqa: E402
from jittor_mlp_tpu_torch import config  # noqa: E402
from jittor_mlp_tpu_torch.core import nnf  # noqa: E402
from jittor_mlp_tpu_torch.parallel import (gather_optimizer_state, gather_state_dict,  # noqa: E402
                                           gather_tp, init_sharded, make_mesh,
                                           make_train_step, pipeline_runner, pipeline_shardings,
                                           tensor, token_parallel_runner)
from jittor_mlp_tpu_torch.parallel.mesh import axis_group, axis_index  # noqa: E402
from jittor_mlp_tpu_torch.parallel.train import batch_sharding  # noqa: E402

PORT = "jittor_mlp_tpu_torch"
RECIPE = tr.Recipe(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, label_smoothing=0.1,
                   ema_decay=0.9)
RECIPE_STEPS = 4
RECIPE_SEED = 11
# Adam's eps 1e-4, as torch_parity.check_train_steps takes it: the Mixer's
# token-mix output bias has a zero gradient (the channel LayerNorm takes it
# out), which float32 leaves at ~5e-9 in an order that differs between the
# dense and the data-parallel sums; eps 1e-8 turns that into ±lr steps
ADAMW = dict(lr=1e-3, weight_decay=0.05, eps=1e-4)


def _sd(sd):
    return {f"sd.{k}": v.detach().float().numpy() for k, v in sd.items()}


def _side(name):
    return FEATURE_CASES[name][2] if name in FEATURE_CASES else PP_CASES[name][2]


def _pipelined(name, mesh, scope):
    """Case ``name`` with a 2-microbatch pipeline runner (the factory's
    ``block_runner=`` unless ``scope``), its other stages' blocks released."""
    runner = pipeline_runner(mesh, microbatches=2, data_axis="data")
    model = build(PORT, name) if scope else build(PORT, name, block_runner=runner)
    with nnf.block_runner_scope(runner if scope else None):
        stages = pipeline_shardings(model, mesh, (1, 3, _side(name), _side(name)))
    init_sharded(model, None, mesh, stages=stages)
    return model, runner


def pp_forward(name, scope):
    def check(mesh):
        model, runner = _pipelined(name, mesh, scope)
        with torch.no_grad(), nnf.block_runner_scope(runner if scope else None):
            logits = model.eval().shard(mesh)(images(name))
        return {"logits": logits.numpy()}
    return check


def _batch(name, mesh, seed=2):
    shard = batch_sharding(mesh)
    return shard({"image": torch.from_numpy(images(name, seed=seed)),
                  "label": torch.from_numpy(labels())})


def pp_train(name, scope, generator_seed=None):
    def check(mesh):
        model, runner = _pipelined(name, mesh, scope)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
        with nnf.block_runner_scope(runner if scope else None):
            loss = make_train_step(model, opt, mesh=mesh)(_batch(name, mesh), gen)
        kept = sum(t.numel() for k, t in model.state_dict().items()
                   if model.pipeline_stages.get(k) is not None)
        return {"loss": np.float64(loss), "block_numel": np.int64(kept),
                **_sd(gather_state_dict(model, mesh))}
    return check


def bn_contract(mesh):
    model, runner = _pipelined("wave_xs", mesh, True)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with nnf.block_runner_scope(runner):
        try:
            make_train_step(model, opt, mesh=mesh)(_batch("wave_xs", mesh))
            message = ""
        except RuntimeError as e:
            message = str(e)
        loss = make_train_step(model, opt, bn_momentum=None, mesh=mesh)(_batch("wave_xs", mesh))
    return {"message": np.array(message), "loss": np.float64(loss)}


def dp_train(name):
    def check(mesh):
        model = build(PORT, name)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        init_sharded(model, opt, mesh, min_dim=2 ** 31)  # the model axis replicates
        loss = make_train_step(model, opt, mesh=mesh)(_batch(name, mesh))
        return {"loss": np.float64(loss), **_sd(model.state_dict())}
    return check


def sp_forward(name, family):
    def check(mesh):
        model = build(PORT, name, block_runner=token_parallel_runner(mesh, family))
        with torch.no_grad():
            return {"logits": model.eval().shard(mesh)(images(name)).numpy()}
    return check


def sp_train(name, family):
    def check(mesh):
        model = build(PORT, name, block_runner=token_parallel_runner(mesh, family))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        init_sharded(model, opt, mesh)
        loss = make_train_step(model, opt, mesh=mesh)(_batch(name, mesh))
        return {"loss": np.float64(loss), **_sd(model.state_dict())}
    return check


def shard_forward(name):
    def check(mesh):
        with torch.no_grad():
            return {"logits": build(PORT, name).eval().shard(mesh)(images(name)).numpy()}
    return check


def _resumable_run(mesh, steps, ckpt_dir=None):
    """``steps`` pipelined AdamW steps of the Mixer (2 stages × 2
    microbatches), from the train example's checkpoints under ``ckpt_dir``
    when given (resumed from the newest, one written after each step);
    returns the last loss and the gathered state dict."""
    from jittor_mlp_tpu_torch.examples.train import checkpoints

    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters(), **ADAMW)
    start, save = 0, None
    if ckpt_dir is not None:
        start, save = checkpoints(ckpt_dir, model, opt, mesh)
    runner = pipeline_runner(mesh, microbatches=2, data_axis="data")
    with nnf.block_runner_scope(runner):
        stages = pipeline_shardings(model, mesh, (1, 3, _side("mixer"), _side("mixer")))
    init_sharded(model, opt, mesh, stages=stages)
    step = make_train_step(model, opt, mesh=mesh)
    loss = None
    with nnf.block_runner_scope(runner):
        for s in range(start, steps):
            loss = step(_batch("mixer", mesh, seed=200 + s))
            if save is not None:
                save(s + 1)
    dist.barrier()  # rank 0's checkpoint is on disk before any rank reads it
    return loss, gather_state_dict(model, mesh)


def pp_resume(mesh):
    """Two pipelined AdamW steps straight through, and the same two cut
    after the first: a checkpoint (the stages' weights and optimizer
    moments), then a new model and optimizer resumed from it."""
    loss, sd = _resumable_run(mesh, 2)
    ckpt = os.path.join(CKPT_ROOT, "pp_resume")
    _resumable_run(mesh, 1, ckpt)
    resumed_loss, resumed_sd = _resumable_run(mesh, 2, ckpt)
    return {"loss": np.float64(loss), "resumed_loss": np.float64(resumed_loss),
            **_sd(sd), **{f"resumed.{k}": v for k, v in _sd(resumed_sd).items()}}


def recipe(mesh):
    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters(), **ADAMW)
    state = tr.init_recipe_state(model, opt, mesh=mesh, recipe=RECIPE)
    step = tr.make_recipe_train_step(model, opt, 8, RECIPE, mesh=mesh)
    out = {}
    for s in range(RECIPE_STEPS):
        state, metrics = step(state, _batch("mixer", mesh, seed=100 + s),
                              torch.Generator().manual_seed(RECIPE_SEED))
        for k, v in metrics.items():
            out[f"{k}{s}"] = np.float64(v)
    out.update(_sd(model.state_dict()))
    out.update({f"ema.{k}": v.numpy() for k, v in state.ema.items()})
    return out


# -- tensor parallelism over the 'model' axis (P = 2) -------------------------

TP_MIN_DIM = 8  # the JAX tests' min_dim: every FF width of the small cases shards
TP_CASES = [*PP_CASES, *(f"shard_{n}" for n in SHARD_CASES)]


def _local_numel(model):
    return sum(t.numel() for t in model.state_dict().values())


def tp_forward(name):
    """``Model.shard(mesh, min_dim=8)``'s f32 forward of the global batch:
    logits, the split sites' counts and the numbers of elements kept."""
    def check(mesh):
        tensor.reset_counts()
        model = build(PORT, name).eval().shard(mesh, min_dim=TP_MIN_DIM)
        with torch.no_grad():
            logits = model(images(name))
        return {"logits": logits.numpy(), "split": tensor.COUNTS["split"],
                "placed": len(model.tp_specs),
                "numel": _local_numel(model),
                "whole": sum(int(np.prod(s)) for s in model.tp_shapes.values())}
    return check


def tp_bf16_and_int8(mesh):
    """The Mixer under TP against the same data-parallel forward unplaced:
    bf16 through the split kernel's twin, and int8 (f32 and bf16 models),
    where the split mode does not apply: the boundary gathers the split
    sites' slices too and the blocks run whole."""
    x = images("mixer")
    out = {}
    for tag, bf16, int8 in (("bf16", True, False), ("int8_f32", False, True),
                            ("int8_bf16", True, True)):
        models = [build(PORT, "mixer").eval() for _ in range(2)]
        if bf16:
            models = [m.to_bf16() for m in models]
        dense, tp = models[0].shard(mesh, min_dim=2 ** 31), models[1].shard(mesh, TP_MIN_DIM)
        modes = contextlib.ExitStack()
        if bf16:
            modes.enter_context(config.bf16_mode())
        if int8:
            modes.enter_context(config.int8_mode())
        with torch.no_grad(), modes:
            want = dense(x)
            tensor.reset_counts()
            got = tp(x)
        out.update({f"{tag}.want": want.float().numpy(), f"{tag}.got": got.float().numpy(),
                    f"{tag}.split": tensor.COUNTS["split"]})
    return out


def tp_train(name, compute_dtype=None):
    def check(mesh):
        model = build(PORT, name)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        init_sharded(model, opt, mesh, min_dim=TP_MIN_DIM)
        tensor.reset_counts()
        loss = make_train_step(model, opt, compute_dtype=compute_dtype, mesh=mesh)(
            _batch(name, mesh))
        return {"loss": np.float64(loss), "split": tensor.COUNTS["split"],
                **_sd(gather_state_dict(model, mesh))}
    return check


def tp_routes(mesh):
    """The Mixer's TP steps on its other routes: f32 under
    ``config.remat_mode()`` (each checkpointed block recomputes inside the
    tensor-parallel scope), and bf16 on the backward-kernel route
    (``config.pallas_bwd``: the split mode does not apply, the boundary
    gathers the split sites' slices and the blocks run whole)."""
    out = {}
    for tag, dtype, mode in (("remat", None, config.remat_mode),
                             ("pallas_bwd", torch.bfloat16, None)):
        model = build(PORT, "mixer")
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        init_sharded(model, opt, mesh, min_dim=TP_MIN_DIM)
        tensor.reset_counts()
        config.pallas_bwd = tag == "pallas_bwd"
        try:
            with mode() if mode else contextlib.nullcontext():
                loss = make_train_step(model, opt, compute_dtype=dtype, mesh=mesh)(
                    _batch("mixer", mesh))
        finally:
            config.pallas_bwd = False
        out.update({f"{tag}.loss": np.float64(loss), f"{tag}.split": tensor.COUNTS["split"],
                    **{f"{tag}.{k}": v for k, v in _sd(gather_state_dict(model, mesh)).items()}})
    return out


def tp_recipe(mesh):
    """The recipe step (mixup, cutmix, EMA) on the Mixer placed at
    ``min_dim=8``: metrics, parameters and the EMA gathered whole."""
    from jittor_mlp_tpu_torch.parallel import _comm

    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters(), **ADAMW)
    init_sharded(model, opt, mesh, min_dim=TP_MIN_DIM)
    state = tr.init_recipe_state(model, opt, mesh=mesh, recipe=RECIPE)
    step = tr.make_recipe_train_step(model, opt, 8, RECIPE, mesh=mesh)
    out = {}
    for s in range(RECIPE_STEPS):
        state, metrics = step(state, _batch("mixer", mesh, seed=100 + s),
                              torch.Generator().manual_seed(RECIPE_SEED))
        for k, v in metrics.items():
            out[f"{k}{s}"] = np.float64(v)
    out.update(_sd(gather_state_dict(model, mesh)))
    group = axis_group(mesh, "model")
    for k, v in state.ema.items():
        spec = model.tp_specs.get(k)
        out[f"ema.{k}"] = (v if spec is None else _comm._gather(v, group, spec.index("model"))
                           ).numpy()
    return out


def tp_adamw_dense(mesh):
    """A TP AdamW step of the Mixer, then its gathered weights and optimizer
    state loaded into a dense model that takes the second step."""
    model = build(PORT, "mixer")
    opt = torch.optim.AdamW(model.parameters(), **ADAMW)
    init_sharded(model, opt, mesh, min_dim=TP_MIN_DIM)
    loss1 = make_train_step(model, opt, mesh=mesh)(_batch("mixer", mesh, seed=300))
    moments = sum(v.numel() for st in opt.state.values() for k, v in st.items() if k != "step")
    sd, osd = gather_state_dict(model, mesh), gather_optimizer_state(opt, model, mesh)
    dense = build(PORT, "mixer")
    dense.load_state_dict(sd)
    dopt = torch.optim.AdamW(dense.parameters(), **ADAMW)
    dopt.load_state_dict(osd)
    b = {"image": torch.from_numpy(images("mixer", seed=301)), "label": torch.from_numpy(labels())}
    loss2 = make_train_step(dense, dopt)(b)
    return {"loss1": np.float64(loss1), "loss2": np.float64(loss2),
            "moments": np.int64(moments), **_sd(dense.state_dict())}


GATHER_SPECS = {"w": (None, "model"), "v": ("model", None, None), "b": ("model",),
                "h": (None, "model")}  # h: a bf16 tensor, its own bucket


def gather_inputs():
    """The whole tensors of ``tp_gather_grad``: w (6, 8), v (4, 3, 2), b (6,)
    in f32 and h (2, 4) in bf16, and an input x (3, 8)."""
    rng = np.random.default_rng(5)
    whole = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for k, shape in (("w", (6, 8)), ("v", (4, 3, 2)), ("b", (6,)), ("h", (2, 4)))}
    whole["h"] = whole["h"].bfloat16()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32))
    return whole, x


def gather_loss(t, x):
    """A loss of all four tensors, whole."""
    return ((x @ t["w"].t() + t["b"]).square().sum() + (t["v"] ** 3).sum()
            + t["h"].float().square().sum())


def tp_gather_grad(mesh):
    """``gather_tp`` and its backward: each rank's slices of w (axis 1), v
    (axis 0), b and a bf16 h, gathered (the f32 ones in one bucket, h in
    its own), a loss of the whole tensors scaled by 1/P (as the mesh step
    scales it): the slices' gradients against the dense ones."""
    group = axis_group(mesh, "model")
    r, size = axis_index(mesh, "model"), 2
    whole, x = gather_inputs()
    pieces = {k: t.chunk(size, GATHER_SPECS[k].index("model"))[r].clone().requires_grad_()
              for k, t in whole.items()}
    got = gather_tp(pieces, GATHER_SPECS, group)
    (gather_loss(got, x) / size).backward()
    out = {"rank": np.int64(r)}
    for k, piece in pieces.items():
        out[f"grad.{k}"] = piece.grad.float().numpy()
        out[f"whole.{k}"] = got[k].detach().float().numpy()
    return out


def tp_reshard(mesh):
    """A Mixer placed on the 2 × 2 mesh (``init_sharded``, ``min_dim=8``),
    then ``Model.shard`` again: on a 4 × 1 mesh (another model group) and at
    the default ``min_dim`` (other specs) it raises, and on the same mesh
    and ``min_dim`` it keeps its slices and runs its forward."""
    model = build(PORT, "mlp_mixer").eval()
    init_sharded(model, None, mesh, min_dim=TP_MIN_DIM)
    out = {}
    for tag, other, min_dim in (("4x1", make_mesh(model_parallel=1), TP_MIN_DIM),
                                ("min_dim", mesh, 512)):
        try:
            model.shard(other, min_dim=min_dim)
            out[tag] = "placed again"
        except ValueError as e:
            out[tag] = str(e)
    with torch.no_grad():
        out["logits"] = model.shard(mesh, min_dim=TP_MIN_DIM)(images("mlp_mixer")).numpy()
    out["numel"] = _local_numel(model)
    return out


def tp_example(mesh):
    """The train example with --model-parallel 2 (tensor parallelism in the
    4-rank world: a 2 × 2 mesh), two steps with a checkpoint after each;
    its last checkpoint loaded into a dense model, whose forward is held to
    the placed model's."""
    from jittor_mlp_tpu_torch.examples.train import main
    from jittor_mlp_tpu_torch.utils.serialization import restore_train_state

    ckpt = os.path.join(CKPT_ROOT, "tp_example")
    model, losses = main(["--device", "cpu", "--model-parallel", "2", "--steps", "2",
                          "--image-size", "16", "--batch", "8", "--ckpt-dir", ckpt,
                          "--ckpt-every", "1"])
    dist.barrier()  # rank 0's checkpoint is on disk before any rank reads it
    dense = build_example_mixer()
    step = restore_train_state(os.path.join(ckpt, "step_00000002"), dense,
                               torch.optim.AdamW(dense.parameters()))
    x = torch.from_numpy(images("mixer", batch=4, seed=9))
    with torch.no_grad():
        got, want = model.eval()(x), dense.eval()(x)
    return {"losses": np.array(losses), "step": np.int64(step), "placed": len(model.tp_specs),
            "split": np.int64(len(model.tp_split)), "got": got.numpy(), "want": want.numpy()}


def build_example_mixer():
    """The train example's default model at --image-size 16, --classes 10."""
    import jittor_mlp_tpu_torch as jt

    return jt.MLPMixerForImageClassification(image_size=16, patch_size=8, d_model=128, depth=6,
                                             num_classes=10, device="cpu")


CHECKS = {
    "dp2pp2": {
        **{f"pp_forward[{n}]": pp_forward(n, scope=True) for n in PP_CASES},
        "pp_forward[mixer]": pp_forward("mixer", scope=False),
        "pp_forward[gmlp]": pp_forward("gmlp", scope=False),
        "pp_forward[asmlp]": pp_forward("asmlp", scope=True),
        "pp_train[mixer]": pp_train("mixer", scope=False),
        "pp_train[gmlp]": pp_train("gmlp", scope=False),
        "pp_train[swin_dp]": pp_train("swin_dp", scope=True, generator_seed=7),
        "pp_resume": pp_resume,
        "bn_contract": bn_contract,
        "dp_train[wave_xs]": dp_train("wave_xs"),
        "sp_forward[mixer]": sp_forward("mixer", "mlp_mixer"),
        "sp_forward[resmlp]": sp_forward("resmlp", "res_mlp"),
        "sp_train[mixer]": sp_train("mixer", "mlp_mixer"),
        **{f"tp_forward[{n}]": tp_forward(n) for n in TP_CASES},
        "tp_bf16_and_int8": tp_bf16_and_int8,
        "tp_train[mixer]": tp_train("mixer"),
        "tp_train[gmlp]": tp_train("gmlp"),
        "tp_train[wave_xs]": tp_train("wave_xs"),
        "tp_train_bf16[mixer]": tp_train("mixer", torch.bfloat16),
        "tp_routes": tp_routes,
        "tp_recipe": tp_recipe,
        "tp_adamw_dense": tp_adamw_dense,
        "tp_gather_grad": tp_gather_grad,
        "tp_reshard": tp_reshard,
        "tp_example": tp_example,
    },
    "dp2": {
        "recipe": recipe,
        # WaveMLP-T and CycleMLP-B1 hold 512-wide tensors, which the JAX
        # heuristic shards over a 'model' axis of 2: a 2 × 1 mesh
        **{f"shard_forward[{n}]": shard_forward(f"shard_{n}")
           for n in ("wave_mlp", "swin_mlp", "cycle_mlp")},
    },
}
MODEL_PARALLEL = {"dp2pp2": 2, "dp2": 1}
CKPT_ROOT = None  # the shared directory of the checkpoints, set by main


def main(world, rank, size, port, out_dir):
    global CKPT_ROOT
    CKPT_ROOT = os.path.join(out_dir, f"{world}.ckpt")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(model_parallel=MODEL_PARALLEL[world])
    out = {"mesh/coord": np.array([axis_index(mesh, "data"), axis_index(mesh, "model")])}
    failed = False
    for name, check in CHECKS[world].items():
        try:
            for k, v in check(mesh).items():
                out[f"{name}/{k}"] = np.asarray(v)
        except Exception:
            out[f"{name}/error"] = np.array(traceback.format_exc())
            failed = True
            break
    np.savez(os.path.join(out_dir, f"{world}.{rank}.npz"), **out)
    if failed:
        os._exit(1)  # the peers' collectives fail within the group's timeout
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
