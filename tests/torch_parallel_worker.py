"""One rank of the gloo worlds of ``test_torch_parallel_dist.py``.

    python tests/torch_parallel_worker.py WORLD RANK SIZE PORT OUT_DIR

runs every check of world WORLD ("dp2pp2": 4 ranks, a 2 × 2 ('data',
'model') mesh; "dp2": 2 ranks, a 2 × 1 mesh) in a gloo process group of
SIZE ranks on a loopback PORT, and writes what each check returns to
``OUT_DIR/WORLD.RANK.npz`` as ``check/field`` arrays (``check/error`` with
the traceback where a check raised: the rank then stops, and its peers'
collectives fail within the group's timeout). Imports neither JAX nor the
JAX package: the parent test holds the results to both packages' dense
references.
"""

import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parallel_cases import FEATURE_CASES, PP_CASES, build, images, labels  # noqa: E402

import jittor_mlp_tpu_torch.train_recipes as tr  # noqa: E402
from jittor_mlp_tpu_torch.core import nnf  # noqa: E402
from jittor_mlp_tpu_torch.parallel import (gather_state_dict, init_sharded,  # noqa: E402
                                           make_mesh, make_train_step, pipeline_runner,
                                           pipeline_shardings, token_parallel_runner)
from jittor_mlp_tpu_torch.parallel.mesh import axis_index  # noqa: E402
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
