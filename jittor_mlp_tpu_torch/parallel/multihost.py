"""Multi-process bring-up and per-rank batch feeding (counterpart of
``jittor_mlp_tpu/parallel/multihost.py``).

The JAX package runs one process per host over that host's devices; the
port runs one process per device, started by ``torchrun``. ``initialize()``
joins them into one ``torch.distributed`` world (NCCL on cards, gloo on the
CPU, when asked for) from torchrun's environment, ``make_pod_mesh`` builds
the ('data', 'model') mesh with every model group inside one node (its
collectives run every layer and stay on NVLink), ``process_batch_size``
and ``process_batch_offset`` give a rank's rows of the global batch (the
one row split of the port: ``parallel.train.batch_sharding``,
``Model.shard`` and the train example take theirs from it), and
``global_batch`` puts them on the rank's device; no rank needs to
materialize the global batch.

    multihost.initialize()                      # no-op outside torchrun
    mesh = multihost.make_pod_mesh(model_parallel=2)
    rows = multihost.process_batch_size(mesh, 256)
    off = multihost.process_batch_offset(mesh, 256)
    batch = multihost.global_batch(mesh, {"image": imgs[off:off + rows],
                                          "label": labels[off:off + rows]})

    torchrun --nproc-per-node=8 -m jittor_mlp_tpu_torch.examples.train ...

``run_local_selftest()`` spawns gloo processes on this machine and holds
one data-parallel step of a small Mixer to the dense single-process step;
``python -m jittor_mlp_tpu_torch.parallel.multihost --selftest`` prints it.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size, make_mesh, mesh_device

_POD_ENV_MARKERS = (
    # explicit-coordinator environments of the JAX package: when one is set,
    # a process is part of a multi-process run
    "MEGASCALE_COORDINATOR_ADDRESS",
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def _looks_like_pod():
    """True where the environment says this process is one of several: the
    JAX package's markers (a coordinator address, several TPU workers,
    SLURM / Open MPI / PMI task counts above 1) and ``WORLD_SIZE > 1``."""
    if any(os.environ.get(m) for m in _POD_ENV_MARKERS):
        return True
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        return True
    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "WORLD_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize(backend="nccl", timeout=600):
    """Join the world of processes that ``torchrun`` started.

    With torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``) this calls ``init_process_group`` with
    ``backend`` and ``timeout`` seconds: NCCL, on the rank's card
    (``cuda:{LOCAL_RANK}``), and RuntimeError where no card is visible;
    gloo, on the CPU, only when the caller asks for it. Without that
    environment, a single process: a no-op, unless a pod marker says this
    process is one of several (``_looks_like_pod``), where it raises rather
    than train unsynced. Safe to call more than once."""
    if dist.is_initialized():
        return
    if not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        if _looks_like_pod():
            missing = [k for k in _TORCHRUN_ENV if not os.environ.get(k)]
            raise RuntimeError(
                f"this process looks like one of several (multi-process environment "
                f"markers set) but torchrun's {', '.join(missing)} are missing: refusing "
                f"to train unsynced; start it with torchrun")
        return
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card, and none is visible to "
                               "this process; pass backend='gloo' to run on the CPU")
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    elif backend != "gloo":
        raise ValueError(f"backend={backend!r}: 'nccl' (cards) or 'gloo' (the CPU)")
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout))


def make_pod_mesh(model_parallel=1):
    """The ('data', 'model') mesh over the world, each model group inside one
    node: torchrun numbers a node's ranks contiguously, and ``make_mesh``
    puts ``model_parallel`` consecutive ranks in a model group, so a node's
    ``LOCAL_WORLD_SIZE`` must divide by ``model_parallel`` (else
    ValueError)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local % model_parallel:
        raise ValueError(f"a node runs {local} ranks, not divisible by "
                         f"model_parallel={model_parallel}: model groups would cross nodes")
    return make_mesh(model_parallel=model_parallel)


def process_batch_size(mesh, global_batch_size):
    """This rank's share of the global batch: the rows of its data index
    (each rank is one device, so one data index)."""
    n_data = axis_size(mesh, "data")
    if global_batch_size % n_data:
        raise ValueError(f"global batch {global_batch_size} does not split over {n_data} "
                         f"data ranks")
    return global_batch_size // n_data


def process_batch_offset(mesh, global_batch_size):
    """Row offset of this rank's share within the global batch: its data
    index times the share (the ranks of a model group share their rows)."""
    return axis_index(mesh, "data") * process_batch_size(mesh, global_batch_size)


def global_batch(mesh, local_arrays):
    """This rank's rows (``local_arrays``: {name: numpy array or tensor})
    as tensors on its device, the port's counterpart of a global array
    sharded over 'data'."""
    dev = mesh_device(mesh)
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(dev) for k, v in local_arrays.items()}


# ---------------------------------------------------------------------------
# Executable self-test: real gloo processes on this machine.
# ---------------------------------------------------------------------------

_SELFTEST_MIXER = dict(d_model=64, depth=2, patch_size=4, image_size=8, num_classes=16,
                       expansion_factor=4)


def _selftest_step(world, mesh=None):
    """One AdamW step of the JAX self-test's small Mixer on a seeded global
    batch of 2 rows per process of ``world`` (without a mesh: the dense
    single-process step on all of them); returns (loss, parameter norm)."""
    import jittor_mlp_tpu_torch as jt

    from .train import init_sharded, make_train_step

    model = jt.MLPMixerForImageClassification(**_SELFTEST_MIXER, device="cpu")
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
    n_global = 2 * world
    rng = np.random.default_rng(5)
    images = rng.standard_normal((n_global, 3, 8, 8)).astype(np.float32)
    labels = rng.integers(0, 16, size=(n_global,)).astype(np.int64)
    if mesh is None:
        batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    else:
        init_sharded(model, optimizer, mesh)
        n, off = process_batch_size(mesh, n_global), process_batch_offset(mesh, n_global)
        batch = global_batch(mesh, {"image": images[off:off + n], "label": labels[off:off + n]})
    loss = make_train_step(model, optimizer, mesh=mesh)(batch)
    norm = torch.sqrt(sum(p.detach().double().square().sum() for p in model.parameters()))
    return float(loss), float(norm)


def _selftest_worker(out_path, timeout, world):
    """The body of one self-test process of ``world`` (``RANK`` and the rest
    of torchrun's environment set by the launcher; none for the
    reference)."""
    import json

    torch.set_num_threads(1)
    mesh = None
    if os.environ.get("RANK") is not None:
        initialize(backend="gloo", timeout=timeout)
        mesh = make_pod_mesh(model_parallel=1)
    loss, norm = _selftest_step(world, mesh)
    with open(out_path, "w") as f:
        json.dump({"loss": loss, "param_norm": norm,
                   "world": dist.get_world_size() if mesh is not None else 1}, f)
    if mesh is not None:
        dist.destroy_process_group()


def run_local_selftest(num_processes=2, timeout=120):
    """Launch ``num_processes`` gloo processes of one data-parallel step and
    one single-process dense reference over the same global batch; assert
    that each process's loss and post-step parameter norm are within 1e-5
    (relative) of the reference's. A process that fails or outlives
    ``timeout`` seconds fails the self-test with its stderr. Returns
    {"w0": ..., "ref": ...}."""
    import json
    import socket
    import subprocess
    import sys
    import tempfile

    with socket.socket() as s:  # a free loopback port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    results = {}
    with tempfile.TemporaryDirectory() as td:
        procs = []
        for tag, rank in [(f"w{i}", i) for i in range(num_processes)] + [("ref", None)]:
            env = {k: v for k, v in os.environ.items()
                   if k not in _TORCHRUN_ENV and k != "LOCAL_WORLD_SIZE"}
            env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
            if rank is not None:
                env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(num_processes),
                           LOCAL_WORLD_SIZE=str(num_processes), MASTER_ADDR="localhost",
                           MASTER_PORT=str(port))
            out = os.path.join(td, f"{tag}.json")
            code = ("from jittor_mlp_tpu_torch.parallel import multihost as mh; "
                    f"mh._selftest_worker({out!r}, {timeout}, {num_processes})")
            procs.append((tag, out, subprocess.Popen(
                [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        try:
            for tag, out, p in procs:
                try:
                    so, se = p.communicate(timeout=timeout)
                except subprocess.TimeoutExpired:
                    p.kill()
                    so, se = p.communicate()
                    raise AssertionError(f"{tag} timed out after {timeout} s\nstderr:{se}")
                assert p.returncode == 0, f"{tag} failed rc={p.returncode}\nstderr:{se}"
                with open(out) as f:
                    results[tag] = json.load(f)
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    ref = results["ref"]
    for i in range(num_processes):
        w = results[f"w{i}"]
        assert w["world"] == num_processes, w
        for key in ("loss", "param_norm"):
            rel = abs(w[key] - ref[key]) / max(1.0, abs(ref[key]))
            assert rel <= 1e-5, (f"process {i} {key} {w[key]!r} vs single-process "
                                 f"{ref[key]!r} (rel {rel:.2e})")
    return results


if __name__ == "__main__":
    import sys as _sys

    if len(_sys.argv) >= 2 and _sys.argv[1] == "--selftest":
        print(run_local_selftest())
    else:
        raise SystemExit("usage: python -m jittor_mlp_tpu_torch.parallel.multihost --selftest")
