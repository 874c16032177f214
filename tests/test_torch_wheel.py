"""The port runs from an installed wheel: the wheel carries every source the
port builds (the CUDA kernels, the native host libraries) and its sweeps,
and installed, every library resolves to a path in the per-user cache, not
inside the installed package. A checkout keeps ``build/`` at its root.

The wheel is built offline from a copy of the package in a temporary
directory, so no ``build/`` or ``*.egg-info`` lands in the checkout.
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import pytest

from jittor_mlp_tpu_torch.data import loader
from jittor_mlp_tpu_torch.ops.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "jittor_mlp_tpu_torch")

# run with the installed copy on PYTHONPATH: every kernel library's path,
# the native libraries' paths and the build roots, as JSON
PROBE = r"""
import importlib, json, os, pkgutil
import jittor_mlp_tpu_torch as jt
from jittor_mlp_tpu_torch.data import loader
from jittor_mlp_tpu_torch.ops import kernels
from jittor_mlp_tpu_torch.ops.kernels import _build

libs = {}
for info in pkgutil.iter_modules(kernels.__path__):
    mod = importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{info.name}")
    for value in vars(mod).values():
        for lib in value.values() if isinstance(value, dict) else [value]:
            if isinstance(lib, _build.Library):
                libs[lib.name] = [_build.library_path(lib.name, lib.sources), lib.sources]
print(json.dumps({
    "package": os.path.dirname(jt.__file__),
    "kernels": libs,
    "native": [loader.library_path(n, []) for n in ("fastloader", "decode")],
    "build_dirs": [_build.BUILD_DIR, loader.BUILD_DIR],
}))
"""


def _sources_named():
    """csrc/ files of every kernel library, every header, and the native
    host sources: what the port builds."""
    import importlib
    import pkgutil

    from jittor_mlp_tpu_torch.ops import kernels

    names = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"jittor_mlp_tpu_torch.ops.kernels.{info.name}")
        for value in vars(mod).values():
            for lib in value.values() if isinstance(value, dict) else [value]:
                if isinstance(lib, _build.Library):
                    names.update(f"csrc/{s}" for s in lib.sources)
    names.update(f"csrc/{f}" for f in os.listdir(os.path.join(PKG, "csrc")) if f.endswith(".cuh"))
    names.update(f"data/native/{n}.cpp" for n in ("fastloader", "decode"))
    return names


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    shutil.copy(os.path.join(ROOT, "pyproject.toml"), src)
    ignore = shutil.ignore_patterns("__pycache__", "*.so")
    for pkg in ("jittor_mlp_tpu", "jittor_mlp_tpu_torch"):
        shutil.copytree(os.path.join(ROOT, pkg), src / pkg, ignore=ignore)
    res = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
                          "--no-deps", "--no-index", "-q", "-w", str(tmp / "dist"), str(src)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    (path,) = (tmp / "dist").glob("*.whl")
    return path


def test_wheel_holds_every_source_the_port_builds(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    want = _sources_named()
    assert {"csrc/mixer_block.cu", "csrc/gemm_sm90.cuh", "data/native/decode.cpp"} <= want
    missing = sorted(n for n in want if f"jittor_mlp_tpu_torch/{n}" not in names)
    assert not missing, missing
    for sweep in ("train_h100.jsonl", "serving_h100.jsonl"):
        assert f"jittor_mlp_tpu_torch/sweeps/{sweep}" in names
    # the checkout got nothing from the build
    assert not any(f.endswith(".egg-info") for f in os.listdir(ROOT))


def test_installed_copy_resolves_every_library_in_the_user_cache(wheel, tmp_path):
    site = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(site)
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JMT_KERNEL_BUILD_DIR", "JMT_NATIVE_BUILD_DIR")}
    env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache))
    run = subprocess.run([sys.executable, "-c", PROBE], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["package"] == str(site / "jittor_mlp_tpu_torch")
    kernels = cache / "jittor_mlp_tpu_torch" / "kernels"
    assert got["build_dirs"] == [str(kernels), str(cache / "jittor_mlp_tpu_torch" / "native")]
    assert len(got["kernels"]) >= 12
    for name, (path, sources) in got["kernels"].items():
        assert os.path.dirname(path) == str(kernels) and os.path.basename(path).startswith(name)
        for s in sources:
            assert (site / "jittor_mlp_tpu_torch" / "csrc" / s).exists(), s
    for path in got["native"]:
        assert os.path.dirname(path) == str(cache / "jittor_mlp_tpu_torch" / "native")
    # the overrides win over the cache
    env.update(JMT_KERNEL_BUILD_DIR=str(tmp_path / "k"), JMT_NATIVE_BUILD_DIR=str(tmp_path / "n"))
    run = subprocess.run([sys.executable, "-c", PROBE], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1])["build_dirs"] == [
        str(tmp_path / "k"), str(tmp_path / "n")]


def test_checkout_builds_under_build_at_its_root(monkeypatch):
    monkeypatch.delenv("JMT_KERNEL_BUILD_DIR", raising=False)
    assert _build.build_root("kernels", "JMT_KERNEL_BUILD_DIR") == os.path.join(
        ROOT, "build", "kernels")
    assert _build.build_root("native", "JMT_NATIVE_BUILD_DIR") == os.path.join(
        ROOT, "build", "native")
    if not os.environ.get("JMT_NATIVE_BUILD_DIR"):
        assert loader.BUILD_DIR == os.path.join(ROOT, "build", "native")
    monkeypatch.setenv("JMT_KERNEL_BUILD_DIR", "/elsewhere")
    assert _build.build_root("kernels", "JMT_KERNEL_BUILD_DIR") == "/elsewhere"
