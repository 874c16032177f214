"""Nothing a run imports is ``jax``, ``jaxlib``, ``flax`` or the JAX package
(top-level names compared whole: the port's own name begins with the JAX
package's), and the references import nothing of the port."""

import ast
import glob
import json
import os
import subprocess
import sys

from bench_h100 import harness

HERE = os.path.join(harness.ROOT, "bench_h100")


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["jittor_mlp_tpu_torch", "jittor_mlp_tpu_torch.ops",
                                      "jaxtyping", "flaxen", "torch"]) == []
    assert harness.forbidden_modules(["jittor_mlp_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "jittor_mlp_tpu"]


def test_a_run_loads_nothing_forbidden():
    """A whole small run on the CPU, every cell's traffic kind, traced, in a
    process of its own: then no forbidden module is loaded."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{harness.ROOT!r}, {os.path.dirname(__file__)!r}]\n"
        "import bench_small\n"
        "from bench_h100 import harness\n"
        "bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')\n"
        "for name in [w['name'] for w in bench['workloads']]:\n"
        "    bench_small.run(bench_small.cell(name), seconds=0.2, trace=1)\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_references_import_nothing_of_the_port():
    files = glob.glob(os.path.join(HERE, "reference", "*.py"))
    assert len(files) >= 3
    for f in files:
        for name in _imports(f):
            top = name.lstrip(".").split(".")[0]
            assert top in ("", "__future__", "common", "contextlib", "math", "torch"), (f, name)
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r})\n"
            "import bench_h100.reference.common, bench_h100.reference.mixer_b16, "
            "bench_h100.reference.resmlp_s24\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jittor_mlp_tpu_torch', 'jittor_mlp_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_harness_sources_import_no_jax():
    for f in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        for name in _imports(f):
            assert name.lstrip(".").split(".")[0] not in harness.FORBIDDEN, (f, name)
