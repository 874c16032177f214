"""One run of one cell: the cell, its configuration, its traffic mix, its
reference, its limits and its per-layer readers found by name from
``BENCHMARK.json``; set-up, the measured window (traced with ``--trace
1``), the peak memory, the correctness check, and the result line.

Where things live, by name (``bench_h100/`` below):

- ``configs/<config>.json``: the configuration (``factory``, ``args``,
  ``reference``, the weight draw under ``assumed``);
- ``reference/<reference>.py``: its plain float32 forward, the weight
  specs and the counts of products and bytes;
- ``traffic/<traffic>.json``: the mix, read by ``loads.KINDS[kind]``;
- ``limits/<cell>.json``: {number: limit} of the correctness check;
- ``metrics/<metric>.py``: ``read(run)`` of a per-layer metric, None where
  the run holds nothing to read;
- ``peaks.json``: the published peaks of each card, by the name the card
  reports.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "jittor_mlp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "jittor_mlp_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole (the port's own name begins with the JAX
    package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_module(here, folder, name):
    """``<here>/<folder>/<name>.py`` as ``bench_h100.<folder>.<name>``."""
    full = f"bench_h100.{folder}.{name}"
    spec = importlib.util.spec_from_file_location(full, os.path.join(here, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one cell's run needs, found by name."""

    def __init__(self, name, root=ROOT):
        here = os.path.join(root, "bench_h100")
        self.bench = load_json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
        self.name, self.workload = name, cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.cfg = load_json(root, self.config_entry["file"])
        self.traffic = load_json(here, "traffic", f"{self.workload['traffic']}.json")
        self.ref = load_module(here, "reference", self.cfg["reference"])
        limits = os.path.join(here, "limits", f"{name}.json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}
        self.end_to_end = [m for m in self.bench["end_to_end"] if applies(m, name)]
        self.per_layer = [m for m in self.bench["per_layer"] if applies(m, name)]
        self.readers = {m["name"]: load_module(here, "metrics", m["name"]).read
                        for m in self.per_layer}
        self.peaks_table = load_json(here, "peaks.json")

    def peaks(self, kind):
        return next((v for k, v in self.peaks_table.items() if k in kind), None)


class Run:
    """The state of one run, which the loads and the readers see."""

    def __init__(self, cell, seed, device, program, traffic=None, t_start=None):
        import torch

        self.cell, self.seed, self.t_start = cell, seed, t_start
        self.setup_s = None
        self.device = torch.device(device)
        self.program = program
        self.cfg, self.ref = cell.cfg, cell.ref
        self.traffic = traffic if traffic is not None else cell.traffic
        self.window = self.trace = self.peaks = None
        self.marks = []

    def mark(self, what):
        """Note how far set-up has come (seconds since the process's start)."""
        if self.t_start is not None:
            self.marks.append(f"{what} {time.perf_counter() - self.t_start:.3f}")

    def setup_done(self):
        """Set-up ends here: from the process's start (``t_start``, on the
        ``time.perf_counter`` clock) to the window's start."""
        if self.t_start is not None:
            self.setup_s = time.perf_counter() - self.t_start
            self.note(f"set-up s: {'; '.join(self.marks)}; warmed up {self.setup_s:.3f}")

    def note(self, msg):
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)


def judge(numbers, limits):
    """{number: {"value", "limit"}} of each number the cell's limits name,
    and whether each is within its limit (one missing, or not finite,
    fails; no limits at all fail)."""
    out = {k: {"value": numbers.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
    ok = bool(limits) and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                              for v in out.values())
    return out, ok


def drive(run, seconds, trace):
    """Set-up, window, peak memory, what the check needs of the program's
    state, free, check. Returns (window result, check numbers, peak
    bytes); ``run.trace`` holds the reduced trace when ``trace``."""
    import torch

    from . import loads
    from . import trace as tr

    load = loads.KINDS[run.traffic["kind"]](run)
    load.setup()
    run.setup_done()
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(run.device)
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(tr.WINDOW_SPAN):
                window = load.window(seconds)
                if cuda:
                    torch.cuda.synchronize(run.device)
        run.trace = tr.reduce(prof)
        del prof
        run.note(f"trace events by kind: {run.trace.kinds}")
    else:
        window = load.window(seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    load.finish()
    load.free()
    if cuda:
        torch.cuda.empty_cache()
    numbers = load.check()
    run.window = window
    return window, numbers, peak


def result_line(run, window, numbers, peak, trace, kind, count):
    """The contract's JSON object; ``check`` comes last."""
    cell = run.cell
    run.note(f"numbers of the check: {json.dumps(numbers)}")
    checked, ok = judge(numbers, cell.limits)
    correct = ok and window["failed"] == 0
    metrics = {}
    if trace:
        run.peaks = cell.peaks(kind)
        for m in cell.per_layer:
            v = cell.readers[m["name"]](run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(window["end_to_end"], setup_s=run.setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"{m['name']} is not measured by traffic kind "
                               f"{run.traffic['kind']!r}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": count, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["check"] = checked
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    if not os.path.isfile(os.path.join(ROOT, PROGRAM, "__init__.py")):
        print(f"the program ({PROGRAM}/) is not in this checkout", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s): is_available() "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    program = importlib.import_module(PROGRAM)
    importlib.import_module(f"{PROGRAM}.parallel")
    run = Run(cell, args.seed, "cuda:0", program, t_start=t_start)
    run.mark("imports")
    window, numbers, peak = drive(run, args.seconds, args.trace)
    out = result_line(run, window, numbers, peak, args.trace,
                      torch.cuda.get_device_name(0), chips)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}", file=sys.stderr)
        return 4
    print(f"correct {out['correct']} failed {out['failed']} of {out['attempted']}",
          file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
