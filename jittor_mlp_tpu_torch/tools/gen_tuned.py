"""Regenerate ``jittor_mlp_tpu_torch/tuned.py`` from the port's sweeps
(counterpart of the repository's ``tools/gen_tuned.py``, with
``tools/merge_train_sweep.py`` folded in).

The sweeps are the harness's records (``tools/compare.py``): the train sweep
(``--all --train --try-remat``) measures, per model of CONFIGS, whether block
rematerialization beats the plain backward and at which batch; the serving
sweep (``--all --int8 --serving-numerics``) measures bf16 and dynamic-int8
throughput and their numerics against the f32 forward. Run from the
repository root:

    python -m jittor_mlp_tpu_torch.tools.gen_tuned [--train PATH] [--serving PATH] [--out PATH]

Where a model has several train records, the best ``train_fps`` is kept.
The serving dtype follows the JAX package's rule, unchanged:
- "f32" when bf16's top-1 agreement with the f32 forward is below 0.90;
- "int8" when dynamic W8A8 is ≥ 1.05× the bf16 img/s and keeps ≥ 0.98
  top-1 agreement with bf16;
- "bf16" otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .compare import CONFIGS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_SWEEP = os.path.join(_PKG, "sweeps", "train_h100.jsonl")
SERVING_SWEEP = os.path.join(_PKG, "sweeps", "serving_h100.jsonl")
OUT = os.path.join(_PKG, "tuned.py")

F32_BELOW = 0.90  # bf16 top-1 agreement with f32 under which a model serves in f32
INT8_SPEEDUP, INT8_AGREE = 1.05, 0.98  # int8 img/s over bf16's, its agreement with bf16

HEADER = '''"""Measured best-known train/serve settings per zoo model, for the port (GENERATED).

Regenerate with ``python -m jittor_mlp_tpu_torch.tools.gen_tuned`` after
updating ``jittor_mlp_tpu_torch/sweeps/train_h100.jsonl`` or
``serving_h100.jsonl`` (``python -m jittor_mlp_tpu_torch.tools.compare``);
do not edit the tables by hand.

Every row was measured on
{cards},
at the full widths of the harness's CONFIGS, with seed-0 weights.

``TRAIN``: bf16 mixed-precision training (f32 master weights, AdamW) through
``parallel.train.make_train_step``:
- ``remat``: whether checkpointing every block (``config.remat_mode()``)
  gave more img/s than the plain backward (or the plain step did not fit);
- ``batch``: the batch the number was measured at;
- ``img_s``: that training throughput, for provenance.

``SERVE``: the serving dtype, by the JAX package's rule on the serving
sweep: "f32" where bf16's top-1 agreement with the f32 forward is below
0.90 (64 images); "int8" (dynamic W8A8) where it is at least 1.05x the
bf16 img/s and keeps at least 0.98 agreement with bf16; "bf16" otherwise.
The img/s (b256) and agreements are the measurements behind each row.

``Predictor`` resolves its default serving dtype through
``serve_settings(name)``; pass ``bf16=``/``compute=`` to override.
``train_settings(name)`` / ``serve_settings(name)`` resolve either a sweep
key ("mlp_mixer") or a factory name ("MLPMixerForImageClassification") and
return None for a model without a row.
"""

'''

FOOTER = '''


def train_settings(name):
    """Best-known train settings for ``name`` (keys ``factory, remat,
    batch, img_s``), or None."""
    by_factory = {rec["factory"]: rec for rec in TRAIN.values()}
    return TRAIN.get(name) or by_factory.get(name)


def serve_settings(name):
    """Serving recommendation for ``name`` (``dtype`` "bf16"/"int8"/"f32"
    plus the measurements behind it), or None."""
    by_factory = {rec["factory"]: rec for rec in SERVE.values()}
    return SERVE.get(name) or by_factory.get(name)
'''


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def factory(key):
    _, ref_cls, our_name, _ = CONFIGS[key]
    return our_name or ref_cls


def serve_row(record):
    """The SERVE row of one serving record: the dtype by the rule, and the
    measurements behind it."""
    bf16_fps, int8_fps = float(record["fps"]), float(record.get("int8_fps", 0.0))
    bf16_agree = float(record.get("bf16_argmax_agree", 1.0))
    int8_vs_bf16 = float(record.get("int8_argmax_agree_vs_bf16", 0.0))
    if bf16_agree < F32_BELOW:
        dtype = "f32"
    elif int8_fps >= INT8_SPEEDUP * bf16_fps and int8_vs_bf16 >= INT8_AGREE:
        dtype = "int8"
    else:
        dtype = "bf16"
    return {
        "factory": factory(record["model"]),
        "dtype": dtype,
        "bf16_img_s": round(bf16_fps, 1),
        "int8_img_s": round(int8_fps, 1),
        "bf16_argmax": round(bf16_agree, 4),
        "int8_argmax": round(float(record.get("int8_argmax_agree", 0.0)), 4),
    }


def serve_rows(records):
    """{key: SERVE row} of the serving records of CONFIGS' models (records
    without a forward throughput, or of other runs, such as A/B records
    with an "arm", are skipped; a later record of a model replaces an
    earlier one)."""
    return {r["model"]: serve_row(r) for r in records
            if "arm" not in r and "fps" in r and r["model"] in CONFIGS}


def train_rows(records):
    """{key: TRAIN row} of the train records, the best ``train_fps`` of each
    model (records without one, such as a ``train_error``, are skipped)."""
    best = {}
    for r in records:
        if "train_fps" in r and r["model"] in CONFIGS:
            if r["model"] not in best or r["train_fps"] > best[r["model"]]["train_fps"]:
                best[r["model"]] = r
    return {key: {"factory": factory(key), "remat": bool(r.get("train_remat", False)),
                  "batch": int(r.get("train_batch", 32)), "img_s": round(float(r["train_fps"]), 1)}
            for key, r in best.items()}


def cards(records):
    """The cards the records were measured on, "name at limit" each, in
    order of first appearance; ValueError for a record that names none."""
    out = []
    for r in records:
        if not r.get("card") or not r.get("power_limit"):
            raise ValueError(f"record of {r.get('model')!r} names no card and power limit")
        c = f"{r['card']} at {r['power_limit']}"
        if c not in out:
            out.append(c)
    return out


def render(train_records, serving_records):
    """The text of the generated tuned.py."""
    train, serve = train_rows(train_records), serve_rows(serving_records)
    lines = ["TRAIN = {"]
    for key in sorted(train):
        rec = train[key]
        lines.append(f'    "{key}": {{"factory": "{rec["factory"]}", "remat": {rec["remat"]}, '
                     f'"batch": {rec["batch"]}, "img_s": {rec["img_s"]}}},')
    lines += ["}", "", "SERVE = {"]
    for key in sorted(serve):
        rec = serve[key]
        lines.append(f'    "{key}": {{"factory": "{rec["factory"]}", "dtype": "{rec["dtype"]}", '
                     f'"bf16_img_s": {rec["bf16_img_s"]}, "int8_img_s": {rec["int8_img_s"]}, '
                     f'"bf16_argmax": {rec["bf16_argmax"]}, '
                     f'"int8_argmax": {rec["int8_argmax"]}}},')
    lines.append("}")
    header = HEADER.format(cards=" and ".join(cards(train_records + serving_records)))
    return header + "\n".join(lines) + FOOTER


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", default=TRAIN_SWEEP, help="train sweep (JSON lines)")
    ap.add_argument("--serving", default=SERVING_SWEEP, help="serving sweep (JSON lines)")
    ap.add_argument("--out", default=OUT, help="the module to write")
    args = ap.parse_args(argv)
    train, serving = read_jsonl(args.train), read_jsonl(args.serving)
    text = render(train, serving)
    with open(args.out, "w") as f:
        f.write(text)
    rows, serve = train_rows(train), serve_rows(serving)
    n_dt = {d: sum(r["dtype"] == d for r in serve.values()) for d in ("bf16", "int8", "f32")}
    print(f"wrote {args.out}: {len(rows)} train rows ({sum(r['remat'] for r in rows.values())} "
          f"remat), {len(serve)} serve rows {n_dt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
