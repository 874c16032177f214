"""Export every family of the port on the card with ``deploy`` and report
which ones ``torch.export`` takes.

Each model of chip_smoke.py's phase 8 (``FAMILIES``, compare.py's widths,
full depth) and the four kernel models (Mixer-B/16, ResMLP-S24, gMLP-S,
AS-MLP-T) is built on the card from seed 0 in bf16 (eval), exported with
``deploy.save_exported`` at b8, loaded with ``deploy.load_exported`` and run
on one seeded batch: the program's logits must equal the eager forward's
bit for bit (NaN where the eager forward has NaN: the BatchNorm families'
statistics are the draw's). A family that does not export is reported with
the first line of its error; the export's warnings are recorded, not shown.
Run from the repository root:

    python -m jittor_mlp_tpu_torch.tools.export_zoo [--model vip sequencer ...] [--out F]

Prints one line per model and writes the records to ``--out`` (by default
``build/export_zoo.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import torch


def models():
    """name → (title, factory, kwargs): the four kernel models, then phase 8's."""
    import chip_smoke as cs

    out = {
        "mlp_mixer": ("Mixer-B/16", "MLPMixerForImageClassification", cs.MIXER_B16),
        "res_mlp": ("ResMLP-S24", "ResMLPForImageClassification", cs.RESMLP_S24),
        "g_mlp": ("gMLP-S", "gMLPForImageClassification", cs.GMLP_S),
        "as_mlp": ("AS-MLP-T", "AS_MLP", cs.AS_MLP_T),
    }
    out.update({k: v[:3] for k, v in cs.FAMILIES.items()})
    return out


def build(factory, kwargs):
    import jittor_mlp_tpu_torch as jt

    fn = jt
    for part in factory.split("."):
        fn = getattr(fn, part)
    return fn(**kwargs).to_bf16().eval()


def export_one(title, factory, kwargs, tmp, batch=8):
    from jittor_mlp_tpu_torch import deploy

    model = build(factory, kwargs)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, 3, 224, 224, generator=g, device="cuda").bfloat16()
    rec = {"model": title}
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            path = deploy.save_exported(model, os.path.join(tmp, "m.pt2"), batch_size=batch,
                                        dtype=torch.bfloat16)
        rec["export_s"] = time.perf_counter() - t0
        rec["export_warnings"] = [str(w.message).splitlines()[0][:160] for w in caught]
        fwd = deploy.load_exported(path)
        with torch.inference_mode():
            want = model.forward(x)
        got = fwd(x)
        torch.cuda.synchronize()
        rec["bit_equal"] = bool(torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
                                and torch.equal(got.isnan(), want.isnan()))
        rec["exports"] = True
        os.remove(path)
    except Exception as e:  # the report names the family and its error
        rec["exports"] = False
        rec["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300] if str(e) else ''}"
    del model
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", nargs="*", default=None)
    ap.add_argument("--out", default=os.path.join("build", "export_zoo.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("export_zoo: no CUDA card")
    sys.path.insert(0, os.getcwd())  # chip_smoke.py at the repository root
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    table = models()
    names = args.model or list(table)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            rec = {"name": name, **export_one(*table[name], tmp)}
            out.append(rec)
            print(f"[export] {json.dumps(rec)}  [{card}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "results": out}, f, indent=1)
    failed = [r["name"] for r in out if not (r["exports"] and r.get("bit_equal"))]
    print(f"[export] {len(out) - len(failed)} of {len(out)} export and run bit-equal; "
          f"not: {failed}", flush=True)


if __name__ == "__main__":
    main()
