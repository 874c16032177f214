"""The general traffic generator: one class per kind of traffic file
(``traffic/<mix>.json``'s ``kind``), each of which builds the system under
test from the configuration and the seed, drives it through the measured
window and hands back what the window produced for the correctness check.

- ``closed``: one client calling ``Predictor.predict`` back to back on
  batches from a pool drawn from the seed (offline batch classification);
- ``train``: ``make_train_step`` called back to back on batches made on the
  card from the seed.

Every kind takes its parameters from its traffic file, so a new mix of an
existing kind is a data file. The program sees only the inputs made here.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .reference import common


class Load:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic, self.ref = run.cfg, run.traffic, run.ref
        self.device = run.device

    # -- shared set-up ------------------------------------------------------

    def weights(self, dtype):
        """The configuration's weights drawn from the seed on the device, in
        the type they are served in (rounded to bf16 for a bf16 server, so
        that both sides hold the same values), as float32 tensors."""
        specs = self.ref.param_specs(self.cfg["args"], self.cfg["assumed"]["weights"])
        w = common.draw_weights(specs, self.run.seed, self.device)
        if dtype is not None:
            w = {k: v.to(dtype).float() for k, v in w.items()}
        return w

    def reference_weights(self):
        return self.weights(torch.bfloat16 if self.traffic.get("bf16") else None)

    def model(self, weights):
        factory = getattr(self.run.program, self.cfg["factory"])
        model = factory(**self.cfg["args"], device=self.device)
        self.run.mark("model built")
        model.load_state_dict(weights, strict=True)
        self.run.mark("weights loaded")
        return model

    def generator(self, stream):
        """A generator on the device for input stream ``stream`` of this
        seed (the weights take stream 0)."""
        return torch.Generator(device=self.device).manual_seed(self.run.seed + stream)

    def images(self, shape, stream=1):
        """uint8 NHWC images of ``shape`` (..., H, W, 3) drawn on the device
        and handed to the host as a client holds them. Each image has a
        colour of its own, a smooth pattern over a 4 × 4 grid and pixel
        noise, so that its features, pooled over its tokens, and so its
        answer, are its own."""
        g = self.generator(stream)
        *lead, h, w, c = shape
        n = math.prod(lead)
        kw = dict(generator=g, device=self.device)
        base = torch.rand(n, 1, 1, c, **kw) * 255
        amp = 16 + torch.rand(n, 1, 1, 1, **kw) * 80
        low = torch.nn.functional.interpolate(torch.randn(n, c, 4, 4, **kw), size=(h, w),
                                              mode="bilinear", align_corners=False)
        img = base + amp * low.permute(0, 2, 3, 1) + 24 * torch.randn(n, h, w, c, **kw)
        return img.clamp(0, 255).round().to(torch.uint8).reshape(shape).cpu().numpy()

    def predictor(self, model, batch_size):
        t = self.traffic
        return self.run.program.Predictor(model, batch_size=batch_size,
                                          image_size=self.cfg["args"]["image_size"],
                                          bf16=t["bf16"], compute=t["compute"], top_k=t["top_k"])

    def reference_logprobs(self, weights, images, rows=128, mm=common.matmul):
        """The reference's log-probabilities of uint8 ``images`` (N, H, W,
        3), in blocks of ``rows``, its products ``mm`` (float32 as they
        are by default)."""
        out = []
        with torch.no_grad(), common.float32_exact():
            for i in range(0, len(images), rows):
                x = common.preprocess(torch.from_numpy(images[i:i + rows]).to(self.device))
                out.append(torch.log_softmax(self.ref.forward(weights, x, mm=mm), -1))
        return torch.cat(out)

    def finish(self):
        """After the window and the peak's reading, before the program is
        freed: what the check needs from the program's own state."""


def answer_gaps(ref_logp, labels, probs):
    """What a batch of answers is judged by: ``logprob_err``, the largest
    gap between a served probability's log and the reference's
    log-probability of that label; ``logprob_sum`` and ``answers``, the sum
    of those gaps and their count (``logprob_mae`` is the one over the
    other across a run); ``top1_gap``, the largest amount by which the
    reference's log-probability of the served first label lies below its
    best."""
    labels = torch.as_tensor(np.asarray(labels), device=ref_logp.device).long()
    probs = torch.as_tensor(np.asarray(probs), device=ref_logp.device).double()
    got = ref_logp.double().gather(1, labels)
    err = (probs.clamp_min(1e-300).log() - got).abs()
    top1 = (ref_logp.double().max(1).values - got[:, 0]).max()
    return {"logprob_err": float(err.max()), "logprob_sum": float(err.sum()),
            "answers": err.numel(), "top1_gap": float(top1)}


def worst_answers(parts):
    """The run's numbers from ``answer_gaps`` of its batches: the largest
    gaps, and the mean gap ``logprob_mae``."""
    return {"logprob_err": max(p["logprob_err"] for p in parts),
            "logprob_mae": sum(p["logprob_sum"] for p in parts) / sum(p["answers"] for p in parts),
            "top1_gap": max(p["top1_gap"] for p in parts)}


def fifths(ends, t0, seconds, per_end=1):
    """The rate (work a second) in each fifth of a window that began at
    ``t0``, from the times at which its pieces of work ended."""
    edges = t0 + seconds * np.arange(6) / 5
    return [round(float(c) * per_end * 5 / seconds, 1) for c in np.histogram(ends, edges)[0]]


class Closed(Load):
    """Batch classification: ``predict`` on full batches, back to back, from
    a pool of batches drawn from the seed."""

    def make_pool(self):
        t, s = self.traffic, self.cfg["args"]["image_size"]
        return self.images((t["pool_batches"], t["batch_size"], s, s, 3))

    def setup(self):
        self.predictor_ = self.predictor(self.model(self.reference_weights()),
                                         self.traffic["batch_size"])
        self.pool = self.make_pool()
        self.run.mark("inputs drawn")
        for i in range(2):  # the one shape the window uses
            self.predictor_.predict(self.pool[i % len(self.pool)])

    def window(self, seconds):
        pool, predict, outs, ends = self.pool, self.predictor_.predict, [], []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            with record_function("predict"):  # a span of the benchmark's own
                outs.append(predict(pool[i % len(pool)]))
            ends.append(time.perf_counter())
            i += 1
        dt = time.perf_counter() - t0
        self.outs = outs
        b = self.traffic["batch_size"]
        self.run.note(f"img/s in each fifth of the window: {fifths(ends, t0, seconds, b)}")
        return {"attempted": i, "failed": 0, "images": i * b, "window_s": dt,
                "end_to_end": {"infer_img_s": i * b / dt}}

    def free(self):
        del self.predictor_

    def flat_pool(self):
        return self.pool.reshape(-1, *self.pool.shape[-3:])

    def control(self, mm):
        """The reference put in the program's place with products ``mm``,
        in blocks of the cell's batch: its answers on every image of the
        pool, judged as the program's are."""
        w, images = self.reference_weights(), self.flat_pool()
        ref = self.reference_logprobs(w, images)
        top = self.reference_logprobs(w, images, rows=self.traffic["batch_size"], mm=mm) \
            .exp().topk(self.traffic["top_k"], -1)
        return worst_answers([answer_gaps(ref, top.indices.cpu().numpy(),
                                          top.values.cpu().numpy())])

    def check(self):
        logp = self.reference_logprobs(self.reference_weights(), self.flat_pool())
        logp = logp.reshape(len(self.pool), -1, logp.shape[-1])
        return worst_answers([answer_gaps(logp[i % len(self.pool)], labels, probs)
                              for i, (labels, probs) in enumerate(self.outs)])


class Train(Load):
    """Training: the step called back to back. Set-up drives the same step
    object through its first ``check_steps`` steps, on rows that all
    differ, and keeps what the check compares: each step's loss, each
    leaf's first gradient (from the optimizer's first moment after one
    step) and each leaf's change over those steps. After the window the
    same object takes ``tail_steps`` more steps on fresh batches, from a
    copy of its state that the reference starts from too."""

    def make_batches(self, stream=1, count=None):
        """Batches made on the device from the seed: normal images and
        uniform labels; the pool the window cycles by default."""
        t, a = self.traffic, self.cfg["args"]
        b, s = t["batch_size"], a["image_size"]
        g = self.generator(stream)
        return [{"image": torch.randn(b, a["in_channels"], s, s, generator=g, device=self.device),
                 "label": torch.randint(0, a["num_classes"], (b,), generator=g, device=self.device)}
                for _ in range(t["pool_batches"] if count is None else count)]

    def optimizer(self):
        return common.AdamW(**{k: v for k, v in self.traffic["optimizer"].items() if k != "name"})

    def reference(self, **kw):
        """What the plain reference gives where the program's numbers were
        taken: {losses, grad1, change} of the check's first steps from the
        drawn weights, and {tail_losses, tail_change} of the tail steps
        from the program's state after the window. ``kw`` goes to
        ``common.train_reference`` (the control's product, a fault's rows)."""
        losses, grad1, change = common.train_reference(
            self.ref.forward, self.weights(None), self.batches[:self.traffic["check_steps"]],
            self.optimizer(), **kw)
        opt = self.optimizer()
        opt.m = {k: v.to(self.device) for k, v in self.state["m"].items()}
        opt.v = {k: v.to(self.device) for k, v in self.state["v"].items()}
        opt.t = self.state["t"]
        params = {k: v.to(self.device) for k, v in self.state["params"].items()}
        tail_losses, _, tail_change = common.train_reference(self.ref.forward, params, self.tail,
                                                             opt, **kw)
        return {"losses": losses, "grad1": grad1, "change": change,
                "tail_losses": tail_losses, "tail_change": tail_change}

    def setup(self):
        t = self.traffic
        w = self.weights(None)
        model = self.model(w)
        opt_cfg = dict(t["optimizer"])
        opt = getattr(torch.optim, opt_cfg.pop("name"))(model.parameters(), **opt_cfg)
        dtype = getattr(torch, t["compute_dtype"])
        self.step = self.run.program.parallel.make_train_step(model, opt, compute_dtype=dtype)
        self.batches = self.make_batches()
        self.run.mark("inputs drawn")
        names = {p: k for k, p in model.named_parameters()}
        beta1 = opt.param_groups[0]["betas"][0]
        self.numbers = {"losses": []}
        for i in range(t["check_steps"]):
            self.numbers["losses"].append(float(self.step(self.batches[i])))
            if i == 0:
                self.numbers["grad1"] = {names[p]: float(st["exp_avg"].norm()) / (1 - beta1)
                                         for p, st in opt.state.items()}
        with torch.no_grad():
            self.numbers["change"] = {k: float((p - w[k]).norm())
                                      for k, p in model.named_parameters()}
        del w  # drawn again for the check: the window holds only the program's state
        self.model_, self.opt = model, opt
        self.next = t["check_steps"]

    def window(self, seconds):
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        batches, step = self.batches, self.step
        sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            with record_function("train_step"):
                step(batches[(self.next + n) % len(batches)])
            n += 1
        sync()
        dt = time.perf_counter() - t0
        b = self.traffic["batch_size"]
        return {"attempted": n, "failed": 0, "images": n * b, "window_s": dt,
                "end_to_end": {"train_img_s": n * b / dt}}

    def finish(self):
        """The program's state after the window (parameters, AdamW's
        moments and step count) copied to the host, then ``tail_steps``
        more steps of the same step object on fresh batches."""
        names = {p: k for k, p in self.model_.named_parameters()}
        with torch.no_grad():
            params = {k: p.detach().to("cpu", copy=True) for p, k in names.items()}
            st = self.opt.state
            self.state = {"params": params,
                          "m": {names[p]: s["exp_avg"].to("cpu", copy=True) for p, s in st.items()},
                          "v": {names[p]: s["exp_avg_sq"].to("cpu", copy=True)
                                for p, s in st.items()},
                          "t": max((int(s["step"]) for s in st.values()), default=0)}
        self.tail = self.make_batches(stream=2, count=self.traffic["tail_steps"])
        self.numbers["tail_losses"] = [float(self.step(b)) for b in self.tail]
        with torch.no_grad():
            self.numbers["tail_change"] = {
                k: float((p.detach() - params[k].to(self.device)).norm()) for p, k in names.items()}

    def free(self):
        del self.step, self.model_, self.opt

    def check(self):
        return train_gaps(self.numbers, self.reference())


def train_gaps(prog, ref):
    """The numbers a training run is judged by, from the program's and the
    reference's readings (``Train.reference``): ``loss_gap``, the largest
    relative gap of a step's loss over the first steps and the tail;
    ``grad_gap``, the worst leaf's gap of its first gradient's norm;
    ``change_gap`` and ``tail_change_gap``, the worst leaf's gap of its
    change's norm over the first steps and over the tail
    (``common.leaf_gaps``). Leaves whose first reference gradient is under
    a thousandth of the median leaf's move by round-off alone and are left
    out of the changes."""
    med = sorted(ref["grad1"].values())[len(ref["grad1"]) // 2]
    moved = {k for k, v in ref["grad1"].items() if v >= 1e-3 * med}
    pairs = zip(prog["losses"] + prog["tail_losses"], ref["losses"] + ref["tail_losses"])
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in pairs),
            "grad_gap": common.leaf_gaps(prog["grad1"], ref["grad1"]),
            "change_gap": common.leaf_gaps(prog["change"], ref["change"], keep=moved),
            "tail_change_gap": common.leaf_gaps(prog["tail_change"], ref["tail_change"],
                                                keep=moved)}


KINDS = {"closed": Closed, "train": Train}
