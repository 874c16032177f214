"""mfu.train: three times the model's forward products per image (forward,
and the backward's two products a forward product; recomputation not
counted), times the images trained in the traced window, over the window's
seconds and the card's dense bf16 peak, in %."""


def read(run):
    if run.trace is None or run.peaks is None or not run.window["images"]:
        return None
    flops = 3 * run.ref.flops_per_image(run.cfg["args"]) * run.window["images"]
    return 100.0 * flops / run.trace.window_s / run.peaks["bf16_flops"]
