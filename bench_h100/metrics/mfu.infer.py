"""mfu.infer: the model's products per image, as the configuration's
reference counts them (2·M·N·K a product), times the images classified in
the traced window, over the window's seconds and the card's dense bf16
peak, in %."""


def read(run):
    if run.trace is None or run.peaks is None or not run.window["images"]:
        return None
    flops = run.ref.flops_per_image(run.cfg["args"]) * run.window["images"]
    return 100.0 * flops / run.trace.window_s / run.peaks["bf16_flops"]
