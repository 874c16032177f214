"""roofline.block.infer: the block kernels' share of their roofline, in %.

Over every launch of the program's kernel ops (``jittor_mlp_tpu_torch::``,
the hand-written block kernels on this path) in the traced window: the
least time a launch could take, the larger of its operations over the
card's dense bf16 peak and its bytes over the card's memory bandwidth (the
configuration's reference counts both from the block's shapes: each input
read once, each output written once), summed over the launches and divided
by the device time of the kernels those ops launched."""

PREFIX = "jittor_mlp_tpu_torch::"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    device_s, launches = run.trace.op_device(PREFIX)
    if not launches or device_s <= 0:
        return None
    a, b = run.cfg["args"], run.traffic["batch_size"]
    least = max(run.ref.block_ops(a, b) / run.peaks["bf16_flops"],
                run.ref.block_bytes(a, b) / run.peaks["hbm_bytes_s"])
    return 100.0 * launches * least / device_s
