"""The training step's model FLOPs over the traced window at the bf16 tensor
core peak (989 TFLOP/s), in %."""

BF16_FLOPS = 989e12


def read(v):
    if v.summary.window_s <= 0 or "step_flops" not in v.least:
        return None
    return 100.0 * v.least["step_flops"] / (BF16_FLOPS * v.summary.window_s)
