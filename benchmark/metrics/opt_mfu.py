"""The optimizer steps' share of the chip's peaks, in %: the least time of
kernel #3 in exact mode, kernel #4 and the update's bytes
(benchmark/roofline.py) over the traced window's length."""


def read(v):
    if v.summary.window_s <= 0 or "step" not in v.least:
        return None
    return 100.0 * v.least["step"] / v.summary.window_s
