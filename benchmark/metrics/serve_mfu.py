"""The served frames' share of the chip's peaks, in %: the least time of their
compositing work (kernel #3's, benchmark/roofline.py) over the traced
window's length."""


def read(v):
    if v.summary.window_s <= 0 or "composite" not in v.least:
        return None
    return 100.0 * v.least["composite"] / v.summary.window_s
