"""Share of the traced window in which no operation ran on the device, in %:
1 - (the union of the device operations' intervals) / the window."""


def read(v):
    if v.summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - v.summary.busy_s / v.summary.window_s)
