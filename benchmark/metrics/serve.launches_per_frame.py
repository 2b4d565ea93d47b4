"""Host-side kernel and graph launch calls per served frame (traced window)."""


def read(v):
    return v.summary.launches / v.units if v.units else None
