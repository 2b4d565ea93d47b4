"""The trunk kernels' (#1/#2) share of their roofline over the traced steps,
in %: the least time of the model FLOPs and bytes of their calls
(benchmark/roofline.py::train_step_work) over their device time."""

KERNELS = ("fwd_kernel", "bwd_rows_kernel", "atb_kernel", "colsum_kernel", "colsum_rows_kernel")


def read(v):
    t = v.summary.kernel_s(*KERNELS)
    if t <= 0 or "trunk" not in v.least:
        return None
    return 100.0 * v.least["trunk"] / t
