"""kernels_roofline_share.serve: the least time of the traced window's work
(portbench.work: each operation's max(operations / peak, bytes / HBM rate),
from the cell's shapes) over the time the card ran kernels (copies left
out), %."""


def read(run):
    if run.trace is None or not run.totals.get("calls") or not run.work \
            or run.trace.kernel_busy_s <= 0:
        return None
    units = len(run.units)
    return 100.0 * units * run.work["least_s"] / run.trace.kernel_busy_s
