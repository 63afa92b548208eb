"""kernels_per_call.serve: device kernels launched per ``predict`` call in
the traced window (copies and memsets not counted)."""


def read(run):
    if run.trace is None or not run.totals.get("calls"):
        return None
    return run.trace.kernels / run.totals["calls"]
