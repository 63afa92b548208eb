"""kernels_per_step.train: device kernels launched per train step in the
traced window (copies and memsets not counted)."""


def read(run):
    if run.trace is None or not run.totals.get("steps"):
        return None
    return run.trace.kernels / run.totals["steps"]
