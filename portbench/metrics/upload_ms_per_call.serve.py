"""upload_ms_per_call.serve: device time of the host-to-device copies per
``predict`` call in the traced window, ms."""


def read(run):
    if run.trace is None or not run.totals.get("calls"):
        return None
    n, s = run.trace.copies.get("HtoD", (0, 0.0))
    return s * 1e3 / run.totals["calls"] if n else None
