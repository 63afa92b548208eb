"""serve_call_p95_ms: the 95th percentile of every ``predict`` call's
latency in the window, by the host's clock (inclusive quantiles)."""

import statistics


def read(run):
    if "calls" not in run.totals or run.trace is not None:
        return None
    lat = [(b - a) * 1e3 for a, b, _ in run.units]
    if len(lat) < 2:
        return lat[0] if lat else None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
