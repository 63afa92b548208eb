"""layernorm_roofline_share.vit: the least time of the traced window's
LayerNorm work (each row and residual branch read, the normalised row and
the sum written, at 3.35 TB/s; portbench/work_vit.py) over the card's time
inside the window's ``satae.ln`` spans, %. None where the program has no
such span or the cell no such work."""

from portbench import spans


def read(run):
    recs = spans.named(run, "satae.ln")
    least = run.work.get("ln_least_s") if run.work else None
    if recs is None or not least or any(r.device_ms is None for r in recs):
        return None
    busy_s = sum(r.device_ms for r in recs) * 1e-3
    if busy_s <= 0:
        return None
    return 100.0 * len(run.units) * least / busy_s
