"""wattn_roofline_share.swin: the least time of the traced window's
shifted-window attention (S = Q K^T and P V over each token's 64-token
window at the bf16 peak, or the bytes of qkv read, the heads' output
written and the position-bias tables read; portbench/work_swin.py:
max(operations / peak, bytes / 3.35 TB/s), real chips only) over the
card's time inside the window's ``satae.wattn`` spans, %. None where the
program has no such span or the cell no such work."""

from portbench import spans


def read(run):
    recs = spans.named(run, "satae.wattn")
    least = run.work.get("wattn_least_s") if run.work else None
    if recs is None or not least or any(r.device_ms is None for r in recs):
        return None
    busy_s = sum(r.device_ms for r in recs) * 1e-3
    if busy_s <= 0:
        return None
    return 100.0 * len(run.units) * least / busy_s
