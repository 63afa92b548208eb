"""k1_roofline_share.vit: the least time of the traced window's GEMM work
(the patch embedding and the blocks' qkv, proj, fc1 and fc2 at the bf16
peak, the head's three linears at the float32 one; portbench/work_vit.py:
max(operations / peak, bytes / 3.35 TB/s), inputs read once, outputs
written once, real chips only) over the card's time inside the window's
``satae.k1`` spans, %. None where the program has no such span or the
cell no such work."""

from portbench import spans


def read(run):
    recs = spans.named(run, "satae.k1")
    least = run.work.get("gemm_least_s") if run.work else None
    if recs is None or not least or any(r.device_ms is None for r in recs):
        return None
    busy_s = sum(r.device_ms for r in recs) * 1e-3
    if busy_s <= 0:
        return None
    return 100.0 * len(run.units) * least / busy_s
