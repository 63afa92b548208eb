"""k1_wide_share.vit: the share of the traced window's K1 launches (the
``satae.k1`` spans) that ran K1's wide kernel, whose span carries the
counter ``wide`` at 1 (0 on every other K1 route), %. A 64-chip chunk of
the ViT cell launches K1 52 times: the patch embedding and the blocks'
qkv, proj, fc1 and fc2 in bf16 (49), and the head's three float32
linears. None where the program has no such span, or spans without the
counter (a program older than the wide route)."""

from portbench import spans


def read(run):
    recs = spans.named(run, "satae.k1")
    if recs is None or any("wide" not in r.counts for r in recs):
        return None
    return 100.0 * sum(r.counts["wide"] for r in recs) / len(recs)
