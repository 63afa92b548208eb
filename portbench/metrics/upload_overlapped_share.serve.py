"""upload_overlapped_share.serve: share of the bytes the serving calls copied
to the card whose copy was issued after the call's first chunks were
launched, so that it can run under their kernels: the ``overlapped_bytes``
counter of the window's ``satae.serve.upload`` spans over their ``bytes``,
%. None for a program whose upload span has no such counter."""

from portbench import spans


def read(run):
    upload = spans.named(run, "satae.serve.upload")
    if upload is None or any("overlapped_bytes" not in r.counts
                             for r in upload):
        return None
    total = sum(r.counts.get("bytes", 0) for r in upload)
    if total <= 0:
        return None
    return 100.0 * sum(r.counts["overlapped_bytes"] for r in upload) / total
