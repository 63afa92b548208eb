"""upload_gbps.serve: bytes the serving calls copied to the card (the
``bytes`` counter of the window's ``satae.serve.upload`` spans) over the
device time of the window's host-to-device copies, GB/s."""

from portbench import spans


def read(run):
    upload = spans.named(run, "satae.serve.upload")
    if upload is None:
        return None
    n, s = run.trace.copies.get("HtoD", (0, 0.0))
    if not n or s <= 0:
        return None
    return sum(r.counts.get("bytes", 0) for r in upload) / s / 1e9
