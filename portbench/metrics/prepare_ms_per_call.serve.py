"""prepare_ms_per_call.serve: host time from the start of a serving call
(span ``satae.serve``) to the start of its upload (its child
``satae.serve.upload``), per ``predict`` call in the traced window, ms: the
call's checks, the conversion to uint8 and the folded weights' look-up,
before anything reaches the card."""

from portbench import spans


def read(run):
    serve = spans.named(run, "satae.serve")
    upload = spans.named(run, "satae.serve.upload")
    calls = run.totals.get("calls")
    if serve is None or upload is None or not calls:
        return None
    start = {r.id: r.t0_ns for r in serve}
    waits = [r.t0_ns - start[r.parent] for r in upload if r.parent in start]
    if len(waits) != calls:
        return None
    return sum(waits) * 1e-6 / calls
