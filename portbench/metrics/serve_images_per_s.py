"""serve_images_per_s: images that ``predict`` returned over the whole
window, per second of it (upload and readback included)."""


def read(run):
    if "calls" not in run.totals or run.trace is not None:
        return None
    return run.totals["images"] / run.window_s
