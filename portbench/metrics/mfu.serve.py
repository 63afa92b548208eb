"""mfu.serve: the model's FLOPs of the traced window's work over the window
and the card's peak for the configuration's dtype (495 TFLOP/s TF32 for
float32, 989 bf16), %.

It is taken under the profiler, over the traced window, as every per-layer
metric is: where the host holds the card back, the profiler's own cost per
operation lengthens that window, so this share reads below the untraced
run's rate times the FLOPs of an image over the peak, and is compared only
with other traced runs, never with the end-to-end rate."""


def read(run):
    if run.trace is None or not run.totals.get("calls") or not run.work \
            or run.trace.window_s <= 0:
        return None
    units = len(run.units)
    return 100.0 * units * run.work["flops"] / run.trace.window_s \
        / run.peak["flops"]
