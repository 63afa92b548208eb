"""train_images_per_s: training images stepped over the whole window, summed
over the configs trained at once, per second of it."""


def read(run):
    if "steps" not in run.totals or run.trace is not None:
        return None
    return run.totals["images"] / run.window_s
