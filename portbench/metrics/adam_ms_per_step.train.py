"""adam_ms_per_step.train: the card's time inside the window's
``satae.train.adam`` spans (``optim.adam_update`` over the stacked
parameters) per stacked step, ms. A span's time runs from the card reaching
the CUDA event recorded as the phase opens to it reaching the one as it
closes, so it holds any idle time of the card in between."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.train.adam", "steps")
