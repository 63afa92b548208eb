"""forward_ms_per_step.train: the card's time inside the window's
``satae.train.forward`` spans (the augmentation draws and ops, the stacked
model's forward, the loss) per stacked step, ms. A span's time runs from the
card reaching the CUDA event recorded as the phase opens to it reaching the
one as it closes, so it holds any idle time of the card in between (the
card is 96 % busy in this cell)."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.train.forward", "steps")
