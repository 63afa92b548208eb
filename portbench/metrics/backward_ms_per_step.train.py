"""backward_ms_per_step.train: the card's time inside the window's
``satae.train.backward`` spans (``torch.autograd.grad`` over every
parameter of the 45 stacked configs) per stacked step, ms. A span's time
runs from the card reaching the CUDA event recorded as the phase opens to
it reaching the one as it closes, so it holds any idle time of the card in
between."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.train.backward", "steps")
