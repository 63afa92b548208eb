"""k2_ms_per_call.serve: the card's time inside the window's K2 launch
spans (``satae.k2``) per ``predict`` call, ms. A span's time runs from the
card reaching the CUDA event recorded before the launch to it reaching the
one after, so it holds any idle time of the card between the two, which a
busy card (91 % in this cell) keeps to microseconds."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.k2", "calls")
