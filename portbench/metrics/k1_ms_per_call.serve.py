"""k1_ms_per_call.serve: the card's time inside the window's K1 launch
spans (``satae.k1``: the encoder's projection and the head's three linears)
per ``predict`` call, ms. A span's time runs from the card reaching the
CUDA event recorded before the launch to it reaching the one after, so it
holds any idle time of the card between the two."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.k1", "calls")
