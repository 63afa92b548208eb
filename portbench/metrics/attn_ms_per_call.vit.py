"""attn_ms_per_call.vit: the card's time inside the window's attention launch
spans (``satae.attn``: one a block, 12 a chunk) per ``predict`` call, ms,
from each span's two CUDA events (the card's idle time between them
included). None where the program has no such span."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.attn", "calls")
