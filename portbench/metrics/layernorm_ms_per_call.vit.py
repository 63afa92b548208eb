"""layernorm_ms_per_call.vit: the card's time inside the window's LayerNorm
launch spans (``satae.ln``: two a block and the final one, 25 a chunk) per
``predict`` call, ms, from each span's two CUDA events (the card's idle
time between them included). None where the program has no such span."""

from portbench import spans


def read(run):
    return spans.device_ms_per(run, "satae.ln", "calls")
