"""The benchmark's plain reference: the notebook's model, its training step
and Adam in float32 PyTorch (``model``), and the roundings that make the
control (``precision``). Imports nothing of the program under test."""
