"""setup_s: seconds from the start of the process to the first timed unit
(imports, CUDA context, kernel libraries, inputs from the seed, the first
steps and the warm-up of every shape the window uses)."""


def read(run):
    return run.setup_s
