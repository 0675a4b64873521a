"""setup_s: seconds from the process's start to the window's start: torch
and CUDA start-up, loading (or building) the kernel library, making the
inputs and the encoder, and the warm-up calls."""


def read(run):
    return run.setup_s
