"""busy_ms.device: device busy time per call (frame or batch) in the traced
slice: the union of the intervals of its kernels, memsets and copies."""


def read(run):
    if run.trace is None or not run.trace.device or not run.trace.calls:
        return None
    return run.trace.busy_s() * 1e3 / run.trace.calls
