"""launches.device: kernels, memsets and copies per call (frame or batch)
in the traced slice."""


def read(run):
    if run.trace is None or not run.trace.device or not run.trace.calls:
        return None
    return len(run.trace.device) / run.trace.calls
