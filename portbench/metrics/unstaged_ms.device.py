"""unstaged_ms.device: device busy time per call (frame or batch) in the
traced slice of the ops that no file under ``stages/`` names: work that
no stage's roofline sees, such as a kernel renamed or new torch glue."""


def read(run):
    if run.trace is None or not run.trace.device or not run.trace.calls:
        return None
    return run.trace.busy_s(run.unstaged_ops()) * 1e3 / run.trace.calls
