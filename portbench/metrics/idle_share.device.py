"""idle_share.device: share of the time in which the device runs nothing,
at the run's untraced pace: one less the traced slice's busy time per call
(the union of its device intervals) times the calls per second of the
window before the slice, up to the synchronise that starts it. The
slice's own idle share is the driver's, from ``busy_s`` and ``window_s``;
it reads higher, since the profiler's cost on each launch slows the
host's enqueue to about the device's pace in these cells."""


def read(run):
    calls, seconds = run.lead
    if (run.trace is None or not run.trace.device or not run.trace.calls
            or not calls or seconds <= 0):
        return None
    busy = run.trace.busy_s() / run.trace.calls
    return 1.0 - busy * calls / seconds
