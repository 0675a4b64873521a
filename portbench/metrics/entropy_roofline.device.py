"""entropy_roofline.device: the entropy stage's bound
(``bounds.entropy_bound_s``, on the scans of the slice's inputs) over the
device time of the ops that ``stages/entropy.json`` assigns to it (block
pack, segment merge, stuffing and their memsets), per call, in percent."""

from portbench import bounds


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    busy = run.trace.busy_s(run.stage_ops("entropy"))
    if busy <= 0:
        return None
    bound = bounds.entropy_bound_s(run.config, run.slice_scan_bytes())
    return 100.0 * bound * run.trace.calls / busy
