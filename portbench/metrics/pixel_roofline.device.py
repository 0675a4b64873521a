"""pixel_roofline.device: the pixel stage's bound (``bounds.pixel_bound_s``)
over the device time of the ops that ``stages/pixel.json`` assigns to it,
per call, in percent."""

from portbench import bounds


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    busy = run.trace.busy_s(run.stage_ops("pixel"))
    if busy <= 0:
        return None
    return 100.0 * bounds.pixel_bound_s(run.config) * run.trace.calls / busy
