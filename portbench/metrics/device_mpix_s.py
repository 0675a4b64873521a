"""device_mpix_s: pixels of every device-resident frame (or batch)
enqueued in the window, over the time from the window's start to the
synchronise that ends it."""


def read(run):
    if run.entry != "device_encode" or run.window_s <= 0:
        return None
    done = run.calls - run.failed
    return done * run.pixels_per_call / run.window_s / 1e6
