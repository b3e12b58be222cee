"""device_idle.train: the share of the traced window of train steps in
which no kernel, copy or set ran on the card (the union of their
intervals from the profiler's trace, against the window's length). In %.

The traced window, not the unprofiled one: the host runs two steps ahead
of a device-paced step, and the device's busy time per step is within
about 0.1% of the unprofiled wall per step, so busy time per step over
the unprofiled wall could read 0 or below. The profiler's host time
shows here as a few ms of idle a step."""


def read(run):
    t = run.get("trace")
    if run.get("lane") != "train" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
