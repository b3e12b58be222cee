"""device_idle.repick: the share of the unprofiled window of whole
re-picking passes in which no kernel, copy or set ran on the card.

The device's busy seconds per device call come from the profiler's trace
of the traced passes (the union of the kernel, copy and set intervals,
over the calls traced); times the calls of the unprofiled window, over
that window's wall time. The profiler's own host time lengthens each
call of this host-paced lane in the traced stretch, not in the
unprofiled one. In %."""


def read(run):
    t = run.get("trace")
    if run.get("lane") != "repick" or t is None or not run.get("trace_calls"):
        return None
    busy = t.busy_s / run["trace_calls"] * run["calls"]
    return 100.0 * (1.0 - busy / run["wall_s"])
