"""fill_ms_per_call.repick: the engine's archive fill (its ``stage['fill']``
seconds: the shard reads into the staging batch on the producer thread)
over the device calls of the window, in ms per call."""


def read(run):
    if run.get("lane") != "repick" or not run.get("calls"):
        return None
    return 1e3 * run["stage_s"]["fill"] / run["calls"]
