"""decode_ms_per_call.repick: the engine's decode and commit (its
``stage['decode'] + stage['write']`` seconds: the picker on the card, the
copy to the host, the catalog rows and the segment's rename) over the
device calls of the window, in ms per call."""


def read(run):
    if run.get("lane") != "repick" or not run.get("calls"):
        return None
    return 1e3 * (run["stage_s"]["decode"] + run["stage_s"]["write"]) / run["calls"]
