"""mfu.train: the train step's share of the card's float32 peak.

The FLOPs of one forward and backward per waveform, counted on the
reference with no recompute and frozen in the configuration's file
(``flops_per_waveform.train_step``), times the waveforms the window
updated on, over the window's wall time (the unprofiled window) times the
card's published dense float32 peak (``devices/*.json``, ``fp32``). In %.
"""


def read(run):
    if run.get("lane") != "train":
        return None
    flops = run["config"]["flops_per_waveform"]["train_step"] * run["waveforms"]
    return 100.0 * flops / (run["wall_s"] * run["peaks"]["flops"]["fp32"])
