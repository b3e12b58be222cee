"""mfu.repick: the re-picking program's share of the card's float32 peak.

The FLOPs of one forward per waveform, counted on the reference and
frozen in the configuration's file (``flops_per_waveform.forward``), times
the catalog rows the window committed, over the window's wall time times
the card's published dense float32 peak (``devices/*.json``). In %.
"""


def read(run):
    if run.get("lane") != "repick":
        return None
    flops = run["config"]["flops_per_waveform"]["forward"] * run["waveforms"]
    return 100.0 * flops / (run["wall_s"] * run["peaks"]["flops"]["fp32"])
