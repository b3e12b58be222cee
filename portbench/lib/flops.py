"""The work counts frozen in each configuration's file, counted on the
reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the products
(convolutions, matrix products, the attention's two ``einsum`` products)
of one forward in eval mode and of one train step (forward and backward in
train mode) of the reference at one waveform; the reference recomputes
nothing, so neither count holds a recompute. The attention calls of one
forward, as (L, M, H, E), come from the same pass. Run as a script, it
prints the block a configuration file holds:

    python portbench/lib/flops.py portbench/configs/seist_l_dpk.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

import torch

if __name__ == "__main__":  # run as a file: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.reference import dropout as ref_dropout  # noqa: E402
from portbench.reference import seist as ref_seist  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402


def count(cfg: Dict) -> Dict:
    """{"flops_per_waveform": {"forward", "train_step"}, "attention_calls"}
    at the configuration's window, counted at batch 1 on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    torch.manual_seed(0)
    model = ref_train.build_model(cfg)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    window = cfg["window"]
    x = torch.randn(1, window, cfg["in_channels"])
    model.eval()
    ref_seist.ATTENTION_LOG.clear()
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        model(x)
    calls = [list(c) for c in ref_seist.ATTENTION_LOG]
    model.train()
    ref_dropout.set_draws(model, ref_dropout.StepDraws(0, 0, "cpu"))
    with FlopCounterMode(display=False) as step:
        ref_train.loss_fn(cfg)(model(x), torch.rand(1, window, 3)).backward()
    ref_seist.ATTENTION_LOG.clear()
    return {"flops_per_waveform": {"forward": int(fwd.get_total_flops()),
                                   "train_step": int(step.get_total_flops())},
            "attention_calls": calls}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(count(json.load(f))))
