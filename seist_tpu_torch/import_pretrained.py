"""``python -m seist_tpu_torch import-pretrained``: the reference's
published ``.pth`` weights -> the port's weights file, without JAX.

    python -m seist_tpu_torch import-pretrained --pth seist_s_dpk_diting.pth \\
        --model-name seist_s_dpk --out seist_s_dpk.pt

The counterpart of ``tools/import_pretrained.py`` (same flags, same
default ``--in-channels``, same closing line); where that tool writes an
orbax checkpoint, this one writes the port's strict ``state_dict``
(``models/reference.py``), checked against the model by
``serve/pool.py::validate_checkpoint``. ``serve --model NAME=W.pt``,
``repick --model NAME=W.pt``, ``train --checkpoint W.pt`` (test, or a
fine-tune from the weights alone), ``predict`` and ``demo`` load it as it
is. A host conversion: it takes no device.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seist_tpu_torch import-pretrained",
                                 description="reference .pth -> the port's weights (.pt)")
    ap.add_argument("--pth", required=True, type=str,
                    help="path to the reference's torch state dict (.pth)")
    ap.add_argument("--model-name", required=True, type=str,
                    help="registered model name, e.g. seist_s_dpk")
    ap.add_argument("--in-samples", default=8192, type=int)
    ap.add_argument("--in-channels", default=None, type=int,
                    help="default: the model's task-spec input count (3 for most, 2 for "
                    "ditingmotion's [z, dz]); 3 for a model without a task spec")
    ap.add_argument("--out", required=True, type=str, help="output weights file (.pt)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Convert and write; returns the output path."""
    import torch

    from seist_tpu_torch import taskspec
    from seist_tpu_torch.models import api
    from seist_tpu_torch.models.reference import state_dict_from_reference

    args = get_args(argv)
    if args.in_channels is None:
        try:
            args.in_channels = taskspec.get_num_inchannels(args.model_name)
        except KeyError:
            # distpt_network has no task spec; every spec-less model takes 3 channels.
            args.in_channels = 3
    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    model = api.create_model(args.model_name, in_channels=args.in_channels,
                             in_samples=args.in_samples)
    state = state_dict_from_reference(sd, model, checkpoint=args.pth,
                                      model_name=args.model_name)
    model.load_state_dict(state, strict=True)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, out)
    n = sum(p.numel() for p in model.parameters())
    print(f"Imported {args.pth} -> {out} ({n:,} params)", flush=True)
    return out
