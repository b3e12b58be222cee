"""Convert a JAX package train checkpoint (orbax) into the PyTorch port's
checkpoint pair, from which ``python -m seist_tpu_torch train
--checkpoint`` resumes at the same data position and update count.

    python tools/orbax_to_torch.py \
        --checkpoint RUN/checkpoints/model_<step> --model-name seist_s_dpk \
        [--in-samples 8192] [--in-channels C] [--weight-decay 0] \
        [--out RUN_DIR]

The checkpoint is restored into a train state of the same structure as the
JAX worker builds it (the model, Adam from ``train/optim.py::build_optimizer``
over a schedule, with ``--weight-decay`` as the run had it) and written through
``seist_tpu_torch/models/convert.py::save_torch_train_state`` as
``OUT/checkpoints/model_<step>.pt`` and ``state_<step>.pt``. ``--out``
defaults to the JAX run directory (the part of the path before
``checkpoints``), so the port's pair lands beside the orbax one. Only Adam
states convert (the port's optimizer holds Adam's moments).

This tool imports JAX and orbax; the port it writes for does not.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_TOOLS))  # for the packages without install


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="orbax train checkpoint -> the port's pair")
    ap.add_argument("--checkpoint", required=True,
                    help="the JAX package's step checkpoint (RUN/checkpoints/model_<step>)")
    ap.add_argument("--model-name", required=True)
    ap.add_argument("--in-samples", default=8192, type=int)
    ap.add_argument("--in-channels", default=None, type=int,
                    help="default: the model's task-spec input count")
    ap.add_argument("--weight-decay", default=0.0, type=float)
    ap.add_argument("--out", default="", help="the port's run directory (default: the JAX "
                    "run directory)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Convert; returns the port's weights path."""
    args = get_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")  # a host conversion

    import seist_tpu
    from seist_tpu import taskspec
    from seist_tpu.models import api
    from seist_tpu.train.checkpoint import load_checkpoint, restore_into_state
    from seist_tpu.train.optim import build_optimizer
    from seist_tpu.train.state import create_train_state

    from seist_tpu_torch.models.convert import save_torch_train_state

    seist_tpu.load_all()
    if args.in_channels is None:
        try:
            args.in_channels = taskspec.get_num_inchannels(args.model_name)
        except KeyError:
            args.in_channels = 3
    path = os.path.abspath(args.checkpoint.rstrip("/"))
    step = int(os.path.basename(path).rpartition("_")[2])
    model = api.create_model(args.model_name, in_channels=args.in_channels,
                             in_samples=args.in_samples)
    variables = api.init_variables(model, in_samples=args.in_samples,
                                   in_channels=args.in_channels)
    # The worker's optimizer runs on a schedule: its state carries the
    # schedule's count, so the template does too (the rate is not restored).
    tx = build_optimizer("adam", lambda count: 0.0, weight_decay=args.weight_decay)
    state = create_train_state(model, variables, tx)
    restored = load_checkpoint(path, state)
    if "data_epoch" not in restored["meta"]:
        raise SystemExit(f"{path} holds no resume meta (a params-only or legacy epoch "
                         "checkpoint): only a train checkpoint of the step layout converts")
    state = jax.device_get(restore_into_state(state, restored))
    out = os.path.abspath(args.out or path.split("checkpoints")[0])
    meta = {k: v.item() if hasattr(v, "item") else v for k, v in restored["meta"].items()}
    weights = save_torch_train_state(state, meta, out, step, model_name=args.model_name)
    print(f"Converted {path} -> {weights} (update step {int(state.step)}, data position "
          f"{meta['data_epoch']}:{meta['data_batch_offset']})", flush=True)
    return weights


if __name__ == "__main__":
    main()
