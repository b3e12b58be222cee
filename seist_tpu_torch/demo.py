"""``python -m seist_tpu_torch demo``: one trace through a model, its picks
and the phase-picking figure.

    python -m seist_tpu_torch demo --model-name seist_s_dpk \\
        --checkpoint seist_s_dpk.pt --input trace.npz --output-dir ./demo_out

The counterpart of ``demo_predict.py``, with its flags plus ``--device``
(default ``cuda``). ``--input`` is an ``.npz`` whose ``data`` is (3, L) or
(L, 3); without it a synthetic event is generated, so the demo always
runs. The trace is normalized per channel (``--norm-mode max`` means the
absolute maximum, as in the JAX demo), runs one forward on the device
through the serve pool's loader (``--checkpoint ''``: seeded weights), and
its picks are printed as one JSON line. The figure is drawn by
``utils/visualization.py`` with matplotlib imported there: without
matplotlib the demo raises ``ImportError`` after the picks are printed.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

import numpy as np


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m seist_tpu_torch demo",
                                 description="seist_tpu_torch demo inference")
    ap.add_argument("--model-name", default="seist_s_dpk", type=str)
    ap.add_argument("--checkpoint", default="", type=str)
    ap.add_argument("--input", default="", type=str, help=".npz with 'data'")
    ap.add_argument("--in-samples", default=8192, type=int)
    ap.add_argument("--sampling-rate", default=50, type=int)
    ap.add_argument("--norm-mode", default="std", type=str)
    ap.add_argument("--output-dir", default="./demo_out", type=str)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def normalize(data: np.ndarray, mode: str = "std") -> np.ndarray:
    """Per-channel demean and scale along time; the demo's ``'max'`` is the
    absolute maximum (``demo_predict.py``), unlike the train pipeline's."""
    from seist_tpu_torch.data.preprocess import normalize as _norm

    return _norm(data, "absmax" if mode == "max" else "std", axis=-1)


def load_data(path: str, in_samples: int) -> np.ndarray:
    """(3, in_samples): the ``.npz``'s ``data``, or a synthetic event."""
    if path:
        data = np.asarray(np.load(path)["data"], dtype=np.float32)
        if data.shape[0] > data.shape[-1]:  # (L, C) -> (C, L)
            data = data.T
    else:
        from seist_tpu_torch.data.synthetic import Synthetic

        ds = Synthetic(seed=0, mode="test", num_events=4, trace_samples=in_samples)
        data = ds[0][0]["data"]
    return data[:, :in_samples]


def predict_trace(args: argparse.Namespace) -> Dict[str, Any]:
    """The normalized trace ``data`` (C, L), the model's ``preds`` (L, 3) as
    numpy, and its ``picks`` (the serve path's decode)."""
    import torch

    from seist_tpu_torch.serve.pool import decode_outputs, load_model_entry
    from seist_tpu_torch.serve.protocol import PredictOptions

    entry = load_model_entry(args.model_name, args.checkpoint, window=args.in_samples,
                             device=args.device)
    data = normalize(load_data(args.input, args.in_samples), args.norm_mode)
    x = torch.from_numpy(np.ascontiguousarray(data.T[None], np.float32)).to(entry.device)
    with torch.inference_mode():
        out = entry.model(x)
    picks = decode_outputs(entry, out, PredictOptions.from_dict(
        {"sampling_rate": args.sampling_rate}))
    return {"data": data, "preds": out[0].float().cpu().numpy(), "picks": picks}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run, print the picks, plot; returns :func:`predict_trace`'s dict and
    the figure's ``paths``."""
    args = get_args(argv)
    res = predict_trace(args)
    print(json.dumps({"model": args.model_name, **res["picks"]}), flush=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(f"the demo's figure needs matplotlib, which is not installed; the "
                          f"picks above are the demo's result ({e})") from e
    from seist_tpu_torch.utils.visualization import vis_phase_picking

    res["paths"] = vis_phase_picking(
        waveforms=res["data"],
        waveforms_labels=["Z", "N", "E"],
        preds=res["preds"].T,
        true_phase_idxs=[],
        true_phase_labels=[],
        pred_phase_labels=["Detection", "P-phase", "S-phase"],
        sampling_rate=args.sampling_rate,
        save_name=f"_{args.model_name}",
        save_dir=args.output_dir,
    )
    print(f"Saved: {res['paths']}", flush=True)
    return res
