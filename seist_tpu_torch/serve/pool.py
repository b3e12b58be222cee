"""Model entries: load one servable model, warm it up, decode its outputs.

Counterpart of ``seist_tpu/serve/pool.py``'s single-task path
(``ModelEntry``, ``load_model_entry``, ``decode_outputs``): one model per
entry, one variant (fp32). Multi-task groups, the bf16/int8 variants,
reload and canary wait for later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from seist_tpu_torch import taskspec
from seist_tpu_torch.ops.postprocess import process_outputs
from seist_tpu_torch.serve.protocol import (
    BadRequest,
    PredictOptions,
    ServeError,
    UnknownModel,
)
from seist_tpu_torch.utils.logger import logger


def resolve_device(device: str) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (there is no
    silent CPU path: the caller asks for the CPU by name)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' requested but CUDA is not available; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}' (cuda or cpu)")
    return dev


@dataclass
class ModelEntry:
    """One servable model: everything needed to forward and decode."""

    name: str
    model: torch.nn.Module
    spec: taskspec.TaskSpec
    window: int
    in_channels: int
    device: torch.device

    @property
    def is_picker(self) -> bool:
        """Dense per-sample heads (det/ppk/spk) decode to picks."""
        first = self.spec.labels[0]
        return isinstance(first, tuple) and len(first) == 3 and first[0] in ("non", "det")

    def run(self, batch: np.ndarray) -> torch.Tensor:
        """The request-path forward: (B, window, C) numpy -> outputs on the
        entry's device."""
        x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
        with torch.inference_mode():
            return self.model(x.to(self.device))

    def warmup(self, buckets: Sequence[int]) -> List[Dict[str, Any]]:
        """Run every bucket once; the first run builds the CUDA kernel."""
        report = []
        for b in buckets:
            t0 = time.perf_counter()
            out = self.run(np.zeros((b, self.window, self.in_channels), np.float32))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if not bool(torch.isfinite(out).all()):
                raise ServeError(f"warm-up of {self.name} b{b} gave non-finite outputs")
            ms = (time.perf_counter() - t0) * 1e3
            report.append({"model": self.name, "batch": b, "ms": ms})
            logger.info(f"[serve] warm-up {self.name} b{b}: {ms:.1f} ms")
        return report


def load_model_entry(
    model_name: str,
    weights: str = "",
    *,
    window: int = 8192,
    seed: int = 0,
    device: str = "cuda",
) -> ModelEntry:
    """Create one model for inference on ``device``.

    Without ``weights`` the model serves weights drawn from ``seed``
    (tests, smoke runs); with a ``.pt`` path (models/convert.py writes
    one) the state_dict loads strictly, so a file for another
    architecture raises here, before anything serves.
    """
    from seist_tpu_torch.models import api

    dev = resolve_device(device)
    if dev.type == "cuda":
        # The fp32 variant is the parity reference: cuDNN convolutions
        # default to TF32 (about 3 decimal digits), so both are set off.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        logger.info("[serve] fp32 path: TF32 off for cuDNN convs and matmuls")
    spec = taskspec.get_task_spec(model_name)
    in_channels = taskspec.get_num_inchannels(model_name)
    model = api.create_model(model_name, in_channels=in_channels, in_samples=window, seed=seed)
    if weights:
        state = torch.load(weights, map_location="cpu", weights_only=True)
        model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    return ModelEntry(
        name=model_name,
        model=model,
        spec=spec,
        window=window,
        in_channels=in_channels,
        device=dev,
    )


def decode_outputs(entry: ModelEntry, outputs: torch.Tensor, opts: PredictOptions) -> Dict[str, Any]:
    """One request's raw model outputs (leading dim 1, on the entry's
    device) -> JSON-able result. Picking heads run ops/postprocess on the
    device and come back in one transfer; value heads report their scalar,
    one-hot heads the argmax class and the scores."""
    spec = entry.spec
    with torch.inference_mode():
        if entry.is_picker:
            res = process_outputs(
                outputs,
                spec.labels,
                opts.sampling_rate,
                ppk_threshold=opts.ppk_threshold,
                spk_threshold=opts.spk_threshold,
                det_threshold=opts.det_threshold,
                min_peak_dist=opts.min_peak_dist,
                max_detect_event_num=opts.max_events,
            )
            keys = [k for k in ("ppk", "spk", "det") if k in res]
            host = torch.cat([res[k].reshape(-1) for k in keys]).cpu().numpy()
            fs = float(opts.sampling_rate)
            out: Dict[str, Any] = {"task": "picking"}
            at = 0
            for k in keys:
                size = res[k].numel()
                vals, at = host[at : at + size], at + size
                if k == "det":
                    pairs = vals.reshape(-1, 2)
                    pairs = pairs[pairs[:, 1] >= pairs[:, 0]]
                    out["det"] = [
                        {"onset": int(a), "offset": int(b),
                         "onset_s": round(a / fs, 6), "offset_s": round(b / fs, 6)}
                        for a, b in pairs
                    ]
                else:
                    out[k] = [
                        {"sample": int(i), "time_s": round(i / fs, 6)}
                        for i in vals[vals >= 0]
                    ]
            return out
        outs = outputs if isinstance(outputs, (tuple, list)) else [outputs]
        if len(outs) != len(spec.labels):
            raise ServeError(
                f"model '{entry.name}' produced {len(outs)} outputs for "
                f"{len(spec.labels)} labels"
            )
        result: Dict[str, Any] = {"task": "regression"}
        for name, arr in zip(spec.labels, outs):
            arr = arr.float().cpu().numpy()
            if taskspec.get_kind(name) == taskspec.ONEHOT:
                result["task"] = "classification"
                scores = arr.reshape(-1)
                result[name] = {
                    "class": int(np.argmax(scores)),
                    "scores": [float(s) for s in scores],
                }
            else:
                result[name] = float(arr.reshape(-1)[0])
        return result


def clip_picks(result: Dict[str, Any], n_real: int, fs: float) -> None:
    """Drop picks inside the zero padding of a short trace (index >=
    ``n_real``) and clip detections to the real extent."""
    if result.get("task") != "picking":
        return
    for kind in ("ppk", "spk"):
        if kind in result:
            result[kind] = [p for p in result[kind] if p["sample"] < n_real]
    if "det" in result:
        kept = []
        for d in result["det"]:
            if d["onset"] >= n_real:
                continue
            if d["offset"] >= n_real:
                d = dict(d, offset=n_real - 1, offset_s=round((n_real - 1) / fs, 6))
            kept.append(d)
        result["det"] = kept


def get_entry(entries: Dict[str, ModelEntry], model: Optional[str]) -> ModelEntry:
    """The entry a request names; the only one when it names none."""
    if model is None:
        if len(entries) != 1:
            raise BadRequest(f"'model' is required: serving {sorted(entries)}")
        return next(iter(entries.values()))
    if model not in entries:
        raise UnknownModel(f"model '{model}' is not loaded; serving {sorted(entries)}")
    return entries[model]
