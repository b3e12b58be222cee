#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught; a failed check exits
non-zero before the last line):

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. build the attention kernel from ``seist_tpu_torch/csrc`` with nvcc;
3. hold the kernel against its plain PyTorch version on the card: at the
   five attention shapes of one ``seist_l_dpk`` forward at window 8192
   (batch 8) in fp32 and bf16, at ragged shapes, at M = 1024, and with
   dropout at rate 0.1, where the zero pattern must be identical;
4. serve ``seist_l_dpk`` at window 8192 with seeded weights through the
   port's server, answer concurrent ``/predict`` requests with the plain
   version patched to raise, count the kernel's launches over exactly that
   run (5 per forward), and hold one response against the same trace run
   through the port on the CPU;
5. time the kernel, the plain version and ``F.scaled_dot_product_attention``
   (a yardstick only: the port never calls it) at each shape, and the
   model's forward per batch bucket.

It prints one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seist_tpu_torch.data.preprocess import normalize
from seist_tpu_torch.models import api
from seist_tpu_torch.ops import _kernels
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.serve import server as srv
from seist_tpu_torch.serve.pool import decode_outputs, load_model_entry
from seist_tpu_torch.serve.protocol import PredictOptions

MODEL = "seist_l_dpk"
WINDOW = 8192
BATCH = 8  # the largest serve bucket
N_REQUESTS = 24
SEED = 0
KERNEL = "pooled_attention_fwd"

FP32_TOL = 1e-5  # fp32 max abs error, kernel vs plain: summation order only
# bf16: both sides compute in fp32 and round the output to bf16; a 1e-7
# difference can flip one rounding, so the limit is one bf16 ulp
# (2^-7 relative) at |o| < 2, the range of a softmax-weighted average of
# unit-normal values.
BF16_TOL = 2.0 ** -6
PICK_TOL_S = 0.1  # per pick, GPU response vs the CPU run of the same trace
PROB_TOL = 1e-4  # model output, GPU vs CPU: cuDNN and CPU conv sum orders differ

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the kernel
# computes in fp32 on the CUDA cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ inputs
def qkv(n: int, l: int, m: int, h: int, e: int, dtype, seed: int, dev):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(n, l, h, e, generator=g)
    k = torch.randn(n, m, h, e, generator=g)
    v = torch.randn(n, m, h, e, generator=g)
    return [t.to(dev, dtype) for t in (q, k, v)]


def kernel(q, k, v, rate=0.0, seed=0):
    """One launch through the wrapper, not counted against the main path."""
    launches = pa.launches
    o = pa.fused_pooled_attention(q, k, v, dropout_rate=rate, dropout_seed=seed)
    pa.launches = launches
    return o


def plain(q, k, v, rate=0.0, seed=0):
    return pa.pooled_attention_plain(q, k, v, 1.0 / math.sqrt(q.shape[-1]), rate, seed)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------- phase 3
def check_kernel(shapes: List[Tuple[int, int, int, int]], dev) -> Dict[str, float]:
    errs = {"fp32": 0.0, "bf16": 0.0}
    for i, (l, m, h, e) in enumerate(shapes):
        for name, dtype, tol in (("fp32", torch.float32, FP32_TOL),
                                 ("bf16", torch.bfloat16, BF16_TOL)):
            q, k, v = qkv(BATCH, l, m, h, e, dtype, 100 + i, dev)
            err = max_err(kernel(q, k, v), plain(q, k, v))
            print(f"[check] N={BATCH} L={l} M={m} H={h} E={e} {name}: "
                  f"max_abs_err {err:.3e} (limit {tol:.1e})", flush=True)
            if not err <= tol:
                fail(f"kernel disagrees with plain at {(l, m, h, e)} {name}")
            errs[name] = max(errs[name], err)
        q, k, v = qkv(BATCH, l, m, h, e, torch.float32, 200 + i, dev)
        err = max_err(kernel(q, k, v, 0.1, 1234), plain(q, k, v, 0.1, 1234))
        print(f"[check] N={BATCH} L={l} M={m} H={h} E={e} fp32 dropout 0.1: "
              f"max_abs_err {err:.3e} (limit {FP32_TOL:.1e})", flush=True)
        if not err <= FP32_TOL:
            fail(f"kernel with dropout disagrees with plain at {(l, m, h, e)}")
    for n, l, m, h, e in ((2, 1000, 125, 3, 8), (2, 1000, 125, 2, 20), (1, 8192, 1024, 3, 8)):
        q, k, v = qkv(n, l, m, h, e, torch.float32, 300 + l + m, dev)
        err = max_err(kernel(q, k, v), plain(q, k, v))
        print(f"[check] N={n} L={l} M={m} H={h} E={e} fp32: max_abs_err {err:.3e} "
              f"(limit {FP32_TOL:.1e})", flush=True)
        if not err <= FP32_TOL:
            fail(f"kernel disagrees with plain at ragged/long {(n, l, m, h, e)}")
    # Zero pattern: with v_h the identity (M <= E), O_h is the dropped
    # probability matrix itself, so its zeros are the dropout mask.
    n, l, m, h, e = 2, 1000, 32, 3, 32
    q, k, _ = qkv(n, l, m, h, e, torch.float32, 400, dev)
    v = torch.eye(m, e, device=dev).reshape(1, m, 1, e).expand(n, m, h, e).contiguous()
    ok, op = kernel(q, k, v, 0.1, 77), plain(q, k, v, 0.1, 77)
    same = bool(torch.equal(ok == 0, op == 0))
    frac = float((op == 0).float().mean() * e / m)
    print(f"[check] dropout zero pattern N={n} L={l} M={m} H={h}: identical={same}, "
          f"dropped fraction {frac:.4f} (rate 0.1)", flush=True)
    if not same or not 0.08 < frac < 0.12:
        fail("dropout zero pattern differs from the plain version")
    return errs


# ------------------------------------------------------------- phase 4
@torch.no_grad()
def seeded_weights(path: str) -> None:
    """seist_l_dpk weights drawn from SEED, with kernels at std
    0.5/sqrt(fan_in) and random BatchNorm statistics so activations stay
    O(1) through the depth: the JAX package's std-0.02 init shrinks them
    to an output of exactly 0.5 everywhere, which has no picks to compare."""
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED)
    g = torch.Generator().manual_seed(SEED)
    for name, t in model.state_dict().items():
        if t.ndim >= 2:
            fan_in = t[0].numel()
            t.copy_(torch.randn(t.shape, generator=g) * (0.5 / math.sqrt(fan_in)))
        elif name.endswith(("running_var", ".weight")):
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
        else:
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    torch.save(model.state_dict(), path)


def post(url: str, body: dict) -> Tuple[int, dict]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:  # the status is checked by the caller
        return e.code, {"error": e.read().decode(errors="replace")}


def traces(n: int) -> np.ndarray:
    """Seeded noise with one P/S-like burst pair per trace, (n, 3, WINDOW)."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, 3, WINDOW)).astype(np.float32)
    t = np.arange(WINDOW)
    for i in range(n):
        p = rng.integers(1000, 5000)
        for onset, amp in ((p, 6.0), (p + rng.integers(300, 1500), 10.0)):
            env = np.where(t >= onset, np.exp(-(t - onset) / 200.0), 0.0)
            x[i] += (amp * env * rng.standard_normal(WINDOW)).astype(np.float32)
    return x


def picks_close(a: dict, b: dict, tol_samples: float) -> bool:
    for kind in ("ppk", "spk"):
        sa = sorted(p["sample"] for p in a[kind])
        sb = sorted(p["sample"] for p in b[kind])
        if len(sa) != len(sb) or any(abs(x - y) > tol_samples for x, y in zip(sa, sb)):
            return False
    da = sorted((d["onset"], d["offset"]) for d in a["det"])
    db = sorted((d["onset"], d["offset"]) for d in b["det"])
    return len(da) == len(db) and all(
        abs(x[0] - y[0]) <= tol_samples and abs(x[1] - y[1]) <= tol_samples
        for x, y in zip(da, db)
    )


def serve_phase(weights: str, n_shapes: int) -> dict:
    service = srv.build_service([(MODEL, weights)], window=WINDOW, device="cuda",
                                max_batch=BATCH, max_delay_ms=20.0)
    server = srv.start_http_server(service, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    data = traces(N_REQUESTS)
    opts = {"max_events": 1}
    results: List[Tuple[int, dict, float]] = [None] * N_REQUESTS

    def one(i: int) -> None:
        t0 = time.perf_counter()
        status, body = post(url + "/predict", {"data": data[i].tolist(), "options": opts})
        results[i] = (status, body, (time.perf_counter() - t0) * 1e3)

    real_plain = pa.pooled_attention_plain

    def plain_off_path(*a, **k):
        raise AssertionError("pooled_attention_plain reached on the serve path")

    pa.pooled_attention_plain = plain_off_path
    pa.launches = 0
    threads = [threading.Thread(target=one, args=(i,)) for i in range(N_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    launches = pa.launches
    pa.pooled_attention_plain = real_plain
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        metrics = json.loads(r.read())
    server.shutdown()
    service.shutdown()

    if any(r is None for r in results):
        fail("a /predict request did not finish")
    for status, body, _ in results:
        if status != 200 or body.get("task") != "picking" or not all(
            isinstance(body.get(k), list) for k in ("ppk", "spk", "det")
        ):
            fail(f"bad /predict response: {status} {str(body)[:200]}")
    stats = metrics["models"][MODEL]
    forwards = stats["forwards"]
    print(f"[serve] {N_REQUESTS} requests -> {forwards} forwards, batch fill "
          f"{stats['batch_fill_ratio']:.3f}, kernel launches {launches} "
          f"(/metrics {metrics['kernels'][KERNEL]['launches']})", flush=True)
    if stats["completed"] != N_REQUESTS or launches != n_shapes * forwards or forwards < 1:
        fail(f"launches {launches} != {n_shapes} x forwards {forwards}")

    # The same trace through the port on the CPU, and the raw outputs of both.
    entry = service.entries[MODEL]
    cpu = load_model_entry(MODEL, weights, window=WINDOW, device="cpu")
    x = normalize(data[0].T, "std", axis=0).astype(np.float32)[None]
    out_gpu, out_cpu = entry.run(x), cpu.run(x)
    popts = PredictOptions.from_dict(opts)
    ref = decode_outputs(cpu, out_cpu, popts)
    prob_err = max_err(out_gpu.cpu(), out_cpu)
    n_picks = sum(len(ref[k]) for k in ("ppk", "spk", "det"))
    print(f"[serve] response 0 vs CPU run: gpu {json.dumps(results[0][1])} cpu "
          f"{json.dumps(ref)}; output max_abs_err {prob_err:.3e} (limit {PROB_TOL:.0e})",
          flush=True)
    if not picks_close(results[0][1], ref, PICK_TOL_S * popts.sampling_rate):
        fail("GPU response picks differ from the CPU run by more than 0.1 s")
    if not prob_err <= PROB_TOL or n_picks == 0:
        fail(f"GPU output vs CPU {prob_err:.3e}, {n_picks} picks in the reference")
    lat = np.array([r[2] for r in results])
    return {
        "entry": entry,
        "launches": launches,
        "forwards": forwards,
        "client_p50_ms": float(np.percentile(lat, 50)),
        "client_p99_ms": float(np.percentile(lat, 99)),
        "server_latency_ms": stats["latency_ms"],
    }


# ------------------------------------------------------------- phase 5
def time_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n, l, m, h, e, itemsize, peak_ops) -> Tuple[float, float]:
    """(bytes_ms, ops_ms): q, k, v read once and o written once; 4*N*L*M*H*E
    operations (a multiply-add each for QK^T and PV)."""
    nbytes = itemsize * n * h * e * (2 * l + 2 * m)
    ops = 4 * n * l * m * h * e
    return nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3


def time_shapes(shapes, dev) -> List[dict]:
    rows = []
    for i, (l, m, h, e) in enumerate(shapes):
        for name, dtype, peak in (("fp32", torch.float32, PEAK_FP32_S),
                                  ("bf16", torch.bfloat16, PEAK_BF16_S)):
            q, k, v = qkv(BATCH, l, m, h, e, dtype, 500 + i, dev)
            scale = 1.0 / math.sqrt(e)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ms = time_ms(lambda: kernel(q, k, v), 200)
            plain_ms = time_ms(lambda: plain(q, k, v), 50)
            lib_ms = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), 200
            )
            b_ms, o_ms = bound(BATCH, l, m, h, e, q.element_size(), peak)
            rows.append({"L": l, "M": m, "H": h, "E": e, "dtype": name, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bytes_ms": b_ms, "ops_ms": o_ms})
    return rows


def time_forward(entry) -> Dict[int, float]:
    out = {}
    for b in (1, 2, 4, 8):
        x = np.random.default_rng(b).standard_normal((b, WINDOW, 3)).astype(np.float32)
        out[b] = time_ms(lambda: entry.run(x), 20, warmup=3)
    return out


def profile_forward(entry, iters: int = 5) -> dict:
    """torch.profiler over ``iters`` batch-8 forwards: device busy share of
    the wall time, kernels per forward, and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.random.default_rng(0).standard_normal((BATCH, WINDOW, 3)).astype(np.float32)
    entry.run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            entry.run(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "wall_ms_per_forward": wall_ms / iters,
        "device_busy_ms_per_forward": busy_ms / iters,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_forward": sum(e.count for e in dev_events) / iters,
        "top": [(e.key[:60], e.self_device_time_total / 1e3 / iters, e.count // iters)
                for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name_power = card()
    print(name_power, flush=True)  # the nvidia-smi line as it gives it
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    _kernels.build(KERNEL)
    print(f"[build] {KERNEL}: {_kernels.BUILD_SECONDS[KERNEL]:.2f} s "
          f"({_kernels.library_path(KERNEL).name})", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = api.create_model(MODEL, in_samples=WINDOW).attention_shapes(WINDOW)
    print(f"[shapes] {MODEL} window {WINDOW}: (L, M, H, E) per launch {shapes}", flush=True)
    errs = check_kernel(shapes, dev)

    weights = os.path.join(str(_kernels.BUILD_DIR), f"{MODEL}_seed{SEED}.pt")
    seeded_weights(weights)
    served = serve_phase(weights, len(shapes))

    rows = time_shapes(shapes, dev)
    for r in rows:
        print(f"[time] {name_power} | N={BATCH} L={r['L']} M={r['M']} H={r['H']} "
              f"E={r['E']} {r['dtype']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
              f"{max(r['bytes_ms'], r['ops_ms']):.5f} ms (bytes {r['bytes_ms']:.5f}, "
              f"ops {r['ops_ms']:.5f})", flush=True)
    fwd = time_forward(served["entry"])
    for b, ms in fwd.items():
        print(f"[time] {name_power} | {MODEL} window {WINDOW} forward b{b}: {ms:.3f} ms",
              flush=True)
    prof = profile_forward(served["entry"])
    print(f"[profile] {name_power} | {MODEL} window {WINDOW} b{BATCH}: wall "
          f"{prof['wall_ms_per_forward']:.3f} ms/forward, device busy "
          f"{prof['device_busy_ms_per_forward']:.3f} ms, idle share "
          f"{prof['device_idle_share']:.3f}, {prof['kernels_per_forward']:.0f} "
          f"kernels/forward", flush=True)
    for key, ms, count in prof["top"]:
        print(f"[profile]   {ms:.3f} ms/forward in {count} launches: {key}", flush=True)
    lat = served["server_latency_ms"]
    print(f"[time] {name_power} | /predict x{N_REQUESTS} concurrent: client p50 "
          f"{served['client_p50_ms']:.1f} ms p99 {served['client_p99_ms']:.1f} ms; "
          f"server p50 {lat['p50']:.1f} ms p99 {lat['p99']:.1f} ms", flush=True)

    fp32 = [r for r in rows if r["dtype"] == "fp32"]  # the serving path is fp32
    bytes_ms = sum(r["bytes_ms"] for r in fp32)
    ops_ms = sum(r["ops_ms"] for r in fp32)
    print(json.dumps({"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_fwd.cu",
        "replaces": "seist_tpu/ops/pallas_attention.py:137",
        "launches": served["launches"],
        "max_abs_err": errs["fp32"],
        "ms": sum(r["ms"] for r in fp32),
        "plain_ms": sum(r["plain_ms"] for r in fp32),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in fp32),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
