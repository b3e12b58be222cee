#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught; a failed check exits
non-zero before the last line):

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. build both attention kernels from ``seist_tpu_torch/csrc`` with nvcc,
   one process per source, started together;
3. hold the forward kernel (K1) against its plain PyTorch version on the
   card: at the five attention shapes of one ``seist_l_dpk`` forward at
   window 8192 (batch 8) in fp32 and bf16, at ragged shapes, at M = 1024,
   and with dropout at rate 0.1, where the zero pattern must be identical;
4. hold the backward kernel (K2) against its plain version at the five
   shapes of a batch-64 train step in fp32 and bf16 at dropout rates 0 and
   0.3, at ragged L and M, M over one tile and E = 64, and the autograd
   function against ``torch.autograd.grad`` through the plain forward;
5. serve ``seist_l_dpk`` at window 8192 with seeded weights through the
   port's server, answer concurrent ``/predict`` requests with the plain
   versions patched to raise, count K1's launches over exactly that run
   (5 per forward), and hold one response against the same trace run
   through the port on the CPU;
6. train ``seist_l_dpk`` at window 8192, batch 64, through the entry of
   ``python -m seist_tpu_torch train`` on the synthetic dataset for one
   epoch, with both plain versions patched to raise: K1 launches 5 per
   train step and val batch, K2 5 per train step; the losses are finite,
   the parameters change, and the best checkpoint serves one trace;
7. one train step of ``seist_l_dpk`` (batch 4, attention dropout 0.3, the
   other drop rates 0) on the card and on the CPU from the same weights,
   batch and attention seeds: loss, every gradient leaf and the BatchNorm
   running statistics agree within the repo's train-mode parity limits;
8. time both kernels, their plain versions and PyTorch's
   ``scaled_dot_product_attention`` (forward and backward; a yardstick
   only: the port never calls it) at each shape, the model's forward per
   batch bucket, and the train step at batch 64 and 256 with its peak
   memory; profile a batch-8 forward and a batch-64 train step.

It prints one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
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

from seist_tpu_torch import cli, taskspec
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.data.preprocess import normalize
from seist_tpu_torch.models import api
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.ops import _kernels
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.serve import server as srv
from seist_tpu_torch.serve.pool import decode_outputs, load_model_entry
from seist_tpu_torch.serve.protocol import PredictOptions
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import constant
from seist_tpu_torch.train.step import TrainState, make_train_step

MODEL = "seist_l_dpk"
WINDOW = 8192
BATCH = 8  # the largest serve bucket
TRAIN_BATCH = 64
N_REQUESTS = 24
SEED = 0
KERNEL = "pooled_attention_fwd"
KERNEL_BWD = "pooled_attention_bwd"
# The train run: 256 synthetic events -> 204 train (x2 by augmentation ->
# 6 batches of 64) and 25 val (1 padded batch).
TRAIN_ARGS = ["--model-name", MODEL, "--dataset-name", "synthetic", "--synthetic-events",
              "256", "--in-samples", str(WINDOW), "--batch-size", str(TRAIN_BATCH),
              "--epochs", "1", "--seed", str(SEED), "--device", "cuda"]
TRAIN_STEPS, VAL_BATCHES = 6, 1

FP32_TOL = 1e-5  # fp32 max abs error, kernel vs plain: summation order only
# bf16: both sides compute in fp32 and round the output to bf16; a 1e-7
# difference can flip one rounding, so the limit is one bf16 ulp
# (2^-7 relative) at |o| < 2, the range of a softmax-weighted average of
# unit-normal values.
BF16_TOL = 2.0 ** -6
PICK_TOL_S = 0.1  # per pick, GPU response vs the CPU run of the same trace
PROB_TOL = 1e-4  # model output, GPU vs CPU: cuDNN and CPU conv sum orders differ
# K2 against its plain version, per output, relative to max(1, max|plain|):
# fp32 sums over up to L rows in another order; bf16 may flip one rounding
# of the largest output (one bf16 ulp is 2^-7 relative).
BWD_FP32_TOL = 1e-5
BWD_BF16_TOL = 2.0 ** -7
# GPU vs CPU train step, the repo's train-mode parity conventions
# (tests/test_golden_parity.py): loss rtol 1e-5; every gradient leaf at
# cosine >= 0.9999 and max error <= 5e-3 of its max; leaves that are zero
# by construction below 1e-6 of the largest gradient; BatchNorm running
# statistics rtol 1e-4, atol 1e-5.
LOSS_RTOL = 1e-5
GRAD_COS = 0.9999
GRAD_REL = 5e-3
ZERO_REL = 1e-6
BN_RTOL, BN_ATOL = 1e-4, 1e-5

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the kernel
# computes in fp32 on the CUDA cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12


def ptxas_summary(log: str) -> List[str]:
    """``kernel<type,EP>:registers/spill-store-bytes`` per compiled kernel,
    from nvcc's ``-Xptxas -v`` output."""
    out, cur, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            kind = re.search(r"(bwd_rows|bwd_keys|bwd_reduce|fwd)_kernel", cur)
            ep = re.search(r"Li(\d+)E", cur)
            out.append(f"{kind.group(1) if kind else cur[:24]}"
                       f"<{'bf16' if 'bfloat16' in cur else 'f32'}"
                       f"{',' + ep.group(1) if ep else ''}>:{m.group(1)}/{spill}")
            cur, spill = None, 0
    return out


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


# ------------------------------------------------------------- phase 5
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


# ------------------------------------------------------------- phase 4
def qkvg(n: int, l: int, m: int, h: int, e: int, dtype, seed: int, dev):
    q, k, v = qkv(n, l, m, h, e, dtype, seed, dev)
    g = torch.randn(n, l, h, e, generator=torch.Generator().manual_seed(seed + 1))
    return q, k, v, g.to(dev, dtype)


def kernel_bwd(q, k, v, g, rate=0.0, seed=0):
    """One backward launch, not counted against the main path."""
    launches = pa.bwd_launches
    out = pa._backward(q, k, v, g, 1.0 / math.sqrt(q.shape[-1]), rate, seed)
    pa.bwd_launches = launches
    return out


def plain_bwd(q, k, v, g, rate=0.0, seed=0):
    return pa.pooled_attention_bwd_plain(q, k, v, g, 1.0 / math.sqrt(q.shape[-1]), rate, seed)


def bwd_err(got, want) -> float:
    """max over dq, dk, dv of max|kernel - plain| / max(1, max|plain|)."""
    return max(max_err(a, b) / max(1.0, float(b.float().abs().max()))
               for a, b in zip(got, want))


def check_kernel_bwd(shapes, dev) -> float:
    """Returns the largest fp32 max abs error over every output checked."""
    worst = 0.0
    cases = [(TRAIN_BATCH,) + s for s in shapes]
    cases += [(2, 1000, 125, 3, 8), (2, 300, 200, 2, 20), (2, 130, 65, 3, 64),
              (1, 4096, 512, 3, 16)]
    for i, (n, l, m, h, e) in enumerate(cases):
        for name, dtype, tol in (("fp32", torch.float32, BWD_FP32_TOL),
                                 ("bf16", torch.bfloat16, BWD_BF16_TOL)):
            for rate in (0.0, 0.3):
                q, k, v, g = qkvg(n, l, m, h, e, dtype, 600 + i, dev)
                got = kernel_bwd(q, k, v, g, rate, 4321)
                want = plain_bwd(q, k, v, g, rate, 4321)
                err = bwd_err(got, want)
                print(f"[check-bwd] N={n} L={l} M={m} H={h} E={e} {name} rate {rate}: "
                      f"rel err {err:.3e} (limit {tol:.1e})", flush=True)
                if not err <= tol:
                    fail(f"backward kernel disagrees with plain at {(n, l, m, h, e)} "
                         f"{name} rate {rate}")
                if dtype == torch.float32:
                    worst = max([worst] + [max_err(a, b) for a, b in zip(got, want)])
    # The autograd function (K1 forward, K2 backward) against autograd
    # through the plain forward, with dropout.
    n, l, m, h, e = 8, 1024, 128, 2, 8
    q, k, v, g = qkvg(n, l, m, h, e, torch.float32, 700, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(pa.pooled_attention_plain(*leaves, 0.35, 0.3, 11), leaves, g)
    fwd, bwd = pa.launches, pa.bwd_launches
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = pa.fused_pooled_attention(*leaves, 0.35, dropout_rate=0.3, dropout_seed=11)
    got = torch.autograd.grad(out, leaves, g)
    pa.launches, pa.bwd_launches = fwd, bwd
    err = bwd_err(got, want)
    print(f"[check-bwd] autograd N={n} L={l} M={m} H={h} E={e} rate 0.3 vs "
          f"torch.autograd.grad of the plain forward: rel err {err:.3e}", flush=True)
    if not err <= BWD_FP32_TOL:
        fail("autograd through the kernels disagrees with autograd through plain")
    return max([worst] + [max_err(a, b) for a, b in zip(got, want)])


# ------------------------------------------------------------- phase 6
def train_phase(log_base: str, n_shapes: int) -> dict:
    """Train through the CLI entry with both plain versions patched to
    raise; count both kernels over exactly that run."""
    real = pa.pooled_attention_plain, pa.pooled_attention_bwd_plain

    def off_path(*a, **k):
        raise AssertionError("a plain attention version was reached on the train path")

    pa.pooled_attention_plain = pa.pooled_attention_bwd_plain = off_path
    pa.launches = pa.bwd_launches = 0
    t0 = time.perf_counter()
    best = cli.main(TRAIN_ARGS + ["--log-base", log_base])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, bwd_launches = pa.launches, pa.bwd_launches
    pa.pooled_attention_plain, pa.pooled_attention_bwd_plain = real

    log_dir = os.path.dirname(os.path.dirname(best))
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    val = np.load(os.path.join(log_dir, "val_losses.npy"))
    print(f"[train] {MODEL} window {WINDOW} batch {TRAIN_BATCH}: {len(losses)} steps, "
          f"losses {[round(float(x), 5) for x in losses]}, val {val.tolist()}, "
          f"K1 launches {launches}, K2 launches {bwd_launches}, wall {wall_s:.1f} s",
          flush=True)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not np.isfinite(val).all():
        fail(f"train losses: {losses}, val {val}")
    if (launches != n_shapes * (TRAIN_STEPS + VAL_BATCHES)
            or bwd_launches != n_shapes * TRAIN_STEPS):
        fail(f"K1 launches {launches} != {n_shapes} x {TRAIN_STEPS + VAL_BATCHES} or K2 "
             f"launches {bwd_launches} != {n_shapes} x {TRAIN_STEPS}")
    trained = torch.load(best, map_location="cpu", weights_only=True)
    init = api.create_model(MODEL, in_samples=WINDOW, seed=SEED).state_dict()
    params = [k for k in init if not k.endswith(("running_mean", "running_var"))]
    changed = sum(not torch.equal(trained[k], init[k]) for k in params)
    print(f"[train] {changed}/{len(params)} parameter tensors changed; best checkpoint "
          f"{os.path.relpath(best)}", flush=True)
    if changed < 0.9 * len(params) or not all(torch.isfinite(t).all() for t in trained.values()):
        fail("training did not change the parameters, or made them non-finite")
    entry = load_model_entry(MODEL, best, window=WINDOW, device="cuda")
    x = normalize(traces(1)[0].T, "std", axis=0).astype(np.float32)[None]
    out = entry.run(x)
    res = decode_outputs(entry, out, PredictOptions.from_dict({}))
    print(f"[train] the best checkpoint serves: {json.dumps(res)[:200]}", flush=True)
    if not bool(torch.isfinite(out).all()) or res.get("task") != "picking":
        fail("the trained checkpoint does not serve")
    return {"launches": launches, "bwd_launches": bwd_launches, "wall_s": wall_s}


# ------------------------------------------------------------- phase 7
def train_batch(n: int):
    """``n`` preprocessed synthetic train samples (inputs, targets)."""
    spec = taskspec.get_task_spec(MODEL)
    ds = pipeline.from_task_spec(spec, "synthetic", "train", seed=SEED, in_samples=WINDOW,
                                 dataset_kwargs={"num_events": 64})
    samples = [ds[i] for i in range(n)]
    return (torch.from_numpy(np.stack([s[0] for s in samples])),
            torch.from_numpy(np.stack([s[1] for s in samples])))


def one_step(weights: str, x, y, device: str):
    """One guarded train step on ``device``: attention dropout 0.3, every
    other drop rate 0; returns (loss, grads by name, running stats)."""
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED, attn_drop_rate=0.3,
                             path_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0,
                             other_drop_rate=0.0)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    model.to(device)
    state = TrainState(model, build_optimizer("adam", model.parameters()), constant(1e-3))
    rng = RandomSource(seed_generator=torch.Generator().manual_seed(SEED))
    loss, _, diag = make_train_step(taskspec.make_loss(MODEL))(state, x.to(device),
                                                              y.to(device), rng)
    if not diag["applied"]:
        fail(f"the parity step was skipped on {device}")
    grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
    stats = {k: b.detach().cpu() for k, b in model.named_buffers()}
    return float(loss), grads, stats


def gpu_vs_cpu_step(weights: str) -> dict:
    x, y = train_batch(4)
    # Gradients that are zero in exact arithmetic under the parity step's
    # drop rates (see SeismogramTransformer.zero_grad_parameters).
    zero = set(api.create_model(MODEL, in_samples=WINDOW, path_drop_rate=0.0,
                                key_drop_rate=0.0, mlp_drop_rate=0.0,
                                other_drop_rate=0.0).zero_grad_parameters())
    t0 = time.perf_counter()
    loss_g, grads_g, stats_g = one_step(weights, x, y, "cuda")
    loss_c, grads_c, stats_c = one_step(weights, x, y, "cpu")
    cpu_s = time.perf_counter() - t0
    gscale = max(float(g.abs().max()) for g in grads_c.values())
    worst_cos, worst_rel, zeros = 1.0, 0.0, 0
    for k, gc in grads_c.items():
        gg = grads_g[k]
        if k in zero:
            zeros += 1
            if max(float(gc.abs().max()), float(gg.abs().max())) >= ZERO_REL * gscale:
                fail(f"{k}: gradient should be ~0, got {float(gg.abs().max()):.3e}")
            continue
        cos = float((gg * gc).sum() / (gg.norm() * gc.norm()))
        rel = float((gg - gc).abs().max() / max(float(gc.abs().max()), 1e-12))
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
        if not (cos >= GRAD_COS and rel <= GRAD_REL):
            fail(f"{k}: gradient cosine {cos:.6f}, rel err {rel:.3e}")
    bn_err = 0.0
    for k, sc in stats_c.items():
        sg = stats_g[k]
        if not torch.allclose(sg, sc, rtol=BN_RTOL, atol=BN_ATOL):
            fail(f"running stat {k} differs: {float((sg - sc).abs().max()):.3e}")
        bn_err = max(bn_err, float((sg - sc).abs().max()))
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    print(f"[parity] {MODEL} train step b4 GPU vs CPU: loss {loss_g:.7f} vs {loss_c:.7f} "
          f"(rel {loss_rel:.2e}, limit {LOSS_RTOL:.0e}); {len(grads_c) - zeros} grad leaves, "
          f"worst cosine {worst_cos:.7f} (limit {GRAD_COS}), worst rel err {worst_rel:.2e} "
          f"(limit {GRAD_REL:.0e}); {zeros} zero-by-construction leaves ~0; BN stats max "
          f"abs diff {bn_err:.2e}; {cpu_s:.1f} s", flush=True)
    if not loss_rel <= LOSS_RTOL:
        fail("GPU and CPU train-step losses differ")
    return {"worst_cos": worst_cos, "worst_rel": worst_rel}


# ------------------------------------------------------------- phase 8
def device_ms(fn, iters: int = 20, attempts: int = 5) -> float:
    """Device time per call of ``fn``: the sum of the kernels it launches,
    from torch.profiler. Unlike :func:`time_ms` it leaves out the host's
    time between launches, which a call of a small kernel can exceed.

    A trace can come back with kernels missing or with others' kernels in
    it (on an H100: the first traces of a process, and once in 90 later
    ones, where a K2 shape read a tenth of its time), so it must hold
    ``iters`` times the kernels of a one-call trace; another attempt is
    made when it does not. :func:`main` spends the first traces of the
    process on a throwaway measurement."""
    from torch.profiler import ProfilerActivity, profile

    def trace(calls: int):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_kernels(prof)
        return sum(e.count for e in events), sum(e.self_device_time_total for e in events)

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(attempts):
        per_call, _ = trace(1)
        count, us = trace(iters)
        if per_call > 0 and count == per_call * iters:
            return us / 1e3 / iters
        counts.append((per_call, count))
        print(f"[time] profiler trace incomplete: {count} kernels over {iters} calls, "
              f"{per_call} in one; tracing again", flush=True)
    fail(f"profiler traces never held every kernel (per call, total): {counts}")


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Wall time per call between CUDA events around ``iters`` calls: the
    device time, or the host's time to issue a call when that is longer."""
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
            fns = {"ms": lambda: kernel(q, k, v), "plain_ms": lambda: plain(q, k, v),
                   "library_ms": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                        scale=scale)}
            row = {"L": l, "M": m, "H": h, "E": e, "dtype": name}
            for key, fn in fns.items():
                row[key] = device_ms(fn)
                row["call_" + key] = time_ms(fn, 200 if key != "plain_ms" else 50)
            row["bytes_ms"], row["ops_ms"] = bound(BATCH, l, m, h, e, q.element_size(), peak)
            rows.append(row)
    return rows


def bound_bwd(n, l, m, h, e, itemsize) -> Tuple[float, float]:
    """(bytes_ms, ops_ms) of K2: q, k, v, g read once and dq, dk, dv
    written once; 10*N*L*M*H*E operations (a multiply-add each for QK^T
    recomputed, dPd, dV, dQ and dK) on the fp32 CUDA cores."""
    nbytes = itemsize * n * h * e * (3 * l + 4 * m)
    ops = 10 * n * l * m * h * e
    return nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3


def time_bwd_shapes(shapes, dev) -> List[dict]:
    """K2, its plain version and the backward of
    ``F.scaled_dot_product_attention`` (rate 0) at the train step's shapes."""
    rows = []
    for i, (l, m, h, e) in enumerate(shapes):
        q, k, v, g = qkvg(TRAIN_BATCH, l, m, h, e, torch.float32, 800 + i, dev)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        scale = 1.0 / math.sqrt(e)
        ot = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        gt = g.transpose(1, 2)
        fns = {"ms": lambda: kernel_bwd(q, k, v, g, 0.3, 5),
               "plain_ms": lambda: plain_bwd(q, k, v, g, 0.3, 5),
               "library_ms": lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                         retain_graph=True)}
        row = {"L": l, "M": m, "H": h, "E": e}
        for key, fn in fns.items():
            row[key] = device_ms(fn)
            row["call_" + key] = time_ms(fn, 100 if key != "plain_ms" else 20)
        row["bytes_ms"], row["ops_ms"] = bound_bwd(TRAIN_BATCH, l, m, h, e, 4)
        rows.append(row)
    return rows


def time_train_step(weights: str, batch: int, steps: int = 5) -> dict:
    """Forward, backward and update of seist_l_dpk (its drop rates 0.3) at
    ``batch``: host wall time per step over ``steps`` steps after two warm
    ones, each step ending in the guard's host read; peak memory."""
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    model.cuda()
    state = TrainState(model, build_optimizer("adam", model.parameters()), constant(1e-4))
    step = make_train_step(taskspec.make_loss(MODEL))
    g = torch.Generator().manual_seed(batch)
    x = torch.randn(batch, WINDOW, 3, generator=g).cuda()
    y = torch.rand(batch, WINDOW, 3, generator=g).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        step(state, x, y, RandomSource.from_seed(i, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(state, x, y, RandomSource.from_seed(10 + i, "cuda"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "state": state, "step": step, "x": x, "y": y}


def profile_train_step(run: dict, iters: int = 3) -> dict:
    """torch.profiler over ``iters`` train steps of a :func:`time_train_step`
    run: device idle share, kernels per step, the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile

    state, step, x, y = run["state"], run["step"], run["x"], run["y"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            step(state, x, y, RandomSource.from_seed(100 + i, "cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms_per_step": wall_ms / iters,
        "device_busy_ms_per_step": busy_ms / iters,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in dev_events) / iters,
        "top": [(e.key[:60], e.self_device_time_total / 1e3 / iters, e.count // iters)
                for e in top],
    }


def time_forward(entry) -> Dict[int, float]:
    out = {}
    for b in (1, 2, 4, 8):
        x = np.random.default_rng(b).standard_normal((b, WINDOW, 3)).astype(np.float32)
        out[b] = time_ms(lambda: entry.run(x), 20, warmup=3)
    return out


def device_kernels(prof) -> list:
    """The device events of a profile, without user-annotation ranges (such
    as ``Optimizer.step``), which span other kernels and would count their
    time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def profile_forward(entry, iters: int = 5) -> dict:
    """torch.profiler over ``iters`` batch-8 forwards: device busy share of
    the wall time, kernels per forward, and the kernels that take most."""
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
    dev_events = device_kernels(prof)
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

    t0 = time.perf_counter()
    _kernels.build_all((KERNEL, KERNEL_BWD))
    for name in (KERNEL, KERNEL_BWD):
        print(f"[build] {name}: {_kernels.BUILD_SECONDS[name]:.2f} s "
              f"({_kernels.library_path(name).name}); ptxas registers/spill bytes: "
              f"{' '.join(ptxas_summary(_kernels.BUILD_LOGS.get(name, '')))}", flush=True)
    print(f"[build] both, in parallel: {time.perf_counter() - t0:.2f} s", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = api.create_model(MODEL, in_samples=WINDOW).attention_shapes(WINDOW)
    print(f"[shapes] {MODEL} window {WINDOW}: (L, M, H, E) per launch {shapes}", flush=True)
    errs = check_kernel(shapes, dev)
    bwd_abs = check_kernel_bwd(shapes, dev)

    weights = os.path.join(str(_kernels.BUILD_DIR), f"{MODEL}_seed{SEED}.pt")
    seeded_weights(weights)
    served = serve_phase(weights, len(shapes))
    trained = train_phase(os.path.join(str(_kernels.BUILD_DIR), "train_logs"), len(shapes))
    gpu_vs_cpu_step(weights)

    ones = torch.ones(1024, device=dev)
    device_ms(lambda: ones.add_(1.0), attempts=10)  # the profiler's first traces
    rows = time_shapes(shapes, dev)
    for r in rows:
        print(f"[time] {name_power} | N={BATCH} L={r['L']} M={r['M']} H={r['H']} "
              f"E={r['E']} {r['dtype']}: device ms: kernel {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}; per call: kernel "
              f"{r['call_ms']:.4f}, plain {r['call_plain_ms']:.4f}, sdpa "
              f"{r['call_library_ms']:.4f}; bound "
              f"{max(r['bytes_ms'], r['ops_ms']):.5f} ms (bytes {r['bytes_ms']:.5f}, "
              f"ops {r['ops_ms']:.5f})", flush=True)
    bwd_rows = time_bwd_shapes(shapes, dev)
    for r in bwd_rows:
        print(f"[time-bwd] {name_power} | N={TRAIN_BATCH} L={r['L']} M={r['M']} H={r['H']} "
              f"E={r['E']} fp32 rate 0.3: device ms: kernel {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, sdpa backward (rate 0) {r['library_ms']:.4f}; per "
              f"call: kernel {r['call_ms']:.4f}, plain {r['call_plain_ms']:.4f}, sdpa "
              f"backward {r['call_library_ms']:.4f}; "
              f"bound {max(r['bytes_ms'], r['ops_ms']):.5f} ms (bytes {r['bytes_ms']:.5f}, "
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
    served_launches = served["launches"]
    del served

    for batch in (TRAIN_BATCH, 256):
        run = time_train_step(weights, batch)
        print(f"[time] {name_power} | {MODEL} window {WINDOW} train step b{batch} "
              f"(forward, backward, Adam update, guard): {run['ms']:.2f} ms, peak memory "
              f"{run['peak_gib']:.2f} GiB", flush=True)
        if batch == TRAIN_BATCH:
            tp = profile_train_step(run)
            print(f"[profile] {name_power} | {MODEL} train step b{batch}: wall "
                  f"{tp['wall_ms_per_step']:.2f} ms/step, device busy "
                  f"{tp['device_busy_ms_per_step']:.2f} ms, idle share "
                  f"{tp['device_idle_share']:.3f}, {tp['kernels_per_step']:.0f} "
                  f"kernels/step", flush=True)
            for key, ms, count in tp["top"]:
                print(f"[profile]   {ms:.3f} ms/step in {count} launches: {key}", flush=True)
        del run
        torch.cuda.empty_cache()

    fp32 = [r for r in rows if r["dtype"] == "fp32"]  # the serving path is fp32
    bytes_ms = sum(r["bytes_ms"] for r in fp32)
    ops_ms = sum(r["ops_ms"] for r in fp32)
    b_bytes = sum(r["bytes_ms"] for r in bwd_rows)
    b_ops = sum(r["ops_ms"] for r in bwd_rows)
    print(f"[paths] serve: K1 {served_launches} launches; train: K1 {trained['launches']}, "
          f"K2 {trained['bwd_launches']} launches", flush=True)
    print(json.dumps({"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_fwd.cu",
        "replaces": "seist_tpu/ops/pallas_attention.py:137",
        "launches": served_launches + trained["launches"],
        "max_abs_err": errs["fp32"],
        "ms": sum(r["ms"] for r in fp32),
        "plain_ms": sum(r["plain_ms"] for r in fp32),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in fp32),
    }, {
        "name": KERNEL_BWD,
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_bwd.cu",
        "replaces": "seist_tpu/ops/pallas_attention.py:155",
        "launches": trained["bwd_launches"],
        "max_abs_err": bwd_abs,
        "ms": sum(r["ms"] for r in bwd_rows),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows),
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes > b_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in bwd_rows),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
