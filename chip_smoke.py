#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seist_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught; a failed check exits
non-zero before the last line):

1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
2. build the three kernel sources from ``seist_tpu_torch/csrc`` with nvcc
   (the attention forward and backward, each with its fp32 and its bf16
   kernels, and K3, the augmentation draws), one process per source,
   started together, and print each kernel's registers and spills
   (``-Xptxas -v``), failing when an attention kernel for E <= 32, or K3,
   spills;
3. hold the forward kernel (K1) and its row statistics (lse) against the
   plain PyTorch version on the card: at the five attention shapes of one
   ``seist_l_dpk`` forward at window 8192 (batch 8) in fp32 and bf16, at
   ragged shapes, at M = 1024, at batch 1 at each of the five shapes (serve
   bucket 1) and at batch 8 at the last, each under its own plan and the
   one-warp plan, and with dropout at rate 0.1, where the zero pattern
   must be identical;
4. hold the backward kernel (K2), fed K1's (o, lse), against its plain
   version from the same (o, lse), and the chain against the
   recompute-everything reference, at the five shapes of a batch-64 train
   step in fp32 and bf16 at dropout rates 0 and 0.3, at ragged L and M, M
   over one tile and E = 64, with two calls giving the same bits; and the
   autograd function against ``torch.autograd.grad`` through the plain
   forward;
5. serve ``seist_l_dpk`` at window 8192 through the port's server (fp32,
   each bucket a captured program) with weights whose outputs follow the
   waveform (phase 5's seeded draw with BatchNorm's affine times 0.05, its
   statistics set from the first 4 request traces and the output bias a
   decisive detection channel), imported by phase
   16 (a) from a reference-layout ``.pth``; answer concurrent ``/predict``
   requests with the plain versions patched to raise, count K1's launches
   over exactly that run (5 per forward), and hold the first 4 responses'
   picks against their traces run through the port on the CPU, and those
   traces' outputs (the b4 program) within 1e-4 of the CPU's, every two
   traces' at least 1e-3 apart (``check_separated``: a request fed another
   request's waveform fails);
6. ``train_test``: train ``seist_l_dpk`` at window 8192, batch 64, through
   the entry of ``python -m seist_tpu_torch train --mode train_test`` on the
   synthetic dataset for one epoch with an interval save every 3 steps,
   then test the best checkpoint, with both plain versions patched to
   raise: K1 launches 5 per train step, val batch and test batch, K2 5 per
   train step; the losses are finite, the parameters change, the test
   metrics JSON and the results CSV (one row per test event) are written,
   the interval checkpoint ``model_3.pt`` / ``state_3.pt`` exists and the
   best checkpoint serves one trace. The run has the telemetry on
   (``--metrics-port -1 --profile-steps 2``): its ``/metrics`` is scraped
   once while it runs, its scalars (TensorBoard event files, or
   ``scalars.jsonl`` without the package) hold the train task metrics at
   the ``--log-step`` calls, the profiler's Chrome trace of calls 3-4 is
   read (its size, its kernels; K1 and K2 five times per step where CUPTI
   lists the kernels of a replayed graph, and the output says which case
   held), and the entry's span p50s and ``waveforms_per_sec`` are printed;
   6b. resume: ``--mode train --checkpoint .../model_3.pt`` into the same
   run, plain versions patched to raise: a mid-epoch resume from batch 3
   that runs steps 4-6 (losses within rtol 1e-4 of phase 6's: the card's
   cuDNN backward promises no bits) and the val batch, ending at update 6;
   6c. bf16: ``--mode train_test --dtype bf16``, plain versions patched to
   raise: the bf16 kernels of K1 and K2 take every launch, losses and
   metrics are finite, parameters change and stay fp32 with Adam's moments
   and the BatchNorm statistics, and a bf16 eval forward of phase 6's best
   weights lies within 0.05 of the fp32 one on the test batch;
   6d. packs of phase 6's events, trained on; 6e. SIGTERM at step 3 of a
   run on the float32 pack: exit 75, the checkpoint, a flight dump with
   reason ``preempt``, steps and a ``step_dispatch`` span, and the resume;
7. one train step of ``seist_l_dpk`` (batch 4, attention dropout 0.3, the
   other drop rates 0) on the card and on the CPU from the same weights,
   batch and attention seeds: loss, every gradient leaf and the BatchNorm
   running statistics agree within the repo's train-mode parity limits;
8. (the kernels' own timing runs right after phase 4, before any
   profiler session has traced a graph replay, after which traces of
   eager launches lose kernels on the card) time both kernels, their
   plain versions and PyTorch's
   ``scaled_dot_product_attention`` (forward and backward; a yardstick
   only: the port never calls it) at each shape in device ms, beside the
   bound (bytes, or operations at the faster of fp32 on the CUDA cores and
   3xTF32 on the tensor cores, both printed), the model's
   forward per batch bucket, and the train step at batch 64 and 256 with
   its peak memory, in fp32 and bf16, captured as a CUDA graph (with the
   capture's seconds); K1 in bf16 also at the train step's
   batch 64; K2 in both types per shape at rate 0.3 (the train step's) and
   at rate 0 beside SDPA's backward (rate 0), its bound at the type's rate
   (the bf16 tensor cores for bf16); profile a
   batch-8 forward and a captured batch-64 train step in fp32 and bf16;
   the train Loader's waveforms/s at window 8192 with augmentation on over
   the float32 pack of 2048 synthetic events, at batch 500, with 4 processes,
   beside the fp32 train step's consumption at b64 and b256;
9. the captured step (``train/graph.py``), which every train path above
   already runs: at batch 64, drop rates 0.3, fp32, six captured steps
   against six eager ones from the same weights, batches and (seed,
   epoch, step): losses within RESUME_RTOL, step 1's outputs copied from
   the graph (as the worker copies them for its task metrics) within
   RESUME_RTOL of the eager step's, and the output-projection
   dropout's decisions in the first attention block (its zeros where both
   runs' inputs are nonzero) identical at every step and new at each; a NaN batch through the graph leaves every state
   tensor bitwise; one replay under ``torch.profiler`` (K1 and K2 five
   times each where it traces graph kernels); and ``train_test`` with
   ``--steps-per-call 2`` (losses against phase 6's pair means) and with
   ``--grad-accum-steps 2 --batch-size 32`` through the train entry, plain
   versions patched to raise, the replays' launches counted;
10. the six baseline families at their published widths, none of which
    reaches K1 or K2: PhaseNet served at window 8192 (24 concurrent
    requests, every response's picks within 0.1 s of the port's CPU run);
    ``train_test`` of phasenet, eqtransformer (both L1 flags on), magnet and
    baz_network at window 8192 and ditingmotion at 128, batch 64, through
    the train entry; per family 3 captured steps against 3 eager ones
    (losses within RESUME_RTOL, no attention launch), the forward at b8,
    the captured and eager step at b64 with a profile and peak memory; a
    bf16 step of eqtransformer and magnet against fp32 (loss rtol 0.05);
    BAZNetwork's eigenvector signs on the card against the CPU and its
    outputs where they agree; DistPTNetwork's forward at window 8192
    against the CPU;
11. device augmentation (``--device-aug step|cached``, ``--ingest``) on
    phase 6's events, the CLI's default rates: (a) K3 against its plain
    version at b64 and b256 of traces of 12000 (keys, uniforms and the
    integer draws made from them bitwise, the two normal fields within
    1e-6), with its time (CUDA events around a captured run of back-to-back
    launches) beside its bound (threefry blocks at the int32 rate, each
    block's integer instructions counted in the built kernel's SASS), its
    grid and the key chain's share of the blocks its warps issue, and a
    processed b64 batch on the card against the port on
    the CPU (phases, counts and gates exactly, windows and labels within
    1e-5); (b) ``--device-aug step`` through the train entry on the
    synthetic events, on their float32 pack with ``--ingest direct``
    (losses equal to the synthetic run's) and on the int8 pack, plain
    versions patched to raise, each log showing the resolved mode and no
    fallback, K3 launched once per step; (c) ``--device-aug step --ingest
    direct`` and ``cached`` (automatic steps per call, 32) on the
    2048-event float32 pack of phase 8, two epochs each, and the cached run
    resumed mid-epoch from its interval checkpoint (losses within
    RESUME_RTOL); (d) three captured device-aug steps against three eager
    ones from one state, in step and cached mode; (e) the captured
    device-aug call at b64 and b256 in both modes beside phase 8's
    host-fed step, the processor's device ms, peak memory and the cache's
    MiB, the step mode's host feed rate, and waveforms/s through the train
    entry beside phase 8's Loader.

12. compiled serving programs, plain attention patched to raise:
    ``serve --model seist_l_dpk=W --model-group seist_l=dpk,emg,dis
    --variants fp32,bf16,int8`` through the serve entry's argument parser
    (60 CUDA graphs: 4 buckets x 3 variants of the full forward, and of
    the group's trunk and three heads; the group's emg and dis weights
    carry dpk's trunk), with the ready time, each program's capture
    seconds, FLOPs and K1 launches per replay, and the memory of each
    entry's graph pools and variant weights; both parity gates pass;
    every program's replay against its function run eagerly (1e-4 of
    max(1, |eager|); the rows of a waveform or trunk program at buckets 2-8
    at least 1e-3 apart); ``/predict`` x24 concurrent in fp32, bf16 and int8
    and to the group, K1's launches (fp32 and bf16) equal to the replays'
    captured launches, no request without a program; bf16 and int8 picks
    as many as fp32's, each within 0.1 s of fp32's or moved across a
    near-tie (fp32 probabilities within the variant's gate tolerance); the
    group's heads
    against the single-task models; replayed against eager forwards per
    variant at bucket 8 (wall, device busy, idle share, kernels); a reload
    that swaps (version 2) and one of NaN weights refused (409). The
    serve entry's telemetry is on: every response's ``Server-Timing`` has
    the five segments (parse, normalize, queue_wait, forward, decode),
    which sum to at most ``total``, and their p50/p99 per variant and for
    the group are printed beside the client's time outside ``total``; one
    request's ``/traces/<id>``, ``/metrics.json`` (one trunk run per group
    flush) and the Prometheus text (every line parses) are checked; and
    the FLOPs the fp32 b1 program publishes equal the port's count for the
    same entry on the CPU.

13. the long-record and stream planes, plain attention patched to raise:
    ``serve --model seist_l_dpk=W --model phasenet=W --model-group
    seist_l=dpk,emg,dis --shed-batch-delay-ms 1 --stream-journal-dir D``
    through the serve entry's argument parser (fp32 programs);
    ``/healthz/live`` and ``/healthz/ready`` answer 200 with every
    model's version; ``/annotate`` of a 10-minute record (30,000 x 3
    samples, four P/S burst pairs) to seist_l_dpk, the seist_l group and
    PhaseNet, with the card's stitched curve within 1e-4 of the port's
    CPU run (its stretches of 4,096 samples at least 1e-3 apart) and the picks within the stream-smoke tolerance of the CPU's
    (at most a tenth of the union stranded, matched picks within 2
    samples; the thresholds sit at the 0.999 quantile of the CPU's
    curve), and of a 1-hour
    record (wall ms, windows/s); ``/stream`` of 16 stations' 10-minute
    records in 10-s packets on 8 client threads, each station's picks
    within that tolerance of ``/annotate`` of its record, with as many
    windows, no refused packet, no dropped window, no degraded session,
    while a batch-tier ``/predict`` flood beside it is shed (503 with
    ``Retry-After``); four stations journaled half-way, the service shut
    down and a second one over the journal directory resuming them, with
    the picks of the uninterrupted run; K1's launches over the phase
    equal to 5 per replay of a SeisT program. Prints the packet and
    window latencies and the shed counts per tier.
14. the fleet: ``python -m seist_tpu_torch supervise-fleet`` in a
    subprocess with two replicas of ``serve --model seist_l_dpk=W
    --window 8192 --buckets 1,8`` (fp32) on the card, each run as
    ``python -X faulthandler`` under a wrapper of this script's that keeps
    the life's stdout and stderr in a file of its own (the last 60 lines of
    a replica that exits with anything but 75 or the phase's -9 are
    printed) and writes the process's K1 launches on its way out (exit 75
    included); four closed-loop /predict clients in this process,
    another process than the servers, through the router. (a) Replica 0
    is SIGKILLed at its 8th request (``SEIST_FAULT_SERVE_KILL_REQ``) and
    relaunched; its relaunch answers a direct ``/predict``, ``/annotate``
    and ``/stream`` while ``/healthz/ready`` says ``warming``; (b) in its
    next life it black-holes 4 requests, and its breaker opens and
    closes; phase 5's first two traces through the router give phase 5's
    CPU picks of each (0.1 s), which differ from each other; ``/predict`` p50/p99 through the router and direct to one
    replica at the same concurrency; (e) ``/fleet/metrics.json`` merges
    both replicas and the router, and adds up to what the phase sent; (c)
    SIGHUP rolls both replicas to a second weights file as version 2 under
    load, each drained with exit 75, the router's ready count never below
    1, every response version 1 or 2 and all version 2 after the roll; (d)
    replica 0 rolled alone to version 3, a bad candidate
    (``SEIST_FAULT_SERVE_BAD_CANDIDATE``), and a 50% canary of it is
    rolled back, after which only version 2 answers. No client request
    fails in (a)-(d). SIGTERM stops the supervisor (exit 0, both replicas
    drained with 75); the K1 counts of every life but the SIGKILLed one
    are summed, each a multiple of 5. Prints the relaunch-to-ready
    seconds, the roll's wall seconds, the attempts until the rollback.
15. batch re-picking, plain attention patched to raise (in the worker
    processes too, by a wrapper of this script's that also writes each
    process's K1 launches on its way out): phase 8's 2,048 synthetic
    events at trace 8192, packed into 8 shards of 256 as float32 and as
    int8; the seeded weights with each BatchNorm's scale and shift cut to
    0.05 and its statistics set from the archive's first rows, so the
    outputs follow the waveform (the seeded ones' do not); ``--batch-size 64
    --batches-per-call 2 --commit-every 1 --max-events 1`` (128 rows a
    replay, 2 segments a unit, one plan for every run). (a) ``repick
    --compile-gate`` in this process: 2,048 rows with the pack's keys,
    ``compiles_after_warmup`` 0, K1 10 launches per replay over every
    replay, at least 1,024 distinct (ppk, spk, det) rows; waveforms/s,
    the stage seconds, the capture seconds and graph memory; then, from
    an engine of the same plan, one profiled replay's device busy and
    idle share and the rate over 8 passes of the archive; (b) 12 rows of
    (a)'s own replays (both ends of both batches of its first, middle
    and last call, kept as the run decodes them) against the same rows
    through the port on the CPU: outputs within 1e-4, every two rows at
    least 1e-3 apart (so a row fed the wrong waveform fails), picks and
    detection within 0.1 s (phase 12's rule: or moved across a near-tie
    of the CPU's outputs); (c) ``--variant int8`` on the int8 pack
    (``stage_raw``): the gate passes, the same 12 rows of its replays
    within 1e-4 of the CPU's int8 weights on the same int8 rows,
    ``batch_infer_bytes`` per row a quarter of (a)'s, picks as (a)'s
    under phase 12's variant rule; (d)
    two worker processes with ``--no-merge``, worker 0 slowed by
    ``SEIST_FAULT_REPICK_SLOW_MS``, SIGKILLed after its first segment
    commit and relaunched, then ``--merge-only``: the catalog
    byte-identical to (a)'s, ``compiles_after_warmup`` 0 in each worker,
    K1 10 per replay in each; (e) ``supervise-repick --workers 3`` in a
    child process with ``tools/batch_chaos.py``'s faults (worker 0's lease
    store partitioned from its first operation for 1.5 times (d)'s worker
    start plus 15 s, at least 45 s, so that a relaunched peer reclaims its
    unit first; worker 1 SIGKILLed and worker 2 SIGTERMed at their first
    lease): exit 0, the catalog's
    sha256 equal to (a)'s, ``double_commits`` 0, ``fence_rejects`` >= 1.
    Each child process is bounded by a timeout whose expiry fails the
    phase. Prints the relaunch counts and the fleet's wall seconds.
16. the reference's weights and offline prediction: (a), before phase 5,
    ``python -m seist_tpu_torch import-pretrained`` in a subprocess on phase
    5's weights written in the reference's layout (``model_dict``,
    ``module.`` prefixes, ``num_batches_tracked``, each LSTM's bias split
    in two): the ``.pt`` equal to the weights tensor for tensor, phases 5
    and 12-14 serving it; (b) ``python -m seist_tpu_torch predict`` of
    phase 13's 10-minute record on the card (a child process under a
    wrapper that patches the plain attention to raise and writes its K1
    launches) and with ``--device cpu`` in this process, at phase 13's
    thresholds: P and S picks and detection onsets within 0.1 s or moved
    across a near-tie of the CPU curve, K1 5 per replay of the b8 program;
    (c) ``demo --device cuda`` on phase 5's first trace against the CPU
    (probabilities within 1e-5; whether matplotlib exists, and the figure
    where it does); (d) ``train --checkpoint W.pt --mode train`` from the
    imported weights alone, one epoch of phase 6's events at batch 4 (drop
    rates but the attention's 0): it starts at epoch 0, batch 0, update 0
    with a fresh optimizer, and its first step's loss lies within 1e-4 of
    the CPU's step from the same weights, batch and attention seeds; (e)
    one captured b64 train step, drop rates 0.3, with and without
    ``use_checkpoint``: losses within 1e-6 (relative), gradients within
    phase 7's limits, K1 10 launches per step against 5, both peak
    memories.
17. training on several ranks (``seist_tpu_torch/parallel/``): (a) K1 and
    K2, fp32 and bf16, with the dropout counter's batch offset ``pid0 =
    4*H`` on rows 4-7 of a b8 batch (a second data rank's rows): equal to
    rows 4-7 of the ``pid0 = 0`` run and to the plain version with the
    offset within phases 3-4's limits, and, with V and g the identity, the
    same dropout zeros (another pattern at ``pid0 = 0``); (b) phase 6's
    train run (``--mode train``) as one rank over NCCL, launched through
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` in a child
    process with the plain attention patched to raise: its steps captured
    with their all-reduce inside, its losses within RESUME_RTOL of phase
    6's, K1 and K2 as phase 6's; (c) two ranks in two processes on this
    card under ``DIST_BACKEND=gloo`` (NCCL refuses two ranks on one device),
    eager steps, through ``python -m seist_tpu_torch.parallel.check``:
    ``data=2`` at b8 a rank against one rank at b16 on the same rows, and
    ``seq=2`` (every attention a ring) at b8 against one rank at b8, all
    drop rates 0.3, three steps each: losses within RESUME_RTOL, both
    ranks' parameters byte-identical (their checksums, gathered), K1 and
    K2 on the data-parallel run only; then the train entry itself,
    ``train --mode train_test --seq-shards 2`` at b8 over 64 synthetic
    events on two ranks through the env contract, against the same run on
    one rank in this process (captured): rank 0's step losses and the
    global test loss within RESUME_RTOL, one run directory with the test
    metrics file, the worker's byte-identical-parameters line; (d) with two
    cards or more, both parts of (c) over NCCL with captured steps (the
    ring's P2P and gathers inside the train and eval graphs). Prints which
    of (c) and (d) ran. Each child has a timeout whose expiry kills every
    rank and fails the phase.
18. device augmentation over several data ranks: the train entry with
    ``--device-aug`` through the env contract, against one rank at the
    global batch in this process (captured; each global batch ordered as
    the ranks' rows side by side, ``parallel/check.py::ranks_order``,
    since each dropout mask is positional): (a) one NCCL rank (world 1) in
    this process, ``--device-aug cached --steps-per-call 4`` at b16,
    captured, the row
    exchange (a copy at world 1) inside the processor's graph, against the
    same run without a group: losses within RESUME_RTOL, the first call's
    processed rows bitwise (or within DA_ROWS_TOL, printed); (b) two gloo
    ranks on this card in two child processes (plain versions patched to
    raise), b8 a rank over 40 synthetic events, ``--device-aug step`` and
    ``cached`` (the cache sharded, ``ceil(n/2)`` rows a rank, one
    ``all_to_all`` a step); (c) the same step run with ``--ingest direct``
    on phase 6's float32 pack at b32 a rank. In (b)-(c): rank 0's losses
    within RESUME_RTOL of one rank's, each rank's first processed rows
    against its rows of the one-rank batch, K3 one launch per step per
    rank, K1 and K2 as the steps and the val batch need, eager (no graph),
    one run directory and the byte-identical-parameters line per run; (d)
    with two cards or more, (b)'s two runs over NCCL on cuda:0-1, captured
    (the row exchange and the all-reduces inside the graphs), against the
    same references. The children start first and train while (a) and the
    references run here; each launch has one timeout. Prints which of (a)-(d)
    ran and the phase's seconds.
19. where the time goes (``obs/attribution.py``): (a) the b64 fp32 train
    step of seist_l_dpk (drop rates 0.3, Adam, the guard) recorded on the
    card, and the same step at b2 on the card and on the CPU: the matmul
    class at b2 equal on both, at b64 exactly 32 times b2's, K1 and K2
    charged 5 times each; prints flops_total, the class decomposition and
    the top 8 ops at the H100 basis; (b) ``measured_kernels`` over 3
    profiled replays of the captured b64 step: K1's and K2's kernels 5
    launches each per step, ``mfu_model`` (the recording's FLOPs over that
    wall at 67 TFLOP/s) in (0, 1], the class time shares summing to 1
    within 1e-3; (c) ``python -m seist_tpu_torch profile-step --batch 64
    --steps 3`` (its entry, in this process), its trace listing K1 and K2 5
    times per step; (d) in phase 14, while the fleet is up, one ``/predict`` through
    the router stitched (``trace-report``'s functions) from the router's
    and both replicas' ``/traces``: one tree, the replica's
    ``server:/predict`` root a child of a router attempt, no flags.
20. repeatability and the streaming plane's acceptance: (a) the captured
    b64 fp32 step as three graphs from one state (the port; the step
    before the fixed-order backwards; that one under cuDNN's global
    deterministic flag), their replays interleaved and timed by CUDA
    events: the repair costs at most 3%; one eager b16 step twice from one
    state under default settings: every gradient leaf bitwise equal;
    ``/annotate``'s mean stitch of an hour twice: bitwise equal; phase 18
    (b)'s one-rank ``--device-aug step`` Adam run twice: equal losses and a
    byte-identical best checkpoint; (b) ``twin`` (200 stations, 60 s, one
    driving worker) with twinpick on the card: every gate, and its alerts
    (ids and pick samples) equal to the same scenario on the CPU in a
    child process, but for picks on a near-tie of the CPU's |z|; (c) the
    stream chaos lane's SIGKILL run (``stream_chaos.sigkill_run``: three
    twin replicas on the card behind ``supervise-fleet``), with its gates;
    (b)'s two twins and (c) run in child processes started before phase
    19.

Each phase's wall seconds are printed as a ``[phase-time]`` line. To keep
the script inside its time, the packs are made by child processes from the
start (``PackQueue``), phase 17's five rank processes start together and
phase 18's two start beside them, phase 15 (d)'s workers start with the
phase, phase 16's parts run while ``predict``'s process does, phase 16
runs while phase 15 (e)'s chaos fleet does, and phase 20's children work
beside phases 19-20.

It prints one ``{"kernels": [...]}`` line (the fp32 K1 and K2, their bf16
kernels, K3; launches over every phase's main path) and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits 1 and prints no result.

``python3 chip_smoke.py --loss-gap`` runs no phase and checks nothing: it
builds the kernels and measures where phase 18 (b)'s step-mode loss gap
comes from (``loss_gap_reading``).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import csv
import gc
import glob
import io
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seist_tpu_torch import cli, taskspec, trace_report
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.data.preprocess import normalize
from seist_tpu_torch.models import api
from seist_tpu_torch.models.common import RandomSource
from seist_tpu_torch.ops import _kernels, launch_counts
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.ops import stream as stream_ops
from seist_tpu_torch.ops import threefry as tf
from seist_tpu_torch.serve import aot
from seist_tpu_torch.serve import server as srv
from seist_tpu_torch.serve.pool import decode_outputs, load_model_entry
from seist_tpu_torch.serve.protocol import PredictOptions
from seist_tpu_torch.train.optim import build_optimizer
from seist_tpu_torch.train.schedule import constant
from seist_tpu_torch.train import worker
from seist_tpu_torch.train.checkpoint import (
    PREEMPT_EXIT_CODE,
    find_newest_checkpoint,
    state_path_for,
)
from seist_tpu_torch.models.seist import AttentionBlock
from seist_tpu_torch.train.graph import _flat, capture_train_step
from seist_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_train_step,
    move_batch,
    step_random_source,
)
from seist_tpu_torch.obs import attribution
from seist_tpu_torch.obs import trace as obs_trace
from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.utils import logger as logger_mod
from seist_tpu_torch.utils.logger import logger

MODEL = "seist_l_dpk"
WINDOW = 8192
BATCH = 8  # the largest serve bucket
TRAIN_BATCH = 64
N_REQUESTS = 24
SEED = 0
KERNEL = "pooled_attention_fwd"
KERNEL_BWD = "pooled_attention_bwd"
KERNEL_K3 = "aug_draws"
# The train run: 256 synthetic events -> 204 train (x2 by augmentation ->
# 6 batches of 64), 25 val (1 padded batch) and 27 test (1 padded batch).
TRAIN_ARGS = ["--model-name", MODEL, "--dataset-name", "synthetic", "--synthetic-events",
              "256", "--in-samples", str(WINDOW), "--batch-size", str(TRAIN_BATCH),
              "--epochs", "1", "--seed", str(SEED), "--device", "cuda"]
TRAIN_STEPS, VAL_BATCHES, TEST_BATCHES, TEST_EVENTS = 6, 1, 1, 27
SAVE_EVERY = 3  # the interval save the resume phase starts from
PROFILE_STEPS = 2  # phase 6's --profile-steps: calls 3 and 4, after the graph capture
RESUME_RTOL = 1e-4  # resumed vs uninterrupted step losses on the card
BF16_OUT_TOL = 0.05  # bf16 vs fp32 eval outputs, the JAX package's limit (tests/test_train.py)

FP32_TOL = 1e-5  # fp32 max abs error, kernel vs plain: summation order only
LSE_TOL = 1e-5  # K1's row statistics, fp32 in both types
# bf16: both sides compute in fp32 and round the output to bf16; a 1e-7
# difference can flip one rounding, so the limit is one bf16 ulp
# (2^-7 relative) at |o| < 2, the range of a softmax-weighted average of
# unit-normal values.
BF16_TOL = 2.0 ** -6
PICK_TOL_S = 0.1  # per pick, GPU response vs the CPU run of the same trace
PROB_TOL = 1e-4  # model output, GPU vs CPU: cuDNN and CPU conv sum orders differ
# Two different inputs' outputs must differ by at least this much (ten times
# PROB_TOL), so that a card-vs-CPU check of the outputs sees a request or a
# row fed another one's waveform (check_separated).
SEPARATION = 1e-3
# K2 against its plain version, per output, relative to max(1, max|plain|):
# fp32 sums over up to L rows in another order; bf16 may flip one rounding
# of the largest output (one bf16 ulp is 2^-7 relative).
BWD_FP32_TOL = 1e-5
BWD_BF16_TOL = 2.0 ** -7
# The bf16 chain (K1's o and lse, then K2) against the recompute-everything
# reference: D comes from the bf16-rounded o, which moves the gradients by
# about one bf16 rounding of o; the limit of tests/test_torch_attention_tiles.py.
CHAIN_BF16_TOL = 2.0 ** -6
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

# Published peaks of one H100 SXM (NVIDIA data sheet, dense). The
# operations of fp32 inputs go at the faster of the CUDA cores' fp32 rate
# and 3xTF32 on the tensor cores (three TF32 products per fp32 product, as
# K1 and K2 compute them); those of bf16 inputs at the tensor cores' bf16
# rate. A kernel's bound is the larger of its bytes' and its operations'
# time (:func:`bound_of`).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12


def ptxas_summary(log: str) -> List[Tuple[str, int, int]]:
    """``(kernel<type,EP>, registers, spill-store bytes)`` per compiled
    kernel, from nvcc's ``-Xptxas -v`` output."""
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
            kind = re.search(r"(fwd_kernel_bf16|bwd_kernel_bf16|fwd_kernel|bwd_kernel|"
                             r"reduce_slabs|aug_draws_kernel)", cur)
            ep = re.search(r"Li(\d+)E", cur)
            out.append((f"{kind.group(1) if kind else cur[:24]}"
                        f"<{'bf16' if 'bfloat16' in cur else 'f32'}"
                        f"{',' + ep.group(1) if ep else ''}>", int(m.group(1)), spill))
            cur, spill = None, 0
    return out


def check_spills(name: str, log: str) -> None:
    """Print registers/spill-store bytes per kernel; fail when a K1 or K2
    kernel (fp32 or bf16) for E <= 32, or K3, spills."""
    rows = ptxas_summary(log)
    print(f"[build] {name}: ptxas registers/spill bytes: "
          f"{' '.join(f'{k}:{r}/{sp}' for k, r, sp in rows)}", flush=True)
    for kern, _, spill in rows:
        ep = re.search(r",(\d+)>", kern)
        if spill and ((ep and int(ep.group(1)) <= 32) or name == KERNEL_K3):
            fail(f"{kern} spills {spill} bytes of registers")


def allocated_gib() -> float:
    """Memory allocated on the card, after a garbage collection."""
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 2**30


def fail(msg: str) -> None:
    """Fails the run; the reason goes to both streams, so that a caller
    that keeps only the end of one of them still sees it."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def kernel(q, k, v, rate=0.0, seed=0, with_lse=False, pid0=0):
    """One K1 launch through the wrapper, not counted against the main path:
    o, or (o, lse) with the row statistics."""
    counts = pa.counts()
    o, lse = pa._forward(q, k, v, 1.0 / math.sqrt(q.shape[-1]), rate, seed, with_lse, pid0)
    pa.set_counts(counts)
    return (o, lse) if with_lse else o


def plain(q, k, v, rate=0.0, seed=0, with_lse=False, pid0=0):
    return pa.pooled_attention_plain(q, k, v, 1.0 / math.sqrt(q.shape[-1]), rate, seed,
                                     return_lse=with_lse, pid0=pid0)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------- phase 3
def check_kernel(shapes: List[Tuple[int, int, int, int]], dev) -> Dict[str, float]:
    """K1 against its plain version, per type: at the serve batch in both
    types; at the train step's batch in bf16 (the bf16 kernel's main path),
    at rates 0 and 0.3; dropout 0.1 in fp32. Returns the largest max abs
    error of o per type."""
    errs = {"fp32": 0.0, "bf16": 0.0}
    cases = [(BATCH, l, m, h, e, name, dtype, tol, 0.0) for l, m, h, e in shapes
             for name, dtype, tol in (("fp32", torch.float32, FP32_TOL),
                                      ("bf16", torch.bfloat16, BF16_TOL))]
    cases += [(TRAIN_BATCH, l, m, h, e, "bf16", torch.bfloat16, BF16_TOL, rate)
              for l, m, h, e in shapes for rate in (0.0, 0.3)]
    for i, (n, l, m, h, e, name, dtype, tol, rate) in enumerate(cases):
        q, k, v = qkv(n, l, m, h, e, dtype, 100 + i, dev)
        (o, lse), (o_p, lse_p) = (kernel(q, k, v, rate, 4321, with_lse=True),
                                  plain(q, k, v, rate, 4321, with_lse=True))
        err, lse_err = max_err(o, o_p), max_err(lse, lse_p)
        print(f"[check] N={n} L={l} M={m} H={h} E={e} {name} rate {rate}: "
              f"max_abs_err {err:.3e} (limit {tol:.1e}), lse {lse_err:.3e} "
              f"(limit {LSE_TOL:.0e})", flush=True)
        if not (err <= tol and lse_err <= LSE_TOL):
            fail(f"kernel disagrees with plain at {(n, l, m, h, e)} {name} rate {rate}")
        if not torch.equal(kernel(q, k, v, rate, 4321), o):
            fail("K1's output changes when it also writes the row statistics")
        errs[name] = max(errs[name], err)
    for i, (l, m, h, e) in enumerate(shapes):
        q, k, v = qkv(BATCH, l, m, h, e, torch.float32, 200 + i, dev)
        err = max_err(kernel(q, k, v, 0.1, 1234), plain(q, k, v, 0.1, 1234))
        print(f"[check] N={BATCH} L={l} M={m} H={h} E={e} fp32 dropout 0.1: "
              f"max_abs_err {err:.3e} (limit {FP32_TOL:.1e})", flush=True)
        if not err <= FP32_TOL:
            fail(f"kernel with dropout disagrees with plain at {(l, m, h, e)}")
    for n, l, m, h, e in ((2, 1000, 125, 3, 8), (2, 1000, 125, 2, 20), (1, 8192, 1024, 3, 8)):
        q, k, v = qkv(n, l, m, h, e, torch.float32, 300 + l + m, dev)
        (o, lse), (o_p, lse_p) = kernel(q, k, v, with_lse=True), plain(q, k, v, with_lse=True)
        err, lse_err = max_err(o, o_p), max_err(lse, lse_p)
        print(f"[check] N={n} L={l} M={m} H={h} E={e} fp32: max_abs_err {err:.3e} "
              f"(limit {FP32_TOL:.1e}), lse {lse_err:.3e}", flush=True)
        if not (err <= FP32_TOL and lse_err <= LSE_TOL):
            fail(f"kernel disagrees with plain at ragged/long {(n, l, m, h, e)}")
    # fwd_plan's two warps a 16-row group (ksplit 2: every batch-1 forward,
    # serve bucket 1, and b8 at the last shape) and the one-warp plan of
    # an M of one key chunk, each against the plain version.
    real_plan = _kernels.fwd_plan

    def one_warp(n, l, m, h, sms):
        return real_plan(n, l, _kernels.FWD_CHUNK, h, sms)

    for n, l, m, h, e in [(BATCH,) + shapes[-1]] + [(1,) + s for s in dict.fromkeys(shapes)]:
        q, k, v = qkv(n, l, m, h, e, torch.float32, 900 + l, dev)
        sms = _kernels.sm_count(dev)
        for plan in (real_plan, one_warp):
            _kernels.fwd_plan = plan
            try:
                err = max_err(kernel(q, k, v), plain(q, k, v))
            finally:
                _kernels.fwd_plan = real_plan
            print(f"[check] N={n} L={l} M={m} H={h} E={e} fp32 plan {plan(n, l, m, h, sms)} "
                  f"(row_warps, ksplit): max_abs_err {err:.3e} (limit {FP32_TOL:.1e})",
                  flush=True)
            if not err <= FP32_TOL:
                fail(f"K1 with the plan {plan(n, l, m, h, sms)} disagrees with plain at "
                     f"{(n, l, m, h, e)}")
    # Zero pattern: with v_h the identity (M <= E), O_h is the dropped
    # probability matrix itself, so its zeros are the dropout mask: the fp32
    # kernel's uniform test and the bf16 kernel's integer threshold.
    n, l, m, h, e = 2, 1000, 32, 3, 32
    for name, dtype, rate in (("fp32", torch.float32, 0.1), ("bf16", torch.bfloat16, 0.3)):
        q, k, _ = qkv(n, l, m, h, e, dtype, 400, dev)
        v = torch.eye(m, e, device=dev, dtype=dtype).reshape(1, m, 1, e).expand(n, m, h, e)
        v = v.contiguous()
        ok, op = kernel(q, k, v, rate, 77), plain(q, k, v, rate, 77)
        same = bool(torch.equal(ok == 0, op == 0))
        frac = float((op == 0).float().mean() * e / m)
        print(f"[check] dropout zero pattern N={n} L={l} M={m} H={h} {name}: "
              f"identical={same}, dropped fraction {frac:.4f} (rate {rate})", flush=True)
        if not same or not abs(frac - rate) < 0.02:
            fail(f"{name} dropout zero pattern differs from the plain version")
        if name == "bf16":
            errs[name] = max(errs[name], max_err(ok, op))
    return errs


# ------------------------------------------------------------- phase 5
@torch.no_grad()
def seeded_weights(path: str, seed: int = SEED) -> None:
    """seist_l_dpk weights drawn from ``seed``, with kernels at std
    0.5/sqrt(fan_in) and random BatchNorm statistics so activations stay
    O(1) through the depth: the JAX package's std-0.02 init shrinks them
    to an output of exactly 0.5 everywhere, which has no picks to compare."""
    model = api.create_model(MODEL, in_samples=WINDOW, seed=seed)
    g = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if t.ndim >= 2:
            fan_in = t[0].numel()
            t.copy_(torch.randn(t.shape, generator=g) * (0.5 / math.sqrt(fan_in)))
        elif name.endswith(("running_var", ".weight")):
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
        else:
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    torch.save(model.state_dict(), path)


# The reference's list modules, by the port's (flax's) per-index prefix:
# the inverse of tools/parity.py's table.
REFERENCE_LISTS = {"block": "blocks", "clarity_side": "clarity_side_layers",
                   "polarity_side": "polarity_side_layers", "fuse_clarity": "fuse_clarity",
                   "fuse_polarity": "fuse_polarity", "resconv": "res_convs",
                   "bilstm": "bilstms", "transformer": "transformers", "decoder": "decoders",
                   "up": "up_convs", "down": "down_convs"}
_LSTM_PORT_LEAF = re.compile(r"(weight_ih|weight_hh|bias_hh)_l0(_reverse)?")


def reference_module(path: List[str]) -> List[str]:
    """A port module path in the reference's module layout, as
    tools/parity.py maps that layout back: ``stem.{i}``,
    ``encoder_layers.{i}.{j}``, ``out_head.up_layers.{k}.conv|norm``,
    ``convs|norms|projs.{k}``, DiTingMotion's ``conv_layers.{j}`` and
    ``convs.{a}.0``, BAZNetwork's ``layers.{k}.0``, MagNet's ``lstm`` and
    the list modules; any other name stays."""
    out: List[str] = []
    for i, seg in enumerate(path):
        parent = path[i - 1] if i else ""
        if i == 0 and (m := re.fullmatch(r"stem(\d+)", seg)):
            out += ["stem", m[1]]
        elif m := re.fullmatch(r"stage(\d+)_aggr", seg):
            out += ["encoder_layers", m[1], "0"]
        elif m := re.fullmatch(r"stage(\d+)_block(\d+)", seg):
            out += ["encoder_layers", m[1], str(int(m[2]) + 1)]
        elif parent == "out_head" and (m := re.fullmatch(r"(conv|norm)(\d+)", seg)):
            out += ["up_layers", m[2], m[1]]
        elif parent.startswith("comb") and (m := re.fullmatch(r"conv(\d+)", seg)):
            out += ["convs", m[1], "0"]
        elif re.fullmatch(r"block\d+", parent) and (m := re.fullmatch(r"comb(\d+)", seg)):
            out += ["conv_layers", m[1]]
        elif m := re.fullmatch(r"wave_conv(\d+)", seg):
            out += ["layers", m[1], "0"]
        elif m := re.fullmatch(r"(conv|norm|proj)(\d+)", seg):
            out += [m[1] + "s", m[2]]
        elif seg == "bilstm":
            out.append("lstm")
        elif (m := re.fullmatch(r"([a-z_]+?)(\d+)", seg)) and m[1] in REFERENCE_LISTS:
            out += [REFERENCE_LISTS[m[1]], m[2]]
        else:
            out.append(seg)
    return out


def reference_state_dict(port: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` in the reference's layout: its keys
    renamed by :func:`reference_module` (the port keeps torch's tensor
    layouts, so every tensor stays as it is), each LSTM's one bias split
    into torch's two, ``bias_ih`` and ``bias_hh`` (nonzero halves, whose
    sum is exact), and a ``num_batches_tracked`` beside each BatchNorm's
    statistics, as a training run leaves it."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in port.items():
        module, _, leaf = key.rpartition(".")
        prefix = ".".join(reference_module(module.split(".")) if module else [])
        m = _LSTM_PORT_LEAF.fullmatch(leaf)
        if m and m[1] == "bias_hh":
            out[f"{prefix}.bias_ih_l0{m[2] or ''}"] = value * 0.5
            out[f"{prefix}.{leaf}"] = value * 0.5
            continue
        out[f"{prefix}.{leaf}"] = value.clone()
        if leaf == "running_var":
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(1000, dtype=torch.int64)
    return out


def write_reference_pth(port: Dict[str, torch.Tensor], path: str) -> None:
    """A reference-layout ``.pth`` as a training run of the reference saves
    it: nested under ``model_dict``, every key prefixed with ``module.``."""
    torch.save({"model_dict": {f"module.{k}": v for k, v in reference_state_dict(port).items()},
                "epoch": 0}, path)


SERVE_BN_GAIN = 0.05  # phase 5's weights cut BatchNorm's affine as phase 15's do
CALIBRATION_TRACES = 4  # phase 5's first request traces set the statistics
# The output convolution's bias of phase 5's weights, one logit per channel
# (det, ppk, spk): the detection channel is decisive (sigmoid ~0.92) and
# the phase channels sit near the pick threshold 0.3-0.5, as a trained
# model's do. Calibrated alone, the three channels lie within a few 1e-2 of
# each other, and the variant gates of phase 12 (the per-sample argmax may
# flip on at most 0.5% of samples in bf16) refuse every near-tie.
SERVE_HEAD_LOGITS = (2.5, 0.0, -0.4)


def imported_weights(flat: str) -> dict:
    """Phase 16 (a), run before phase 5, which serves what it writes: the
    weights of phases 5 and 12-14 (:func:`calibrated_weights` of phase 5's
    ``flat`` on its first request traces, so their outputs follow the
    waveform) written in the reference's layout as a training run of the
    reference saves a ``.pth`` (nested under ``model_dict``, ``module.``
    prefixes, ``num_batches_tracked``), then ``python -m seist_tpu_torch
    import-pretrained`` in a subprocess. Its ``.pt`` must equal the weights
    tensor for tensor."""
    t0 = time.perf_counter()
    build = str(_kernels.BUILD_DIR)
    want = calibrated_weights(flat, traces(N_REQUESTS)[:CALIBRATION_TRACES], SERVE_BN_GAIN)
    want["out_head.out_conv.bias"] = torch.tensor(SERVE_HEAD_LOGITS, dtype=torch.float32)
    pth = os.path.join(build, f"{MODEL}_reference.pth")
    out = os.path.join(build, f"{MODEL}_imported.pt")
    write_reference_pth(want, pth)
    raw = torch.load(pth, map_location="cpu", weights_only=True)
    n_tracked = sum(k.endswith("num_batches_tracked") for k in raw["model_dict"])
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "seist_tpu_torch", "import-pretrained", "--pth",
                           pth, "--model-name", MODEL, "--in-samples", str(WINDOW), "--out", out],
                          env=env, capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t1
    if proc.returncode != 0:
        fail(f"import-pretrained exited {proc.returncode}: {proc.stderr[-2000:]}")
    got = torch.load(out, map_location="cpu", weights_only=True)
    line = proc.stdout.strip().splitlines()[-1]
    n_params = sum(v.numel() for k, v in want.items()
                   if not k.endswith(("running_mean", "running_var")))
    equal = sorted(got) == sorted(want) and all(
        got[k].dtype == v.dtype and torch.equal(got[k], v) for k, v in want.items())
    print(f"[import] (phase 16a) {MODEL}: python -m seist_tpu_torch import-pretrained on a "
          f"reference-layout .pth ({len(raw['model_dict'])} keys under model_dict, 'module.' "
          f"prefixes, {n_tracked} num_batches_tracked) in {sub_s:.1f} s: {line!r}; the .pt "
          f"equals the weights tensor for tensor: {equal} ({len(want)} tensors)", flush=True)
    if not equal or line != f"Imported {pth} -> {out} ({n_params:,} params)":
        fail("import-pretrained did not give back the weights the .pth was made from")
    return {"weights": out, "pth": pth, "seconds": time.perf_counter() - t0,
            "subprocess_s": sub_s}


def check_separated(what: str, got: np.ndarray, want: np.ndarray,
                    tol: float = PROB_TOL) -> Tuple[float, float]:
    """Rows of the card's outputs ``got`` against the CPU's ``want`` of the
    same inputs (row i of both from input i): within ``tol``, and every row
    at least SEPARATION from every OTHER row's CPU outputs, so that a row
    fed another row's input fails. Returns (max abs error, smallest
    separation)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape or len(got) < 2:
        fail(f"{what}: {got.shape} rows against {want.shape}: two or more rows are needed")
    err = float(np.abs(got - want).max())
    sep = min(float(np.abs(got[i] - want[j]).max())
              for i in range(len(got)) for j in range(len(want)) if i != j)
    if err > tol:
        fail(f"{what}: the card's outputs lie {err:.3e} from the CPU's (limit {tol})")
    if sep < SEPARATION:
        fail(f"{what}: two rows' outputs lie only {sep:.3e} apart (limit {SEPARATION}): the "
             f"check of the outputs could not see a row fed another row's waveform")
    return err, sep


# Phases 5, 10 and 12 time the forward under 24 concurrent requests, whose
# queueing the default tiers could shed; phase 13 exercises the shedding.
NO_SHED = srv.ShedConfig(batch_delay_ms=float("inf"), interactive_delay_ms=float("inf"))


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
    # PhaseNet's (non, ppk, spk) has no detection head.
    da = sorted((d["onset"], d["offset"]) for d in a.get("det", []))
    db = sorted((d["onset"], d["offset"]) for d in b.get("det", []))
    return len(da) == len(db) and all(
        abs(x[0] - y[0]) <= tol_samples and abs(x[1] - y[1]) <= tol_samples
        for x, y in zip(da, db)
    )


def serve_phase(weights: str, n_shapes: int) -> dict:
    service = srv.build_service([(MODEL, weights)], window=WINDOW, device="cuda",
                                max_batch=BATCH, max_delay_ms=20.0, shed_config=NO_SHED)
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

    # The first traces through the port on the CPU, and the raw outputs of
    # both: each response's picks are its own trace's, and every trace's
    # outputs lie at least SEPARATION from every other's, so a request fed
    # another request's waveform fails.
    entry = service.entries[MODEL]
    cpu = load_model_entry(MODEL, weights, window=WINDOW, device="cpu")
    n_cpu = CALIBRATION_TRACES
    x = np.stack([normalize(d.T, "std", axis=0) for d in data[:n_cpu]]).astype(np.float32)
    out_gpu, out_cpu = entry.run(x), cpu.run(x)
    popts = PredictOptions.from_dict(opts)
    refs = [decode_outputs(cpu, out_cpu[i:i + 1], popts) for i in range(n_cpu)]
    prob_err, sep = check_separated(f"phase 5, traces 0-{n_cpu - 1} (b{n_cpu} program)",
                                    out_gpu.cpu().numpy(), out_cpu.numpy())
    n_picks = sum(len(r[k]) for r in refs for k in ("ppk", "spk", "det"))
    print(f"[serve] response 0 vs CPU run: gpu {json.dumps(results[0][1])} cpu "
          f"{json.dumps(refs[0])}; traces 0-{n_cpu - 1}: outputs max_abs_err {prob_err:.3e} "
          f"(limit {PROB_TOL:.0e}), every two at least {sep:.3e} apart (limit "
          f"{SEPARATION:.0e}); {n_picks} picks in the references", flush=True)
    for i in range(n_cpu):
        if not picks_close(results[i][1], refs[i], PICK_TOL_S * popts.sampling_rate):
            fail(f"GPU response {i}'s picks differ from the CPU run of its trace by more "
                 "than 0.1 s")
    if n_picks == 0:
        fail("no picks in the CPU references")
    lat = np.array([r[2] for r in results])
    return {
        "entry": entry,
        "launches": launches,
        "forwards": forwards,
        "n_shapes": n_shapes,
        "ref0": refs[0],  # trace 0's picks on the CPU, and the card's response
        "resp0": results[0][1],
        "refs": refs,  # traces 0-3's picks on the CPU
        "client_p50_ms": float(np.percentile(lat, 50)),
        "client_p99_ms": float(np.percentile(lat, 99)),
        "server_latency_ms": stats["latency_ms"],
    }


# ------------------------------------------------------------- phase 4
def qkvg(n: int, l: int, m: int, h: int, e: int, dtype, seed: int, dev):
    q, k, v = qkv(n, l, m, h, e, dtype, seed, dev)
    g = torch.randn(n, l, h, e, generator=torch.Generator().manual_seed(seed + 1))
    return q, k, v, g.to(dev, dtype)


def kernel_bwd(q, k, v, g, o, lse, rate=0.0, seed=0, pid0=0):
    """One K2 launch from K1's (o, lse), not counted against the main path."""
    counts = pa.counts()
    out = pa._backward(q, k, v, g, o, lse, 1.0 / math.sqrt(q.shape[-1]), rate, seed, pid0)
    pa.set_counts(counts)
    return out


def plain_bwd(q, k, v, g, o, lse, rate=0.0, seed=0, pid0=0):
    return pa.pooled_attention_bwd_plain(q, k, v, g, o, lse, 1.0 / math.sqrt(q.shape[-1]),
                                         rate, seed, pid0)


def bwd_err(got, want) -> float:
    """max over dq, dk, dv of max|kernel - plain| / max(1, max|plain|)."""
    return max(max_err(a, b) / max(1.0, float(b.float().abs().max()))
               for a, b in zip(got, want))


def check_kernel_bwd(shapes, dev) -> Dict[str, float]:
    """Returns the largest max abs error over every output checked, per
    type (fp32: the autograd check included)."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    cases = [(TRAIN_BATCH,) + s for s in shapes]
    cases += [(2, 1000, 125, 3, 8), (2, 300, 200, 2, 20), (2, 130, 65, 3, 64),
              (1, 4096, 512, 3, 16)]
    for i, (n, l, m, h, e) in enumerate(cases):
        for name, dtype, tol in (("fp32", torch.float32, BWD_FP32_TOL),
                                 ("bf16", torch.bfloat16, BWD_BF16_TOL)):
            for rate in (0.0, 0.3):
                q, k, v, g = qkvg(n, l, m, h, e, dtype, 600 + i, dev)
                o, lse = kernel(q, k, v, rate, 4321, with_lse=True)
                got = kernel_bwd(q, k, v, g, o, lse, rate, 4321)
                want = plain_bwd(q, k, v, g, o, lse, rate, 4321)
                err = bwd_err(got, want)
                # The whole chain, K1's (o, lse) then K2, against the
                # recompute-everything reference.
                ref_err = bwd_err(got, pa.pooled_attention_bwd_reference(
                    q, k, v, g, 1.0 / math.sqrt(e), rate, 4321))
                ref_tol = tol if dtype == torch.float32 else CHAIN_BF16_TOL
                print(f"[check-bwd] N={n} L={l} M={m} H={h} E={e} {name} rate {rate}: "
                      f"rel err {err:.3e} (limit {tol:.1e}); vs the recompute reference "
                      f"{ref_err:.3e} (limit {ref_tol:.1e})", flush=True)
                if not (err <= tol and ref_err <= ref_tol):
                    fail(f"backward kernel disagrees with plain at {(n, l, m, h, e)} "
                         f"{name} rate {rate}")
                if not all(torch.equal(a, b) for a, b in zip(
                        got, kernel_bwd(q, k, v, g, o, lse, rate, 4321))):
                    fail(f"two K2 calls gave different bits at {(n, l, m, h, e)}")
                worst[name] = max([worst[name]] + [max_err(a, b) for a, b in zip(got, want)])
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
    worst["fp32"] = max([worst["fp32"]] + [max_err(a, b) for a, b in zip(got, want)])
    return worst


# ------------------------------------------------------------- phase 6
def run_entry(argv: List[str],
              expect_exit: int = 0) -> Tuple[str, Dict[str, int], float, List[str]]:
    """``cli.main(argv)`` with both plain versions patched to raise: the
    best checkpoint, both kernels' launches (and those of their bf16
    kernels) over exactly that run, its wall seconds and its log.
    With ``expect_exit``, the run must end in ``SystemExit(expect_exit)``
    (and the checkpoint is ""); any other exit is fatal."""
    real = pa.pooled_attention_plain, pa.pooled_attention_bwd_plain, tf.aug_draws_plain

    def off_path(*a, **k):
        raise AssertionError("a plain kernel version was reached on the main path")

    lines: List[str] = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger.addHandler(handler)
    pa.pooled_attention_plain = pa.pooled_attention_bwd_plain = tf.aug_draws_plain = off_path
    pa.launches = pa.bwd_launches = pa.bf16_launches = pa.bf16_bwd_launches = tf.launches = 0
    t0 = time.perf_counter()
    try:
        best, code = cli.main(argv), 0
    except SystemExit as e:
        best, code = "", e.code
    finally:
        pa.pooled_attention_plain, pa.pooled_attention_bwd_plain, tf.aug_draws_plain = real
        logger.removeHandler(handler)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if code != expect_exit:
        fail(f"the train entry exited with {code!r}, expected {expect_exit}")
    counts = {"K1": pa.launches, "K2": pa.bwd_launches, "K1_bf16": pa.bf16_launches,
              "K2_bf16": pa.bf16_bwd_launches, "K3": tf.launches}
    return best, counts, wall_s, lines


def check_launches(counts: Dict[str, int], n_shapes: int, forwards: int, steps: int,
                   k3: int = 0, recomputes: int = 0) -> None:
    """K1 n_shapes per forward and per rematerialised stage's recompute of
    a train step (``use_checkpoint``: every attention call runs again in
    the backward pass), K2 n_shapes per train step, K3 ``k3`` launches (one
    per device-augmented step)."""
    forwards += recomputes
    if (counts["K1"] != n_shapes * forwards or counts["K2"] != n_shapes * steps
            or counts["K3"] != k3):
        fail(f"K1 launches {counts['K1']} != {n_shapes} x {forwards}, K2 launches "
             f"{counts['K2']} != {n_shapes} x {steps} or K3 launches {counts['K3']} != {k3}")


def changed_params(trained: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    init = api.create_model(MODEL, in_samples=WINDOW, seed=SEED).state_dict()
    params = [k for k in init if not k.endswith(("running_mean", "running_var"))]
    return sum(not torch.equal(trained[k], init[k]) for k in params), len(params)


def test_outputs(log_dir: str) -> dict:
    """The test run's metrics JSON and results CSV, checked."""
    with open(os.path.join(log_dir, "test_metrics_synthetic.json")) as f:
        payload = json.load(f)
    with open(os.path.join(log_dir, "test_results_synthetic_test.csv"), newline="") as f:
        rows = list(csv.reader(f))
    values = [v for m in payload["metrics"].values() for v in m.values()]
    print(f"[test] loss {payload['loss']:.6f}; metrics {json.dumps(payload['metrics'])}; CSV "
          f"{len(rows) - 1} rows, columns {rows[0][1:]}", flush=True)
    if (set(payload["metrics"]) != {"det", "ppk", "spk"} or not np.isfinite(payload["loss"])
            or not np.isfinite(values).all() or len(rows) - 1 != TEST_EVENTS):
        fail(f"test outputs: {payload}, {len(rows) - 1} CSV rows (want {TEST_EVENTS})")
    return payload


class Scrape(logging.Handler):
    """Reads the train run's ``--metrics-port -1`` from its log and, at the
    run's first loss line (printed while later calls run), scrapes
    ``/metrics`` once: the endpoint of a live run."""

    def __init__(self):
        super().__init__()
        self.url = ""
        self.text = ""

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("[obs] metrics endpoint: "):
            self.url = msg.split(": ", 1)[1]
        elif not self.text and self.url and "_train epoch" in msg and " loss " in msg:
            with urllib.request.urlopen(self.url, timeout=30) as r:
                self.text = r.read().decode()


class SpanLog:
    """A bus span sink keeping every span's duration (ms) by name."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = {}

    def __call__(self, span):
        self.ms.setdefault(span.name, []).append((span.duration_s or 0.0) * 1e3)


def profile_trace(log_dir: str) -> dict:
    """The ``--profile-steps`` capture of a train run: its file's size, and
    the device kernels it lists (all, K1's, K2's;
    ``obs/attribution.py::kernels_in_trace``)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "profile", "*", "trace.json")))
    if len(paths) != 1:
        fail(f"expected one profiler trace under {log_dir}/profile, found {paths}")
    table = attribution.kernels_in_trace(paths[0])
    return {"path": paths[0], "bytes": table["bytes"], "kernels": int(table["kernels"]),
            "K1": int(attribution.launches_of(table, "fwd_kernel")),
            "K2": int(attribution.launches_of(table, "bwd_kernel"))}


def read_scalars(tb_dir: str) -> Tuple[List[dict], str]:
    """The ``ScalarWriter``'s rows ({tag, step, value}): ``scalars.jsonl``,
    or the TensorBoard event files where the package imported."""
    path = os.path.join(tb_dir, "scalars.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            return [json.loads(x) for x in f], "scalars.jsonl"
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(tb_dir, size_guidance={"scalars": 0})
    acc.Reload()
    return ([{"tag": tag, "step": e.step, "value": e.value}
             for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)],
            "TensorBoard event files")


def check_train_telemetry(log_dir: str, scrape: Scrape, spans: SpanLog, n_shapes: int,
                          name_power: str, wps0: float) -> Tuple[Dict[str, float], dict]:
    """Phase 6's telemetry: the scrape of the live run's ``/metrics``, the
    train task metrics in the scalars at the ``--log-step`` calls,
    the profiler capture (K1 and K2 in it where CUPTI lists graph kernels)
    and the train entry's span p50s; returns the p50s and the capture."""
    want = ("seist_step_dispatch_ms_count", "seist_host_wait_ms_bucket", "seist_train_loss ",
            "seist_global_step ", "seist_data_plane_reads ", "seist_loader_batches_total ")
    missing = [w for w in want if w not in scrape.text]
    print(f"[obs] /metrics scraped from the live run at {scrape.url}: {len(scrape.text)} bytes, "
          f"{sum(1 for x in scrape.text.splitlines() if not x.startswith('#'))} samples; "
          f"missing {missing}", flush=True)
    if not scrape.text or missing:
        fail(f"the train run's /metrics was not scraped or lacks {missing}")
    rows, form = read_scalars(os.path.join(log_dir, "tensorboard"))
    tags = sorted({r["tag"].rsplit("/", 1)[0] for r in rows})
    metric_steps = sorted({r["step"] for r in rows
                           if r["tag"].startswith("train.ppk.metrics/step/")})
    print(f"[obs] scalars ({form}): {len(rows)} rows, tags {tags}; train.ppk.metrics/step at "
          f"steps {metric_steps}", flush=True)
    log_calls = list(range(0, TRAIN_STEPS, 4))  # --log-step 4, one batch per call
    if metric_steps != log_calls or not all(np.isfinite(r["value"]) for r in rows) or any(
            f"train.{t}.metrics/step" not in tags for t in ("det", "ppk", "spk")):
        fail(f"the scalars lack the train task metrics at steps {log_calls}")
    prof = profile_trace(log_dir)
    graph_kernels = prof["K1"] + prof["K2"] > 0
    print(f"[obs] {name_power} | --profile-steps {PROFILE_STEPS}: {os.path.relpath(prof['path'])} "
          f"{prof['bytes']} bytes, {prof['kernels']} device kernels, K1 {prof['K1']}, K2 "
          f"{prof['K2']}: CUPTI {'lists' if graph_kernels else 'does not list'} the kernels "
          f"inside a replayed graph" + (f" (want {PROFILE_STEPS * n_shapes} of each)"
                                        if graph_kernels else ""), flush=True)
    if graph_kernels and (prof["K1"], prof["K2"]) != (PROFILE_STEPS * n_shapes,) * 2:
        fail("the profiler listed graph kernels but not K1 and K2 five times per step")
    p50 = {k: float(np.median(v)) for k, v in sorted(spans.ms.items())}
    print(f"[obs] {name_power} | train entry spans, p50 ms (count): "
          + ", ".join(f"{k} {p50[k]:.3f} ({len(spans.ms[k])})" for k in (
              "host_wait", "step_dispatch", "log_interval", "validate", "checkpoint_save",
              "train_epoch") if k in p50)
          + f"; waveforms_per_sec gauge {BUS.gauge('waveforms_per_sec').value:.1f} "
          f"(before the run {wps0:.1f}); per call (call 0 captures the step, calls "
          f"3-{2 + PROFILE_STEPS} run under the profiler): host_wait "
          f"{[round(x, 3) for x in spans.ms.get('host_wait', [])]}, step_dispatch "
          f"{[round(x, 3) for x in spans.ms.get('step_dispatch', [])]}", flush=True)
    if not {"host_wait", "step_dispatch", "validate", "checkpoint_save"} <= set(p50):
        fail(f"the train run recorded spans {sorted(p50)} only")
    return p50, prof


def train_test_phase(log_base: str, n_shapes: int, name_power: str) -> dict:
    """Train one epoch and test, through the CLI entry (phase 6), with the
    telemetry on: the metrics endpoint scraped while the run lives, a
    two-step profiler capture, the train task metrics in its scalars."""
    scrape, spans = Scrape(), SpanLog()
    logger.addHandler(scrape)
    BUS.add_span_sink(spans)
    wps0 = BUS.gauge("waveforms_per_sec").value
    try:
        best, counts, wall_s, _ = run_entry(TRAIN_ARGS + [
            "--mode", "train_test", "--save-interval-steps", str(SAVE_EVERY), "--log-base",
            log_base, "--metrics-port", "-1", "--profile-steps", str(PROFILE_STEPS)])
    finally:
        logger.removeHandler(scrape)
        BUS.remove_span_sink(spans)
    log_dir = os.path.dirname(os.path.dirname(best))
    p50, prof = check_train_telemetry(log_dir, scrape, spans, n_shapes, name_power, wps0)
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    val = np.load(os.path.join(log_dir, "val_losses.npy"))
    print(f"[train_test] {MODEL} window {WINDOW} batch {TRAIN_BATCH}: {len(losses)} steps, "
          f"losses {[round(float(x), 5) for x in losses]}, val {val.tolist()}, K1 launches "
          f"{counts['K1']}, K2 launches {counts['K2']}, wall {wall_s:.1f} s", flush=True)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not np.isfinite(val).all():
        fail(f"train losses: {losses}, val {val}")
    check_launches(counts, n_shapes, TRAIN_STEPS + VAL_BATCHES + TEST_BATCHES, TRAIN_STEPS)
    payload = test_outputs(log_dir)
    interval = [os.path.join(log_dir, "checkpoints", f"{kind}_{SAVE_EVERY}.pt")
                for kind in ("model", "state")]
    if not all(os.path.exists(p) for p in interval):
        fail(f"the interval checkpoint is missing: {interval}")
    trained = torch.load(best, map_location="cpu", weights_only=True)
    changed, n_params = changed_params(trained)
    print(f"[train_test] {changed}/{n_params} parameter tensors changed; best checkpoint "
          f"{os.path.relpath(best)}; interval checkpoint {os.path.basename(interval[0])} and "
          f"{os.path.basename(interval[1])} written", flush=True)
    if changed < 0.9 * n_params or not all(torch.isfinite(t).all() for t in trained.values()):
        fail("training did not change the parameters, or made them non-finite")
    entry = load_model_entry(MODEL, best, window=WINDOW, device="cuda")
    x = normalize(traces(1)[0].T, "std", axis=0).astype(np.float32)[None]
    out = entry.run(x)
    res = decode_outputs(entry, out, PredictOptions.from_dict({}))
    print(f"[train_test] the best checkpoint serves: {json.dumps(res)[:200]}", flush=True)
    if not bool(torch.isfinite(out).all()) or res.get("task") != "picking":
        fail("the trained checkpoint does not serve")
    return {"counts": counts, "wall_s": wall_s, "log_dir": log_dir, "best": best,
            "losses": losses, "test_loss": payload["loss"], "spans_p50": p50, "profile": prof}


def resume_phase(run: dict, n_shapes: int) -> dict:
    """Resume phase 6's run from its interval checkpoint (phase 6b)."""
    log_dir = run["log_dir"]
    ckpt = os.path.join(log_dir, "checkpoints", f"model_{SAVE_EVERY}.pt")
    _, counts, wall_s, lines = run_entry(TRAIN_ARGS + ["--mode", "train", "--checkpoint", ckpt])
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    want = run["losses"][SAVE_EVERY:]
    record = torch.load(os.path.join(log_dir, "checkpoints", f"state_{TRAIN_STEPS}.pt"),
                        map_location="cpu", weights_only=True)
    resumed = [line for line in lines if line.startswith("Mid-epoch resume")]
    rel = float(np.max(np.abs(losses - want) / np.abs(want))) if len(losses) == len(want) else -1
    print(f"[resume] {resumed}; steps {SAVE_EVERY + 1}-{TRAIN_STEPS} losses "
          f"{[round(float(x), 6) for x in losses]} vs uninterrupted "
          f"{[round(float(x), 6) for x in want]} (max rel {rel:.2e}, limit {RESUME_RTOL:.0e}); "
          f"update count {record['step']}; K1 launches {counts['K1']}, K2 launches "
          f"{counts['K2']}, wall {wall_s:.1f} s", flush=True)
    if resumed != [f"Mid-epoch resume: epoch 0 from batch {SAVE_EVERY}"]:
        fail(f"no mid-epoch resume from batch {SAVE_EVERY} in the log")
    if not 0 <= rel <= RESUME_RTOL or record["step"] != TRAIN_STEPS:
        fail("the resumed run does not continue the uninterrupted one")
    check_launches(counts, n_shapes, TRAIN_STEPS - SAVE_EVERY + VAL_BATCHES,
                   TRAIN_STEPS - SAVE_EVERY)
    return {"counts": counts, "wall_s": wall_s, "max_rel": rel}


def test_batch(dev):
    """The test split's one (padded) batch: inputs, targets, mask."""
    args = cli.get_args(TRAIN_ARGS)
    loader = worker._build_loader(args, taskspec.get_task_spec(MODEL), "test")
    (batch,) = list(loader)
    loader.close()
    return (move_batch(batch.inputs, dev), move_batch(batch.loss_targets, dev),
            torch.from_numpy(batch.mask).to(dev))


def bf16_phase(log_base: str, n_shapes: int, fp32_best: str, dev) -> dict:
    """``train_test`` in bf16 through the CLI entry (phase 6c)."""
    best, counts, wall_s, _ = run_entry(TRAIN_ARGS + [
        "--mode", "train_test", "--dtype", "bf16", "--log-base", log_base])
    log_dir = os.path.dirname(os.path.dirname(best))
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    val = np.load(os.path.join(log_dir, "val_losses.npy"))
    print(f"[bf16] {MODEL} window {WINDOW} batch {TRAIN_BATCH} --dtype bf16: losses "
          f"{[round(float(x), 5) for x in losses]}, val {val.tolist()}; K1 launches "
          f"{counts['K1']} (bf16 {counts['K1_bf16']}), K2 launches {counts['K2']} (bf16 "
          f"{counts['K2_bf16']}), wall {wall_s:.1f} s", flush=True)
    check_launches(counts, n_shapes, TRAIN_STEPS + VAL_BATCHES + TEST_BATCHES, TRAIN_STEPS)
    if counts["K1_bf16"] != counts["K1"] or counts["K2_bf16"] != counts["K2"]:
        fail("a launch of the bf16 run went past the bf16 kernels")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not np.isfinite(val).all():
        fail(f"bf16 train losses: {losses}, val {val}")
    test_outputs(log_dir)
    trained = torch.load(best, map_location="cpu", weights_only=True)
    record = torch.load(state_path_for(best), map_location="cpu", weights_only=True)
    moments = [t for st in record["optimizer"]["state"].values()
               for key, t in st.items() if key in ("exp_avg", "exp_avg_sq")]
    changed, n_params = changed_params(trained)
    fp32 = all(t.dtype == torch.float32 for t in list(trained.values()) + moments)
    print(f"[bf16] {changed}/{n_params} parameter tensors changed; parameters, BatchNorm "
          f"statistics and {len(moments)} Adam moments all fp32: {fp32}", flush=True)
    if changed < 0.9 * n_params or not fp32:
        fail("bf16 training left parameters unchanged or the master state not fp32")

    # A bf16 eval forward of phase 6's best weights against the fp32 one.
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED)
    model.load_state_dict(torch.load(fp32_best, map_location="cpu", weights_only=True))
    state = TrainState(model.to(dev))
    x, y, mask = test_batch(dev)
    loss_fn = taskspec.make_loss(MODEL)
    before = pa.launches, pa.bf16_launches
    l32, o32 = make_eval_step(loss_fn)(state, x, y, mask)
    l16, o16 = make_eval_step(loss_fn, compute_dtype="bf16")(state, x, y, mask)
    pa.launches, pa.bf16_launches = before
    valid = int(mask.sum())
    err = max_err(o16[:valid], o32[:valid])
    print(f"[bf16] eval forward of the fp32 run's best weights on the test batch ({valid} "
          f"events): bf16 vs fp32 outputs max abs {err:.3e} (limit {BF16_OUT_TOL}); loss "
          f"{float(l16):.6f} vs {float(l32):.6f}; outputs {o16.dtype}", flush=True)
    if not err <= BF16_OUT_TOL or o16.dtype != torch.float32:
        fail("the bf16 eval forward is too far from the fp32 one")
    return {"counts": counts, "wall_s": wall_s, "eval_err": err}


# ------------------------------------------------------------- phases 6d, 6e
class PackQueue:
    """The synthetic packs the run trains and re-picks on, made one after
    another by ``python -m seist_tpu_torch pack`` child processes on a
    thread of this process from the script's start, while the card works;
    each phase waits for its own (``verdict``). Jobs: (out, the pack's
    arguments, its processes)."""

    def __init__(self, jobs: List[Tuple[str, List[str], int]]):
        self.jobs = jobs
        self.results: Dict[str, Tuple[int, str]] = {}
        self.done = {out: threading.Event() for out, _, _ in jobs}
        self.proc: Optional[subprocess.Popen] = None
        self._stopped = False
        atexit.register(self.stop)  # an exit on a failure stops the pack at work
        self._thread = threading.Thread(target=self._run, name="packs", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        root = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for out, argv, workers in self.jobs:
            try:
                if self._stopped:
                    raise RuntimeError("stopped")
                self.proc = subprocess.Popen(
                    [sys.executable, "-m", "seist_tpu_torch", "pack", "--out", out,
                     "--workers", str(workers), "--no-resume", *argv],
                    cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, start_new_session=True)
                stdout, stderr = self.proc.communicate(timeout=600)
                self.results[out] = (self.proc.returncode, stdout + stderr[-3000:])
            except Exception as e:  # noqa: BLE001 - the phase that waits fails on it
                self.results[out] = (-1, repr(e))
            self.done[out].set()

    def stop(self) -> None:
        self._stopped = True
        proc = self.proc
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    def verdict(self, out: str) -> Tuple[int, dict]:
        """Wait for ``out``'s pack: its exit code and its JSON verdict."""
        if not self.done[out].wait(timeout=900):
            fail(f"the pack {out} was not made")
        rc, text = self.results[out]
        lines = [x for x in text.splitlines() if x.startswith("{")]
        if rc != 0 or not lines:
            fail(f"pack {out}: rc {rc}\n{text[-2000:]}")
        return rc, json.loads(lines[-1])


PACKS_DIR = "packs"  # under the build directory


def pack_args(dtype: str, events: int = 256, shard_mb: float = 8.0) -> List[str]:
    """``pack``'s arguments for the synthetic dataset at trace 12000 (the
    size phase 6 trains on)."""
    return ["--dataset", "synthetic", "--dataset-kwargs", json.dumps({"num_events": events}),
            "--dtype", dtype, "--shard-mb", str(shard_mb)]


def repick_pack_args(dtype: str) -> List[str]:
    """``pack``'s arguments for phase 15's archive at trace WINDOW."""
    return ["--dataset", "synthetic", "--dataset-kwargs",
            json.dumps({"num_events": REPICK_EVENTS, "trace_samples": WINDOW}), "--dtype", dtype,
            "--samples-per-shard", str(REPICK_SHARD)]


def pack_jobs() -> List[Tuple[str, List[str], int]]:
    """Every pack of the run, in the order the phases need them: phase 6d's
    two, phase 8's 2,048 events (phase 11 trains on them too), phase 15's
    archives."""
    pack_dir = os.path.join(str(_kernels.BUILD_DIR), PACKS_DIR)
    return [(os.path.join(pack_dir, "f32_256"), pack_args("float32"), 4),
            (os.path.join(pack_dir, "i8_256"), pack_args("int8"), 4),
            (os.path.join(pack_dir, f"float32_{LOADER_EVENTS}"),
             pack_args("float32", LOADER_EVENTS, 512), 4),
            (os.path.join(pack_dir, "repick_float32"), repick_pack_args("float32"), 1),
            (os.path.join(pack_dir, "repick_int8"), repick_pack_args("int8"), 1)]


_PACKS: Optional[PackQueue] = None


def packs() -> PackQueue:
    """The run's PackQueue, started at its first use (main() starts it once
    the kernels are built)."""
    global _PACKS
    if _PACKS is None:
        _PACKS = PackQueue(pack_jobs())
    return _PACKS


def pack_entry(out: str, dtype: str, events: int = 256) -> dict:
    """The JSON verdict of ``out``'s pack of the synthetic dataset (trace
    12000, the size phase 6 trains on), made by ``packs()``."""
    rc, verdict = packs().verdict(out)
    print(f"[pack] {dtype}: {events} events -> {verdict['shards']} shards, "
          f"{verdict['on_disk_bytes']} bytes ({verdict['bytes_vs_fp32']} of float32), "
          f"{verdict['wall_s']} s with {verdict['workers']} pack processes", flush=True)
    if rc != 0 or verdict["samples"] != events or verdict["dtype"] != dtype:
        fail(f"pack {dtype}: rc {rc}, {verdict}")
    return verdict


def packed_args(data: str) -> List[str]:
    """Phase 6's train arguments on a pack instead of the synthetic dataset."""
    args = list(TRAIN_ARGS)
    i = args.index("--synthetic-events")
    del args[i:i + 2]
    args[args.index("synthetic")] = "packed"
    return args + ["--data", data]


def max_rel(got: np.ndarray, want: np.ndarray) -> float:
    if len(got) != len(want):
        fail(f"{len(got)} losses against {len(want)}")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def packed_phase(log_base: str, n_shapes: int, run: dict) -> dict:
    """Pack phase 6's events and train on the packs (phase 6d)."""
    pack_dir = os.path.join(str(_kernels.BUILD_DIR), PACKS_DIR)
    f32, i8 = os.path.join(pack_dir, "f32_256"), os.path.join(pack_dir, "i8_256")
    if pack_entry(f32, "float32")["shards"] < 2:
        fail("the float32 pack has one shard: --shard-mb 8 must give more")
    pack_entry(i8, "int8")
    best, counts, wall_s, _ = run_entry(packed_args(f32) + [
        "--mode", "train_test", "--save-interval-steps", str(SAVE_EVERY), "--log-base", log_base])
    log_dir = os.path.dirname(os.path.dirname(best))
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    rel = max_rel(losses, run["losses"])
    with open(os.path.join(log_dir, "test_metrics_packed.json")) as f:
        plane = json.load(f)["data_plane"]
    faults = {k: v for k, v in plane["counters"].items() if k != "reads"}
    print(f"[packed] train_test on the float32 pack: losses {[round(float(x), 6) for x in losses]}"
          f" vs phase 6 on the synthetic dataset: max rel {rel:.2e} (limit {RESUME_RTOL:.0e}); "
          f"K1 launches {counts['K1']}, K2 launches {counts['K2']}, wall {wall_s:.1f} s; "
          f"data_plane {json.dumps(plane['counters'])}, quarantined "
          f"{plane['quarantine']['quarantined']}", flush=True)
    check_launches(counts, n_shapes, TRAIN_STEPS + VAL_BATCHES + TEST_BATCHES, TRAIN_STEPS)
    if not rel <= RESUME_RTOL:
        fail("losses on the float32 pack differ from phase 6's on the same events")
    if any(faults.values()) or plane["quarantine"]["quarantined"] or not plane["counters"]["reads"]:
        fail(f"the data plane saw faults on a clean pack: {plane}")
    best8, counts8, wall8, _ = run_entry(packed_args(i8) + ["--mode", "train",
                                                            "--log-base", log_base])
    losses8 = np.load(os.path.join(os.path.dirname(os.path.dirname(best8)), "train_losses.npy"))
    print(f"[packed] one epoch on the int8 pack: losses {[round(float(x), 6) for x in losses8]} "
          f"beside float32's {[round(float(x), 6) for x in losses]}; K1 launches "
          f"{counts8['K1']}, K2 launches {counts8['K2']}, wall {wall8:.1f} s", flush=True)
    check_launches(counts8, n_shapes, TRAIN_STEPS + VAL_BATCHES, TRAIN_STEPS)
    if len(losses8) != TRAIN_STEPS or not np.isfinite(losses8).all():
        fail(f"int8 pack losses: {losses8}")
    return {"counts": counts, "counts_i8": counts8, "max_rel": rel, "f32": f32, "i8": i8,
            "wall_s": wall_s}


def check_preempt_dump(run_dir: str) -> None:
    """The preempted run's one flight dump: reason ``preempt``, at least
    one step and a ``step_dispatch`` span."""
    dumps = glob.glob(os.path.join(run_dir, "flight", "flight_*.json"))
    dump = json.load(open(dumps[0])) if len(dumps) == 1 else {}
    names = sorted({x["name"] for x in dump.get("spans", [])})
    print(f"[preempt] flight dump {[os.path.basename(d) for d in dumps]}: reason "
          f"{dump.get('reason')}, steps {[x['step'] for x in dump.get('steps', [])]}, spans "
          f"{names}, last step {dump.get('last_step')}", flush=True)
    if dump.get("reason") != "preempt" or not dump.get("steps") or "step_dispatch" not in names:
        fail("the preemption left no flight dump with reason preempt, a step and a "
             "step_dispatch span")


def preempt_phase(n_shapes: int, run: dict, data: str) -> dict:
    """SIGTERM at step 3 of a train run on the float32 pack, then the
    resume from the newest checkpoint (phase 6e)."""
    log_base = os.path.join(str(_kernels.BUILD_DIR), "preempt_logs")
    shutil.rmtree(log_base, ignore_errors=True)
    os.environ["SEIST_FAULT_SIGTERM_STEP"] = str(SAVE_EVERY)
    try:
        _, counts, wall_s, lines = run_entry(packed_args(data) + ["--mode", "train",
                                                                   "--log-base", log_base],
                                             expect_exit=PREEMPT_EXIT_CODE)
    finally:
        del os.environ["SEIST_FAULT_SIGTERM_STEP"]
    ckpt = find_newest_checkpoint(log_base)
    want = [os.path.join(os.path.dirname(ckpt or ""), f"{kind}_{SAVE_EVERY}.pt")
            for kind in ("model", "state")]
    print(f"[preempt] SEIST_FAULT_SIGTERM_STEP={SAVE_EVERY}: SystemExit({PREEMPT_EXIT_CODE}); "
          f"{[x for x in lines if x.startswith('Preempted')]}; newest checkpoint "
          f"{ckpt and os.path.relpath(ckpt)}; K1 launches {counts['K1']}, K2 launches "
          f"{counts['K2']}, wall {wall_s:.1f} s", flush=True)
    if ckpt != want[0] or not os.path.exists(want[1]):
        fail(f"no model_{SAVE_EVERY}.pt / state_{SAVE_EVERY}.pt after the preemption")
    check_launches(counts, n_shapes, SAVE_EVERY, SAVE_EVERY)
    check_preempt_dump(os.path.dirname(os.path.dirname(ckpt)))
    _, counts_r, wall_r, lines = run_entry(packed_args(data) + ["--mode", "train",
                                                                "--checkpoint", ckpt])
    log_dir = os.path.dirname(os.path.dirname(ckpt))
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    rel = max_rel(losses, run["losses"][SAVE_EVERY:])
    record = torch.load(os.path.join(log_dir, "checkpoints", f"state_{TRAIN_STEPS}.pt"),
                        map_location="cpu", weights_only=True)
    print(f"[preempt] resumed: {[x for x in lines if x.startswith('Mid-epoch resume')]}; steps "
          f"{SAVE_EVERY + 1}-{TRAIN_STEPS} losses {[round(float(x), 6) for x in losses]} vs "
          f"phase 6 max rel {rel:.2e} (limit {RESUME_RTOL:.0e}); update count {record['step']}; "
          f"K1 launches {counts_r['K1']}, K2 launches {counts_r['K2']}, wall {wall_r:.1f} s",
          flush=True)
    if not rel <= RESUME_RTOL or record["step"] != TRAIN_STEPS:
        fail("the run resumed after the preemption does not continue phase 6's")
    check_launches(counts_r, n_shapes, TRAIN_STEPS - SAVE_EVERY + VAL_BATCHES,
                   TRAIN_STEPS - SAVE_EVERY)
    return {"counts": counts, "counts_resumed": counts_r, "max_rel": rel}


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
        events = attribution.device_kernels(prof)
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


def bound(n, l, m, h, e, itemsize, peak_ops) -> Tuple[float, float, float]:
    """(bytes_ms, ops_ms, tc_ms): q, k, v read once and o written once;
    4*N*L*M*H*E operations (a multiply-add each for QK^T and PV) at the
    type's peak, and in 3xTF32 on the tensor cores."""
    nbytes = itemsize * n * h * e * (2 * l + 2 * m)
    ops = 4 * n * l * m * h * e
    return (nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3,
            3 * ops / PEAK_TF32_S * 1e3)


def bound_of(bytes_ms: float, ops_ms: float, tc_ms: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the bytes' time or the operations' at the
    faster of the two rates, whichever is larger."""
    op_ms = min(ops_ms, tc_ms)
    return max(bytes_ms, op_ms), "bytes" if bytes_ms >= op_ms else "operations"


def time_shapes(shapes, dev, n: int = BATCH, types=("fp32", "bf16")) -> List[dict]:
    """K1, its plain version and ``F.scaled_dot_product_attention`` at
    batch ``n`` in each of ``types``, rate 0."""
    rows = []
    for i, (l, m, h, e) in enumerate(shapes):
        for name, dtype, peak in (("fp32", torch.float32, PEAK_FP32_S),
                                  ("bf16", torch.bfloat16, PEAK_BF16_S)):
            if name not in types:
                continue
            q, k, v = qkv(n, l, m, h, e, dtype, 500 + i, dev)
            scale = 1.0 / math.sqrt(e)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            seed = pa.seed_tensor(0, dev)  # made once: the timed call is K1's launch alone
            fns = {"ms": lambda: kernel(q, k, v, seed=seed), "plain_ms": lambda: plain(q, k, v),
                   "library_ms": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                        scale=scale)}
            row = {"N": n, "L": l, "M": m, "H": h, "E": e, "dtype": name}
            for key, fn in fns.items():
                row[key] = device_ms(fn)
                row["call_" + key] = time_ms(fn, 200 if key != "plain_ms" else 50)
            row["bytes_ms"], row["ops_ms"], row["tc_ms"] = bound(n, l, m, h, e,
                                                                 q.element_size(), peak)
            rows.append(row)
    return rows


def bound_bwd(n, l, m, h, e, itemsize, peak_ops=PEAK_FP32_S) -> Tuple[float, float, float]:
    """(bytes_ms, ops_ms, tc_ms) of K2: q, k, v, g, o (``itemsize`` bytes
    each) and the fp32 lse read once and dq, dk, dv written once;
    10*N*L*M*H*E operations (a multiply-add each for QK^T, dPd, dV, dQ and
    dK) at the type's peak (the fp32 CUDA cores, or the bf16 tensor cores),
    and in 3xTF32 on the tensor cores."""
    nbytes = itemsize * n * h * e * (4 * l + 4 * m) + 4 * n * h * l
    ops = 10 * n * l * m * h * e
    return (nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3,
            3 * ops / PEAK_TF32_S * 1e3)


def time_bwd_shapes(shapes, dev, dtype=torch.float32) -> List[dict]:
    """K2 at rate 0.3 (``ms``, as the train step runs it) and at rate 0
    (``ms0``, like for like with the library call), its plain version and the
    backward of ``F.scaled_dot_product_attention`` (rate 0) at the train
    step's shapes, on ``dtype`` inputs."""
    rows = []
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_FP32_S
    for i, (l, m, h, e) in enumerate(shapes):
        q, k, v, g = qkvg(TRAIN_BATCH, l, m, h, e, dtype, 800 + i, dev)
        seed = pa.seed_tensor(5, dev)  # made once: the timed call is K2's launch alone
        o, lse = kernel(q, k, v, 0.3, seed, with_lse=True)
        o0, lse0 = kernel(q, k, v, 0.0, seed, with_lse=True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        scale = 1.0 / math.sqrt(e)
        ot = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        gt = g.transpose(1, 2)
        fns = {"ms": lambda: kernel_bwd(q, k, v, g, o, lse, 0.3, seed),
               "ms0": lambda: kernel_bwd(q, k, v, g, o0, lse0, 0.0, seed),
               "plain_ms": lambda: plain_bwd(q, k, v, g, o, lse, 0.3, 5),
               "library_ms": lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                         retain_graph=True)}
        row = {"L": l, "M": m, "H": h, "E": e}
        for key, fn in fns.items():
            row[key] = device_ms(fn)
            row["call_" + key] = time_ms(fn, 100 if key != "plain_ms" else 20)
        row["bytes_ms"], row["ops_ms"], row["tc_ms"] = bound_bwd(
            TRAIN_BATCH, l, m, h, e, q.element_size(), peak)
        rows.append(row)
    return rows


def time_train_step(weights: str, batch: int, steps: int = 5, dtype: str = "fp32",
                    captured: bool = False) -> dict:
    """Forward, backward and guarded update of seist_l_dpk (its drop rates
    0.3) at ``batch`` in the compute ``dtype``, eager or as the captured
    graph the train worker runs: host wall time per step over ``steps``
    steps after two warm ones (the first captures), the steps queued
    without a host read between them; peak memory above what was
    allocated before (the model, the optimizer, the step's activations,
    and for the graph its warm-up's snapshot and its pool); capture
    seconds."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    model.cuda()
    state = TrainState(model, build_optimizer("adam", model.parameters()), constant(1e-4))
    step = make_train_step(taskspec.make_loss(MODEL), compute_dtype=dtype)
    if captured:
        step = capture_train_step(step)
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
    return {"ms": ms, "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
            "before_gib": before / 2**30,
            "capture_s": step.graphs.capture_seconds[0] if captured else None,
            "state": state, "step": step, "x": x, "y": y}


def profile_train_step(run: dict, iters: int = 3) -> dict:
    """``obs/attribution.py::measured_kernels`` over ``iters`` train steps of
    a :func:`time_train_step` run (its steps were the warm-up): wall and
    device-busy ms per step, idle share, kernels per step, the kernels that
    take most."""
    state, step, x, y = run["state"], run["step"], run["x"], run["y"]
    seeds = iter(range(100, 100 + iters))
    return attribution.measured_kernels(
        lambda: step(state, x, y, RandomSource.from_seed(next(seeds), "cuda")), iters=iters,
        warmup=0)


def time_forward(entry) -> Dict[int, float]:
    out = {}
    for b in (1, 2, 4, 8):
        x = np.random.default_rng(b).standard_normal((b, WINDOW, 3)).astype(np.float32)
        out[b] = time_ms(lambda: entry.run(x), 20, warmup=3)
    return out


def profile_forward(entry, iters: int = 5) -> dict:
    """``measured_kernels`` over ``iters`` batch-8 forwards: wall and
    device-busy ms, idle share, kernels per forward, the kernels that take
    most."""
    x = np.random.default_rng(0).standard_normal((BATCH, WINDOW, 3)).astype(np.float32)
    return attribution.measured_kernels(lambda: entry.run(x), iters=iters, top_k=6)


LOADER_EVENTS = 2048  # 295 MB of float32 waveforms at trace 12000, 74 MB as int8


def loader_rate(dataset: str, data: str, batch: int, processes: int) -> Tuple[float, int]:
    """Waveforms/s of the train Loader that ``--dataset-name dataset``
    builds at window 8192 with augmentation on, with ``--workers 8``
    threads or ``--loader-processes processes``, over the second half of
    its first epoch: the first half starts the pools (a worker process
    imports torch, seconds each, and starts when work arrives). Returns
    (rate, waveforms timed)."""
    argv = ["--model-name", MODEL, "--dataset-name", dataset, "--in-samples", str(WINDOW),
            "--batch-size", str(batch), "--seed", str(SEED), "--workers", "8",
            "--loader-processes", str(processes)]
    argv += (["--synthetic-events", str(LOADER_EVENTS)] if dataset == "synthetic"
             else ["--data", data])
    loader = worker._build_loader(cli.get_args(argv), taskspec.get_task_spec(MODEL), "train")
    try:
        batches, warm = iter(loader), len(loader) // 2
        for _ in range(warm):
            next(batches)
        t0, n = time.perf_counter(), 0
        for b in batches:
            n += len(b.mask)
        rate = n / (time.perf_counter() - t0)
    finally:
        loader.close()
    return rate, n


def loader_phase(name_power: str, step_ms: Dict[int, float]) -> List[dict]:
    """The train Loader's throughput on the float32 pack of the synthetic
    dataset (which phase 11 trains on), at batch 500, with 4 processes,
    beside the fp32 train step's consumption."""
    pack_dir = os.path.join(str(_kernels.BUILD_DIR), PACKS_DIR)
    sources = []
    for dtype in ("float32",):
        out = os.path.join(pack_dir, f"{dtype}_{LOADER_EVENTS}")
        pack_entry(out, dtype, events=LOADER_EVENTS)
        sources.append(("packed", out, dtype))
    consume = {b: b * 1e3 / ms for b, ms in step_ms.items()}
    rows = []
    for batch in (500,):
        for dataset, data, label in sources:
            for processes in (4,):
                rate, n = loader_rate(dataset, data, batch, processes)
                mode = "4 processes" if processes else "8 threads"
                rows.append({"source": label, "batch": batch, "mode": mode, "wps": rate})
                print(f"[loader] {name_power} | {os.cpu_count()} CPUs | train Loader, window "
                      f"{WINDOW}, augmentation on, {LOADER_EVENTS} events, {dataset} "
                      f"({label}), b{batch}, {mode}: {rate:.1f} waveforms/s over the epoch's "
                      f"last {n}; the fp32 "
                      f"train step consumes {consume[TRAIN_BATCH]:.1f} (b{TRAIN_BATCH}) and "
                      f"{consume[256]:.1f} (b256) waveforms/s", flush=True)
    print(f"[loader] the packs sit in the page cache: these rates are the host's cost per "
          f"sample (read, widen, preprocess, augment, assemble), not the disk's", flush=True)
    return rows


# ------------------------------------------------------------- phase 9
CAPTURE_STEPS = 6  # captured against eager steps, from the same state


def _dropout_pattern(model: torch.nn.Module, dev) -> Tuple[torch.Tensor, list]:
    """Buffers that hold, after each step, the zero pattern of the first
    attention block's output-projection dropout and where its input is
    nonzero (where a zero of the output is the dropout's decision): written
    by copies in a forward hook, which a captured step captures and
    replays."""
    att = next(m for m in model.modules() if isinstance(m, AttentionBlock))
    holder: list = []

    def hook(module, inputs, out):
        if not module.training:
            return
        if not holder:
            holder.extend(torch.zeros(out.shape, dtype=torch.bool, device=dev) for _ in range(2))
        holder[0].copy_(out == 0)
        holder[1].copy_(inputs[0] != 0)

    att.proj_drop.register_forward_hook(hook)
    return att, holder


def _train_model(weights: str, dev):
    """seist_l_dpk from phase 5's seeded weights, its drop rates 0.3, with
    Adam at a constant 1e-4 (the weights keep the activations O(1), so
    the dropout's zeros are its own)."""
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    model.to(dev)
    return TrainState(model, build_optimizer("adam", model.parameters()), constant(1e-4))


def _state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Everything an update changes but the gradients: parameters,
    BatchNorm statistics, Adam's moments and step counters, the count."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out["count"] = state.count
    return {k: v.detach().clone() for k, v in out.items()}


def captured_vs_eager(weights: str, dev) -> dict:
    """Phase 9a-b: CAPTURE_STEPS captured steps against as many eager ones
    from the same weights, batches and (seed, epoch, step); then a NaN
    batch through the captured step."""
    loss_fn = taskspec.make_loss(MODEL)
    g = torch.Generator().manual_seed(SEED + 9)
    xs = [torch.randn(TRAIN_BATCH, WINDOW, 3, generator=g).to(dev) for _ in range(CAPTURE_STEPS)]
    ys = [torch.rand(TRAIN_BATCH, WINDOW, 3, generator=g).to(dev) for _ in range(CAPTURE_STEPS)]
    runs = {}
    for mode in ("eager", "captured"):
        state = _train_model(weights, dev)
        att, pattern = _dropout_pattern(state.model, dev)
        step = make_train_step(loss_fn)
        if mode == "captured":
            step = capture_train_step(step)
        losses, patterns = [], []
        before = pa.counts()
        for t in range(CAPTURE_STEPS):
            # Step 1's outputs, as the worker copies them on a log-step call.
            kw = {"keep_outputs": t == 1} if mode == "captured" else {}
            loss, out, diag = step(state, xs[t], ys[t], step_random_source(SEED, 0, t, dev),
                                   **kw)
            if t == 1:
                kept = out.clone() if mode == "eager" else out
            losses.append(float(loss))
            patterns.append((pattern[0].clone(), pattern[1].clone()))
            if not bool(diag["applied"]):
                fail(f"{mode} step {t} was skipped")
        launches = tuple(b - a for a, b in zip(before, pa.counts()))
        pa.set_counts(before)
        runs[mode] = {"state": state, "step": step, "losses": np.array(losses),
                      "patterns": patterns, "launches": launches, "outputs": kept}
    eager, cap = runs["eager"], runs["captured"]
    rel = max_rel(cap["losses"], eager["losses"])
    out_err = max_err(cap["outputs"], eager["outputs"]) / max(
        1.0, float(eager["outputs"].abs().max()))
    print(f"[capture] step 1's outputs copied from the graph ({tuple(cap['outputs'].shape)}, "
          f"{cap['outputs'].numel() * 4 / 2**20:.2f} MiB, what the graph's pool keeps beyond "
          f"PR 9's) vs the eager step's: max error {out_err:.3e} relative to max(1, |eager|) "
          f"(limit {RESUME_RTOL:.0e})", flush=True)
    if not out_err <= RESUME_RTOL:
        fail("the captured step's copied outputs differ from the eager step's")
    # The dropout's decisions are compared where both runs' inputs are
    # nonzero: a product that rounds to exactly 0 in one run and not in the
    # other (cuDNN sums in another order in a graph) zeroes an output the
    # dropout kept.
    both = [nz_a & nz_b for (_, nz_a), (_, nz_b) in zip(cap["patterns"], eager["patterns"])]
    same = [bool(torch.equal(a[v], b[v])) for (a, _), (b, _), v in
            zip(cap["patterns"], eager["patterns"], both)]
    raw_diff = sum(int((a != b).sum()) for (a, _), (b, _) in zip(cap["patterns"],
                                                                 eager["patterns"]))
    exact_zero = sum(int((~v).sum()) for v in both)
    fresh = [not torch.equal(a, b) for (a, _), (b, _) in zip(cap["patterns"],
                                                             cap["patterns"][1:])]
    frac = float(cap["patterns"][0][0].float().mean())
    graph = next(iter(cap["step"].graphs.by_key.values()))
    print(f"[capture] {MODEL} window {WINDOW} b{TRAIN_BATCH} fp32, drop rates 0.3: "
          f"{CAPTURE_STEPS} captured steps vs eager: losses {cap['losses'].tolist()} vs "
          f"{eager['losses'].tolist()} (max rel {rel:.3e}, limit {RESUME_RTOL:.0e}); "
          f"output-projection dropout decisions identical at every step: {all(same)} (over "
          f"{sum(int(v.sum()) for v in both)} elements; {exact_zero} with an input of exactly 0 "
          f"in a run, {raw_diff} zeros of the outputs differ), new each step: {all(fresh)}, "
          f"dropped fraction {frac:.4f}; attention seeds per "
          f"step {graph.seeds.numel()}; launches K1/K2 per replay {graph.launches[:2]}, over "
          f"the {CAPTURE_STEPS} steps captured {cap['launches'][:2]} eager "
          f"{eager['launches'][:2]}; capture {cap['step'].graphs.capture_seconds[0]:.2f} s",
          flush=True)
    if not rel <= RESUME_RTOL or not all(same) or not all(fresh) or not 0.25 < frac < 0.35:
        fail("the captured step does not reproduce the eager one")
    if cap["launches"] != eager["launches"] or graph.seeds.numel() != len(
            api.create_model(MODEL, in_samples=WINDOW).attention_shapes(WINDOW)):
        fail("the captured step's attention launches or seeds differ from the eager step's")

    # 9b: a NaN batch through the captured step changes no byte of the state.
    state, step = cap["state"], cap["step"]
    want = _state_tensors(state)
    loss, _, diag = step(state, xs[0] * float("nan"), ys[0],
                         step_random_source(SEED, 0, CAPTURE_STEPS, dev))
    got = _state_tensors(state)
    changed = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"[capture] NaN batch through the captured step: applied {bool(diag['applied'])}, "
          f"loss {float(loss)}; {len(want)} state tensors (parameters, BatchNorm statistics, "
          f"Adam moments and step counters, update count {int(state.count)}) bitwise "
          f"unchanged: {not changed}", flush=True)
    if bool(diag["applied"]) or changed or int(state.count) != CAPTURE_STEPS:
        fail(f"the skipped captured step changed the state: {changed[:5]}")
    loss, _, diag = step(state, xs[1], ys[1], step_random_source(SEED, 0, CAPTURE_STEPS, dev))
    if not bool(diag["applied"]) or int(state.count) != CAPTURE_STEPS + 1:
        fail("the captured step did not recover after the skipped one")
    out = {"max_rel": rel, "capture_s": cap["step"].graphs.capture_seconds[0],
           "replay_profile": profile_replay(state, step, xs[2], ys[2])}
    del runs, cap, eager, state, step
    torch.cuda.empty_cache()
    return out


def profile_replay(state, step, x, y) -> dict:
    """torch.profiler over one replay (``measured_kernels``): does the trace
    show the kernels inside a graph, and K1 and K2 five times each?"""
    m = attribution.measured_kernels(
        lambda: step(state, x, y, step_random_source(SEED, 0, 99, x.device)), iters=1, warmup=0)
    k1, k2 = (int(attribution.launches_of(m, n)) for n in ("fwd_kernel", "bwd_kernel"))
    total = int(m["kernels"])
    print(f"[capture] torch.profiler over one replay: {total} kernels traced, K1 {k1}, K2 "
          f"{k2}", flush=True)
    if total and (k1, k2) != (5, 5):
        fail(f"one replay traced K1 {k1} and K2 {k2} times, not 5 and 5")
    return {"kernels": total, "K1": k1, "K2": k2}


def grouped_entry_phase(log_base: str, n_shapes: int, run: dict) -> dict:
    """Phase 9c: ``train_test`` with ``--steps-per-call 2``, then with
    ``--grad-accum-steps 2 --batch-size 32``, through the CLI entry."""
    best, counts, wall_s, lines = run_entry(TRAIN_ARGS + [
        "--mode", "train_test", "--steps-per-call", "2", "--log-base", log_base])
    log_dir = os.path.dirname(os.path.dirname(best))
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    pairs = run["losses"].reshape(-1, 2).mean(axis=1)
    rel = max_rel(losses, pairs)
    record = torch.load(state_path_for(best), map_location="cpu", weights_only=True)
    print(f"[spc] train_test --steps-per-call 2: losses per call {losses.tolist()} vs phase 6's "
          f"pair means {pairs.tolist()} (max rel {rel:.3e}, limit {RESUME_RTOL:.0e}); update "
          f"count {record['step']}; K1 launches {counts['K1']}, K2 {counts['K2']}, wall "
          f"{wall_s:.1f} s", flush=True)
    check_launches(counts, n_shapes, TRAIN_STEPS + VAL_BATCHES + TEST_BATCHES, TRAIN_STEPS)
    if not rel <= RESUME_RTOL or record["step"] != TRAIN_STEPS:
        fail("--steps-per-call 2 does not train phase 6's steps")
    test_outputs(log_dir)

    args = [a for a in TRAIN_ARGS]
    args[args.index("--batch-size") + 1] = "32"
    best, counts_a, wall_a, lines = run_entry(args + [
        "--mode", "train_test", "--grad-accum-steps", "2", "--log-base", log_base])
    log_dir = os.path.dirname(os.path.dirname(best))
    losses_a = np.load(os.path.join(log_dir, "train_losses.npy"))
    record = torch.load(state_path_for(best), map_location="cpu", weights_only=True)
    micro = 2 * len(losses_a)
    print(f"[accum] train_test --grad-accum-steps 2 --batch-size 32: {len(losses_a)} updates of "
          f"2 micro-batches, losses {[round(float(x), 6) for x in losses_a]}; update count "
          f"{record['step']}; {[x for x in lines if x.startswith('grad_accum_steps')]}; K1 "
          f"launches {counts_a['K1']}, K2 {counts_a['K2']}, wall {wall_a:.1f} s", flush=True)
    check_launches(counts_a, n_shapes, micro + 2, micro)
    if record["step"] != len(losses_a) or not np.isfinite(losses_a).all() or not len(losses_a):
        fail("--grad-accum-steps 2 did not apply one update per two micro-batches")
    test_outputs(log_dir)
    return {"counts": counts, "counts_accum": counts_a, "max_rel": rel, "wall_s": wall_s,
            "wall_accum_s": wall_a}


# ------------------------------------------------------------- phase 10
#: The five families with a task row and the window each trains at
#: (DiTingMotion's published input is 128 samples).
BASELINES = {"phasenet": WINDOW, "eqtransformer": WINDOW, "magnet": WINDOW,
             "baz_network": WINDOW, "ditingmotion": 128}
# 128 synthetic events -> 102 train (x2 by augmentation -> 3 batches of 64),
# one padded val batch and one padded test batch.
BASELINE_EVENTS, BASELINE_STEPS = 128, 3
#: EQTransformer trains with both L1 terms on (``--conv-*-l1-alpha``).
L1_ARGS = ["--conv-kernel-l1-alpha", "1e-4", "--conv-bias-l1-alpha", "1e-4"]
BF16_LOSS_RTOL = 0.05  # bf16 vs fp32 step loss, the JAX package's limit (tests/test_train.py)
#: The model's output on the card vs the CPU (cuDNN and the CPU sum in other
#: orders), as PROB_TOL; DistPTNetwork's heads are unbounded values.
DISTPT_TOL = 1e-4


def baseline_args(name: str) -> List[str]:
    """The train entry's arguments for one family. A window that
    augmentation turns into noise keeps no value or class label, which
    the loader (the JAX package's too) cannot stack: the families with
    such labels train with ``--generate-noise-rate 0``."""
    args = ["--model-name", name, "--dataset-name", "synthetic", "--synthetic-events",
            str(BASELINE_EVENTS), "--in-samples", str(BASELINES[name]), "--batch-size",
            str(TRAIN_BATCH), "--epochs", "1", "--seed", str(SEED), "--device", "cuda"]
    if name in ("magnet", "baz_network", "ditingmotion"):
        args += ["--generate-noise-rate", "0"]
    return args + (L1_ARGS if name == "eqtransformer" else [])


def baseline_batch(name: str, n: int, seed: int, dev):
    """Seeded inputs and targets of a family's task row at its window."""
    window = BASELINES.get(name, WINDOW)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, window, 2 if name == "ditingmotion" else 3, generator=g)
    if name in ("phasenet", "eqtransformer"):
        y = torch.rand(n, window, 3, generator=g)
    elif name == "magnet":
        y = 6.0 * torch.rand(n, 1, generator=g)
    elif name == "baz_network":
        y = 360.0 * torch.rand(n, 1, generator=g)
    else:
        y = tuple(torch.eye(2)[torch.randint(0, 2, (n,), generator=g)].long() for _ in "cp")
    return x.to(dev), (tuple(t.to(dev) for t in y) if isinstance(y, tuple) else y.to(dev))


def serve_phasenet(name_power: str) -> None:
    """Phase 10a: PhaseNet served at window 8192 from seeded weights (its
    own initialisers), 24 concurrent requests; every response's picks
    within 0.1 s of the port's CPU run of the same trace."""
    weights = os.path.join(str(_kernels.BUILD_DIR), f"phasenet_seed{SEED}.pt")
    torch.save(api.create_model("phasenet", in_samples=WINDOW, seed=SEED).state_dict(), weights)
    service = srv.build_service([("phasenet", weights)], window=WINDOW, device="cuda",
                                max_batch=BATCH, max_delay_ms=20.0, shed_config=NO_SHED)
    server = srv.start_http_server(service, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d/predict" % server.server_address[1]
    data, opts = traces(N_REQUESTS), {"max_events": 1}
    results: List[Tuple[int, dict, float]] = [None] * N_REQUESTS

    def one(i: int) -> None:
        t0 = time.perf_counter()
        status, body = post(url, {"data": data[i].tolist(), "options": opts})
        results[i] = (status, body, (time.perf_counter() - t0) * 1e3)

    before = pa.counts()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(N_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    launches = tuple(b - a for a, b in zip(before, pa.counts()))
    forwards = service.metrics()["models"]["phasenet"]["forwards"]
    server.shutdown()
    service.shutdown()
    if any(r is None or r[0] != 200 or r[1].get("task") != "picking" for r in results):
        fail(f"a phasenet /predict failed: {[r and (r[0], str(r[1])[:120]) for r in results]}")
    cpu = load_model_entry("phasenet", weights, window=WINDOW, device="cpu")
    x = np.stack([normalize(t.T, "std", axis=0) for t in data]).astype(np.float32)
    out_cpu = cpu.run(x)
    popts = PredictOptions.from_dict(opts)
    close = n_picks = 0
    for i, (_, body, _) in enumerate(results):
        ref = decode_outputs(cpu, out_cpu[i:i + 1], popts)
        close += picks_close(body, ref, PICK_TOL_S * popts.sampling_rate)
        n_picks += sum(len(ref[k]) for k in ("ppk", "spk"))
    lat = np.array([r[2] for r in results])
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"[phasenet-serve] {name_power} | window {WINDOW}: {N_REQUESTS} concurrent /predict -> "
          f"{forwards} forwards; picks within {PICK_TOL_S} s of the CPU run in {close} of "
          f"{N_REQUESTS} responses ({n_picks} reference picks); client p50 {p50:.1f} ms p99 "
          f"{p99:.1f} ms; K1/K2 launches {launches[:2]}", flush=True)
    if close != N_REQUESTS or n_picks == 0 or any(launches):
        fail("served PhaseNet's picks differ from the CPU run, or an attention kernel ran")


def baseline_train_test(name: str, log_base: str) -> None:
    """Phase 10b: ``train_test`` of one family through the train entry, the
    plain attention versions patched to raise (no family reaches them)."""
    best, counts, wall_s, lines = run_entry(baseline_args(name) + [
        "--mode", "train_test", "--log-base", log_base])
    log_dir = os.path.dirname(os.path.dirname(best))
    losses = np.load(os.path.join(log_dir, "train_losses.npy"))
    with open(os.path.join(log_dir, "test_metrics_synthetic.json")) as f:
        payload = json.load(f)
    with open(os.path.join(log_dir, "test_results_synthetic_test.csv"), newline="") as f:
        rows = len(list(csv.reader(f))) - 1
    eval_tasks = list(taskspec.get_task_spec(name).eval)
    values = [v for m in payload["metrics"].values() for v in m.values()]
    print(f"[baseline-train] {name} window {BASELINES[name]} b{TRAIN_BATCH}"
          f"{' ' + ' '.join(L1_ARGS) if name == 'eqtransformer' else ''}: losses "
          f"{[round(float(x), 5) for x in losses]}, test loss {payload['loss']:.5f}, metrics "
          f"{json.dumps(payload['metrics'])}, CSV {rows} rows; attention launches "
          f"{sum(counts.values())}; wall {wall_s:.1f} s", flush=True)
    if (len(losses) != BASELINE_STEPS or not np.isfinite(losses).all()
            or sorted(payload["metrics"]) != sorted(eval_tasks) or not rows
            or not np.isfinite([payload["loss"]] + values).all() or any(counts.values())):
        fail(f"{name} train_test: losses {losses}, metrics {payload['metrics']}, {rows} rows, "
             f"attention launches {counts}")
    if name == "eqtransformer" and not any("conv_kernel_l1_alpha: 0.0001" in x for x in lines):
        fail("the L1 flags did not reach the eqtransformer run")


def baseline_state(name: str, dev) -> TrainState:
    model = api.create_model(name, in_channels=2 if name == "ditingmotion" else 3,
                             in_samples=BASELINES[name], seed=SEED).to(dev)
    return TrainState(model, build_optimizer("adam", model.parameters()), constant(1e-4))


def baseline_steps(name: str, dev, name_power: str) -> None:
    """Phase 10c-d and the family's times: 3 captured b64 steps against 3
    eager ones from the same weights, batches and (seed, epoch, step), their
    drop rates on (losses within RESUME_RTOL, no attention launch); then 5
    timed steps of each, one profiled captured step; the forward at b8;
    for eqtransformer and magnet one bf16 captured step against fp32."""
    loss_fn = taskspec.make_loss(name)
    batches = [baseline_batch(name, TRAIN_BATCH, 100 + t, dev) for t in range(3)]
    runs = {}
    for mode in ("eager", "captured"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_b = torch.cuda.memory_allocated()
        state = baseline_state(name, dev)
        step = make_train_step(loss_fn)
        if mode == "captured":
            step = capture_train_step(step)
        before = pa.counts()
        losses = [float(step(state, x, y, step_random_source(SEED, 0, t, dev))[0])
                  for t, (x, y) in enumerate(batches)]
        launches = tuple(b - a for a, b in zip(before, pa.counts()))
        x, y = batches[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5):
            step(state, x, y, step_random_source(SEED, 1, i, dev))
        torch.cuda.synchronize()
        runs[mode] = {"losses": np.array(losses), "launches": launches,
                      "ms": (time.perf_counter() - t0) * 1e3 / 5,
                      "peak_gib": (torch.cuda.max_memory_allocated() - before_b) / 2**30,
                      "state": state, "step": step}
    cap, eag = runs["captured"], runs["eager"]
    rel = max_rel(cap["losses"], eag["losses"])
    prof = profile_train_step({"state": cap["state"], "step": cap["step"], "x": batches[0][0],
                               "y": batches[0][1]})
    model = cap["state"].model.eval()
    xf = baseline_batch(name, BATCH, 7, dev)[0]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(xf), 20, warmup=3)
    print(f"[baseline-capture] {name} window {BASELINES[name]} b{TRAIN_BATCH} fp32, its drop "
          f"rates: 3 captured steps vs eager: losses {cap['losses'].tolist()} vs "
          f"{eag['losses'].tolist()} (max rel {rel:.3e}, limit {RESUME_RTOL:.0e}); attention "
          f"launches captured {sum(cap['launches'])}, eager {sum(eag['launches'])}; capture "
          f"{cap['step'].graphs.capture_seconds[0]:.2f} s", flush=True)
    print(f"[baseline-time] {name_power} | {name} window {BASELINES[name]}: forward b{BATCH} "
          f"{fwd_ms:.3f} ms; train step b{TRAIN_BATCH} captured {cap['ms']:.2f} ms, eager "
          f"{eag['ms']:.2f} ms; captured step: device busy {prof['busy_ms']:.2f} "
          f"ms, {prof['kernels']:.0f} kernels, idle share {prof['idle_share']:.3f} "
          f"(profiled wall {prof['wall_ms']:.2f} ms); peak memory captured "
          f"{cap['peak_gib']:.3f} GiB, eager {eag['peak_gib']:.3f} GiB", flush=True)
    for line in attribution.kernel_lines(prof, "step")[:4]:
        print(f"[baseline-time]   {line}", flush=True)
    if not rel <= RESUME_RTOL or any(cap["launches"]) or any(eag["launches"]):
        fail(f"{name}: the captured step does not reproduce the eager one")
    del runs, cap, eag, model
    if name in ("eqtransformer", "magnet"):  # 10d
        x, y = batches[0]
        got = {}
        for dtype in ("fp32", "bf16"):
            state = baseline_state(name, dev)
            step = capture_train_step(make_train_step(loss_fn, compute_dtype=dtype))
            got[dtype] = float(step(state, x, y, step_random_source(SEED, 0, 0, dev))[0])
            if not all(p.dtype == torch.float32 for p in state.model.parameters()):
                fail(f"{name} bf16 step left a parameter in another dtype")
        rel16 = abs(got["bf16"] - got["fp32"]) / abs(got["fp32"])
        print(f"[baseline-bf16] {name}: captured bf16 step loss {got['bf16']:.6f} vs fp32 "
              f"{got['fp32']:.6f} (rel {rel16:.3e}, limit {BF16_LOSS_RTOL})", flush=True)
        if not rel16 <= BF16_LOSS_RTOL:
            fail(f"{name}: the bf16 step's loss is off the fp32 one")
    torch.cuda.empty_cache()


def baz_features(dev) -> None:
    """BAZNetwork's eigen features on the card against the CPU, for windows
    of noise mixed across the channels (distinct eigenvalues, so each
    eigenvector is defined up to its sign): covariance and eigenvalues
    alike, the eigenvectors equal up to sign, the windows where cuSOLVER's
    sign differs from LAPACK's counted, the outputs compared where none
    does and, on the CPU's features, in every window; and the features'
    cost per b64 step (computed before each replay)."""
    from seist_tpu_torch.models.baz_network import cov_features

    window = BASELINES["baz_network"]
    model = api.create_model("baz_network", in_samples=window, seed=SEED)
    g = torch.Generator().manual_seed(11)
    mix = torch.linalg.qr(torch.randn(3, 3, generator=g))[0] * torch.tensor([3.0, 1.5, 0.5])
    x = torch.randn(TRAIN_BATCH, window, 3, generator=g) @ mix
    xg = x.to(dev)
    f_cpu, f_gpu = cov_features(x), cov_features(xg).cpu()
    same_rest = float((f_gpu[:, :4] - f_cpu[:, :4]).abs().max())
    dots = (f_gpu[:, 4:] * f_cpu[:, 4:]).sum(dim=-1)  # (N, 3): +-1 per eigenvector
    aligned = bool(((dots.abs() - 1).abs() < 1e-4).all())
    agree = (dots > 0).all(dim=1)
    with torch.no_grad():
        o_cpu = model(x)
        model.to(dev)
        o_gpu = [o.cpu() for o in model(xg)]
        o_fed = [o.cpu() for o in model((xg, f_cpu.to(dev)))]  # the CPU's features on the card
    err = max(float(torch.cat([(a - b).abs()[agree].reshape(-1), torch.zeros(1)]).max())
              for a, b in zip(o_gpu, o_cpu))
    fed_err = max(float((a - b).abs().max()) for a, b in zip(o_fed, o_cpu))
    ms = time_ms(lambda: cov_features(xg), 20)
    flips = int((~agree).sum())
    per_vector = (dots < 0).sum(dim=0).tolist()
    print(f"[baz-eigh] b{TRAIN_BATCH} window {window}: covariance and eigenvalues, card vs CPU, "
          f"max abs err {same_rest:.2e}; eigenvectors equal up to sign: {aligned}; cuSOLVER's "
          f"sign differs from LAPACK's in {flips} of {len(agree)} windows (per eigenvector, "
          f"ascending: {per_vector}); outputs on the card's own features where no sign differs "
          f"({int(agree.sum())} windows) max abs err {err:.2e}, on the CPU's features (all "
          f"windows) {fed_err:.2e} (limit {PROB_TOL:.0e}); features before each replay "
          f"{ms:.3f} ms per b{TRAIN_BATCH} step", flush=True)
    if (not same_rest <= PROB_TOL or not aligned or not err <= PROB_TOL
            or not fed_err <= PROB_TOL):
        fail("BAZNetwork's features or outputs on the card differ from the CPU's")


def distpt_forward(dev) -> None:
    """Phase 10e: DistPTNetwork at window 8192 on the card against the CPU."""
    model = api.create_model("distpt_network", in_samples=WINDOW, seed=SEED)
    x = torch.randn(BATCH, WINDOW, 3, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        want = model(x)
        got = [o.cpu() for o in model.to(dev)(x.to(dev))]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"[distpt] window {WINDOW} b{BATCH}: outputs on the card vs the CPU max abs err "
          f"{err:.2e} (limit {DISTPT_TOL:.0e})", flush=True)
    if not err <= DISTPT_TOL:
        fail("DistPTNetwork on the card differs from the CPU")


def baseline_phase(name_power: str, log_base: str, dev) -> None:
    """Phase 10: the six baseline families on the card at their published
    widths."""
    t0 = time.perf_counter()
    serve_phasenet(name_power)
    for name in BASELINES:
        baseline_train_test(name, log_base)
    for name in BASELINES:
        baseline_steps(name, dev, name_power)
    baz_features(dev)
    distpt_forward(dev)
    print(f"[baseline] phase 10: {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------- phase 11
# The int32 rate of one H100 SXM: its 132 SMs have 64 INT32 lanes each
# beside 128 FP32 lanes (Hopper architecture white paper), so a quarter of
# the published fp32 FLOP/s (which counts an FMA as two). K3's bound counts
# the threefry2x32 blocks its draws need at that rate, each block the
# integer instructions the built kernel issues to the int32 pipe for it
# (:func:`sass_threefry_block`: its SHF rotates, LOP3 xors and IADD3 adds;
# the adds compiled to IMAD run on the FMA pipe, beside the float work),
# and 40 fp32 operations per normal (log1p, sqrt, nine FMAs of the erfinv
# polynomial, the scaling). Counted by hand from the algorithm, a block is
# 77 operations (20 rounds of add, rotate and xor; five key injections of
# three adds; two initial adds): that bound is printed beside it.
PEAK_INT32_S = PEAK_FP32_S / 4
THREEFRY_OPS_BY_HAND = 77
NORMAL_FLOPS = 40
#: SASS opcodes of the int32 (ALU) pipe among a threefry block's
#: instructions; IMAD runs on the FMA pipe, and VIADD's pipe is not
#: documented (it is left out of the bound).
INT32_PIPE = ("SHF", "LOP3", "IADD3", "PRMT")
DA_STEPS = 3  # captured against eager device-aug steps, from the same state


def aug_store(argv: List[str]):
    """The train split of ``argv``'s dataset, its RawStore and AugConfig."""
    from seist_tpu_torch.data import device_aug as da

    sds = worker._build_loader(cli.get_args(argv), taskspec.get_task_spec(MODEL),
                               "train").dataset
    store = pipeline.RawStore.build(sds)
    cfg = da.AugConfig.from_preprocessor(sds.preprocessor, seed=SEED, raw_len=store.raw_len,
                                         phase_slots=store.phase_slots)
    return sds, store, cfg


def aug_batch(store, batch: int, epoch: int = 0, pin: bool = True):
    """Batch 0 of the epoch's order as the step mode's feed makes it."""
    item = next(pipeline.iter_raw_batches(store, epoch, seed=SEED, shuffle=True,
                                          batch_size=batch))
    return pipeline.raw_batch_tensors(item, pin)


def _sass_instructions(text: str) -> List[Tuple[str, List[str]]]:
    """(opcode, operands) of each instruction of ``cuobjdump -sass`` output."""
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m:
            out.append((m.group(1), [o.strip() for o in m.group(2).split(",")]))
    return out


def _sass_reg(token: str) -> Optional[str]:
    m = re.fullmatch(r"-?\|?(R\d+)\|?(?:\.reuse)?", token.strip())
    return m.group(1) if m else None


def sass_threefry_block(text: str) -> Dict[str, int]:
    """Opcode counts of one threefry block in K3's SASS (``text``, the
    library's ``cuobjdump -sass``): in the field path's first group, from
    the row key's shared-memory load to the first store, each output's bits
    (the register ``LEA.HI ..., 0x3f800000`` turns into a float) are traced
    back through the instructions that computed them; a block is what the
    later outputs' traces add to the earlier ones' (the first also holds
    the key schedule it shares). Every later block must count the same."""
    ins = _sass_instructions(text)
    start = next(i for i, (op, _) in enumerate(ins) if op.startswith("LDS"))
    end = next(i for i in range(start, len(ins)) if ins[i][0].startswith("STG"))

    def dest(i: int) -> Optional[str]:
        op, ops = ins[i]
        return None if op.startswith(("ST", "BRA", "BSSY", "BSYNC")) else _sass_reg(ops[0])

    def trace(i: int, reg: str) -> set:
        found, todo = set(), [(i, reg)]
        while todo:
            at, want = todo.pop()
            j = next((j for j in range(at - 1, start, -1) if dest(j) == want), None)
            if j is not None and j not in found:
                found.add(j)
                todo += [(j, r) for r in map(_sass_reg, ins[j][1][1:]) if r and r != "RZ"]
        return found

    traces = [trace(i, _sass_reg(ins[i][1][1])) for i in range(start, end)
              if ins[i][0] == "LEA.HI" and "0x3f800000" in ins[i][1]]
    seen, blocks = set(traces[0]), []
    for t in traces[1:]:
        blocks.append(dict(collections.Counter(ins[j][0] for j in t - seen)))
        seen |= t
    if not blocks or any(b != blocks[0] for b in blocks):
        fail(f"K3's SASS: {len(traces)} outputs in the first group, blocks {blocks}")
    return blocks[0]


def k3_sass(lib_path: Path) -> Dict[str, int]:
    """One threefry block of the built K3 (:func:`sass_threefry_block`),
    from ``cuobjdump -sass`` beside nvcc; fails without it."""
    cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed ({proc.returncode}): {proc.stderr[-500:]}")
    return sass_threefry_block(proc.stdout)


def k3_bound(batch: int, cfg, int_ops: int) -> Tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes_ms, ops_ms) of one K3 launch over a batch:
    its outputs written once and the indices read once, against the
    threefry blocks (two for the key chain and one per named draw of each
    sample, one per output element) at ``int_ops`` integer operations each
    at the int32 rate, or the normals' float work at the fp32 rate,
    whichever is longer."""
    from seist_tpu_torch.data import device_aug as da

    uniforms, fields = da._draw_layout(cfg)
    slots = sum(n for _, _, n, _ in uniforms)
    normals = len(fields) * cfg.channels * cfg.raw_len
    nbytes = 4 * batch * (slots + normals) + 4 * (batch + 1)
    blocks = batch * (2 + len(uniforms) + len(fields) + slots + normals)
    int_ms = blocks * int_ops / PEAK_INT32_S * 1e3
    fp_ms = batch * normals * NORMAL_FLOPS / PEAK_FP32_S * 1e3
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, max(int_ms, fp_ms)
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms


def k3_chain_share(geometry: Dict[str, int], batch: int, n_slots: int, n_fields: int,
                   field_len: int) -> float:
    """The key chain's share of the threefry blocks K3's warps issue (a warp
    pays for a block once, however many of its lanes need it): three a
    field block (its thread 0 folds the row key) and three of every slot
    thread's four, against one per output group member of every active
    warp."""
    threads, per = geometry["threads"], geometry["per_thread"]
    chain = outputs = 0
    slot_warps = -(-batch * n_slots // 32)
    chain += 3 * slot_warps
    outputs += slot_warps
    rows = batch * n_fields
    for start in range(0, field_len, geometry["tile"]):
        groups = -(-min(geometry["tile"], field_len - start) // per)
        chain += 3 * rows
        for first in range(0, groups, threads):
            outputs += rows * per * -(-min(threads, groups - first) // 32)
    return chain / max(chain + outputs, 1)


def graph_ms(fn, launches: int = 50, iters: int = 20) -> float:
    """Device time per launch of ``fn``: CUDA events around replays of a
    graph that captured ``launches`` back-to-back calls (so the host's
    time to issue a call is not in it); the capture's launch counts go to
    a discarded tally."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), launch_counts.diverted(stream):
        fn()  # warm: the library is loaded, the first launch made
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    return time_ms(graph.replay, iters, warmup=2) / launches


def check_k3(store, cfg, dev, name_power: str) -> dict:
    """Phase 11a: K3 against its plain version on the card at b64 and b256
    of phase 6's train split (trace 12000, the CLI's default rates: both
    normal fields): keys of the plain version on the card and the CPU,
    uniforms and the integer draws made from them bitwise, normals within
    1e-6; then its grid, the key chain's share, one threefry block's SASS
    and times beside the bound from it (and from the hand count)."""
    from seist_tpu_torch.data import device_aug as da

    uniforms, fields = da._draw_layout(cfg)
    slots = [(tag, pos) for _, tag, n, _ in uniforms for pos in range(n)]
    tags = [tag for _, tag in fields]
    flen = cfg.channels * cfg.raw_len
    block = k3_sass(_kernels.library_path(KERNEL_K3))
    int_ops = sum(n for op, n in block.items() if op.split(".")[0] in INT32_PIPE)
    print(f"[k3] SASS of one threefry block: {sum(block.values())} integer instructions "
          f"({', '.join(f'{op} {n}' for op, n in sorted(block.items()))}); {int_ops} of them on "
          f"the int32 pipe (counted by hand: {THREEFRY_OPS_BY_HAND} operations)", flush=True)
    epoch = torch.tensor(0, dtype=torch.int32)
    out = {}
    for batch in (TRAIN_BATCH, 256):
        _, idx, _ = aug_batch(store, batch)
        idx_d, ep_d = idx.to(dev), epoch.to(dev)
        before = tf.launches
        u, f = tf.aug_draws(SEED, ep_d, idx_d, slots, tags, flen)
        torch.cuda.synchronize()
        tf.launches = before
        pu, pf = tf.aug_draws_plain(SEED, ep_d, idx_d, slots, tags, flen)
        keys_equal = torch.equal(tf.sample_keys(SEED, ep_d, idx_d).cpu(),
                                 tf.sample_keys(SEED, epoch, idx))
        ints_equal = all(torch.equal(da._u2i(u[:, s], n), da._u2i(pu[:, s], n))
                         for s in range(len(slots)) for n in (2, 40, cfg.raw_len, 2**30 - 1))
        err = float((f - pf).abs().max())
        exact = float((f == pf).float().mean())
        bound_ms, bound_by, bytes_ms, ops_ms = k3_bound(batch, cfg, int_ops)
        bound77_ms = k3_bound(batch, cfg, THREEFRY_OPS_BY_HAND)[0]
        geo = _kernels.aug_draws_shape(_kernels.build(KERNEL_K3), batch, len(slots), len(tags),
                                       flen)
        share = k3_chain_share(geo, batch, len(slots), len(tags), flen)

        def call():
            tf.aug_draws(SEED, ep_d, idx_d, slots, tags, flen, out=(u, f))

        # The profiler's one-call traces lose K3's kernel, and a wrapper call
        # takes the host longer than the kernel takes the card: CUDA events
        # around a captured run of back-to-back launches.
        ms = graph_ms(call)
        call_ms = time_ms(call, 100)
        plain_ms = time_ms(lambda: tf.aug_draws_plain(SEED, ep_d, idx_d, slots, tags, flen), 5,
                           warmup=1)
        tf.launches = before
        print(f"[k3] {name_power} | b{batch}: {len(slots)} uniforms and {len(tags)} normal fields "
              f"of {cfg.channels}x{cfg.raw_len} a sample; keys (card vs CPU) equal {keys_equal}, "
              f"uniforms equal {torch.equal(u, pu)}, integer draws equal {ints_equal}, normals "
              f"max abs err {err:.3g} ({exact:.4f} exact, limit 1e-6); grid {geo['blocks']} "
              f"blocks of {geo['threads']} threads ({geo['slot_blocks']} for the uniforms), "
              f"{geo['per_thread']} outputs a thread at once, {geo['tile'] // geo['threads']} a "
              f"thread a tile of {geo['tile']}; key chain {share:.2%} of the threefry blocks the "
              f"warps issue; ms per call: kernel {ms:.4f} (CUDA events over a captured run of "
              f"back-to-back launches; {call_ms:.4f} a wrapper call back to back), plain "
              f"{plain_ms:.4f}; bound {bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f}: {int_ops} int32-pipe instructions a block); bound / "
              f"kernel {bound_ms / ms:.3f}; with the hand count of {THREEFRY_OPS_BY_HAND} a block: "
              f"bound {bound77_ms:.4f}, bound / kernel {bound77_ms / ms:.3f}", flush=True)
        if not (keys_equal and torch.equal(u, pu) and ints_equal and err <= 1e-6):
            fail("K3 disagrees with its plain version")
        out[batch] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    return out


def processed_card_vs_cpu(sds, store, cfg, dev) -> None:
    """Phase 11a: the card's processed b64 batch (K3, then the ops) against
    the port's on the CPU for the same rows: phase arrays, counts and gates
    exactly, windows and labels within 1e-5."""
    from seist_tpu_torch.data import device_aug as da

    rows, idx, aug = aug_batch(store, TRAIN_BATCH, pin=False)
    epoch = torch.tensor(0, dtype=torch.int32)
    on_dev = pipeline._tree_map(lambda t: t.to(dev), rows)
    before = tf.launches
    states = []
    for r, i, a, e in ((rows, idx, aug, epoch), (on_dev, idx.to(dev), aug.to(dev), epoch.to(dev))):
        draws = da.draw_all(cfg, e, i)
        states.append(da.process_event(cfg, r["data"], *(r[k].long() for k in (
            "ppks", "np_p", "spks", "np_s")), draws, a))
    proc = da.make_row_processor(cfg, sds.input_names, sds.label_names)
    want = proc(rows, idx, aug, epoch)
    got = proc(on_dev, idx.to(dev), aug.to(dev), epoch.to(dev))
    torch.cuda.synchronize()
    tf.launches = before
    cpu, card = states
    exact = all(torch.equal(cpu[k], card[k].cpu()) for k in ("ppks", "np_p", "spks", "np_s",
                                                              "gen_fired"))
    win_err = float((cpu["win"] - card["win"].cpu()).abs().max())
    io_err = max(float((w - g.cpu()).abs().max()) for w, g in zip(want, got))
    print(f"[device-aug] b{TRAIN_BATCH} processed on the card vs the CPU, same rows: phases, "
          f"counts and gates equal {exact} ({int(card['gen_fired'].sum())} noise-generated, "
          f"{int((card['np_p'] > 0).sum())} with phases); windows max abs err {win_err:.3g}, "
          f"inputs and labels {io_err:.3g} (limit 1e-5)", flush=True)
    if not exact or win_err > 1e-5 or io_err > 1e-5:
        fail("the card's processed batch differs from the CPU's")


def da_entry(argv: List[str], mode: str, expect: List[str], n_shapes: int, forwards: int,
             steps: int) -> Tuple[str, dict, List[str], np.ndarray]:
    """One device-aug run through the train entry: the log must show the
    resolved mode (``expect`` prefixes) and no fallback; K1, K2 and K3
    (one per step) launched as the run's steps and forwards need."""
    best, counts, wall_s, lines = run_entry(argv)
    fallback = [x for x in lines if (x.startswith("--device-aug") and "->" in x)
                or "direct ingest unavailable" in x or "fallback path" in x]
    shown = [next((x for x in lines if x.startswith(p)), None) for p in expect]
    log_dir = os.path.dirname(os.path.dirname(best)) if best else ""
    losses = np.load(os.path.join(log_dir, "train_losses.npy")) if best else np.zeros(0)
    epoch_lines = [x for x in lines if x.startswith("Epoch ")]
    print(f"[device-aug] {mode}: {' | '.join(str(x)[:110] for x in shown)}; losses "
          f"{[round(float(x), 5) for x in losses]}; {epoch_lines}; K1 {counts['K1']}, K2 "
          f"{counts['K2']}, K3 {counts['K3']} launches, wall {wall_s:.1f} s", flush=True)
    if fallback or None in shown:
        fail(f"--device-aug {mode} did not run as asked: {fallback or lines[:5]}")
    check_launches(counts, n_shapes, forwards, steps, k3=steps)
    if not len(losses) or not np.isfinite(losses).all():
        fail(f"device-aug losses: {losses}")
    return best, counts, lines, losses


def train_seconds(lines: List[str], epoch: int) -> Tuple[float, int]:
    """(train-loop seconds, steps) of ``epoch`` from the worker's epoch line."""
    line = next(x for x in lines if x.startswith(f"Epoch {epoch}:"))
    m = re.search(r"\(train ([0-9.]+) s, (\d+) steps\)", line)
    return float(m.group(1)), int(m.group(2))


def device_aug_entry_phase(log_base: str, n_shapes: int, f32: str, i8: str,
                           big_pack: str) -> dict:
    """Phases 11b-c: ``--device-aug step`` through the train entry on phase
    6's synthetic events, on its float32 pack (``--ingest direct``, losses
    equal to the synthetic run's: the same events and keys) and int8 pack;
    ``--device-aug step --ingest direct`` and ``cached`` (automatic steps
    per call) on the 2048-event float32 pack for waveforms/s, and the
    cached run resumed from its interval checkpoint."""
    step_log = ["device-aug step:"]
    direct_log = ["packed direct ingest:", "device-aug step:"]
    two = ["--epochs", "2"]
    tt = TRAIN_STEPS * 2
    _, c_a, _, losses_a = da_entry(
        TRAIN_ARGS + two + ["--device-aug", "step", "--mode", "train_test", "--log-base",
                            log_base], "step (synthetic)", step_log, n_shapes,
        tt + 2 * VAL_BATCHES + TEST_BATCHES, tt)
    _, c_b, _, losses_b = da_entry(
        packed_args(f32) + two + ["--device-aug", "step", "--ingest", "direct", "--mode",
                                  "train_test", "--log-base", log_base],
        "step --ingest direct (float32 pack)", direct_log, n_shapes,
        tt + 2 * VAL_BATCHES + TEST_BATCHES, tt)
    rel = max_rel(losses_b, losses_a)
    print(f"[device-aug] float32 pack vs synthetic, same events and keys: losses max rel "
          f"{rel:.2e} (limit {RESUME_RTOL:.0e})", flush=True)
    if not rel <= RESUME_RTOL:
        fail("device-aug losses on the float32 pack differ from the synthetic run's")
    _, c_c, _, _ = da_entry(
        packed_args(i8) + ["--device-aug", "step", "--ingest", "direct", "--mode", "train",
                           "--log-base", log_base],
        "step --ingest direct (int8 pack)", direct_log, n_shapes, TRAIN_STEPS + VAL_BATCHES,
        TRAIN_STEPS)

    big = packed_args(big_pack) + ["--epochs", "2", "--mode", "train", "--log-base", log_base,
                                   "--keep-checkpoints", "10"]
    big_steps = (LOADER_EVENTS * 8 // 10) * 2 // TRAIN_BATCH  # 51
    big_val = -(-(LOADER_EVENTS // 10) // TRAIN_BATCH)  # 4
    _, c_d, lines_d, _ = da_entry(
        big + ["--device-aug", "step", "--ingest", "direct"],
        f"step --ingest direct ({LOADER_EVENTS}-event float32 pack)", direct_log, n_shapes,
        2 * big_steps + 2 * big_val, 2 * big_steps)
    spc = min(32, big_steps)
    cached_steps = (big_steps // spc) * spc
    best_e, c_e, lines_e, losses_e = da_entry(
        big + ["--device-aug", "cached", "--save-interval-steps", str(spc)],
        f"cached ({LOADER_EVENTS}-event float32 pack)", ["device-aug cached:"], n_shapes,
        2 * cached_steps + 2 * big_val, 2 * cached_steps)
    if not any(f"steps_per_call={spc}" in x for x in lines_e):
        fail(f"--device-aug cached did not take the automatic steps per call {spc}")
    run_e = os.path.dirname(os.path.dirname(best_e))
    ckpt = os.path.join(run_e, "checkpoints", f"model_{spc}.pt")
    _, c_r, lines_r, _ = da_entry(
        packed_args(big_pack) + ["--epochs", "2", "--mode", "train", "--device-aug", "cached",
                                 "--save-interval-steps", str(spc), "--checkpoint", ckpt],
        "cached, resumed", ["device-aug cached:", f"Mid-epoch resume: epoch 0 from batch {spc}"],
        n_shapes,
        cached_steps + 2 * big_val, cached_steps)
    resumed = np.load(os.path.join(run_e, "train_losses.npy"))
    rel_r = max_rel(resumed, losses_e[-len(resumed):])
    print(f"[device-aug] cached resumed from {os.path.basename(ckpt)} (epoch 0, batch {spc} of "
          f"{big_steps}): losses {resumed.tolist()} vs uninterrupted {losses_e.tolist()} (max "
          f"rel {rel_r:.2e}, limit {RESUME_RTOL:.0e})", flush=True)
    if not rel_r <= RESUME_RTOL:
        fail("the resumed cached run does not continue the uninterrupted one")
    rates = {}
    for mode, lines in (("step --ingest direct", lines_d), ("cached", lines_e)):
        secs, steps = train_seconds(lines, 1)
        rates[mode] = steps * TRAIN_BATCH / secs
    return {"counts": [c_a, c_b, c_c, c_d, c_e, c_r], "wps": rates}


def device_aug_captured_vs_eager(weights: str, store, sds, cfg, dev) -> dict:
    """Phase 11d: DA_STEPS captured device-aug steps (processor graph, then
    step graph) against as many eager ones from the same state, indices
    and (seed, epoch, step), in step and cached mode: losses within
    RESUME_RTOL."""
    from seist_tpu_torch.data import device_aug as da
    from seist_tpu_torch.train.graph import capture_processor
    from seist_tpu_torch.train.step import make_cached_train_call, make_device_aug_train_step

    loss_fn = taskspec.make_loss(MODEL)
    items = list(pipeline.iter_raw_batches(store, 0, seed=SEED, shuffle=True,
                                           batch_size=TRAIN_BATCH))[:DA_STEPS]
    cache = pipeline.DeviceEpochCache(store, dev)
    epoch = torch.tensor(0, dtype=torch.int32)
    out = {}
    for mode in ("step", "cached"):
        losses = {}
        for run in ("eager", "captured"):
            state = _train_model(weights, dev)
            step = make_train_step(loss_fn)
            if mode == "step":
                proc = da.make_row_processor(cfg, sds.input_names, sds.label_names)
                if run == "captured":
                    proc, step = capture_processor(proc, dev), capture_train_step(step)
                call = make_device_aug_train_step(loss_fn, proc, step=step)
            else:
                proc = da.make_cache_processor(cfg, sds.input_names, sds.label_names,
                                               store.n_raw, store.augmentation)
                if run == "captured":
                    proc = capture_processor(proc, dev, resident=1)
                    step = capture_train_step(step)
                call = make_cached_train_call(loss_fn, proc, step=step)
            got = []
            for t, item in enumerate(items):
                rows, idx, aug = pipeline.raw_batch_tensors(item, pin=True)
                rng = step_random_source(SEED, 0, t, dev)
                e = epoch if run == "captured" else epoch.to(dev)
                if run == "eager":
                    rows = pipeline._tree_map(lambda x: x.to(dev), rows)
                    idx, aug = idx.to(dev), aug.to(dev)
                if mode == "step":
                    got.append(call(state, rows, idx, aug, e, rng)[0])
                else:
                    got.append(call(state, cache.arrays, idx[None], e, rng)[0])
            losses[run] = [float(x) for x in got]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["captured"], losses["eager"]))
        print(f"[device-aug] {mode}: {DA_STEPS} captured steps vs eager from one state: losses "
              f"{losses['captured']} vs {losses['eager']} (max rel {rel:.3e}, limit "
              f"{RESUME_RTOL:.0e})", flush=True)
        if not rel <= RESUME_RTOL:
            fail(f"the captured device-aug {mode} step differs from the eager one")
        out[mode] = rel
    return out


def time_device_aug_step(weights: str, store, sds, cfg, batch: int, mode: str,
                         steps: int = 5) -> dict:
    """The captured device-aug call the train worker runs (processor graph,
    then step graph), seist_l_dpk at ``batch``: host wall time per step over
    ``steps`` after two warm ones, the step mode's rows ready in pinned
    memory as its feed thread leaves them; the processor replay alone
    (CUDA events over back-to-back replays); peak memory above what was allocated before; the cache's
    MiB in cached mode."""
    from seist_tpu_torch.data import device_aug as da
    from seist_tpu_torch.train.graph import capture_processor
    from seist_tpu_torch.train.step import make_cached_train_call, make_device_aug_train_step

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss_fn = taskspec.make_loss(MODEL)
    state = _train_model(weights, "cuda")
    step = capture_train_step(make_train_step(loss_fn))
    rows, idx, aug = aug_batch(store, batch)
    epoch = torch.tensor(0, dtype=torch.int32)
    cache_mib = 0.0
    torch.cuda.reset_peak_memory_stats()
    if mode == "step":
        proc = capture_processor(da.make_row_processor(cfg, sds.input_names, sds.label_names),
                                 "cuda")
        call = make_device_aug_train_step(loss_fn, proc, step=step)
        run = lambda i: call(state, rows, idx, aug, epoch, RandomSource.from_seed(i, "cuda"))
        replay = lambda: proc(rows, idx, aug, epoch)
    else:
        cache = pipeline.DeviceEpochCache(store, "cuda")
        cache_mib = cache.nbytes / 2**20
        proc = capture_processor(da.make_cache_processor(
            cfg, sds.input_names, sds.label_names, store.n_raw, store.augmentation), "cuda",
            resident=1)
        call = make_cached_train_call(loss_fn, proc, step=step)
        run = lambda i: call(state, cache.arrays, idx[None], epoch, RandomSource.from_seed(i, "cuda"))
        replay = lambda: proc(cache.arrays, idx, epoch)
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        run(10 + i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    proc_ms = time_ms(replay, 10, warmup=2)
    return {"ms": ms, "proc_ms": proc_ms,
            "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
            "cache_mib": cache_mib,
            "capture_s": proc.graphs.capture_seconds[0] + step.graphs.capture_seconds[0]}


def feed_rate(store, batch: int, batches: int = 8) -> float:
    """Waveforms/s of the step mode's host feed alone: a raw-row gather (or
    a packed store's shard fill) and the copy into pinned memory, one
    thread, the work of the worker's feed thread."""
    it = pipeline.iter_raw_batches(store, 1, seed=SEED, shuffle=True, batch_size=batch)
    pipeline.raw_batch_tensors(next(it), pin=True)
    t0, n = time.perf_counter(), 0
    for _ in range(batches):
        item = next(it, None)
        if item is None:
            break
        n += len(pipeline.raw_batch_tensors(item, pin=True)[1])
    return n / (time.perf_counter() - t0)


def device_aug_phase(name_power: str, logs: str, n_shapes: int, weights: str, dev,
                     packed: dict, step_ms: Dict[int, float], loader_rows: List[dict]) -> dict:
    """Phase 11: device augmentation and direct ingest (module docstring)."""
    from seist_tpu_torch.data import ingest as ingest_lib

    t0 = time.perf_counter()
    sds, store, cfg = aug_store(TRAIN_ARGS)
    k3 = check_k3(store, cfg, dev, name_power)
    processed_card_vs_cpu(sds, store, cfg, dev)
    big_pack = os.path.join(str(_kernels.BUILD_DIR), "packs", f"float32_{LOADER_EVENTS}")
    entry = device_aug_entry_phase(logs, n_shapes, packed["f32"], packed["i8"], big_pack)
    device_aug_captured_vs_eager(weights, store, sds, cfg, dev)
    big_sds, big_store, big_cfg = aug_store(packed_args(big_pack))
    direct = ingest_lib.PackedRawStore.build(big_sds, batch_size=256, reuse_staging=True)
    times = {}
    for batch in (TRAIN_BATCH, 256):
        for mode in ("step", "cached"):
            r = time_device_aug_step(weights, big_store, big_sds, big_cfg, batch, mode)
            times[(batch, mode)] = r
            print(f"[device-aug-time] {name_power} | {MODEL} window {WINDOW} b{batch} "
                  f"--device-aug {mode} captured (processor graph, then step graph): {r['ms']:.2f} "
                  f"ms/step ({batch * 1e3 / r['ms']:.1f} waveforms/s) beside the host-fed "
                  f"captured step's {step_ms[batch]:.2f} ms (phase 8); processor graph "
                  f"{r['proc_ms']:.3f} ms per replay (CUDA events, its input copies included); K3 "
                  f"{k3[batch]['ms']:.4f} ms (bound {k3[batch]['bound_ms']:.4f}); peak memory "
                  f"{r['peak_gib']:.2f} GiB above before"
                  + (f", cache {r['cache_mib']:.1f} MiB" if mode == "cached" else "")
                  + f"; captures {r['capture_s']:.2f} s", flush=True)
            torch.cuda.empty_cache()
    for batch in (TRAIN_BATCH, 256):
        feed = {"RawStore": feed_rate(big_store, batch), "direct ingest": feed_rate(direct, batch)}
        host = max((r["wps"] for r in loader_rows if r["batch"] == 500), default=float("nan"))
        print(f"[device-aug-feed] {name_power} | {os.cpu_count()} CPUs | b{batch} step-mode host "
              f"feed, one thread: RawStore gather {feed['RawStore']:.1f} waveforms/s, float32 "
              f"pack direct ingest {feed['direct ingest']:.1f}; the device-aug step consumes "
              f"{batch * 1e3 / times[(batch, 'step')]['ms']:.1f}, the host-fed step "
              f"{batch * 1e3 / step_ms[batch]:.1f}; best host Loader (phase 8, b500) "
              f"{host:.1f}", flush=True)
    for mode, wps in entry["wps"].items():
        print(f"[device-aug-entry] {name_power} | train entry, --device-aug {mode}, "
              f"{LOADER_EVENTS}-event float32 pack, b{TRAIN_BATCH}, epoch 1 (warm): {wps:.1f} "
              f"waveforms/s over the train loop", flush=True)
    print(f"[device-aug] phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"k3": k3, "counts": entry["counts"]}


# ------------------------------------------------------------- phase 12
GROUP = "seist_l"
GROUP_TASKS = ("dpk", "emg", "dis")
SERVE_VARIANTS = ("fp32", "bf16", "int8")
SERVE_BUCKETS = (1, 2, 4, 8)
# A replayed program against the same function run eagerly on the card, per
# output, relative to max(1, max|eager|): phase 5's limit (the distance head
# answers in the hundreds, where one fp32 ulp is 3e-5).
REPLAY_TOL = PROB_TOL


@torch.no_grad()
def group_weights(dpk_weights: str, out_dir: str) -> Dict[str, str]:
    """Weights of the group's tasks: dpk's file, and for each other task
    dpk's trunk with a head drawn as :func:`seeded_weights` draws, so the
    group (trunk of its first task) computes what each single-task model
    computes."""
    trunk = torch.load(dpk_weights, weights_only=True)
    paths = {"dpk": dpk_weights}
    for i, task in enumerate(GROUP_TASKS[1:], start=1):
        model = api.create_model(f"{GROUP}_{task}", in_samples=WINDOW, seed=SEED)
        g = torch.Generator().manual_seed(SEED + i)
        state = model.state_dict()
        for name, t in state.items():
            if not name.startswith("out_head."):
                t.copy_(trunk[name])
            elif t.ndim >= 2:
                t.copy_(torch.randn(t.shape, generator=g) * (0.5 / math.sqrt(t[0].numel())))
            elif name.endswith(("running_var", ".weight")):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        paths[task] = os.path.join(out_dir, f"{GROUP}_{task}_seed{SEED}.pt")
        torch.save(state, paths[task])
    return paths


def rel_err(got, want) -> float:
    return max(max_err(a, b) / max(1.0, float(b.float().abs().max()))
               for a, b in zip(_flat(got), _flat(want)))


def picks_agree(a: dict, b: dict, probs: np.ndarray, tol: float) -> Tuple[bool, int]:
    """A variant's picks ``b`` against fp32's ``a`` at the decision level of
    the parity gate: the same count of each kind, and each pick within
    PICK_TOL_S of fp32's, or moved between two samples whose fp32
    probabilities (``probs`` (L, 3): det, ppk, spk) differ by at most the
    variant's gate tolerance ``tol`` (a near-tie). Returns (agree, near-ties)."""
    tol_samples = PICK_TOL_S * 50
    ties = 0
    pairs = []
    for kind, ch in (("ppk", 1), ("spk", 2)):
        sa = sorted(p["sample"] for p in a[kind])
        sb = sorted(p["sample"] for p in b[kind])
        if len(sa) != len(sb):
            return False, ties
        pairs += [(x, y, ch) for x, y in zip(sa, sb)]
    da = sorted((d["onset"], d["offset"]) for d in a["det"])
    db = sorted((d["onset"], d["offset"]) for d in b["det"])
    if len(da) != len(db):
        return False, ties
    pairs += [(x[j], y[j], 0) for x, y in zip(da, db) for j in (0, 1)]
    for x, y, ch in pairs:
        if abs(x - y) <= tol_samples:
            continue
        if abs(float(probs[x, ch]) - float(probs[y, ch])) > tol:
            return False, ties
        ties += 1
    return True, ties


def program_calls(service) -> Dict[str, int]:
    return {p.key: p.calls for e in service.entries.values() for p in e.all_programs()}


SEGMENTS = ("parse", "normalize", "queue_wait", "forward", "decode")
# Server-Timing prints each duration rounded to 0.1 ms: the five segments'
# sum may exceed the rounded total by half a unit per number.
TIMING_ROUND_MS = 0.05 * (len(SEGMENTS) + 1)


def post_timed(url: str, body: dict) -> Tuple[int, dict, Dict[str, str]]:
    """``post`` that also returns the response's headers."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode(errors="replace")}, dict(e.headers)


def server_timing(header: str) -> Dict[str, float]:
    """``Server-Timing: total;dur=1.0, parse;dur=0.2, ...`` -> {name: ms}."""
    out = {}
    for part in header.split(", "):
        name, _, dur = part.partition(";dur=")
        out[name] = float(dur)
    return out


def storm(url: str, bodies: List[dict]) -> Tuple[List[Tuple[int, dict]], float, float, dict]:
    """The bodies as concurrent /predict requests: the responses, the
    client p50 and p99 in ms, and each response's Server-Timing segments
    (``timing``: {segment: [ms]}, with ``outside`` the client's latency
    minus the server's total and ``unspanned`` the total minus its
    segments; ``trace_ids``)."""
    results: List[Tuple[int, dict, float]] = [None] * len(bodies)
    headers: List[Dict[str, str]] = [None] * len(bodies)

    def one(i: int) -> None:
        t0 = time.perf_counter()
        status, body, headers[i] = post_timed(url + "/predict", bodies[i])
        results[i] = (status, body, (time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(r is None for r in results):
        fail("a /predict request did not finish")
    for status, body, _ in results:
        if status != 200:
            fail(f"bad /predict response: {status} {str(body)[:300]}")
    timing: Dict[str, List[float]] = {k: [] for k in ("total",) + SEGMENTS
                                      + ("outside", "unspanned")}
    trace_ids = []
    for (_, _, client_ms), h in zip(results, headers):
        seg = server_timing(h.get("Server-Timing", ""))
        if not set(SEGMENTS) <= set(seg) or "total" not in seg:
            fail(f"a /predict response lacks Server-Timing segments: {h.get('Server-Timing')}")
        spanned = sum(seg[k] for k in SEGMENTS)
        if spanned > seg["total"] + TIMING_ROUND_MS:
            fail(f"Server-Timing segments sum to {spanned} ms > total {seg['total']} ms")
        for k in ("total",) + SEGMENTS:
            timing[k].append(seg[k])
        timing["outside"].append(client_ms - seg["total"])
        timing["unspanned"].append(seg["total"] - spanned)
        trace_ids.append(obs_trace.parse_traceparent(h.get("traceparent"))[0])
    timing["trace_ids"] = trace_ids
    lat = np.array([r[2] for r in results])
    return ([(r[0], r[1]) for r in results], float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)), timing)


def check_programs(service, n_shapes: int) -> None:
    """Every program's replay against its function run eagerly on the card,
    on the capture's own kind of input; and the attention launches each
    replay adds (per forward: n_shapes fp32 K1, of them bf16 in bf16)."""
    rng = np.random.default_rng(SEED + 1)
    worst: Dict[str, float] = {}
    apart: Dict[str, float] = {}
    for name, entry in service.entries.items():
        for prog in entry.all_programs():
            variant = prog.key.rsplit("/", 1)[1]
            b = int(prog.key.rsplit("/", 2)[1][1:])
            kind = prog.key.split("/")[1]
            x = torch.from_numpy(rng.standard_normal((b, WINDOW, 3)).astype(np.float32)).cuda()
            with torch.inference_mode():
                if kind.startswith("head:"):
                    feats = entry.programs[(variant, "trunk", b)](x)
                    inputs = [feats.clone()]
                else:
                    inputs = [x]
                got = prog(*inputs)
                got = [t.clone() for t in _flat(got)]
                want = prog.fn(*inputs)
            err = rel_err(got, want)
            worst[variant] = max(worst.get(variant, 0.0), err)
            g0, w0 = _flat(got)[0], _flat(want)[0]
            if b >= 2 and g0.dim() >= 3:  # waveform or trunk outputs: rows told apart
                scale = max(1.0, float(w0.float().abs().max()))
                _, sep = check_separated(f"{prog.key}: replay vs eager", g0.float().cpu().numpy(),
                                         w0.float().cpu().numpy(), tol=REPLAY_TOL * scale)
                apart[variant] = min(apart.get(variant, math.inf), sep)
            want_k1 = (0, 0) if kind.startswith("head:") else (
                n_shapes, n_shapes if variant == "bf16" else 0)
            if prog.launches != want_k1:
                fail(f"{prog.key}: K1 launches per replay {prog.launches} != {want_k1}")
            if not err <= REPLAY_TOL:
                fail(f"{prog.key}: replay vs eager {err:.3e} > {REPLAY_TOL:.0e}")
    print(f"[programs] every program's replay against its eager run on the card (max error "
          f"relative to max(1, |eager|), limit {REPLAY_TOL:.0e}): "
          f"{', '.join(f'{v} {e:.3e}' for v, e in worst.items())}; rows of the waveform and "
          f"trunk programs at buckets 2-8 at least "
          f"{', '.join(f'{v} {e:.3e}' for v, e in apart.items())} apart (limit "
          f"{SEPARATION:.0e})", flush=True)


def programs_phase(name_power: str, weights: str, n_shapes: int) -> dict:
    """Phase 12 (module docstring)."""
    paths = group_weights(weights, os.path.dirname(weights))
    argv = ["--model", f"{MODEL}={weights}", "--model-group",
            GROUP + "=" + ",".join(f"{t}:{paths[t]}" for t in GROUP_TASKS),
            "--variants", ",".join(SERVE_VARIANTS), "--window", str(WINDOW),
            "--max-batch", str(BATCH), "--max-delay-ms", "20", "--device", "cuda",
            "--shed-batch-delay-ms", "inf", "--shed-interactive-delay-ms", "inf"]
    real_plain = pa.pooled_attention_plain

    def plain_off_path(*a, **k):
        raise AssertionError("pooled_attention_plain reached on the served path")

    pa.pooled_attention_plain = plain_off_path
    mem0 = allocated_gib()
    logger_mod.set_logdir(os.path.join(str(_kernels.BUILD_DIR), "serve_logs"))
    events = srv.start_telemetry()  # serve's flight recorder, trace collector, events
    service = srv.service_from_args(srv.get_serve_args(argv))
    server = srv.start_http_server(service, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    stats = service.pool.program_stats
    print(f"[programs] {name_power} | serve {' '.join(argv)}: ready in {service.ready_s:.2f} s; "
          + "; ".join(f"{n}: {int(st['graph_programs'])} programs, capture "
                      f"{st['graph_capture_s']:.2f} s, graph pools and variant weights "
                      f"{st['graph_memory_mib']:.1f} MiB" for n, st in stats.items())
          + f"; allocated {allocated_gib() - mem0:.3f} GiB more than before", flush=True)
    for r in service.pool.warmup_report:
        print(f"[programs]   {r['program']}: {r['seconds']:.3f} s, {r['flops']:.6g} flops, K1 "
              f"launches per call {r['k1_launches_per_call']}", flush=True)
    single, group = service.entries[MODEL], service.entries[GROUP]
    print(f"[programs] parity gates: {MODEL} {single.variant_ok} (errors {single.parity_err}); "
          f"{GROUP} {group.variant_tasks} (errors {group.parity_err})", flush=True)
    if not all(single.variant_ok.get(v) for v in SERVE_VARIANTS[1:]):
        fail(f"a variant of {MODEL} failed its parity gate: {single.variant_ok}")
    if any(set(group.variant_tasks.get(v, ())) != set(GROUP_TASKS) for v in SERVE_VARIANTS):
        fail(f"a variant of {GROUP} failed its parity gate: {group.variant_tasks}")
    check_programs(service, n_shapes)

    # The main path: /predict x24 per variant and for the group, counted.
    data = traces(N_REQUESTS)
    opts = {"max_events": 1}
    calls0 = program_calls(service)
    fallback0 = service.metrics()["fallback_runs"]
    pa.launches = pa.bf16_launches = 0
    runs = {}
    for variant in SERVE_VARIANTS:
        runs[variant] = storm(url, [{"model": MODEL, "data": data[i].tolist(),
                                     "options": dict(opts, variant=variant)}
                                    for i in range(N_REQUESTS)])
    runs["group"] = storm(url, [{"model": GROUP, "data": data[i].tolist(), "options": opts}
                                for i in range(N_REQUESTS)])
    counts = {"K1": pa.launches, "K1_bf16": pa.bf16_launches}
    metrics = service.metrics()
    calls = {k: c - calls0[k] for k, c in program_calls(service).items()}
    progs = {p.key: p for e in service.entries.values() for p in e.all_programs()}
    want = {"K1": sum(calls[k] * progs[k].launches[0] for k in calls),
            "K1_bf16": sum(calls[k] * progs[k].launches[1] for k in calls)}
    print(f"[programs] main path: K1 {counts['K1']} launches (bf16 {counts['K1_bf16']}), "
          f"replays x captured launches {want}; program calls "
          f"{ {k: c for k, c in calls.items() if c} }; fallback runs "
          f"{metrics['fallback_runs'] - fallback0}; /metrics kernels {metrics['kernels']}",
          flush=True)
    if counts != want or counts["K1_bf16"] < 1 or counts["K1"] <= counts["K1_bf16"]:
        fail(f"served K1 launches {counts} != the replays' {want}, or a type never launched")
    if metrics["fallback_runs"] != fallback0:
        fail("a served request ran without a program")
    ref = runs["fp32"][0]
    ties = {}
    for variant in SERVE_VARIANTS[1:]:
        ties[variant] = 0
        for i, ((_, a), (_, b)) in enumerate(zip(ref, runs[variant][0])):
            x = normalize(data[i].T, "std", axis=0).astype(np.float32)[None]
            probs = single.run(x, "fp32")[0].cpu().numpy()
            agree, n_ties = picks_agree(a, b, probs, aot._PARITY_TOL[variant]["abs"])
            ties[variant] += n_ties
            if not agree:
                fail(f"{variant} picks of trace {i} differ from fp32's: {b} vs {a}")
    for i, ((_, a), (_, g)) in enumerate(zip(ref, runs["group"][0])):
        if g["trunk_runs"] != 1 or sorted(g["tasks"]) != sorted(GROUP_TASKS):
            fail(f"group response {i}: {str(g)[:300]}")
        if not picks_close(g["tasks"]["dpk"], a, PICK_TOL_S * 50):
            fail(f"group dpk picks of trace {i} differ from {MODEL}'s")
    n_picks = sum(len(a[k]) for _, a in ref for k in ("ppk", "spk", "det"))
    for name, (_, p50, p99, timing) in runs.items():
        print(f"[time] {name_power} | /predict x{N_REQUESTS} concurrent, "
              f"{MODEL if name != 'group' else GROUP + ' (' + ','.join(GROUP_TASKS) + ')'} "
              f"{name if name != 'group' else 'fp32'}: client p50 {p50:.1f} ms p99 {p99:.1f} ms",
              flush=True)
        print(f"[trace] {name_power} | /predict x{N_REQUESTS} {name}: Server-Timing p50/p99 ms "
              + ", ".join(f"{k} {np.percentile(timing[k], 50):.1f}/"
                          f"{np.percentile(timing[k], 99):.1f}"
                          for k in ("total",) + SEGMENTS)
              + f"; client minus total {np.percentile(timing['outside'], 50):.1f}/"
              f"{np.percentile(timing['outside'], 99):.1f}; total minus segments "
              f"{np.percentile(timing['unspanned'], 50):.1f}/"
              f"{np.percentile(timing['unspanned'], 99):.1f}", flush=True)
    telemetry_checks(url, runs, name_power)
    host_stages(single, data, name_power)
    print(f"[programs] bf16 and int8 picks: the same count as fp32's ({n_picks} over "
          f"{N_REQUESTS} traces), each within {PICK_TOL_S} s of fp32's or on a near-tie "
          f"(fp32 probabilities at the two samples within the variant's gate tolerance): "
          f"near-ties {ties}; fan-out {metrics['fanout']}", flush=True)

    # The group's heads against the single-task models on the card.
    x = np.stack([normalize(d.T, "std", axis=0) for d in data[:BATCH]]).astype(np.float32)
    outs = group.fanout(x, GROUP_TASKS, "fp32", account=False)
    for task in GROUP_TASKS:
        one = single if task == "dpk" else load_model_entry(
            f"{GROUP}_{task}", paths[task], window=WINDOW, device="cuda")
        want_t = one.run(x)
        err = rel_err(outs[task], want_t)
        sep = (check_separated(f"{GROUP} head dpk vs {MODEL}", outs[task].float().cpu().numpy(),
                               want_t.float().cpu().numpy(), tol=REPLAY_TOL)[1]
               if task == "dpk" else None)
        print(f"[programs] {GROUP} head {task} (replayed) vs {GROUP}_{task} "
              f"({'replayed' if task == 'dpk' else 'eager'}): {err:.3e}"
              + (f"; the {BATCH} traces' outputs at least {sep:.3e} apart" if sep else ""),
              flush=True)
        if not err <= REPLAY_TOL:
            fail(f"group head {task} differs from {GROUP}_{task} by {err:.3e}")
        del one

    # Replayed against eager forwards, per variant at the largest bucket.
    rows = []
    for variant in SERVE_VARIANTS:
        for b in (SERVE_BUCKETS[-1],):
            xb = torch.from_numpy(np.random.default_rng(b).standard_normal(
                (b, WINDOW, 3)).astype(np.float32)).cuda()
            prog = single.programs[variant][b]
            with torch.inference_mode():
                replay = attribution.measured_kernels(lambda: prog(xb), iters=5)
                eager = attribution.measured_kernels(lambda: prog.fn(xb), iters=5)
            rows.append((variant, b, replay, eager))
            print(f"[time] {name_power} | {MODEL} window {WINDOW} b{b} {variant} forward: "
                  f"replayed wall {replay['wall_ms']:.3f} ms, device busy "
                  f"{replay['busy_ms']:.3f} ms, idle share {replay['idle_share']:.3f}, "
                  f"{replay['kernels']:.0f} kernels; eager wall {eager['wall_ms']:.3f} ms, "
                  f"device busy {eager['busy_ms']:.3f} ms, idle share "
                  f"{eager['idle_share']:.3f}, {eager['kernels']:.0f} kernels", flush=True)

    # Reload: one that swaps (new weights, version 2), one refused (NaN).
    status, body = post(url + "/admin/reload", {"model": MODEL, "checkpoint": paths["dpk"]})
    if status != 200 or body.get("version") != 2:
        fail(f"reload refused: {status} {body}")
    status2, one_resp = post(url + "/predict", {"model": MODEL, "data": data[0].tolist(),
                                                "options": opts})
    nan_path = os.path.join(os.path.dirname(weights), f"{MODEL}_nan.pt")
    torch.save({k: torch.full_like(v, float("nan")) for k, v in
                torch.load(weights, weights_only=True).items()}, nan_path)
    status3, refused = post(url + "/admin/reload", {"model": MODEL, "checkpoint": nan_path})
    refused = json.loads(refused["error"]) if status3 != 200 else refused
    status4, after = post(url + "/predict", {"model": MODEL, "data": data[0].tolist(),
                                             "options": opts})
    print(f"[programs] {name_power} | reload {MODEL} -> version {body['version']}: "
          f"{body['reload_s']:.2f} s for {body['programs']} programs, then /predict "
          f"model_version {one_resp.get('model_version')}; reload of NaN weights: {status3} "
          f"{refused.get('error')} ({str(refused.get('message'))[:160]}); then /predict "
          f"{status4} model_version {after.get('model_version')}", flush=True)
    if (status2 != 200 or one_resp.get("model_version") != 2 or status3 != 409
            or status4 != 200 or after.get("model_version") != 2):
        fail("the reloads did not swap and refuse as they should")
    server.shutdown()
    service.shutdown()
    events.close()
    pa.pooled_attention_plain = real_plain
    flops_check(service, weights)  # the CPU count runs the plain attention
    counts.update(K2=0, K3=0, K2_bf16=0)
    return {"counts": counts, "rows": rows, "runs": {k: v[1:] for k, v in runs.items()},
            "ready_s": service.ready_s, "reload_s": body["reload_s"]}


def telemetry_checks(url: str, runs: dict, name_power: str) -> None:
    """After phase 12's storms: one request's trace from ``/traces/<id>``
    (its spans, the forward's replayed program), the bus snapshot from
    ``/metrics.json`` (one trunk run per group flush) and the Prometheus
    text, every line of which parses."""
    tid = runs["group"][3]["trace_ids"][0]
    with urllib.request.urlopen(f"{url}/traces/{tid}", timeout=30) as r:
        trace = json.loads(r.read())
    spans = {x["name"]: x for x in trace["spans"]}
    fwd = spans.get("forward", {}).get("annotations", {})
    print(f"[trace] /traces/{tid}: spans {sorted(spans)}; forward {fwd}", flush=True)
    if not set(SEGMENTS) <= set(spans) or fwd.get("aot") is not True or not str(
            fwd.get("program", "")).startswith(f"{GROUP}/trunk/b"):
        fail("the group request's trace lacks its spans or a replayed trunk program")
    with urllib.request.urlopen(url + "/metrics.json", timeout=30) as r:
        snap = json.loads(r.read())
    trunk = snap["counters"].get(f"serve_trunk_runs{{model={GROUP}}}", 0.0)
    flushes = snap["collectors"].get(f"serve_batcher_forwards{{model={GROUP}}}", -1.0)
    print(f"[trace] /metrics.json: {len(snap['counters'])} counters, {len(snap['gauges'])} "
          f"gauges, {len(snap['histograms'])} histograms, {len(snap['collectors'])} collector "
          f"samples; {GROUP} trunk runs {trunk} over {flushes} flushes; serve_aot_programs "
          f"{ {k: v for k, v in snap['gauges'].items() if k.startswith('serve_aot_programs')} }",
          flush=True)
    if trunk != flushes or trunk < 1:
        fail(f"the group's trunk ran {trunk} times over {flushes} flushes")
    with urllib.request.urlopen(url + "/metrics?format=prometheus", timeout=30) as r:
        text = r.read().decode()
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [-+0-9.eEinfINFa]+$')
    bad = [x for x in text.splitlines() if not (x.startswith("# TYPE ") or sample.match(x))]
    print(f"[trace] /metrics?format=prometheus: {len(text.splitlines())} lines, "
          f"{len(bad)} that do not parse", flush=True)
    if bad or "seist_serve_trunk_runs_total" not in text:
        fail(f"Prometheus text lines do not parse: {bad[:3]}")


def host_stages(entry, data: np.ndarray, name_power: str) -> None:
    """The host's stages of one ``/predict``, each alone on one thread (ms,
    median over the traces), beside the storm's spans, which are wall
    time on 24 handler threads sharing one interpreter with their
    clients: the request body's JSON encode and decode, ``parse``,
    ``normalize``, and ``decode`` of the row on the host (as served) and on
    the card (where the outputs were before the batcher's copy)."""
    from seist_tpu_torch.serve.batcher import slice_outputs, to_host
    from seist_tpu_torch.serve.protocol import parse_waveform

    opts = PredictOptions.from_dict({"max_events": 1})
    ms: Dict[str, List[float]] = {k: [] for k in ("json_encode", "json_decode", "parse",
                                                  "normalize", "decode_host", "decode_card")}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        ms[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for d in data:
        body = timed("json_encode", lambda: json.dumps({"data": d.tolist()}))
        lists = timed("json_decode", lambda: json.loads(body))["data"]
        x = timed("parse", lambda: parse_waveform(lists, entry.in_channels))
        x = timed("normalize", lambda: np.asarray(normalize(x, "std", axis=0), np.float32))
        out = entry.run(x[None], "fp32")
        torch.cuda.synchronize()
        host = to_host(out)
        timed("decode_host", lambda: decode_outputs(entry, slice_outputs(host, 0), opts))
        timed("decode_card", lambda: decode_outputs(entry, slice_outputs(out, 0), opts))
    print(f"[trace] {name_power} | /predict's host stages alone, one thread, median ms over "
          f"{len(data)} traces: " + ", ".join(f"{k} {np.median(v):.2f}" for k, v in ms.items()),
          flush=True)


def flops_check(service, weights: str) -> None:
    """The FLOPs the served fp32 b1 program of seist_l_dpk publishes
    (``/metrics``' warm-up table) against the count the port makes for the
    same entry on the CPU, where the plain attention is counted instead of
    K1."""
    row = next(r for r in service.metrics()["warmup"]
               if r["program"] == f"{MODEL}/full/b1/fp32")
    cpu = load_model_entry(MODEL, weights, window=WINDOW, device="cpu")
    x = torch.zeros(1, WINDOW, 3)
    with torch.inference_mode():
        want = attribution.matmul_flops(cpu._fn("fp32"), [x])
    print(f"[programs] {MODEL}/full/b1/fp32 FLOPs on the card {row['flops']:.9g}, on the CPU "
          f"{want:.9g}", flush=True)
    if abs(row["flops"] - want) > 1e-9 * want or want <= 0:
        fail("the served program's FLOPs differ from the CPU's count")


# ------------------------------------------------------------- phase 13
RECORD = 30000  # a 10-minute record at 50 Hz
HOUR = 180000
STATIONS = 16
PACKET = 500  # 10 s
STREAM_CLIENTS = 8
RESTART_STATIONS = 4
FLOOD_CLIENTS = 4
# /stream against /annotate of the same record, and the card's /annotate
# against the CPU's (tools/stream_smoke.py): the two run the windows in
# batches of other sizes, so a pick whose peak sits within rounding of the
# threshold may show on one side only. At most a tenth of the union (at
# least one) may be stranded, and matched picks lie within 2 samples.
MATCH_SAMPLES = 2
STRAND_SHARE = 0.1
# The weights are not trained: their curves are no calibrated
# probabilities, and at the default thresholds every local maximum could be
# a candidate and /annotate's pick capacity bind. The thresholds sit at this
# quantile of the CPU reference's stitched curve instead, so a record has a
# few dozen samples above them; the capacity (RECORD_EVENTS) then never
# binds, which the phase checks.
PICK_QUANTILE = 0.999
RECORD_EVENTS = 256


def long_record(seed: int, n: Optional[int] = None) -> np.ndarray:
    """Seeded noise with four P/S-like burst pairs, (n, 3) (n: RECORD)."""
    n = n or RECORD
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    t = np.arange(n)
    seg = n // 4
    for k in range(4):
        p = k * seg + int(rng.integers(seg // 10, seg // 2))
        for onset, amp in ((p, 6.0), (p + int(rng.integers(300, 1500)), 10.0)):
            env = np.where(t >= onset, np.exp(-np.maximum(t - onset, 0) / 200.0), 0.0)[:, None]
            x += (amp * env * rng.standard_normal((n, 3))).astype(np.float32)
    return x


def matched(a: List[int], b: List[int], tol: int = MATCH_SAMPLES) -> int:
    """Greedy one-to-one matching of two pick lists within ``tol`` samples."""
    n = i = j = 0
    a, b = sorted(a), sorted(b)
    while i < len(a) and j < len(b):
        if abs(a[i] - b[j]) <= tol:
            n, i, j = n + 1, i + 1, j + 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return n


def picks_match(a: Dict[str, List[int]], b: Dict[str, List[int]]) -> Tuple[bool, str]:
    """P and S picks of two runs within the stream-smoke tolerance."""
    ok, notes = True, []
    for kind in ("ppk", "spk"):
        m = matched(a[kind], b[kind])
        union = len(a[kind]) + len(b[kind]) - m
        stranded = union - m
        ok = ok and (union == 0 or stranded <= max(1, int(STRAND_SHARE * union)))
        notes.append(f"{kind} {len(a[kind])}/{len(b[kind])} matched {m}")
    return ok, ", ".join(notes)


def sample_picks(body: dict) -> Dict[str, List[int]]:
    return {k: [p["sample"] for p in body[k]] for k in ("ppk", "spk")}


def cpu_annotate(entry, rec: np.ndarray) -> Tuple[np.ndarray, Dict[str, List[int]], dict]:
    """The port's CPU run of ``rec`` through ``entry`` (one forward per
    batch), the pick thresholds at PICK_QUANTILE of its stitched curve, and
    its picks at them: (curve, picks, options)."""
    outs = []

    def forward(x):
        outs.append(entry.run(x))
        return outs[-1]

    kw = dict(window=WINDOW, batch_size=BATCH, channel0=entry.channel0, combine="max",
              max_events=RECORD_EVENTS)
    prob = stream_ops.annotate(forward, rec, **kw)["prob"]
    det = prob[:, 0] if entry.channel0 == "det" else 1.0 - prob[:, 0]
    opts = {"ppk_threshold": float(np.quantile(prob[:, 1], PICK_QUANTILE)),
            "spk_threshold": float(np.quantile(prob[:, 2], PICK_QUANTILE)),
            "det_threshold": float(np.quantile(det, PICK_QUANTILE)),
            "combine": "max", "record_max_events": RECORD_EVENTS, "timeout_ms": 60000}
    replay = iter(outs)
    got = stream_ops.annotate(lambda x: next(replay), rec, **dict(
        kw, ppk_threshold=opts["ppk_threshold"], spk_threshold=opts["spk_threshold"],
        det_threshold=opts["det_threshold"]))
    picks = {k: got[k].tolist() for k in ("ppk", "spk")}
    return prob, picks, opts


def stream_station(url: str, station: dict, rec: np.ndarray, opts: dict, seqs: range,
                   end: bool, lat_ms: List[float], statuses: List[int]) -> dict:
    """POST a station's packets (seq numbers ``seqs``, 1-based packet
    indices into ``rec``) and, with ``end``, the closing packet; returns
    the merged picks, the windows and the responses' flags."""
    out = {"ppk": [], "spk": [], "windows": 0, "degraded": False, "closed": False}
    bodies = [{"model": MODEL, "station": station, "seq": s, "options": opts,
               "data": rec[(s - 1) * PACKET : s * PACKET].tolist()} for s in seqs]
    if end:
        bodies.append({"model": MODEL, "station": station, "seq": seqs.stop, "end": True,
                       "options": opts})
    for body in bodies:
        t0 = time.perf_counter()
        status, r = post(url + "/stream", body)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        statuses.append(status)
        if status != 200:
            fail(f"/stream {station['id']} seq {body['seq']}: {status} {str(r)[:300]}")
        for k in ("ppk", "spk"):
            out[k] += [p["sample"] for p in r[k]]
        out["windows"] += r["windows"]
        out["degraded"] |= r["degraded"]
        out["closed"] = r["closed"]
    return out


def run_clients(jobs: List, n_threads: int) -> List:
    """``jobs`` (callables) on ``n_threads`` client threads, each taking
    every n-th job in turn; returns their results in job order."""
    results: List = [None] * len(jobs)
    errors: List[BaseException] = []

    def client(k: int) -> None:
        try:
            for i in range(k, len(jobs), n_threads):
                results[i] = jobs[i]()
        except BaseException as e:  # noqa: BLE001 — re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        fail(f"a client failed: {errors[:1]}")
    return results


def streams_phase(name_power: str, weights: str) -> dict:
    """Phase 13 (module docstring)."""
    t_phase = time.perf_counter()
    paths = group_weights(weights, os.path.dirname(weights))
    pn_weights = os.path.join(str(_kernels.BUILD_DIR), f"phasenet_seed{SEED}.pt")
    torch.save(api.create_model("phasenet", in_samples=WINDOW, seed=SEED).state_dict(),
               pn_weights)
    # The port's CPU references, before the plain attention is patched out
    # (the CPU runs it). The group's trunk and dpk head are seist_l_dpk's
    # weights, so seist_l_dpk's reference is the group's too.
    rec = long_record(SEED)
    t0 = time.perf_counter()
    cpu = {MODEL: load_model_entry(MODEL, weights, window=WINDOW, device="cpu"),
           "phasenet": load_model_entry("phasenet", pn_weights, window=WINDOW, device="cpu")}
    refs = {name: cpu_annotate(e, rec) for name, e in cpu.items()}
    refs[GROUP] = refs[MODEL]
    del cpu
    cpu_s = time.perf_counter() - t0
    opts = refs[MODEL][2]
    journal = os.path.join(str(_kernels.BUILD_DIR), "stream_journal")
    shutil.rmtree(journal, ignore_errors=True)
    common = ["--window", str(WINDOW), "--max-batch", str(BATCH), "--max-delay-ms", "20",
              "--device", "cuda", "--shed-batch-delay-ms", "1", "--stream-journal-dir", journal,
              "--stream-journal-every-s", "5", "--assoc-min-stations", "4"]
    argv = (["--model", f"{MODEL}={weights}", "--model", f"phasenet={pn_weights}",
             "--model-group", GROUP + "=" + ",".join(f"{t}:{paths[t]}" for t in GROUP_TASKS)]
            + common)
    real_plain = pa.pooled_attention_plain

    def plain_off_path(*a, **k):
        raise AssertionError("pooled_attention_plain reached on the served path")

    pa.pooled_attention_plain = plain_off_path
    service = srv.service_from_args(srv.get_serve_args(argv))
    server = srv.start_http_server(service, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    services = [service]
    # The main path of the phase, counted: every request below.
    calls0 = program_calls(service)
    pa.launches = pa.bf16_launches = 0

    with urllib.request.urlopen(url + "/healthz/live", timeout=30) as r:
        live = (r.status, json.loads(r.read()))
    with urllib.request.urlopen(url + "/healthz/ready", timeout=30) as r:
        ready = (r.status, json.loads(r.read()))
    print(f"[streams] {name_power} | serve {' '.join(argv)}: ready in {service.ready_s:.2f} s; "
          f"/healthz/live {live}; /healthz/ready {ready}; CPU references {cpu_s:.1f} s; "
          f"thresholds at the {PICK_QUANTILE} quantile of the CPU curve: ppk "
          f"{opts['ppk_threshold']:.6f}, spk {opts['spk_threshold']:.6f}, det "
          f"{opts['det_threshold']:.6f}", flush=True)
    if live[0] != 200 or ready[0] != 200 or set(ready[1].get("versions", {})) != {
            MODEL, "phasenet", GROUP}:
        fail("the health routes do not answer ready with every model's version")

    # /annotate of the 10-minute record: each model over HTTP, and the
    # card's stitched curve against the CPU's.
    rows = {}
    for name in (MODEL, GROUP, "phasenet"):
        prob_cpu, picks_cpu, o = refs[name]
        t0 = time.perf_counter()
        status, body = post(url + "/annotate", {"model": name, "data": rec.tolist(),
                                                 "options": o})
        wall = (time.perf_counter() - t0) * 1e3
        if status != 200:
            fail(f"/annotate {name}: {status} {str(body)[:300]}")
        entry = service.entries[name]
        forward = entry.picker_forward if entry.is_group else (lambda x, e=entry: e.run(x))
        prob = stream_ops.annotate(forward, rec, window=WINDOW, batch_size=BATCH,
                                   channel0=entry.channel0, combine="max",
                                   max_events=RECORD_EVENTS)["prob"]
        # The curve in stretches of a stride: each against the CPU's, and at
        # least SEPARATION from every other stretch's, so a window fed
        # another window's samples fails.
        seg = WINDOW // 2
        n_seg = RECORD // seg
        err, sep = check_separated(f"/annotate {name}, {n_seg} stretches of {seg} samples",
                                   prob[:n_seg * seg].reshape(n_seg, seg, -1),
                                   prob_cpu[:n_seg * seg].reshape(n_seg, seg, -1))
        err = max(err, float(np.abs(prob - prob_cpu).max()))
        ok, notes = picks_match(sample_picks(body), picks_cpu)
        rows[name] = (wall, body["windows"])
        print(f"[streams] {name_power} | /annotate {name}, {RECORD} samples, {body['windows']} "
              f"windows: wall {wall:.1f} ms, {body['windows'] / wall * 1e3:.1f} windows/s; card "
              f"curve vs CPU max_abs_err {err:.3e} (limit {PROB_TOL:.0e}), its {n_seg} stretches "
              f"of {seg} samples at least {sep:.3e} apart (limit {SEPARATION:.0e}); picks vs "
              f"CPU: {notes}", flush=True)
        if not err <= PROB_TOL or not ok:
            fail(f"/annotate {name} on the card differs from the CPU run")
        if max(len(v) for v in picks_cpu.values()) >= RECORD_EVENTS or not picks_cpu["ppk"]:
            fail(f"/annotate {name}: no picks, or the pick capacity binds")
    hour = long_record(SEED + 1, HOUR)
    t0 = time.perf_counter()
    status, body = post(url + "/annotate", {"model": MODEL, "data": hour.tolist(),
                                             "options": opts})
    wall = (time.perf_counter() - t0) * 1e3
    if status != 200:
        fail(f"/annotate of the 1-hour record: {status} {str(body)[:300]}")
    print(f"[streams] {name_power} | /annotate {MODEL}, 1 hour ({HOUR} samples, "
          f"{body['windows']} windows): wall {wall:.1f} ms, {body['windows'] / wall * 1e3:.1f} "
          f"windows/s", flush=True)

    # /stream: 16 stations on 8 clients, a batch-tier /predict flood beside.
    recs = [long_record(SEED + 10 + i) for i in range(STATIONS)]
    offline = run_clients([lambda i=i: post(url + "/annotate", {
        "model": MODEL, "data": recs[i].tolist(), "options": opts}) for i in range(STATIONS)],
        STREAM_CLIENTS)
    if any(s != 200 for s, _ in offline):
        fail("an /annotate of a station's record failed")
    geometry = [{"id": f"ST{i:02d}", "network": "XX", "lat": 35.0 + 0.05 * (i % 4),
                 "lon": -117.0 + 0.05 * (i // 4)} for i in range(STATIONS)]
    lat_ms: List[float] = []
    statuses: List[int] = []
    n_packets = RECORD // PACKET
    done = threading.Event()
    flood_traces = traces(FLOOD_CLIENTS)
    flood: List[Tuple[int, dict, Dict[str, str]]] = []

    def flooder(k: int) -> None:
        # A well-behaved batch client: it waits out a shed's Retry-After.
        while not done.is_set():
            flood.append(post_timed(url + "/predict", {
                "model": MODEL, "data": flood_traces[k].tolist(),
                "options": {"priority": "batch", "max_events": 1}}))
            done.wait(float(flood[-1][2].get("Retry-After", 0)))

    floods = [threading.Thread(target=flooder, args=(k,)) for k in range(FLOOD_CLIENTS)]
    for t in floods:
        t.start()
    t0 = time.perf_counter()
    # Two stations per client, their packets interleaved.
    streamed = run_clients([lambda i=i: stream_station(
        url, geometry[i], recs[i], opts, range(1, n_packets + 1), True, lat_ms, statuses)
        for i in range(STATIONS)], STREAM_CLIENTS)
    stream_s = time.perf_counter() - t0
    done.set()
    for t in floods:
        t.join(timeout=300)
    metrics = service.metrics()
    mux = metrics["stream"][MODEL]
    shed = metrics["shed"][MODEL]["tiers"]
    win_ms = BUS.histogram("stream_window_latency_ms", model=MODEL).summary()
    bad = []
    for i, (s, (status, body)) in enumerate(zip(streamed, offline)):
        ok, notes = picks_match(s, sample_picks(body))
        if not ok or s["windows"] != body["windows"] or s["degraded"] or not s["closed"]:
            bad.append(f"ST{i:02d}: {notes}; windows {s['windows']} vs {body['windows']}")
    n_shed = sum(1 for st, b, h in flood if st == 503 and "shed" in b.get("error", "")
                 and "Retry-After" in h)
    n_flood_ok = sum(1 for st, _, _ in flood if st == 200)
    print(f"[streams] {name_power} | /stream: {STATIONS} stations x {n_packets} packets of "
          f"{PACKET} samples + end on {STREAM_CLIENTS} clients in {stream_s:.2f} s; packet "
          f"p50 {np.percentile(lat_ms, 50):.1f} ms p99 {np.percentile(lat_ms, 99):.1f} ms; "
          f"stream_window_latency_ms p50 {win_ms['p50']:.1f} p99 {win_ms['p99']:.1f} (n "
          f"{win_ms['count']}); windows {mux['windows']:.0f}, dropped "
          f"{mux['windows_dropped']:.0f}, degraded sessions {mux['degraded_sessions']:.0f}, "
          f"picks {mux['picks']:.0f}, alerts {mux['alerts']:.0f}; stations matching /annotate "
          f"{STATIONS - len(bad)} of {STATIONS}", flush=True)
    print(f"[streams] {name_power} | batch-tier /predict flood beside it: {len(flood)} "
          f"requests, {n_shed} shed (503, Retry-After), {n_flood_ok} served; shed counts per "
          f"tier {json.dumps(shed)}", flush=True)
    if bad:
        fail(f"/stream differs from /annotate: {bad[:4]}")
    if (any(s != 200 for s in statuses) or mux["windows_dropped"] or mux["degraded_sessions"]
            or shed["alert"]["shed"] or shed["alert"]["admitted"] != len(statuses)):
        fail("an alert-tier packet or window was refused, dropped or shed")
    if n_shed < 1 or n_shed + n_flood_ok != len(flood):
        fail(f"the batch-tier flood was not shed with Retry-After: statuses "
             f"{collections.Counter(st for st, _, _ in flood)}")

    # Restart from the journal: four stations half-streamed, the service
    # shut down (journaling them), a second one over the same directory.
    half = n_packets // 2
    restart = [dict(geometry[i], id=f"RS{i:02d}") for i in range(RESTART_STATIONS)]
    first = run_clients([lambda i=i: stream_station(
        url, restart[i], recs[i], opts, range(1, half + 1), False, [], [])
        for i in range(RESTART_STATIONS)], RESTART_STATIONS)
    server.shutdown()
    service.shutdown()
    t0 = time.perf_counter()
    service2 = srv.service_from_args(srv.get_serve_args(
        ["--model", f"{MODEL}={weights}"] + common))
    server2 = srv.start_http_server(service2, "127.0.0.1", 0)
    url2 = "http://127.0.0.1:%d" % server2.server_address[1]
    services.append(service2)
    ready2_s = time.perf_counter() - t0
    second = run_clients([lambda i=i: stream_station(
        url2, restart[i], recs[i], opts, range(half + 1, n_packets + 1), True, [], [])
        for i in range(RESTART_STATIONS)], RESTART_STATIONS)
    mux2 = service2.metrics()["stream"][MODEL]
    server2.shutdown()
    service2.shutdown()
    pa.pooled_attention_plain = real_plain
    notes = []
    for i in range(RESTART_STATIONS):
        merged = {k: first[i][k] + second[i][k] for k in ("ppk", "spk")}
        ok, note = picks_match(merged, streamed[i])
        notes.append(note)
        if not ok or first[i]["windows"] + second[i]["windows"] != streamed[i]["windows"]:
            fail(f"RS{i:02d}, resumed from the journal, differs from the uninterrupted run")
    print(f"[streams] {name_power} | restart: {RESTART_STATIONS} stations journaled at packet "
          f"{half}, a second service ready in {ready2_s:.2f} s restored {mux2['restores']:.0f}; "
          f"against the uninterrupted run: {'; '.join(notes)}", flush=True)
    if mux2["restores"] != RESTART_STATIONS or mux2["restores_failed"]:
        fail("the second service did not restore every station from the journal")

    counts = {"K1": pa.launches, "K1_bf16": pa.bf16_launches}
    calls = {}
    for s in services:
        for key, c in program_calls(s).items():
            calls[key] = calls.get(key, 0) + c - calls0.get(key, 0) * (s is service)
    progs = {p.key: p for s in services for e in s.entries.values() for p in e.all_programs()}
    want = sum(calls[k] * progs[k].launches[0] for k in calls)
    print(f"[streams] main path: K1 {counts['K1']} launches (bf16 {counts['K1_bf16']}), "
          f"replays x captured launches {want}; replays "
          f"{ {k: c for k, c in calls.items() if c} }; phase {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    if counts["K1"] != want or counts["K1"] < 1 or counts["K1_bf16"]:
        fail(f"phase 13's K1 launches {counts} != 5 x its replays ({want})")
    counts.update(K2=0, K3=0, K2_bf16=0)
    return {"counts": counts, "annotate": rows, "record_options": refs[MODEL][2]}


# ------------------------------------------------------------- phase 14
FLEET_REPLICAS = 2
FLEET_CLIENTS = 4
FLEET_BUCKETS = "1,8"
# The router's per-attempt limit: a black-holed request fails after it and
# is retried on the other replica (an honest /predict takes ~0.1 s).
FLEET_TIMEOUT_S = 1.0
FLEET_KILL_REQ = 8
FLEET_BLACKHOLE_AFTER, FLEET_BLACKHOLE_COUNT, FLEET_BLACKHOLE_HOLD_S = 2, 4, 3
FLEET_BAD_VERSION = 3  # the canary's candidate: every /predict it serves answers 500
# The canary's budget. The candidate's breaker opens at its third failure
# (the router's default, which the black hole needs), and from then on it
# sees one request per cooldown; so the budget decides on those three.
FLEET_CANARY = {"percent": 50, "max_error_delta": 0.2, "min_requests": 3}
FLEET_LATENCY_REQUESTS = 48
FLEET_AFTER_ROLLBACK = 20
# The replica command: the port's serve main under a wrapper of this
# script's own. On the process's way out (exit 75 included; a SIGKILL loses
# it) the wrapper writes the process's K1 launch counts to the phase's
# directory. It numbers each replica's lives there, and keeps the black
# hole to replica 0's second life (the one after the SIGKILL), so the kill
# and the black hole each run alone. The plain attention is patched to
# raise, as in phase 5.
REPLICA_WRAPPER = """\
import atexit, glob, json, os, sys
out, me = sys.argv[1], os.environ.get("SEIST_SERVE_REPLICA", "x")
life = len(glob.glob(os.path.join(out, f"life_r{me}_*")))
open(os.path.join(out, f"life_r{me}_{life}"), "w").close()
# This life's stdout and stderr, faulthandler's stacks included (python -X
# faulthandler writes them to fd 2 on a fatal signal), go to a file of its own.
log = os.open(os.path.join(out, f"replica_r{me}_life{life}.log"),
              os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
os.dup2(log, 1)
os.dup2(log, 2)
if not (me == os.environ.get("SEIST_FAULT_SERVE_REPLICA") and life == 1):
    for key in [k for k in os.environ if k.startswith("SEIST_FAULT_SERVE_BLACKHOLE")]:
        del os.environ[key]
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.serve import server

def _plain_off_path(*a, **k):
    raise AssertionError("pooled_attention_plain reached on the fleet path")

pa.pooled_attention_plain = _plain_off_path

def _dump():
    with open(os.path.join(out, f"k1_r{me}_life{life}.json"), "w") as f:
        json.dump({"K1": pa.launches, "K1_bf16": pa.bf16_launches}, f)

atexit.register(_dump)
server.main(sys.argv[2:])
"""


def replica_tails(work: str, supervisor_log: str, n: int = 60) -> str:
    """The last ``n`` lines of every life of each replica that exited with
    anything but 75 (a drain) or -9 (the phase's own SIGKILL), as the
    supervisor logged its exit: its stdout and stderr, and the Python stack
    of every thread that faulthandler printed on a fatal signal."""
    bad = sorted(set(re.findall(r"replica (\d+) crashed rc=(?!-9\b)(-?\d+)", supervisor_log)))
    parts = []
    for replica, rc in bad:
        for path in sorted(glob.glob(os.path.join(work, f"replica_r{replica}_life*.log"))):
            with open(path, errors="replace") as f:
                tail = f.read().splitlines()[-n:]
            parts.append(f"[fleet] replica {replica} (an exit rc={rc}), "
                         f"{os.path.basename(path)}, last {len(tail)} lines:\n" + "\n".join(tail))
    return "\n".join(parts) or "[fleet] no replica exited with anything but 75 or -9"


def free_ports(n: int) -> int:
    """A base port with ``n`` consecutive free ports below the ephemeral
    range, so no outgoing connection takes a replica's port first."""
    rng = np.random.default_rng()
    while True:
        base = int(rng.integers(20000, 32000 - n))
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


def get_json(url: str, timeout: float = 10.0) -> Tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class FleetLog:
    """Drains one pipe of the fleet (the supervisor's ``[fleet]`` log, or
    its stdout with every replica's) on a thread, stamping each line with
    its arrival on the monotonic clock."""

    def __init__(self, pipe):
        self.lines: List[Tuple[float, str]] = []
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        threading.Thread(target=self._drain, args=(pipe,), daemon=True).start()

    def _drain(self, pipe) -> None:
        for line in pipe:
            with self._lock:
                self.lines.append((time.monotonic(), line.rstrip("\n")))

    def when(self, pattern: str, after: float = 0.0) -> Optional[float]:
        """Arrival of the first line after ``after`` that matches ``pattern``."""
        with self._lock:
            lines = list(self.lines)
        for t, line in lines:
            if t >= after and re.search(pattern, line):
                return t
        return None

    def text(self) -> str:
        with self._lock:
            return "\n".join(line for _, line in self.lines)

    def tail(self, n: int = 60, pattern: str = "") -> str:
        with self._lock:
            lines = [line for _, line in self.lines if re.search(pattern, line)]
        return "\n".join(lines[-n:])

    def save(self, path: str) -> None:
        """The log, each line after its arrival in seconds from the start."""
        with self._lock:
            lines = list(self.lines)
        with open(path, "w") as f:
            f.writelines(f"{t - self._t0:9.3f} {line}\n" for t, line in lines)


class FleetLoad:
    """Closed-loop /predict clients against the router until stopped; each
    record is (start, status, model_version, latency ms, error code)."""

    def __init__(self, url: str, body: bytes, n_threads: int):
        self.records: List[Tuple[float, int, Optional[int], float, str]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(url, body), daemon=True)
                         for _ in range(n_threads)]
        for t in self._threads:
            t.start()

    def _client(self, url: str, body: bytes) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            req = urllib.request.Request(url + "/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    status, out = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                status, out = e.code, {"error": e.read().decode(errors="replace")[:200]}
            except OSError as e:
                status, out = 0, {"error": repr(e)}
            with self._lock:
                self.records.append((t0, status, out.get("model_version"),
                                     (time.monotonic() - t0) * 1e3, str(out.get("error", ""))))

    def since(self, t: float) -> List[Tuple[float, int, Optional[int], float, str]]:
        with self._lock:
            return [r for r in self.records if r[0] >= t]

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)


def timed_requests(url: str, body: bytes, n: int, n_threads: int) -> np.ndarray:
    """``n`` /predict requests on ``n_threads`` clients: their latencies (ms);
    any non-200 fails the phase."""
    def one() -> float:
        t0 = time.perf_counter()
        req = urllib.request.Request(url + "/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            if r.status != 200:
                fail(f"/predict to {url}: {r.status}")
            r.read()
        return (time.perf_counter() - t0) * 1e3

    return np.array(run_clients([one] * n, n_threads))


def stitch_check(url: str, body: dict) -> None:
    """Phase 19 (d), while phase 14's fleet is up: one ``/predict`` through
    the router under a ``traceparent`` of this script's, its spans fetched
    from the router's and both replicas' ``/traces`` and stitched by
    ``python -m seist_tpu_torch trace-report``'s functions: one tree, the
    replica's ``server:/predict`` root a child of a router attempt, no
    flags."""
    tid = obs_trace._new_trace_id()
    req = urllib.request.Request(url + "/predict", data=json.dumps(body).encode(), headers={
        "Content-Type": "application/json",
        obs_trace.TRACEPARENT_HEADER: obs_trace.format_traceparent(tid, obs_trace._new_span_id())})
    with urllib.request.urlopen(req, timeout=60) as r:
        status = r.status
    endpoints = [url] + trace_report.replica_endpoints(url)
    st = trace_report.stitch_from_endpoints(tid, endpoints)
    served = st.find("server:/predict")
    by_id = {s["span_id"]: s for s in st.spans}
    print(f"[fleet] phase 19 (d): one /predict through the router ({status}), stitched from "
          f"{len(endpoints)} endpoints' /traces: {len(st.spans)} spans in {len(st.roots)} "
          f"tree(s), processes {st.processes()}, flags {st.flags}", flush=True)
    for line in st.format().splitlines():
        print(f"[fleet]   {line}", flush=True)
    if (status != 200 or len(endpoints) != 1 + FLEET_REPLICAS or len(st.roots) != 1
            or st.roots[0].get("name") != "router:/predict" or len(served) != 1
            or by_id.get(served[0].get("parent_id"), {}).get("name") != "attempt" or st.flags):
        fail("the stitched trace is not one tree with the replica's root under a router attempt")


def fleet_phase(name_power: str, weights: str, served: dict) -> dict:
    """Phase 14 (module docstring)."""
    t_phase = time.perf_counter()
    work = os.path.join(str(_kernels.BUILD_DIR), "fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    w2 = os.path.join(work, f"{MODEL}_seed{SEED + 1}.pt")
    seeded_weights(w2, seed=SEED + 1)
    spec = os.path.join(work, "rollout.json")
    base = free_ports(FLEET_REPLICAS)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               SEIST_FAULT_SERVE_REPLICA="0", SEIST_FAULT_SERVE_KILL_REQ=str(FLEET_KILL_REQ),
               SEIST_FAULT_STAMP=os.path.join(work, "faults.stamp"),
               SEIST_FAULT_SERVE_BLACKHOLE_AFTER=str(FLEET_BLACKHOLE_AFTER),
               SEIST_FAULT_SERVE_BLACKHOLE_COUNT=str(FLEET_BLACKHOLE_COUNT),
               SEIST_FAULT_SERVE_BLACKHOLE_HOLD_S=str(FLEET_BLACKHOLE_HOLD_S),
               SEIST_FAULT_SERVE_BAD_CANDIDATE=str(FLEET_BAD_VERSION))
    serve_args = ["--model", f"{MODEL}={weights}", "--window", str(WINDOW), "--device", "cuda",
                  "--buckets", FLEET_BUCKETS, "--max-batch", str(BATCH), "--max-delay-ms", "20",
                  "--shed-batch-delay-ms", "inf", "--shed-interactive-delay-ms", "inf"]
    cmd = [sys.executable, "-m", "seist_tpu_torch", "supervise-fleet",
           "--replicas", str(FLEET_REPLICAS), "--base-port", str(base), "--router-port", "0",
           "--probe-interval-s", "0.2", "--backoff", "0.5",
           "--request-timeout-s", str(FLEET_TIMEOUT_S), "--fleet-scrape-interval-s", "0.5",
           "--rollout-file", spec, "--rollout-ready-timeout-s", "120", "--drain-timeout-s", "60",
           "--", sys.executable, "-X", "faulthandler", "-c", REPLICA_WRAPPER, work, *serve_args]
    print(f"[fleet] python -m seist_tpu_torch supervise-fleet --replicas {FLEET_REPLICAS} ... -- "
          f"serve {' '.join(serve_args)}", flush=True)
    t_start = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    sup, out = FleetLog(proc.stderr), FleetLog(proc.stdout)
    load: Optional[FleetLoad] = None

    def wait(pred, timeout_s: float, what: str):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = pred()
            if got:
                return got
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        fail(f"phase 14: timed out waiting for {what}\n[fleet log]\n{sup.tail(40, r'^.fleet.')}"
             f"\n[replicas, {work}/replicas.log]\n{out.tail(40)}")

    try:
        m = wait(lambda: re.search(r"ROUTER=(http://[\d.]+:\d+)", out.text()), 120,
                 "the router's address")
        url = m.group(1)

        def replicas() -> List[dict]:
            try:
                return get_json(url + "/router/replicas")[1].get("replicas", [])
            except OSError:
                return []

        def in_rotation(version: Optional[int] = None) -> bool:
            reps = replicas()
            return len(reps) == FLEET_REPLICAS and all(
                r["probe_state"] == "ok" and r["breaker"]["state"] == "closed"
                and (version is None or r["versions"].get(MODEL) == version) for r in reps)

        wait(in_rotation, 240, "two replicas in rotation")
        fleet_ready_s = time.monotonic() - t_start
        print(f"[fleet] two replicas in rotation after {fleet_ready_s:.1f} s", flush=True)
        phase5 = traces(N_REQUESTS)
        body = json.dumps({"data": phase5[0].tolist(), "options": {"max_events": 1}}).encode()

        # (a) SIGKILL at replica 0's 8th request under load.
        t_load = time.monotonic()
        load = FleetLoad(url, body, FLEET_CLIENTS)
        t_kill = wait(lambda: sup.when(r"replica 0 crashed rc=-9", t_load), 120,
                      "the SIGKILL of replica 0")
        # The relaunch opens its socket before its warm-up: while it warms,
        # /predict, /annotate and /stream sent to it directly are served.
        r0 = f"http://127.0.0.1:{base}"

        def warming() -> bool:
            try:
                live, ready = get_json(r0 + "/healthz/live", 2.0), get_json(r0 + "/healthz/ready", 2.0)
            except OSError:
                return False
            return live[0] == 200 and ready == (503, {"status": "warming", "ready": False,
                                                      "versions": {MODEL: 1}})

        wait(warming, 120, "replica 0's relaunch warming up")
        t_warm = time.monotonic()
        print(f"[fleet] replica 0 warming {t_warm - t_kill:.1f} s after its SIGKILL", flush=True)
        # (b)'s breaker states of replica 0, watched from here on: the black
        # hole can open and close it before replica 0 is seen back in
        # rotation below.
        seen: List[str] = []
        watching = threading.Event()

        def watch_breaker() -> None:
            while not watching.wait(0.05):
                reps = {r["url"]: r for r in replicas()}
                state = reps.get(f"127.0.0.1:{base}", {}).get("breaker", {}).get("state")
                if state and (not seen or seen[-1] != state):
                    seen.append(state)

        watcher = threading.Thread(target=watch_breaker, daemon=True)
        watcher.start()
        record = long_record(SEED, 2 * WINDOW)
        station = {"id": "FL01", "network": "XX", "lat": 35.0, "lon": -117.0}
        # They pay the process's first forward (the card's libraries
        # loading) beside the warm-up's captures: a deadline of a minute.
        opts = {"timeout_ms": 60000.0}
        warm_calls = [
            ("/predict", {"data": traces(1)[0].tolist(), "options": dict(opts, max_events=1)}),
            ("/annotate", {"model": MODEL, "data": record.tolist(), "options": opts}),
            ("/stream", {"model": MODEL, "station": station, "seq": 1, "options": opts,
                         "data": record[:PACKET].tolist()}),
        ]

        def warm_call(path: str, b: dict) -> Tuple[int, dict, float]:
            t0 = time.monotonic()
            status, answer = post(r0 + path, b)
            return status, answer, time.monotonic() - t0

        warm = run_clients([lambda p=p, b=b: warm_call(p, b) for p, b in warm_calls],
                           len(warm_calls))
        warm_s = [round(w[2], 2) for w in warm]
        if any(s != 200 for s, _, _ in warm):
            fail("a request to the warming replica failed: "
                 f"{[(p, s, t, str(b)[:200]) for (p, _), (s, b, t) in zip(warm_calls, warm)]}")
        back = wait(lambda: in_rotation() and time.monotonic(), 240,
                    "replica 0 back in rotation after the SIGKILL")
        kill_relaunch_s = back - t_kill
        r0_metrics = get_json(r0 + "/metrics")[1]

        # (b) The black hole (replica 0's second life): its breaker opens,
        # then closes, while every client request succeeds.
        def breaker_cycle() -> bool:
            return "open" in seen and seen[-1] == "closed" and in_rotation()

        t_hole, cycled = time.monotonic(), False
        try:
            wait(breaker_cycle, 120, "replica 0's breaker to open and close again")
            cycled = True
        finally:
            watching.set()
            watcher.join(timeout=5)
            if not cycled:
                print(f"[fleet] replica 0's breaker states since its relaunch warmed: {seen}",
                      flush=True)
        hole_s = time.monotonic() - t_hole
        load.stop()
        records = load.since(0.0)
        failed = [r for r in records if r[1] != 200]
        print(f"[fleet] {name_power} | (a) SIGKILL at replica 0's request {FLEET_KILL_REQ} and "
              f"(b) its black hole (requests {FLEET_BLACKHOLE_AFTER + 1}-"
              f"{FLEET_BLACKHOLE_AFTER + FLEET_BLACKHOLE_COUNT} of its next life held "
              f"{FLEET_BLACKHOLE_HOLD_S} s) under {FLEET_CLIENTS} clients: {len(records)} "
              f"requests, {len(failed)} failed; relaunch to ready after the SIGKILL "
              f"{kill_relaunch_s:.1f} s; while warming, direct /predict, /annotate, /stream: "
              f"{[s for s, _, _ in warm]} in {warm_s} s (fallback_runs "
              f"{r0_metrics['fallback_runs']}); breaker of replica 0: {' -> '.join(seen)} in "
              f"{hole_s:.1f} s", flush=True)
        if failed or not records:
            fail(f"client requests failed under the SIGKILL or the black hole: {failed[:5]}")

        # Parity: phase 5's first two traces through the router, phase 5's
        # answers; the two CPU answers differ, so a request fed the other
        # one's waveform fails.
        fs = PredictOptions.from_dict({"max_events": 1}).sampling_rate
        status, got = post(url + "/predict", json.loads(body))
        status1, got1 = post(url + "/predict", {"data": phase5[1].tolist(),
                                                "options": {"max_events": 1}})
        ok = (status == status1 == 200 and picks_close(got, served["ref0"], PICK_TOL_S * fs)
              and picks_close(got, served["resp0"], PICK_TOL_S * fs)
              and picks_close(got1, served["refs"][1], PICK_TOL_S * fs))
        apart = not picks_close(served["refs"][0], served["refs"][1], PICK_TOL_S * fs)
        print(f"[fleet] /predict through the router vs phase 5's CPU runs of the same traces: "
              f"{json.dumps(got)}, {json.dumps(got1)}; picks within {PICK_TOL_S} s: {ok}; the "
              f"two traces' CPU picks differ by more: {apart}", flush=True)
        if not ok or not apart:
            fail("the fleet's answers differ from phase 5's, or phase 5's two answers do not "
                 "tell the traces apart")

        # /predict latency, through the router and direct to replica 1.
        lat_router = timed_requests(url, body, FLEET_LATENCY_REQUESTS, FLEET_CLIENTS)
        lat_direct = timed_requests(f"http://127.0.0.1:{base + 1}", body, FLEET_LATENCY_REQUESTS,
                                    FLEET_CLIENTS)
        print(f"[fleet] {name_power} | /predict x{FLEET_LATENCY_REQUESTS} on {FLEET_CLIENTS} "
              f"clients in another process: through the router p50 "
              f"{np.percentile(lat_router, 50):.1f} ms p99 {np.percentile(lat_router, 99):.1f} ms; "
              f"direct to one replica p50 {np.percentile(lat_direct, 50):.1f} ms p99 "
              f"{np.percentile(lat_direct, 99):.1f} ms", flush=True)

        # (e) The fleet pane merges both replicas and the router.
        sent_router = len(records) + 2 + FLEET_LATENCY_REQUESTS
        direct = FLEET_LATENCY_REQUESTS + 1  # replica 1's timed ones, replica 0's warming one

        def pane():
            time.sleep(0.6)  # a scrape after the last request
            view = get_json(url + "/fleet/metrics.json", 30)[1]
            return view if view.get("up") == FLEET_REPLICAS + 1 else None

        view = wait(pane, 30, "/fleet/metrics.json with every source up")
        agg = view["aggregate"]
        per = {n: (s or {}).get("collectors", {}).get("serve_requests_predict", 0.0)
               for n, s in view["replicas"].items() if n.startswith("replica-")}
        router_req = agg["counters"].get("router_requests{path=predict}", 0.0)
        attempts = router_req + agg["counters"].get("router_retries", 0.0)
        after_kill = len([r for r in records if r[0] >= back]) + FLEET_LATENCY_REQUESTS + 2
        summed = agg["collectors"].get("serve_requests_predict", 0.0)
        print(f"[fleet] (e) /fleet/metrics.json: {view['up']} sources up; /predict counted by "
              f"the replicas {per} (sum {summed:.0f}), by the router {router_req:.0f} "
              f"({attempts:.0f} attempts with retries); the phase sent {sent_router} through the "
              f"router and {direct} direct", flush=True)
        if (len(per) != FLEET_REPLICAS or summed != sum(per.values()) or router_req != sent_router
                or not after_kill <= summed <= attempts + direct):
            fail("the fleet pane does not add up to the requests the phase sent")
        stitch_check(url, json.loads(body))

        # (c) A rolling restart to a second weights file, under load.
        with open(spec, "w") as f:
            json.dump({"version": 2, "checkpoint": w2}, f)
        t_roll = time.monotonic()
        load = FleetLoad(url, body, FLEET_CLIENTS)
        proc.send_signal(signal.SIGHUP)
        min_ready = [FLEET_REPLICAS]

        def rolled() -> bool:
            reps = replicas()
            min_ready[0] = min(min_ready[0], sum(r["probe_state"] == "ok" for r in reps))
            return bool(sup.when(r"rollout complete: version 2", t_roll)) and in_rotation(2)

        wait(rolled, 300, "the roll to version 2")
        t_done = sup.when(r"rollout complete: version 2", t_roll)
        time.sleep(1.0)
        load.stop()
        roll = load.since(t_roll)
        failed = [r for r in roll if r[1] != 200]
        versions = collections.Counter(r[2] for r in roll)
        late = {r[2] for r in roll if r[0] > t_done}
        roll_relaunch = []
        for i in range(FLEET_REPLICAS):
            t75 = sup.when(rf"replica {i} clean preempt \(rc=75\)", t_roll)
            t_ok = sup.when(rf"rollout: replica {i} ready \+ re-registered \(version 2\)", t_roll)
            roll_relaunch.append(None if t75 is None or t_ok is None else t_ok - t75)
        print(f"[fleet] {name_power} | (c) roll to version 2 under {FLEET_CLIENTS} clients: wall "
              f"{t_done - t_roll:.1f} s; {len(roll)} requests, {len(failed)} failed, versions "
              f"{dict(versions)}, after the roll {sorted(late)}; router ready count never below "
              f"{min_ready[0]}; exit 75 to ready per replica "
              f"{[None if s is None else round(s, 1) for s in roll_relaunch]} s", flush=True)
        if (failed or min_ready[0] < 1 or not set(versions) <= {1, 2} or late != {2}
                or None in roll_relaunch or re.search(r"crashed rc=(?!-9)", sup.text())):
            fail(f"the rolling restart failed: {failed[:5]}\n{sup.tail(40, r'^.fleet.')}\n"
                 f"{replica_tails(work, sup.text())}")

        # (d) The canary: replica 0 alone rolled to the bad candidate (with
        # no traffic, so its breaker is closed when the canary starts), then
        # half the first attempts to it, under load.
        with open(spec, "w") as f:
            json.dump({"version": FLEET_BAD_VERSION, "checkpoint": w2, "replicas": [0]}, f)
        t_canary_roll = time.monotonic()
        proc.send_signal(signal.SIGHUP)
        wait(lambda: sup.when(rf"rollout complete: version {FLEET_BAD_VERSION} on replica\(s\) "
                              r"\[0\]", t_canary_roll), 300, "replica 0's roll to the candidate")
        wait(lambda: sorted(r["versions"].get(MODEL, 0) for r in replicas()
                            if r["probe_state"] == "ok") == [2, FLEET_BAD_VERSION], 60,
             "both cohorts in rotation")
        status, started = post(url + "/router/canary", dict(FLEET_CANARY,
                                                            version=FLEET_BAD_VERSION))
        if status != 200 or started.get("state") != "active":
            fail(f"POST /router/canary: {status} {started}")
        t_canary = time.monotonic()
        load = FleetLoad(url, body, FLEET_CLIENTS)

        def rolled_back() -> Optional[dict]:
            c = get_json(url + "/router/canary")[1]
            return c if c["state"] == "rolled_back" else None

        canary = wait(rolled_back, 120, "the canary's rollback")
        t_rollback = time.monotonic()
        load.stop()
        canary_records = load.since(t_canary)
        after = [post(url + "/predict", json.loads(body)) for _ in range(FLEET_AFTER_ROLLBACK)]
        until = sum(c["requests"] for c in canary["cohorts"].values())
        failed = [r for r in canary_records if r[1] != 200]
        after_versions = sorted({b.get("model_version") for _, b in after})
        print(f"[fleet] {name_power} | (d) canary of version {FLEET_BAD_VERSION} at "
              f"{FLEET_CANARY['percent']}%: {canary['state']} after {until} routed attempts "
              f"({canary['rollback_reason']}) in {t_rollback - t_canary:.1f} s; replica 0's roll "
              f"to it {t_canary - t_canary_roll:.1f} s; {len(canary_records)} client requests "
              f"under the canary, {len(failed)} failed; after the rollback {len(after)} requests "
              f"answered by version(s) {after_versions}", flush=True)
        if failed or any(s != 200 for s, _ in after) or after_versions != [2]:
            fail("the canary's rollback let a failure or the candidate through")
    finally:
        if load is not None:
            load.stop()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        sup.save(os.path.join(work, "supervisor.log"))
        out.save(os.path.join(work, "replicas.log"))
    log = sup.text()
    counts = []
    for path in sorted(glob.glob(os.path.join(work, "k1_r*_life*.json"))):
        with open(path) as f:
            counts.append((os.path.basename(path), json.load(f)))
    k1 = sum(c["K1"] for _, c in counts)
    lives = len(glob.glob(os.path.join(work, "life_r*")))
    wall = time.perf_counter() - t_phase
    print(f"[fleet] {name_power} | supervisor exit {rc}; replicas drained: "
          f"{log.count('drained (rc=75)')}; K1 launches on the fleet path {k1} or more (a "
          f"SIGKILLed process's count is lost): {[(n, c['K1']) for n, c in counts]}; fleet up in "
          f"{fleet_ready_s:.1f} s; phase 14 wall {wall:.1f} s", flush=True)
    exits = collections.Counter(re.findall(r"replica \d+ (?:crashed rc=(-?\d+)|clean preempt "
                                           r"\(rc=(75)\))", log))
    exits = collections.Counter({int(a or b): n for (a, b), n in exits.items()})
    print(f"[fleet] replica exits over the phase, by code: {dict(sorted(exits.items()))} "
          f"(-9: the phase's SIGKILL; 75: a drain); an abort (-6): "
          f"{'seen' if exits.get(-6) else 'not seen'}; each life's stdout and stderr "
          f"(python -X faulthandler) in {work}/replica_r*_life*.log", flush=True)
    if any(code not in (-9, 75) for code in exits):
        print(replica_tails(work, log), flush=True)
    if (rc != 0 or log.count("drained (rc=75)") != FLEET_REPLICAS or len(counts) != lives - 1
            or k1 <= 0 or any(c["K1"] % served["n_shapes"] or c["K1_bf16"] for _, c in counts)):
        fail(f"the fleet did not stop cleanly or lost its counts\n{sup.tail(40, r'^.fleet.')}")
    return {"counts": {"K1": k1, "K2": 0, "K3": 0, "K1_bf16": 0, "K2_bf16": 0}, "wall_s": wall}


# ------------------------------------------------------------- phase 15
REPICK_EVENTS = LOADER_EVENTS  # phase 8's synthetic events, here at trace WINDOW
REPICK_SHARD = 256  # 8 shards: 8 work units
REPICK_BATCH = 64
REPICK_BPC = 2  # batches per call: 128 rows a replay, 10 K1 launches
REPICK_ROWS_PER_CALL = REPICK_BATCH * REPICK_BPC
# --max-events 1 is phase 5's decode option: the top pick of each kind.
REPICK_GEOMETRY = ["--model", "", "--batch-size", str(REPICK_BATCH), "--batches-per-call",
                   str(REPICK_BPC), "--commit-every", "1", "--max-events", "1"]
# (b): rows of the serial run held against the CPU, taken from that run's
# own replays: both ends of both batches of its first, middle and last call.
REPICK_CPU_ROWS = np.array([c * REPICK_ROWS_PER_CALL + o for c in (0, 8, 15)
                            for o in (0, REPICK_BATCH - 1, REPICK_BATCH, 2 * REPICK_BATCH - 1)])
# The seeded weights answer every waveform alike (their outputs do not move
# with the input); phase 15's cut each BatchNorm's scale and shift by this
# gain and set its statistics from the archive (repick_weights), so the
# outputs follow the waveform while the int8 weights stay inside their
# gate. (b) prints how far apart two rows' outputs lie.
REPICK_BN_GAIN = 0.05
REPICK_PASSES = 8  # (a)'s timed loop: the archive 8 times, 16,384 rows
REPICK_TIMEOUT_S = 300.0  # each child process; its expiry fails the phase
REPICK_SLOW_MS = "1500"  # (d) worker 0's sleep per call: its kill lands after one commit
# (e): the JAX package's chaos clocks (tools/batch_chaos.py); the partition
# outlasts a peer's relaunch and the reclaim of worker 0's expired unit.
CHAOS_LEASE_ENV = {
    "SEIST_LEASE_TTL_S": "2.5", "SEIST_LEASE_HEARTBEAT_S": "0.5", "SEIST_LEASE_GRACE_S": "0.5",
    "SEIST_LEASE_OP_TIMEOUT_S": "1.0", "SEIST_LEASE_RETRIES": "3",
    "SEIST_LEASE_BACKOFF_MS": "30", "SEIST_LEASE_BACKOFF_CAP_MS": "200",
    "SEIST_LEASE_PARK_S": "0.3",
}
CHAOS_SLOW_MS = "400"
CHAOS_PARTITION_AFTER_S = "0.6"


def chaos_partition_s(worker_start_s: float) -> float:
    """(e)'s partition of worker 0, from (d)'s measured worker start (launch
    to its first committed segment): a peer reclaims worker 0's unit about
    one worker start plus a few seconds of scanning after the partition
    opens (it is relaunched after a kill or a preemption), and the
    partition must last past that, or worker 0 heals first and no zombie
    forms. On an H100 host a worker's start has taken ~20-33 s."""
    return max(45.0, 1.5 * worker_start_s + 15.0)

# A repick worker under this script's wrapper: the plain attention patched
# to raise, and the process's K1 launches written on its way out (exit 75
# included; a SIGKILL loses them).
REPICK_WRAPPER = """\
import atexit, json, os, sys
out = sys.argv[1]
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.repick import main

def _plain_off_path(*a, **k):
    raise AssertionError("pooled_attention_plain reached on the repick path")

pa.pooled_attention_plain = _plain_off_path

def _dump():
    with open(os.path.join(out, f"k1_{os.getpid()}.json"), "w") as f:
        json.dump({"K1": pa.launches, "K1_bf16": pa.bf16_launches}, f)

atexit.register(_dump)
sys.exit(main(sys.argv[2:]))
"""

# supervise-repick's main with its workers under REPICK_WRAPPER.
SUPERVISOR_WRAPPER = """\
import sys
from seist_tpu_torch import supervise_repick as sup
out, wrapper = sys.argv[1], sys.argv[2]
real = sup._worker_cmd
sup._worker_cmd = lambda args, i: [sys.executable, "-c", wrapper, out] + real(args, i)[4:]
sys.exit(sup.main(sys.argv[3:]))
"""


@torch.no_grad()
def calibrated_weights(flat: str, rows: np.ndarray, gain: float) -> Dict[str, torch.Tensor]:
    """Weights whose outputs follow the waveform: ``flat``'s (phase 5's
    seeded draw, whose outputs do not) with every BatchNorm's scale and
    shift times ``gain`` and its running statistics those of its input on
    ``rows`` ((n, 3, WINDOW) traces), set layer by layer in one eval
    forward on the CPU."""
    from seist_tpu_torch.batch.engine import normalize_transpose
    from seist_tpu_torch.models.common import BatchNorm

    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED)
    model.load_state_dict(torch.load(flat, map_location="cpu"))
    model.eval()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def calibrate(norm, args):
        x = args[0].float()
        dims = tuple(range(x.dim() - 1))
        norm.running_mean.copy_(x.mean(dims))
        norm.running_var.copy_(x.var(dims, correction=0))

    for norm in norms:
        norm.weight.mul_(gain)
        norm.bias.mul_(gain)
    hooks = [norm.register_forward_pre_hook(calibrate) for norm in norms]
    try:
        model(normalize_transpose(torch.from_numpy(rows)))
    finally:
        for h in hooks:
            h.remove()
    return model.state_dict()


def repick_weights(path: str, flat: str, rows: np.ndarray) -> None:
    """Phase 15's weights: :func:`calibrated_weights` on archive rows."""
    torch.save(calibrated_weights(flat, rows, REPICK_BN_GAIN), path)


@contextlib.contextmanager
def kept_outputs(kept: Dict[int, np.ndarray]):
    """Keep the outputs of the rows in REPICK_CPU_ROWS from a run's own
    replays, ``{row: (WINDOW, 3)}``: ``RepickEngine._decode_call`` is
    patched to copy them out before decoding, so they come through the
    run's whole feed (the fill, the pinned copy on the copy stream, the
    replay's wait on its event, the staging slab's reuse)."""
    from seist_tpu_torch.batch.engine import RepickEngine

    real = RepickEngine._decode_call

    def keep(self, out, *, n_valid, row_lo):
        if self._warm:  # the warm-up's call decodes zeros
            sel = [int(r) for r in REPICK_CPU_ROWS if row_lo <= r < row_lo + n_valid]
            if sel:
                got = out[MODEL].reshape(-1, WINDOW, 3)[[r - row_lo for r in sel]]
                kept.update(zip(sel, got.float().cpu().numpy()))
        return real(self, out, n_valid=n_valid, row_lo=row_lo)

    RepickEngine._decode_call = keep
    try:
        yield kept
    finally:
        RepickEngine._decode_call = real


def check_kept(what: str, kept: Dict[int, np.ndarray], want: np.ndarray) -> Tuple[float, float]:
    """A run's kept outputs against the CPU's ``want`` of the same rows
    (REPICK_CPU_ROWS' order), by :func:`check_separated`. Returns (max abs
    error, the smallest separation)."""
    if sorted(kept) != sorted(int(r) for r in REPICK_CPU_ROWS):
        fail(f"{what}: outputs kept of rows {sorted(kept)}, expected {REPICK_CPU_ROWS.tolist()}")
    return check_separated(what, np.stack([kept[int(r)] for r in REPICK_CPU_ROWS]), want)


def repick_pack(out: str, dtype: str) -> None:
    rc, v = packs().verdict(out)
    if rc != 0 or v["samples"] != REPICK_EVENTS or v["shards"] != REPICK_EVENTS // REPICK_SHARD:
        fail(f"repick archive {dtype}: rc {rc}, {v}")
    print(f"[repick] archive {dtype}: {v['samples']} events at trace {WINDOW} in {v['shards']} "
          f"shards, {v['on_disk_bytes']} bytes, {v['wall_s']} s", flush=True)


def start_mapreduce(out_d: str, archive: str, geometry: List[str]) -> dict:
    """Phase 15 (d)'s two workers over ``archive`` into ``out_d``, worker 0
    slowed so that a thread of this process SIGKILLs it after its first
    commit and relaunches it, while the phase goes on: a handle with the
    processes, the thread and its ``error``."""
    os.makedirs(out_d)
    base = [sys.executable, "-c", REPICK_WRAPPER, out_d, "--archive", archive, "--out", out_d,
            "--compile-gate", "--no-merge", "--num-workers", "2", *geometry]
    run = {"t0": time.perf_counter(), "launched": time.time(), "error": None}
    slow = dict(os.environ, SEIST_FAULT_REPICK_SLOW_MS=REPICK_SLOW_MS)
    run["w0"] = child(base + ["--worker-index", "0"], os.path.join(out_d, "w0.1.log"), slow)
    run["w1"] = child(base + ["--worker-index", "1"], os.path.join(out_d, "w1.log"))

    def kill_and_relaunch() -> None:
        first = os.path.join(out_d, "unit_00000.seg_0000.jsonl")
        while not os.path.exists(first):
            if run["w0"].poll() is not None or time.perf_counter() - run["t0"] > REPICK_TIMEOUT_S:
                run["error"] = (f"(d): worker 0 ended ({run['w0'].poll()}) or timed out before "
                                f"its first commit")
                return
            time.sleep(0.05)
        run["w0"].send_signal(signal.SIGKILL)
        rc = run["w0"].wait()
        if rc != -signal.SIGKILL:
            run["error"] = f"(d) worker 0, SIGKILLed: exit {rc}"
            return
        run["segs_at_kill"] = len(glob.glob(os.path.join(out_d, "unit_*.seg_*.jsonl")))
        run["w0b"] = child(base + ["--worker-index", "0"], os.path.join(out_d, "w0.2.log"))

    def stop() -> None:  # a failure before (d)'s checks: stop its workers
        for key in ("w0", "w1", "w0b"):
            if key in run and run[key].poll() is None:
                run[key].kill()
                run[key].wait()

    atexit.register(stop)
    run["thread"] = threading.Thread(target=kill_and_relaunch, daemon=True)
    run["thread"].start()
    return run


def repick_in_process(argv: List[str]) -> dict:
    """``repick.main(argv)`` in this process: its verdicts, K1 launches
    over exactly that run, the ``batch_infer_bytes`` it added, its wall
    seconds and its log."""
    from seist_tpu_torch import repick

    buf, lines = io.StringIO(), []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger.addHandler(handler)
    bytes0 = BUS.counter("batch_infer_bytes").value
    pa.launches = pa.bf16_launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = repick.main(argv)
    finally:
        logger.removeHandler(handler)
    wall = time.perf_counter() - t0
    verdicts = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    if rc != 0:
        fail(f"repick {' '.join(argv)}: rc {rc}, {verdicts}")
    return {"verdicts": {v["role"]: v for v in verdicts},
            "counts": {"K1": pa.launches, "K1_bf16": pa.bf16_launches},
            "bytes": BUS.counter("batch_infer_bytes").value - bytes0, "wall_s": wall,
            "lines": lines}


def catalog_of(out: str) -> Tuple[bytes, List[dict]]:
    with open(os.path.join(out, "catalog.jsonl"), "rb") as f:
        blob = f.read()
    return blob, [json.loads(x) for x in blob.splitlines()]


def row_picks(r: dict) -> dict:
    """A catalog row in the ``picks_agree`` form."""
    return {"ppk": [{"sample": s} for s in r["ppk"]], "spk": [{"sample": s} for s in r["spk"]],
            "det": [{"onset": a, "offset": b} for a, b in r["det"]]}


def sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def child(cmd: List[str], log: str, env: Optional[dict] = None) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            env=env, cwd=str(Path(__file__).resolve().parent))


def wait_child(proc: subprocess.Popen, what: str, expect: Tuple[int, ...] = (0,),
               log: Optional[str] = None, note=None) -> int:
    """Waits for a child; on a failure the end of its ``log`` is shown,
    and what ``note()`` returns."""

    def tail() -> str:
        text = note() if note is not None else ""
        if log is None or not os.path.exists(log):
            return text
        with open(log, errors="replace") as f:
            return f"{text}\n[the end of {log}]\n{f.read()[-4000:]}"

    try:
        rc = proc.wait(timeout=REPICK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{what}: no exit within {REPICK_TIMEOUT_S:.0f} s{tail()}")
    if rc not in expect:
        fail(f"{what}: exit {rc}, expected {expect}{tail()}")
    return rc


def log_verdicts(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def k1_dumps(out: str) -> List[dict]:
    return [json.load(open(p)) for p in sorted(glob.glob(os.path.join(out, "k1_*.json")))]


def repick_phase(name_power: str, weights: str) -> dict:
    """Phase 15 (module docstring)."""
    from seist_tpu_torch import repick
    from seist_tpu_torch.batch import engine as engine_mod
    from seist_tpu_torch.data.ingest import PackedRawStore
    from seist_tpu_torch.ops.postprocess import decode_head_batch
    from seist_tpu_torch.ops.results import catalog_rows

    t_phase = time.perf_counter()
    root = os.path.join(str(_kernels.BUILD_DIR), "repick")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    arch = {d: os.path.join(str(_kernels.BUILD_DIR), PACKS_DIR, f"repick_{d}")
            for d in ("float32", "int8")}
    for dtype, path in arch.items():
        repick_pack(path, dtype)
    keys = np.load(os.path.join(arch["float32"], "index.npz"))["key"]

    # The weights, and (b)'s and (c)'s references, on the CPU (which runs
    # the plain attention).
    t0 = time.perf_counter()

    def raw_store(path: str, stage_raw: bool = False):
        sds = pipeline.SeismicDataset("packed", "train", seed=0, data_dir=path, input_names=[],
                                      label_names=[], task_names=[], in_samples=WINDOW,
                                      augmentation=False, shuffle=False, data_split=False)
        return PackedRawStore.build(sds, batch_size=REPICK_ROWS_PER_CALL, stage_raw=stage_raw)

    store = raw_store(arch["float32"])
    ids = np.arange(4)
    rp_weights = os.path.join(root, "weights.pt")
    first_rows = store.row_batch_at(ids, epoch=0, idx=ids)["data"].copy()
    repick_weights(rp_weights, weights, first_rows)
    flat = load_model_entry(MODEL, weights, window=WINDOW, device="cpu")
    with torch.inference_mode():
        out5 = flat.model(engine_mod.normalize_transpose(torch.from_numpy(first_rows))).numpy()
    print(f"[repick] the seeded weights (phase 5's before calibration) on the CPU: rows 0-3's "
          f"outputs at most {float(np.abs(out5 - out5[:1]).max()):.2e} apart (they do not "
          f"follow the waveform)", flush=True)
    del flat
    geometry = list(REPICK_GEOMETRY)
    geometry[1] = f"{MODEL}={rp_weights}"
    # (d)'s two workers start now, beside the CPU references and (a)-(c).
    out_d = os.path.join(root, "mapreduce")
    d_run = start_mapreduce(out_d, arch["float32"], geometry)
    cpu = load_model_entry(MODEL, rp_weights, window=WINDOW, device="cpu")
    ids = REPICK_CPU_ROWS
    rows_i8 = raw_store(arch["int8"], stage_raw=True).row_batch_at(ids, epoch=0, idx=ids)
    decode = {**engine_mod.DEFAULT_DECODE, "max_events": 1}
    with torch.inference_mode():
        cpu_probs = cpu.model(engine_mod.normalize_transpose(
            torch.from_numpy(store.row_batch_at(ids, epoch=0, idx=ids)["data"].copy())))
        dec = decode_head_batch(cpu.spec, cpu_probs, is_picker=True, sampling_rate=50, **decode)
        int8_apply = aot.make_variant_apply(lambda m, x: m(x), cpu.model, "int8")
        cpu_i8 = int8_apply(engine_mod.normalize_transpose(engine_mod.dequant_rows(
            torch.from_numpy(rows_i8["data"].copy()),
            torch.from_numpy(rows_i8["data_scale"].copy())))).float().numpy()
    cpu_rows = catalog_rows({MODEL: {k: v.numpy() for k, v in dec.items()}},
                            n_valid=len(ids), row_ids=ids, keys=keys[ids])
    cpu_probs = cpu_probs.numpy()
    del cpu, int8_apply
    cpu_s = time.perf_counter() - t0

    real_plain = pa.pooled_attention_plain

    def plain_off_path(*a, **k):
        raise AssertionError("pooled_attention_plain reached on the repick path")

    pa.pooled_attention_plain = plain_off_path
    try:
        # (a) serial, in this process, through the entry.
        out_a = os.path.join(root, "serial")
        with kept_outputs({}) as kept_a:
            a = repick_in_process(["--archive", arch["float32"], "--out", out_a,
                                   "--compile-gate", *geometry])
        w = a["verdicts"]["worker"]
        blob_a, rows_a = catalog_of(out_a)
        replays = w["program_calls"]
        print(f"[repick] {name_power} | (a) serial {MODEL} window {WINDOW} b{REPICK_BATCH}x"
              f"{REPICK_BPC}: {w['rows']} rows in {w['calls']} calls, {w['waveforms_per_sec']} "
              f"waveforms/s over {w['wall_s']} s; stage seconds {w['stage_seconds']}; program "
              f"capture {w['warmup_capture_s']} s, graph memory {w['warmup_graph_memory_mib']} "
              f"MiB, {w['warmup_flops_per_call']:.4g} FLOPs a replay; entry wall "
              f"{a['wall_s']:.1f} s; K1 {a['counts']['K1']} launches over {replays} replays; "
              f"compiles_after_warmup {w['compiles_after_warmup']}", flush=True)
        if (w["rows"] != REPICK_EVENTS or len(rows_a) != REPICK_EVENTS
                or [r["key"] for r in rows_a] != [str(k) for k in keys]
                or [r["row"] for r in rows_a] != list(range(REPICK_EVENTS))):
            fail("(a): the catalog's rows or keys are not the pack's")
        if w["compiles_after_warmup"] != 0:
            fail(f"(a): compiles_after_warmup {w['compiles_after_warmup']}")
        if (w["warmup_k1_launches_per_call"] != 5 * REPICK_BPC
                or a["counts"]["K1"] != 5 * REPICK_BPC * replays or a["counts"]["K1_bf16"]
                or replays != 1 + REPICK_EVENTS // REPICK_ROWS_PER_CALL):
            fail(f"(a): K1 launches {a['counts']} != 10 x {replays} replays")
        # The rows' picks follow their waveforms: a catalog whose rows came
        # from the row numbers alone would repeat one tuple.
        distinct = len({(tuple(r["ppk"]), tuple(r["spk"]), tuple(map(tuple, r["det"])))
                        for r in rows_a})
        print(f"[repick] (a) {distinct} distinct (ppk, spk, det) of {len(rows_a)} rows "
              f"(limit {REPICK_EVENTS // 2})", flush=True)
        if distinct < REPICK_EVENTS // 2:
            fail(f"(a): {distinct} distinct picks in {len(rows_a)} rows")

        # One replay profiled, and the rate over a longer loop, from an
        # engine of the same plan.
        engine, units = repick.build_engine(repick.get_args(
            ["--archive", arch["float32"], "--out", os.path.join(root, "profile"), *geometry]))
        engine.warmup()
        first = store.row_batch_at(np.arange(REPICK_ROWS_PER_CALL), epoch=0,
                                   idx=np.arange(REPICK_ROWS_PER_CALL))["data"]
        args = engine._call_args(first.reshape(REPICK_BPC, REPICK_BATCH, 3, WINDOW), None)
        prof = attribution.measured_kernels(lambda: engine._program(*args), iters=3)
        print(f"[repick] {name_power} | one replay of {REPICK_ROWS_PER_CALL} rows (profiled): wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms, idle share "
              f"{prof['idle_share']:.3f}, {prof['kernels']:.0f} kernels", flush=True)
        engine.stage = {k: 0.0 for k in engine.stage}
        calls0, pa.launches = engine.program_calls, 0
        rates, t0 = [], time.perf_counter()
        for p in range(REPICK_PASSES):
            out_p = os.path.join(root, f"pass_{p}")
            os.makedirs(out_p)
            rates.append(engine.run_units(units, out_p, commit_every=1)["waveforms_per_sec"])
        loop_s = time.perf_counter() - t0
        loop_calls = engine.program_calls - calls0
        print(f"[repick] {name_power} | (a) timed loop, the archive {REPICK_PASSES} times "
              f"through the engine: {REPICK_PASSES * REPICK_EVENTS / loop_s:.1f} waveforms/s "
              f"over {loop_s:.3f} s ({loop_calls} calls), per pass {min(rates)}-{max(rates)}; "
              f"stage seconds { {k: round(v, 3) for k, v in engine.stage.items()} }; K1 "
              f"{pa.launches}", flush=True)
        if pa.launches != 5 * REPICK_BPC * loop_calls:
            fail(f"(a) timed loop: K1 {pa.launches} != 10 x {loop_calls} calls")

        # (b) the card against the CPU, on rows of (a)'s own replays.
        prob_err, sep = check_kept("(b)", kept_a, cpu_probs)
        ties = 0
        for k, r in enumerate(REPICK_CPU_ROWS):
            ok, n = picks_agree(row_picks(cpu_rows[k]), row_picks(rows_a[r]), cpu_probs[k],
                                PROB_TOL)
            ties += n
            if not ok:
                fail(f"(b): row {r}: card {rows_a[r]} against the CPU {cpu_rows[k]}")
        print(f"[repick] (b) card vs CPU, rows {REPICK_CPU_ROWS.tolist()} of (a)'s replays: "
              f"outputs within {prob_err:.2e} (limit {PROB_TOL}), two rows at least {sep:.2e} "
              f"apart (limit {SEPARATION:.0e}); picks and detections within "
              f"{PICK_TOL_S} s ({ties} moved across a near-tie of the CPU's outputs); CPU "
              f"references {cpu_s:.1f} s", flush=True)

        # (c) int8 end to end.
        out_c = os.path.join(root, "int8")
        with kept_outputs({}) as kept_c:
            c = repick_in_process(["--archive", arch["int8"], "--out", out_c, "--variant",
                                   "int8", "--compile-gate", *geometry])
        i8_err, i8_sep = check_kept("(c)", kept_c, cpu_i8)
        wc = c["verdicts"]["worker"]
        gate = [x for x in c["lines"] if x.startswith("[repick] variant gate")]
        _, rows_c = catalog_of(out_c)
        per_row = (a["bytes"] / REPICK_EVENTS, c["bytes"] / REPICK_EVENTS)
        tol = aot._PARITY_TOL["int8"]["abs"]
        bad, ties_c, fp32_probs = [], 0, {}
        for ra, rc_ in zip(rows_a, rows_c):
            same, _ = picks_agree(row_picks(ra), row_picks(rc_), np.zeros((WINDOW, 3)), -1.0)
            if same:
                continue
            call = ra["row"] // REPICK_ROWS_PER_CALL
            if call not in fp32_probs:  # fp32's outputs of that call, for its near-ties
                lo = call * REPICK_ROWS_PER_CALL
                idc = np.arange(lo, lo + REPICK_ROWS_PER_CALL)
                x = store.row_batch_at(idc, epoch=0, idx=idc)["data"]
                out = engine._program(*engine._call_args(
                    x.reshape(REPICK_BPC, REPICK_BATCH, 3, WINDOW), None))
                fp32_probs[call] = out[MODEL].reshape(-1, WINDOW, 3).cpu().numpy()
            ok, n = picks_agree(row_picks(ra), row_picks(rc_),
                                fp32_probs[call][ra["row"] % REPICK_ROWS_PER_CALL], tol)
            ties_c += n
            if not ok:
                bad.append(ra["row"])
        print(f"[repick] {name_power} | (c) int8 archive, --variant int8: {wc['rows']} rows, "
              f"{wc['waveforms_per_sec']} waveforms/s, stage seconds {wc['stage_seconds']}; "
              f"{gate}; outputs of rows {REPICK_CPU_ROWS.tolist()} of its replays within "
              f"{i8_err:.2e} of the CPU's int8 weights on the same int8 rows (limit {PROB_TOL}), "
              f"two rows at least {i8_sep:.2e} apart; batch_infer_bytes per row "
              f"{per_row[1]:.0f} against (a)'s {per_row[0]:.0f}; picks against (a)'s: "
              f"{ties_c} moved across a near-tie (fp32 within {tol}), {len(bad)} rows disagree; "
              f"K1 {c['counts']['K1']} over {wc['program_calls']} calls (gate included)",
              flush=True)
        if (wc["rows"] != REPICK_EVENTS or len(rows_c) != REPICK_EVENTS
                or wc["compiles_after_warmup"] != 0 or not gate
                or not all(" ok " in g for g in gate)):
            fail(f"(c): int8 run {wc}, gate {gate}")
        if per_row[1] * 4 != per_row[0]:
            fail(f"(c): batch_infer_bytes per row {per_row} is not a quarter of (a)'s")
        if bad:
            fail(f"(c): int8 picks of rows {bad[:10]} disagree with fp32's")
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        # (d) two worker processes (started with the phase), worker 0
        # SIGKILLed after its first commit and relaunched, then the merge.
        d_run["thread"].join(REPICK_TIMEOUT_S)
        if d_run["error"] or "w0b" not in d_run:
            fail(d_run["error"] or "(d): worker 0 was not killed and relaunched in time")
        t0, launched, segs_at_kill = d_run["t0"], d_run["launched"], d_run["segs_at_kill"]
        wait_child(d_run["w1"], "(d) worker 1", log=os.path.join(out_d, "w1.log"))
        wait_child(d_run["w0b"], "(d) worker 0, relaunched", log=os.path.join(out_d, "w0.2.log"))
        d = repick_in_process(["--archive", arch["float32"], "--out", out_d, "--merge-only"])
        wall_d = time.perf_counter() - t0
        worker_start = os.path.getmtime(os.path.join(out_d, "unit_00001.seg_0000.jsonl")) - launched
        partition = chaos_partition_s(worker_start)
        vd = [log_verdicts(os.path.join(out_d, f)) for f in ("w0.2.log", "w1.log")]
        workers = [v for vs in vd for v in vs if v.get("role") == "worker"]
        dumps = k1_dumps(out_d)
        print(f"[repick] (d) 2 workers, worker 0 SIGKILLed after its first commit "
              f"({segs_at_kill} segments committed then) and relaunched: resumed with "
              f"{workers[0]['segments_skipped']} segments skipped; merged {d['verdicts']['merge']}"
              f"; byte-identical to (a): {catalog_of(out_d)[0] == blob_a}; K1 per surviving "
              f"process {[x['K1'] for x in dumps]}; worker 1's first commit "
              f"{worker_start:.1f} s after its launch; wall {wall_d:.1f} s", flush=True)
        if catalog_of(out_d)[0] != blob_a:
            fail("(d): the merged catalog differs from (a)'s")
        if (len(workers) != 2 or any(v["compiles_after_warmup"] != 0 for v in workers)
                or workers[0]["segments_skipped"] < 1):
            fail(f"(d): worker verdicts {workers}")
        if sorted(x["K1"] for x in dumps) != sorted(5 * REPICK_BPC * v["program_calls"]
                                                    for v in workers):
            fail(f"(d): K1 launches {dumps} != 10 x each worker's replays")

        # (e) the chaos fleet.
        out_e = os.path.join(root, "fleet")
        os.makedirs(out_e)
        env = dict(os.environ, SEIST_FAULT_REPICK_SLOW_MS=CHAOS_SLOW_MS, **CHAOS_LEASE_ENV)
        cmd = [sys.executable, "-c", SUPERVISOR_WRAPPER, out_e, REPICK_WRAPPER,
               "--archive", arch["float32"], "--out", out_e, "--workers", "3",
               "--lease-dir", os.path.join(out_e, "leases"), "--retries", "2",
               "--rejoin-delay-s", "1.0", "--timeout-s", str(REPICK_TIMEOUT_S - 30),
               "--compile-gate", *geometry,
               "--fault-env", f"0:SEIST_FAULT_BATCH_PARTITION_AFTER_S={CHAOS_PARTITION_AFTER_S}",
               "--fault-env", f"0:SEIST_FAULT_BATCH_PARTITION_FOR_S={partition:.1f}",
               "--fault-env", "1:SEIST_FAULT_BATCH_KILL_UNIT=1",
               "--fault-env", "2:SEIST_FAULT_BATCH_PREEMPT_UNIT=1"]
        t0 = time.perf_counter()
        sup = child(cmd, os.path.join(root, "supervisor.log"), env)
    finally:
        pa.pooled_attention_plain = real_plain
    k1 = a["counts"]["K1"] + c["counts"]["K1"]

    def finish() -> dict:
        """(e)'s end and checks, after phase 16 ran beside it."""
        try:
            wait_child(sup, "(e) supervise-repick", log=os.path.join(root, "supervisor.log"))
            wall_e = time.perf_counter() - t0
            v = [x for x in log_verdicts(os.path.join(root, "supervisor.log"))
                 if x.get("role") == "supervisor"][-1]
            fleet_workers = [x for f in sorted(glob.glob(os.path.join(out_e, "logs", "w*.log")))
                             for x in log_verdicts(f) if x.get("role") == "fleet-worker"]
            dumps = k1_dumps(out_e)
            same = sha256(os.path.join(out_e, "catalog.jsonl")) == sha256(
                os.path.join(out_a, "catalog.jsonl"))
            # The zombie's window: worker 0's first park against its unit's done
            # marker (a peer's reclaim), seconds after the supervisor's start.
            wall0 = time.time() - wall_e
            done0 = os.path.getmtime(os.path.join(out_e, "leases", "unit_00000.done.json")) - wall0
            parks = [line[:23] for line in open(os.path.join(out_e, "logs", "w0.01.log"))
                     if "parked" in line]
            park0 = (time.mktime(time.strptime(parks[0][:19], "%Y-%m-%d %H:%M:%S"))
                     + float("0." + parks[0][20:23]) - wall0) if parks else float("nan")
            print(f"[repick] (e) worker 0 first parked at {park0:.1f} s, its unit's done marker "
                  f"(a peer's reclaim) at {done0:.1f} s, the partition {partition:.1f} s",
                  flush=True)
            print(f"[repick] {name_power} | (e) chaos fleet, 3 workers (worker 0 partitioned "
                  f"{partition:.1f} s, worker 1 SIGKILLed and worker 2 SIGTERMed at their "
                  f"first lease): supervisor {v['ok']}, relaunches {v['relaunches']} (preempts "
                  f"{v['preempts']}, crashes {v['crashes']}), lease {v['lease']}, fence audit "
                  f"{v['fence_audit']}; sha256 equal to (a)'s: {same}; fleet wall {wall_e:.1f} s "
                  f"(supervisor's {v['wall_s']} s); K1 per surviving worker process "
                  f"{[x['K1'] for x in dumps]}", flush=True)
            if not (v["ok"] and same and v["lease"]["double_commits"] == 0
                    and v["lease"]["fence_rejects"] >= 1 and v["crashes"] >= 1
                    and v["preempts"] >= 1 and v.get("compiles_after_warmup") == 0):
                fail(f"(e): supervisor verdict {v}, catalog equal {same}")
            if any(x["K1"] % (5 * REPICK_BPC) or x["K1_bf16"] for x in dumps) or sorted(
                    x["K1"] for x in dumps) != sorted(5 * REPICK_BPC * x["program_calls"]
                                                      for x in fleet_workers):
                fail(f"(e): K1 launches {dumps} against the workers' replays")
        finally:
            if sup.poll() is None:
                sup.kill()
                sup.wait()
        print(f"[repick] main path: K1 {k1} launches in this process ((a) and (c)), "
              f"{sum(x['K1'] for x in k1_dumps(out_d) + dumps)} in the surviving worker "
              f"processes of (d) and (e); phase {time.perf_counter() - t_phase:.1f} s (with "
              f"phase 16 beside (e))", flush=True)
        return {"K1": k1, "K2": 0, "K3": 0, "K1_bf16": 0, "K2_bf16": 0}

    return {"finish": finish, "wall_s": time.perf_counter() - t_phase}


# ------------------------------------------------------------- phase 16
PREDICT_WRAPPER = """\
import atexit, json, sys
from seist_tpu_torch.ops import pooled_attention as pa

def _plain_off_path(*a, **k):
    raise AssertionError("pooled_attention_plain reached on the predict path")

pa.pooled_attention_plain = _plain_off_path

def _dump():
    with open(sys.argv[1], "w") as f:
        json.dump({"K1": pa.launches, "K1_bf16": pa.bf16_launches}, f)

atexit.register(_dump)
from seist_tpu_torch.__main__ import main
main(sys.argv[2:])
"""
PICK_TIE_TOL = 10 * PROB_TOL  # (b)'s near-tie: the CPU curve at the two samples
FINETUNE_BATCH = 4  # (d): the CPU's first step runs at this batch too
# (d) and (e): drop rates as phase 7's (the card's and the CPU's dropout and
# DropPath generators differ; the attention's counter hash does not).
ATTENTION_ONLY = dict(path_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0,
                      other_drop_rate=0.0)
REMAT_LOSS_RTOL = 1e-6


@contextlib.contextmanager
def plain_attention_off(what: str):
    """The plain attention patched to raise, for the card's runs."""
    real = pa.pooled_attention_plain

    def off_path(*a, **k):
        raise AssertionError(f"pooled_attention_plain reached on the {what} path")

    pa.pooled_attention_plain = off_path
    try:
        yield
    finally:
        pa.pooled_attention_plain = real


def csv_picks(path: str) -> Dict[str, List[int]]:
    """``predict``'s CSV as sample lists: P, S and detection onsets."""
    kinds = {"P": "ppk", "S": "spk", "detection": "det"}
    out: Dict[str, List[int]] = {"ppk": [], "spk": [], "det": []}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[kinds[row["kind"]]].append(int(row["sample"]))
    return out


def offline_picks_agree(card: Dict[str, List[int]], cpu: Dict[str, List[int]],
                        prob: np.ndarray) -> Tuple[bool, int, int]:
    """The card's picks against the CPU's: as many of each kind, each
    within PICK_TOL_S of the CPU's, or moved between two samples whose CPU
    curve values (ppk, spk, det channels) differ by at most PICK_TIE_TOL (a
    near-tie, phase 12's rule). Returns (agree, near-ties, largest move)."""
    ties, worst = 0, 0
    for kind, ch in (("ppk", 1), ("spk", 2), ("det", 0)):
        a, b = sorted(card[kind]), sorted(cpu[kind])
        if len(a) != len(b):
            return False, ties, worst
        for x, y in zip(a, b):
            worst = max(worst, abs(x - y))
            if abs(x - y) <= PICK_TOL_S * 50:
                continue
            if abs(float(prob[x, ch]) - float(prob[y, ch])) > PICK_TIE_TOL:
                return False, ties, worst
            ties += 1
    return True, ties, worst


def predict_check(work: str, weights: str, options: dict, n_shapes: int, meanwhile) -> dict:
    """(b): ``predict`` of phase 13's 10-minute record on the card (a child
    process under PREDICT_WRAPPER) and, meanwhile, on the CPU in this
    process, then ``meanwhile()`` (the phase's other parts) while the child
    runs; phase 13's thresholds (the CPU curve's PICK_QUANTILE)."""
    from seist_tpu_torch import predict

    rec = long_record(SEED)
    npz = os.path.join(work, "record.npz")
    np.savez(npz, data=rec.T)  # (C, L): predict transposes it back
    flags = ["--model-name", MODEL, "--checkpoint", weights, "--input", npz,
             "--window", str(WINDOW), "--batch-size", str(BATCH),
             "--ppk-threshold", repr(options["ppk_threshold"]),
             "--spk-threshold", repr(options["spk_threshold"]),
             "--det-threshold", repr(options["det_threshold"]),
             "--max-events", str(RECORD_EVENTS)]
    card_csv, cpu_csv = os.path.join(work, "card.csv"), os.path.join(work, "cpu.csv")
    counts_json = os.path.join(work, "predict_k1.json")
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", PREDICT_WRAPPER, counts_json, "predict",
                             *flags, "--output", card_csv], cwd=work, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cpu = predict.main(flags + ["--output", cpu_csv, "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        meanwhile()
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    card_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"predict on the card exited {proc.returncode}: {err[-2000:]}")
    with open(counts_json) as f:
        k1 = json.load(f)
    card, want = csv_picks(card_csv), csv_picks(cpu_csv)
    agree, ties, worst = offline_picks_agree(card, want, cpu["prob"])
    with open(card_csv, "rb") as f, open(cpu_csv, "rb") as g:
        same_bytes = f.read() == g.read()
    windows = len(stream_ops.window_offsets(RECORD, WINDOW, WINDOW // 2))
    replays = -(-windows // BATCH)
    print(f"[offline] (b) predict {MODEL}, {RECORD} samples ({windows} windows, --batch-size "
          f"{BATCH}): card {out.strip().splitlines()[-1]!r} within {card_s:.1f} s (a process, "
          f"beside (c)-(e)), CPU "
          f"in this process {cpu_s:.1f} s; P/S/detection rows card "
          f"{[len(card[k]) for k in ('ppk', 'spk', 'det')]} CPU "
          f"{[len(want[k]) for k in ('ppk', 'spk', 'det')]}, agree within {PICK_TOL_S} s or a "
          f"near-tie: {agree} ({ties} near-ties admitted, largest move {worst} samples), CSVs "
          f"byte-identical: {same_bytes}; K1 in the card's process {k1['K1']} ({replays} "
          f"replay(s) x {n_shapes}), plain attention never reached", flush=True)
    if not agree or not want["ppk"] or k1["K1"] != n_shapes * replays or k1["K1_bf16"]:
        fail("predict on the card differs from the CPU's, found no picks, or did not replay "
             "its program with K1")
    return {"K1": k1["K1"], "ties": ties}


def demo_check(work: str, weights: str, n_shapes: int) -> dict:
    """(c): ``demo`` of phase 5's first trace on the card against the CPU."""
    import importlib.util

    from seist_tpu_torch import demo

    npz = os.path.join(work, "trace.npz")
    np.savez(npz, data=traces(N_REQUESTS)[0])
    argv = ["--model-name", MODEL, "--checkpoint", weights, "--input", npz,
            "--in-samples", str(WINDOW), "--output-dir", os.path.join(work, "demo_out")]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    before = pa.launches
    with plain_attention_off("demo"):
        if has_mpl:
            card = demo.main(argv + ["--device", "cuda"])
            figure = all(os.path.getsize(p) > 0 for p in card["paths"])
        else:
            try:
                demo.main(argv + ["--device", "cuda"])
                fail("the demo did not raise without matplotlib")
            except ImportError as e:
                print(f"[offline] (c) the demo without matplotlib: ImportError: {e}", flush=True)
            card = demo.predict_trace(demo.get_args(argv + ["--device", "cuda"]))
            figure = None
    k1 = pa.launches - before
    cpu = demo.predict_trace(demo.get_args(argv + ["--device", "cpu"]))
    err = float(np.abs(card["preds"] - cpu["preds"]).max())
    forwards = 1 if has_mpl else 2
    print(f"[offline] (c) demo {MODEL} on phase 5's trace 0: card vs CPU probabilities "
          f"max_abs_err {err:.3e} (limit 1e-05); picks card {json.dumps(card['picks'])} CPU "
          f"{json.dumps(cpu['picks'])}; matplotlib on this machine: "
          f"{'yes' if has_mpl else 'no'}; figure written: {figure}; K1 {k1}", flush=True)
    if not err <= 1e-5 or (has_mpl and not figure) or k1 != n_shapes * forwards:
        fail("the demo on the card differs from the CPU, wrote no figure, or missed K1")
    return {"K1": k1}


@contextlib.contextmanager
def record_first_step(first: dict):
    """The train worker's captured step, with its first call's batch kept
    (on the host) in ``first``."""
    real = worker.capture_train_step

    def capture(step):
        run = real(step)

        def rec(state, inputs, targets, rng, keep_outputs=False):
            if not first:
                first.update(x=inputs.detach().cpu().clone(), y=targets.detach().cpu().clone())
            return run(state, inputs, targets, rng, keep_outputs=keep_outputs)

        rec.graphs = run.graphs
        return rec

    worker.capture_train_step = capture
    try:
        yield first
    finally:
        worker.capture_train_step = real


@contextlib.contextmanager
def model_overrides(**kw):
    """``api.create_model`` with ``kw`` (the train worker builds its model
    through it)."""
    real = api.create_model

    def create(name, *a, **k):
        return real(name, *a, **{**kw, **k})

    api.create_model = create
    try:
        yield
    finally:
        api.create_model = real


def finetune_check(weights: str, n_shapes: int) -> dict:
    """(d): ``train --checkpoint W.pt --mode train`` from the imported
    weights alone, one epoch of phase 6's events at batch FINETUNE_BATCH,
    and its first step against the same step on the CPU."""
    run_dir = os.path.splitext(weights)[0]
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = list(TRAIN_ARGS)
    argv[argv.index("--batch-size") + 1] = str(FINETUNE_BATCH)
    argv += ["--mode", "train", "--checkpoint", weights, "--use-tensorboard", "false"]
    first: dict = {}
    with record_first_step(first), model_overrides(**ATTENTION_ONLY):
        best, counts, wall_s, lines = run_entry(argv)
    losses = np.load(os.path.join(run_dir, "train_losses.npy"))
    steps = len(losses)
    started = [x for x in lines if x.startswith(f"Resumed from {weights} (epoch 0, batch offset "
                                                "0, loss inf, update step 0)")]
    no_opt = [x for x in lines if "has no optimizer state; loading params only" in x]
    record = torch.load(state_path_for(best), map_location="cpu", weights_only=True)
    model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED, **ATTENTION_ONLY)
    model.load_state_dict(torch.load(weights, map_location="cpu", weights_only=True))
    state = TrainState(model, build_optimizer("adam", model.parameters()), constant(1e-3))
    loss, _, _ = make_train_step(taskspec.make_loss(MODEL))(
        state, first["x"], first["y"], step_random_source(SEED, 0, 0, "cpu"))
    rel = abs(float(losses[0]) - float(loss)) / abs(float(loss))
    print(f"[offline] (d) train --checkpoint {os.path.basename(weights)} --mode train, one "
          f"epoch at b{FINETUNE_BATCH}: {steps} steps in {wall_s:.1f} s, log dir {run_dir}; "
          f"'no optimizer state' logged: {bool(no_opt)}; started at epoch 0, batch 0, update "
          f"step 0: {bool(started)}; best checkpoint {os.path.basename(best)} at update "
          f"{record['step']}; first step's loss {float(losses[0]):.7f} vs the CPU's "
          f"{float(loss):.7f} from the same weights and batch (rel {rel:.2e}, limit 1e-04); "
          f"K1 {counts['K1']}, K2 {counts['K2']}", flush=True)
    if (not no_opt or not started or rel > 1e-4 or record["step"] > steps
            or counts["K2"] != n_shapes * steps or counts["K1"] % n_shapes
            or counts["K1"] <= counts["K2"] or not np.isfinite(losses).all()):
        fail("the fine-tune from the weights alone did not start from step 0 or its first "
             "step differs from the CPU's")
    return counts


def remat_check(flat: str, dev, n_shapes: int) -> dict:
    """(e): one captured b64 train step, drop rates 0.3, with and without
    ``use_checkpoint``, from the same weights, batch and randomness."""
    loss_fn = taskspec.make_loss(MODEL)
    g = torch.Generator().manual_seed(SEED + 16)
    x = torch.randn(TRAIN_BATCH, WINDOW, 3, generator=g).to(dev)
    y = torch.rand(TRAIN_BATCH, WINDOW, 3, generator=g).to(dev)
    runs = {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = api.create_model(MODEL, in_samples=WINDOW, seed=SEED, use_checkpoint=remat)
        model.load_state_dict(torch.load(flat, map_location="cpu", weights_only=True))
        state = TrainState(model.to(dev), build_optimizer("adam", model.parameters()),
                           constant(1e-4))
        step = capture_train_step(make_train_step(loss_fn))
        before = pa.counts()
        loss, _, diag = step(state, x, y, step_random_source(SEED, 0, 0, dev))
        torch.cuda.synchronize()
        launches = tuple(b - a for a, b in zip(before, pa.counts()))
        graph = next(iter(step.graphs.by_key.values()))
        runs[remat] = {
            "loss": float(loss), "applied": bool(diag["applied"]), "launches": launches,
            "per_replay": graph.launches[:2],
            "grads": {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()},
            "zero": set(model.zero_grad_parameters()),
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "capture_s": step.graphs.capture_seconds[0]}
        del state, step, graph, model
    off, on = runs[False], runs[True]
    rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    gscale = max(float(v.abs().max()) for v in off["grads"].values())
    worst_cos, worst_rel = 1.0, 0.0
    for k, go in off["grads"].items():
        gn = on["grads"][k]
        if k in off["zero"]:
            if max(float(go.abs().max()), float(gn.abs().max())) >= ZERO_REL * gscale:
                fail(f"(e) {k}: gradient should be ~0")
            continue
        cos = float((gn * go).sum() / (gn.norm() * go.norm()))
        worst_cos = min(worst_cos, cos)
        worst_rel = max(worst_rel, float((gn - go).abs().max() / max(float(go.abs().max()),
                                                                      1e-12)))
    print(f"[offline] (e) {MODEL} b{TRAIN_BATCH} captured train step, drop rates 0.3, "
          f"use_checkpoint on vs off: loss {on['loss']:.8f} vs {off['loss']:.8f} (rel {rel:.2e}, "
          f"limit {REMAT_LOSS_RTOL:.0e}); gradients worst cosine {worst_cos:.7f} (limit "
          f"{GRAD_COS}), worst rel err {worst_rel:.2e} (limit {GRAD_REL:.0e}); K1/K2 per replay "
          f"{on['per_replay']} vs {off['per_replay']}, over the call {on['launches'][:2]} vs "
          f"{off['launches'][:2]}; peak memory above what was allocated before (capture and "
          f"step) {on['peak_gib']:.2f} GiB vs {off['peak_gib']:.2f} GiB; capture "
          f"{on['capture_s']:.2f} s vs {off['capture_s']:.2f} s", flush=True)
    if (not on["applied"] or not off["applied"] or rel > REMAT_LOSS_RTOL
            or worst_cos < GRAD_COS or worst_rel > GRAD_REL):
        fail("(e) the rematerialised step differs from the plain one")
    for r, recompute in ((off, 0), (on, 1)):
        check_launches({"K1": r["launches"][0], "K2": r["launches"][1], "K3": 0}, n_shapes,
                       forwards=1, steps=1, recomputes=recompute)
    return {"K1": off["launches"][0] + on["launches"][0],
            "K2": off["launches"][1] + on["launches"][1]}


def offline_phase(weights: str, flat: str, options: dict, n_shapes: int, dev) -> dict:
    """Phase 16 (module docstring); (a) ran before phase 5."""
    work = os.path.join(str(_kernels.BUILD_DIR), "offline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rest = {}

    def meanwhile() -> None:  # (c)-(e) while predict's process runs
        rest.update(demo=demo_check(work, weights, n_shapes), tune=finetune_check(weights, n_shapes),
                    remat=remat_check(flat, dev, n_shapes))

    predicted = predict_check(work, weights, options, n_shapes, meanwhile)
    demoed, tuned, remat = rest["demo"], rest["tune"], rest["remat"]
    return {"counts": {"K1": predicted["K1"] + demoed["K1"] + tuned["K1"] + remat["K1"],
                       "K2": tuned["K2"] + remat["K2"], "K3": 0, "K1_bf16": 0, "K2_bf16": 0},
            "predict_K1": predicted["K1"]}


# ------------------------------------------------------------------ phase 17
DIST_STEPS = 3  # (c) and (d): train steps per run
DIST_BATCH = 8  # (c) and (d): one data rank's batch
DIST_CHILD_TIMEOUT_S = 300  # each multi-rank child; expiry kills them all and fails
# (c) and (d): the train entry at b8 over 64 synthetic events (51 train, x2
# by augmentation -> 12 steps of 8; 6 val and 7 test events, one padded
# batch each), the depth cut from TRAIN_ARGS' 256 events.
DIST_TRAIN_ARGS = TRAIN_ARGS + ["--mode", "train_test", "--batch-size", str(DIST_BATCH),
                                "--synthetic-events", "64", "--use-tensorboard", "false"]
DIST_TRAIN_STEPS, DIST_EVAL_BATCHES = 12, 2
ALL_DROPS = dict(path_drop_rate=0.3, attn_drop_rate=0.3, key_drop_rate=0.3, mlp_drop_rate=0.3,
                 other_drop_rate=0.3)
# A child of phase 17: the plain attention patched to raise, its attention
# launches and its graph captures written to argv[1] at exit; argv[2]
# "train" runs the train entry on argv[3:], "check" the step check
# (seist_tpu_torch/parallel/check.py) on the spec argv[3].
DIST_WRAPPER = """\
import atexit, json, sys
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.train import graph

def _plain_off_path(*a, **k):
    raise AssertionError("a plain attention version reached on the multi-rank path")

pa.pooled_attention_plain = pa.pooled_attention_bwd_plain = _plain_off_path
captures = [0]
_init = graph.Captured.__init__

def _counted(self, *a, **k):
    _init(self, *a, **k)
    captures[0] += 1

graph.Captured.__init__ = _counted

def _dump():
    with open(sys.argv[1], "w") as f:
        json.dump(dict(zip(("K1", "K2", "K1_bf16", "K2_bf16"), pa.counts()),
                       captures=captures[0]), f)

atexit.register(_dump)
if sys.argv[2] == "train":
    from seist_tpu_torch.__main__ import main
    main(sys.argv[2:])
else:
    from seist_tpu_torch.parallel.check import main
    sys.exit(main(sys.argv[3:]))
"""


def pid0_check(shapes, dev) -> Dict[str, float]:
    """(a) K1 and K2 with ``pid0 = 4*H`` on rows 4-7 of a b8 batch against
    rows 4-7 of the ``pid0 = 0`` b8 run (the rows a second data rank
    holds) and against the plain version with the same offset, within
    phases 3-4's limits, at the first and last attention shapes; then with
    V and the upstream gradient the identity (L = M = E), where K1's
    output is the dropped probabilities and K2's dV their transpose: the same zeros as the b8 run's rows and
    the plain version's, and other zeros at ``pid0 = 0``. Returns the
    largest error per type."""
    worst = {}
    for name, dtype, tol, btol in (("fp32", torch.float32, FP32_TOL, BWD_FP32_TOL),
                                   ("bf16", torch.bfloat16, BF16_TOL, BWD_BF16_TOL)):
        errs = []
        for i, (l, m, h, e) in enumerate((shapes[0], shapes[-1], (32, 32, 3, 32))):
            q, k, v, g = qkvg(8, l, m, h, e, dtype, 1700 + i, dev)
            eye = i == 2
            if eye:
                v = g = torch.eye(e, dtype=dtype, device=dev).reshape(1, e, 1, e).expand(
                    8, e, h, e).contiguous()
            seed, pid0 = 1234 + i, 4 * h
            o, lse = kernel(q, k, v, 0.3, seed, with_lse=True)
            rows = [t[4:].contiguous() for t in (q, k, v, g)]
            o4, lse4 = kernel(*rows[:3], 0.3, seed, with_lse=True, pid0=pid0)
            p4, plse4 = plain(*rows[:3], 0.3, seed, with_lse=True, pid0=pid0)
            grads = kernel_bwd(q, k, v, g, o, lse, 0.3, seed)
            grads4 = kernel_bwd(*rows, o4, lse4, 0.3, seed, pid0)
            want4 = plain_bwd(*rows, o4, lse4, 0.3, seed, pid0)
            e_rows = max(max_err(o4, o[4:]), max_err(lse4, lse[4:]))
            e_plain = max(max_err(o4, p4), max_err(lse4, plse4))
            e_bwd = max(bwd_err(grads4, [t[4:] for t in grads]), bwd_err(grads4, want4))
            zeros = ""
            ok = e_rows <= tol and e_plain <= max(tol, LSE_TOL) and e_bwd <= btol
            if eye:
                unshifted = kernel(*rows[:3], 0.3, seed)
                dv4, dv = grads4[2], grads[2][4:]
                same = bool(torch.equal(o4 == 0, o[4:] == 0) and torch.equal(o4 == 0, p4 == 0)
                            and torch.equal(dv4 == 0, dv == 0))
                moved = not torch.equal(unshifted == 0, o4 == 0)
                frac = float((o4 == 0).float().mean())
                zeros = (f"; V and g the identity: dropout zeros identical to the b8 run's rows and "
                         f"the plain version's {same} (dropped {frac:.4f}), another pattern at "
                         f"pid0 0 {moved}")
                ok = ok and same and moved and 0.25 < frac < 0.35
            print(f"[dist] (a) {name} N=8 L={l} M={m} H={h} E={e} rate 0.3, rows 4-7 at pid0 "
                  f"{pid0}: vs the b8 run's rows {e_rows:.2e} (output bitwise "
                  f"{bool(torch.equal(o4, o[4:]))}), vs the plain version {e_plain:.2e}, "
                  f"gradients {e_bwd:.2e}{zeros}", flush=True)
            if not ok:
                fail(f"(a) {name}: K1/K2 with pid0 differ from the b8 run's rows or the plain "
                     "version")
            errs.append(max(e_plain, e_bwd))
        worst[name] = max(errs)
    return worst


def start_children(wrapper: str, args_per_rank: List[List[str]], env_per_rank: List[dict],
                   work: str, tag: str = "rank") -> Tuple[list, List[str]]:
    """Start one child per rank running ``wrapper`` (``python -c``) on its
    arguments, each with its log ``<tag><r>.log`` in ``work``; returns
    (processes, logs)."""
    root = str(Path(__file__).resolve().parent)
    procs, logs = [], []
    for r, (argv, env) in enumerate(zip(args_per_rank, env_per_rank)):
        logs.append(os.path.join(work, f"{tag}{r}.log"))
        env = dict(env, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen([sys.executable, "-c", wrapper] + argv, cwd=root,
                                          env=env, stdout=out, stderr=subprocess.STDOUT,
                                          text=True))
    return procs, logs


def wait_children(procs: list, logs: List[str], deadline: float) -> List[str]:
    """Wait for every child until ``deadline`` (monotonic), killing all on
    expiry or on a failure (which fails the phase, with the port's frames
    of the failing rank); returns their logs."""
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                with open(logs[r]) as f:
                    text = f.read()
                frames = [x for x in text.splitlines() if "seist_tpu_torch" in x and "File" in x]
                fail(f"rank {r} exited {p.returncode}; the port's frames:\n"
                     + "\n".join(frames[-40:]) + f"\n{text[-3000:]}")
    except subprocess.TimeoutExpired:
        fail("the ranks did not finish by their deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    return outs


def start_dist(args_per_rank: List[List[str]], env_per_rank: List[dict], work: str,
               tag: str) -> dict:
    """Start one child per rank (DIST_WRAPPER), its log and launch record
    named by ``tag``: a handle for :func:`finish_dist`."""
    counts = [os.path.join(work, f"counts_{tag}{r}.json") for r in range(len(args_per_rank))]
    procs, logs = start_children(DIST_WRAPPER, [[c] + argv for c, argv in
                                                zip(counts, args_per_rank)], env_per_rank, work,
                                 tag=f"{tag}_rank")
    return {"procs": procs, "logs": logs, "counts": counts, "t0": time.perf_counter()}


def finish_dist(handle: dict) -> Tuple[List[str], List[dict], float]:
    """Wait for a :func:`start_dist` group within DIST_CHILD_TIMEOUT_S
    (killing every one on expiry or on a failure): the ranks' stdouts,
    their launch records and the group's wall seconds."""
    outs = wait_children(handle["procs"], handle["logs"],
                         time.monotonic() + DIST_CHILD_TIMEOUT_S)
    records = []
    for path in handle["counts"]:
        with open(path) as f:
            records.append(json.load(f))
    return outs, records, time.perf_counter() - handle["t0"]


def rank_env(world: int, rank: int, port: int, backend: Optional[str]) -> dict:
    env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(world),
               PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    env.pop("DIST_BACKEND", None)
    if backend:
        env["DIST_BACKEND"] = backend
    return env


def start_nccl_one_rank(work: str) -> dict:
    """(b) phase 6's train run (``--mode train``) as one rank over NCCL,
    launched through the env contract."""
    return start_dist([["train"] + TRAIN_ARGS + ["--mode", "train", "--log-base",
                                                 os.path.join(work, "b_logs"),
                                                 "--use-tensorboard", "false"]],
                      [rank_env(1, 0, free_ports(1), None)], work, "b")


def check_nccl_one_rank(handle: dict, run: dict, n_shapes: int) -> dict:
    """(b): captured steps, its losses within RESUME_RTOL of phase 6's, K1 5
    per step and val batch, K2 5 per step."""
    outs, recs, wall = finish_dist(handle)
    m = re.search(r"log dir: (\S+)", outs[0])
    if m is None or "backend nccl" not in outs[0] or "run eagerly" in outs[0]:
        fail("(b) the one-rank run did not start an NCCL group with captured steps:\n"
             + outs[0][-2000:])
    losses = np.load(os.path.join(m.group(1), "train_losses.npy"))
    rel = max_rel(losses, run["losses"])
    counts = dict(recs[0], K3=0)
    print(f"[dist] (b) one rank over NCCL through COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID, "
          f"{MODEL} window {WINDOW} b{TRAIN_BATCH} drop rates 0.3: {len(losses)} steps, losses "
          f"{[round(float(x), 6) for x in losses]} vs phase 6's max rel {rel:.2e} (limit "
          f"{RESUME_RTOL:.0e}); {recs[0]['captures']} graph captures; K1 {counts['K1']}, K2 "
          f"{counts['K2']}; {wall:.1f} s (a process)", flush=True)
    if not rel <= RESUME_RTOL or recs[0]["captures"] < 2:
        fail("(b) the NCCL rank's captured run differs from phase 6's, or was not captured")
    check_launches(counts, n_shapes, TRAIN_STEPS + VAL_BATCHES, TRAIN_STEPS)
    return counts


def train_one_rank(n_shapes: int, work: str) -> dict:
    """The one-rank reference of the two-rank train entry: DIST_TRAIN_ARGS
    in this process, captured: its step losses and test loss."""
    best, counts, wall, _ = run_entry(DIST_TRAIN_ARGS + ["--log-base",
                                                         os.path.join(work, "train_ref")])
    run_dir = os.path.dirname(os.path.dirname(best))
    losses = np.load(os.path.join(run_dir, "train_losses.npy"))
    with open(os.path.join(run_dir, "test_metrics_synthetic.json")) as f:
        test_loss = json.load(f)["loss"]
    print(f"[dist] one rank (this process, captured): train_test b{DIST_BATCH}, "
          f"{len(losses)} steps, losses {[round(float(x), 6) for x in losses]}, test loss "
          f"{test_loss:.6f}; K1 {counts['K1']}, K2 {counts['K2']}; {wall:.1f} s", flush=True)
    check_launches(counts, n_shapes, DIST_TRAIN_STEPS + DIST_EVAL_BATCHES, DIST_TRAIN_STEPS)
    return {"losses": losses, "test_loss": test_loss, "counts": counts}


def start_train_two_ranks(backend: Optional[str], work: str, label: str) -> dict:
    """(c) or (d): the train entry itself on two ranks through the env
    contract, DIST_TRAIN_ARGS with ``--seq-shards 2`` (both ranks hold the
    same rows, every attention a ring)."""
    port = free_ports(1)
    logs = os.path.join(work, f"train_{label}")
    handle = start_dist(
        [["train"] + DIST_TRAIN_ARGS + ["--seq-shards", "2", "--log-base", logs]] * 2,
        [rank_env(2, r, port, backend) for r in range(2)], work, f"train_{label}")
    return dict(handle, logs_dir=logs)


def check_train_two_ranks(handle: dict, ref: dict, backend: Optional[str], label: str) -> dict:
    """(c) or (d): rank 0's step losses and the global test loss within
    RESUME_RTOL of one rank's, one run directory (rank 0's, broadcast)
    holding the test metrics file, the worker's byte-identical-parameters
    line, the steps captured under NCCL and eager under gloo, and no K1 or
    K2 launch (the ring's blocks are einsums)."""
    logs = handle["logs_dir"]
    outs, recs, wall = finish_dist(handle)
    runs = sorted(os.listdir(logs)) if os.path.isdir(logs) else []
    m = re.search(r"log dir: (\S+)", outs[0])
    if len(runs) != 1 or m is None or os.path.basename(m.group(1).rstrip("/")) != runs[0]:
        fail(f"({label}) the two ranks made run directories {runs} (rank 0's log dir "
             f"{m.group(1) if m else None}):\n{outs[0][-2000:]}")
    run_dir = os.path.join(logs, runs[0])
    metrics = os.path.join(run_dir, "test_metrics_synthetic.json")
    agreed = re.search(r"parameters byte-identical over 2 ranks \(sha256 (\w+)\)", outs[0])
    if agreed is None or not os.path.isfile(metrics):
        fail(f"({label}) no byte-identical-parameters line or no test metrics file in "
             f"{sorted(os.listdir(run_dir))}:\n{outs[0][-2000:]}")
    losses = np.load(os.path.join(run_dir, "train_losses.npy"))
    with open(metrics) as f:
        test_loss = json.load(f)["loss"]
    rel = max_rel(losses, ref["losses"])
    test_rel = abs(test_loss - ref["test_loss"]) / abs(ref["test_loss"])
    captures = [r["captures"] for r in recs]
    launches = {k: sum(r[k] for r in recs) for k in ("K1", "K2", "K1_bf16", "K2_bf16")}
    print(f"[dist] ({label}) train --seq-shards 2 on two ranks, {backend or 'nccl'}, "
          f"train_test b{DIST_BATCH}: {len(losses)} steps, rank 0's losses vs one rank's max "
          f"rel {rel:.2e}, test loss {test_loss:.6f} rel {test_rel:.2e} (limit "
          f"{RESUME_RTOL:.0e}); one run directory {runs[0]}; parameters byte-identical "
          f"(sha256 {agreed.group(1)}); graph captures per rank {captures}; launches "
          f"{launches}; {wall:.1f} s (two processes)", flush=True)
    if not rel <= RESUME_RTOL or not test_rel <= RESUME_RTOL:
        fail(f"({label}) the two-rank train entry differs from one rank")
    if (min(captures) < 2) if backend is None else any(captures):
        fail(f"({label}) graph captures per rank {captures} under {backend or 'nccl'}")
    if any(launches.values()):
        fail(f"({label}) attention kernels launched under --seq-shards 2: {launches}")
    return dict(launches, K3=0)


def dist_spec(work: str, backend_tag: str) -> str:
    spec = {"model": MODEL, "window": WINDOW, "device": "cuda", "seed": SEED,
            "out": None, "runs": [
                {"seq": 1, "global_batch": 2 * DIST_BATCH, "steps": DIST_STEPS,
                 "drop": ALL_DROPS},
                {"seq": 2, "global_batch": DIST_BATCH, "steps": DIST_STEPS, "drop": ALL_DROPS}]}
    path = os.path.join(work, f"spec_{backend_tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def start_two_ranks(spec_path: str, backend: Optional[str], work: str, label: str) -> dict:
    """(c) or (d): the spec's two runs (data 2 at b8 a rank, then seq 2 at
    b8) on two ranks."""
    port = free_ports(1)
    return start_dist([["check", spec_path]] * 2,
                      [rank_env(2, r, port, backend) for r in range(2)], work, f"check_{label}")


def check_two_ranks(handle: dict, refs: List[dict], backend: Optional[str], n_shapes: int,
                    label: str) -> dict:
    """(c) or (d) against ``refs`` (one rank at b16 and at b8 on the same
    rows): losses within RESUME_RTOL, every rank's parameters
    byte-identical after the last step, K1 and K2 on the data-parallel run
    only (the ring's blocks are einsums)."""
    outs, recs, wall = finish_dist(handle)
    lines = [json.loads(x) for x in outs[0].splitlines() if x.startswith('{"run"')]
    if len(lines) != 2:
        fail(f"({label}) rank 0 printed {len(lines)} run records:\n{outs[0][-2000:]}")
    for line, ref in zip(lines, refs):
        rel = max_rel(np.asarray(line["losses"]), np.asarray(ref["losses"]))
        same = len(set(line["checksums"])) == 1
        print(f"[dist] ({label}) data {line['data']} x seq {line['seq']}, global batch "
              f"{line['global_batch']}, {backend or 'nccl'}, captured {line['captured']}: "
              f"losses {[round(x, 6) for x in line['losses']]} vs one rank's max rel "
              f"{rel:.2e} (limit {RESUME_RTOL:.0e}); parameters byte-identical over the ranks "
              f"{same} ({line['checksums'][0][:16]}); rank 0's launches {line['launches']}",
              flush=True)
        if not rel <= RESUME_RTOL or not same:
            fail(f"({label}) two ranks differ from one, or from each other")
    dp, sp = lines[0]["launches"], lines[1]["launches"]
    if (dp["K1"] != n_shapes * DIST_STEPS or dp["K2"] != n_shapes * DIST_STEPS
            or sp["K1"] or sp["K2"]):
        fail(f"({label}) attention launches: data-parallel {dp}, ring {sp}")
    total = {k: sum(r[k] for r in recs) for k in ("K1", "K2", "K1_bf16", "K2_bf16")}
    print(f"[dist] ({label}) both ranks' launches {total}, {sum(r['captures'] for r in recs)} "
          f"graph captures; {wall:.1f} s (two processes)", flush=True)
    return dict(total, K3=0)


def dist_phase(run: dict, n_shapes: int, shapes, dev) -> dict:
    """Phase 17: (a) the kernels' batch offset, (b) one NCCL rank captured,
    (c) two gloo ranks on this card, (d) two NCCL ranks on two cards when
    there are two."""
    from seist_tpu_torch.parallel import check as pcheck

    work = os.path.join(str(_kernels.BUILD_DIR), "dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    errs = pid0_check(shapes, dev)
    spec_path = dist_spec(work, "ref")
    with open(spec_path) as f:
        spec = json.load(f)
    # (b) and (c)'s five children start together, beside this process's
    # one-rank references.
    groups = []
    try:
        groups.append(start_nccl_one_rank(work))
        groups.append(start_two_ranks(spec_path, "gloo", work, "c"))
        groups.append(start_train_two_ranks("gloo", work, "c"))
        refs = []
        for one in spec["runs"]:
            one = dict(one, seq=1)
            ref = pcheck.run_steps(spec, one, dev)
            refs.append({"losses": ref["losses"]})
            del ref
            torch.cuda.empty_cache()
        print(f"[dist] one rank (this process, captured): b{2 * DIST_BATCH} losses "
              f"{[round(x, 6) for x in refs[0]['losses']]}, b{DIST_BATCH} "
              f"{[round(x, 6) for x in refs[1]['losses']]}", flush=True)
        tref = train_one_rank(n_shapes, work)
        counts = [check_nccl_one_rank(groups[0], run, n_shapes), tref["counts"],
                  check_two_ranks(groups[1], refs, "gloo", n_shapes, "c"),
                  check_train_two_ranks(groups[2], tref, "gloo", "c")]
        ran = "(a), (b) and (c)"
        if torch.cuda.device_count() >= 2:
            groups.append(start_two_ranks(spec_path, None, work, "d"))
            counts.append(check_two_ranks(groups[-1], refs, None, n_shapes, "d"))
            groups.append(start_train_two_ranks(None, work, "d"))
            counts.append(check_train_two_ranks(groups[-1], tref, None, "d"))
            ran = "(a), (b), (c) and (d)"
    finally:
        for g in groups:
            for p in g["procs"]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print(f"[dist] phase 17 ran {ran} ({torch.cuda.device_count()} card(s) visible)",
          flush=True)
    total = {k: sum(c[k] for c in counts) for k in ("K1", "K2", "K1_bf16", "K2_bf16", "K3")}
    return {"counts": total, "errs": errs}


# ------------------------------------------------------------------ phase 18
DA_EVENTS = 40  # 32 train events (DA_RAW), x2 by augmentation: 64 samples
DA_RAW = DA_EVENTS * 8 // 10
DA_BATCH = 8  # (b): a data rank's batch, 4 steps; (a) and one rank: the global 16
DA_SPC = 4  # the cached runs' steps per call: one call
DA_DIRECT_BATCH = 32  # (c): a rank's batch on phase 6's pack: 6 steps
DA_PACK_SAMPLES = 408  # phase 6's float32 pack: 204 train events, x2 by augmentation
DA_ARGS = TRAIN_ARGS + ["--mode", "train", "--synthetic-events", str(DA_EVENTS),
                        "--use-tensorboard", "false"]
DA_CHILD_TIMEOUT_S = 300  # both children of (b)-(c); expiry kills them and fails
# A rank's processed rows against its rows of the one-rank batch: bitwise
# expected (the draws are keyed by sample, the ops are per row); where a
# reduction's kernel splits its rows otherwise at another batch size, phase
# 11's window limit.
DA_ROWS_TOL = 1e-5
# A child of phase 18: the plain versions patched to raise; for each run of
# the JSON list argv[1] (its env contract's address, argv, a file for the
# rows), cli.main with every count set to 0 first, the first processed
# batch's tensors (``check.first_processed_batch``), the cache's rows a
# rank, the graph captures and the launches recorded; the records written
# to argv[2] after each run.
DA_WRAPPER = """\
import json, os, sys
import torch
from seist_tpu_torch import cli
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.ops import pooled_attention as pa
from seist_tpu_torch.ops import threefry as tf
from seist_tpu_torch.parallel import check
from seist_tpu_torch.train import graph

def _off_path(*a, **k):
    raise AssertionError("a plain kernel version was reached on the multi-rank path")

pa.pooled_attention_plain = pa.pooled_attention_bwd_plain = tf.aug_draws_plain = _off_path
rows, captures = [], [0]
_cache = pipeline.DeviceEpochCache.__init__

def _noted(self, *a, **k):
    _cache(self, *a, **k)
    rows.append(self.rows)

pipeline.DeviceEpochCache.__init__ = _noted
_init = graph.Captured.__init__

def _counted(self, *a, **k):
    _init(self, *a, **k)
    captures[0] += 1

graph.Captured.__init__ = _counted
records = []
with open(sys.argv[1]) as f:
    runs = json.load(f)
for run in runs:
    os.environ["COORDINATOR_ADDRESS"] = run["address"]
    rows.clear()
    captures[0] = 0
    pa.launches = pa.bwd_launches = pa.bf16_launches = pa.bf16_bwd_launches = tf.launches = 0
    with check.first_processed_batch() as kept:
        best = cli.main(run["argv"])
    torch.save(kept[0], run["kept"])
    records.append({"label": run["label"], "best": best, "K1": pa.launches,
                    "K2": pa.bwd_launches, "K1_bf16": pa.bf16_launches,
                    "K2_bf16": pa.bf16_bwd_launches, "K3": tf.launches, "cache_rows": list(rows),
                    "captures": captures[0]})
    with open(sys.argv[2], "w") as f:
        json.dump(records, f)
"""


@contextlib.contextmanager
def one_rank_as_ranks(ranks: int, batch: int):
    """The train entry in this process under ``check.ranks_order``, its
    first processed batch kept (the list yielded: one list of CPU
    tensors)."""
    from seist_tpu_torch.parallel import check as pcheck

    real_order = pipeline._epoch_order
    pipeline._epoch_order = pcheck.ranks_order(ranks, batch)
    try:
        with pcheck.first_processed_batch() as kept:
            yield kept
    finally:
        pipeline._epoch_order = real_order


def da_reference(argv: List[str], label: str, n_shapes: int, steps: int, forwards: int,
                 ranks: int, batch: int, env: Optional[dict] = None) -> dict:
    """One run of the train entry in this process at the global batch (the
    ranks' rows side by side), captured; ``env`` (the env contract of one
    NCCL rank) is set around it. Its losses, first processed batch,
    launches (K3 one per step) and log."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with one_rank_as_ranks(ranks, batch) as kept:
            best, counts, wall, lines = run_entry(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = np.load(os.path.join(os.path.dirname(os.path.dirname(best)), "train_losses.npy"))
    check_launches(counts, n_shapes, forwards, steps, k3=steps)
    print(f"[dist18] {label}: {len(losses)} losses {[round(float(x), 6) for x in losses]}; K1 "
          f"{counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}; {wall:.1f} s", flush=True)
    return {"losses": losses, "kept": kept[0], "counts": counts, "lines": lines}


def rows_gap(got: List[torch.Tensor], whole: List[torch.Tensor], lo: int, hi: int
             ) -> Tuple[bool, float]:
    """(bitwise, largest difference) of a rank's processed tensors against
    rows [lo, hi) of the one-rank batch's."""
    if len(got) != len(whole):
        return False, float("inf")
    same, gap = True, 0.0
    for g, w in zip(got, whole):
        w = w[lo:hi]
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, float("inf")
        same = same and torch.equal(g, w)
        if g.is_floating_point():
            gap = max(gap, float((g.double() - w.double()).abs().max()))
        elif not torch.equal(g, w):
            gap = float("inf")
    return same, gap


def start_ranks(runs: Dict[str, tuple], backend: Optional[str], work: str, tag: str):
    """Two children of DA_WRAPPER, each running ``runs`` in order on one
    rank (each run on a port of its own, ``--batch-size`` a rank); returns
    (processes, logs, the records' files)."""
    port = free_ports(len(runs))
    per_rank = []
    for r in range(2):
        listed = [{"label": label, "address": f"127.0.0.1:{port + i}",
                   "kept": os.path.join(work, f"kept_{tag}_{label}_{r}.pt"),
                   "argv": argv + ["--batch-size", str(b), "--log-base",
                                   os.path.join(work, f"{tag}_{label}")]}
                  for i, (label, (argv, b, _)) in enumerate(runs.items())]
        with open(os.path.join(work, f"runs_{tag}_{r}.json"), "w") as f:
            json.dump(listed, f)
        per_rank.append([os.path.join(work, f"runs_{tag}_{r}.json"),
                         os.path.join(work, f"records_{tag}_{r}.json")])
    envs = [rank_env(2, r, port, backend) for r in range(2)]
    for env in envs:
        env.pop("COORDINATOR_ADDRESS")  # each run sets its own
    procs, logs = start_children(DA_WRAPPER, per_rank, envs, work, tag=f"rank18{tag}_")
    return procs, logs, [x[1] for x in per_rank]


def check_ranks(runs: Dict[str, tuple], refs: Dict[str, dict], outs: List[str],
                records_files: List[str], backend: Optional[str], work: str, tag: str,
                n_shapes: int, val: int, name_power: str) -> List[dict]:
    """(b)-(d)'s checks of two ranks' runs against the one-rank references:
    one run directory, rank 0's losses within RESUME_RTOL, each rank's
    first processed rows within DA_ROWS_TOL (bitwise printed), K3 one per
    step a rank, K1 and K2 as the steps and the val batch need, graphs
    under NCCL and none under gloo, the cache's rows a rank, the
    byte-identical-parameters line. Returns the ranks' launch records."""
    records = []
    for path in records_files:
        with open(path) as f:
            records.append({x["label"]: x for x in json.load(f)})
    shas = re.findall(r"parameters byte-identical over 2 ranks \(sha256 (\w+)\)", outs[0])
    epochs = re.findall(r"Epoch 0: [^\n]*", outs[0])  # rank 0's, one a run, in order
    counts = []
    for i, (label, (argv, b, n)) in enumerate(runs.items()):
        recs = [records[r][label] for r in range(2)]
        run_dirs = sorted(os.listdir(os.path.join(work, f"{tag}_{label}")))
        losses = np.load(os.path.join(work, f"{tag}_{label}", run_dirs[-1], "train_losses.npy"))
        rel = max_rel(losses, refs[label]["losses"])
        rows = [rows_gap(torch.load(os.path.join(work, f"kept_{tag}_{label}_{r}.pt")),
                         refs[label]["kept"], r * b, (r + 1) * b) for r in range(2)]
        k3 = [x["K3"] for x in recs]
        cache = [x["cache_rows"] for x in recs]
        captures = [x["captures"] for x in recs]
        part = {"gloo": "(c)" if label == "direct" else "(b)"}.get(backend or "", "(d)")
        where = "two gloo ranks on this card" if backend else "two NCCL ranks on cuda:0-1"
        print(f"[dist18] {part} {name_power} | {where}, --device-aug {label}, b{b} a rank: "
              f"{n} steps ({len(losses)} losses), rank 0's losses vs one rank's at b{2 * b} max "
              f"rel {rel:.2e} (limit {RESUME_RTOL:.0e}); each rank's first processed rows vs its "
              f"rows of the one-rank batch: bitwise {[x[0] for x in rows]}, max difference "
              f"{max(x[1] for x in rows):.2e}; K3 per rank {k3} ({n} steps each); cache rows per "
              f"rank {cache}; graph captures {captures}; K1 {[x['K1'] for x in recs]}, K2 "
              f"{[x['K2'] for x in recs]}; rank 0: {epochs[i] if i < len(epochs) else None}",
              flush=True)
        if (len(run_dirs) != 1 or not rel <= RESUME_RTOL
                or not max(x[1] for x in rows) <= DA_ROWS_TOL):
            fail(f"{part} {label}: two ranks differ from one rank ({run_dirs})")
        if k3 != [n, n] or (any(captures) if backend else min(captures) < 2):
            fail(f"{part} {label}: K3 launches {k3} (want {n} a rank) or graph captures "
                 f"{captures} under {backend or 'nccl'}")
        for x in recs:
            check_launches(x, n_shapes, n + val, n, k3=n)
        want_rows = [[-(-DA_RAW // 2)]] * 2 if label == "cached" else [[], []]
        if cache != want_rows:
            fail(f"{part} {label}: cache rows per rank {cache}, want {want_rows}")
        counts += recs
    if len(shas) != len(runs):
        fail(f"{len(shas)} byte-identical-parameters lines for {len(runs)} runs")
    return counts


def start_device_aug_ranks(f32_pack: str) -> dict:
    """Phase 18's (b) and (c): two gloo ranks on this card, started during
    phase 17 (beside its own rank processes)."""
    work = os.path.join(str(_kernels.BUILD_DIR), "dist18")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    steps = 2 * DA_RAW // (2 * DA_BATCH)
    pack_steps = DA_PACK_SAMPLES // (2 * DA_DIRECT_BATCH)
    direct = packed_args(f32_pack) + ["--mode", "train", "--use-tensorboard", "false",
                                      "--device-aug", "step", "--ingest", "direct"]
    runs = {
        "step": (DA_ARGS + ["--device-aug", "step"], DA_BATCH, steps),
        "cached": (DA_ARGS + ["--device-aug", "cached", "--steps-per-call", str(DA_SPC)],
                   DA_BATCH, steps),
        "direct": (direct, DA_DIRECT_BATCH, pack_steps),
    }
    procs, logs, records = start_ranks(runs, "gloo", work, "gloo")
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])  # a failure before 18
    return {"work": work, "runs": runs, "procs": procs, "logs": logs, "records": records,
            "deadline": time.monotonic() + DA_CHILD_TIMEOUT_S, "t0": time.perf_counter()}


def device_aug_ranks_phase(started: dict, n_shapes: int, name_power: str) -> dict:
    """Phase 18 (module docstring): (b) and (c)'s two gloo ranks started
    during phase 17 (``start_device_aug_ranks``); (a) and the one-rank
    references run in this process while they train; (d) follows with two
    cards or more."""
    t0 = time.perf_counter()
    work, runs = started["work"], started["runs"]
    procs, logs, records = started["procs"], started["logs"], started["records"]
    steps, val = 2 * DA_RAW // (2 * DA_BATCH), 1  # one padded val batch a rank
    deadline = started["deadline"]
    try:
        refs = {}
        for label, (argv, b, n) in runs.items():
            refs[label] = da_reference(
                argv + ["--batch-size", str(2 * b), "--log-base", os.path.join(work, f"one_{label}")],
                f"one rank, {label}, b{2 * b} (the ranks' rows side by side)", n_shapes, n,
                n + val, 2, b)
        nccl = da_reference(
            runs["cached"][0] + ["--batch-size", str(2 * DA_BATCH), "--log-base",
                                 os.path.join(work, "a_cached")],
            "(a) one NCCL rank, cached, the exchange in the captured call", n_shapes, steps,
            steps + val, 2, DA_BATCH,
            env={"COORDINATOR_ADDRESS": f"127.0.0.1:{free_ports(1)}", "NUM_PROCESSES": "1",
                 "PROCESS_ID": "0", "LOCAL_RANK": "0"})
        a_wall = time.perf_counter() - t0
    finally:
        outs = wait_children(procs, logs, deadline)
    counts = [refs[k]["counts"] for k in refs] + [nccl["counts"]]
    # (a): one NCCL rank against the same run without a group.
    a_log = nccl["lines"]
    rel = max_rel(nccl["losses"], refs["cached"]["losses"])
    same, gap = rows_gap(nccl["kept"], refs["cached"]["kept"], 0, 2 * DA_BATCH)
    group = next((x for x in a_log if x.startswith("mesh:")), "")
    print(f"[dist18] (a) {name_power} | one NCCL rank (world 1), --device-aug cached "
          f"--steps-per-call {DA_SPC}, b{2 * DA_BATCH}: {group}; losses vs the same run without "
          f"a group max rel {rel:.2e} (limit {RESUME_RTOL:.0e}); the first call's processed rows "
          f"bitwise {same} (max difference {gap:.2e}, limit {DA_ROWS_TOL:.0e})", flush=True)
    if "backend nccl" not in group or any("run eagerly" in x for x in a_log):
        fail("(a) did not run one NCCL rank with captured steps")
    if not rel <= RESUME_RTOL or not gap <= DA_ROWS_TOL:
        fail("(a) the NCCL rank's cached run differs from the run without a group")
    counts += check_ranks(runs, refs, outs, records, "gloo", work, "gloo", n_shapes, val,
                          name_power)
    if "packed direct ingest:" not in outs[0]:
        fail("(c) rank 0 did not ingest the pack directly")
    ran = "(a), (b) and (c)"
    if torch.cuda.device_count() >= 2:
        both = {k: runs[k] for k in ("step", "cached")}
        procs, logs, records = start_ranks(both, None, work, "nccl")
        outs = wait_children(procs, logs, time.monotonic() + DA_CHILD_TIMEOUT_S)
        counts += check_ranks(both, refs, outs, records, None, work, "nccl", n_shapes, val,
                              name_power)
        ran = "(a), (b), (c) and (d)"
    wall = time.perf_counter() - t0
    print(f"[dist18] {name_power} | phase 18 ran {ran} ({torch.cuda.device_count()} card(s) "
          f"visible): {wall:.1f} s in this process ((a) and the references {a_wall:.1f} s, "
          f"beside the two gloo ranks, which started {t0 - started['t0']:.1f} s earlier, "
          f"during phase 17)", flush=True)
    total = {k: sum(c[k] for c in counts) for k in ("K1", "K2", "K1_bf16", "K2_bf16", "K3")}
    return {"counts": total}


def loss_gap_reading(n_shapes: int, name_power: str) -> None:
    """``chip_smoke.py --loss-gap``, a measurement outside the checks:
    phase 18 (b)'s ``--device-aug step`` run (two gloo ranks on this card
    against one rank at the global batch, the ranks' rows side by side)
    with its Adam, with SGD at the same learning rate and with SGD at a
    constant 0.05. For each, every step's relative loss gap (step 0's loss
    comes before any update: the forward alone, its BatchNorm sums taken
    per rank and then over the ranks), and, after the last step, the
    largest difference and the share of elements that differ, for the
    parameters and for BatchNorm's running statistics apart."""
    t0 = time.perf_counter()
    work = os.path.join(str(_kernels.BUILD_DIR), "loss_gap")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    steps = 2 * DA_RAW // (2 * DA_BATCH)
    step = DA_ARGS + ["--device-aug", "step"]
    runs = {"adam": (step, DA_BATCH, steps),
            "sgd": (step + ["--optim", "SGD"], DA_BATCH, steps),
            "sgd_lr0.05": (step + ["--optim", "SGD", "--use-lr-scheduler", "false",
                                   "--max-lr", "0.05"], DA_BATCH, steps)}
    procs, logs, _ = start_ranks(runs, "gloo", work, "gap")
    try:
        refs = {label: da_reference(
            argv + ["--batch-size", str(2 * b), "--log-base", os.path.join(work, f"one_{label}")],
            f"one rank, {label}, b{2 * b}", n_shapes, n, n + 1, 2, b)
            for label, (argv, b, n) in runs.items()}
    finally:
        wait_children(procs, logs, time.monotonic() + DA_CHILD_TIMEOUT_S)
    for label, (_, b, n) in runs.items():
        dirs = {}
        for who, base in (("one", f"one_{label}"), ("two", f"gap_{label}")):
            (run,) = os.listdir(os.path.join(work, base))
            dirs[who] = os.path.join(work, base, run)
        two = np.load(os.path.join(dirs["two"], "train_losses.npy")).astype(np.float64)
        one = refs[label]["losses"].astype(np.float64)
        gaps = np.abs(two - one) / np.abs(one)
        params = [torch.load(os.path.join(d, "checkpoints", f"model_{n}.pt"), map_location="cpu")
                  for d in (dirs["one"], dirs["two"])]
        seen = {kind: [0, 0, 0.0] for kind in ("parameters", "running statistics")}
        for k, v in params[0].items():
            if not v.is_floating_point():
                continue
            d = (v.double() - params[1][k].double()).abs()
            row = seen["running statistics" if ".running_" in k else "parameters"]
            row[0] += int((d > 0).sum())
            row[1] += d.numel()
            row[2] = max(row[2], float(d.max()))
        after = "; ".join(f"{kind}: largest difference {big:.6e}, {n} of {total} elements differ"
                          for kind, (n, total, big) in seen.items())
        print(f"[loss-gap] {name_power} | --device-aug step, {label}, two gloo ranks at b{b} "
              f"against one rank at b{2 * b}: losses one {one.tolist()}, two {two.tolist()}; "
              f"relative gap per step {gaps.tolist()} (loss moved {one[0] - one[-1]:.6e}); "
              f"after the last step, {after}", flush=True)
    print(f"[loss-gap] {name_power} | {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------- phase 19
ATTRIB_SMALL = 2  # (a): the step at b2, on the card and on the CPU
ATTRIB_REPLAYS = 3  # (b): profiled replays of the captured b64 step
PROFILE_STEP_STEPS = 3  # (c): `profile-step --steps`
ATTRIB_TOP = 8


def matmul_of(ops: List[dict]) -> int:
    return sum(r["flops"] for r in ops if r["class"] == "matmul")


def attribution_phase(weights: str, name_power: str, n_shapes: int, dev) -> dict:
    """Phase 19 (a)-(c): the b64 fp32 train step of seist_l_dpk (its drop
    rates 0.3, Adam, the guard) recorded by ``obs/attribution.py`` on the
    card, the same step at b2 on the card and on the CPU; ``python -m
    seist_tpu_torch profile-step`` (its entry, in this process: a child
    would spend its start) and its trace; the captured b64 step's kernels
    over ``ATTRIB_REPLAYS`` profiled replays and its attribution against
    that wall time."""
    from seist_tpu_torch.__main__ import main as port_main

    t0 = time.perf_counter()
    step = make_train_step(taskspec.make_loss(MODEL))

    def record(batch: int, device) -> List[dict]:
        state = _train_model(weights, device)
        x, y = (t.to(device) for t in make_batch(batch))
        return attribution.op_costs(
            lambda *a: step(*a, RandomSource.from_seed(batch, device)), (state, x, y))

    # (a) the analytic half.
    ops64, ops2, ops2_cpu = (record(TRAIN_BATCH, dev), record(ATTRIB_SMALL, dev),
                             record(ATTRIB_SMALL, "cpu"))
    mm64, mm2, mm2_cpu = matmul_of(ops64), matmul_of(ops2), matmul_of(ops2_cpu)
    basis = attribution.roofline("fp32")
    analytic = attribution.summarize(ops64, top_k=ATTRIB_TOP, **basis)
    kernels = {r["op"]: r["count"] for r in ops64 if r["op"].startswith("pooled_attention")}
    print(f"[attrib] {name_power} | {MODEL} window {WINDOW} train step b{TRAIN_BATCH} fp32 on "
          f"the card, recorded: flops_total {analytic['flops_total']}, bytes_total "
          f"{analytic['bytes_total']}, {analytic['n_op_kinds']} op kinds, arithmetic intensity "
          f"{analytic['arithmetic_intensity']}; kernels charged {kernels}; matmul FLOPs "
          f"b{TRAIN_BATCH} {mm64}, b{ATTRIB_SMALL} on the card {mm2}, on the CPU {mm2_cpu} "
          f"(b{TRAIN_BATCH} / b{ATTRIB_SMALL}: {mm64 / max(mm2, 1):.6f})", flush=True)
    for cname, c in analytic["mfu_decomposition"].items():
        print(f"[attrib]   class {cname}: flops {c['flops']} ({c['flops_frac']:.4f} of all), "
              f"modelled time share {c['time_frac']:.4f}", flush=True)
    print(f"[attrib]   top {ATTRIB_TOP} ops by modelled time (H100 basis: "
          f"{basis['hbm_bw'] / 1e12:.2f} TB/s, fp32 {basis['peak_flops'] / 1e12:.0f} TFLOP/s "
          f"on the CUDA cores; {name_power}):", flush=True)
    for r in analytic["top_ops"]:
        print(f"[attrib]     {r['op']} ({r['class']}, {r['bound']}): {r['count']} calls, "
              f"{r['flops']} flops, {r['bytes_accessed']} bytes, time share "
              f"{r['time_frac']:.4f}; e.g. {r['example']}", flush=True)
    if (mm2 != mm2_cpu or mm64 != TRAIN_BATCH // ATTRIB_SMALL * mm2
            or kernels != {"pooled_attention_fwd": n_shapes, "pooled_attention_bwd": n_shapes}):
        fail(f"the recorded matmul FLOPs are not the CPU's at b{ATTRIB_SMALL} ({mm2} against "
             f"{mm2_cpu}), or not linear in the batch ({mm64} at b{TRAIN_BATCH}), or K1/K2 were "
             f"not charged {n_shapes} times each ({kernels})")
    del ops2, ops2_cpu
    t_a = time.perf_counter() - t0

    # (c) profile-step, and the trace it wrote.
    trace_dir = os.path.join(str(_kernels.BUILD_DIR), "profile_step")
    shutil.rmtree(trace_dir, ignore_errors=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_main(["profile-step", "--batch", str(TRAIN_BATCH), "--steps",
                   str(PROFILE_STEP_STEPS), "--device", dev.type, "--out", trace_dir])
    table = attribution.kernels_in_trace(os.path.join(trace_dir, "trace.json"),
                                         calls=PROFILE_STEP_STEPS)
    t1, t2 = (attribution.launches_of(table, n) for n in ("fwd_kernel", "bwd_kernel"))
    t_c = time.perf_counter() - t0 - t_a
    print(f"[attrib] {name_power} | python -m seist_tpu_torch profile-step --batch {TRAIN_BATCH} "
          f"--steps {PROFILE_STEP_STEPS}: {t_c:.1f} s; its trace {table['bytes']} bytes, "
          f"{table['kernels']:g} kernels/step, K1 {t1:g} and K2 {t2:g} per step; its output:",
          flush=True)
    for line in out.getvalue().splitlines():
        print(f"[attrib]   | {line}", flush=True)
    if (t1, t2) != (n_shapes, n_shapes):
        fail(f"profile-step's trace lists K1 {t1} and K2 {t2} per step, not {n_shapes}")

    # (b) the measured half: the captured step (what the train worker runs).
    state = _train_model(weights, dev)
    x, y = (t.to(dev) for t in make_batch(TRAIN_BATCH))
    captured = capture_train_step(step)
    seeds = iter(range(1000, 1000 + ATTRIB_REPLAYS + 2))

    def replay() -> None:
        captured(state, x, y, RandomSource.from_seed(next(seeds), dev))

    replay()  # the capture
    measured = attribution.measured_kernels(replay, iters=ATTRIB_REPLAYS, top_k=ATTRIB_TOP)
    k1, k2, k2r = (attribution.launches_of(measured, n)
                   for n in ("fwd_kernel", "bwd_kernel", "reduce_slabs"))
    out = attribution.summarize(ops64, top_k=ATTRIB_TOP, measured_step_ms=measured["wall_ms"],
                                **basis)
    frac_sum = sum(c["time_frac"] for c in out["mfu_decomposition"].values())
    print(f"[attrib] {name_power} | the captured b{TRAIN_BATCH} step over {ATTRIB_REPLAYS} "
          f"profiled replays: wall {measured['wall_ms']:.3f} ms/step, device busy "
          f"{measured['busy_ms']:.3f} ms, idle share {measured['idle_share']:.3f}, "
          f"{measured['kernels']:g} kernels/step; K1 {k1:g} and K2 {k2:g} launches/step (K2's "
          f"row-split reduce {k2r:g}); mfu_model {out['mfu_model']} (flops_total at "
          f"{basis['peak_flops'] / 1e12:.0f} TFLOP/s fp32 over the wall), mfu_matmul_attributed "
          f"{out.get('mfu_matmul_attributed')}; est_ms per class "
          f"{ {c: d['est_ms'] for c, d in out['mfu_decomposition'].items()} } (time shares sum "
          f"{frac_sum:.4f})", flush=True)
    for line in attribution.kernel_lines(measured, "step"):
        print(f"[attrib]   {line}", flush=True)
    if (k1, k2) != (n_shapes, n_shapes) or not 0.0 < out["mfu_model"] <= 1.0 or abs(
            frac_sum - 1.0) > 1e-3:
        fail(f"the profiled replays list K1 {k1} and K2 {k2} launches per step (want "
             f"{n_shapes}), or mfu_model {out['mfu_model']} lies outside (0, 1], or the class "
             f"time shares sum to {frac_sum}")
    del state, captured, x, y, ops64
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[attrib] phase 19: (a) {t_a:.1f} s, (c) {t_c:.1f} s, (b) "
          f"{time.perf_counter() - t0 - t_a - t_c:.1f} s", flush=True)
    return {"analytic": analytic, "measured": measured}


# ------------------------------------------------------------- phase 20
REPEAT_BATCH = 16  # (a): the eager step made twice from one state
REPAIR_COST_LIMIT = 0.03  # (a): the repair's share of the captured b64 step, at most
REPAIR_ROUNDS = 8  # (a): rounds of none, repair, flag, flag, repair, none replays
STITCH_STRIDE = WINDOW // 2  # (a): /annotate's default stride
#: (b): the tool's default network at the smoke run's 60 s (its default is
#: 240 s), one driving worker: the associator then sees the picks in one
#: order, so two runs, on the card and on the CPU, give the same alerts.
TWIN_ARGS = ["--stations", "200", "--duration-s", "60", "--workers", "1"]
TWIN_TIE = 1e-4  # (b): a pick may differ only where the CPU's |z| lies this close to 4.5
TWIN_TIMEOUT_S = 300.0
# (b): the scenario through twinpick on the device argv[2], in a child
# process (one on the card, one on the CPU, beside each other); its alerts,
# gates, detail and counters to argv[1].
TWIN_CHILD = """\
import json, sys
from seist_tpu_torch import twin
args = twin.get_args(sys.argv[3:] + ["--device", sys.argv[2]])
stations, events, waves, expected = twin.build_scenario(args)
rounds = twin.make_schedule(args, stations)
service = twin._make_service(args)
try:
    run = twin.drive(args, service, stations, waves, rounds)
    stats = service.metrics()["stream"].get("twinpick", {})
finally:
    service.shutdown()
gates, detail = twin.evaluate(args, events, expected, run, stats)
with open(sys.argv[1], "w") as f:
    json.dump({"alerts": run["alerts"], "gates": gates, "detail": detail, "stats": stats,
               "run": {k: run[k] for k in ("packets", "windows", "wall_s")}}, f)
"""
# (c): the stream chaos lane's SIGKILL run with its replicas on the card;
# its gates and detail to argv[1].
CHAOS_CHILD = """\
import json, sys
from seist_tpu_torch import stream_chaos
gates, detail = stream_chaos.sigkill_run(sys.argv[2], "cuda")
print(stream_chaos.verdict_line("sigkill_station_heavy", gates, detail), flush=True)
with open(sys.argv[1], "w") as f:
    json.dump({"gates": gates, "detail": detail}, f)
"""


def make_batch(batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A seeded random batch (x, y) for ``batch`` traces on the CPU."""
    g = torch.Generator().manual_seed(batch)
    return torch.randn(batch, WINDOW, 3, generator=g), torch.rand(batch, WINDOW, 3, generator=g)


def eager_grads_twice(weights: str, step, x, y) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The parameter gradients of one eager step from phase 5's weights,
    made twice with the same batch and draws."""
    grads = []
    for _ in range(2):
        state = _train_model(weights, x.device)
        step(state, x, y, RandomSource.from_seed(7, x.device))
        grads.append({n: p.grad.detach().clone()
                      for n, p in state.model.named_parameters() if p.grad is not None})
    return tuple(grads)


def _linear_index_select(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``interpolate_linear`` before the repair: its backward is
    ``index_select``'s atomic ``index_add``."""
    from seist_tpu_torch.models import common

    l_in = x.shape[-2]
    if l_in == out_size:
        return x
    lo, hi, w = common._linear_taps(l_in, out_size, x.device, x.dtype)
    w = w[None, :, None]
    return x.index_select(1, lo) * (1.0 - w) + x.index_select(1, hi) * w


def _conv_autograd(self, x: torch.Tensor) -> torch.Tensor:
    """``Conv1d.forward`` before the repair: cuDNN's backward."""
    return F.conv1d(x.transpose(1, 2), self.weight, self.bias, self.stride, 0, self.dilation,
                    self.groups).transpose(1, 2)


@contextlib.contextmanager
def unrepaired(flag: bool = False):
    """The step as it was before the repair (the atomic ``index_add`` of
    ``interpolate_linear``'s backward and cuDNN's convolution backward),
    with ``torch.backends.cudnn.deterministic`` set to ``flag``: cuDNN's
    global flag, a diagnostic the port does not use."""
    from seist_tpu_torch.models import common

    real = common.interpolate_linear, common.Conv1d.forward
    common.interpolate_linear, common.Conv1d.forward = _linear_index_select, _conv_autograd
    torch.backends.cudnn.deterministic = flag
    try:
        yield
    finally:
        common.interpolate_linear, common.Conv1d.forward = real
        torch.backends.cudnn.deterministic = False


def repair_cost(weights: str, name_power: str) -> dict:
    """(a) The captured b64 fp32 step (drop rates 0.3, Adam, the guard) as
    three graphs from one state: the repair (the port as it is), no repair,
    and no repair under cuDNN's global deterministic flag. Their replays
    interleave, REPAIR_ROUNDS rounds of none, repair, flag, flag, repair,
    none (drift over the run cancels), each timed by CUDA events; the
    repair's median may exceed no repair's by REPAIR_COST_LIMIT at most."""
    dev = torch.device("cuda", 0)
    state = _train_model(weights, dev)
    x, y = (t.to(dev) for t in make_batch(TRAIN_BATCH))
    plain = make_train_step(taskspec.make_loss(MODEL))
    pa.set_counts((0, 0, 0, 0))
    steps = {}
    for name in ("none", "repair", "flag"):
        steps[name] = capture_train_step(plain)
        with (contextlib.nullcontext() if name == "repair" else unrepaired(name == "flag")):
            steps[name](state, x, y, RandomSource.from_seed(0, dev))  # captures
    torch.cuda.synchronize()
    ms = {name: [] for name in steps}
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(6 * REPAIR_ROUNDS)]
    order = ("none", "repair", "flag", "flag", "repair", "none") * REPAIR_ROUNDS
    for i, (name, (e0, e1)) in enumerate(zip(order, events)):
        e0.record()
        steps[name](state, x, y, RandomSource.from_seed(100 + i, dev))
        e1.record()
    torch.cuda.synchronize()
    for name, (e0, e1) in zip(order, events):
        ms[name].append(e0.elapsed_time(e1))
    # The median of each graph's replays: phase 20's children share the card
    # (their small kernels may delay one replay now and then).
    med = {k: float(np.median(v)) for k, v in ms.items()}
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    cost = med["repair"] / med["none"] - 1.0
    flag = med["flag"] / med["none"] - 1.0
    print(f"[repeat] {name_power} | (a) the captured b{TRAIN_BATCH} fp32 step, three graphs from "
          f"one state, {REPAIR_ROUNDS} rounds of none-repair-flag-flag-repair-none replays "
          f"(CUDA events), median (mean): none {med['none']:.3f} ({mean['none']:.3f}) ms, "
          f"repair {med['repair']:.3f} ({mean['repair']:.3f}) ms ({cost * 100:+.2f}%, limit "
          f"+{REPAIR_COST_LIMIT * 100:.0f}%), cuDNN's global deterministic flag without the "
          f"repair {med['flag']:.3f} ({mean['flag']:.3f}) ms ({flag * 100:+.2f}%); per replay "
          f"min/max none {min(ms['none']):.3f}/{max(ms['none']):.3f}, repair "
          f"{min(ms['repair']):.3f}/{max(ms['repair']):.3f}", flush=True)
    if cost > REPAIR_COST_LIMIT:
        fail(f"(a) the repair costs {cost * 100:.2f}% of the captured step")
    launches = (pa.launches, pa.bwd_launches)
    del steps, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": med, "cost": cost, "flag": flag, "launches": launches}


def stitch_twice(name_power: str) -> None:
    """(a) ``/annotate``'s path (``ops/stream.annotate``, combine 'mean')
    over phase 13's hour-long record on the card, twice: the stitched
    curves bitwise equal. The windows' probabilities come from a fixed
    elementwise picker on the card (the model's forward is not the
    question here); the same windows through the ``index_add_`` stitch it
    replaces are shown beside it."""
    dev = torch.device("cuda", 0)
    rec = long_record(13, HOUR)

    def apply_fn(x):
        z = torch.as_tensor(np.asarray(x), device=dev)
        p = torch.sigmoid(z[..., 0].abs() - 3.0)
        return torch.stack([1.0 - p, p, torch.sigmoid(z[..., 1].abs() - 3.0)], dim=-1)

    outs = [stream_ops.annotate(apply_fn, rec, window=WINDOW, stride=STITCH_STRIDE,
                                batch_size=BATCH, channel0="non", combine="mean")
            for _ in range(2)]
    same = np.array_equal(outs[0]["prob"], outs[1]["prob"])
    offsets = stream_ops.window_offsets(rec.shape[0], WINDOW, STITCH_STRIDE)
    windows = normalize(np.stack([rec[o:o + WINDOW] for o in offsets]), "std", axis=1)
    probs = apply_fn(windows.astype(np.float32))
    old = []
    for _ in range(2):
        pos = (torch.as_tensor(offsets, device=dev)[:, None]
               + torch.arange(WINDOW, device=dev)[None, :]).reshape(-1)
        acc = torch.zeros((rec.shape[0], 3), device=dev).index_add_(0, pos, probs.reshape(-1, 3))
        hits = torch.zeros((rec.shape[0],), device=dev).index_add_(
            0, pos, torch.ones_like(pos, dtype=torch.float32))
        old.append((acc / hits.clamp(min=1.0)[:, None]).cpu())
    print(f"[repeat] {name_power} | (a) /annotate's mean stitch of an hour ({HOUR} samples, "
          f"{len(offsets)} windows of {WINDOW}, stride {STITCH_STRIDE}) twice on the card: "
          f"bitwise equal {same}; the index_add_ stitch it replaces, twice on the same "
          f"windows: bitwise equal {torch.equal(old[0], old[1])}", flush=True)
    if not same:
        fail("(a) the mean stitch gave other bits on a second call")


def adam_run_twice(n_shapes: int, name_power: str, work: str) -> List[dict]:
    """(a) phase 18 (b)'s one-rank ``--device-aug step`` Adam run (b16,
    4 steps, K1 and K2 5 a step, K3 once) twice in this process: equal
    losses and equal bytes in the best checkpoint."""
    argv = DA_ARGS + ["--device-aug", "step", "--batch-size", str(2 * DA_BATCH)]
    runs, counts = [], []
    for i in range(2):
        best, c, wall, _ = run_entry(argv + ["--log-base", os.path.join(work, f"adam{i}")])
        run_dir = os.path.dirname(os.path.dirname(best))
        with open(best, "rb") as f:
            runs.append((np.load(os.path.join(run_dir, "train_losses.npy")), f.read(), wall))
        counts.append(c)
    (l0, b0, w0), (l1, b1, w1) = runs
    print(f"[repeat] {name_power} | (a) the one-rank --device-aug step Adam run twice "
          f"({w0:.1f} s, {w1:.1f} s): losses {l0.tolist()} and {l1.tolist()}, bitwise equal "
          f"{np.array_equal(l0, l1)}; best checkpoints ({len(b0)} bytes) byte-identical "
          f"{b0 == b1}; launches {counts[0]}", flush=True)
    if not (np.array_equal(l0, l1) and b0 == b1):
        fail("(a) one rank's captured Adam run did not repeat bit for bit")
    steps = 2 * DA_RAW // (2 * DA_BATCH)
    for c in counts:
        check_launches(c, n_shapes, steps + 1, steps, k3=steps)
    return counts


def twin_near_ties(waves: Dict[str, np.ndarray], window: int, stride: int
                   ) -> Dict[str, set]:
    """Per station, the samples where a window's z-score of channel 0 or 1
    lies within TWIN_TIE of twinpick's threshold 4.5 (on the station's
    whole waveform: what every station without dropped packets sees)."""
    out = {}
    for sid, w in waves.items():
        near = set()
        for o in stream_ops.window_offsets(w.shape[0], window, stride):
            z = np.abs(normalize(w[o:o + window][None], "std", axis=1)[0][:, :2])
            near.update(int(o + i) for i in np.nonzero((np.abs(z - 4.5) < TWIN_TIE).any(1))[0])
        out[sid] = near
    return out


def twin_alert_key(alert: dict) -> Tuple[str, tuple]:
    return alert["alert_id"], tuple((p["station"], p["t_s"]) for p in alert["picks"])


def twin_card_vs_cpu(name_power: str, card: dict, cpu: dict) -> dict:
    """(b) the twin with twinpick on the card (TWIN_ARGS): every gate; its
    alerts against the CPU's, the same ids and pick samples unless a pick
    sits on a near-tie of the CPU's |z| (printed)."""
    from seist_tpu_torch import twin

    args = twin.get_args(TWIN_ARGS)
    detail, run = card["detail"], card["run"]
    print(f"[twin] {name_power} | (b) twin, {args.stations} stations, {args.duration_s:.0f} s "
          f"at {args.fs} Hz, {args.workers} worker, twinpick on the card (a child process): "
          f"{run['packets']} packets, {run['windows']} windows, {len(card['alerts'])} alerts in "
          f"{run['wall_s']:.1f} s; gates {card['gates']}; p99 sample->alert "
          f"{detail['p99_sample_to_alert_ms']} ms (budget {args.p99_budget_ms:.0f} ms); "
          f"stages (p50/p99 ms) {detail['latency_stages_ms']}; mainshock covered "
          f"{detail['mainshock_stations_covered']}/{detail['mainshock_expected_stations']}; "
          f"stream counters {card['stats']}", flush=True)
    if not all(card["gates"].values()):
        fail(f"(b) the twin's gates on the card: {card['gates']}")
    got = [twin_alert_key(a) for a in card["alerts"]]
    want = [twin_alert_key(a) for a in cpu["alerts"]]
    diffs = sorted(set(got) ^ set(want))
    ties = {}
    if diffs:
        _, _, waves, _ = twin.build_scenario(args)
        ties = twin_near_ties(waves, args.window, args.window // 2)
    shared = {p for key in set(got) & set(want) for p in key[1]}

    def on_tie(key) -> bool:  # every pick of the alert the other run lacks sits on a near-tie
        return all(any(abs(round(t * args.fs) - s) <= 2 for s in ties.get(sid, ()))
                   for sid, t in set(key[1]) - shared)

    unexplained = [d for d in diffs if not on_tie(d)]
    print(f"[twin] (b) card vs the port on the CPU (a child, the same scenario): alerts "
          f"{len(got)} vs {len(want)}, the same ids and pick samples {got == want}; CPU gates "
          f"{all(cpu['gates'].values())}; differing alerts {len(diffs)} {diffs[:4]}, on a "
          f"near-tie (|z| within {TWIN_TIE} of 4.5) {len(diffs) - len(unexplained)}", flush=True)
    if unexplained or (not diffs and got != want):
        fail(f"(b) the card's alerts differ from the CPU's off a near-tie: {unexplained[:4]}")
    return {"p99": detail["p99_sample_to_alert_ms"], "stages": detail["latency_stages_ms"],
            "windows": run["windows"], "wall_s": run["wall_s"]}


def start_phase20_children() -> dict:
    """Phase 20's child processes, started before phase 19 and working
    beside phases 19-20: (b) the twin on the card and on the CPU, (c) the
    stream chaos lane. Each runs in a session of its own; whatever is still
    running when the script exits (a failure) is killed with all it
    started."""
    work = os.path.join(str(_kernels.BUILD_DIR), "phase20")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, outs = {}, {}
    for name, code, argv in (("twin_cuda", TWIN_CHILD, ["cuda"] + TWIN_ARGS),
                             ("twin_cpu", TWIN_CHILD, ["cpu"] + TWIN_ARGS),
                             ("chaos", CHAOS_CHILD, [os.path.join(work, "chaos")])):
        outs[name] = os.path.join(work, f"{name}.json")
        with open(os.path.join(work, f"{name}.log"), "w") as f:
            procs[name] = subprocess.Popen([sys.executable, "-c", code, outs[name]] + argv,
                                           cwd=root, env=env, stdout=f,
                                           stderr=subprocess.STDOUT, start_new_session=True)

    def stop() -> None:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    atexit.register(stop)
    return {"work": work, "procs": procs, "outs": outs, "stop": stop, "t0": time.perf_counter()}


def processes() -> str:
    """The machine's processes as /proc shows them (pid, state, threads,
    resident MiB, command), for a failure's report."""
    rows = []
    for d in sorted(glob.glob("/proc/[0-9]*"), key=lambda p: int(p.rsplit("/", 1)[1])):
        try:
            with open(os.path.join(d, "status")) as f:
                kv = dict(x.split(":", 1) for x in f.read().splitlines() if ":" in x)
            with open(os.path.join(d, "cmdline"), "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")[:160]
        except OSError:
            continue
        if not cmd:  # a kernel thread
            continue
        rss = int(kv.get("VmRSS", "0 kB").split()[0]) // 1024
        rows.append(f"{d.rsplit('/', 1)[1]} {kv.get('State', '?').strip()[:1]} "
                    f"{kv.get('Threads', '?').strip()} {rss} {cmd}")
    listening = []
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                listening += [int(x.split()[1].rsplit(":", 1)[1], 16)
                              for x in f.read().splitlines()[1:] if x.split()[3] == "0A"]
        except OSError:
            continue
    return ("\n[processes: pid state threads MiB command]\n" + "\n".join(rows)
            + f"\n[TCP ports listening] {sorted(set(listening))}")


def child_result(started: dict, name: str, what: str) -> dict:
    wait_child(started["procs"][name], what,
               log=os.path.join(started["work"], f"{name}.log"), note=processes)
    with open(started["outs"][name]) as f:
        return json.load(f)


def repeat_twin_phase(weights: str, name_power: str, n_shapes: int, started: dict) -> dict:
    """Phase 20: (a) bitwise repeatability of the train and stitch paths
    and the repair's cost in this process; (b) the twin on the card against
    the CPU and (c) the stream chaos lane's SIGKILL run, from the children
    ``start_phase20_children`` started before phase 19."""
    t0 = time.perf_counter()
    try:
        cost = repair_cost(weights, name_power)
        t_cost = time.perf_counter() - t0
        dev = torch.device("cuda", 0)
        step = make_train_step(taskspec.make_loss(MODEL))
        x, y = (t.to(dev) for t in make_batch(REPEAT_BATCH))
        pa.set_counts((0, 0, 0, 0))
        g0, g1 = eager_grads_twice(weights, step, x, y)
        eager = (pa.launches, pa.bwd_launches)
        n_params = len(list(api.create_model(MODEL, in_samples=WINDOW).parameters()))
        differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
        print(f"[repeat] {name_power} | (a) one eager b{REPEAT_BATCH} step twice from one "
              f"state, default settings (cuDNN's deterministic flag off, deterministic "
              f"algorithms off): {len(g0) - len(differ)} of {len(g0)} gradient leaves bitwise "
              f"equal ({n_params} parameters); differing {differ[:8]}", flush=True)
        if differ or len(g0) != n_params:
            fail(f"(a) {len(differ)} gradient leaves differ between two eager steps")
        del g0, g1
        if eager != (2 * n_shapes, 2 * n_shapes):
            fail(f"(a) two eager steps launched K1 and K2 {eager} times")
        replays = n_shapes * (3 + 6 * REPAIR_ROUNDS)  # each graph's capturing call replays once
        if cost["launches"] != (replays, replays):
            fail(f"(a) the timed graphs launched K1 and K2 {cost['launches']} times, not "
                 f"{replays}")
        counts = {"K1": eager[0] + replays, "K2": eager[1] + replays, "K3": 0, "K1_bf16": 0,
                  "K2_bf16": 0}
        stitch_twice(name_power)
        for c in adam_run_twice(n_shapes, name_power, started["work"]):
            for k in counts:
                counts[k] += c[k]
        t_a = time.perf_counter() - t0
        twin_res = twin_card_vs_cpu(name_power,
                                    child_result(started, "twin_cuda", "(b) the twin on the card"),
                                    child_result(started, "twin_cpu", "(b) the twin on the CPU"))
        chaos = child_result(started, "chaos", "(c) the stream chaos lane")
    finally:
        started["stop"]()
    det = chaos["detail"]
    print(f"[chaos] {name_power} | (c) the stream chaos lane on the card (three twin replicas "
          f"behind supervise-fleet, SIGKILL of replica {det['target_replica']} homing "
          f"{det['stations_on_target']} stations at its packet {det['kill_packet']}): gates "
          f"{chaos['gates']}; seist_stream_rehome_total {det['seist_stream_rehome_total']}, "
          f"re-homes {det['rehomes']}; SIGKILL to the relaunched replica probed ready "
          f"{det['relaunch_s']} s; mainshock alert ids {det['mainshock_ids']}; worst emissions "
          f"of one id {det['worst_emissions_per_id']}; fleet ready {det['fleet_ready_s']} s, "
          f"drive {det['drive_s']} s, lane {det['wall_s']} s", flush=True)
    if not all(chaos["gates"].values()):
        fail(f"(c) the chaos lane's gates: {chaos['gates']}; replicas at the end "
             f"{det.get('replicas_after')}\n[the fleet's stdout]\n{det.get('stdout_tail', '')}"
             f"\n[the fleet's stderr]\n{det.get('stderr_tail', '')}{processes()}")
    print(f"[repeat] phase 20: (a) {t_a:.1f} s in this process (the step's timing "
          f"{t_cost:.1f} s); (b) and (c) in children started {t0 - started['t0']:.1f} s "
          f"earlier, before phase 19; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"counts": counts, "cost": cost, "twin": twin_res, "chaos": det}


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
    marks = [t0]

    def lap(name: str) -> None:
        now = time.perf_counter()
        print(f"[phase-time] {name}: {now - marks[-1]:.1f} s (script {now - t0:.1f} s)",
              flush=True)
        marks.append(now)

    _kernels.build_all((KERNEL, KERNEL_BWD, KERNEL_K3))
    for name in (KERNEL, KERNEL_BWD, KERNEL_K3):
        print(f"[build] {name}: {_kernels.BUILD_SECONDS[name]:.2f} s "
              f"({_kernels.library_path(name).name})", flush=True)
        check_spills(name, _kernels.BUILD_LOGS.get(name, ""))
    print(f"[build] all three, in parallel: {time.perf_counter() - t0:.2f} s", flush=True)
    if sys.argv[1:] != ["--loss-gap"]:
        packs()  # the run's packs, made beside phases 3-8

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = api.create_model(MODEL, in_samples=WINDOW).attention_shapes(WINDOW)
    if sys.argv[1:] == ["--loss-gap"]:
        loss_gap_reading(len(shapes), name_power)
        return 0
    print(f"[shapes] {MODEL} window {WINDOW}: (L, M, H, E) per launch {shapes}", flush=True)
    errs = check_kernel(shapes, dev)
    bwd_abs = check_kernel_bwd(shapes, dev)
    lap("phases 2-4 (build, the kernels against their plain versions)")
    # The kernels' device times come first: once a CPU+CUDA profiler session
    # has traced graph replays (phase 6's --profile-steps capture, phase 8's
    # profiles), later CUDA-only traces of eager launches lose kernels on
    # this card (PR 8's phase 11 saw it for K3).
    ones = torch.ones(1024, device=dev)
    device_ms(lambda: ones.add_(1.0), attempts=10)  # the profiler's first traces
    rows = time_shapes(shapes, dev)
    rows64 = time_shapes(shapes, dev, n=TRAIN_BATCH, types=("bf16",))  # the train step's K1
    for r in rows + rows64:
        b_ms, b_by = bound_of(r["bytes_ms"], r["ops_ms"], r["tc_ms"])
        print(f"[time] {name_power} | N={r['N']} L={r['L']} M={r['M']} H={r['H']} "
              f"E={r['E']} {r['dtype']}: device ms: kernel {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}; per call: kernel "
              f"{r['call_ms']:.4f}, plain {r['call_plain_ms']:.4f}, sdpa "
              f"{r['call_library_ms']:.4f}; bound {b_ms:.5f} ms by {b_by} (bytes "
              f"{r['bytes_ms']:.5f}; ops at the {r['dtype']} peak {r['ops_ms']:.5f}, in "
              f"3xTF32 on the tensor cores {r['tc_ms']:.5f}); kernel "
              f"{'<=' if r['ms'] <= r['library_ms'] else '>'} sdpa", flush=True)
    bwd_rows = {}
    for name, dtype, ops_at in (("fp32", torch.float32, "on the fp32 CUDA cores"),
                                ("bf16", torch.bfloat16, "at the bf16 tensor-core peak")):
        bwd_rows[name] = time_bwd_shapes(shapes, dev, dtype)
        for r in bwd_rows[name]:
            b_ms, b_by = bound_of(r["bytes_ms"], r["ops_ms"], r["tc_ms"])
            print(f"[time-bwd] {name_power} | N={TRAIN_BATCH} L={r['L']} M={r['M']} "
                  f"H={r['H']} E={r['E']} {name} rate 0.3: device ms: kernel {r['ms']:.4f} "
                  f"(at rate 0 {r['ms0']:.4f}), plain {r['plain_ms']:.4f}, sdpa backward "
                  f"(rate 0) {r['library_ms']:.4f}; "
                  f"per call: kernel {r['call_ms']:.4f}, plain {r['call_plain_ms']:.4f}, sdpa "
                  f"backward {r['call_library_ms']:.4f}; bound {b_ms:.5f} ms by {b_by} (bytes "
                  f"{r['bytes_ms']:.5f}; ops {ops_at} {r['ops_ms']:.5f}, in 3xTF32 on the "
                  f"tensor cores {r['tc_ms']:.5f}); kernel at rate 0 "
                  f"{'<=' if r['ms0'] <= r['library_ms'] else '>'} sdpa backward", flush=True)
    lap("phase 8, the kernels' times")
    weights = os.path.join(str(_kernels.BUILD_DIR), f"{MODEL}_seed{SEED}.pt")
    seeded_weights(weights)
    # Phases 5 and 12-14 serve weights whose outputs follow the waveform,
    # imported from a reference-layout .pth (phase 16a); the train phases
    # and phase 15 start from the seeded ones.
    imported = imported_weights(weights)
    served_weights = imported["weights"]
    lap("phase 16a (import-pretrained)")
    served = serve_phase(served_weights, len(shapes))
    lap("phase 5")
    logs = os.path.join(str(_kernels.BUILD_DIR), "train_logs")
    mem_before_train = allocated_gib()
    trained = train_test_phase(logs, len(shapes), name_power)
    resumed = resume_phase(trained, len(shapes))
    bf16 = bf16_phase(logs, len(shapes), trained["best"], dev)
    packed = packed_phase(logs, len(shapes), trained)
    preempted = preempt_phase(len(shapes), trained, packed["f32"])
    grouped = grouped_entry_phase(logs, len(shapes), trained)
    path_counts = [trained["counts"], resumed["counts"], bf16["counts"], packed["counts"],
                   packed["counts_i8"], preempted["counts"], preempted["counts_resumed"],
                   grouped["counts"], grouped["counts_accum"]]
    lap("phases 6 and 9c (the train paths)")
    gpu_vs_cpu_step(weights)
    captured = captured_vs_eager(weights, dev)
    lap("phases 7 and 9")
    print(f"[memory] allocated on the card after gc: {mem_before_train:.3f} GiB before the "
          f"train runs, {allocated_gib():.3f} GiB after them and phase 9", flush=True)

    fwd = time_forward(served["entry"])
    for b, ms in fwd.items():
        print(f"[time] {name_power} | {MODEL} window {WINDOW} forward b{b} (its captured "
              f"program): {ms:.3f} ms", flush=True)
    prof = profile_forward(served["entry"])
    print(f"[profile] {name_power} | {MODEL} window {WINDOW} b{BATCH} (its captured program): wall "
          f"{prof['wall_ms']:.3f} ms/forward, device busy {prof['busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['kernels']:.0f} kernels/forward", flush=True)
    for line in attribution.kernel_lines(prof, "forward"):
        print(f"[profile]   {line}", flush=True)
    lat = served["server_latency_ms"]
    print(f"[time] {name_power} | /predict x{N_REQUESTS} concurrent: client p50 "
          f"{served['client_p50_ms']:.1f} ms p99 {served['client_p99_ms']:.1f} ms; "
          f"server p50 {lat['p50']:.1f} ms p99 {lat['p99']:.1f} ms", flush=True)
    served_launches = served["launches"]
    served_ref = {k: served[k] for k in ("ref0", "resp0", "refs", "n_shapes")}
    del served

    step_ms = {}
    for dtype in ("fp32", "bf16"):
        for batch in (TRAIN_BATCH, 256):
            for mode in ("captured",):
                run = time_train_step(weights, batch, dtype=dtype, captured=mode == "captured")
                if dtype == "fp32" and mode == "captured":  # what the train worker runs
                    step_ms[batch] = run["ms"]
                cap = (f", capture {run['capture_s']:.2f} s" if run["capture_s"] is not None
                       else "")
                print(f"[time] {name_power} | {MODEL} window {WINDOW} train step b{batch} "
                      f"{dtype} {mode} (forward, backward, Adam update, guard): "
                      f"{run['ms']:.2f} ms, peak memory {run['peak_gib']:.2f} GiB above the "
                      f"{run['before_gib']:.2f} GiB allocated before{cap}",
                      flush=True)
                if batch == TRAIN_BATCH and mode == "captured":
                    tp = profile_train_step(run)
                    print(f"[profile] {name_power} | {MODEL} train step b{batch} {dtype} {mode}: "
                          f"wall {tp['wall_ms']:.2f} ms/step, device busy {tp['busy_ms']:.2f} "
                          f"ms, idle share {tp['idle_share']:.3f}, {tp['kernels']:.0f} "
                          f"kernels/step", flush=True)
                    for line in attribution.kernel_lines(tp, "step"):
                        print(f"[profile]   {line}", flush=True)
                del run
                torch.cuda.empty_cache()

    lap("phase 8, the forward and the train step")
    loader_rows = loader_phase(name_power, step_ms)
    lap("phase 8, the loader")
    baseline_phase(name_power, logs, dev)
    lap("phase 10")
    augmented = device_aug_phase(name_power, logs, len(shapes), weights, dev, packed, step_ms,
                                 loader_rows)
    path_counts += augmented["counts"]
    lap("phase 11")
    programs = programs_phase(name_power, served_weights, len(shapes))
    path_counts.append(programs["counts"])
    lap("phase 12")
    streams = streams_phase(name_power, served_weights)
    path_counts.append(streams["counts"])
    lap("phase 13")
    gc.collect()
    torch.cuda.empty_cache()  # the replicas of phase 14 share the card
    fleet = fleet_phase(name_power, served_weights, served_ref)
    path_counts.append(fleet["counts"])
    lap("phase 14")
    gc.collect()
    torch.cuda.empty_cache()
    repicked = repick_phase(name_power, weights)
    lap("phase 15 (a)-(d), and (e)'s fleet started")
    gc.collect()
    torch.cuda.empty_cache()
    offline = offline_phase(served_weights, weights, streams["record_options"], len(shapes), dev)
    path_counts.append(offline["counts"])
    lap("phase 16, beside phase 15 (e)")
    repick_counts = repicked["finish"]()
    path_counts.append(repick_counts)
    lap("phase 15 (e), what was left of it")
    gc.collect()
    torch.cuda.empty_cache()
    da_ranks = start_device_aug_ranks(packed["f32"])  # phase 18's two ranks, beside phase 17
    dist = dist_phase(trained, len(shapes), shapes, dev)
    path_counts.append(dist["counts"])
    lap("phase 17, and phase 18's two ranks started")
    gc.collect()
    torch.cuda.empty_cache()
    ranks18 = device_aug_ranks_phase(da_ranks, len(shapes), name_power)
    path_counts.append(ranks18["counts"])
    lap("phase 18")
    gc.collect()
    torch.cuda.empty_cache()
    children20 = start_phase20_children()  # phase 20's (b) and (c), beside phases 19-20
    pa.set_counts((0, 0, 0, 0))
    attribution_phase(weights, name_power, len(shapes), dev)
    # (a)'s two recorded steps on the card, profile-step's capture, 3 warm
    # and 3 traced steps, and (b)'s capture, warm replay and profiled ones.
    attrib_counts = {"K1": pa.launches, "K2": pa.bwd_launches, "K3": 0, "K1_bf16": 0,
                     "K2_bf16": 0}
    want = len(shapes) * (2 + 1 + 3 + PROFILE_STEP_STEPS + 2 + ATTRIB_REPLAYS)
    if (attrib_counts["K1"], attrib_counts["K2"]) != (want, want):
        fail(f"phase 19 launched K1 {attrib_counts['K1']} and K2 {attrib_counts['K2']} times, "
             f"not {want}")
    path_counts.append(attrib_counts)
    lap("phase 19")
    gc.collect()
    torch.cuda.empty_cache()
    repeated = repeat_twin_phase(weights, name_power, len(shapes), children20)
    path_counts.append(repeated["counts"])
    lap("phase 20")

    fp32 = [r for r in rows if r["dtype"] == "fp32"]  # the serving path is fp32
    bf16_rows = [r for r in rows if r["dtype"] == "bf16"]
    k3 = augmented["k3"][TRAIN_BATCH]  # the train path's batch
    launches = {k: served_launches * (k == "K1") + sum(c[k] for c in path_counts)
                for k in ("K1", "K2", "K3", "K1_bf16", "K2_bf16")}
    print(f"[paths] serve: K1 {served_launches} launches; train_test: K1 "
          f"{trained['counts']['K1']}, K2 {trained['counts']['K2']}; resume: K1 "
          f"{resumed['counts']['K1']}, K2 {resumed['counts']['K2']}; bf16 train_test: K1 "
          f"{bf16['counts']['K1_bf16']}, K2 {bf16['counts']['K2_bf16']} (bf16 "
          f"kernels); packed train_test: K1 {packed['counts']['K1']}, K2 "
          f"{packed['counts']['K2']}; int8 pack train: K1 {packed['counts_i8']['K1']}, K2 "
          f"{packed['counts_i8']['K2']}; preempted: K1 {preempted['counts']['K1']}, K2 "
          f"{preempted['counts']['K2']}; resumed after it: K1 "
          f"{preempted['counts_resumed']['K1']}, K2 {preempted['counts_resumed']['K2']}; "
          f"--steps-per-call 2: K1 {grouped['counts']['K1']}, K2 {grouped['counts']['K2']}; "
          f"--grad-accum-steps 2: K1 {grouped['counts_accum']['K1']}, K2 "
          f"{grouped['counts_accum']['K2']}; device-aug (phase 11, six runs): K1 "
          f"{sum(c['K1'] for c in augmented['counts'])}, K2 "
          f"{sum(c['K2'] for c in augmented['counts'])}, K3 "
          f"{sum(c['K3'] for c in augmented['counts'])}; served programs (phase 12): K1 "
          f"{programs['counts']['K1']} (bf16 {programs['counts']['K1_bf16']}); long-record and "
          f"stream planes (phase 13): K1 {streams['counts']['K1']}; fleet (phase 14): K1 "
          f"{fleet['counts']['K1']} or more; re-picking (phase 15, this process): K1 "
          f"{repick_counts['K1']}; offline prediction, fine-tuning and remat (phase 16): "
          f"K1 {offline['counts']['K1']} (predict's process {offline['predict_K1']}), K2 "
          f"{offline['counts']['K2']}; several ranks (phase 17, (b)-(d) in their processes): "
          f"K1 {dist['counts']['K1']}, K2 {dist['counts']['K2']}; device augmentation on several "
          f"ranks (phase 18, this process and (b)-(c)'s): K1 {ranks18['counts']['K1']}, K2 "
          f"{ranks18['counts']['K2']}, K3 {ranks18['counts']['K3']}; where the time goes "
          f"(phase 19): K1 {attrib_counts['K1']}, K2 {attrib_counts['K2']}; repeatability "
          f"(phase 20): K1 {repeated['counts']['K1']}, K2 {repeated['counts']['K2']}, K3 "
          f"{repeated['counts']['K3']}; all paths: K1 "
          f"{launches['K1']} (bf16 "
          f"{launches['K1_bf16']}), K2 {launches['K2']} (bf16 {launches['K2_bf16']}), K3 "
          f"{launches['K3']}", flush=True)
    bounds = {}
    for kid, label, rs, ms_key, ops_at in (
            ("K1", "five fp32 b8 launches", fp32, "ms", "on the fp32 CUDA cores"),
            ("K1-bf16", "five bf16 b8 launches", bf16_rows, "ms", "at the bf16 tensor-core peak"),
            ("K1-bf16-b64", "five bf16 b64 launches", rows64, "ms",
             "at the bf16 tensor-core peak"),
            ("K2", "five fp32 b64 launches, rate 0.3", bwd_rows["fp32"], "ms",
             "on the fp32 CUDA cores"),
            ("K2-rate0", "five fp32 b64 launches, rate 0", bwd_rows["fp32"], "ms0",
             "on the fp32 CUDA cores"),
            ("K2-bf16", "five bf16 b64 launches, rate 0.3", bwd_rows["bf16"], "ms",
             "at the bf16 tensor-core peak"),
            ("K2-bf16-rate0", "five bf16 b64 launches, rate 0", bwd_rows["bf16"], "ms0",
             "at the bf16 tensor-core peak")):
        b_ms, o_ms, tc_ms = (sum(r[key] for r in rs) for key in ("bytes_ms", "ops_ms", "tc_ms"))
        bounds[kid] = bound_of(b_ms, o_ms, tc_ms)
        print(f"[sum] {name_power} | {kid} {label}: device ms kernel "
              f"{sum(r[ms_key] for r in rs):.4f}, plain {sum(r['plain_ms'] for r in rs):.4f}, "
              f"sdpa {sum(r['library_ms'] for r in rs):.4f}; bound {bounds[kid][0]:.5f} by "
              f"{bounds[kid][1]} (bytes {b_ms:.5f}; ops {ops_at} {o_ms:.5f}, in 3xTF32 on "
              f"the tensor cores {tc_ms:.5f}); kernel <= sdpa at "
              f"{sum(r[ms_key] <= r['library_ms'] for r in rs)} of {len(rs)} shapes",
              flush=True)
    print(json.dumps({"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_fwd.cu",
        "replaces": "seist_tpu/ops/pallas_attention.py:137",
        "launches": launches["K1"] - launches["K1_bf16"],
        "max_abs_err": errs["fp32"],
        "ms": sum(r["ms"] for r in fp32),
        "plain_ms": sum(r["plain_ms"] for r in fp32),
        "bound_ms": bounds["K1"][0],
        "bound_by": bounds["K1"][1],
        "library_ms": sum(r["library_ms"] for r in fp32),
    }, {
        "name": KERNEL_BWD,
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_bwd.cu",
        "replaces": "seist_tpu/ops/pallas_attention.py:155",
        "launches": launches["K2"] - launches["K2_bf16"],
        "max_abs_err": bwd_abs["fp32"],
        "ms": sum(r["ms"] for r in bwd_rows["fp32"]),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows["fp32"]),
        "bound_ms": bounds["K2"][0],
        "bound_by": bounds["K2"][1],
        "library_ms": sum(r["library_ms"] for r in bwd_rows["fp32"]),
    }, {
        "name": KERNEL + "_bf16",
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_fwd_bf16.cuh",
        "replaces": "seist_tpu/ops/pallas_attention.py:137",
        "launches": launches["K1_bf16"],
        "max_abs_err": errs["bf16"],
        "ms": sum(r["ms"] for r in bf16_rows),
        "plain_ms": sum(r["plain_ms"] for r in bf16_rows),
        "bound_ms": bounds["K1-bf16"][0],
        "bound_by": bounds["K1-bf16"][1],
        "library_ms": sum(r["library_ms"] for r in bf16_rows),
    }, {
        "name": KERNEL_BWD + "_bf16",
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/pooled_attention_bwd_bf16.cuh",
        "replaces": "seist_tpu/ops/pallas_attention.py:155",
        "launches": launches["K2_bf16"],
        "max_abs_err": bwd_abs["bf16"],
        "ms": sum(r["ms"] for r in bwd_rows["bf16"]),
        "plain_ms": sum(r["plain_ms"] for r in bwd_rows["bf16"]),
        "bound_ms": bounds["K2-bf16"][0],
        "bound_by": bounds["K2-bf16"][1],
        "library_ms": sum(r["library_ms"] for r in bwd_rows["bf16"]),
    }, {
        "name": KERNEL_K3,
        "route": "cuda",
        "source": "seist_tpu_torch/csrc/aug_draws.cu",
        "replaces": "seist_tpu/data/device_aug.py:169 (jax.random threefry draws, XLA code)",
        "launches": launches["K3"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
