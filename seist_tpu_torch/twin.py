"""Network digital twin: the streaming plane's acceptance harness (the
port's counterpart of ``tools/twin.py``).

It synthesizes a deterministic earthquake scenario from one seed: a
mainshock, then an Omori-law aftershock sequence, over a simulated station
network with noise stations, dropouts, late-burst deliveries and duplicated
packets. Every packet goes through ``ServeService.stream`` (admission, the
shed ladder, StationMux, MicroBatcher, StreamSession, Associator): the path
of a live ``POST /stream`` request, minus the socket.

The model is ``twinpick``, a deterministic outlier picker that is the same
for every batch shape. Windows reach it z-normalized, so its P probability
is ``clip(|z| - 4.5, 0, 1)`` on channel 0 (S: channel 1), as plain torch
ops on the service's device. A 256-sample window of Gaussian noise tops out
near 3.5 sigma and gives nothing; a triangular pulse peaks near 5.5 sigma
whatever its amplitude. So the twin knows which stations were handed a
pulse with intact timing, and gates on the network's behaviour:

* zero missed mainshock alerts: an alert back-projects to the mainshock's
  origin time, and the picks of all alerts cover every expected detector
  (less the ``min_stations - 1`` the associator cannot alert on);
* zero alert-tier sheds, dropped windows and degraded sessions;
* p99 sample-to-alert latency within its budget, with the per-stage
  breakdown (arrival -> due -> queue -> device -> pick -> association);
* the faults fired: duplicates deduplicated, sequence gaps counted.

    python -m seist_tpu_torch twin --smoke [--device cpu] [--output run.json]

Scenario, schedule and waveforms are numpy only: the same seed gives the
same bytes as ``tools/twin.py``. ``--output`` writes the result JSON (the
JAX tool's keys) only when a path is given. Exit 0 when every gate holds,
3 otherwise.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

import numpy as np

GATE_EXIT_CODE = 3

#: footprint of the simulated network (~90 km across: regional array)
LAT0, LAT1 = 34.6, 35.4
LON0, LON1 = -117.9, -117.1
NOISE_STD = 0.05  # background channel noise (P prob ~= 0.05 << 0.5)
PULSE_HALF = 10  # triangular pulse half-width, samples
DROPOUT_SPAN_S = (0.5, 0.7)  # dropout window, fraction of duration


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="network digital twin")
    ap.add_argument("--stations", type=int, default=200)
    ap.add_argument("--duration-s", type=float, default=240.0)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--fs", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mainshock-frac", type=float, default=0.25,
                    help="mainshock origin time as a fraction of duration")
    ap.add_argument("--noise-frac", type=float, default=0.16,
                    help="fraction of stations that never see an event")
    ap.add_argument("--min-stations", type=int, default=4,
                    help="associator co-detection quorum")
    ap.add_argument("--p99-budget-ms", type=float, default=2500.0,
                    help="sample->alert p99 gate")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--output", default=None,
                    help="write the result JSON here (no file when unset)")
    ap.add_argument("--device", default="cuda",
                    help="where twinpick runs: cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configuration: 50 stations, 60 s scenario")
    ap.add_argument("--export-schedule", default=None, metavar="PATH",
                    help="also write the deterministic arrival schedule "
                    "(stations + per-round packet plan) as JSON, so the "
                    "real-fleet chaos lane replays the exact same "
                    "mainshock delivery this twin run drove")
    args = ap.parse_args(argv)
    if args.smoke:
        args.stations = 50
        args.duration_s = 60.0
    return args


# ----------------------------------------------------------- scenario
def make_stations(args, rng) -> List[Dict[str, Any]]:
    """Grid geometry + deterministic fault-role assignment. Roles are
    disjoint so each fault's effect is attributable."""
    n = args.stations
    side = max(1, int(math.ceil(math.sqrt(n))))
    stations = []
    for i in range(n):
        stations.append({
            "id": f"TW{i:04d}",
            "network": "TW",
            "lat": round(LAT0 + (LAT1 - LAT0) * (i // side) / max(1, side - 1), 4),
            "lon": round(LON0 + (LON1 - LON0) * (i % side) / max(1, side - 1), 4),
            "noise": False, "late": False, "dup": False, "dropout": False,
        })
    order = rng.permutation(n)
    k_noise = int(round(args.noise_frac * n))
    roles = (["noise"] * k_noise + ["late"] * 3 + ["dup"] * 4
             + ["dropout"] * 5)
    for idx, role in zip(order, roles):
        stations[int(idx)][role] = True
    return stations


def _dist_km(lat1, lon1, lat2, lon2) -> float:
    la1, la2 = math.radians(lat1), math.radians(lat2)
    dlon = math.radians(lon2 - lon1) * math.cos(0.5 * (la1 + la2))
    return 6371.0 * math.hypot(la2 - la1, dlon)


def make_events(args, rng) -> List[Dict[str, Any]]:
    """Mainshock + Omori-law aftershocks (rate K/(t+c)^p after the
    mainshock), sampled by deterministic integral thinning with a 3 s
    refractory so consecutive events stay separable by the associator's
    origin-time tolerance. The first aftershock waits 6 s: two pulses
    inside one analysis window inflate its std enough to push peak-z
    under the picker threshold, and the mainshock gate must not depend
    on that (aftershock-pair shadowing is allowed, and reported)."""
    t_main = args.mainshock_frac * args.duration_s
    clat, clon = 0.5 * (LAT0 + LAT1), 0.5 * (LON0 + LON1)
    events = [{
        "name": "mainshock", "t": t_main, "lat": clat, "lon": clon,
        "amp": 1.5, "radius_km": 1e9,
    }]
    K, c, p = 2.5, 1.0, 1.1
    acc, last_t = 0.0, -10.0
    dt = 0.1
    horizon = args.duration_s - t_main - 8.0  # leave room for moveout
    t = 0.0
    i = 0
    while t < horizon:
        acc += K / (t + c) ** p * dt
        if acc >= 1.0:
            acc -= 1.0
            if t - last_t >= 3.0 and t >= 6.0:
                last_t = t
                i += 1
                events.append({
                    "name": f"aftershock{i}",
                    "t": t_main + t,
                    "lat": clat + float(rng.uniform(-0.12, 0.12)),
                    "lon": clon + float(rng.uniform(-0.12, 0.12)),
                    "amp": 1.2,
                    "radius_km": float(rng.uniform(30.0, 60.0)),
                })
        t += dt
    return events


def synth_network(args, stations, events, rng, velocity_kms=6.0):
    """Per-station waveforms (noise + triangular P pulses at the
    physical moveout arrival) and the ground-truth detector sets.

    A station is an *expected detector* of an event when it was handed a
    pulse AND its sample clock is intact at the arrival — dropout
    stations lose whole packets, which shifts every later sample
    earlier, so their post-dropout picks carry wrong times by design and
    are excluded from expectations (the realistic failure, accounted)."""
    fs = args.fs
    L = int(args.duration_s * fs)
    drop_lo = DROPOUT_SPAN_S[0] * args.duration_s
    # expected[event][station_id] = arrival time (s): the truth table —
    # evaluation matches observed picks against it by (station, time).
    waves, expected = {}, {ev["name"]: {} for ev in events}
    for st in stations:
        w = rng.standard_normal((L, 3)).astype(np.float32) * NOISE_STD
        if not st["noise"]:
            for ev in events:
                d = _dist_km(ev["lat"], ev["lon"], st["lat"], st["lon"])
                if d > ev["radius_km"]:
                    continue
                arr_s = ev["t"] + d / velocity_kms
                s0 = int(round(arr_s * fs))
                if s0 - PULSE_HALF < 0 or s0 + PULSE_HALF >= L:
                    continue
                for k in range(-PULSE_HALF, PULSE_HALF + 1):
                    w[s0 + k, 0] += ev["amp"] * (1.0 - abs(k) / (PULSE_HALF + 1))
                if not (st["dropout"] and arr_s >= drop_lo):
                    expected[ev["name"]][st["id"]] = s0 / fs
        waves[st["id"]] = w
    return waves, expected


def build_scenario(args):
    """The full deterministic scenario from one seed: geometry, events,
    waveforms, truth table. One rng threads through all three stages, so
    any consumer (the in-process twin, the chaos lane's HTTP client)
    regenerates bit-identical waveforms from the same args."""
    rng = np.random.default_rng(args.seed)
    stations = make_stations(args, rng)
    events = make_events(args, rng)
    waves, expected = synth_network(args, stations, events, rng)
    return stations, events, waves, expected


def make_schedule(args, stations) -> List[List[Dict[str, Any]]]:
    """Deterministic arrival schedule: a list of ROUNDS, each round the
    packets delivered in that scenario step, in station order. All fault
    roles are resolved here — dup stations' replayed packets appear
    twice (same seq), late stations' bursts land in the round that
    flushes them, dropout packets are simply absent (seq still advances,
    so the receiver sees the gap). The final round carries one
    ``end=true`` close per station. ``drive`` and the real-fleet chaos
    lane (tests/test_torch_stream_chaos.py) both consume this plan, so the
    twin's gates and the chaos run argue about the SAME replay."""
    fs = args.fs
    packet = args.window // 2
    L = int(args.duration_s * fs)
    n_rounds = (L + packet - 1) // packet
    drop_lo = int(DROPOUT_SPAN_S[0] * L)
    drop_hi = int(DROPOUT_SPAN_S[1] * L)
    rounds: List[List[Dict[str, Any]]] = [[] for _ in range(n_rounds + 1)]
    for st in stations:
        sid = st["id"]
        seq = 0
        held: List[Dict[str, Any]] = []
        for r in range(n_rounds):
            lo, hi = r * packet, min((r + 1) * packet, L)
            seq += 1
            if st["dropout"] and lo < drop_hi and hi > drop_lo:
                continue  # packet lost; seq advances -> gap
            pkt = {"station": sid, "seq": seq, "lo": lo, "hi": hi}
            if st["late"]:
                held.append(pkt)
                if r % 4 == 3 or r == n_rounds - 1:
                    rounds[r].extend(held)
                    held = []
                continue
            rounds[r].append(pkt)
            if st["dup"] and seq % 5 == 0:
                rounds[r].append(dict(pkt))  # replayed packet, same seq
        rounds[n_rounds].extend(held)  # stragglers (never for r%4 math)
        seq += 1
        rounds[n_rounds].append(
            {"station": sid, "seq": seq, "end": True}
        )
    return rounds


def export_schedule(path, args, stations, events, rounds) -> None:
    """One self-describing JSON artifact: enough to regenerate the
    waveforms (scenario args incl. seed) plus the resolved delivery
    plan. Written atomically (dotfile + replace, the flight.py idiom) so
    a concurrently-starting chaos client never reads a torn file."""
    doc = {
        "scenario": {
            "stations": args.stations,
            "duration_s": args.duration_s,
            "window": args.window,
            "fs": args.fs,
            "seed": args.seed,
            "mainshock_frac": args.mainshock_frac,
            "noise_frac": args.noise_frac,
            "min_stations": args.min_stations,
        },
        "stations": stations,
        "events": events,
        "n_rounds": len(rounds),
        "rounds": rounds,
    }
    tmp = os.path.join(
        os.path.dirname(os.path.abspath(path)) or ".",
        "." + os.path.basename(path) + ".tmp",
    )
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, path)


# -------------------------------------------------------------- drive
class TwinPickEntry:
    """The ``twinpick`` entry: per-sample thresholds only, so batch shape
    cannot flip a crossing, and a pure-noise window gives no pick."""

    name, in_channels, channel0 = "twinpick", 3, "non"
    is_picker, is_group, version, variants = True, False, 1, ("fp32",)
    fallback_runs = 0

    def __init__(self, window: int, device: str):
        import torch

        self.window = window
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")

    def run(self, x, variant="fp32"):
        """(N, window, 3) z-scored windows -> (N, window, 3) (non, P, S)."""
        import torch

        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        p = torch.clamp(torch.abs(x[..., 0]) - 4.5, 0.0, 1.0)
        s = torch.clamp(torch.abs(x[..., 1]) - 4.5, 0.0, 1.0)
        return torch.stack([1.0 - p, p, s], dim=-1)

    def all_programs(self):
        return []

    def resolve_tasks(self, tasks):
        return None

    def supported_variants(self, tasks=None):
        return ["fp32"]


class _TwinPool:
    warmup_report: List[Any] = []
    program_stats: Dict[str, Any] = {}

    def __init__(self, entry: TwinPickEntry):
        self.entry = entry

    def names(self):
        return ["twinpick"]

    def get(self, name=None):
        return self.entry

    def entries(self):
        return {"twinpick": self.entry}

    def warmup(self, buckets):
        pass


def _make_service(args):
    """ServeService over ``twinpick`` on ``args.device`` (default cuda),
    with the JAX tool's batcher and stream configuration."""
    from seist_tpu_torch.serve.batcher import BatcherConfig
    from seist_tpu_torch.serve.server import ServeService

    entry = TwinPickEntry(args.window, getattr(args, "device", "cuda"))
    return ServeService(
        _TwinPool(entry),
        BatcherConfig(max_batch=16, max_delay_ms=2.0, max_queue=1024),
        stream_config={
            "max_stations": max(64, 2 * args.stations),
            "assoc_min_stations": args.min_stations,
            "assoc_window_s": 30.0,
            "assoc_tolerance_s": 2.0,
            # The durability plane: unset for the in-process twin, set by
            # twin_replica.py when the chaos fleet needs journaled
            # failover over the same deterministic model.
            "journal_dir": getattr(args, "journal_dir", None),
            "journal_every_s": getattr(args, "journal_every_s", 5.0),
            "assoc_dedup_window_s": getattr(args, "assoc_dedup_window_s", 2.0),
        },
    )


def drive(args, service, stations, waves, rounds):
    """Feed the whole network through POST /stream semantics, replaying
    the arrival schedule ``make_schedule`` resolved (dup/late/dropout
    fates and all). ``--workers`` threads each OWN stations ``w::W``
    (per-station packet order is a protocol invariant); within a worker,
    rounds advance in schedule order, so picks reach the associator in
    roughly scenario-time order."""
    from seist_tpu_torch.serve.protocol import Overloaded, QueueFull, ServeError

    options = {"ppk_threshold": 0.5, "spk_threshold": 0.95,
               "det_threshold": 0.95, "sampling_rate": args.fs}
    by_id = {st["id"]: st for st in stations}

    lock = threading.Lock()
    out = {"alerts": [], "sheds": 0, "errors": 0, "packets": 0,
           "windows": 0}

    def send(st, body_data, seq, end=False):
        body = {
            "model": "twinpick",
            "station": {k: st[k] for k in ("id", "network", "lat", "lon")},
            "seq": seq,
            "options": options,
        }
        if body_data is not None:
            body["data"] = body_data
        if end:
            body["end"] = True
        try:
            r = service.stream(body)
        except (Overloaded, QueueFull):
            with lock:
                out["sheds"] += 1
            return
        except ServeError:
            with lock:
                out["errors"] += 1
            return
        with lock:
            out["packets"] += 1
            out["windows"] += r["windows"]
            out["alerts"].extend(r["alerts"])

    def worker(w):
        try:
            mine = {st["id"] for st in stations[w :: max(1, args.workers)]}
            for rnd in rounds:
                for pkt in rnd:
                    sid = pkt["station"]
                    if sid not in mine:
                        continue
                    st = by_id[sid]
                    if pkt.get("end"):
                        send(st, None, pkt["seq"], end=True)
                    else:
                        data = waves[sid][pkt["lo"]:pkt["hi"]].tolist()
                        send(st, data, pkt["seq"])
        except BaseException as e:  # noqa: BLE001
            with lock:
                out["errors"] += 1
            sys.stderr.write(f"[twin] worker {w} died: {e!r}\n")

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(max(1, args.workers))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["wall_s"] = time.monotonic() - t0
    return out


# -------------------------------------------------------------- gates
def _pct(vals, q):
    return round(float(np.percentile(np.asarray(vals), q)), 3) if vals else -1.0


def evaluate(args, events, expected, run, stream_stats):
    """Ground truth vs observed alerts -> the gate ledger."""
    t_main = events[0]["t"]
    main_alerts = [a for a in run["alerts"]
                   if abs(a["origin"]["t_s"] - t_main) <= 3.0]
    # Coverage credit is TRUTH-based: a station counts as covered when
    # its known mainshock arrival appears as a pick in ANY alert —
    # including an outlier alert whose origin landed on a remote grid
    # node (its picks are still real mainshock detections that reached
    # the alert plane; only the location was degraded).
    exp_main = expected["mainshock"]
    union = set()
    for a in run["alerts"]:
        for p in a["picks"]:
            t_true = exp_main.get(p["station"])
            if t_true is not None and abs(p["t_s"] - t_true) <= 0.5:
                union.add(p["station"])
    # The associator can never alert on the last < min_stations pending
    # picks — the reachable coverage bound.
    need = len(exp_main) - (args.min_stations - 1)
    # Location gate on the MEDIAN over mainshock alerts: a quorum-sized
    # leftover pick set can cohere at a remote grid node (the known
    # moveout-compression degeneracy) — one such outlier alert must not
    # decide the gate either way.
    errs = sorted(
        max(abs(a["origin"]["lat"] - events[0]["lat"]),
            abs(a["origin"]["lon"] - events[0]["lon"]))
        for a in main_alerts
    )
    origin_err_deg = round(errs[len(errs) // 2], 4) if errs else -1.0

    aft = [ev for ev in events[1:]
           if len(expected[ev["name"]]) >= args.min_stations]
    aft_detected = sum(
        1 for ev in aft
        if any(abs(a["origin"]["t_s"] - ev["t"]) <= 3.0
               for a in run["alerts"])
    )

    s2a = [a["latency_ms"]["sample_to_alert"] for a in run["alerts"]
           if "sample_to_alert" in a["latency_ms"]]
    stages = {}
    for key in ("arrival_to_due", "due_to_queue", "queue_device",
                "pick", "association", "sample_to_alert"):
        vals = [a["latency_ms"][key] for a in run["alerts"]
                if key in a["latency_ms"]]
        stages[key] = {"p50": _pct(vals, 50), "p99": _pct(vals, 99)}

    gates = {
        "mainshock_alert_emitted": len(main_alerts) >= 1,
        "mainshock_all_picks_covered": len(union) >= need,
        "mainshock_origin_within_half_deg":
            0.0 <= origin_err_deg <= 0.5,
        "zero_alert_tier_sheds": run["sheds"] == 0 and run["errors"] == 0,
        "zero_dropped_windows":
            stream_stats.get("windows_dropped", -1.0) == 0.0,
        "zero_degraded_sessions":
            stream_stats.get("degraded_sessions", -1.0) == 0.0,
        "p99_sample_to_alert_within_budget":
            bool(s2a) and _pct(s2a, 99) <= args.p99_budget_ms,
        "duplicates_exercised": stream_stats.get("duplicates", 0.0) > 0.0,
        "gaps_exercised": stream_stats.get("gaps", 0.0) > 0.0,
    }
    detail = {
        "mainshock_alerts": len(main_alerts),
        "mainshock_expected_stations": len(exp_main),
        "mainshock_stations_covered": len(union),
        "mainshock_coverage_floor": need,
        "mainshock_origin_err_deg_median": origin_err_deg,
        "aftershocks_alertable": len(aft),
        "aftershocks_detected": aft_detected,
        "alerts_total": len(run["alerts"]),
        "p99_sample_to_alert_ms": _pct(s2a, 99),
        "latency_stages_ms": stages,
    }
    return gates, detail


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    stations, events, waves, expected = build_scenario(args)
    rounds = make_schedule(args, stations)
    print(f"[twin] scenario: {len(stations)} stations "
          f"({sum(s['noise'] for s in stations)} noise, 5 dropout, "
          f"3 late, 4 dup), mainshock @ {events[0]['t']:.1f}s, "
          f"{len(events) - 1} aftershocks, {args.duration_s:.0f}s @ "
          f"{args.fs} Hz", flush=True)
    if args.export_schedule:
        export_schedule(args.export_schedule, args, stations, events,
                        rounds)
        print(f"[twin] arrival schedule -> {args.export_schedule}",
              flush=True)

    service = _make_service(args)
    try:
        run = drive(args, service, stations, waves, rounds)
        stream_stats = service.metrics()["stream"].get("twinpick", {})
    finally:
        service.shutdown()

    gates, detail = evaluate(args, events, expected, run, stream_stats)
    ok = all(gates.values())
    result = {
        "metric": "stream_twin_p99_sample_to_alert_ms",
        "value": detail["p99_sample_to_alert_ms"],
        "unit": "ms",
        "budget_ms": args.p99_budget_ms,
        "gates": gates,
        "detail": detail,
        "scenario": {
            "stations": args.stations,
            "duration_s": args.duration_s,
            "window": args.window,
            "fs": args.fs,
            "seed": args.seed,
            "events": len(events),
            "min_stations": args.min_stations,
        },
        "run": {
            "packets": run["packets"],
            "windows": run["windows"],
            "sheds": run["sheds"],
            "errors": run["errors"],
            "wall_s": round(run["wall_s"], 3),
        },
        "stream_stats": stream_stats,
        "measured_at": datetime.now(timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"),
        "pass": ok,
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1, sort_keys=False)
            f.write("\n")
    for name, good in gates.items():
        print(f"[twin] {'PASS' if good else 'FAIL'}  {name}", flush=True)
    print(f"[twin] {'PASS' if ok else 'FAIL'}: "
          f"{detail['alerts_total']} alerts, mainshock covered "
          f"{detail['mainshock_stations_covered']}/"
          f"{detail['mainshock_expected_stations']} stations, "
          f"p99 sample->alert {detail['p99_sample_to_alert_ms']:.1f} ms "
          f"(budget {args.p99_budget_ms:.0f} ms) -> {args.output or 'no file'}",
          flush=True)
    return 0 if ok else GATE_EXIT_CODE


if __name__ == "__main__":
    sys.exit(main())
