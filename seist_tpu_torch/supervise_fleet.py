"""Serving-fleet supervisor: spawn N replicas + the front-tier router,
restart what dies, roll the registry (the port's copy of
``tools/supervise_fleet.py``).

The serving analog of ``python -m seist_tpu_torch supervise`` (which
babysits one training process): this babysits a *fleet* — N
``python -m seist_tpu_torch serve`` replica processes on consecutive
ports plus an in-process :mod:`seist_tpu_torch.serve.router` front tier
that load-balances, retries and circuit-breaks across them::

    python -m seist_tpu_torch supervise-fleet --replicas 2 --router-port 8080 \\
        --base-port 18100 -- \\
        python -m seist_tpu_torch serve --model seist_l_dpk=W.pt --window 8192

The supervisor and its router take no device and import neither torch
nor numpy; each replica keeps the serve rule (``cuda`` unless
``--device cpu``).

Replica lifecycle (mirrors the train plane's exit-code contract,
``train/checkpoint.py::PREEMPT_EXIT_CODE``):

* exit ``75`` (EX_TEMPFAIL) — the replica caught SIGTERM, drained its
  in-flight requests and left cleanly (a managed preemption). Relaunched
  IMMEDIATELY; the failure budget is untouched.
* any other nonzero exit (SIGKILL shows as -9) — a crash. The replica is
  pulled from the router's rotation at once (faster than a probe
  interval), relaunched after ``--backoff`` seconds, up to ``--retries``
  consecutive crashes; staying up ``--healthy-reset-s`` refills the
  budget. A replica that exhausts its budget is deregistered for good.
* exit ``0`` — voluntary stop (operator SIGINT); the slot is retired.

The supervisor exits 0 on SIGTERM/SIGINT (after draining the replicas)
and 1 once every replica slot has been retired. Each replica gets
``SEIST_SERVE_REPLICA=<index>`` in its environment — the handle
``SEIST_FAULT_SERVE_REPLICA`` uses to aim a chaos fault at exactly one
member of the fleet (utils/faults.py), and the ordinal that suffixes
the replica's ``events_r<N>.jsonl`` / flight-dump artifacts under a
shared ``--logdir``.

The supervisor is also the fleet's metrics pane: a
:class:`seist_tpu_torch.obs.fleet.FleetAggregator` periodically pulls every
replica's ``/metrics.json`` plus the in-process router's bus and serves
the merged view (counters summed, histograms merged bucket-wise,
per-replica breakdown retained) at ``GET /fleet/metrics[.json]`` on the
router port.

**Rolling restart** (the live-model flywheel): ``SIGHUP`` makes the supervisor read ``--rollout-file`` (JSON:
``{"version": N, "checkpoint"?: path, "cmd"?: [...], "replicas"?: [i]}``)
and roll the fleet to the new model version ONE replica at a time —
SIGTERM-drain (exit 75, in-flight requests finish, the router routes
away), relaunch on the rewritten command (``--model-version N`` +
checkpoint substitution), then wait until the replica answers
``/healthz/ready`` with the target version AND is probe-ready in the
router's registry before touching the next. Capacity never dips below
N-1, and a replica that never converges aborts the roll loudly instead
of draining the next one. ``"replicas": [0]`` rolls a subset — the
canary-staging primitive (roll one, canary it via ``POST
/router/canary``, then roll the rest).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from seist_tpu_torch.train.checkpoint import PREEMPT_EXIT_CODE


def _log(msg: str) -> None:
    print(f"[fleet] {msg}", file=sys.stderr, flush=True)


def rollout_cmd(
    cmd: List[str], version: int, checkpoint: Optional[str] = None
) -> List[str]:
    """Rewrite a replica command for a new model version: strip any
    existing ``--model-version``, substitute checkpoints when one is
    given (``--model NAME=CKPT`` values, ``--checkpoint`` values, and
    every task of ``--model-group PREFIX=task:CKPT,...``), then append
    ``--model-version N``. Pure function (unit-tested); anything fancier
    ships a full ``"cmd"`` in the rollout file instead."""
    out: List[str] = []
    i = 0
    while i < len(cmd):
        arg = cmd[i]
        if arg == "--model-version":
            i += 2  # drop flag + value
            continue
        if arg.startswith("--model-version="):
            i += 1
            continue
        if checkpoint is not None:
            if arg == "--model" and i + 1 < len(cmd):
                name = cmd[i + 1].partition("=")[0]
                out += [arg, f"{name}={checkpoint}"]
                i += 2
                continue
            if arg == "--checkpoint" and i + 1 < len(cmd):
                out += [arg, checkpoint]
                i += 2
                continue
            if arg == "--model-group" and i + 1 < len(cmd):
                prefix, _, rest = cmd[i + 1].partition("=")
                tasks = [
                    part.partition(":")[0] for part in rest.split(",")
                ]
                out += [
                    arg,
                    prefix + "=" + ",".join(
                        f"{t}:{checkpoint}" for t in tasks if t
                    ),
                ]
                i += 2
                continue
        out.append(arg)
        i += 1
    return out + ["--model-version", str(version)]


class FleetRollout:
    """One in-flight rolling restart, advanced by the monitor loop (a
    state machine, not a blocking call — crash relaunches and budget
    accounting keep running for the rest of the fleet mid-roll).

    Per replica: ``drain`` (SIGTERM; the replica exits 75 after serving
    its in-flight work and the monitor relaunches it IMMEDIATELY on the
    already-rewritten command) -> ``wait_ready`` (poll the replica's
    ``/healthz/ready`` until it reports the target version, plus the
    router's probe_ready so it is actually back in rotation) -> next
    slot. Aborts loudly on a per-replica ready timeout."""

    def __init__(
        self,
        slots: List["ReplicaSlot"],
        version: int,
        checkpoint: Optional[str] = None,
        cmd: Optional[List[str]] = None,
        subset: Optional[List[int]] = None,
        ready_timeout_s: float = 300.0,
    ):
        self.version = int(version)
        self.checkpoint = checkpoint
        self.cmd = list(cmd) if cmd else None
        self.ready_timeout_s = float(ready_timeout_s)
        self.queue = [
            s for s in slots
            if not s.retired and (subset is None or s.index in subset)
        ]
        self.phase = "start"  # start -> wait_relaunch -> wait_ready
        self.current: Optional[ReplicaSlot] = None
        self._old_pid: Optional[int] = None
        self._ready_deadline = 0.0
        self.done = False
        self.aborted = ""
        self.rolled: List[int] = []

    def _finish(self) -> None:
        self.done = True
        _log(
            f"rollout complete: version {self.version} on "
            f"replica(s) {self.rolled}"
        )

    def _next_slot(self) -> None:
        # A queued slot may have burned its crash budget since SIGHUP:
        # skip retired slots instead of draining a corpse (the monitor
        # never relaunches them, so waiting on one would hang the roll).
        while self.queue and self.queue[0].retired:
            skipped = self.queue.pop(0)
            _log(
                f"rollout: replica {skipped.index} retired since the "
                "roll started; skipping"
            )
        if not self.queue:
            self._finish()
            return
        self.current = self.queue.pop(0)
        slot = self.current
        # One deadline covers the slot's WHOLE drain -> relaunch -> ready
        # journey: a replica that ignores SIGTERM (wedged flush thread)
        # must abort the roll just as loudly as one that never converges.
        self._ready_deadline = time.monotonic() + self.ready_timeout_s
        base = self.cmd if self.cmd is not None else slot.cmd
        # Keep the supervisor-assigned --host/--port intact: rollout_cmd
        # only touches model flags; a full "cmd" replacement gets the
        # slot's host/port re-appended (argparse: last value wins).
        new_cmd = rollout_cmd(base, self.version, self.checkpoint)
        if self.cmd is not None:
            new_cmd += ["--host", "127.0.0.1", "--port", str(slot.port)]
        slot.cmd = new_cmd
        if slot.proc is not None and slot.proc.poll() is None:
            self._old_pid = slot.proc.pid
            _log(
                f"rollout: draining replica {slot.index} "
                f"(pid {self._old_pid}) for version {self.version}"
            )
            try:
                slot.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            self.phase = "wait_relaunch"
        else:
            # Slot already down (crash backoff): the monitor's next
            # relaunch uses the rewritten command.
            self._old_pid = None
            _log(
                f"rollout: replica {slot.index} already down; relaunch "
                f"will carry version {self.version}"
            )
            self.phase = "wait_relaunch"

    def _abort(self, reason: str) -> None:
        self.aborted = reason
        self.done = True
        _log(f"rollout ABORTED: {reason}")

    def advance(self, registry, probe_ready_fn) -> None:
        """One monitor tick. ``probe_ready_fn(slot) -> (ready, versions)``
        polls the replica's own /healthz/ready (injectable for tests)."""
        if self.done:
            return
        if self.phase == "start":
            self._next_slot()
            if self.done:
                return
        slot = self.current
        now = time.monotonic()
        if self.phase == "wait_relaunch":
            if slot.retired:
                self._abort(
                    f"replica {slot.index} retired mid-roll (crash budget)"
                )
                return
            if now >= self._ready_deadline:
                self._abort(
                    f"replica {slot.index} never relaunched within "
                    f"{self.ready_timeout_s:.0f}s (drain wedged?)"
                )
                return
            proc = slot.proc
            if proc is None or (
                self._old_pid is not None and proc.pid == self._old_pid
            ):
                return  # still draining / in the monitor's relaunch gap
            _log(
                f"rollout: replica {slot.index} relaunched "
                f"(pid {proc.pid}, version {self.version}); waiting ready"
            )
            self.phase = "wait_ready"
            return
        if self.phase == "wait_ready":
            if slot.retired:
                self._abort(
                    f"replica {slot.index} retired mid-roll (crash budget)"
                )
                return
            if now >= self._ready_deadline:
                self._abort(
                    f"replica {slot.index} not ready on version "
                    f"{self.version} within {self.ready_timeout_s:.0f}s"
                )
                return
            ready, versions = probe_ready_fn(slot)
            if not ready or not versions:
                return
            if any(int(v) != self.version for v in versions.values()):
                return  # relaunched but still reporting the old version
            in_rotation = any(
                r.probe_ready and r.url.endswith(f":{slot.port}")
                for r in registry.replicas()
            )
            if not in_rotation:
                return  # ready, but the router's prober hasn't readmitted
            _log(
                f"rollout: replica {slot.index} ready + re-registered "
                f"(version {self.version})"
            )
            self.rolled.append(slot.index)
            self.phase = "start"
            if not self.queue:
                self._finish()  # the last replica converged this tick


class ReplicaSlot:
    """One fleet position: its port, process handle and failure budget."""

    def __init__(self, index: int, port: int, cmd: List[str]):
        self.index = index
        self.port = port
        self.url = f"127.0.0.1:{port}"
        self.cmd = list(cmd) + ["--host", "127.0.0.1", "--port", str(port)]
        self.proc: Optional[subprocess.Popen] = None
        self.failures = 0  # consecutive crashes since last healthy stretch
        self.started_at = 0.0
        self.restart_at: Optional[float] = None  # backoff schedule
        self.retired = False

    def spawn(self) -> None:
        env = dict(os.environ)
        env["SEIST_SERVE_REPLICA"] = str(self.index)
        self.proc = subprocess.Popen(self.cmd, env=env)
        self.started_at = time.monotonic()
        self.restart_at = None
        _log(
            f"replica {self.index} (port {self.port}) started "
            f"pid={self.proc.pid}"
        )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="serving-fleet supervisor: replicas + router",
        usage="python -m seist_tpu_torch supervise-fleet [opts] -- "
        "python -m seist_tpu_torch serve ...",
    )
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--base-port", type=int, default=18100,
                    help="replica i serves on base-port + i")
    ap.add_argument("--router-host", default="127.0.0.1")
    ap.add_argument("--router-port", type=int, default=8080,
                    help="front-tier port (0 = ephemeral, printed)")
    ap.add_argument("--retries", type=int, default=3,
                    help="consecutive crash relaunches per replica before "
                    "the slot is retired (exit-75 preempts are free)")
    ap.add_argument("--backoff", type=float, default=2.0,
                    help="seconds before a crash relaunch")
    ap.add_argument("--healthy-reset-s", type=float, default=60.0,
                    help="uptime that refills a replica's crash budget")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="SIGTERM->SIGKILL grace on supervisor shutdown")
    # Router knobs (forwarded to seist_tpu_torch.serve.router.RouterConfig).
    ap.add_argument("--router-retries", type=int, default=2)
    ap.add_argument("--request-timeout-s", type=float, default=10.0)
    ap.add_argument("--hedge-ms", type=float, default=0.0)
    ap.add_argument("--probe-interval-s", type=float, default=0.5)
    ap.add_argument("--breaker-failures", type=int, default=3)
    ap.add_argument("--breaker-cooldown-s", type=float, default=2.0)
    ap.add_argument("--fleet-scrape-interval-s", type=float, default=5.0,
                    help="how often the fleet aggregator pulls every "
                    "replica's /metrics.json (served merged on the "
                    "router port at GET /fleet/metrics[.json])")
    ap.add_argument("--rollout-file", default="",
                    help="JSON rollout spec ({'version': N, "
                    "'checkpoint'?: path, 'cmd'?: [...], 'replicas'?: "
                    "[i, ...]}) read when SIGHUP arrives: rolls the "
                    "fleet to the new model version one replica at a "
                    "time")
    ap.add_argument("--rollout-ready-timeout-s", type=float, default=300.0,
                    help="per-replica ready deadline during a roll; "
                    "exceeding it ABORTS the roll (capacity stays N-1, "
                    "never N-2)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="the replica command, after `--` (without "
                    "--host/--port, which the supervisor assigns)")
    args = ap.parse_args(argv)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no replica command (use: supervise-fleet [opts] -- "
                 "python -m seist_tpu_torch serve ...)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")

    from seist_tpu_torch.obs import trace as obs_trace
    from seist_tpu_torch.obs.bus import BUS
    from seist_tpu_torch.obs.fleet import FleetAggregator
    from seist_tpu_torch.serve.router import (
        Router,
        RouterConfig,
        start_router_server,
    )

    router = Router(
        config=RouterConfig(
            retries=args.router_retries,
            request_timeout_s=args.request_timeout_s,
            hedge_ms=args.hedge_ms,
            probe_interval_s=args.probe_interval_s,
            breaker_failures=args.breaker_failures,
            breaker_cooldown_s=args.breaker_cooldown_s,
        )
    )
    slots = [
        ReplicaSlot(i, args.base_port + i, cmd)
        for i in range(args.replicas)
    ]
    # Fleet metrics pane: periodically pull every replica's /metrics.json
    # plus the (in-process) router's bus, merge counters/gauges and
    # bucket-wise histograms, serve the single aggregated view at
    # GET /fleet/metrics[.json] on the router port —
    # the signal source the autoscaler and canary rollback will read.
    obs_trace.register_trace_collector()
    fleet = FleetAggregator(interval_s=args.fleet_scrape_interval_s)
    fleet.add_source("router", BUS.snapshot)
    for slot in slots:
        slot.spawn()
        router.registry.add(slot.url)
        fleet.add_source(f"replica-{slot.index}", slot.url)
    router_port = args.router_port
    if router_port == 0:
        # An ephemeral (port-0) router bind can land ON a replica's
        # pre-assigned port: the replica process may not have bound it
        # yet, so the kernel hands it out, and that replica then
        # crash-loops on EADDRINUSE until its relaunch budget retires
        # the slot. Pick the ephemeral port ourselves, excluding every
        # slot's port.
        import socket

        replica_ports = {slot.port for slot in slots}
        while True:
            probe = socket.socket()
            probe.bind((args.router_host, 0))
            router_port = probe.getsockname()[1]
            probe.close()
            if router_port not in replica_ports:
                break
    server = start_router_server(router, args.router_host, router_port)
    server.fleet = fleet
    fleet.start()
    host, port = server.server_address[:2]
    # Machine-greppable for harnesses driving an ephemeral-port fleet.
    print(f"[fleet] ROUTER=http://{host}:{port}", flush=True)
    _log(f"router on http://{host}:{port}, {len(slots)} replica(s)")

    stop = threading.Event()
    #: SIGHUP arrivals (handler does a GIL-atomic increment only —
    #: threadlint signal-handler-unsafe); the monitor loop compares
    #: against its consumed count and starts the roll itself.
    hup = {"count": 0, "seen": 0}

    def _term(signum, frame):
        stop.set()

    def _hup(signum, frame):
        hup["count"] += 1

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    signal.signal(signal.SIGHUP, _hup)

    try:
        _monitor(slots, router, args, stop, hup)
    finally:
        fleet.stop()
        _drain(slots, args.drain_timeout_s)
        server.shutdown()
        router.stop()
    live_slots = [s for s in slots if not s.retired]
    if stop.is_set():
        _log("stopped (signal)")
        return 0
    _log("stopped (all replica slots retired)" if not live_slots
         else "stopped")
    return 0 if live_slots else 1


def _probe_replica(slot: "ReplicaSlot") -> Tuple[bool, Dict[str, int]]:
    """Poll one replica's /healthz/ready directly: (ready, versions).
    The rollout's convergence check — the router's registry alone is not
    enough (its prober can lag a probe interval)."""
    from seist_tpu_torch.serve.router import _http_request

    try:
        status, _, body = _http_request(
            slot.url, "GET", "/healthz/ready", timeout_s=2.0
        )
    except Exception:  # noqa: BLE001 — a dead/warming replica is "not yet"
        return False, {}
    try:
        payload = json.loads(body.decode())
    except (ValueError, UnicodeDecodeError):
        payload = {}
    versions = (
        payload.get("versions") if isinstance(payload, dict) else None
    )
    return status == 200, versions if isinstance(versions, dict) else {}


def _read_rollout_spec(path: str) -> Optional[dict]:
    if not path:
        _log("SIGHUP but no --rollout-file configured; ignoring")
        return None
    try:
        with open(path) as f:
            spec = json.load(f)
    except (OSError, ValueError) as e:
        _log(f"rollout file {path!r} unreadable: {e!r}; ignoring SIGHUP")
        return None
    if not isinstance(spec, dict) or "version" not in spec:
        _log(f"rollout file {path!r} needs {{'version': N}}; ignoring")
        return None
    return spec


def _monitor(
    slots: List["ReplicaSlot"], router, args, stop: threading.Event,
    hup: Optional[Dict[str, int]] = None,
) -> None:
    """Poll replica processes; restart / retire per the exit contract.
    Also advances an in-flight rolling restart (SIGHUP + --rollout-file)
    one state-machine tick per loop — crash handling for the REST of the
    fleet keeps running mid-roll."""
    rollout: Optional[FleetRollout] = None
    while not stop.is_set():
        if hup is not None and hup["count"] > hup["seen"]:
            hup["seen"] = hup["count"]
            if rollout is not None and not rollout.done:
                _log("SIGHUP during an active rollout; ignoring")
            else:
                spec = _read_rollout_spec(args.rollout_file)
                if spec is not None:
                    rollout = FleetRollout(
                        slots,
                        version=spec["version"],
                        checkpoint=spec.get("checkpoint"),
                        cmd=spec.get("cmd"),
                        subset=spec.get("replicas"),
                        ready_timeout_s=args.rollout_ready_timeout_s,
                    )
                    _log(
                        f"rollout started: version {rollout.version} over "
                        f"{len(rollout.queue)} replica(s), one at a time"
                    )
        if rollout is not None and not rollout.done:
            rollout.advance(router.registry, _probe_replica)
        active = 0
        for slot in slots:
            if slot.retired:
                continue
            active += 1
            now = time.monotonic()
            if slot.proc is None:
                # In backoff: relaunch when its clock expires.
                if slot.restart_at is not None and now >= slot.restart_at:
                    slot.spawn()
                    router.registry.add(slot.url)
                continue
            if (
                slot.failures
                and now - slot.started_at >= args.healthy_reset_s
            ):
                _log(f"replica {slot.index} healthy "
                     f"{args.healthy_reset_s:.0f}s: crash budget reset")
                slot.failures = 0
            rc = slot.proc.poll()
            if rc is None:
                continue
            slot.proc = None
            # Pull it from rotation NOW — the router should stop routing
            # to a dead port before the next health probe finds out.
            router.registry.mark_down(slot.url, reason=f"rc={rc}")
            # Streaming failover visibility: how many stations the dead
            # replica was home to. They re-home to survivors on their
            # next packet (journal restore / gap-stitch re-warm); the
            # chaos lane greps this line to time the re-home.
            homed = router.affinity.snapshot()["by_replica"].get(
                slot.url, 0
            )
            if homed:
                _log(
                    f"replica {slot.index} was stream home to {homed} "
                    "stations; re-homing to survivors"
                )
            if rc == 0:
                _log(f"replica {slot.index} exited 0 (voluntary); "
                     "slot retired")
                slot.retired = True
                router.registry.remove(slot.url)
            elif rc == PREEMPT_EXIT_CODE:
                _log(f"replica {slot.index} clean preempt (rc={rc}): "
                     "immediate relaunch, budget untouched")
                slot.spawn()
                router.registry.add(slot.url)
            else:
                slot.failures += 1
                if slot.failures > args.retries:
                    _log(f"replica {slot.index} crashed rc={rc}; budget "
                         f"exhausted ({slot.failures - 1}/{args.retries}) "
                         "— slot retired")
                    slot.retired = True
                    router.registry.remove(slot.url)
                else:
                    _log(f"replica {slot.index} crashed rc={rc}; relaunch "
                         f"in {args.backoff:.1f}s "
                         f"(budget {slot.failures}/{args.retries})")
                    slot.restart_at = now + args.backoff
        if active == 0:
            return  # every slot retired: the fleet is gone
        stop.wait(0.2)


def _drain(slots: List["ReplicaSlot"], timeout_s: float) -> None:
    """SIGTERM every live replica (graceful drain, expect exit 75), then
    SIGKILL stragglers after the grace period."""
    live = [s for s in slots if s.proc is not None and s.proc.poll() is None]
    for slot in live:
        try:
            slot.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + timeout_s
    for slot in live:
        remaining = max(0.1, deadline - time.monotonic())
        try:
            rc = slot.proc.wait(timeout=remaining)
            _log(f"replica {slot.index} drained (rc={rc})")
        except subprocess.TimeoutExpired:
            _log(f"replica {slot.index} did not drain in "
                 f"{timeout_s:.0f}s; SIGKILL")
            slot.proc.kill()
            slot.proc.wait()


if __name__ == "__main__":
    sys.exit(main())
