"""The stream chaos lane (the port's counterpart of the JAX package's
``tests/test_stream_chaos.py``): the digital twin's mainshock scenario
replayed against a real fleet of three ``twin-replica`` processes behind
``supervise-fleet`` and its router.

The twin exports its arrival schedule to a file and the lane drives the
fleet from that file, so the in-process twin and the chaos run argue about
the same replay. :func:`sigkill_run` SIGKILLs the replica that carries the
most stations while the mainshock arrives; its gates:

* zero missed mainshock alerts: the union of the stream responses' alerts
  and the fleet's alert WALs holds the mainshock (the consumer dedupes on
  ``alert_id``);
* bounded duplicates: no ``alert_id`` is emitted more than three times;
* the kill is visible end to end: the fault stamp, the router's re-homes
  (``seist_stream_rehome_total`` > 0), the supervisor's re-home line and
  the relaunch;
* the client survives: a failed send retries the same seq, so every
  severed packet ends a success or a counted drop, never a silent one.

:func:`packet_fault_run` runs every replica under the drop, duplicate and
reorder packet faults (``SEIST_FAULT_STREAM_*_P``): the plane degrades as
documented and the mainshock alert still lands. Each returns ``(gates,
detail)``; :func:`verdict_line` is the lane's greppable
``[stream-chaos] VERDICT {json}``.
"""

from __future__ import annotations

import glob
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

WINDOW = 256
#: The JAX lane's scenario: 36 stations, 30 s, seed 7.
SCENARIO_ARGS = [
    "--stations", "36", "--duration-s", "30", "--window", str(WINDOW),
    "--fs", "50", "--seed", "7", "--min-stations", "4", "--workers", "4",
]
REPLICAS = 3
WARM_TIMEOUT_S = 240.0
FLEET_ARGS = ("--router-retries", "3", "--request-timeout-s", "30")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port(n: int = 1) -> int:
    """A loopback port that is free now, and so are the ``n - 1`` after it
    (``supervise-fleet`` puts replica i on ``--base-port`` + i)."""
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        if port + n > 65536:
            continue
        for p in range(port + 1, port + n):
            try:
                with socket.socket() as t:
                    t.bind(("127.0.0.1", p))
            except OSError:
                break
        else:
            return port


def _drain_pipe(pipe, buf: List[str]) -> None:
    for line in pipe:
        buf.append(line)


def replica_args(journal_dir: str, device: str) -> List[str]:
    return ["--window", str(WINDOW), "--stations", "72", "--min-stations", "4",
            "--journal-dir", journal_dir, "--journal-every-s", "0.2", "--device", device]


def start_fleet(base_port: int, replica: Sequence[str], env_extra: Optional[dict] = None,
                replicas: int = REPLICAS, fleet_args: Sequence[str] = FLEET_ARGS):
    """``supervise-fleet`` over ``replicas`` twin replicas: (process, router
    host, router port). Both pipes are drained for the fleet's whole life (an
    undrained pipe at the kernel's 64 KB wedges every fleet process)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "seist_tpu_torch", "supervise-fleet",
         "--replicas", str(replicas), "--base-port", str(base_port), "--router-port", "0",
         "--probe-interval-s", "0.3", "--backoff", "0.5", "--drain-timeout-s", "20",
         *fleet_args, "--",
         sys.executable, "-X", "faulthandler", "-m", "seist_tpu_torch", "twin-replica",
         *replica],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
    proc.fleet_err = []
    proc.fleet_err_thread = threading.Thread(target=_drain_pipe,
                                             args=(proc.stderr, proc.fleet_err), daemon=True)
    proc.fleet_err_thread.start()
    router = None
    for _ in range(50):
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(r"ROUTER=http://([\d.]+):(\d+)", line)
        if m:
            router = (m.group(1), int(m.group(2)))
            break
    if router is None:
        proc.kill()
        proc.wait()
        raise RuntimeError("no ROUTER line from supervise-fleet")
    proc.fleet_out = []
    threading.Thread(target=_drain_pipe, args=(proc.stdout, proc.fleet_out), daemon=True).start()
    return proc, router[0], router[1]


def get(host: str, port: int, path: str, timeout: float = 5.0) -> Tuple[int, Any]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw.decode()
    finally:
        conn.close()


def wait_probed_ready(host: str, port: int, n: int, timeout_s: float = WARM_TIMEOUT_S) -> float:
    """Block until the router probes ``n`` replicas ready; the seconds it took."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        try:
            _, payload = get(host, port, "/router/replicas")
            states = [r["probe_state"] for r in payload.get("replicas", [])]
            if states.count("ok") >= n:
                return time.monotonic() - t0
        except OSError:
            pass
        time.sleep(0.25)
    raise RuntimeError(f"fleet never reached {n} probed-ready replicas in {timeout_s}s")


def stop_fleet(proc, timeout: float = 60) -> Tuple[int, str]:
    """SIGTERM the supervisor (it drains the fleet): its exit code and stderr."""
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    proc.fleet_err_thread.join(timeout=10)
    return rc, "".join(proc.fleet_err)


def build_and_export(path: str):
    """The scenario and its schedule, exported to ``path`` and read back
    from it (the file is the contract both consumers drive from):
    (args, schedule document, waveforms, expected detectors)."""
    from seist_tpu_torch import twin

    args = twin.get_args(SCENARIO_ARGS)
    stations, events, waves, expected = twin.build_scenario(args)
    rounds = twin.make_schedule(args, stations)
    twin.export_schedule(path, args, stations, events, rounds)
    with open(path) as f:
        doc = json.load(f)
    if doc["rounds"] != rounds:
        raise AssertionError("the exported schedule is not the replay")
    return args, doc, waves, expected


class StreamClient:
    """Reconnect-with-resume ``/stream`` client over the exported schedule:
    worker threads own stations ``w::W`` (per-station order is the
    protocol's invariant); a failed send retries the same seq, so a success
    after a retry is a resume and exhausted retries are a counted drop."""

    MAX_RETRIES = 4

    def __init__(self, host: str, port: int, doc: dict, waves: dict, workers: int = 4,
                 round_pause_s: float = 0.25):
        self.host, self.port = host, port
        self.doc, self.waves = doc, waves
        self.workers = workers
        self.round_pause_s = round_pause_s
        self.lock = threading.Lock()
        self.alerts: List[dict] = []
        self.ok = 0
        self.resumed = 0
        self.dropped = 0
        self.resume_ms: List[float] = []
        self.options = {"ppk_threshold": 0.5, "spk_threshold": 0.95, "det_threshold": 0.95,
                        "sampling_rate": doc["scenario"]["fs"]}

    def _post(self, body: dict) -> Tuple[int, bytes]:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        try:
            conn.request("POST", "/stream", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        except OSError:
            return 0, b""
        finally:
            conn.close()

    def _send(self, st: dict, pkt: dict) -> None:
        body = {"model": "twinpick",
                "station": {k: st[k] for k in ("id", "network", "lat", "lon")},
                "seq": pkt["seq"], "options": self.options}
        if pkt.get("end"):
            body["end"] = True
        else:
            body["data"] = self.waves[st["id"]][pkt["lo"]:pkt["hi"]].tolist()
        t0 = time.monotonic()
        for attempt in range(1 + self.MAX_RETRIES):
            status, raw = self._post(body)
            if status == 200:
                with self.lock:
                    self.ok += 1
                    if attempt:
                        self.resumed += 1
                        self.resume_ms.append((time.monotonic() - t0) * 1000.0)
                    try:
                        self.alerts.extend(json.loads(raw).get("alerts") or [])
                    except ValueError:
                        pass
                return
            if not (status == 0 or status >= 500):
                break  # a 4xx is not retried: the packet is gone
            time.sleep(0.3 * (attempt + 1))
        with self.lock:
            self.dropped += 1

    def drive(self) -> None:
        by_id = {st["id"]: st for st in self.doc["stations"]}

        def worker(w):
            try:
                mine = {st["id"] for st in self.doc["stations"][w::self.workers]}
                for rnd in self.doc["rounds"]:
                    for pkt in rnd:
                        if pkt["station"] in mine:
                            self._send(by_id[pkt["station"]], pkt)
                    # Pace the replay: the journals get a cadence tick and
                    # the kill lands in the middle of the stream.
                    time.sleep(self.round_pause_s)
            except BaseException as e:  # noqa: BLE001 - a dead worker fails the gate
                with self.lock:
                    self.dropped += 10**6
                sys.stderr.write(f"[stream-chaos] worker {w} died: {e!r}\n")

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("the stream chaos client wedged")


def wal_alerts(journal_dir: str) -> List[dict]:
    """Every alert record in the fleet's alert WALs."""
    out = []
    for path in glob.glob(os.path.join(journal_dir, "twinpick", "alerts*.wal")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


class _ProbeWatch(threading.Thread):
    """Polls the router's registry every 0.1 s: the wall time at which the
    replica ``url``'s probe turns ready again after it was seen down (its
    relaunch)."""

    def __init__(self, host: str, port: int, url: str):
        super().__init__(daemon=True)
        self.host, self.port, self.url = host, port, url
        self.down = False
        self.back_at: Optional[float] = None
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(0.1) and self.back_at is None:
            try:
                _, reg = get(self.host, self.port, "/router/replicas", timeout=2.0)
            except OSError:
                continue
            state = next((r.get("probe_state") for r in reg.get("replicas", [])
                          if str(r.get("url", "")).endswith(self.url)), None)
            if state is not None and state != "ok":
                self.down = True
            elif state == "ok" and self.down:
                self.back_at = time.time()

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)


def _rehome_total(text: Any) -> float:
    m = re.search(r"^seist_stream_rehome_total(?:\{[^}]*\})? ([0-9.eE+-]+)$",
                  text if isinstance(text, str) else "", re.M)
    return float(m.group(1)) if m else 0.0


def _mainshock_ids(alerts: List[dict], t_main: float) -> List[str]:
    return sorted({a["alert_id"] for a in alerts if abs(a["origin"]["t_s"] - t_main) <= 3.0})


def sigkill_run(work: str, device: str) -> Tuple[Dict[str, bool], Dict[str, Any]]:
    """SIGKILL the replica that homes the most stations while the
    mainshock arrives. The survivors restore its stations from the shared
    journals, the router re-homes them, and the consumer's alert ledger
    shows the mainshock."""
    from seist_tpu_torch.serve.router import StationAffinity

    os.makedirs(work, exist_ok=True)
    _, doc, waves, _ = build_and_export(os.path.join(work, "schedule.json"))
    stations, events = doc["stations"], doc["events"]
    # Rendezvous placement is deterministic in the replicas' urls: aim the
    # kill at the station-heavy replica, and time it against the mainshock.
    base_port = free_port(REPLICAS)
    urls = [f"127.0.0.1:{base_port + i}" for i in range(REPLICAS)]
    aff = StationAffinity()
    by_url = {u: 0 for u in urls}
    for st in stations:
        by_url[aff.rank(st["id"], urls)[0]] += 1
    target_url = max(by_url, key=lambda u: by_url[u])
    target = urls.index(target_url)
    main_round = int(events[0]["t"] * doc["scenario"]["fs"]) // (WINDOW // 2)
    # The target's packets per round are about its homed stations: fire
    # one round into the mainshock wave.
    kill_packet = by_url[target_url] * (main_round + 1)
    jd = os.path.join(work, "journals")
    stamp = os.path.join(work, "kill.stamp")
    t0 = time.monotonic()
    proc, host, port = start_fleet(
        base_port, replica_args(jd, device),
        env_extra={"SEIST_FAULT_STREAM_KILL_PACKET": str(kill_packet),
                   "SEIST_FAULT_SERVE_REPLICA": str(target), "SEIST_FAULT_STAMP": stamp})
    watch = _ProbeWatch(host, port, f"127.0.0.1:{base_port + target}")
    try:
        ready_s = wait_probed_ready(host, port, REPLICAS)
        watch.start()
        client = StreamClient(host, port, doc, waves)
        t_drive = time.monotonic()
        client.drive()
        drive_s = time.monotonic() - t_drive
        _, reg = get(host, port, "/router/replicas")
        _, metrics = get(host, port, "/metrics")
        stream = reg.get("stream") or {}
        # The relaunched target is back in rotation before the teardown
        # (a gate: a relaunch that never turns ready fails it).
        try:
            relaunch_ready_s: Optional[float] = wait_probed_ready(host, port, REPLICAS,
                                                                  timeout_s=120.0)
            time.sleep(0.3)  # the watcher's next poll sees the relaunched replica
        except RuntimeError:
            relaunch_ready_s = None
            _, reg_after = get(host, port, "/router/replicas")
    finally:
        watch.stop()
        rc, err = stop_fleet(proc, timeout=120)
    out = "".join(getattr(proc, "fleet_out", []))
    for name, text in (("fleet.err.log", err), ("fleet.out.log", out)):
        with open(os.path.join(work, name), "w") as f:
            f.write(text)
    wal = wal_alerts(jd)
    main_ids = _mainshock_ids(client.alerts + wal, events[0]["t"])
    per_id: Dict[str, int] = {}
    for a in client.alerts:
        per_id[a["alert_id"]] = per_id.get(a["alert_id"], 0) + 1
    worst_dup = max(per_id.values(), default=0)
    rehome_total = _rehome_total(metrics)
    gates = {
        "kill_fired": os.path.exists(stamp),
        "mainshock_alert_observed": len(main_ids) >= 1,
        "duplicates_bounded": worst_dup <= 3,
        "stations_rehomed": stream.get("rehomes", 0) > 0 and rehome_total > 0,
        "rehome_logged": "was stream home to" in err,
        "replica_relaunched": (bool(re.search(rf"replica {target} crashed rc=-9; relaunch", err))
                               and relaunch_ready_s is not None),
        "client_no_unrescued_failures": client.dropped == 0,
        "fleet_clean_exit": rc == 0,
    }
    detail = {
        "target_replica": target, "stations_on_target": by_url[target_url],
        "kill_packet": kill_packet, "alerts_seen": len(client.alerts), "wal_records": len(wal),
        "mainshock_ids": main_ids, "rehomes": stream.get("rehomes", 0),
        "seist_stream_rehome_total": rehome_total, "resumed_packets": client.resumed,
        "resume_ms_max": round(max(client.resume_ms, default=0.0), 1),
        "worst_emissions_per_id": worst_dup, "fleet_ready_s": round(ready_s, 2),
        "relaunch_s": (round(watch.back_at - os.path.getmtime(stamp), 2)
                       if watch.back_at and os.path.exists(stamp) else None),
        "drive_s": round(drive_s, 2),
        "relaunch_ready_wait_s": (None if relaunch_ready_s is None
                                  else round(relaunch_ready_s, 2)),
        "wall_s": round(time.monotonic() - t0, 2),
        "stderr_tail": "" if all(gates.values()) else err[-6000:],
        "stdout_tail": "" if all(gates.values()) else out[-4000:],
    }
    if relaunch_ready_s is None:
        detail["replicas_after"] = reg_after.get("replicas") if isinstance(reg_after, dict) else reg_after
    return gates, detail


def packet_fault_run(work: str, device: str) -> Tuple[Dict[str, bool], Dict[str, Any]]:
    """``SEIST_FAULT_STREAM_{DROP,DUP,REORDER}_P`` at 3% on every replica:
    gap-stitching absorbs drops, idempotent seqs absorb duplicates, a late
    reordered packet folds into both, and the mainshock alert still lands."""
    os.makedirs(work, exist_ok=True)
    _, doc, waves, _ = build_and_export(os.path.join(work, "schedule.json"))
    jd = os.path.join(work, "journals")
    proc, host, port = start_fleet(
        free_port(REPLICAS), replica_args(jd, device),
        env_extra={"SEIST_FAULT_STREAM_DROP_P": "0.03", "SEIST_FAULT_STREAM_DUP_P": "0.03",
                   "SEIST_FAULT_STREAM_REORDER_P": "0.03"})
    try:
        wait_probed_ready(host, port, REPLICAS)
        client = StreamClient(host, port, doc, waves, round_pause_s=0.1)
        client.drive()
    finally:
        rc, err = stop_fleet(proc, timeout=120)
    main_ids = _mainshock_ids(client.alerts + wal_alerts(jd), doc["events"][0]["t"])
    gates = {"mainshock_alert_observed": len(main_ids) >= 1,
             "client_no_unrescued_failures": client.dropped == 0,
             "fleet_clean_exit": rc == 0}
    detail = {"alerts_seen": len(client.alerts), "mainshock_ids": main_ids,
              "ok_packets": client.ok,
              "stderr_tail": err[-3000:] if rc != 0 else ""}
    return gates, detail


def verdict_line(name: str, gates: Dict[str, bool], detail: Dict[str, Any]) -> str:
    ok = all(gates.values())
    return ("[stream-chaos] VERDICT "
            + json.dumps({"test": name, "ok": ok, "gates": gates, "detail": detail}))
