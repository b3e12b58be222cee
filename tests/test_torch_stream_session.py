"""The port's stream plane on the host (``seist_tpu_torch/stream``,
``utils/faults.py``'s stream injector) against the JAX package's, on the
same inputs: identical due windows, picks, snapshots, journal bytes in
both directions, alerts (ids, origin, t0, stations), dedup and WAL
seeding, and packet fates.

The sessions are fed one numpy picker's probabilities, computed on each
due window, and packets of random sizes with a gap (a packet never sent),
a duplicate (one sent twice) and ``end``: a session stitches what arrives
(the mux drops a duplicate by its ``seq``; the session does not see it)."""

from __future__ import annotations

import numpy as np
import pytest

from seist_tpu.ops.stream import annotate as jannotate
from seist_tpu.stream import assoc as jassoc
from seist_tpu.stream import journal as jjournal
from seist_tpu.stream import session as jsession
from seist_tpu.utils import faults as jfaults

from seist_tpu_torch.ops.stream import annotate as tannotate
from seist_tpu_torch.stream import assoc as tassoc
from seist_tpu_torch.stream import journal as tjournal
from seist_tpu_torch.stream import session as tsession
from seist_tpu_torch.stream.mux import MuxConfig, StationMux
from seist_tpu_torch.utils import faults as tfaults

CFG = dict(window=64, stride=32, sampling_rate=50, min_peak_dist=0.1)


def _picker(x):
    x = np.asarray(x)
    a = np.abs(x[..., 0])
    p = a / (a.max(axis=1, keepdims=True) + np.float32(1e-9))
    s = np.clip(np.abs(x[..., 1]) / np.float32(3.0), 0.0, 1.0)
    return np.stack([1.0 - p, p, s], axis=-1).astype(np.float32)


def _record(length, seed=0, events=(60, 170, 290)):
    rng = np.random.default_rng(seed)
    rec = (rng.standard_normal((length, 3)) * 0.1).astype(np.float32)
    for e in events:
        if e + 4 < length:
            rec[e : e + 4, 0] += 40.0
            rec[min(e + 30, length - 1), 1] += 6.0
    return rec


def _packets(length, seed):
    rng = np.random.default_rng(seed)
    sizes, pos = [], 0
    while pos < length:
        n = int(min(rng.integers(1, max(3, length // 7)), length - pos))
        sizes.append(n)
        pos += n
    return sizes


def _gap_and_dup(rec, sizes):
    """The packets as sent: the fourth never arrives, the sixth twice.
    Returns the record as the session sees it and its packet sizes."""
    chunks = np.split(rec, np.cumsum(sizes)[:-1])
    sent = chunks[:3] + chunks[4:6] + [chunks[5]] + chunks[6:]
    return np.concatenate(sent), [len(c) for c in sent]


def _drive(mod, cfg, rec, sizes, restore=None):
    """Feed a session (of package ``mod``) packet by packet; returns the due
    windows' offsets, the emitted picks in order and the snapshots after
    each packet. ``restore``: (k, restore_fn) swaps the session for
    ``restore_fn(snapshot)`` before packet k."""
    sess = mod.StreamSession(cfg)
    offsets, emitted, snaps = [], [], []
    pos = 0
    for k, size in enumerate(sizes):
        if restore is not None and k == restore[0]:
            sess = restore[1](sess.snapshot())
        for w in sess.push(rec[pos : pos + size]):
            offsets.append(w.offset)
            emitted.append(sess.integrate(w.offset, _picker(w.data[None])[0]))
        snaps.append(sess.snapshot())
        pos += size
    for w in sess.finish():
        offsets.append(w.offset)
        emitted.append(sess.integrate(w.offset, _picker(w.data[None])[0]))
    emitted.append(sess.finalize())
    return offsets, emitted, snaps, sess


def _assert_snapshots_equal(a, b):
    assert a["meta"] == b["meta"]
    assert sorted(a["arrays"]) == sorted(b["arrays"])
    for k in a["arrays"]:
        np.testing.assert_array_equal(a["arrays"][k], b["arrays"][k])


@pytest.mark.parametrize("combine", ["max", "mean"])
@pytest.mark.parametrize("channel0", ["non", "det"])
@pytest.mark.parametrize("length", [331, 40])
def test_session_equals_jax_and_annotate(combine, channel0, length):
    rec, sizes = _gap_and_dup(_record(length, seed=length), _packets(length, seed=7))
    length = len(rec)
    tcfg = tsession.SessionConfig(channel0=channel0, combine=combine, **CFG)
    jcfg = jsession.SessionConfig(channel0=channel0, combine=combine, **CFG)
    t_off, t_emit, t_snaps, tsess = _drive(tsession, tcfg, rec, sizes)
    j_off, j_emit, j_snaps, jsess = _drive(jsession, jcfg, rec, sizes)
    assert t_off == j_off and t_emit == j_emit
    assert len(t_snaps) == len(j_snaps)
    for a, b in zip(t_snaps, j_snaps):
        _assert_snapshots_equal(a, b)
    # The union of the emissions is the port's own annotate of the record
    # (with a pick capacity that does not bind: the session has none).
    offline = tannotate(_picker, rec, window=64, stride=32, batch_size=4,
                        max_events=min(128, max(length, 64) // 2),
                        min_peak_dist=0.1, combine=combine, channel0=channel0)
    picks = tsess.picks
    assert sorted(picks["ppk"]) == sorted(offline["ppk"].tolist())
    assert sorted(picks["spk"]) == sorted(offline["spk"].tolist())
    assert sorted(picks["det"]) == sorted(map(tuple, offline["det"].tolist()))
    if length > 64:
        assert picks["ppk"], "the record's bursts give picks"


@pytest.mark.parametrize("writer,reader", [(tjournal, jsession), (jjournal, tsession)])
def test_a_journal_written_by_one_package_restores_in_the_other(writer, reader):
    """A session journaled mid-record by one package and restored by the
    other emits what the uninterrupted session emits."""
    rec = _record(331, seed=17)
    sizes = _packets(331, seed=3)
    cfg = dict(channel0="non", combine="max", **CFG)
    _, ref_emit, _, _ = _drive(tsession, tsession.SessionConfig(**cfg), rec, sizes)
    other = {tjournal: jjournal, jjournal: tjournal}[writer]
    for k in (1, len(sizes) // 2, len(sizes) - 1):
        blob = writer.state_to_bytes
        restore = (k, lambda snap: reader.StreamSession.restore(
            other.state_from_bytes(blob(snap))))
        mod = tsession if writer is jjournal else jsession
        _, emit, _, _ = _drive(mod, mod.SessionConfig(**cfg), rec, sizes, restore=restore)
        assert emit == ref_emit, f"restored before packet {k}"


def test_journal_bytes_and_files_equal_jax(tmp_path):
    sess = tsession.StreamSession(tsession.SessionConfig(**CFG))
    for w in sess.push(_record(150)):
        sess.integrate(w.offset, _picker(w.data[None])[0])
    state = sess.snapshot()
    assert tjournal.state_to_bytes(state) == jjournal.state_to_bytes(state)
    tj = tjournal.StationJournal(str(tmp_path / "t"), model="m/x")
    jj = jjournal.StationJournal(str(tmp_path / "j"), model="m/x")
    pt, pj = tj.write("CI.STA 01", state), jj.write("CI.STA 01", state)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert pt.replace(str(tmp_path / "t"), "") == pj.replace(str(tmp_path / "j"), "")
    _assert_snapshots_equal(jj.load("CI.STA 01"), tj.load("CI.STA 01"))
    (tmp_path / "t" / "m_x" / "stations" / "bad.npz").write_bytes(b"torn")
    assert tj.load("bad") is None and tj.corrupt_reads == 1
    assert tj.station_ids() == ["CI.STA_01", "bad"]


GEOM = [("S1", 35.0, -117.0), ("S2", 35.2, -117.1), ("S3", 35.1, -116.8),
        ("S4", 34.9, -117.2), ("N1", 36.5, -118.5), ("S5", 35.3, -116.9)]


def _pick_stream(seed):
    """Picks of two events and noise, in arrival order."""
    rng = np.random.default_rng(seed)
    out = []
    for t0, (elat, elon) in ((100.0, (35.05, -117.05)), (160.0, (35.15, -116.95))):
        for sid, lat, lon in GEOM:
            if sid == "N1":
                continue
            t = t0 + jassoc._dist_km(elat, elon, lat, lon) / 6.0 + rng.normal(0, 0.2)
            out.append((sid, lat, lon, t))
    out.append(("N1", 36.5, -118.5, 101.0))
    out += [(sid, lat, lon, 130.0 + 15 * rng.random()) for sid, lat, lon in GEOM[:3]]
    return sorted(out, key=lambda p: p[3])


@pytest.mark.parametrize("seed", [0, 1])
def test_associator_alerts_dedup_and_wal_equal_jax(seed, tmp_path):
    def run(mod, jour, wal_dir, replay):
        wal = jour.AlertWAL(str(wal_dir / "alerts.wal"))
        a = mod.Associator(mod.AssocConfig(min_stations=4, window_s=30.0, tolerance_s=2.0),
                           clock=lambda: 200.0, wal=wal)
        seeded = a.seed_from_wal()
        alerts = []
        for sid, lat, lon, t in _pick_stream(seed) * (2 if replay else 1):
            got = a.add(mod.StationPick(station_id=sid, network="CI", lat=lat, lon=lon, t_s=t,
                                        stamps={"arrival": 1.0, "picked": 1.5}))
            if got is not None:
                alerts.append(got.to_dict())
        return alerts, a.stats(), seeded, a.recent_alerts()

    for replay in (False, True):
        t = run(tassoc, tjournal, tmp_path / f"t{replay}", replay)
        j = run(jassoc, jjournal, tmp_path / f"j{replay}", replay)
        assert t == j
    alerts, stats, _, _ = t
    assert len(alerts) >= 2 and stats["alerts_deduped"] >= 1
    assert all(a["alert_id"].startswith("ev-") for a in alerts)
    # A restarted associator over the port's WAL seeds its dedup window and
    # suppresses the same events again; the JAX package reads that WAL too.
    again_t = run(tassoc, tjournal, tmp_path / "tTrue", False)
    again_j = run(jassoc, jjournal, tmp_path / "tTrue", False)
    assert again_t[2] == again_j[2] == len(alerts)  # the replay added nothing to the WAL
    assert again_t[0] == again_j[0] == []


def test_alert_ids_equal_jax():
    t = tassoc.Associator()
    j = jassoc.Associator()
    for lat, lon, t0, sids in ((35.05, -117.05, 100.3, ["S2", "S1"]),
                               (-12.5, 190.0, -3.0, ["A"]), (0.124, 0.126, 4.99, ["x", "x"])):
        assert t.alert_id_for(lat, lon, t0, sids) == j.alert_id_for(lat, lon, t0, sids)


def test_packet_fates_equal_jax():
    env = {"SEIST_FAULT_STREAM_DROP_P": "0.1", "SEIST_FAULT_STREAM_DUP_P": "0.15",
           "SEIST_FAULT_STREAM_REORDER_P": "0.2", "SEIST_FAULT_STREAM_JOURNAL_CORRUPT_P": "0.3"}
    t = tfaults.StreamFaultInjector.from_env(env)
    j = jfaults.StreamFaultInjector.from_env(env)
    assert t.plan.__dict__ == j.plan.__dict__
    rng = np.random.default_rng(0)
    fates = []
    for i in range(1000):
        sid, seq = f"ST{int(rng.integers(0, 64)):02d}", int(rng.integers(0, 10_000))
        fates.append(t.packet_fate(sid, seq))
        assert fates[-1] == j.packet_fate(sid, seq)
        assert t.corrupt_journal(sid) == j.corrupt_journal(sid)
    assert {"ok", "drop", "dup", "reorder"} == set(fates)
    assert t.packet_fate("ST00", None) == "ok"
    assert tfaults.StreamFaultInjector().packet_fate("ST00", 1) == "ok"


def test_serve_fault_plans_parse_as_jax():
    env = {"SEIST_FAULT_SERVE_KILL_REQ": "7", "SEIST_FAULT_SERVE_SLOW_MS": "2.5",
           "SEIST_FAULT_SERVE_BLACKHOLE_AFTER": "3", "SEIST_FAULT_SERVE_BLACKHOLE_COUNT": "2",
           "SEIST_FAULT_SERVE_BAD_CANDIDATE": "4", "SEIST_FAULT_SERVE_REPLICA": "1"}
    assert tfaults.ServeFaultPlan.from_env(env).__dict__ == \
        jfaults.ServeFaultPlan.from_env(env).__dict__
    for replica in (0, 1):
        t = tfaults.ServeFaultInjector(tfaults.ServeFaultPlan.from_env(env), replica)
        j = jfaults.ServeFaultInjector(jfaults.ServeFaultPlan.from_env(env), replica)
        assert t.enabled == j.enabled == (replica == 1)
        assert [t.is_bad_candidate(v) for v in range(6)] == [j.is_bad_candidate(v)
                                                              for v in range(6)]
    assert not tfaults.ServeFaultInjector().enabled


def test_mux_journals_and_a_new_mux_resumes_the_station(tmp_path):
    """Through the port's mux: a second mux over the same journal resumes
    the station mid-record, and its emissions continue the first's."""
    rec = _record(331, seed=5)
    sizes = _packets(331, seed=9)
    cfg = MuxConfig(session=tsession.SessionConfig(channel0="non", combine="max", **CFG),
                    journal_every_s=0.0, model="m")

    def submit(x):
        return _picker(np.asarray(x)[None])

    def feed_all(mux_for):
        picks, pos = [], 0
        for k, n in enumerate(sizes):
            r = mux_for(k).feed({"id": "A"}, rec[pos : pos + n], seq=k + 1,
                                end=k == len(sizes) - 1)
            picks.append(r["picks"])
            pos += n
        return picks

    ref = StationMux(submit, cfg)
    want = feed_all(lambda k: ref)
    first = StationMux(submit, cfg, journal=tjournal.StationJournal(str(tmp_path), "m"))
    second = StationMux(submit, cfg, journal=tjournal.StationJournal(str(tmp_path), "m"))
    half = len(sizes) // 2
    got = feed_all(lambda k: first if k < half else second)
    assert got == want
    assert second.stats()["restores"] == 1.0 and first.stats()["journal_writes"] >= half
