"""Tiered admission in the port (``serve/shed.py``, the batcher's rank
order and queue delay, the protocol's new options) against the JAX
package's: the same decisions and ``Retry-After`` on a scripted delay
sequence, the same flush order by rank, and the same inputs accepted and
refused by ``PredictOptions`` and ``parse_station``."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import dataclasses
import threading
import time

import numpy as np
import pytest

from seist_tpu.serve import batcher as jbatcher
from seist_tpu.serve import protocol as jprotocol
from seist_tpu.serve import shed as jshed

from seist_tpu_torch.obs.bus import BUS
from seist_tpu_torch.serve import batcher as tbatcher
from seist_tpu_torch.serve import protocol as tprotocol
from seist_tpu_torch.serve import shed as tshed


def _decisions(mod, prot, delays, tiers, final_every=0):
    """Each (delay, tier) through a controller whose delay reads the script."""
    it = iter(delays)
    cur = {"d": 0.0}

    def delay():
        return cur["d"]

    ctl = mod.AdmissionController(delay, mod.ShedConfig(batch_delay_ms=50.0,
                                                        interactive_delay_ms=250.0),
                                  model="shed-test")
    out = []
    for i, tier in enumerate(tiers):
        cur["d"] = next(it)
        final = bool(final_every) and i % final_every == 0
        try:
            ctl.admit(tier, final=final)
            out.append(("admit", None, None))
        except prot.Overloaded as e:
            out.append(("shed", e.headers()["Retry-After"], e.payload()))
    stats = ctl.stats()
    ctl.close()
    return out, stats


@pytest.mark.parametrize("final_every", [0, 3])
def test_admission_decisions_equal_jax(final_every):
    rng = np.random.default_rng(final_every)
    # A delay that rises through every threshold, stays, and falls back
    # through the hysteresis band.
    ramp = np.concatenate([np.linspace(0, 400, 40), np.full(20, 300.0),
                           np.linspace(300, 0, 40), rng.uniform(0, 600, 60)])
    tiers = [("batch", "interactive", "alert")[i % 3] for i in range(len(ramp))]
    got = _decisions(tshed, tprotocol, ramp.tolist(), tiers, final_every)
    want = _decisions(jshed, jprotocol, ramp.tolist(), tiers, final_every)
    assert got == want
    decisions, stats = got
    assert {d[0] for d in decisions} == {"admit", "shed"}
    assert stats["tiers"]["alert"]["shed"] == 0  # alerts are never policy-shed
    assert all(int(d[1]) >= 1 for d in decisions if d[0] == "shed")


def test_overloaded_is_a_503_with_retry_after():
    e = tprotocol.Overloaded("x", retry_after_s=2.2)
    assert (e.status, e.code, e.headers(), e.payload()["retry_after_s"]) == (
        503, "shed", {"Retry-After": "3"}, 2.2)
    assert tprotocol.QueueFull("y").headers() == {}


def test_the_controller_publishes_on_the_bus():
    ctl = tshed.AdmissionController(lambda: 75.0, model="shed-bus")
    with pytest.raises(tprotocol.Overloaded):
        ctl.admit("batch")
    ctl.admit("interactive")
    snap = BUS.snapshot()["collectors"]
    assert snap["serve_shed_tiers_batch_shed{model=shed-bus}"] == 1.0
    assert snap["serve_shed_queue_delay_ms{model=shed-bus}"] == 75.0
    assert ctl.shed_level() == 1
    ctl.close()
    assert "serve_shed_level{model=shed-bus}" not in BUS.snapshot()["collectors"]


def _flush_order(mod, ranks):
    """The order a batcher with one slot per flush serves ``ranks``
    submitted while its worker is busy."""
    release = threading.Event()
    order = []

    def forward(batch):
        if not release.wait(timeout=30):
            raise RuntimeError("never released")
        order.append(int(batch[0, 0]))
        return np.asarray(batch)

    b = mod.MicroBatcher(forward, mod.BatcherConfig(max_batch=1, max_delay_ms=0.0,
                                                    max_queue=64), name=f"rank-{mod.__name__}")
    threads = [threading.Thread(target=b.submit, args=(np.full((1,), -1.0),),
                                kwargs={"timeout_ms": 30000, "rank": 1})]
    threads[0].start()
    deadline = time.monotonic() + 30
    while b.stats()["queue_depth"] != 0 or b.stats()["submitted"] != 1:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    for i, rank in enumerate(ranks):  # the worker holds the first one
        t = threading.Thread(target=b.submit, args=(np.full((1,), float(i)),),
                             kwargs={"timeout_ms": 30000, "rank": rank})
        t.start()
        threads.append(t)
        while b.stats()["queue_depth"] != i + 1:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    delay = b.queue_delay_ms()
    assert delay > 0 and b.stats()["queue_delay_ms"] > 0
    release.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert b.queue_delay_ms() == 0.0
    b.shutdown()
    return order[1:]


def test_batcher_flushes_by_rank_as_jax():
    ranks = [2, 1, 0, 2, 0, 1, 1, 0, 2]
    got = _flush_order(tbatcher, ranks)
    assert got == _flush_order(jbatcher, ranks)
    assert [ranks[i] for i in got] == sorted(ranks)  # lowest rank first, FIFO within


OPTIONS = [
    None, {}, {"priority": "alert"}, {"priority": "batch", "stride": 128},
    {"combine": "mean", "record_max_events": 64}, {"stride": 2.0}, {"timeout_ms": 1},
    {"priority": "urgent"}, {"priority": 1}, {"combine": "median"}, {"stride": -1},
    {"record_max_events": 1.5}, {"stride": True}, {"stride": float("nan")},
    {"variant": "bf16", "priority": "interactive"}, {"bogus": 1}, {"max_events": 0},
]


@pytest.mark.parametrize("opts", OPTIONS)
def test_predict_options_accept_and_refuse_as_jax(opts):
    def parse(mod):
        try:
            return dataclasses.asdict(mod.PredictOptions.from_dict(opts))
        except mod.BadRequest as e:
            return ("refused", type(e).__name__)

    assert parse(tprotocol) == parse(jprotocol)


STATIONS = [
    None, {"id": "A"}, {"id": "CI.PAS", "network": "CI", "lat": 34.1, "lon": -118.2},
    {"id": "B", "lat": 0, "lon": 360}, "A", {"network": "CI"}, {"id": ""}, {"id": "x" * 65},
    {"id": "A", "lat": 10.0}, {"id": "A", "lat": 91.0, "lon": 0.0},
    {"id": "A", "lat": True, "lon": 0.0}, {"id": "A", "elev": 3}, {"id": "A", "network": 5},
    {"id": "A", "lat": float("inf"), "lon": 0.0},
]


@pytest.mark.parametrize("station", STATIONS)
@pytest.mark.parametrize("required", [False, True])
def test_parse_station_accepts_and_refuses_as_jax(station, required):
    def parse(mod):
        try:
            return mod.parse_station(station, required=required)
        except mod.BadRequest as e:
            return ("refused", str(e))

    assert parse(tprotocol) == parse(jprotocol)


def test_priorities_equal_jax():
    assert tprotocol.PRIORITIES == jprotocol.PRIORITIES
    assert tprotocol.DEFAULT_PRIORITY == jprotocol.DEFAULT_PRIORITY
    assert dataclasses.asdict(tshed.ShedConfig()) == dataclasses.asdict(jshed.ShedConfig())
