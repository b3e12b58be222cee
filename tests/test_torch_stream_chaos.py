"""The stream chaos lane on the port (``seist_tpu_torch/stream_chaos.py``),
the counterpart of ``tests/test_stream_chaos.py``: the twin's mainshock
schedule (36 stations, 30 s, seed 7) replayed against three
``twin-replica`` processes on the CPU behind ``supervise-fleet`` and its
router.

* A SIGKILL of the replica that homes the most stations, one round into
  the mainshock: zero missed mainshock alerts over the responses and the
  fleet's WALs, at most three emissions of one ``alert_id``, the kill seen
  end to end (the fault stamp, re-homes counted by the router and in
  ``seist_stream_rehome_total``, the supervisor's re-home line, the
  relaunch), no client failure left unretried, a clean fleet exit.
* Drop, duplicate and reorder packet faults at 3% on every replica: the
  mainshock alert still lands.

Each test prints the lane's ``[stream-chaos] VERDICT {json}`` line.
"""

from __future__ import annotations

import pytest

from seist_tpu_torch import stream_chaos

pytestmark = [pytest.mark.slow, pytest.mark.chaos]


def _verdict(name, gates, detail):
    print(stream_chaos.verdict_line(name, gates, detail), flush=True)
    assert all(gates.values()), (gates, detail)


def test_sigkill_station_heavy_replica_exactly_once(tmp_path):
    gates, detail = stream_chaos.sigkill_run(str(tmp_path), "cpu")
    _verdict("sigkill_station_heavy", gates, detail)


def test_packet_faults_degrade_without_losing_mainshock(tmp_path):
    gates, detail = stream_chaos.packet_fault_run(str(tmp_path), "cpu")
    _verdict("packet_faults", gates, detail)
