"""The port's task metrics, results CSV and test run against the JAX
package's, on the CPU.

* ``ops/metrics.py``: every task kind (ppk/spk with one and two phases and
  padded predictions, det, onehot pmp, value emg, baz across the +/-180
  wrap, r2) from the same seeded numpy inputs. Counting counters (tp,
  predp, possp, data_size) are equal; the float32 residual sums are equal
  but for the order of the sum (XLA's CPU reduction and torch's add more
  than eight terms in different orders, one float32 rounding apart), so
  they are held at rtol 1e-6; ``finalize`` on the same counters within
  1e-12; the metric values within 1e-6; ``+`` accumulating as ``merge``
  does.
* ``ops/results.py``: the same rows give a byte-identical CSV (the JAX
  package writes it with pandas, the port with the csv module).
* ``train/worker.py``: ``validate`` and ``test_worker`` against
  ``seist_tpu.train.worker.validate(..., testing=True, save_results=True)``
  on the synthetic test split, ``seist_s_dpk`` and ``seist_s_baz`` at
  window 256 with the same seeded weights: loss within 1e-5, counters and
  metric values within 1e-6 of max(1, |value|) (baz's are in degrees, from
  outputs scaled by 360), the CSVs equal row for row (float cells within
  1e-5 relative), and no output probability within 1e-4 of a decode
  threshold, so no decision flips on fp32 noise.
"""

from __future__ import annotations

import csv
import json

import jax
import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu import cli as jcli
from seist_tpu import taskspec as jts
from seist_tpu.ops import metrics as jm
from seist_tpu.ops.results import ResultSaver as JResultSaver
from seist_tpu.train import worker as jworker
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import jit_eval_step, make_eval_step as j_make_eval_step
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.utils.logger import logger as jlogger

import seist_tpu_torch
from seist_tpu_torch import cli as tcli
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.models.convert import save_torch_weights
from seist_tpu_torch.ops import metrics as tm
from seist_tpu_torch.ops.results import ResultSaver as TResultSaver
from seist_tpu_torch.train import worker as tworker
from seist_tpu_torch.train.step import TrainState, make_eval_step

from _torch_parity import model_pair

PAD = int(-1e7)
N, L = 16, 1000


def _cases():
    """(task, metric names, targets, preds) per task kind, from one seed."""
    rng = np.random.default_rng(7)
    t1 = rng.integers(100, 900, (N, 1))
    p1 = t1 + rng.integers(-15, 16, (N, 1))
    p1[::5] = PAD
    t2 = np.sort(rng.integers(50, 950, (N, 2)), axis=1)
    p2 = t2[:, ::-1] + rng.integers(-12, 13, (N, 2))  # swapped order: matching needed
    p2[1::4, 0] = PAD
    t2[3] = [120, PAD]  # one target padded
    det_t = np.stack([t1[:, 0], t1[:, 0] + 200], 1)
    det_p = det_t + rng.integers(-50, 50, (N, 2))
    det_p[2] = [1, 0]  # an empty (padding) interval
    pmp_t = np.eye(2)[rng.integers(0, 2, N)].astype(np.float32)
    pmp_p = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    emg_t = rng.uniform(0, 6, (N, 1)).astype(np.float32)
    emg_p = (emg_t + rng.normal(0, 0.5, (N, 1))).astype(np.float32)
    baz_t = rng.uniform(0, 360, (N, 1)).astype(np.float32)
    baz_t[:4] = [[2.0], [358.0], [179.0], [181.0]]
    baz_p = (baz_t + rng.normal(0, 40, (N, 1))).astype(np.float32)
    baz_p[:4] = [[355.0], [3.0], [-179.0], [10.0]]  # residuals across the wrap
    names = lambda t: jts.get_metrics(t)  # noqa: E731
    return [
        ("ppk", names("ppk"), t1, p1),
        ("spk", names("spk"), t2, p2),
        ("det", names("det"), det_t, det_p),
        ("pmp", names("pmp"), pmp_t, pmp_p),
        ("emg", names("emg"), emg_t, emg_p),
        ("baz", names("baz"), baz_t, baz_p),
    ]


CASES = _cases()


def _pair(task, names):
    kw = dict(task=task, metric_names=names, sampling_rate=50, time_threshold=0.2,
              num_samples=L)
    return jm.Metrics(**kw), tm.Metrics(**kw)


def _assert_counters_equal(jc, tc):
    """Counts exactly; float32 sums up to the order of the sum."""
    assert set(jc) == set(tc)
    for k in jc:
        a, b = np.asarray(jax.device_get(jc[k])), tc[k].cpu().numpy()
        assert a.dtype == b.dtype, k
        if k in tm.REGR_KEYS:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("task,names,t,p", CASES, ids=[c[0] for c in CASES])
def test_counters_and_metrics_match_jax(task, names, t, p):
    jmet, tmet = _pair(task, names)
    half = N // 2
    for sl in (slice(0, half), slice(half, None)):  # two batches, accumulated
        jmet.compute(t[sl], p[sl])
        tmet.compute(t[sl], torch.from_numpy(np.ascontiguousarray(p[sl])))
    _assert_counters_equal(jmet.counters, tmet.counters)
    want, got = jmet.get_all_metrics(), tmet.get_all_metrics()
    assert set(want) == set(got) == set(names)
    for k in names:
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert jmet.to_dict().keys() == tmet.to_dict().keys()
    # finalize alone, on the same host counters and gathered targets
    host = {k: np.asarray(v) for k, v in jax.device_get(jmet.counters).items()}
    tgts = t if "r2" in names else None
    want = jm.finalize(task, names, host, tgts)
    got = tm.finalize(task, names, host, tgts)
    for k in names:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("task,names,t,p", CASES[:2], ids=["ppk", "spk"])
def test_order_phases_matches_jax(task, names, t, p):
    t32, p32 = t.astype(np.int32), p.astype(np.int32)
    want = np.asarray(jm.order_phases(t32, p32))
    got = tm.order_phases(torch.from_numpy(t32), torch.from_numpy(p32)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task,names,t,p", CASES[3:], ids=["pmp", "emg", "baz"])
def test_add_accumulates_like_merge(task, names, t, p):
    a_j, a_t = _pair(task, names)
    b_j, b_t = _pair(task, names)
    a_j.compute(t[:5], p[:5])
    a_t.compute(t[:5], torch.from_numpy(p[:5]))
    b_j.compute(t[5:], p[5:])
    b_t.compute(t[5:], torch.from_numpy(p[5:]))
    both_t = a_t + b_t
    merged = tm.merge(a_t.counters, b_t.counters)
    for k, v in merged.items():
        assert torch.equal(both_t.counters[k], v), k
    _assert_counters_equal((a_j + b_j).counters, both_t.counters)
    assert a_t.counters["data_size"].item() == 5  # `+` leaves its operands alone
    whole = _pair(task, names)[1]
    whole.compute(t, torch.from_numpy(p))
    for k, v in whole.get_all_metrics().items():
        assert abs(both_t.get_all_metrics()[k] - v) <= 1e-6 * max(1.0, abs(v)), k


def test_result_saver_csv_is_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    tasks = ["det", "ppk", "spk", "pmp", "baz"]
    savers = JResultSaver(tasks), TResultSaver(tasks)
    for b in range(2):
        n = 4 - b
        meta = {"key": [f"ev{b}_{i}" for i in range(n)], "snr": [str(x) for x in
                                                                  rng.uniform(0, 30, n)]}
        targets = {
            "det": rng.integers(0, 500, (n, 2)), "ppk": rng.integers(-5, 500, (n, 2)),
            "spk": rng.integers(0, 500, (n, 1)), "pmp": np.eye(2)[rng.integers(0, 2, n)],
            "baz": rng.uniform(0, 360, (n, 1)).astype(np.float32),
        }
        preds = {
            "det": rng.integers(0, 500, (n, 2)).astype(np.int32),
            "ppk": np.where(rng.uniform(size=(n, 2)) < 0.3, PAD,
                            rng.integers(1, 500, (n, 2))).astype(np.int32),
            "spk": rng.integers(-3, 500, (n, 1)).astype(np.int32),
            "pmp": rng.uniform(0, 1, (n, 2)).astype(np.float32),
            "baz": rng.uniform(0, 360, (n, 1)).astype(np.float32),
        }
        savers[0].append(meta, targets, preds)
        savers[1].append(meta, targets, {k: torch.from_numpy(v) for k, v in preds.items()})
    paths = tmp_path / "jax.csv", tmp_path / "torch.csv"
    for s, path in zip(savers, paths):
        s.save_as_csv(str(path))
    assert paths[1].read_bytes() == paths[0].read_bytes()


# ----------------------------------------------------------- validate and test
FLAGS = ["--dataset-name", "synthetic", "--synthetic-events", "60", "--in-samples", "256",
         "--batch-size", "4", "--workers", "2", "--seed", "0"]
THRESHOLDS = {"ppk": 0.3, "spk": 0.3, "det": 0.5}


def _jax_validate(name, variables, jm_model, log_dir):
    seist_tpu.load_all()
    args = jcli.get_args(FLAGS + ["--model-name", name])
    spec = jts.get_task_spec(name)
    state = create_train_state(jm_model, variables, j_build_optimizer("adam", 1e-3))
    eval_step = jit_eval_step(j_make_eval_step(spec, jts.make_loss(name)), None)
    jlogger.set_logdir(str(log_dir))
    loader = jworker._build_loader(args, spec, "test")
    try:
        return jworker.validate(args, state, eval_step, spec, loader, None, testing=True,
                                save_results=True)
    finally:
        loader.close()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _cells_equal(a, b):
    if a == b:
        return True
    try:
        return abs(float(a) - float(b)) <= 1e-5 * max(1.0, abs(float(b)))
    except ValueError:
        return False


@pytest.mark.parametrize("name", ["seist_s_dpk", "seist_s_baz"])
def test_validate_and_test_worker_match_jax(name, tmp_path):
    jm_model, variables, model = model_pair(name, 256, seed=1)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jloss, jmetrics = _jax_validate(name, variables, jm_model, jdir)

    seist_tpu_torch.load_all()
    args = tcli.get_args(FLAGS + ["--model-name", name, "--device", "cpu"])
    args.log_dir = str(tdir)
    tdir.mkdir()
    spec = tts.get_task_spec(name)
    loader = tworker._build_loader(args, spec, "test")
    assert len(loader) == 2 and loader.dataset.name() == "synthetic_test"
    state = TrainState(model)
    outputs = []
    step = make_eval_step(tts.make_loss(name))

    def recording_step(*a):
        loss, out = step(*a)
        outputs.append(out)
        return loss, out

    loss, metrics = tworker.validate(args, state, recording_step, spec, loader,
                                     torch.device("cpu"))
    loader.close()
    if name.endswith("dpk"):  # no decision within fp32 noise of a threshold
        out = torch.cat(outputs).numpy()
        for i, task in enumerate(("det", "ppk", "spk")):
            gap = np.abs(out[..., i] - THRESHOLDS[task]).min()
            assert gap > 1e-4, (task, gap)
    assert abs(loss - jloss) <= 1e-5
    for task, jmet in jmetrics.items():
        jc, tc = jmet.counters, metrics[task].counters
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{task}.{k}")
        want, got = jmet.get_all_metrics(), metrics[task].get_all_metrics()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (task, k, got[k], want[k])
    if name.endswith("dpk"):
        assert metrics["ppk"].counters["possp"] > 0

    weights = tmp_path / "w.pt"
    save_torch_weights(jax.device_get(variables), str(weights))
    args.checkpoint = str(weights)
    test_loss = tworker.test_worker(args)
    assert abs(test_loss - jloss) <= 1e-5
    payload = json.loads((tdir / "test_metrics_synthetic.json").read_text())
    assert payload["model"] == name and payload["dataset"] == "synthetic"
    for task, jmet in jmetrics.items():
        want = jmet.get_metrics(jmet.metric_names())
        assert payload["metrics"][task].keys() == want.keys()
        for k, v in want.items():
            assert abs(payload["metrics"][task][k] - v) <= 1e-6 * max(1.0, abs(v)), (task, k)
    jrows = _rows(jdir / "test_results_synthetic_test.csv")
    trows = _rows(tdir / "test_results_synthetic_test.csv")
    assert len(trows) == len(jrows) == 7  # the header and the 6 real rows (2 batches of 4)
    assert trows[0] == jrows[0]
    for tr, jr in zip(trows[1:], jrows[1:]):
        assert len(tr) == len(jr) and all(_cells_equal(a, b) for a, b in zip(tr, jr)), (tr, jr)
    # A second test run in the same directory does not overwrite the first.
    tworker.test_worker(args)
    assert (tdir / "test_metrics_synthetic_new.json").exists()
    assert (tdir / "test_results_synthetic_test_new.csv").exists()
