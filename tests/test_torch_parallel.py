"""Multi-rank training of the port (``seist_tpu_torch/parallel/``) against
the JAX package's, on the CPU.

Two gloo ranks start once for the module (``tests/_torch_dist_worker.py``,
through the port's env contract ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES``
/ ``PROCESS_ID``) and run every check in that one start: one train step
of ``seist_s_dpk`` (window 256, global batch 4) under ``data=2`` and
under ``seq=2`` (``seist_tpu_torch/parallel/check.py``), from the JAX
package's seeded variables, with attention dropout 0.3 and every other
drop rate 0; the same two steps from the port's own init at every drop
rate 0.3; the task metrics synchronised over the ranks; then ``python -m
seist_tpu_torch train --seq-shards 2`` itself, in the same processes.

The JAX reference is one jitted guarded train step under
``make_mesh(data=1, seq=2)`` on the global batch, whose attention seeds
are fixed (``jax.random.randint`` patched while it traces) and given to
the port's steps as their seed buffer. Limits (``PERF.md`` §2, the
train-step row): loss rtol 1e-5; gradient leaves cosine >= 0.9999 and
max error <= 5e-3 of their max, the leaves zero by construction below
1e-6 of the largest gradient, a leaf below 1e-6 of the largest on both
sides fp32 noise; BatchNorm statistics rtol 1e-4 / atol 1e-5; the
train-mode forward 2e-4 (``tests/test_ring_attention.py:200``). The
port's two ranks against its one rank at every drop rate 0.3: the same
limits. ``_shard_order`` and the epoch orders are byte-identical to the
JAX package's.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import os
import pickle
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.data import pipeline as jpipe
from seist_tpu.models import api as japi
from seist_tpu.ops import metrics as jm
from seist_tpu.parallel import mesh as jmesh
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import jit_step, make_train_step as j_make_train_step

import seist_tpu_torch
from seist_tpu_torch.data import pipeline as tpipe
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.parallel import check
from seist_tpu_torch.parallel import dist as tdist
from seist_tpu_torch.parallel import mesh as tmesh

from _torch_dist_worker import Launch, free_port
from _torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parent.parent
MODEL, WINDOW, GLOBAL, LR = "seist_s_dpk", 256, 4, 1e-3
ATTN_ONLY = dict(path_drop_rate=0.0, attn_drop_rate=0.3, key_drop_rate=0.0, mlp_drop_rate=0.0,
                 other_drop_rate=0.0)
ALL_03 = dict(path_drop_rate=0.3, attn_drop_rate=0.3, key_drop_rate=0.3, mlp_drop_rate=0.3,
              other_drop_rate=0.3)
LAUNCH_TIMEOUT_S = 300.0
N_ROWS, BOUNDS = 12, [0, 5, 12]  # the metrics' rows and each rank's (unequal: R2's padding)


def _keep_grads() -> optax.GradientTransformation:
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def _metric_cases():
    rng = np.random.default_rng(41)
    ppk_t = rng.integers(0, WINDOW, (N_ROWS, 1))
    ppk_p = np.where(rng.random((N_ROWS, 1)) < 0.8, ppk_t + rng.integers(-8, 9, (N_ROWS, 1)),
                     -1)
    emg_t = rng.normal(2.0, 1.0, (N_ROWS, 1)).astype(np.float32)
    emg_p = (emg_t + rng.normal(0.0, 0.3, (N_ROWS, 1))).astype(np.float32)
    return {"ppk": (ppk_t.astype(np.int64), ppk_p.astype(np.int64)), "emg": (emg_t, emg_p)}


def _jax_step(variables, x, y, seeds):
    """JAX's guarded step on the global batch under a seq-2 mesh, the
    attention seeds fixed in call order. Returns (new state, loss,
    outputs)."""
    jmodel = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **ATTN_ONLY)
    tx = optax.chain(_keep_grads(), j_build_optimizer("adam", LR))
    mesh = jmesh.make_mesh(data=1, model=1, seq=2, devices=jax.devices()[:2])
    state = jmesh.replicate(mesh, create_train_state(jmodel, variables, tx))
    xb, yb = jmesh.shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y)))
    calls = []

    def fixed_seed(key, shape, minval, maxval, dtype=jnp.int32):
        calls.append(len(calls))
        return jnp.full(shape, int(seeds[len(calls) - 1]), dtype)

    step = jit_step(j_make_train_step(jts.get_task_spec(MODEL), jts.make_loss(MODEL),
                                      guard=True), mesh=mesh, donate_state=False)
    with jmesh.use_mesh(mesh), mock.patch.object(jax.random, "randint", fixed_seed):
        new, loss, outputs, diag = step(state, xb, yb, jax.random.PRNGKey(0))
    assert len(calls) == len(seeds) and int(diag["applied"]) == 1
    return jax.device_get(new), float(loss), np.asarray(outputs)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two ranks' records (every check of the module) and the JAX
    reference, computed while the ranks run."""
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    out = tmp_path_factory.mktemp("parallel")
    jmodel = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **ATTN_ONLY)
    variables = random_flax_variables(japi.param_shapes(jmodel, in_samples=WINDOW), seed=0)
    torch.save(state_dict_from_flax(jax.device_get(variables)), out / "w.pt")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, GLOBAL, WINDOW, 3)).astype(np.float32)
    y = rng.uniform(0.0, 1.0, (1, GLOBAL, WINDOW, 3)).astype(np.float32)
    n_calls = len(tapi.create_model(MODEL, in_samples=WINDOW).attention_shapes(WINDOW))
    seeds = rng.integers(1, 2**31 - 1, (1, n_calls)).astype(np.int32)
    np.savez(out / "parity.npz", x=x, y=y, attention_seeds=seeds)
    parity = dict(global_batch=GLOBAL, steps=1, drop=ATTN_ONLY, lr=LR,
                  inputs=str(out / "parity.npz"), weights=str(out / "w.pt"))
    own = dict(global_batch=GLOBAL, steps=1, drop=ALL_03, lr=LR)
    cases = _metric_cases()
    np.savez(out / "metrics.npz", **{f"{t}_{k}": a for t, (tt, pp) in cases.items()
                                     for k, a in (("t", tt), ("p", pp))})
    spec = {
        "out": str(out),
        "check": {"model": MODEL, "window": WINDOW, "device": "cpu", "seed": 0,
                  "runs": [dict(parity, seq=1), dict(parity, seq=2), dict(own, seq=1),
                           dict(own, seq=2)]},
        "metrics": {"inputs": str(out / "metrics.npz"), "tasks": list(cases), "bounds": BOUNDS,
                    "names": {t: jts.get_metrics(t) for t in cases}, "num_samples": WINDOW},
        "cli": {"address": f"127.0.0.1:{free_port()}", "argv": [
            "--device", "cpu", "--model-name", MODEL, "--dataset-name", "synthetic",
            "--synthetic-events", "20", "--in-samples", str(WINDOW), "--batch-size", "4",
            "--epochs", "1", "--seq-shards", "2", "--workers", "1", "--use-tensorboard",
            "false", "--log-base", str(out / "cli")]},
    }
    launch = Launch("parallel", spec, 2, LAUNCH_TIMEOUT_S)
    try:
        jax_ref = _jax_step(variables, x[0], y[0], seeds[0])
    finally:
        launch.wait()
    runs = [[torch.load(out / f"run{i}_rank{r}.pt") for r in range(2)] for i in range(4)]
    return {"out": out, "spec": spec, "runs": runs, "jax": jax_ref, "x": x, "cases": cases,
            "metrics": [torch.load(out / f"metrics_rank{r}.pt") for r in range(2)],
            "cli": [torch.load(out / f"cli_rank{r}.pt") for r in range(2)]}


def _compare_grads(got, want, model):
    """PERF.md §2's train-step limits (module docstring)."""
    zero = set(model.zero_grad_parameters())
    gscale = max(float(w.abs().max()) for w in want.values())
    checked = 0
    for k, w in want.items():
        g = got[k].detach()
        if k in zero:
            assert max(float(g.abs().max()), float(w.abs().max())) < 1e-6 * gscale, k
            continue
        if max(float(g.abs().max()), float(w.abs().max())) < 1e-6 * gscale:
            continue  # fp32 noise on both sides
        g, w = g.double().ravel(), w.double().ravel()
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.9999, f"{k}: grad cosine {cos}"
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel <= 5e-3, f"{k}: rel grad err {rel}"
        checked += 1
    assert checked > 100


def _compare_stats(got_state, want_state):
    for k, v in want_state.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got_state[k], v, rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.parametrize("run,label", [(0, "data=2"), (1, "seq=2")])
def test_parallel_step_matches_jax(launched, run, label):
    new, jloss, jout = launched["jax"]
    recs = launched["runs"][run]
    model = tapi.create_model(MODEL, in_samples=WINDOW, **ATTN_ONLY)
    for rec in recs:  # every rank holds the global loss and gradients
        np.testing.assert_allclose(rec["losses"][0], jloss, rtol=1e-5)
        _compare_grads(rec["grads"], state_dict_from_flax({"params": new.opt_state[0]}), model)
        _compare_stats(rec["state"], state_dict_from_flax({"batch_stats": new.batch_stats}))
    if recs[0]["data"] == 2:  # each data rank holds its rows of the outputs
        outputs = torch.cat([r["outputs"] for r in recs]).numpy()
    else:
        outputs = recs[0]["outputs"].numpy()
        np.testing.assert_array_equal(recs[1]["outputs"].numpy(), outputs)
    np.testing.assert_allclose(outputs, jout, rtol=2e-4, atol=2e-4)


def test_ranks_hold_byte_identical_parameters(launched):
    for recs in launched["runs"]:
        assert recs[0]["checksum"] == recs[1]["checksum"]
        for k, v in recs[0]["state"].items():
            assert torch.equal(v, recs[1]["state"][k]), k


@pytest.mark.parametrize("run", [2, 3], ids=["data=2", "seq=2"])
def test_two_ranks_match_one_rank_at_every_drop_rate(launched, run):
    spec = launched["spec"]["check"]
    one = check.run_steps(spec, dict(spec["runs"][run], seq=1), torch.device("cpu"))
    assert one["data"] == one["seq"] == 1
    model = tapi.create_model(MODEL, in_samples=WINDOW, **ALL_03)
    for rec in launched["runs"][run]:
        np.testing.assert_allclose(rec["losses"], one["losses"], rtol=1e-5)
        _compare_grads(rec["grads"], one["grads"], model)
        _compare_stats(rec["state"], one["state"])


@pytest.mark.parametrize("task", ["ppk", "emg"])
def test_synced_metrics_match_jax(launched, task):
    t, p = launched["cases"][task]
    want = jm.Metrics(task=task, metric_names=jts.get_metrics(task), sampling_rate=50,
                      time_threshold=0.2, num_samples=WINDOW)
    want.compute(t, p)
    expect = want.get_all_metrics()
    for synced in launched["metrics"]:
        got = synced[task]["metrics"]
        assert set(got) == set(expect)
        for k, v in expect.items():
            assert abs(got[k] - v) <= 1e-6 * max(1.0, abs(v)), (k, got[k], v)
        for k, v in jax.device_get(want.counters).items():
            np.testing.assert_allclose(synced[task]["counters"][k].numpy(), np.asarray(v),
                                       rtol=1e-6, err_msg=k)


def test_train_entry_runs_two_ranks_with_seq_shards(launched):
    """``python -m seist_tpu_torch train --seq-shards 2`` on two ranks of
    the env contract: one run directory (rank 0's), the checkpoint and
    test metrics written once, the ranks' parameters equal at the end."""
    best = [c["best"] for c in launched["cli"]]
    assert best[0] == best[1] and os.path.exists(best[0])
    run_dir = Path(best[0]).parent.parent
    assert (run_dir / "train_losses.npy").exists()
    assert (run_dir / "test_metrics_synthetic.json").exists()
    log = (launched["out"] / "parallel_rank0.log").read_text()
    assert "mesh: {'data': 1, 'model': 1, 'seq': 2}" in log
    assert "[dist] parameters byte-identical over 2 ranks" in log
    assert [p.name for p in (launched["out"] / "cli").iterdir()] == [run_dir.name]


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("n", [12, 13, 14])
def test_shard_order_and_epoch_orders_match_jax(world, n):
    order = np.random.default_rng(n).permutation(n)
    sources = np.arange(n) % 3
    for r in range(world):
        want = jpipe._shard_order(order, world, r)
        got = tpipe._shard_order(order, world, r)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        kw = dict(seed=5, epoch=2, num_shards=world, shard_index=r)
        for shuffle in (False, True):
            assert np.array_equal(tpipe.epoch_indices(n, shuffle=shuffle, **kw),
                                  jpipe.epoch_indices(n, shuffle=shuffle, **kw))
        assert np.array_equal(tpipe.mixture_epoch_indices(sources, temperature=2.0, **kw),
                              jpipe.mixture_epoch_indices(sources, temperature=2.0, **kw))
    shards = [tpipe._shard_order(order, world, r) for r in range(world)]
    assert len({len(s) for s in shards}) == 1  # equal: the head of the order wraps
    assert set(np.concatenate(shards)) == set(order)


def test_loader_shards_by_data_rank():
    seist_tpu_torch.load_all()
    spec = seist_tpu_torch.taskspec.get_task_spec(MODEL)
    sds = tpipe.from_task_spec(spec, "synthetic", "val", seed=0, in_samples=WINDOW,
                               augmentation=False, dataset_kwargs={"num_events": 60})
    n = len(sds)
    loaders = [tpipe.Loader(sds, 2, num_workers=1, num_shards=2, shard_index=r)
               for r in range(2)]
    shard = -(-n // 2)
    assert len(loaders[0]) == len(loaders[1]) == -(-shard // 2)
    seen = np.concatenate([ld._indices() for ld in loaders])
    assert set(seen) == set(range(n))


@pytest.mark.parametrize("data,seq", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_rank_layout_is_jax_s_device_order(data, seq):
    want = np.vectorize(lambda d: d.id)(jmesh.make_mesh(data=data, model=1, seq=seq).devices)
    np.testing.assert_array_equal(tmesh.rank_layout(data, 1, seq), want)
    for rank in range(data * seq):
        m = tmesh.make_mesh(seq=seq, world=data * seq, rank=rank)
        d, _, s = m.coords
        assert want[d, 0, s] == rank and (m.data, m.seq) == (data, seq)
        assert (m.data_index, m.seq_index) == (d, s)


def test_mesh_refuses_a_shape_that_does_not_cover_the_ranks():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_mesh(seq=2, world=3, rank=0)
    with pytest.raises(ValueError, match="model axis"):
        tmesh.make_mesh(model=2, world=2, rank=0)
    assert tmesh.shard_batch(tmesh.make_mesh(world=2, rank=1), np.arange(6)).tolist() == [3, 4, 5]


class _FakeStore:
    """In-memory stand-in for the group's TCP store."""

    def __init__(self, data=None):
        self.data = data if data is not None else {}
        self.deleted = []

    def set(self, key, value):
        self.data[key] = value if isinstance(value, bytes) else str(value).encode()

    def get(self, key):
        return self.data[key]

    def wait(self, keys, timeout=None):
        missing = [k for k in keys if k not in self.data]
        if missing:
            raise TimeoutError(f"keys {missing} never published")

    def add(self, key, n):
        value = int(self.data.get(key, b"0")) + n
        self.data[key] = str(value).encode()
        return value

    def delete_key(self, key):
        self.deleted.append(key)
        return self.data.pop(key, None) is not None


@pytest.fixture
def fake_ranks(monkeypatch):
    """broadcast_object's ranks, faked: (store, set_rank)."""
    store = _FakeStore()
    monkeypatch.setattr(tdist, "_broadcast_seq", 0)
    monkeypatch.setattr(tdist, "_store", lambda: store)
    monkeypatch.setattr(tdist, "process_count", lambda: 2)
    rank = [0]
    monkeypatch.setattr(tdist, "process_index", lambda: rank[0])
    return store, rank


def test_broadcast_object_passes_through_on_one_rank():
    obj = {"a": 1}
    assert tdist.broadcast_object(obj) is obj
    assert tdist.all_gather_object(obj) == [obj]


def test_broadcast_object_rank0_publishes_and_cleans_up(fake_ranks):
    store, _ = fake_ranks
    store.data["seist_tpu_torch/broadcast_object/0/read/all"] = b"1"  # the other rank's arrival
    obj = {"ckpt": "/path/step_120", "step": 120}
    assert tdist.broadcast_object(obj) == obj
    assert "seist_tpu_torch/broadcast_object/0" in store.deleted
    assert "seist_tpu_torch/broadcast_object/0" not in store.data


def test_broadcast_object_rank1_reads_rank0_payload(fake_ranks):
    store, rank = fake_ranks
    rank[0] = 1
    obj = ["eval", 0.25, np.float64(3.5)]
    store.data["seist_tpu_torch/broadcast_object/0"] = pickle.dumps(obj)
    store.data["seist_tpu_torch/broadcast_object/0/read/all"] = b"1"
    assert tdist.broadcast_object(None) == obj
    assert store.deleted == []  # rank 0 owns the cleanup


def test_broadcast_object_sequences_successive_calls(fake_ranks):
    store, _ = fake_ranks
    for i in range(3):
        store.data[f"seist_tpu_torch/broadcast_object/{i}/read/all"] = b"1"
    tdist.broadcast_object("first")
    tdist.broadcast_object("second")
    tdist.barrier()
    values = [k for k in store.deleted if not k.endswith(("/read", "/all"))]
    assert values == ["seist_tpu_torch/broadcast_object/0", "seist_tpu_torch/broadcast_object/1"]
    # each call deletes the barrier keys of the call before it
    assert "seist_tpu_torch/broadcast_object/1/read" in store.deleted


def test_env_contract_and_torchrun_are_read(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist._rendezvous(None, None, None) is None
    assert tdist.init_distributed_mode(device="cpu") is False
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert tdist._rendezvous(None, None, None) == ("10.0.0.1:1234", 4, 3, 3)
    monkeypatch.setenv("PROCESS_ID", "4")
    with pytest.raises(ValueError, match="outside"):
        tdist._rendezvous(None, None, None)
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdist._rendezvous(None, None, None) == ("127.0.0.1:29511", 8, 5, 1)


def test_a_described_launch_that_cannot_start_raises(tmp_path):
    """With the env contract present and no rank 0 to reach, the train
    entry raises within the group's timeout; it never trains alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               NUM_PROCESSES="2", PROCESS_ID="1", SEIST_DIST_TIMEOUT_S="3")
    proc = subprocess.run(
        [sys.executable, "-m", "seist_tpu_torch", "train", "--device", "cpu", "--model-name",
         MODEL, "--dataset-name", "synthetic", "--synthetic-events", "20", "--in-samples",
         str(WINDOW), "--batch-size", "4", "--steps", "1", "--use-tensorboard", "false",
         "--log-base", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "log dir" not in proc.stdout and not any(tmp_path.iterdir())


def test_capture_refuses_the_gloo_backend(monkeypatch):
    from seist_tpu_torch.train import graph, step as step_lib

    card = torch.device("cuda", 0)
    state = mock.Mock(model=torch.nn.Linear(2, 2))
    monkeypatch.setattr(step_lib, "_device_of", lambda model: card)
    assert graph._on_cuda(state) == card
    monkeypatch.setattr(tdist, "backend", lambda: "gloo")
    with pytest.raises(RuntimeError, match="gloo"):
        graph.Captured(lambda: None, [], card)
    # The capture wrappers run the eager step under gloo, and only there.
    assert graph._on_cuda(state) is None
    ran = []
    run = graph.capture_eval_step(lambda *a: ran.append(a) or ("loss", "out"))
    assert run(state, "x", "y", "m") == ("loss", "out") and len(ran) == 1
    # The eager train step gets the host batch on the model's device, as a
    # replay would copy it in ("meta" stands in for the card here).
    monkeypatch.undo()
    on_meta = mock.Mock(model=torch.nn.Linear(2, 2, device="meta"))
    seen = []
    step = graph.capture_train_step(
        lambda st, x, y, rng: seen.append((x.device, y["p"].device)) or ("loss", None, {}))
    assert step(on_meta, torch.ones(2), {"p": torch.ones(1)}, None)[0] == "loss"
    assert seen == [(torch.device("meta"), torch.device("meta"))]


def test_torchrun_launches_the_train_entry(tmp_path):
    """``torchrun --nproc-per-node 2 -m seist_tpu_torch train``: the ranks
    join the store torchrun's agent serves and train as the env contract's
    do."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(free_port()), "-m", "seist_tpu_torch", "train", "--device", "cpu",
         "--model-name", MODEL, "--dataset-name", "synthetic", "--synthetic-events", "20",
         "--in-samples", str(WINDOW), "--batch-size", "4", "--epochs", "1", "--workers", "1",
         "--mode", "train", "--use-tensorboard", "false", "--log-base", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh: {'data': 2, 'model': 1, 'seq': 1}" in proc.stdout
    assert "[dist] parameters byte-identical over 2 ranks" in proc.stdout
    assert len([p for p in tmp_path.iterdir() if p.is_dir()]) == 1
