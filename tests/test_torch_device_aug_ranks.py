"""Device augmentation over several data ranks (``--device-aug step|cached``
under a ``data=2`` mesh, ``step`` under ``--seq-shards 2``) against the JAX
package's data-mesh step and cached call, on the CPU.

Two gloo ranks start once for the module (``tests/_torch_dist_worker.py``
``device_aug``, through the env contract) and run every check in that one
start, ``seist_s_dpk`` at window 256 on raw traces of 400 samples, global
batch 4 (two rows a rank), from the JAX package's seeded variables with
attention dropout 0.3 (its seeds fixed: ``jax.random.randint`` patched
while JAX traces, the same seeds as the port's seed buffer) and every other
drop rate 0:

* one augmenting Adam step on each rank's rows against
  ``jit_device_aug_step(make_device_aug_train_step(...), make_mesh(data=2))``
  on the global batch;
* a k = 2 cached SGD call over each rank's shard of the cache against
  ``jit_cached_call(..., mesh, DeviceEpochCache(store, mesh).arrays)`` in the
  forced 8-device CPU mesh of ``tests/conftest.py`` (the JAX scan traces its
  step once, so both steps share the attention seeds on both sides);
* each rank's cache rows against the JAX cache's shard on its device, the
  rows each rank's exchange delivered against the store's, and each rank's
  processed rows against the same rows processed in one batch;
* the direct-ingest feed of a pack under injected faults: each rank stages
  only its shard's rows, byte-identical to the JAX package's feed of that
  shard, and a quarantined sample's fallback stays keyed by its global
  index (the ranks' rows equal one rank's for every index);
* the train entry itself in the same processes: ``step`` and ``cached``
  under ``data=2`` (one run directory, byte-identical parameters, the same
  parameters in both modes, ``ceil(n / 2)`` cache rows a rank), against
  one rank at the global batch whose order is the ranks' rows side by side;
  ``step`` under ``--seq-shards 2`` against one rank.

Limits: the train-step row of ``PERF.md`` §2 (``tests/test_torch_parallel.py``):
loss rtol 1e-5; gradient leaves cosine >= 0.9999 and max error <= 5e-3 of
their max, the leaves zero by construction below 1e-6 of the largest
gradient, a leaf below 1e-6 of the largest on both sides fp32 noise;
BatchNorm statistics rtol 1e-4 / atol 1e-5; parameters after SGD updates
rtol 1e-4 / atol 1e-5 (``tests/test_torch_device_aug_train.py``). Caches,
exchanged and processed rows, shards and orders: bitwise. The entry runs
against one rank: step losses rtol 1e-5 (the same steps, their sums in
another order).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import re
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
from seist_tpu.data import device_aug as jda
from seist_tpu.data import ingest as jing
from seist_tpu.data import pipeline as jp
from seist_tpu.models import api as japi
from seist_tpu.parallel import mesh as jmesh
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
from seist_tpu.train.step import jit_cached_call, jit_device_aug_step
from seist_tpu.train.step import make_cached_train_call as j_make_cached_train_call
from seist_tpu.train.step import make_device_aug_train_step as j_make_device_aug_train_step

import seist_tpu_torch
from seist_tpu_torch import cli
from seist_tpu_torch import taskspec as tts
from seist_tpu_torch.data import device_aug as tda
from seist_tpu_torch.data import ingest as ting
from seist_tpu_torch.data import packed as tpk
from seist_tpu_torch.data import pipeline as tp
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.parallel import mesh as tmesh
from seist_tpu_torch.parallel.check import flat_tensors
from seist_tpu_torch.train import worker

from _torch_dist_worker import Launch, free_port
from _torch_parity import random_flax_variables

MODEL, WINDOW, RAW, GLOBAL = "seist_s_dpk", 256, 400, 4
ATTN_ONLY = dict(path_drop_rate=0.0, attn_drop_rate=0.3, key_drop_rate=0.0, mlp_drop_rate=0.0,
                 other_drop_rate=0.0)
AUG = dict(augmentation=True, shift_event_rate=0.5, add_noise_rate=0.5, add_gap_rate=0.5,
           drop_channel_rate=0.5, scale_amplitude_rate=0.5, pre_emphasis_rate=0.5,
           generate_noise_rate=0.2, max_event_num=2, add_event_rate=0.5)
DATASET = dict(seed=0, in_samples=WINDOW, data_split=False,
               dataset_kwargs={"num_events": 12, "trace_samples": RAW}, **AUG)
LR = {"adam": 1e-3, "sgd": 1e-2}
SEL = [13, 2, 20, 7]  # 13 and 20: augmented copies (n_raw 12)
IDX_K = [[5, 17, 0, 23], [11, 3, 14, 8]]
EVENTS = 20  # the entry runs: 16 train events, x2 by augmentation
LAUNCH_TIMEOUT_S = 300.0


def _keep_grads() -> optax.GradientTransformation:
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def _entry_argv(log_base: str, *extra: str, batch: int = GLOBAL // 2) -> list:
    return ["--device", "cpu", "--model-name", MODEL, "--dataset-name", "synthetic",
            "--synthetic-events", str(EVENTS), "--in-samples", str(WINDOW), "--batch-size",
            str(batch), "--epochs", "1", "--workers", "1", "--mode", "train",
            "--use-tensorboard", "false", "--log-base", log_base, *extra]


def _jax_runs(variables, js, jcfg, seeds):
    """JAX's augmenting step and k = 2 cached call under make_mesh(data=2),
    the attention seeds fixed; and its cache's shard on each device."""
    spec = jts.get_task_spec(MODEL)
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **ATTN_ONLY)
    mesh = jmesh.make_mesh(data=2, model=1, seq=1, devices=jax.devices()[:2])
    calls = []

    def fixed_seed(key, shape, minval, maxval, dtype=jnp.int32):
        calls.append(len(calls))
        return jnp.full(shape, int(seeds[len(calls) - 1]), dtype)

    def state(opt):
        tx = optax.chain(_keep_grads(), j_build_optimizer(opt, LR[opt]))
        return jmesh.replicate(mesh, create_train_state(jm, variables, tx))

    loss = jts.make_loss(MODEL)
    sel = np.asarray(SEL)
    step = jit_device_aug_step(j_make_device_aug_train_step(
        spec, loss, jda.make_row_processor(jcfg, spec.inputs, spec.labels), guard=True), mesh)
    cache = jp.DeviceEpochCache(js, mesh)
    call = jit_cached_call(j_make_cached_train_call(
        spec, loss, jda.make_cache_processor(jcfg, spec.inputs, spec.labels, n_raw=js.n_raw,
                                             augmentation=True), steps_per_call=2, guard=True),
        mesh, cache.arrays)
    out = {}
    with jmesh.use_mesh(mesh), mock.patch.object(jax.random, "randint", fixed_seed):
        new, jloss, _, diag = step(state("adam"), js.row_batch(sel % js.n_raw),
                                   jnp.asarray(sel, jnp.int32), jnp.asarray(sel >= js.n_raw),
                                   jnp.int32(1), jax.random.PRNGKey(0))
        assert len(calls) == len(seeds)
        out["step"] = (jax.device_get(new), float(jloss), np.asarray(diag["applied"]))
        calls.clear()
        new, jloss, _, diag = call(state("sgd"), cache.arrays, jnp.asarray(IDX_K, jnp.int32),
                                   jnp.int32(2), jax.random.PRNGKey(0))
        assert len(calls) == len(seeds)
        out["cached"] = (jax.device_get(new), float(jloss), np.asarray(diag["applied"]))

    def shard(a, r):
        parts = sorted(a.addressable_shards, key=lambda sh: sh.index[0].start or 0)
        return np.asarray(parts[r].data)

    out["shards"] = [jax.tree.map(lambda a: shard(a, r), cache.arrays) for r in range(2)]
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    out = tmp_path_factory.mktemp("device_aug_ranks")
    jd = jp.from_task_spec(jts.get_task_spec(MODEL), "synthetic", "train", **DATASET)
    td = tp.from_task_spec(tts.get_task_spec(MODEL), "synthetic", "train", **DATASET)
    js, ts = jp.RawStore.build(jd), tp.RawStore.build(td)
    jcfg = jda.AugConfig.from_preprocessor(jd.preprocessor, seed=0, raw_len=RAW,
                                           phase_slots=js.phase_slots)
    tcfg = tda.AugConfig.from_preprocessor(td.preprocessor, seed=0, raw_len=RAW,
                                           phase_slots=ts.phase_slots)
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **ATTN_ONLY)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), seed=0)
    torch.save(state_dict_from_flax(jax.device_get(variables)), out / "w.pt")
    n_calls = len(tapi.create_model(MODEL, in_samples=WINDOW).attention_shapes(WINDOW))
    seeds = np.random.default_rng(11).integers(1, 2**31 - 1, n_calls).astype(np.int32)
    np.save(out / "seeds.npy", seeds)
    cli_runs = {
        "step": _entry_argv(str(out / "cli_step"), "--device-aug", "step"),
        "cached": _entry_argv(str(out / "cli_cached"), "--device-aug", "cached",
                              "--steps-per-call", "2"),
        "seq": _entry_argv(str(out / "cli_seq"), "--device-aug", "step", "--seq-shards", "2",
                           batch=GLOBAL),
    }
    spec = {
        "out": str(out),
        "device_aug": {"model": MODEL, "window": WINDOW, "dataset": DATASET,
                       "weights": str(out / "w.pt"), "seeds": str(out / "seeds.npy"),
                       "drop": ATTN_ONLY, "lr": LR, "sel": SEL, "idx_k": IDX_K},
        "cli": {k: {"address": f"127.0.0.1:{free_port()}", "argv": v}
                for k, v in cli_runs.items()},
        # The one-rank references, one a rank after the group's runs.
        "one": {"seq": {"argv": _entry_argv(str(out / "one_seq"), "--device-aug", "step",
                                            batch=GLOBAL), "ranks": 1, "batch": GLOBAL},
                "step": {"argv": _entry_argv(str(out / "one_step"), "--device-aug", "step",
                                             batch=GLOBAL), "ranks": 2, "batch": GLOBAL // 2}},
    }
    launch = Launch("device_aug", spec, 2, LAUNCH_TIMEOUT_S)
    try:
        jax_ref = _jax_runs(variables, js, jcfg, seeds)
    finally:
        launch.wait()
    one = {}
    for r in range(2):
        rec = torch.load(out / f"one_rank{r}.pt")
        one[rec["label"]] = np.load(Path(rec["best"]).parent.parent / "train_losses.npy")
    return {"out": out, "jax": jax_ref, "ts": ts, "tcfg": tcfg, "td": td, "one": one,
            "ranks": [torch.load(out / f"device_aug_rank{r}.pt") for r in range(2)],
            "cli": [torch.load(out / f"cli_rank{r}.pt") for r in range(2)],
            "logs": [(out / f"device_aug_rank{r}.log").read_text() for r in range(2)]}


def _compare_grads(got, want, model):
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
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-3, k
        checked += 1
    assert checked > 100


def _compare_stats(got_state, batch_stats):
    for k, v in state_dict_from_flax({"batch_stats": batch_stats}).items():
        torch.testing.assert_close(got_state[k], v, rtol=1e-4, atol=1e-5, msg=k)


def _leaves(tree, path=""):
    """A tree's leaves by key path, in the keys' sorted order (jax.tree's
    order for dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    return [tree]


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_device_aug_step_on_two_ranks_matches_jax(launched):
    new, jloss, applied = launched["jax"]["step"]
    model = tapi.create_model(MODEL, in_samples=WINDOW, **ATTN_ONLY)
    assert bool(applied)
    for rank in launched["ranks"]:
        rec = rank["step"]
        assert bool(rec["applied"])
        np.testing.assert_allclose(float(rec["loss"]), jloss, rtol=1e-5)
        _compare_grads(rec["grads"], state_dict_from_flax({"params": new.opt_state[0]}), model)
        _compare_stats(rec["state"], new.batch_stats)


def test_cached_call_on_two_ranks_matches_jax(launched):
    new, jloss, applied = launched["jax"]["cached"]
    np.testing.assert_array_equal(applied, [1, 1])
    want = state_dict_from_flax({"params": new.params})
    for rank in launched["ranks"]:
        rec = rank["cached"]
        assert rec["applied"].tolist() == [1, 1]
        np.testing.assert_allclose(float(rec["loss"]), jloss, rtol=1e-5)
        for k, v in want.items():
            torch.testing.assert_close(rec["state"][k], v, rtol=1e-4, atol=1e-5, msg=k)
        _compare_stats(rec["state"], new.batch_stats)


def test_each_rank_holds_its_shard_of_the_cache(launched):
    ts = launched["ts"]
    rows = -(-ts.n_raw // 2)
    for r, rank in enumerate(launched["ranks"]):
        rec = rank["cached"]
        assert rec["rows"] == rows == 6
        got, want = _leaves(rec["cache"]), _leaves(launched["jax"]["shards"][r])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _equal(g.numpy(), w)
        for g, s in zip(got, _leaves(ts.arrays)):
            assert _equal(g.numpy(), s[r * rows:(r + 1) * rows])


def test_exchange_delivers_the_ranks_rows_bitwise(launched):
    ts = launched["ts"]
    first = np.asarray(IDX_K[0])
    for r, rank in enumerate(launched["ranks"]):
        (got, *_), mine = rank["cached"]["exchanged"], first[2 * r:2 * r + 2]
        assert len(rank["cached"]["exchanged"]) == 2  # one exchange a step
        for g, w in zip(_leaves(got), _leaves(ts.row_batch(mine % ts.n_raw))):
            assert _equal(g.numpy(), w)


def _processed_on_one_rank(launched, rows, idx, epoch):
    spec = tts.get_task_spec(MODEL)
    proc = tda.make_row_processor(launched["tcfg"], spec.inputs, spec.labels)
    ts = launched["ts"]
    idx = np.asarray(idx)
    return proc(tp._tree_map(torch.from_numpy, rows), torch.from_numpy(idx.astype(np.int32)),
                torch.from_numpy(idx >= ts.n_raw), torch.tensor(epoch, dtype=torch.int32))


@pytest.mark.parametrize("mode", ["step", "cached"])
def test_each_ranks_processed_rows_equal_one_batchs(launched, mode):
    """A rank's rows augmented on their own equal the same rows of the
    global batch augmented on one rank: the draws are keyed by the global
    epoch index."""
    ts = launched["ts"]
    calls = [(SEL, 1)] if mode == "step" else [(IDX_K[0], 2), (IDX_K[1], 2)]
    for j, (idx, epoch) in enumerate(calls):
        whole = _processed_on_one_rank(launched, ts.row_batch(np.asarray(idx) % ts.n_raw), idx,
                                       epoch)
        for r, rank in enumerate(launched["ranks"]):
            got = flat_tensors(list(rank[mode]["processed"][j]))
            want = flat_tensors(list(whole))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert torch.equal(g, w[2 * r:2 * r + 2])


def test_train_entry_runs_both_modes_over_two_data_ranks(launched):
    """One run directory a run, byte-identical parameters over the ranks
    and between the modes (the exchange delivers what the host gather
    does), each rank's cache share logged; rank 0's losses against one rank
    at the global batch in the ranks' order."""
    logs = launched["logs"]
    shas = re.findall(r"parameters byte-identical over 2 ranks \(sha256 (\w+)\)", logs[0])
    assert len(shas) == 3  # step, cached, seq
    assert shas[0] == shas[1]
    assert "8 of 16 raw rows on this rank (data rank 0 of 2)" in logs[0]  # rank 1 logs warnings
    assert "mesh: {'data': 2, 'model': 1, 'seq': 1}" in logs[0]
    for c in launched["cli"]:
        assert c["step"] == launched["cli"][0]["step"]
    runs = {}
    for mode in ("step", "cached"):
        dirs = [p for p in (launched["out"] / f"cli_{mode}").iterdir()]
        assert len(dirs) == 1
        runs[mode] = np.load(dirs[0] / "train_losses.npy")
    assert len(runs["step"]) == len(launched["one"]["step"]) == 8
    np.testing.assert_allclose(runs["step"], launched["one"]["step"], rtol=1e-5)
    # A cached call records the mean loss of its k = 2 updates.
    np.testing.assert_allclose(runs["cached"], runs["step"].reshape(-1, 2).mean(1), rtol=1e-6)


def test_train_entry_device_aug_step_under_seq_shards(launched):
    """``--seq-shards 2``: both ranks augment the same rows (the global
    batch); rank 0's losses against one rank's."""
    assert "mesh: {'data': 1, 'model': 1, 'seq': 2}" in launched["logs"][0]
    (run,) = list((launched["out"] / "cli_seq").iterdir())
    losses = np.load(run / "train_losses.npy")
    np.testing.assert_allclose(losses, launched["one"]["seq"], rtol=1e-5)


# ------------------------------------------------ in this process, no launch
@pytest.fixture(scope="module")
def stores():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    jd = jp.from_task_spec(jts.get_task_spec(MODEL), "synthetic", "train", **DATASET)
    td = tp.from_task_spec(tts.get_task_spec(MODEL), "synthetic", "train", **DATASET)
    return jp.RawStore.build(jd), tp.RawStore.build(td), td


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_feeds_shard_the_epoch_as_jax_does(stores, world, shuffle):
    js, ts, _ = stores
    for r in range(world):
        kw = dict(seed=3, shuffle=shuffle, batch_size=2, num_shards=world, shard_index=r)
        got = list(tp.iter_raw_batches(ts, 1, **kw))
        want = list(jp.iter_raw_batches(js, 1, **kw))
        assert len(got) == len(want) > 0
        for (rows, idx, aug), (jrows, jidx, jaug) in zip(got, want):
            assert _equal(idx, jidx) and _equal(aug, jaug)
            for g, w in zip(_leaves(rows), _leaves(jrows)):
                assert _equal(g, w)
        chunks = dict(seed=3, shuffle=shuffle, batch_size=2, steps_per_call=2, num_shards=world,
                      shard_index=r)
        tc = list(tp.DeviceEpochCache(ts, "cpu").epoch_index_chunks(1, **chunks))
        jc = list(jp.DeviceEpochCache(js).epoch_index_chunks(1, **chunks))
        assert len(tc) == len(jc) > 0 and all(_equal(a, b) for a, b in zip(tc, jc))


@pytest.mark.parametrize("world", [2, 5])
def test_cache_shards_and_exchange_chunks(stores, world):
    """Each rank's shard (zero rows padded past n_raw, as the JAX cache
    pads before it shards) against the JAX cache's shard on that device;
    the exchange chunks hold every rank's epoch_index_chunks."""
    js, ts, _ = stores
    mesh = jmesh.make_mesh(data=world, model=1, seq=1, devices=jax.devices()[:world])
    jcache = jp.DeviceEpochCache(js, mesh)
    rows = -(-ts.n_raw // world)
    for r in range(world):
        cache = tp.DeviceEpochCache(ts, "cpu", tmesh.Mesh(data=world, rank=r))
        assert (cache.rows, cache.shards, cache.shard_index) == (rows, world, r)
        for g, a in zip(_leaves(cache.arrays), _leaves(jcache.arrays)):
            parts = sorted(a.addressable_shards, key=lambda sh: sh.index[0].start or 0)
            assert _equal(g.numpy(), np.asarray(parts[r].data))
        kw = dict(seed=3, shuffle=True, batch_size=2, steps_per_call=2)
        together = list(cache.exchange_index_chunks(1, **kw))
        assert together and all(c.shape == (2, world, 2) for c in together)
        for d in range(world):
            alone = list(cache.epoch_index_chunks(1, num_shards=world, shard_index=d, **kw))
            assert all(_equal(t[:, d], a) for t, a in zip(together, alone))


def test_one_rank_exchange_is_a_copy_of_the_gather(stores):
    """Without a group the exchange is a copy: the (1, B) path of the cache
    processor gives the (B,) path's rows and outputs bitwise."""
    _, ts, td = stores
    cache = tp.DeviceEpochCache(ts, "cpu")
    idx = torch.tensor([5, 17, 0, 23], dtype=torch.int32)
    raw = (idx % ts.n_raw).to(torch.int64)
    got = tp.exchange_rows(cache.arrays, raw[None], 0)
    for g, w in zip(_leaves(got), _leaves(ts.row_batch(raw.numpy()))):
        assert _equal(g.numpy(), w)
    cfg = tda.AugConfig.from_preprocessor(td.preprocessor, seed=0, raw_len=RAW,
                                          phase_slots=ts.phase_slots)
    spec = tts.get_task_spec(MODEL)
    one = tda.make_cache_processor(cfg, spec.inputs, spec.labels, n_raw=ts.n_raw,
                                   augmentation=True, mesh=tmesh.Mesh())
    epoch = torch.tensor(2, dtype=torch.int32)
    for a, b in zip(flat_tensors(list(one(cache.arrays, idx[None], epoch))),
                    flat_tensors(list(one(cache.arrays, idx, epoch)))):
        assert torch.equal(a, b)


def test_direct_ingest_stages_a_ranks_rows_keyed_by_global_index(tmp_path, monkeypatch):
    """``--ingest direct`` on two ranks: each rank's staged batches equal
    the JAX package's for the same shard, bitwise, under a corrupt and a
    flaky read; every quarantine fallback is the one a single rank reads
    for the same (epoch, global index)."""
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    pack = tpk.pack_sources([tpk.PackSource(name="synthetic", dataset_kwargs={
        "num_events": 24, "trace_samples": 700, "cache": False})], str(tmp_path / "pack"),
        samples_per_shard=7, dtype="float32")["out"]
    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", "2,5,9")
    monkeypatch.setenv("SEIST_FAULT_IO_FLAKY_P", "0.2")
    kw = dict(seed=3, in_samples=WINDOW, data_dir=pack, max_quarantine_frac=0.5, **AUG)

    def feeds(pkg_pipe, pkg_ing, pkg_spec, shards):
        """Every shard's batches of epoch 1, each from a store of its own
        (a rank's), with each store's quarantine report."""
        out = []
        for r in range(shards):
            ds = pkg_pipe.from_task_spec(pkg_spec.get_task_spec(MODEL), "packed", "train", **kw)
            store = pkg_ing.PackedRawStore.build(ds, batch_size=4)
            out.append((list(pkg_pipe.iter_raw_batches(store, 1, seed=3, shuffle=True,
                                                       batch_size=4, num_shards=shards,
                                                       shard_index=r)),
                        ds.quarantine_report()["quarantined"]))
        return out

    ranks = feeds(tp, ting, tts, 2)
    for (got, _), (want, _) in zip(ranks, feeds(jp, jing, jts, 2)):
        assert len(got) == len(want) > 0
        for (tr, ti, ta), (jr, ji, ja) in zip(got, want):
            assert _equal(ti, ji) and _equal(ta, ja)
            for g, w in zip(_leaves(tr), _leaves(jr)):
                assert _equal(g, w)
    ((one, _),) = feeds(tp, ting, tts, 1)
    by_index = {int(i): tp._tree_map(lambda a, j=j: a[j], rows)
                for rows, idx, _ in one for j, i in enumerate(idx)}
    seen = 0
    for batches, _ in ranks:
        for rows, idx, _ in batches:
            for j, i in enumerate(idx):
                if int(i) in by_index:  # the shards wrap; one rank drops its tail
                    seen += 1
                    for g, w in zip(_leaves(tp._tree_map(lambda a, j=j: a[j], rows)),
                                    _leaves(by_index[int(i)])):
                        assert _equal(g, w)
    assert seen >= len(by_index) - 4
    assert sorted(set(ranks[0][1]) | set(ranks[1][1])) == [2, 5, 9]


def _resolve(stores, tmp_budget_frac: float, ranks: int):
    _, _, td = stores
    est = tp.RawStore.estimate_bytes(td)
    args = cli.get_args(["--model-name", MODEL, "--dataset-name", "synthetic", "--in-samples",
                         str(WINDOW), "--device", "cpu", "--device-aug", "cached",
                         "--device-aug-hbm-gb", repr(est * tmp_budget_frac / 2**30)])
    mode, _, _ = worker._resolve_device_aug(args, td, torch.device("cpu"), 1, 1, ranks)
    return mode


@pytest.mark.parametrize("frac,ranks,mode", [
    (0.75, 1, "step"),  # the whole cache over one card's budget
    (0.75, 2, "cached"),  # a rank's half fits
    (0.4, 2, "step"),  # not even a half fits
    (1.5, 1, "cached"),
])
def test_the_budget_is_compared_per_rank(stores, frac, ranks, mode):
    assert _resolve(stores, frac, ranks) == mode
