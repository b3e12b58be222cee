"""The port's device-augmentation train step against the JAX package's, the
mode resolution of ``--device-aug`` / ``--ingest``, and a mid-epoch resume
on those paths, on the CPU.

``seist_s_dpk`` at window 256 on raw traces of 400 samples (the crop
branch), batch 4, every drop rate 0, every augmentation rate > 0, the same
seeded variables and raw rows on both sides (tests/_torch_parity.py,
``RawStore.build``). The processors draw their own augmentation, the port
through ``ops/threefry.py``; limits as tests/test_torch_step_variants.py:
loss rtol 1e-5; gradient leaves at cosine >= 0.9999 and max error <= 5e-3
of their max (leaves zero by construction exempted below 1e-6 of the
largest); parameters after SGD updates rtol 1e-4, atol 1e-5.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import seist_tpu
from seist_tpu import taskspec as jts
from seist_tpu.data import device_aug as jda
from seist_tpu.data import pipeline as jp
from seist_tpu.models import api as japi
from seist_tpu.train.optim import build_optimizer as j_build_optimizer
from seist_tpu.train.state import create_train_state
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
from seist_tpu_torch.train import optim as toptim
from seist_tpu_torch.train import schedule as tsched
from seist_tpu_torch.train import worker
from seist_tpu_torch.train.checkpoint import load_weights
from seist_tpu_torch.train.step import (
    TrainState,
    make_cached_train_call,
    make_device_aug_train_step,
    step_random_source,
)
from seist_tpu_torch.utils.logger import logger

from _torch_parity import random_flax_variables

MODEL, WINDOW, RAW, BATCH = "seist_s_dpk", 256, 400, 4
DROPS = dict(attn_drop_rate=0.0, key_drop_rate=0.0, mlp_drop_rate=0.0, other_drop_rate=0.0,
             path_drop_rate=0.0)
AUG = dict(augmentation=True, shift_event_rate=0.5, add_noise_rate=0.5, add_gap_rate=0.5,
           drop_channel_rate=0.5, scale_amplitude_rate=0.5, pre_emphasis_rate=0.5,
           generate_noise_rate=0.2, max_event_num=2, add_event_rate=0.5)
LR = {"adam": 1e-3, "sgd": 1e-2}


def _keep_grads() -> optax.GradientTransformation:
    """Passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


@pytest.fixture(scope="module")
def setup():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    common = dict(seed=0, in_samples=WINDOW, data_split=False,
                  dataset_kwargs={"num_events": 12, "trace_samples": RAW}, **AUG)
    jd = jp.from_task_spec(jts.get_task_spec(MODEL), "synthetic", "train", **common)
    td = tp.from_task_spec(tts.get_task_spec(MODEL), "synthetic", "train", **common)
    js, ts = jp.RawStore.build(jd), tp.RawStore.build(td)
    jcfg = jda.AugConfig.from_preprocessor(jd.preprocessor, seed=0, raw_len=RAW,
                                           phase_slots=js.phase_slots)
    tcfg = tda.AugConfig.from_preprocessor(td.preprocessor, seed=0, raw_len=RAW,
                                           phase_slots=ts.phase_slots)
    jm = japi.create_model(MODEL, in_channels=3, in_samples=WINDOW, **DROPS)
    variables = random_flax_variables(japi.param_shapes(jm, in_samples=WINDOW), seed=0)

    def jax_state(opt):
        tx = optax.chain(_keep_grads(), j_build_optimizer(opt, LR[opt]))
        return create_train_state(jm, variables, tx)

    def torch_state(opt):
        tm = tapi.create_model(MODEL, in_samples=WINDOW, **DROPS)
        tm.load_state_dict(state_dict_from_flax(jax.device_get(variables)), strict=True)
        return TrainState(tm, toptim.build_optimizer(opt, tm.parameters()),
                          tsched.constant(LR[opt]))

    return dict(jd=jd, td=td, js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, jax_state=jax_state,
                torch_state=torch_state)


def _as_torch(tree):
    return state_dict_from_flax({"params": jax.device_get(tree)})


def _compare_leaves(model, got, want):
    zero = set(model.zero_grad_parameters())
    gscale = max(float(w.abs().max()) for w in want.values())
    checked = 0
    for k, w in want.items():
        g = got[k].detach()
        noise = max(float(g.abs().max()), float(w.abs().max())) < 1e-6 * gscale
        if k in zero or noise:
            assert noise, k
            continue
        checked += 1
        g, w = g.double().ravel(), w.double().ravel()
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.9999, f"{k}: cosine {cos}"
        assert float((g - w).abs().max() / w.abs().max()) <= 5e-3, k
    assert checked > 100


def _rows_t(rows):
    return tp._tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), rows)


def test_device_aug_step_matches_jax(setup):
    """One guarded Adam step from raw rows, augmented on each side."""
    js, ts = setup["js"], setup["ts"]
    sel = np.array([13, 2, 20, 7])  # 13 and 20: augmented copies (n_raw 12)
    raw, aug = sel % js.n_raw, sel >= js.n_raw
    spec = jts.get_task_spec(MODEL)
    jstep = jax.jit(j_make_device_aug_train_step(
        spec, jts.make_loss(MODEL), jda.make_row_processor(setup["jcfg"], spec.inputs,
                                                           spec.labels), guard=True))
    new, jloss, _, jdiag = jstep(setup["jax_state"]("adam"), js.row_batch(raw),
                                 jnp.asarray(sel, jnp.int32), jnp.asarray(aug), jnp.int32(1),
                                 jax.random.PRNGKey(0))
    state = setup["torch_state"]("adam")
    tspec = tts.get_task_spec(MODEL)
    step = make_device_aug_train_step(
        tts.make_loss(MODEL), tda.make_row_processor(setup["tcfg"], tspec.inputs, tspec.labels))
    loss, out, diag = step(state, _rows_t(ts.row_batch(raw)),
                           torch.from_numpy(sel.astype(np.int32)), torch.from_numpy(aug),
                           torch.tensor(1, dtype=torch.int32), step_random_source(0, 1, 0, "cpu"))
    assert out is None and bool(diag["applied"]) and bool(jdiag["applied"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    model = state.model
    _compare_leaves(model, {k: p.grad for k, p in model.named_parameters()},
                    _as_torch(new.opt_state[0]))
    assert state.step == int(new.step) == 1


def test_cached_call_of_two_matches_jax(setup):
    """A k = 2 call over the resident cache: the ordered applied mask, the
    mean loss and the parameters after two SGD updates."""
    js, ts = setup["js"], setup["ts"]
    idx_k = np.array([[5, 17, 0, 23], [11, 3, 14, 8]], np.int32)
    spec = jts.get_task_spec(MODEL)
    jcall = jax.jit(j_make_cached_train_call(
        spec, jts.make_loss(MODEL),
        jda.make_cache_processor(setup["jcfg"], spec.inputs, spec.labels, n_raw=js.n_raw,
                                 augmentation=True), steps_per_call=2, guard=True))
    new, jloss, _, jdiag = jcall(setup["jax_state"]("sgd"), jp.DeviceEpochCache(js).arrays,
                                 jnp.asarray(idx_k), jnp.int32(2), jax.random.PRNGKey(0))
    state = setup["torch_state"]("sgd")
    tspec = tts.get_task_spec(MODEL)
    call = make_cached_train_call(
        tts.make_loss(MODEL),
        tda.make_cache_processor(setup["tcfg"], tspec.inputs, tspec.labels, n_raw=ts.n_raw,
                                 augmentation=True), steps_per_call=2)
    loss, out, diag = call(state, tp.DeviceEpochCache(ts, "cpu").arrays, torch.from_numpy(idx_k),
                           torch.tensor(2, dtype=torch.int32),
                           [step_random_source(0, 2, j, "cpu") for j in range(2)])
    assert out is None and diag["applied"].tolist() == [1, 1]
    np.testing.assert_array_equal(np.asarray(jdiag["applied"]), [1, 1])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == int(new.step) == 2
    sd = state.model.state_dict()
    for k, v in _as_torch(new.params).items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5, msg=k)


# ------------------------------------------------------ mode resolution
def _args(*extra, events=12):
    return cli.get_args(["--model-name", MODEL, "--dataset-name", "synthetic",
                         "--synthetic-events", str(events), "--in-samples", str(WINDOW),
                         "--batch-size", str(BATCH), "--device", "cpu", *extra])


def _resolve(args, gas=1, spc=1, sds=None):
    spec = tts.get_task_spec(MODEL)
    sds = sds or worker._build_loader(args, spec, "train").dataset
    lines = []
    handler = __import__("logging").Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger.addHandler(handler)
    try:
        mode, store, spc = worker._resolve_device_aug(args, sds, torch.device("cpu"), gas, spc)
    finally:
        logger.removeHandler(handler)
    return mode, store, spc, lines


@pytest.mark.parametrize("extra,gas,spc,match", [
    (["--ingest", "direct"], 1, 1, "--device-aug step"),
    (["--device-aug", "step"], 2, 1, "grad-accum-steps"),
    (["--device-aug", "step"], 1, 2, "requires --device-aug cached"),
    (["--device-aug", "step", "--ingest", "direct"], 1, 1, "packed dataset"),
    (["--device-aug", "cached", "--ingest", "direct"], 1, 1, "requires the device-aug step"),
])
def test_resolution_errors(setup, extra, gas, spc, match):
    with pytest.raises(ValueError, match=match):
        _resolve(_args(*extra), gas=gas, spc=spc)


def test_nan_injection_is_refused_on_device_paths(setup, monkeypatch):
    monkeypatch.setenv("SEIST_FAULT_NAN_STEP", "1")
    with pytest.raises(ValueError, match="SEIST_FAULT_NAN_STEP"):
        _resolve(_args("--device-aug", "cached"))
    assert _resolve(_args())[0] == "off"


def test_resolution_fallbacks_each_log_one_warning(setup, tmp_path):
    mode, store, spc, lines = _resolve(_args("--device-aug", "cached"), spc=4)
    assert (mode, spc, type(store)) == ("cached", 4, tp.RawStore) and not lines
    # Over the budget: cached -> step, and its packing dropped.
    mode, store, spc, lines = _resolve(_args("--device-aug", "cached",
                                             "--device-aug-hbm-gb", "1e-6"), spc=4)
    assert (mode, spc) == ("step", 1)
    assert [x.split(":")[0] for x in lines] == ["--device-aug cached -> step",
                                                "--steps-per-call 4 ignored on the device-aug "
                                                "step fallback path"]
    # An unsupported configuration: the host path.
    mode, store, _, lines = _resolve(_args("--device-aug", "step", "--mask-percent", "10"))
    assert mode == "off" and store is None
    assert len(lines) == 1 and lines[0].startswith("--device-aug step -> off: unsupported")
    # --ingest auto on a pack: the direct shard feed; host: a RawStore.
    pack = tpk.pack_sources([tpk.PackSource(name="synthetic", dataset_kwargs={
        "num_events": 12, "trace_samples": RAW})], str(tmp_path / "pack"),
        samples_per_shard=5)["out"]
    base = ["--dataset-name", "packed", "--data", pack, "--device-aug", "step"]
    mode, store, _, lines = _resolve(_args(*base))
    assert mode == "step" and isinstance(store, ting.PackedRawStore)
    assert lines[0].startswith("packed direct ingest: ")
    assert type(_resolve(_args(*base, "--ingest", "host"))[1]) is tp.RawStore


# -------------------------------------------------- mid-epoch resume
@pytest.mark.parametrize("mode", ["step", "cached"])
def test_mid_epoch_resume_is_bitwise(setup, tmp_path, mode):
    """Train one epoch with an interval save every 2 batches, then resume
    from the first: the final weights equal the uninterrupted run's."""
    extra = ["--device-aug", mode, "--epochs", "1", "--workers", "2", "--mode", "train",
             "--save-interval-steps", "2", "--synthetic-events", "20", "--keep-checkpoints", "20"]
    if mode == "cached":
        extra += ["--steps-per-call", "2"]
    argv = ["--model-name", MODEL, "--dataset-name", "synthetic", "--in-samples", str(WINDOW),
            "--batch-size", str(BATCH), "--device", "cpu"] + extra
    cli.main(argv + ["--log-base", str(tmp_path / "a")])
    (run,) = glob.glob(str(tmp_path / "a" / "*"))
    steps = sorted(int(os.path.basename(p)[6:-3]) for p in
                   glob.glob(os.path.join(run, "checkpoints", "model_*.pt")))
    final = steps[-1]
    whole = load_weights(os.path.join(run, "checkpoints", f"model_{final}.pt"))
    losses = np.load(os.path.join(run, "train_losses.npy"))
    cli.main(argv + ["--checkpoint", os.path.join(run, "checkpoints", "model_2.pt")])
    resumed = load_weights(os.path.join(run, "checkpoints", f"model_{final}.pt"))
    for k, v in whole.items():
        assert torch.equal(v, resumed[k]), k
    tail = np.load(os.path.join(run, "train_losses.npy"))
    np.testing.assert_array_equal(tail, losses[-len(tail):])
