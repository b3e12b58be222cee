"""The port's six baseline families against the JAX package's, on the CPU.

Each family runs at its published widths (the defaults of its flax
dataclass) with the same seeded flax variables on both sides, converted by
``state_dict_from_flax`` (tests/_torch_parity.py), at window 512
(DiTingMotion at its own 128), batch 2. Outputs within 1e-5 absolute in
eval mode; in train mode with drop rates 0 within 1e-5 of max(1, the
largest output) (DistPTNetwork sums eleven blocks normalised by batch
statistics to outputs of about 4), the BatchNorm statistics within rtol
1e-4 / atol 1e-5.

BAZNetwork's eigen features come from each side's ``eigh``: LAPACK on
both, but jaxlib's and torch's builds may return an eigenvector with the
opposite sign. The port is held to JAX's features (passed as its
``(x, features)`` input, what a captured step passes) at 1e-5, and on its
own features where every eigenvector's sign agrees; the flipped windows
are counted, not hidden.

Units: the registry's 21 names, the transposed conv's flip, the LSTM's
single bias and its gates, LayerNorm's eps 1e-6, the banded mask at odd
widths, the initialisers' spread, the L1 selectors and the flags' refusal,
and PhaseNet served on the CPU, its decode equal to the JAX package's.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_parity import model_pair

import seist_tpu
from seist_tpu import taskspec as jtaskspec
from seist_tpu.models import api as japi
from seist_tpu.models import common as jcommon
from seist_tpu.models import eqtransformer as jeqt
from seist_tpu.models.baz_network import _cov_features
from seist_tpu.ops.postprocess import decode_head_batch
from seist_tpu.registry import MODELS as JMODELS
from seist_tpu.serve import server as jserver

import seist_tpu_torch
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models import common as tcommon
from seist_tpu_torch.models import eqtransformer as teqt
from seist_tpu_torch.models.baz_network import cov_features
from seist_tpu_torch.models.convert import save_torch_weights, state_dict_from_flax
from seist_tpu_torch.registry import MODELS as TMODELS
from seist_tpu_torch.serve import server as tserver
from seist_tpu_torch.serve.pool import decode_outputs
from seist_tpu_torch.serve.protocol import PredictOptions

ATOL = 1e-5
#: family -> (window, input channels)
FAMILIES = {
    "phasenet": (512, 3),
    "eqtransformer": (512, 3),
    "magnet": (512, 3),
    "baz_network": (512, 3),
    "ditingmotion": (128, 2),
    "distpt_network": (512, 3),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    name = request.param
    window, c = FAMILIES[name]
    jm, variables, tm = model_pair(name, window, seed=3, in_channels=c)
    return name, window, c, jm, variables, tm


def _x(window, c, n=2, seed=1):
    return np.random.default_rng(seed).standard_normal((n, window, c)).astype(np.float32)


def _leaves(out):
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else (out,))]


def _port_input(name, x):
    """The port's input: BAZNetwork takes JAX's eigen features beside x."""
    t = torch.from_numpy(x)
    return (t, torch.from_numpy(np.array(_cov_features(jnp.asarray(x))))) \
        if name == "baz_network" else t


def _sign_agrees(x) -> np.ndarray:
    """Per window: every eigenvector of the port's eigh has JAX's sign."""
    want = np.asarray(_cov_features(jnp.asarray(x)))[:, 4:]
    got = cov_features(torch.from_numpy(x)).numpy()[:, 4:]
    return (np.abs(got - want) < 1e-4).all(axis=(1, 2))


def test_eval_forward_matches_jax(pair):
    name, window, c, jm, variables, tm = pair
    x = _x(window, c)
    want = _leaves(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = _leaves(tm(_port_input(name, x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and w.std() > 1e-4  # a live signal
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    if name == "baz_network":
        # On the port's own features, where every eigenvector's sign agrees.
        x = _x(window, c, n=8, seed=2)
        agree = _sign_agrees(x)
        want = _leaves(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
        with torch.no_grad():
            got = _leaves(tm(torch.from_numpy(x)))
        print(f"baz_network: eigenvector signs agree in {int(agree.sum())} of {len(agree)} "
              "windows (LAPACK builds)")
        assert agree.any()
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[agree], w[agree], rtol=0, atol=ATOL)


def test_train_forward_matches_jax(pair):
    """Train mode, drop rates 0: batch statistics normalise, the running
    ones update as the JAX package's."""
    name, window, c, jm, variables, tm = pair
    jm0 = japi.create_model(name, in_channels=c, in_samples=window, drop_rate=0.0)
    tm0 = tapi.create_model(name, in_channels=c, in_samples=window, drop_rate=0.0)
    tm0.load_state_dict(tm.state_dict())
    x = _x(window, c, seed=4)
    out, mutated = jax.jit(lambda v, x: jm0.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    tm0.train()
    with torch.no_grad():
        got = _leaves(tm0(_port_input(name, x)))
    for g, w in zip(got, _leaves(out)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * max(1.0, float(np.abs(w).max())))
    stats = state_dict_from_flax({"batch_stats": jax.device_get(mutated.get("batch_stats", {}))})
    sd = tm0.state_dict()
    for k, v in stats.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-4, atol=1e-5, msg=k)
    assert bool(stats) == (name not in ("magnet", "baz_network", "ditingmotion"))


def test_the_registry_holds_the_jax_names():
    seist_tpu.load_all()
    seist_tpu_torch.load_all()
    assert TMODELS.names() == JMODELS.names() and len(TMODELS) == 21


def test_conv_transpose_flips_the_flax_kernel():
    """flax ConvTranspose (VALID, no kernel transpose) correlates with the
    kernel as stored; the converted torch weight is flipped. L_out =
    (L-1)*s + k for k >= s."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    m = fnn.ConvTranspose(4, (7,), strides=(4,), padding="VALID", use_bias=False)
    v = m.init(jax.random.PRNGKey(0), x)
    want = np.asarray(m.apply(v, x))
    conv = tcommon.ConvTranspose1d(5, 4, 7, stride=4)
    sd = state_dict_from_flax({"params": {"convt": jax.device_get(v["params"])}})
    kernel = np.asarray(v["params"]["kernel"])
    np.testing.assert_array_equal(sd["convt.weight"].numpy(), kernel[::-1].transpose(1, 2, 0))
    conv.load_state_dict({"weight": sd["convt.weight"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, (9 - 1) * 4 + 7, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    unflipped = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x).transpose(1, 2), torch.from_numpy(kernel.transpose(1, 2, 0).copy()),
        stride=4).transpose(1, 2).numpy()
    assert np.abs(unflipped - want).max() > 0.1  # the flip matters


@pytest.mark.parametrize("bidirectional", [False, True])
def test_the_lstm_has_one_bias_and_flax_gates(bidirectional):
    """Gates (i, f, g, o) from flax's per-gate kernels; torch's input bias
    is a zero buffer, in neither the parameters nor the state_dict."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    jm = jcommon.BiLSTM(5) if bidirectional else jcommon.LSTM(5)
    v = jm.init(jax.random.PRNGKey(0), x)
    v = jax.tree.map(lambda a: a + 0.3 * rng.standard_normal(a.shape).astype(np.float32), v)
    want_out, want_h = jm.apply(v, x)
    lstm = tcommon.LSTM(6, 5, bidirectional=bidirectional)
    sd = state_dict_from_flax({"params": {"lstm": jax.device_get(v["params"])}})
    lstm.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()}, strict=True)
    names = {n for n, _ in lstm.named_parameters()}
    assert not any(n.startswith("bias_ih") for n in names | set(lstm.state_dict()))
    assert all(float(b.abs().max()) == 0 for n, b in lstm.named_buffers() if "bias_ih" in n)
    assert len(names) == 3 * (2 if bidirectional else 1)
    with torch.no_grad():
        out, h = lstm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)


def test_layer_norm_takes_flax_eps():
    """flax LayerNorm's eps is 1e-6 (torch's default 1e-5): at a channel
    variance of 1e-5 the two differ by ~30%."""
    x = (np.random.default_rng(2).standard_normal((3, 8)) * 3e-3).astype(np.float32)
    m = fnn.LayerNorm()
    want = np.asarray(m.apply(m.init(jax.random.PRNGKey(0), x), x))
    ln = tcommon.LayerNorm(8)
    assert ln.eps == 1e-6
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
        default = torch.nn.LayerNorm(8)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(default - want).max() > 1e-2


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 6, 7])
def test_the_band_mask_floors_the_negated_width(width):
    """EQTransformer's local attention band, odd widths included (the
    lower bound is (-w)//2, so w = 3 keeps j - i in [-2, 0])."""
    x = np.random.default_rng(width).standard_normal((1, 9, 4)).astype(np.float32)
    ja = jeqt.AttentionLayer(6, attn_width=width)
    v = ja.init(jax.random.PRNGKey(width), x)
    _, want = ja.apply(v, x)
    ta = teqt.AttentionLayer(4, 6, attn_width=width)
    sd = state_dict_from_flax({"params": {"a": jax.device_get(v["params"])}})
    ta.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    with torch.no_grad():
        _, got = ta(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    mask = teqt.band_mask(9, width).numpy()
    np.testing.assert_array_equal(np.asarray(want)[0] > 0, mask)
    d = np.arange(9)[None, :] - np.arange(9)[:, None]
    assert mask[d == (-width) // 2].all() and not mask[d == (-width) // 2 - 1].any()


def _spread(model):
    """name -> (std, max |w|, fan_in, kind) of each kernel the init draws."""
    out = {}
    for mod_name, m in model.named_modules():
        if isinstance(m, tcommon.LSTM):
            for n, p in m.named_parameters(recurse=False):
                if n.startswith("weight"):
                    kind = "lecun" if "ih" in n else "orthogonal"
                    out[f"{mod_name}.{n}"] = (p, p.shape[1], kind)
        elif isinstance(m, teqt.AttentionLayer):
            for n in ("Wx", "Wt", "Wa"):
                w = getattr(m, n)
                out[f"{mod_name}.{n}"] = (w, w.shape, "xavier")
        elif isinstance(m, teqt.FeedForward):
            for n in ("lin0", "lin1"):
                w = getattr(m, n).weight
                out[f"{mod_name}.{n}.weight"] = (w, w.shape, "xavier")
        elif isinstance(m, (torch.nn.Linear, tcommon.Conv1d, tcommon.ConvTranspose1d)):
            if mod_name.endswith(("lin0", "lin1")) and ".ff" in f".{mod_name}":
                continue
            w = m.weight
            fan_in = (w.shape[0] * w.shape[2] if isinstance(m, tcommon.ConvTranspose1d)
                      else w[0].numel())
            out[f"{mod_name}.weight"] = (w, fan_in, "lecun")
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_follows_the_flax_initialisers(name):
    """Kernels pooled by initialiser: lecun_normal (std 1/sqrt(fan_in), cut
    at 2 std of its normal), xavier_uniform (limit sqrt(6/(fan_in +
    fan_out))), the LSTM's orthogonal recurrent kernels (W Wᵀ = I per
    gate); biases zero, norm scales one. The pooled std of w*sqrt(fan_in)
    lies within 10% of 1 (thousands of draws per family)."""
    window, c = FAMILIES[name]
    model = tapi.create_model(name, in_channels=c, in_samples=window, seed=7)
    lecun = []
    for key, (w, fan, kind) in _spread(model).items():
        w = w.detach()
        if kind == "lecun":
            z = (w * np.sqrt(fan)).reshape(-1)
            assert float(z.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-4, key
            lecun.append(z)
        elif kind == "xavier":
            fan_in, fan_out = fan
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(w.abs().max()) <= limit + 1e-6, key
            assert float(w.std()) > 0.4 * limit / np.sqrt(3), key
        else:
            for gate in w.split(w.shape[1], dim=0):
                torch.testing.assert_close(gate @ gate.T, torch.eye(w.shape[1]), atol=1e-4,
                                           rtol=0, msg=key)
    z = torch.cat(lecun)
    assert z.numel() > 1000 and 0.9 < float(z.std()) < 1.1, float(z.std())
    for n, p in model.named_parameters():
        if n.endswith("bias") or n.split(".")[-1] in ("bh", "ba") or "bias_hh" in n:
            assert float(p.abs().max()) == 0, n
    for m in model.modules():
        if isinstance(m, (tcommon.BatchNorm, torch.nn.LayerNorm)):
            assert bool((m.weight == 1).all())


def test_the_l1_selectors_match_jax():
    """``l1_param_mask`` selects the same leaves in both packages."""
    window = 512
    jm = japi.create_model("eqtransformer", in_samples=window)
    shapes = japi.param_shapes(jm, in_samples=window)["params"]
    tm = tapi.create_model("eqtransformer", in_samples=window)
    names = [n for n, _ in tm.named_parameters()]
    for kind in ("kernel", "bias"):
        jmask = jeqt.l1_param_mask(shapes, kind)
        flat = jax.tree_util.tree_leaves_with_path(jmask)
        want = sorted(".".join(str(k.key) for k in p[:-1]) + (".weight" if kind == "kernel"
                                                               else ".bias")
                      for p, sel in flat if sel)
        got = sorted(n for n in names if teqt.l1_param_mask(kind)(n))
        assert got == want and len(got) == 7 + 3 * 7
    with pytest.raises(ValueError):
        teqt.l1_param_mask("scale")


def test_the_l1_flags_refuse_other_models(tmp_path):
    from seist_tpu_torch import cli

    argv = ["--device", "cpu", "--dataset-name", "synthetic", "--synthetic-events", "8",
            "--in-samples", "128", "--batch-size", "2", "--epochs", "1", "--workers", "1",
            "--log-base", str(tmp_path), "--model-name", "phasenet"]
    for flag in ("--conv-kernel-l1-alpha", "--conv-bias-l1-alpha"):
        with pytest.raises(ValueError, match="apply only to eqtransformer"):
            cli.main(argv + [flag, "1e-3"])
    args = cli.get_args(argv)
    assert args.conv_kernel_l1_alpha == args.conv_bias_l1_alpha == 0.0


# ------------------------------------------------------------ PhaseNet served
WINDOW, FS = 512, 50
OPTS = {"max_events": 2, "ppk_threshold": 0.3, "spk_threshold": 0.3}


def _decoded_like_jax(got: dict, want: dict) -> bool:
    """The port's JSON holds exactly decode_head_batch's picks and detections."""
    for kind in ("ppk", "spk"):
        if [p["sample"] for p in got[kind]] != [int(s) for s in want[kind][0] if s >= 0]:
            return False
    return [(d["onset"], d["offset"]) for d in got.get("det", [])] == [
        (int(a), int(b)) for a, b in np.asarray(want.get("det", np.zeros((1, 0))))[0]
        .reshape(-1, 2) if b >= a]


def test_phasenet_serves_and_decodes_like_jax(tmp_path):
    """PhaseNet through the port's server on the CPU: concurrent /predict
    requests answer with picks within 0.1 s of the JAX model's decode, and
    the port's decode of a given output equals the JAX package's
    ``decode_head_batch`` exactly."""
    jm, variables, _ = model_pair("phasenet", WINDOW, seed=5)
    weights = str(tmp_path / "phasenet.pt")
    save_torch_weights(jax.device_get(variables), weights)
    service = tserver.build_service([("phasenet", weights)], window=WINDOW, device="cpu",
                                    max_batch=4, max_delay_ms=200.0,
                                    # a batching delay, not an overload: no shedding
                                    shed_config=tserver.ShedConfig(
                                        batch_delay_ms=float("inf"),
                                        interactive_delay_ms=float("inf")))
    server = tserver.start_http_server(service, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d/predict" % server.server_address[1]
    try:
        rng = np.random.default_rng(11)
        traces = [rng.standard_normal((3, WINDOW)).astype(np.float32) * 50 for _ in range(4)]
        results = [None] * len(traces)

        def one(i):
            req = urllib.request.Request(url, data=json.dumps(
                {"data": traces[i].tolist(), "options": OPTS}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                results[i] = json.loads(r.read())

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(traces))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        spec = jtaskspec.get_task_spec("phasenet")
        entry = service.entries["phasenet"]
        opts = PredictOptions.from_dict(OPTS)
        n_picks = 0
        for trace, got in zip(traces, results):
            assert got["model"] == "phasenet" and got["task"] == "picking"
            x = jserver._normalize_trace(trace.T, "std")
            jout = np.asarray(jm.apply(variables, x[None], train=False))
            want = decode_head_batch(spec, jout, is_picker=True, sampling_rate=FS,
                                     max_events=OPTS["max_events"])
            exact = decode_outputs(entry, torch.from_numpy(jout.copy()), opts)
            assert _decoded_like_jax(exact, want)
            for kind in ("ppk", "spk"):
                a = [p["sample"] for p in got[kind]]
                b = [p["sample"] for p in exact[kind]]
                assert len(a) == len(b) and all(abs(i - j) <= 0.1 * FS for i, j in zip(a, b))
            n_picks += len(got["ppk"]) + len(got["spk"])
        assert n_picks > 0
        # A crafted output with clear peaks decodes identically too.
        crafted = np.full((1, WINDOW, 3), 0.05, np.float32)
        crafted[0, :, 0] = 0.9
        for ch, at in ((1, 100), (1, 300), (2, 200)):
            crafted[0, at - 3: at + 4, ch] = np.array([.2, .5, .8, .95, .8, .5, .2])
        want = decode_head_batch(spec, crafted, is_picker=True, sampling_rate=FS,
                                 max_events=OPTS["max_events"])
        got = decode_outputs(entry, torch.from_numpy(crafted), opts)
        assert _decoded_like_jax(got, want) and len(got["ppk"]) == 2
    finally:
        server.shutdown()
        service.shutdown()


@pytest.mark.parametrize("name", ["baz_network", "ditingmotion"])
def test_two_headed_models_evaluate_and_warm_up(name):
    """A model with two heads through the eval step (per-sample losses of
    the tuple, the padded row masked out) and the serving warm-up."""
    from seist_tpu_torch import taskspec as tts
    from seist_tpu_torch.serve.pool import load_model_entry
    from seist_tpu_torch.train.step import TrainState, make_eval_step

    window, c = FAMILIES[name]
    model = tapi.create_model(name, in_channels=c, in_samples=window, seed=1)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_x(window, c, n=3, seed=6))
    if name == "baz_network":
        y = torch.from_numpy(rng.uniform(0, 360, (3, 1)).astype(np.float32))
    else:
        y = tuple(torch.eye(2)[torch.from_numpy(rng.integers(0, 2, 3))].long() for _ in "cp")
    loss_fn = tts.make_loss(name)
    loss, outputs = make_eval_step(loss_fn)(TrainState(model), x, y,
                                            torch.tensor([1.0, 1.0, 0.0]))
    with torch.no_grad():
        want = loss_fn(model(x[:2]), y[:2] if torch.is_tensor(y) else tuple(t[:2] for t in y))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert isinstance(outputs, tuple) and len(outputs) == 2
    report = load_model_entry(name, window=window, device="cpu").warmup([1, 2])
    assert [r["batch"] for r in report] == [1, 2]
