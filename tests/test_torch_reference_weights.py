"""The reference's published weights into the port without JAX
(``seist_tpu_torch/models/reference.py``, ``python -m seist_tpu_torch
import-pretrained``), against ``tools/parity.py`` on the CPU.

For every registry name at its published widths: numpy variables over the
JAX package's ``param_shapes`` (tests/_torch_parity.py, no JAX init), the
port's state dict of them, and that state dict in the reference's layout
as ``chip_smoke.py::reference_state_dict`` writes it (each LSTM bias split
into two nonzero halves). ``tools/parity.py::convert_state_dict`` of that
layout must give back the variables exactly (so the layout is the
reference's as parity.py defines it), and ``state_dict_from_reference`` of
it, nested under ``model_dict`` with ``module.`` prefixes, must equal
``state_dict_from_flax(variables)`` bit for bit.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import seist_tpu
from seist_tpu.models import api as japi

import seist_tpu_torch
from seist_tpu_torch.__main__ import main as port_main
from seist_tpu_torch.models import api as tapi
from seist_tpu_torch.models.convert import state_dict_from_flax
from seist_tpu_torch.models.reference import state_dict_from_reference, unwrap
from seist_tpu_torch.registry import MODELS
from seist_tpu_torch.serve.protocol import IncompatibleCheckpoint

from _torch_parity import random_flax_variables

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import parity  # noqa: E402  (tools/parity.py)

seist_tpu.load_all()
seist_tpu_torch.load_all()
NAMES = MODELS.names()
#: window and input channels per family (a window the model accepts; the
#: parameter shapes do not depend on it)
GEOMETRY = {"ditingmotion": (128, 2)}


def _chip():
    spec = importlib.util.spec_from_file_location("chip_smoke_harness", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip()


def _geometry(name):
    return GEOMETRY.get(name, (512, 3))


def _variables(name, seed=0):
    window, c = _geometry(name)
    jm = japi.create_model(name, in_channels=c, in_samples=window)
    shapes = japi.param_shapes(jm, in_samples=window, in_channels=c)
    return jm, shapes, jax.device_get(random_flax_variables(shapes, seed))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _nested(port_sd):
    return {"model_dict": {f"module.{k}": v
                           for k, v in CHIP.reference_state_dict(port_sd).items()}}


@pytest.mark.parametrize("name", NAMES)
def test_reference_layout_converts_back_exactly(name):
    _, shapes, variables = _variables(name)
    port_sd = state_dict_from_flax(variables)
    ref = CHIP.reference_state_dict(port_sd)
    lstm_ih = [k for k in ref if ".bias_ih_l0" in k]
    for k in lstm_ih:  # the fold is exercised: both halves carry weight
        assert ref[k].abs().min() > 0 and ref[k.replace("bias_ih", "bias_hh")].abs().min() > 0
    back = parity.convert_state_dict(ref, shapes)
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        assert np.array_equal(got[path], value), path

    window, c = _geometry(name)
    model = tapi.create_model(name, in_channels=c, in_samples=window)
    out = state_dict_from_reference(_nested(port_sd), model, model_name=name)
    assert sorted(out) == sorted(port_sd)
    for key, value in port_sd.items():
        assert out[key].dtype == value.dtype and torch.equal(out[key], value), key
    model.load_state_dict(out, strict=True)


def test_the_families_reach_parity_special_rules():
    """The reference layouts above go through the rules of parity.py that
    only some families need."""
    keys = {}
    for name in ("seist_s_dpk", "phasenet", "eqtransformer", "magnet", "ditingmotion",
                 "baz_network", "distpt_network"):
        _, _, variables = _variables(name)
        keys[name] = set(CHIP.reference_state_dict(state_dict_from_flax(variables)))
    assert any(k.startswith("encoder_layers.") for k in keys["seist_s_dpk"])
    assert any(".up_layers." in k for k in keys["seist_s_dpk"])
    assert any(k.startswith("stem.0.") for k in keys["seist_s_dpk"])
    assert any(".convt." in k for k in keys["phasenet"])
    assert any("_l0_reverse" in k for k in keys["eqtransformer"])
    assert any(k.endswith((".Wx", ".Wt", ".Wa")) for k in keys["eqtransformer"])
    assert any(k.startswith("lstm.") for k in keys["magnet"])
    assert any(".conv_layers." in k and ".convs." in k and ".0.weight" in k
               for k in keys["ditingmotion"])
    assert any(k.startswith("layers.") for k in keys["baz_network"])
    assert any(k.endswith("num_batches_tracked") for k in keys["seist_s_dpk"])


def test_seist_s_dpk_forward_matches_jax():
    jm, _, variables = _variables("seist_s_dpk", seed=1)
    model = tapi.create_model("seist_s_dpk", in_samples=512)
    model.load_state_dict(state_dict_from_reference(_nested(state_dict_from_flax(variables)),
                                                    model), strict=True)
    x = np.random.default_rng(2).standard_normal((2, 512, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_unwrapping_and_the_errors_name_the_key():
    _, _, variables = _variables("seist_s_dpk")
    port_sd = state_dict_from_flax(variables)
    ref = CHIP.reference_state_dict(port_sd)
    model = tapi.create_model("seist_s_dpk", in_samples=512)
    for wrapped in (ref, {f"_orig_mod.{k}": v for k, v in ref.items()},
                    {"model_dict": {f"module._orig_mod.{k}": v for k, v in ref.items()}}):
        assert unwrap(wrapped).keys() == ref.keys()
        out = state_dict_from_reference(wrapped, model)
        assert all(torch.equal(out[k], v) for k, v in port_sd.items())
    bogus = dict(ref, **{"encoder_layers.0.0.bogus.weight": torch.zeros(3)})
    with pytest.raises(IncompatibleCheckpoint, match="encoder_layers.0.0.bogus.weight"):
        state_dict_from_reference(bogus, model, checkpoint="x.pth", model_name="seist_s_dpk")
    dropped = "encoder_layers.1.0.proj.weight"
    partial = {k: v for k, v in ref.items() if k != dropped}
    with pytest.raises(IncompatibleCheckpoint, match="stage1_aggr.*proj.*kernel"):
        state_dict_from_reference(partial, model)
    wrong = dict(ref, **{dropped: torch.zeros(5, 5)})
    with pytest.raises(IncompatibleCheckpoint, match=dropped.replace(".", r"\.")):
        state_dict_from_reference(wrong, model)


@pytest.mark.parametrize("name", ["seist_s_dpk", "eqtransformer", "ditingmotion"])
def test_import_pretrained_writes_the_weights_file(name, tmp_path):
    from seist_tpu_torch.serve.pool import load_model_entry

    _, shapes, variables = _variables(name, seed=4)
    port_sd = state_dict_from_flax(variables)
    pth, out = tmp_path / "w.pth", tmp_path / "w.pt"
    torch.save(_nested(port_sd), pth)
    window, _ = _geometry(name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main(["import-pretrained", "--pth", str(pth), "--model-name", name,
                   "--in-samples", str(window), "--out", str(out)])
    n = japi.count_params(shapes["params"])
    assert buf.getvalue().strip() == f"Imported {pth} -> {out} ({n:,} params)"
    saved = torch.load(out, weights_only=True)
    assert sorted(saved) == sorted(port_sd)
    assert all(torch.equal(saved[k], v) for k, v in port_sd.items())
    if name == "seist_s_dpk":  # the file serves as it is
        entry = load_model_entry(name, str(out), window=window, device="cpu")
        assert entry.checkpoint == str(out)


def test_import_pretrained_needs_no_jax_flax_orbax_or_pandas(tmp_path):
    _, _, variables = _variables("phasenet", seed=5)
    pth, out = tmp_path / "p.pth", tmp_path / "p.pt"
    torch.save(_nested(state_dict_from_flax(variables)), pth)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'pandas', 'seist_tpu', 'h5py',\n"
        "          'matplotlib', 'parity'):\n"
        "    sys.modules[m] = None  # any import of them raises ImportError\n"
        "from seist_tpu_torch.__main__ import main\n"
        f"main(['import-pretrained', '--pth', {str(pth)!r}, '--model-name', 'phasenet',\n"
        f"      '--in-samples', '512', '--out', {str(out)!r}])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("Imported ") and out.exists()


def test_the_separation_check_fails_on_shifted_rows():
    """chip_smoke.py's card-vs-CPU checks (phases 5, 12-15) fail when each
    row's outputs are another row's: the rows below are 0.05 apart."""
    rng = np.random.default_rng(0)
    want = rng.uniform(0.0, 1.0, (4, 64, 3)).astype(np.float32)
    got = want + 1e-6
    err, sep = CHIP.check_separated("rows", got, want)
    assert err <= 2e-6 and sep > CHIP.SEPARATION
    with pytest.raises(SystemExit):
        CHIP.check_separated("shifted rows", np.roll(got, 1, axis=0), want)
    flat = np.full_like(want, 0.5)  # outputs that do not follow the input
    with pytest.raises(SystemExit):
        CHIP.check_separated("flat rows", flat + 1e-6, flat)
