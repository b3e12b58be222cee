"""The plain reference against the port on the CPU at small sizes: the same
seeded weights give the same forward (eval, and train mode with the
published dropout, its masks redrawn from the step's seed), the same train
steps, and the reference picker gives the port's catalog rows."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.lib import harness
from portbench.lib import weights as wlib
from portbench.reference import dropout, picker
from portbench.reference import train as ref
from portbench.tests import _cpu

FORWARD_TOL = 1e-4  # fp32 sums in other orders, grown through ~60 normalised layers to ~1e-5


def _port_model(cfg):
    from seist_tpu_torch.models import api

    kwargs = {k: cfg[k] for k in cfg["program_kwargs"]}
    return api.create_model(cfg["program_model"], in_channels=cfg["in_channels"],
                            in_samples=cfg["window"], seed=0, **kwargs)


@pytest.mark.parametrize("config,window", [("seist_l_dpk", 512), ("phasenet", 1024)])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_the_port(config, window, mode):
    cfg = harness.find_cell(next(w["name"] for w in harness.benchmark()["workloads"]
                                 if w["config"] == config)).config
    cfg["window"] = window
    model = ref.build_model(cfg)
    w = wlib.make_weights(model, 123, "cpu")
    x = torch.randn(3, window, 3, generator=torch.Generator().manual_seed(5))
    if mode == "eval":  # running statistics that suit the input, as re-picking sets them
        harness.driver("repick").calibrate(cfg, w, x.transpose(1, 2))
    port = _port_model(cfg)
    port.load_state_dict(w, strict=True)
    model.load_state_dict(w, strict=True)
    getattr(model, mode)()
    getattr(port, mode)()
    if mode == "train":  # the masks of update 4 of the steps seeded 99
        from seist_tpu_torch.models.common import set_random_source
        from seist_tpu_torch.train.step import step_random_source

        set_random_source(port, step_random_source(99, 0, 4, "cpu"))
        dropout.set_draws(model, dropout.StepDraws(99, 4, "cpu"))
    with torch.no_grad():
        want, got = model(x), port(x)
    assert got.shape == want.shape == (3, window, 3)
    assert float((got - want).abs().max()) < FORWARD_TOL
    assert float(want.std()) > 1e-2  # outputs that follow the input
    if mode == "train":  # the dropout acts: other masks give other outputs
        dropout.set_draws(model, dropout.StepDraws(99, 5, "cpu"))
        with torch.no_grad():
            assert float((model(x) - want).abs().max()) > 100 * FORWARD_TOL


@pytest.mark.parametrize("cell,window,batch", [("seist_l_dpk.train.fp32.b500", 512, 4),
                                               ("phasenet.train.fp32.b500", 2048, 16)])
def test_train_steps_match_the_port(cell, window, batch):
    """Three captured-path updates (eager on the CPU) against the
    reference's: losses to 1e-5 of the loss, first gradients to 1e-3 and
    the change to 1e-2 of the leaf's (or the median leaf's) norm. PhaseNet's
    deepest BatchNorm sees L/256 samples a row: at b16 enough for fp32."""
    result, outcome = _cpu.run_small(_cpu.small_cell(cell, window, {"batch": batch}), seed=11)
    nums = outcome.extra["numbers"]
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-3, nums
    assert nums["change_gap"] < 1e-2, nums
    assert result["failed"] == 0 and result["attempted"] >= 4


def test_attention_mask_is_the_ports():
    """The reference's copy of the counter hash keeps what the port's plain
    attention keeps, at the rate SeisT-L trains with."""
    from seist_tpu_torch.ops.pooled_attention import _keep_mask

    for seed in (0, 12345, 2**31 - 2):
        want = _keep_mask(seed, 3, 3, 64, 16, 0.3, "cpu")
        got = dropout.attention_keep(seed, 3, 3, 64, 16, 0.3, "cpu")
        assert torch.equal(got, want)
        assert 0.65 < float(got.float().mean()) < 0.75


def test_train_loss_moves_with_the_labels():
    """The reference's loss sees the labels: a shuffled target changes it."""
    cfg = harness.find_cell("seist_l_dpk.train.fp32.b500").config
    cfg["window"] = 256
    lossf = ref.loss_fn(cfg)
    p = torch.rand(2, 256, 3) * 0.98 + 0.01
    t = torch.rand(2, 256, 3)
    assert abs(float(lossf(p, t)) - float(lossf(p, t.flip(1)))) > 1e-4


def _port_rows(curves: np.ndarray, opts):
    from seist_tpu_torch import taskspec
    from seist_tpu_torch.ops.postprocess import decode_head_batch
    from seist_tpu_torch.ops.results import catalog_rows

    spec = taskspec.get_task_spec("seist_l_dpk")
    dec = decode_head_batch(spec, torch.from_numpy(curves), is_picker=True,
                            sampling_rate=opts["sampling_rate"],
                            ppk_threshold=opts["ppk_threshold"],
                            spk_threshold=opts["spk_threshold"],
                            det_threshold=opts["det_threshold"],
                            min_peak_dist=opts["min_peak_dist_s"], max_events=opts["max_events"])
    host = {"t": {k: v.numpy() for k, v in dec.items()}}
    return catalog_rows(host, n_valid=curves.shape[0], row_ids=range(curves.shape[0]))


def test_picker_gives_the_ports_catalog_rows():
    tr = harness.find_cell("seist_l_dpk.repick.fp32.b64x4").traffic
    opts = {k: tr[k] for k in ("ppk_threshold", "spk_threshold", "det_threshold",
                               "min_peak_dist_s", "max_events")}
    opts["sampling_rate"] = 50
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(64, 3, 2048, generator=g)
    smooth = torch.nn.functional.avg_pool1d(noise, 31, 1, 15) * 4
    curves = torch.sigmoid(smooth).transpose(1, 2).contiguous().numpy()
    curves[5, 100:110, 1] = 0.9  # a plateau
    curves[6, :, :] = 0.2  # nothing above any threshold
    rows = _port_rows(curves, opts)
    picks = 0
    for j, row in enumerate(rows):
        mine = picker.pick_row(curves[j], opts)
        assert {k: row[k] for k in ("det", "ppk", "spk")} == mine, j
        picks += len(mine["ppk"]) + len(mine["spk"]) + len(mine["det"])
    assert picks > 200


def test_normalize_matches_the_ports():
    from seist_tpu_torch.batch.engine import normalize_transpose

    raw = torch.randn(4, 3, 1000) * 7 + 3
    raw[1, 2] = 5.0  # a flat channel: divided by 1
    assert torch.equal(picker.normalize(raw), normalize_transpose(raw))
