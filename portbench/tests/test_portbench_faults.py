"""The rest of a run, on the CPU at a small size, with the timed path
broken underneath: each fault a cell can have makes ``correct`` false
under the cell's own limits, and the sound run is correct."""

from __future__ import annotations

import pytest
import torch

from portbench.tests import _cpu

TRAIN = "seist_l_dpk.train.fp32.b500"
REPICK = "seist_l_dpk.repick.fp32.b64x4"


def _correct(cell_name: str, window: int = 512) -> bool:
    result, outcome = _cpu.run_small(_cpu.small_cell(cell_name, window), seed=5)
    return result["correct"]


@pytest.mark.parametrize("cell", [TRAIN, REPICK])
def test_the_sound_run_is_correct(cell):
    assert _correct(cell)


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from seist_tpu_torch.train import optim

    monkeypatch.setattr(optim, "apply_update", lambda *a, **k: None)
    assert not _correct(TRAIN)


def test_half_of_the_batch_left_out_of_the_loss(monkeypatch):
    from seist_tpu_torch import taskspec

    make = taskspec.TaskSpec.make_loss

    def half(self):
        full = make(self)
        return lambda p, t: full(p[: p.shape[0] // 2], t[: t.shape[0] // 2])

    monkeypatch.setattr(taskspec.TaskSpec, "make_loss", half)
    assert not _correct(TRAIN)


def test_half_of_each_batch_left_out_of_the_forward(monkeypatch):
    from seist_tpu_torch.batch import engine

    prep = engine.normalize_transpose

    def half(raw):
        x = prep(raw)
        return torch.cat([x[: x.shape[0] // 2], torch.zeros_like(x[x.shape[0] // 2:])])

    monkeypatch.setattr(engine, "normalize_transpose", half)
    assert not _correct(REPICK)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from seist_tpu_torch.batch import engine

    rows_of = engine.catalog_rows

    def altered(*a, **k):
        rows = rows_of(*a, **k)
        for r in rows[::3]:
            r["ppk"] = [p + 1 for p in r["ppk"]] or [100]
        return rows

    monkeypatch.setattr(engine, "catalog_rows", altered)
    assert not _correct(REPICK)


def test_rows_left_uncommitted(monkeypatch):
    from seist_tpu_torch.batch import engine

    rows_of = engine.catalog_rows
    monkeypatch.setattr(engine, "catalog_rows", lambda *a, **k: rows_of(*a, **k)[:-1])
    assert not _correct(REPICK)
