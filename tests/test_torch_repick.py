"""Batch re-picking in the port (``seist_tpu_torch/batch/``,
``python -m seist_tpu_torch repick``) against the JAX package's
(``seist_tpu/batch/``, ``tools/repick_archive.py``), on the CPU:

* the catalog's planning, segment math, resume scan, plan guard and merge
  refusal: the same return values and byte-identical files;
* ``decode_head_batch`` + ``catalog_rows`` on the same outputs: the same
  lines (picks equal, values within 1e-6);
* ``stage_raw`` staging of an int8 pack: the same int8 bytes and scales,
  also under an injected corrupt row;
* the slice as a whole: one archive (22 events, trace 256, 10 per shard)
  re-picked by the JAX tool and by the port's ``repick --device cpu`` from
  the same PhaseNet weights (converted), and by ``seist_s_dpk`` on the
  first unit (K1's plain path): the same rows, keys and picks;
* within the port: serial, 2-worker with a deleted last segment then
  resumed, and an in-process lease fleet give byte-identical catalogs;
  the variant gate refuses a divergent variant; no program is built after
  warm-up.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os

import _torch_threads  # noqa: F401  (caps torch's threads first)
import numpy as np
import pytest
import torch
from _torch_parity import model_pair

import seist_tpu
import seist_tpu_torch
from seist_tpu.batch import catalog as jcatalog
from seist_tpu_torch.batch import catalog as tcatalog

seist_tpu.load_all()
seist_tpu_torch.load_all()

TRACE = 256
BATCH = 4
BPC = 2  # batches per call
ROWS_PER_CALL = BATCH * BPC
N_EVENTS = 22
SPS = 10  # 3 shards: 10 + 10 + 2


# ---------------------------------------------------------------- catalog
def _catalog_case(cat, out, case):
    """One catalog operation in ``out``; returns what it returned (or the
    error's class and message)."""
    try:
        if case == "plan_units":
            return [(u.unit_id, u.row_lo, u.row_hi)
                    for u in cat.plan_units(np.array([0, 0, 0, 2, 2, 5]))] + \
                [cat.plan_units(np.array([]))]
        if case == "plan_units_reordered":
            return cat.plan_units(np.array([1, 0, 1]))
        if case == "segment_math":
            u, tail = cat.WorkUnit(0, 0, 22), cat.WorkUnit(1, 22, 24)
            return [cat.calls_per_unit(u, 8), cat.segments_per_unit(u, 8, 2),
                    cat.segments_per_unit(u, 8, 1), cat.calls_per_unit(tail, 8),
                    os.path.basename(cat.segment_path(out, 3, 12)),
                    os.path.basename(cat.segment_fence_path(out, 3, 12))]
        if case == "resume_scan":
            unit = cat.WorkUnit(3, 0, 30)
            seen = [cat.first_missing_segment(out, unit, 8, 1)]
            for seg in (0, 1, 3):
                cat.commit_segment(out, 3, seg, [f"{seg}\n"])
                seen.append(cat.first_missing_segment(out, unit, 8, 1))
            return seen
        if case == "plan_guard":
            plan = {"batch_size": 4, "model": "phasenet", "variant": "fp32", "decode": {"a": 1}}
            cat.write_or_check_plan(out, plan)
            cat.write_or_check_plan(out, dict(plan))
            first = cat.read_plan(out)
            cat.write_or_check_plan(out, {**plan, "batch_size": 8})
            return first
        if case == "merge":
            units = [cat.WorkUnit(0, 0, 8), cat.WorkUnit(1, 8, 16)]
            cat.commit_segment(out, 0, 0, ['{"row":0}\n'])
            try:
                cat.merge_catalog(out, units, 8, 1)
            except FileNotFoundError as e:
                refused = str(e)
            cat.commit_segment(out, 1, 0, ['{"row":8}\n', '{"row":9}\n'])
            return [refused, cat.merge_catalog(out, units, 8, 1, meta={"x": 1}),
                    cat.catalog_paths("D")]
    except Exception as e:  # the refusal under test
        return ("raise", type(e).__name__, str(e).replace(out, "OUT"))
    raise KeyError(case)


@pytest.mark.parametrize("case", ["plan_units", "plan_units_reordered", "segment_math",
                                  "resume_scan", "plan_guard", "merge"])
def test_catalog_matches_jax(case, tmp_path):
    res = {}
    for name, cat in (("jax", jcatalog), ("torch", tcatalog)):
        out = str(tmp_path / name)
        os.makedirs(out)
        got = _catalog_case(cat, out, case)
        files = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
        res[name] = (got, files)
    assert res["torch"] == res["jax"]


# ----------------------------------------------------------- decode + rows
DECODE_CASES = {
    # name: per-output shapes of a batch of N = 6 rows
    "phasenet": [(6, TRACE, 3)],
    "seist_s_dpk": [(6, TRACE, 3)],
    "magnet": [(6, 2)],
    "baz_network": [(6, 1), (6, 1)],
    "seist_s_emg": [(6, 1)],
    "seist_s_pmp": [(6, 2)],
    "ditingmotion": [(6, 2), (6, 2)],
}


def _rows_close(a, b):
    """Catalog rows equal: integers (picks, classes) exactly, floats
    within 1e-6."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _rows_close(a[k], b[k])
        elif isinstance(a[k], float) or isinstance(b[k], float):
            assert abs(a[k] - b[k]) <= 1e-6, (k, a[k], b[k])
        elif isinstance(a[k], list) and a[k] and isinstance(a[k][0], float):
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_head_batch_and_rows_match_jax(name):
    import jax.numpy as jnp

    from seist_tpu import taskspec as jtaskspec
    from seist_tpu.ops.postprocess import decode_head_batch as jdecode
    from seist_tpu.ops.results import catalog_row_lines as jlines
    from seist_tpu.ops.results import catalog_rows as jrows
    from seist_tpu_torch import taskspec as ttaskspec
    from seist_tpu_torch.ops.postprocess import decode_head_batch as tdecode
    from seist_tpu_torch.ops.results import catalog_row_lines as tlines
    from seist_tpu_torch.ops.results import catalog_rows as trows
    from seist_tpu_torch.serve.pool import _is_picker

    rng = np.random.default_rng(7)
    outs = [rng.uniform(0.0, 1.0, s).astype(np.float32) for s in DECODE_CASES[name]]
    if len(outs[0].shape) == 3:  # smooth bumps, so picks and detections exist
        t = np.arange(TRACE)
        for j in range(outs[0].shape[0]):
            for c in range(3):
                centre = rng.integers(20, TRACE - 20)
                outs[0][j, :, c] = 0.2 * outs[0][j, :, c] + 0.8 * np.exp(
                    -0.5 * ((t - centre) / 6.0) ** 2)
    tspec = ttaskspec.get_task_spec(name)
    jspec = jtaskspec.get_task_spec(name)
    picker = _is_picker(tspec)
    kw = dict(is_picker=picker, sampling_rate=50, max_events=4)
    jres = jdecode(jspec, [jnp.asarray(o) for o in outs] if len(outs) > 1 else jnp.asarray(outs[0]),
                   **kw)
    tres = tdecode(tspec, [torch.from_numpy(o) for o in outs] if len(outs) > 1
                   else torch.from_numpy(outs[0]), **kw)
    assert set(tres) == set(jres)
    stations = {"k1": {"id": "ST1", "network": "XX", "lat": 1.0, "lon": 2.0}}
    args = dict(n_valid=5, row_ids=list(range(100, 105)), keys=["k0", "k1", "k2", "k3", "k4"],
                stations=stations)
    jr = jrows({"t": {k: np.asarray(v) for k, v in jres.items()}}, **args)
    tr = trows({"t": {k: v.numpy() for k, v in tres.items()}}, **args)
    assert len(tr) == len(jr) == 5
    for a, b in zip(tr, jr):
        _rows_close(a, b)
    if picker:
        assert any(r["ppk"] for r in tr)
        assert tlines(tr) == jlines(jr)  # integer rows: the same bytes


# ----------------------------------------------------------------- archive
def _pack(root, dtype):
    from seist_tpu.data.packed import PackSource, pack_sources

    return pack_sources(
        [PackSource(name="synthetic", dataset_kwargs={
            "num_events": N_EVENTS, "trace_samples": TRACE, "cache": False})],
        str(root), samples_per_shard=SPS, dtype=dtype)["out"]


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    return _pack(tmp_path_factory.mktemp("repick_f32"), "float32")


@pytest.fixture(scope="module")
def archive_int8(tmp_path_factory):
    return _pack(tmp_path_factory.mktemp("repick_i8"), "int8")


def _datasets(pkg, archive):
    if pkg == "jax":
        from seist_tpu.data import pipeline
    else:
        from seist_tpu_torch.data import pipeline
    return pipeline.SeismicDataset(
        "packed", "train", seed=0, data_dir=archive, input_names=[], label_names=[],
        task_names=[], in_samples=TRACE, augmentation=False, shuffle=False, data_split=False)


@pytest.mark.parametrize("corrupt", ["", "3"])
def test_stage_raw_rows_match_jax(archive_int8, corrupt, monkeypatch):
    """int8 rows staged as stored with their resident scales: the same
    bytes as the JAX package's, and a quarantined row's fallback keeps
    its own scale."""
    from seist_tpu.data.ingest import PackedRawStore as JStore
    from seist_tpu_torch.data.ingest import PackedRawStore as TStore

    monkeypatch.setenv("SEIST_FAULT_IO_CORRUPT", corrupt)
    ids = np.arange(0, 8, dtype=np.int64)
    got = {}
    for pkg, cls in (("jax", JStore), ("torch", TStore)):
        store = cls.build(_datasets(pkg, archive_int8), batch_size=8, stage_raw=True)
        rows = store.row_batch_at(ids, epoch=0, idx=ids)
        assert rows["data"].dtype == np.int8 and store.row_nbytes == 3 * TRACE
        got[pkg] = (rows["data"].copy(), rows["data_scale"].copy())
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
    if corrupt:  # row 3 was replaced by another row, with that row's scale
        scales = TStore.build(_datasets("torch", archive_int8), batch_size=8,
                              stage_raw=True).arrays["data_scale"]
        match = [r for r in range(N_EVENTS) if np.array_equal(scales[r], got["torch"][1][3])]
        assert match and match[0] != 3


def test_stage_raw_refuses_a_float_pack(archive):
    from seist_tpu_torch.data.ingest import PackedRawStore

    with pytest.raises(ValueError, match="stage_raw staging is the int8 device-dequant path"):
        PackedRawStore.build(_datasets("torch", archive), batch_size=8, stage_raw=True)


# ------------------------------------------------------------- the slice
def _weights(name, root, monkeypatch):
    """Random flax variables for ``name`` at TRACE, served by the JAX pool
    (its seeded init patched to return them) and written as the port's
    weights file; returns the file."""
    from seist_tpu.models import api as japi

    _, variables, tm = model_pair(name, TRACE, seed=3)
    monkeypatch.setattr(japi, "init_variables", lambda model, **kw: variables)
    path = os.path.join(str(root), f"{name}.pt")
    torch.save(tm.state_dict(), path)
    return path


def _geometry(*extra):
    return ["--batch-size", str(BATCH), "--batches-per-call", str(BPC), "--commit-every", "1",
            *extra]


def _read(out, name="catalog.jsonl"):
    with open(os.path.join(out, name), "rb") as f:
        return f.read()


def _verdicts(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def runs(archive, tmp_path_factory):
    """One JAX and one port re-pick of the archive with PhaseNet, and both
    over unit 0 with seist_s_dpk (worker 0 of 3): {name: outputs}."""
    from tools.repick_archive import main as jmain

    from seist_tpu_torch.repick import main as tmain

    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("runs")
    res = {}
    try:
        w = _weights("phasenet", root, mp)
        res["jax"] = str(root / "jax")
        assert jmain(["--archive", archive, "--out", res["jax"], "--model", "phasenet",
                      *_geometry()]) == 0
        res["torch"] = str(root / "torch")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert tmain(["--archive", archive, "--out", res["torch"], "--model",
                          f"phasenet={w}", "--device", "cpu", "--compile-gate",
                          *_geometry()]) == 0
        res["verdicts"] = [json.loads(x) for x in printed.getvalue().splitlines()
                           if x.startswith("{")]
        res["weights"] = w
        w = _weights("seist_s_dpk", root, mp)
        first = ["--worker-index", "0", "--num-workers", "3", "--no-merge"]
        res["jax_s"] = str(root / "jax_s")
        assert jmain(["--archive", archive, "--out", res["jax_s"], "--model", "seist_s_dpk",
                      *_geometry(*first)]) == 0
        res["torch_s"] = str(root / "torch_s")
        assert tmain(["--archive", archive, "--out", res["torch_s"], "--model",
                      f"seist_s_dpk={w}", "--device", "cpu", *_geometry(*first)]) == 0
    finally:
        mp.undo()
    return res


def _rows(blob: bytes):
    return [json.loads(x) for x in blob.splitlines()]


def test_port_catalog_matches_the_jax_tool(runs):
    t, j = _rows(_read(runs["torch"])), _rows(_read(runs["jax"]))
    assert len(t) == len(j) == N_EVENTS
    assert [r["row"] for r in t] == list(range(N_EVENTS))
    assert [(r["row"], r["key"], r["ppk"], r["spk"]) for r in t] == \
        [(r["row"], r["key"], r["ppk"], r["spk"]) for r in j]
    assert sum(len(r["ppk"]) + len(r["spk"]) for r in t) > 0
    meta_t, meta_j = (json.loads(_read(runs[k], "catalog_meta.json")) for k in ("torch", "jax"))
    meta_j["model"] = meta_j["plan"]["model"] = meta_t["model"]  # NAME vs NAME=WEIGHTS
    assert meta_t == meta_j


def test_seist_s_dpk_first_unit_matches_the_jax_tool(runs):
    """K1's plain path: the SeisT forward inside the port's program."""
    for seg in (0, 1):
        name = f"unit_00000.seg_{seg:04d}.jsonl"
        t, j = _rows(_read(runs["torch_s"], name)), _rows(_read(runs["jax_s"], name))
        assert [(r["row"], r["key"], r["ppk"], r["spk"], r["det"]) for r in t] == \
            [(r["row"], r["key"], r["ppk"], r["spk"], r["det"]) for r in j]
    assert not glob.glob(os.path.join(runs["torch_s"], "unit_00001.*"))


def _port(archive, out, weights, *extra):
    from seist_tpu_torch.repick import main

    return main(["--archive", archive, "--out", out, "--model", f"phasenet={weights}",
                 "--device", "cpu", *_geometry(*extra)])


def test_two_worker_kill_resume_is_byte_identical(archive, runs, tmp_path):
    """Map-reduce over 2 workers with a kill simulated by deleting worker
    0's last committed segment: the resumed worker restarts at that
    segment, and the merge (no geometry flags: the plan's) gives the
    serial bytes."""
    from seist_tpu_torch.repick import main

    out = str(tmp_path)
    w = ["--worker-index", "0", "--num-workers", "2", "--no-merge"]
    assert _port(archive, out, runs["weights"], *w) == 0
    segs = sorted(glob.glob(os.path.join(out, "unit_00002.seg_*.jsonl")))
    assert segs
    os.unlink(segs[-1])
    assert _port(archive, out, runs["weights"], *w) == 0
    assert json.load(open(os.path.join(out, "worker_0.json")))["unit"] == 2
    assert _port(archive, out, runs["weights"], "--worker-index", "1", "--num-workers", "2",
                 "--no-merge") == 0
    assert main(["--archive", archive, "--out", out, "--merge-only"]) == 0
    assert _read(out) == _read(runs["torch"])
    meta = json.load(open(os.path.join(out, "catalog_meta.json")))
    assert meta["plan"]["commit_every"] == 1 and meta["n_rows"] == N_EVENTS


def test_lease_fleet_is_byte_identical_with_fence_audit(archive, runs, tmp_path, monkeypatch,
                                                        capsys):
    """Two fleet workers over one lease directory, in this process: worker
    0 steals every unit, worker 1 finds only done markers; the merge
    audits the fences and gives the serial bytes."""
    from seist_tpu_torch.repick import main

    out = str(tmp_path)
    leases = os.path.join(out, "leases")
    monkeypatch.setenv("SEIST_LEASE_TTL_S", "10.0")
    fl = ["--fleet", "--lease-dir", leases, "--lease-store", "auto", "--no-merge",
          "--compile-gate"]
    assert _port(archive, out, runs["weights"], *fl, "--worker-index", "0",
                 "--worker-id", "w0") == 0
    assert _port(archive, out, runs["weights"], *fl, "--worker-index", "1",
                 "--worker-id", "w1") == 0
    v = {d["owner"]: d for d in _verdicts(capsys) if d.get("role") == "fleet-worker"}
    assert v["w0"]["all_done"] and v["w0"]["units_done"] == 3
    assert v["w0"]["lease"]["double_commits"] == 0 and v["w0"]["lease"]["fence_rejects"] == 0
    assert v["w1"]["all_done"] and v["w1"]["units_done"] == 0
    assert v["w0"]["compiles_after_warmup"] == 0 and v["w0"]["store"] == "DirLeaseStore"
    assert main(["--archive", archive, "--out", out, "--merge-only", "--lease-dir", leases]) == 0
    merge = [d for d in _verdicts(capsys) if d.get("role") == "merge"][-1]
    assert merge["fence_audit"]["fenced_segments"] == 5
    assert merge["fence_audit"]["stale_fence_segments"] == 0
    assert _read(out) == _read(runs["torch"])


def test_kv_lease_store_raises_outside_a_group(archive, tmp_path):
    """``--lease-store kv`` outside a process group raises, naming the
    launch it needs (``tools/repick_archive.py::_lease_store`` raises
    there too); within a group it is tests/test_torch_lease_kv.py's."""
    from seist_tpu_torch.batch.fleet import LeaseStoreError
    from seist_tpu_torch.repick import main

    with pytest.raises(LeaseStoreError, match="COORDINATOR_ADDRESS"):
        main(["--archive", archive, "--out", str(tmp_path), "--model", "phasenet",
              "--device", "cpu", "--fleet", "--lease-store", "kv", *_geometry()])


def test_no_program_is_built_after_warmup(runs):
    """The straight-line check on the CPU path (the JAX tool's
    CompileBudget gate): 0 programs built or eager forwards after the
    worker's warm-up; the verdict lines carry the JAX tool's keys."""
    worker, merge = runs["verdicts"]
    assert worker["role"] == "worker" and merge["role"] == "merge"
    assert worker["compiles_after_warmup"] == 0 and worker["xla_compiles_after_warmup"] == 0
    assert worker["rows"] == N_EVENTS and worker["calls"] == 5 and worker["units"] == 3
    assert set(worker["stage_seconds"]) == {"fill", "device", "decode", "write"}
    assert {"warmup_program", "warmup_compile_ms", "warmup_flops_per_call",
            "warmup_warmup_s"} <= set(worker)
    progress = json.load(open(os.path.join(runs["torch"], "worker_0.json")))
    assert progress == {"unit": 2, "next_segment": 1, "preempted": False, "rows": N_EVENTS,
                        "calls": 5, "segments": 5}


def _engine(archive, weights, **kw):
    from seist_tpu_torch.repick import build_engine, get_args

    args = get_args(["--archive", archive, "--out", kw.pop("out"), "--model",
                     f"phasenet={weights}", "--device", "cpu", *_geometry(), *kw.pop("extra", ())])
    return build_engine(args)


def test_compile_gate_counts_builds_after_warmup(archive, runs, tmp_path):
    engine, units = _engine(archive, runs["weights"], out=str(tmp_path))
    engine.warmup()
    stats = engine.run_units(units[:1], str(tmp_path), commit_every=1, compile_gate=True)
    assert stats["compiles_after_warmup"] == 0 and stats["xla_compiles_after_warmup"] == 0
    assert stats["rows"] == SPS and stats["program_calls"] == 1 + 2
    # An eager forward after warm-up breaks the contract and is counted.
    program = engine._program

    def eager_too(*args):
        engine.entry.fallback_runs += 1
        return program(*args)

    engine._program = eager_too
    engine._program.calls = 0
    stats = engine.run_units(units[1:2], str(tmp_path), commit_every=1, compile_gate=True)
    assert stats["compiles_after_warmup"] == 2


def test_variant_gate_refuses_a_divergent_variant(archive, runs, tmp_path, monkeypatch):
    from seist_tpu_torch.serve import aot

    engine, _ = _engine(archive, runs["weights"], out=str(tmp_path), extra=["--variant", "bf16"])
    monkeypatch.setattr(aot, "variant_parity", lambda *a, **k: (False, 1.0))
    with pytest.raises(RuntimeError, match="parity gate"):
        engine.warmup()


def test_int8_archive_runs_the_device_dequant_path(archive_int8, runs, tmp_path, capsys):
    """An int8 pack with ``--variant int8``: the gate passes, rows cross as
    int8 (a quarter of the float32 bytes) and the catalog has every row."""
    assert _port(archive_int8, str(tmp_path), runs["weights"], "--variant", "int8") == 0
    worker = [d for d in _verdicts(capsys) if d.get("role") == "worker"][-1]
    assert worker["rows"] == N_EVENTS and worker["warmup_program"].endswith("/int8+i8shards")
    assert len(_rows(_read(str(tmp_path)))) == N_EVENTS


def test_resume_refuses_changed_geometry(archive, runs, tmp_path):
    out = str(tmp_path)
    assert _port(archive, out, runs["weights"], "--no-merge") == 0
    from seist_tpu_torch.repick import main

    with pytest.raises(ValueError, match="different plan"):
        main(["--archive", archive, "--out", out, "--model", f"phasenet={runs['weights']}",
              "--device", "cpu", "--batch-size", str(BATCH * 2), "--batches-per-call",
              str(BPC), "--commit-every", "1", "--no-merge"])


def test_a_task_group_runs_the_trunk_once_with_the_single_models_picks(archive, tmp_path):
    """``--model-group seist_s=dpk,emg``: one program runs the trunk and both
    heads; the dpk head's rows equal a ``seist_s_dpk`` run's (the group's
    trunk is the first task's model, seeded alike), and every row carries
    the emg value."""
    from seist_tpu_torch.repick import main

    single, group = str(tmp_path / "single"), str(tmp_path / "group")
    first = ["--worker-index", "0", "--num-workers", "3", "--no-merge"]
    assert main(["--archive", archive, "--out", single, "--model", "seist_s_dpk", "--device",
                 "cpu", *_geometry(*first)]) == 0
    assert main(["--archive", archive, "--out", group, "--model-group", "seist_s=dpk,emg",
                 "--device", "cpu", *_geometry(*first)]) == 0
    name = "unit_00000.seg_0000.jsonl"
    s, g = _rows(_read(single, name)), _rows(_read(group, name))
    assert [{k: r[k] for k in ("row", "key", "ppk", "spk", "det")} for r in g] == s
    assert all(isinstance(r["emg"], float) for r in g)
