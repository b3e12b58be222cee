"""One rank of the gloo launches of tests/test_torch_parallel.py,
tests/test_torch_ring_attention.py and tests/test_torch_device_aug_ranks.py,
on the CPU:

    COORDINATOR_ADDRESS=127.0.0.1:P NUM_PROCESSES=W PROCESS_ID=i \\
        python tests/_torch_dist_worker.py ring|parallel|device_aug SPEC.json

The rank starts the process group through the port's env contract, runs
every check of its file in this one start and writes what the test holds
against the JAX package into the spec's ``out`` directory (one file per
rank and check). Inputs come from the test, drawn with numpy.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import json
import os
import sys

import numpy as np
import torch

from seist_tpu_torch.ops import ring_attention as ra
from seist_tpu_torch.parallel import dist
from seist_tpu_torch.parallel import mesh as mesh_lib


def _save(out: str, name: str, obj) -> None:
    torch.save(obj, os.path.join(out, f"{name}_rank{dist.process_index()}.pt"))


def _errors(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def ring(spec: dict) -> None:
    """Every case of the ring test: outputs, and gradients where asked,
    under a seq-4 mesh and a data-2 x seq-2 mesh."""
    cases = np.load(spec["inputs"])
    meshes = {4: mesh_lib.make_mesh(data=1, seq=4), 2: mesh_lib.make_mesh(data=2, seq=2)}
    result = {}
    for case in spec["cases"]:
        name, s = case["name"], case["seq"]
        mesh = meshes[s]
        q, k, v = (torch.from_numpy(cases[f"{name}_{t}"]) for t in "qkv")
        n0 = 0
        if case.get("batch_axis"):
            q, k, v = (mesh_lib.shard_batch(mesh, t) for t in (q, k, v))
            n0 = mesh.data_index * q.shape[0]
        q, k, v = (t.clone().requires_grad_(case.get("grad", "") != "") for t in (q, k, v))
        out = ra.ring_attention(q, k, v, mesh.seq_group, dropout_rate=case.get("rate", 0.0),
                                dropout_seed=case.get("seed"), batch_offset=n0)
        rec = {"out": out.detach()}
        if case.get("grad"):
            loss = (out ** 2).sum() if case["grad"] == "square" else out.sum()
            loss.backward()
            rec["grads"] = [t.grad for t in (q, k, v)]
        result[f"{name}_s{s}"] = rec
    m4 = meshes[4]
    x = torch.zeros(1, 30, 2, 8)
    result["errors"] = {
        "indivisible": _errors(lambda: ra.ring_attention(x, x, x, m4.seq_group)),
        "no_seed": _errors(lambda: ra.ring_attention(x, x, x, m4.seq_group, dropout_rate=0.3)),
    }
    _save(spec["out"], "ring", result)


def parallel(spec: dict) -> None:
    """The step checks (``seist_tpu_torch/parallel/check.py``), the synced
    metrics, then the train entry under ``--seq-shards 2`` in these same
    processes, through the env contract (a new port)."""
    from seist_tpu_torch.ops.metrics import Metrics
    from seist_tpu_torch.parallel import check

    device = torch.device("cpu")
    for i, run in enumerate(spec["check"]["runs"]):
        rec = check.run_steps(spec["check"], run, device)
        _save(spec["out"], f"run{i}", rec)
    m = spec["metrics"]
    data = np.load(m["inputs"])
    bounds = m["bounds"]
    rank = dist.process_index()
    synced = {}
    for task in m["tasks"]:
        met = Metrics(task=task, metric_names=m["names"][task], sampling_rate=50,
                      time_threshold=0.2, num_samples=m["num_samples"])
        rows = slice(bounds[rank], bounds[rank + 1])
        met.compute(data[f"{task}_t"][rows], torch.from_numpy(data[f"{task}_p"][rows]))
        met.synchronize_between_processes()
        synced[task] = {"metrics": met.get_all_metrics(),
                        "counters": {k: v.cpu() for k, v in met.counters.items()}}
    _save(spec["out"], "metrics", synced)
    dist.shutdown()
    os.environ["COORDINATOR_ADDRESS"] = spec["cli"]["address"]
    from seist_tpu_torch import cli

    best = cli.main(spec["cli"]["argv"])  # its group is gone when it returns
    torch.save({"best": best}, os.path.join(spec["out"], f"cli_rank{rank}.pt"))


def device_aug(spec: dict) -> None:
    """The device-augmentation checks under a data-2 mesh, from the JAX
    package's seeded variables (every drop rate 0 but attention's, whose
    seeds are the spec's): one augmenting Adam step on this rank's rows of
    the global batch, and a k = 2 cached SGD call over this rank's shard of
    the cache, each step exchanging its rows; the processors' outputs, the
    rank's cache and the rows its first exchange delivered are kept. Then
    the train entry runs (``--device-aug step`` and ``cached`` under
    ``data=2``, ``step`` under ``--seq-shards 2``) in these same processes,
    each through the env contract on a port of its own; last, without a
    group, each rank runs one of the one-rank references (``spec["one"]``,
    rank r the r-th: its train entry, under ``parallel/check.py::ranks_order``
    where it names more than one rank)."""
    from seist_tpu_torch import cli, taskspec
    from seist_tpu_torch.data import device_aug as da
    from seist_tpu_torch.data import pipeline
    from seist_tpu_torch.models import api
    from seist_tpu_torch.models.common import RandomSource
    from seist_tpu_torch.train import optim, schedule
    from seist_tpu_torch.train.step import (TrainState, make_cached_train_call,
                                            make_device_aug_train_step, step_random_source)

    s = spec["device_aug"]
    name = s["model"]
    mesh = mesh_lib.make_mesh(data=2)
    sds = pipeline.from_task_spec(taskspec.get_task_spec(name), "synthetic", "train",
                                  **s["dataset"])
    store = pipeline.RawStore.build(sds)
    cfg = da.AugConfig.from_preprocessor(sds.preprocessor, seed=0, raw_len=store.raw_len,
                                         phase_slots=store.phase_slots)
    names = (cfg, sds.input_names, sds.label_names)
    seeds = torch.as_tensor(np.load(s["seeds"]), dtype=torch.int32)
    loss_fn = taskspec.make_loss(name)

    def state(opt: str):
        model = api.create_model(name, in_samples=s["window"], **s["drop"])
        model.load_state_dict(torch.load(s["weights"]), strict=True)
        return TrainState(model, optim.build_optimizer(opt, model.parameters()),
                          schedule.constant(s["lr"][opt]))

    def rng(epoch: int, step: int) -> RandomSource:
        src = step_random_source(0, epoch, step, "cpu")
        src = RandomSource(src.generator, src.seed_generator)
        src.attention_seeds = seeds.clone()
        return src

    processed: list = []

    def kept(process):
        def run(*args):
            out = process(*args)
            processed.append(out)
            return out

        return run

    def record(st, loss, diag) -> dict:
        model = st.model
        return {"loss": loss, "applied": diag["applied"],
                "grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
                "processed": list(processed)}

    result = {}
    with mesh_lib.use_mesh(mesh):
        sel = mesh_lib.shard_batch(mesh, np.asarray(s["sel"], np.int64))
        raw, aug = sel % store.n_raw, sel >= store.n_raw
        st = state("adam")
        step = make_device_aug_train_step(loss_fn, kept(da.make_row_processor(*names)))
        loss, _, diag = step(st, pipeline._tree_map(torch.from_numpy, store.row_batch(raw)),
                             torch.from_numpy(sel.astype(np.int32)), torch.from_numpy(aug),
                             torch.tensor(1, dtype=torch.int32), rng(1, 0))
        result["step"] = record(st, loss, diag)
        processed.clear()
        cache = pipeline.DeviceEpochCache(store, "cpu", mesh)
        idx = np.asarray(s["idx_k"], np.int32)
        k = idx.shape[0]
        exchanged: list = []
        real = pipeline.exchange_rows

        def keep_rows(*args):
            exchanged.append(real(*args))
            return exchanged[-1]

        pipeline.exchange_rows = keep_rows
        try:
            call = make_cached_train_call(
                loss_fn, kept(da.make_cache_processor(*names, n_raw=store.n_raw,
                                                      augmentation=store.augmentation,
                                                      mesh=mesh)), steps_per_call=k)
            st = state("sgd")
            loss, _, diag = call(st, cache.arrays, torch.from_numpy(idx.reshape(k, 2, -1)),
                                 torch.tensor(2, dtype=torch.int32), [rng(2, j) for j in range(k)])
        finally:
            pipeline.exchange_rows = real
        result["cached"] = dict(record(st, loss, diag), cache=cache.arrays, rows=cache.rows,
                                exchanged=exchanged)
    _save(spec["out"], "device_aug", result)
    rank = dist.process_index()
    dist.shutdown()
    runs = {}
    for label, run in spec["cli"].items():
        os.environ["COORDINATOR_ADDRESS"] = run["address"]
        runs[label] = cli.main(run["argv"])  # its group is gone when it returns
    torch.save(runs, os.path.join(spec["out"], f"cli_rank{rank}.pt"))
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        os.environ.pop(var, None)
    label, one = sorted(spec["one"].items())[rank]
    if one["ranks"] > 1:
        from unittest import mock

        from seist_tpu_torch.parallel import check

        order = check.ranks_order(one["ranks"], one["batch"])
        with mock.patch.object(pipeline, "_epoch_order", order):
            best = cli.main(one["argv"])
    else:
        best = cli.main(one["argv"])
    torch.save({"label": label, "best": best}, os.path.join(spec["out"], f"one_rank{rank}.pt"))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """``world`` ranks of this script on ``task`` and ``spec`` (written to
    ``spec["out"]``), started at once; :meth:`wait` waits for all within
    ``timeout`` seconds, kills every rank on expiry or on a failure, and
    raises with the ranks' logs."""

    def __init__(self, task: str, spec: dict, world: int, timeout: float):
        import subprocess
        import time

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = spec["out"]
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"{task}_spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        port = free_port()
        self.deadline = time.monotonic() + timeout
        self.logs = [os.path.join(out, f"{task}_rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       NUM_PROCESSES=str(world), PROCESS_ID=str(r), PYTHONPATH=root,
                       SEIST_DIST_TIMEOUT_S=str(timeout))
            env.pop("DIST_BACKEND", None)
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), task, path], cwd=out, env=env,
                    stdout=log, stderr=subprocess.STDOUT))

    def wait(self) -> None:
        import subprocess
        import time

        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            tails = []
            for log in self.logs:
                with open(log) as f:
                    tails.append(f"--- {log}\n{f.read()[-3000:]}")
            raise AssertionError(f"ranks exited {codes}\n" + "\n".join(tails))


def main() -> None:
    task, spec_path = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    if not dist.init_distributed_mode(device="cpu"):
        raise SystemExit("no launch described in the environment")
    import seist_tpu_torch

    seist_tpu_torch.load_all()
    try:
        {"ring": ring, "parallel": parallel, "device_aug": device_aug}[task](spec)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
