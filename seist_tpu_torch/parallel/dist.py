"""The process group of a multi-rank run (counterpart of
``seist_tpu/parallel/dist.py``).

One process per rank. :func:`init_distributed_mode` reads the JAX
package's env contract (``COORDINATOR_ADDRESS=host:port``,
``NUM_PROCESSES``, ``PROCESS_ID``) or, when that is absent, torchrun's
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), which plays the part of the JAX package's TPU metadata
detection. It starts one process group over a TCP store that rank 0
serves: ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``; ``DIST_BACKEND=gloo``
runs gloo on ``cuda`` too, which lets several ranks share one card (NCCL
refuses two ranks on one device), with eager steps (``train/graph.py``).
A rank's card is ``cuda:(LOCAL_RANK % device_count)``; ``LOCAL_RANK``
defaults to the process id.

Host-side control data (the log directory, a checksum per rank) travels
through the store, never through a device collective: rank 0 publishes
under a sequenced key, the others read it, and after a barrier on the
store the key is deleted, as the JAX package's ``broadcast_object`` does
over its coordination service. Rank-0-only conventions (checkpoints,
result files, TensorBoard, the metrics port) use :func:`is_main_process`.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
from typing import Any, List, Optional

#: Seconds a rank waits for the group to form, for a store key or a
#: collective (``SEIST_DIST_TIMEOUT_S`` overrides it).
DEFAULT_TIMEOUT_S = 600.0

_STATE: dict = {"store": None, "backend": None, "device": None}


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get("SEIST_DIST_TIMEOUT_S",
                                                           DEFAULT_TIMEOUT_S)))


def _rendezvous(coordinator_address, num_processes, process_id):
    """(address, world, rank, local rank) from the arguments and the env, or
    None when no multi-rank launch is described."""
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in env:
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in env:
        process_id = int(env["PROCESS_ID"])
    if address is None and "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env.get("RANK", "0")) if process_id is None else process_id
    if address is None:
        return None
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {address} given without NUM_PROCESSES and PROCESS_ID")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"PROCESS_ID {process_id} outside [0, {num_processes})")
    local = int(env.get("LOCAL_RANK", process_id))
    return address, int(num_processes), int(process_id), local


def init_distributed_mode(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Start the process group when a multi-rank launch is described
    (module docstring); returns True when it did. ``device`` is the run's
    ``--device`` and picks the backend.

    No silent fallback: with a launch described, a group that cannot
    start raises (within ``SEIST_DIST_TIMEOUT_S``). A rank that went on
    alone would strand the others and write into their run directory."""
    import torch
    import torch.distributed as tdist

    found = _rendezvous(coordinator_address, num_processes, process_id)
    if found is None:
        return False
    if tdist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    address, world, rank, local = found
    dev = torch.device(device)
    backend = os.environ.get("DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"DIST_BACKEND must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {address!r}")
    # Under torchrun its agent already serves a store at MASTER_PORT: every
    # rank joins it as a client, under this restart's prefix (as torch's
    # env:// rendezvous does).
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = tdist.TCPStore(host, int(port), world, is_master=rank == 0 and not agent,
                           timeout=_timeout(), wait_for_workers=False)
    if agent:
        attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
        store = tdist.PrefixStore(f"/worker/attempt_{attempt}", store)
    kw = {"device_id": dev} if backend == "nccl" else {}
    tdist.init_process_group(backend, store=store, world_size=world, rank=rank,
                             timeout=_timeout(), **kw)
    _STATE.update(store=store, backend=backend, device=dev)
    return True


def shutdown() -> None:
    """Destroy the process group (a no-op without one); a later group's
    store exchanges number from 0 again."""
    import torch.distributed as tdist

    global _broadcast_seq
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _STATE.update(store=None, backend=None, device=None)
    _broadcast_seq = 0


def is_dist_avail_and_initialized() -> bool:
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    import torch.distributed as tdist

    return tdist.get_rank() if is_dist_avail_and_initialized() else 0


def process_count() -> int:
    import torch.distributed as tdist

    return tdist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def backend() -> Optional[str]:
    """``nccl``, ``gloo``, or None without a process group."""
    return _STATE["backend"] if is_dist_avail_and_initialized() else None


def rank_device(device) -> "torch.device":
    """This rank's device: ``cuda`` becomes the card the group chose
    (``cuda:(LOCAL_RANK % device_count)``); anything else is returned."""
    import torch

    dev = torch.device(device)
    chosen = _STATE["device"]
    if dev.type == "cuda" and dev.index is None and chosen is not None and chosen.type == "cuda":
        return chosen
    return dev


def _store():
    return _STATE["store"]


def group_store():
    """The group's store (process 0 serves it), or None without a group:
    host-side coordination beyond these exchanges, such as the re-picking
    fleet's leases (``batch/fleet.py::TorchStoreKV``)."""
    return _store() if is_dist_avail_and_initialized() else None


#: Call ordinals of the store exchanges: every rank makes them in the same
#: program order (they are collective), so a per-process counter yields
#: matching keys without coordination.
_broadcast_seq = 0
_KEY = "seist_tpu_torch/broadcast_object"


def _barrier_on(store, key: str, world: int) -> None:
    """Every rank adds one to ``key``; the last to arrive sets ``key/all``,
    which all wait for."""
    if store.add(key, 1) == world:
        store.set(key + "/all", b"1")
    store.wait([key + "/all"], _timeout())


def _next_key() -> str:
    global _broadcast_seq
    key = f"{_KEY}/{_broadcast_seq}"
    _broadcast_seq += 1
    return key


def _finish(store, key: str, values: List[str]) -> None:
    """The barrier of exchange ``key``, then rank 0 deletes its values and
    the previous exchange's barrier keys (every rank has left that
    barrier, since every rank has reached this one)."""
    _barrier_on(store, key + "/read", process_count())
    if process_index() == 0:
        for k in values:
            store.delete_key(k)
        prev = key.rsplit("/", 1)
        prev = f"{prev[0]}/{int(prev[1]) - 1}/read"
        if not prev.endswith("/-1/read"):
            store.delete_key(prev)
            store.delete_key(prev + "/all")


def broadcast_object(obj: Any) -> Any:
    """``obj`` from rank 0 on every rank, through the group's store
    (module docstring); ``obj`` itself with one process."""
    if process_count() <= 1:
        return obj
    store = _store()
    key = _next_key()
    if process_index() == 0:
        store.set(key, pickle.dumps(obj))
        result = obj
    else:
        store.wait([key], _timeout())
        result = pickle.loads(store.get(key))
    _finish(store, key, [key])
    return result


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank (through the
    store, as :func:`broadcast_object`)."""
    if process_count() <= 1:
        return [obj]
    store = _store()
    key = _next_key()
    mine = f"{key}/{process_index()}"
    store.set(mine, pickle.dumps(obj))
    keys = [f"{key}/{r}" for r in range(process_count())]
    store.wait(keys, _timeout())
    result = [pickle.loads(store.get(k)) for k in keys]
    _finish(store, key, keys)
    return result


def checksum(model) -> str:
    """sha256 of a module's parameters' names and bytes: equal on every
    rank when the ranks' parameters are byte-identical."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point (through the store)."""
    if process_count() <= 1:
        return
    store = _store()
    key = _next_key()
    _finish(store, key, [])
