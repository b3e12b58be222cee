"""Build and bind the port's CUDA kernels.

Each source under ``seist_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/seist_tpu_torch/`` at the repository root, keyed by the hash
of the source; the library is loaded with ``ctypes``. Pointers and the
current CUDA stream are passed as ``c_void_p``; each C function returns
``cudaGetLastError()`` and the binding raises when it is not 0. Nothing
here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "seist_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
#: C signature of each source's entry point (all return a cudaError_t as int).
_ARGTYPES = {
    # q, k, v, o, n, l, m, heads, e, dtype, scale, rate, out_scale, lm, seed, stream
    "pooled_attention_fwd": [_P] * 4 + [_I] * 6 + [_F] * 3 + [_U] * 2 + [_P],
    # q, k, v, g, dq, dk, dv, stats, part, n, l, m, heads, e, splits, dtype,
    # scale, rate, out_scale, lm, seed, stream
    "pooled_attention_bwd": [_P] * 9 + [_I] * 7 + [_F] * 3 + [_U] * 2 + [_P],
}

_LOCK = threading.Lock()  # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: Wall seconds each library took to build (or load) in this process.
BUILD_SECONDS: Dict[str, float] = {}
#: What nvcc printed for each library built in this process (ptxas's
#: per-kernel register, shared-memory and spill lines).
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: keyed by its hash."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``csrc/<name>.cu``. Each
    source has its own lock, so builds of different sources run at once
    (:func:`build_all`)."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
        BUILD_SECONDS[name] = time.perf_counter() - t0
        return lib


def build_all(names=tuple(_ARGTYPES)) -> None:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    errors: list = []

    def one(n: str) -> None:
        try:
            build(n)
        except Exception as e:  # re-raised below, after every build ended
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pooled_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    scale: float,
    rate: float,
    seed: int,
) -> None:
    """Launch the kernel on the current stream: q/o (N, L, H, E), k/v
    (N, M, H, E), checked by the caller (ops/pooled_attention.py)."""
    lib = build("pooled_attention_fwd")
    n, l, h, e = q.shape
    m = k.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pooled_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        n, l, m, h, e, _DTYPES[q.dtype],
        float(scale), float(rate),
        1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
        (l * m) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pooled_attention_fwd launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, M={m})"
        )


#: Keys (threads) per block of the backward's key pass
#: (``kKeys`` in csrc/pooled_attention_bwd.cu), and the row tile.
BWD_KEYS_PER_BLOCK = 64
BWD_ROW_TILE = 64
#: Blocks the key pass aims for: 8 of 64 threads on each of 132 SMs.
BWD_TARGET_BLOCKS = 8 * 132


def bwd_row_splits(n: int, l: int, m: int, h: int) -> int:
    """How many contiguous row ranges the backward's key pass splits L
    into: enough blocks to fill the card, never a range under one tile."""
    blocks = -(-m // BWD_KEYS_PER_BLOCK) * n * h
    want = max(1, -(-BWD_TARGET_BLOCKS // blocks))
    return min(want, -(-l // BWD_ROW_TILE))


def pooled_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    dq: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
    scale: float,
    rate: float,
    seed: int,
) -> None:
    """Launch the backward on the current stream: q/g/dq (N, L, H, E),
    k/v/dk/dv (N, M, H, E), checked by the caller. Allocates the kernel's
    fp32 scratch (row statistics and the key pass's partial sums)."""
    lib = build("pooled_attention_bwd")
    n, l, h, e = q.shape
    m = k.shape[1]
    splits = bwd_row_splits(n, l, m, h)
    stats = torch.empty(n * h * l * 3, dtype=torch.float32, device=q.device)
    part = torch.empty(splits * n * h * m * 2 * e, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pooled_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), part.data_ptr(),
        n, l, m, h, e, splits, _DTYPES[q.dtype],
        float(scale), float(rate),
        1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
        (l * m) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pooled_attention_bwd launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, M={m}, splits={splits})"
        )
