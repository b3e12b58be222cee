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
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
#: C signature of each source's entry point (all return a cudaError_t as int).
_ARGTYPES = {
    # q, k, v, o, n, l, m, heads, e, dtype, scale, rate, out_scale, lm, seed, stream
    "pooled_attention_fwd": [_P] * 4 + [_I] * 6 + [_F] * 3 + [_U] * 2 + [_P],
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: Wall seconds each library took to build (or load) in this process.
BUILD_SECONDS: Dict[str, float] = {}


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
    """Compile (once per source hash) and load ``csrc/<name>.cu``."""
    with _LOCK:
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
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
        BUILD_SECONDS[name] = time.perf_counter() - t0
        return lib


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
