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
from typing import Dict, NamedTuple, Optional, Tuple

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
    # q, k, v, o, lse, n, l, m, heads, e, dtype, row_warps, ksplit, scale, rate,
    # out_scale, lm, seed (device pointer), pid0, stream
    "pooled_attention_fwd": [_P] * 5 + [_I] * 8 + [_F] * 3 + [_U, _P, _U, _P],
    # q, k, v, g, o, lse, dq, dk, dv, dq_part, dk_part, dv_part, n, l, m, heads,
    # e, dtype, splits, rows_per_split, scale, rate, out_scale, lm, seed (device
    # pointer), pid0, stream
    "pooled_attention_bwd": [_P] * 12 + [_I] * 8 + [_F] * 3 + [_U, _P, _U, _P],
    # seed, epoch, idx, batch, slot tags (host), slot positions (host),
    # n_slots, tag0, tag1, n_fields, field_len, uniforms, fields, stream
    "aug_draws": [_U, _P, _P, _I, _P, _P] + [_I] * 5 + [_P] * 3,
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
    """Where the library of ``csrc/<name>.cu`` lives: keyed by the hash of
    the source and of the headers beside it."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
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


# Tile constants of csrc/attention_common.cuh (kKeyTile, kWarpRows,
# kFwdChunk, kBwdRowTile); tests/test_torch_attention_tiles.py keeps them
# equal.
KEY_TILE = 128
WARP_ROWS = 16
FWD_CHUNK = 64
BWD_ROW_TILE = 32


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``: what a launch must fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def fwd_plan(n: int, l: int, m: int, h: int, sms: int) -> Tuple[int, int]:
    """(row_warps, ksplit) of K1's blocks. Each of row_warps groups of 16
    query rows is worked by ksplit warps, each over its share of the key
    chunks: 2 when the 16-row groups number fewer than two per SM and M
    spans two chunks. row_warps is the most (of 4, 2, 1 at most 4 warps a
    block) that still gives every SM a block."""
    groups = -(-l // WARP_ROWS) * n * h
    ksplit = 2 if m > FWD_CHUNK and groups < 2 * sms else 1
    for row_warps in (4 // ksplit, 2 // ksplit):
        if row_warps and -(-l // (WARP_ROWS * row_warps)) * n * h >= sms:
            return row_warps, ksplit
    return 1, ksplit


class BwdCost(NamedTuple):
    """What :func:`bwd_plan` models of a K2 kernel: the rows of its row
    tile, the blocks that run at once on an SM, and a block's fixed cost
    (staging K and V, writing dK and dV and, when split, summing the parts)
    in row tiles."""

    row_tile: int
    slots_per_sm: int
    fixed_tiles: int


#: The fp32 K2: one slot an SM and a fixed cost of two row tiles, fitted to
#: sweeps of every split count on an H100.
FP32_BWD_COST = BwdCost(BWD_ROW_TILE, 1, 2)


def bwd_cost(lib: ctypes.CDLL, dtype: torch.dtype, e: int) -> BwdCost:
    """The cost model of the K2 kernel that ``dtype`` at head width ``e``
    takes. The bf16 kernel's row tile and blocks an SM are read from the
    built library (``pooled_attention_bwd_bf16_shape``); its fixed cost is
    one row tile, fitted to sweeps of every split count at seist_l_dpk's
    b64 shapes on an H100."""
    if dtype == torch.float32:
        return FP32_BWD_COST
    tile, blocks = ctypes.c_int(), ctypes.c_int()
    if lib.pooled_attention_bwd_bf16_shape(e, ctypes.byref(tile), ctypes.byref(blocks)):
        raise ValueError(f"K2 bf16 takes head widths up to 64, got {e}")
    return BwdCost(tile.value, blocks.value, 1)


def bwd_plan(n: int, l: int, m: int, h: int, sms: int,
             cost: BwdCost = FP32_BWD_COST) -> Tuple[int, int]:
    """(splits, rows_per_split) of K2: a block owns a key tile of one (b, h)
    and a range of rows, in whole row tiles. The split count minimises the
    busiest SM's work under ``cost`` (:func:`bwd_cost`): the rounds of
    blocks it runs, ceil(blocks * splits / (slots_per_sm * sms)), times each
    block's row tiles plus its fixed cost; the fewest splits win a tie."""
    blocks = -(-m // KEY_TILE) * n * h
    tiles = -(-l // cost.row_tile)
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)  # row tiles of a range
        splits = -(-tiles // per)
        work = -(-blocks * splits // (cost.slots_per_sm * sms)) * (per + cost.fixed_tiles)
        if best is None or work < best[0]:
            best = (work, splits, per * cost.row_tile)
    return best[1], best[2]


def bwd_scratch(n: int, l: int, m: int, h: int, e: int, splits: int) -> Tuple[int, int]:
    """fp32 scratch of K2 in elements: (dq parts, dk parts = dv parts). dQ
    parts exist only when M spans several key tiles, dK/dV parts only when
    the rows are split."""
    ktiles = -(-m // KEY_TILE)
    dq_part = ktiles * n * l * h * e if ktiles > 1 else 0
    dkv_part = splits * n * m * h * e if splits > 1 else 0
    return dq_part, dkv_part


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _out_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def _seed_ptr(seed: torch.Tensor, device) -> int:
    """The device address of the int32 dropout seed that K1 and K2 read."""
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
        raise ValueError(f"the dropout seed must be one int32 on {device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return seed.data_ptr()


def pooled_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: Optional[torch.Tensor],
    scale: float,
    rate: float,
    seed: torch.Tensor,
    pid0: int = 0,
) -> None:
    """Launch K1 on the current stream: q/o (N, L, H, E), k/v (N, M, H, E),
    checked by the caller (ops/pooled_attention.py); ``lse`` fp32 (N, H, L)
    receives the row statistics, or is None. ``seed`` is the int32 dropout
    seed on q's device: the kernel reads it there, so a captured launch
    takes whatever seed is written into it before each replay. ``pid0`` is
    the dropout counter's first batch-head slice (``n0 * H`` for rows that
    start at global batch row ``n0``)."""
    lib = build("pooled_attention_fwd")
    n, l, h, e = q.shape
    m = k.shape[1]
    row_warps, ksplit = fwd_plan(n, l, m, h, sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pooled_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        n, l, m, h, e, _DTYPES[q.dtype], row_warps, ksplit,
        float(scale), float(rate), _out_scale(rate),
        (l * m) & 0xFFFFFFFF, _seed_ptr(seed, q.device), int(pid0) & 0xFFFFFFFF, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pooled_attention_fwd launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, M={m}, blocks of {row_warps}x{ksplit} warps)"
        )


def pooled_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    dq: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
    scale: float,
    rate: float,
    seed: torch.Tensor,
    pid0: int = 0,
) -> None:
    """Launch K2 on the current stream: q/g/o/dq (N, L, H, E), k/v/dk/dv
    (N, M, H, E), lse fp32 (N, H, L), checked by the caller; ``seed`` and
    ``pid0`` as K1's. Allocates the fp32 scratch that :func:`bwd_scratch` sizes (none on
    the main path; under graph capture it comes from, and stays in, the
    graph's private pool)."""
    lib = build("pooled_attention_bwd")
    n, l, h, e = q.shape
    m = k.shape[1]
    splits, rows = bwd_plan(n, l, m, h, sm_count(q.device), bwd_cost(lib, q.dtype, e))
    dq_n, dkv_n = bwd_scratch(n, l, m, h, e, splits)
    dq_part, dk_part, dv_part = (
        torch.empty(c, dtype=torch.float32, device=q.device) if c else None
        for c in (dq_n, dkv_n, dkv_n))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pooled_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(dq_part), _ptr(dk_part), _ptr(dv_part),
        n, l, m, h, e, _DTYPES[q.dtype], splits, rows,
        float(scale), float(rate), _out_scale(rate),
        (l * m) & 0xFFFFFFFF, _seed_ptr(seed, q.device), int(pid0) & 0xFFFFFFFF, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pooled_attention_bwd launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, M={m}, splits={splits})"
        )


def aug_draws(seed: int, epoch: torch.Tensor, idx: torch.Tensor, slots, field_tags,
              field_len: int, uniforms: torch.Tensor, fields: torch.Tensor) -> None:
    """Launch K3 on the current stream (checked by the caller,
    ops/threefry.py): ``slots`` (tag, pos) pairs and ``field_tags`` go to
    the kernel by value, ``epoch`` and ``idx`` are read on the device."""
    lib = build("aug_draws")
    n = len(slots)
    tags = (ctypes.c_int * max(n, 1))(*[int(t) for t, _ in slots])
    pos = (ctypes.c_int * max(n, 1))(*[int(p) for _, p in slots])
    ftags = list(field_tags) + [0] * (2 - len(field_tags))
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = lib.aug_draws(
        int(seed) & 0xFFFFFFFF, epoch.data_ptr(), idx.data_ptr(), idx.shape[0],
        ctypes.cast(tags, ctypes.c_void_p), ctypes.cast(pos, ctypes.c_void_p), n,
        int(ftags[0]), int(ftags[1]), len(field_tags), int(field_len), uniforms.data_ptr(),
        fields.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"aug_draws launch failed: CUDA error {err} (batch {idx.shape[0]}, "
                           f"{n} slots, {len(field_tags)} fields of {field_len})")


def aug_draws_shape(lib: ctypes.CDLL, batch: int, n_slots: int, n_fields: int,
                    field_len: int) -> Dict[str, int]:
    """K3's launch geometry at a call's shapes, read from the built library
    (``aug_draws_shape``), so Python mirrors no constant of the kernel:
    ``blocks`` of the grid, of them ``slot_blocks`` for the uniforms,
    ``threads`` a block, ``per_thread`` outputs a thread draws at once and
    ``tile`` outputs of one (sample, field) row a field block covers."""
    blocks = ctypes.c_longlong()
    ints = [ctypes.c_int() for _ in range(4)]
    lib.aug_draws_shape(batch, n_slots, n_fields, field_len, ctypes.byref(blocks),
                        *(ctypes.byref(i) for i in ints))
    return dict(blocks=blocks.value, **{k: i.value for k, i in
                                        zip(("slot_blocks", "threads", "per_thread", "tile"), ints)})
