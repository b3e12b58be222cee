"""``python -m seist_tpu_torch pack``: pack a registered dataset of the port
into packed shards (the port's copy of ``tools/pack_dataset.py``; same flags,
same files, one JSON verdict line)::

    # one source, 4 pack processes
    python -m seist_tpu_torch pack --dataset synthetic \
        --dataset-kwargs '{"num_events": 2048}' --out /data/synth_packed --workers 4

    # two sources in ONE directory (per-row source_id; train with
    # --mixture-temperature)
    python -m seist_tpu_torch pack --mixture synthetic:,synthetic: --out /data/mix

then train with ``--dataset-name packed --data <out>``. The port registers
``synthetic`` and ``packed``; the HDF5 datasets (DiTing, PNW, SOS) are packed
by the JAX package's ``python -m tools.pack_dataset`` on a machine with h5py,
into the same format.

The pack is planned first (``data/packed.py``), so an N-process pack is
byte-identical to a serial one and an interrupted pack resumes at its first
incomplete shard when the same command runs again (``--no-resume`` rewrites
every shard). Prints ONE JSON line: shards, bytes, samples, wall_s, workers;
a dtype mix is refused with ``{"ok": false, "error": "dtype_mix", ...}`` and
exit code 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _parse_mixture(spec: str) -> List[tuple]:
    """``name:dir[,name:dir...]`` -> [(name, dir), ...]."""
    pairs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, data_dir = part.partition(":")
        if not sep:
            raise SystemExit(f"--mixture entries are name:data_dir, got '{part}'")
        pairs.append((name.strip(), data_dir.strip()))
    if len(pairs) < 2:
        raise SystemExit("--mixture needs at least two name:dir entries")
    return pairs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seist_tpu_torch pack", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset", help="registered source dataset")
    src.add_argument("--mixture",
                     help="comma-separated name:data_dir pairs packed into ONE directory "
                     "with per-row source_id provenance")
    ap.add_argument("--data-dir", default="", help="source dataset dir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shard-mb", type=float, default=512)
    ap.add_argument("--samples-per-shard", type=int, default=0,
                    help="explicit shard capacity (overrides --shard-mb)")
    ap.add_argument("--workers", type=int, default=0,
                    help="shard-parallel pack processes (0/1 = serial)")
    ap.add_argument("--no-resume", action="store_true",
                    help="rewrite every shard even when complete ones exist")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "fp32", "bfloat16", "bf16", "int8", "i8"),
                    help="on-disk waveform dtype: bfloat16 halves the shard bytes, int8 "
                    "(format v3) quarters them with per-row per-channel scales; readers "
                    "widen to float32. int8 and float packs cannot share a directory.")
    ap.add_argument("--dataset-kwargs", default="",
                    help="JSON dict forwarded to the dataset constructor(s)")
    args = ap.parse_args(argv)

    from seist_tpu_torch.data.packed import DtypeMixError, PackSource, pack_sources

    ds_kwargs = json.loads(args.dataset_kwargs) if args.dataset_kwargs else {}
    if args.mixture:
        sources = [PackSource(name=name, data_dir=d, dataset_kwargs=ds_kwargs)
                   for name, d in _parse_mixture(args.mixture)]
    else:
        sources = [PackSource(name=args.dataset, data_dir=args.data_dir,
                              dataset_kwargs=ds_kwargs)]
    try:
        stats = pack_sources(
            sources,
            args.out,
            num_workers=args.workers,
            samples_per_shard=args.samples_per_shard or None,
            shard_mb=args.shard_mb,
            resume=not args.no_resume,
            dtype=args.dtype,
        )
    except DtypeMixError as e:
        print(json.dumps({
            "ok": False,
            "error": "dtype_mix",
            "existing_dtype": e.existing,
            "requested_dtype": e.requested,
            "out": e.out_dir,
            "detail": str(e),
        }))
        return 2
    stats["workers"] = args.workers
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
