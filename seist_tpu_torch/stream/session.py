"""Stateful sliding-window inference for one station's unbounded stream
(the port's copy of ``seist_tpu/stream/session.py``: host numpy, its
snapshots interchangeable with the JAX package's).

A :class:`StreamSession` is the streaming twin of ``ops/stream.annotate``:
feed packets of arbitrary size with :meth:`push`, forward the due windows
it hands back through any model, return the probabilities with
:meth:`integrate`, and the picks that come out are *identical* to running
offline ``annotate`` on the concatenated record — the parity pin
(tests/test_torch_stream_session.py) that makes the subsystem trustworthy.

How the pin is engineered, piece by piece:

* **Windowing**: regular offsets ``0, stride, 2*stride, ...`` become due
  the moment ``offset + window`` samples exist — exactly the set
  ``window_offsets`` enumerates offline. The right-aligned tail window
  (and the padded window of a record shorter than ``window``) depends on
  the final record length, so it is emitted by :meth:`finish`.
* **State**: the session keeps (a) a raw ring buffer from the earliest
  sample any future window can need — ``min(next_offset, n - window)`` —
  and (b) the running stitch accumulators. Per-window z-normalization is
  recomputed from the ring buffer when a window falls due (the same
  ``normalize(chunk, "std", axis=1)`` numpy reduction annotate applies),
  so normalization state *is* the ring buffer + per-window moments;
  a streaming mean/var would diverge bitwise from the offline pin.
* **Stitching**: ``combine='mean'`` accumulates float32 value/hit sums in
  ascending offset order; ``'max'`` keeps a running elementwise max in
  event-evidence space for ``channel0='non'`` — both mirror
  ``stitch_probs`` op for op, including the double ``1 - x`` inversion of
  the non channel that annotate performs (NOT algebraically simplified:
  ``1-(1-m)`` need not equal ``m`` in float32).
* **Finality frontier**: a stitched sample is final once no future window
  can cover it: ``t < min(next_offset, n - window)`` (the tail window of
  a stream ending *right now* starts at ``n - window``). Pickers only
  ever read final samples, so nothing emitted is ever retracted.
* **Incremental picking**: host-side re-implementations of the exact
  ``ops/postprocess.pick_peaks`` / ``detect_events`` semantics (rising
  edge candidates, first/last sample excluded, >= threshold, greedy NMS
  in height order with |dist| <= mpd inclusive, dead peaks don't
  suppress; detection runs strictly > threshold). Greedy NMS looks
  global, but candidates partition into components separated by
  candidate-free gaps > mpd; kills never cross components, so a
  component whose trailing gap is final is itself final — emitted
  immediately, provably identical to the batch kernel.

The ONE divergence from offline: ``annotate``'s ``max_events`` capacity
(auto-scaled to 4 picks per window span, rounded up to a power of two)
truncates to the topk *tallest* when it binds; the session is unbounded.
The auto-scale makes the cap effectively unreachable — parity holds
whenever the offline cap does not bind, which the parity tests assert.

Cost model: one packet costs at most ``ceil(packet/stride)`` window
forwards plus O(packet) host stitching — never a re-annotation of the
record so far.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Mapping, Optional

import numpy as np

from seist_tpu_torch.data.preprocess import normalize

__all__ = ["DueWindow", "SessionConfig", "StreamSession", "STATE_VERSION"]

#: Version tag carried in every snapshot; bump on ANY layout change to the
#: state dict so a restore from an older journal fails loud (fresh session
#: + gap-stitch re-warm) instead of resurrecting subtly-wrong state.
STATE_VERSION = 1


@dataclass(frozen=True)
class SessionConfig:
    """Pick/stitch parameters — mirror ``annotate``'s keyword surface so a
    session and an offline re-annotation can be configured identically."""

    window: int = 8192
    stride: int = 4096
    in_channels: int = 3
    channel0: str = "non"  # 'non' (phasenet) | 'det' (seist dpk family)
    combine: str = "mean"  # 'mean' | 'max'
    sampling_rate: int = 50
    ppk_threshold: float = 0.3
    spk_threshold: float = 0.3
    det_threshold: float = 0.5
    min_peak_dist: float = 1.0

    def __post_init__(self) -> None:
        if self.channel0 not in ("non", "det"):
            raise ValueError(f"channel0 must be 'non'|'det', got {self.channel0!r}")
        if self.combine not in ("mean", "max"):
            raise ValueError(f"combine must be 'mean'|'max', got {self.combine!r}")
        if not (0 < self.stride <= self.window):
            raise ValueError(f"need 0 < stride <= window, got {self.stride}/{self.window}")

    @property
    def peak_dist(self) -> int:
        return int(self.min_peak_dist * self.sampling_rate)


@dataclass(frozen=True)
class DueWindow:
    """One model-ready window: normalized (window, C) float32 at ``offset``.

    ``pad`` > 0 only for the final window of a record shorter than one
    window (zero right-padding; picks inside the pad are trimmed)."""

    offset: int
    data: np.ndarray
    pad: int = 0


class _PeakPicker:
    """Incremental, exact ``pick_peaks``: emits a peak the moment its NMS
    component closes (candidate-free final gap > mpd), never retracts."""

    def __init__(self, threshold: float, mpd: int) -> None:
        self.threshold = float(threshold)
        self.mpd = int(mpd)
        self._comp: List[tuple] = []  # open component: (pos, height)
        self._scanned = 1  # t=0 is never a candidate (first sample excluded)
        self.out: List[int] = []

    def _close(self) -> List[int]:
        comp, self._comp = self._comp, []
        if not comp:
            return []
        if self.mpd <= 1:  # kernel skips NMS entirely for mpd <= 1
            return [p for p, _ in comp]
        # Greedy NMS in height order, ties toward the earlier index
        # (the kernel's stable order); kills are |dpos| <= mpd inclusive and
        # dead candidates don't suppress, as in ops/postprocess.pick_peaks.
        order = sorted(range(len(comp)), key=lambda i: (-comp[i][1], comp[i][0]))
        alive = [True] * len(comp)
        for k in order:
            if not alive[k]:
                continue
            pk = comp[k][0]
            for j in range(len(comp)):
                if j != k and alive[j] and abs(comp[j][0] - pk) <= self.mpd:
                    alive[j] = False
        return sorted(p for (p, _), a in zip(comp, alive) if a)

    def scan(self, curve: np.ndarray, base: int, upto: int, at_end: bool) -> List[int]:
        """Consume final curve samples ``[base, base+len(curve))`` covering
        positions up to ``upto`` (exclusive); decide candidates t with
        t+1 < upto. ``at_end``: ``upto`` is the record length — flush."""
        emitted: List[int] = []
        hi = upto - 1  # t needs t+1 final; also excludes the last sample
        lo = self._scanned
        if hi > lo:
            seg = curve[lo - base - 1 : hi - base + 1]  # values at [lo-1, hi]
            dx = np.diff(seg)
            cand = (dx[:-1] > 0) & (dx[1:] <= 0) & (seg[1:-1] >= self.threshold)
            for p in (np.nonzero(cand)[0] + lo):
                p = int(p)
                if self._comp and p - self._comp[-1][0] > self.mpd:
                    emitted.extend(self._close())
                self._comp.append((p, float(curve[p - base])))
            self._scanned = hi
            if self._comp and (hi - 1) - self._comp[-1][0] > self.mpd:
                emitted.extend(self._close())
        if at_end:
            emitted.extend(self._close())
        return emitted


class _Detector:
    """Incremental, exact ``detect_events``: maximal runs strictly above
    threshold; a run is emitted when a final below-threshold sample (or
    the record end) closes it. Single-sample on == off runs are kept,
    matching annotate's ``det[:, 1] >= det[:, 0]`` filter."""

    def __init__(self, threshold: float) -> None:
        self.threshold = float(threshold)
        self._on: Optional[int] = None
        self._off = -1
        self._scanned = 0

    def scan(self, strength: np.ndarray, base: int, upto: int, at_end: bool) -> List[tuple]:
        emitted: List[tuple] = []
        seg = strength[self._scanned - base : upto - base]
        above = seg > self.threshold
        t = self._scanned
        # Run-length walk via transition indices (host cost O(runs)).
        bounds = np.nonzero(np.diff(above.astype(np.int8)))[0] + 1
        pieces = np.split(above, bounds)
        for piece in pieces:
            if piece.size == 0:
                continue
            if piece[0]:
                if self._on is None:
                    self._on = t
                self._off = t + piece.size - 1
            elif self._on is not None:
                emitted.append((self._on, self._off))
                self._on = None
            t += piece.size
        self._scanned = upto
        if at_end and self._on is not None:
            emitted.append((self._on, self._off))
            self._on = None
        return emitted


class StreamSession:
    """One station's streaming annotate state. Not thread-safe; the mux
    holds one lock per session.

    Protocol::

        due = session.push(packet)           # 0+ DueWindow, ascending offset
        for w in due:
            picks = session.integrate(w.offset, model(w.data[None])[0])
        ...
        for w in session.finish():           # tail / short-record window
            picks = session.integrate(w.offset, ...)
        picks = session.finalize()           # flush pickers

    Every ``integrate``/``finalize`` returns only *newly final* picks
    ({"ppk": [...], "spk": [...], "det": [(on, off), ...]}, absolute
    sample positions); their union over the session's lifetime equals
    offline ``annotate`` output on the concatenated record.
    """

    def __init__(self, config: SessionConfig) -> None:
        self.config = c = config
        self.n_samples = 0  # total samples pushed
        self.n_windows = 0  # windows handed out
        self._next_offset = 0  # first regular offset not yet due
        self._base = 0  # absolute position of ring buffer start
        self._ring = np.zeros((0, c.in_channels), np.float32)
        self._curve_base = 0  # absolute position of accumulator start
        dt = np.float32
        if c.combine == "mean":
            self._acc = np.zeros((0, 3), dt)
            self._hits = np.zeros((0,), dt)
        else:
            self._evmax = np.zeros((0, 3), dt)
        self._final_upto = 0  # samples < this are stitch-final
        self._pending: List[int] = []  # offsets handed out, not integrated
        self._finished = False
        self._finalized = False
        self._total_len: Optional[int] = None  # padded length for short records
        mpd = c.peak_dist
        self._ppk = _PeakPicker(c.ppk_threshold, mpd)
        self._spk = _PeakPicker(c.spk_threshold, mpd)
        self._det = _Detector(c.det_threshold)
        # Retained final curve for picker context: pickers keep their own
        # scan cursors, so we only retain from min(scanned)-1 backwards.
        self._picks: Dict[str, list] = {"ppk": [], "spk": [], "det": []}

    # ------------------------------------------------------------ ingest
    def push(self, data: np.ndarray) -> List[DueWindow]:
        """Append a packet ((L, C) float32, any L >= 0); return the windows
        that became due, ascending offset, each z-normalized model-ready."""
        if self._finished:
            raise RuntimeError("push after finish()")
        c = self.config
        data = np.asarray(data, np.float32)
        if data.ndim != 2 or data.shape[1] != c.in_channels:
            raise ValueError(
                f"packet must be (L, {c.in_channels}), got {data.shape}"
            )
        if data.shape[0]:
            self._ring = np.concatenate([self._ring, data], axis=0)
            self.n_samples += data.shape[0]
        due: List[DueWindow] = []
        while self._next_offset + c.window <= self.n_samples:
            o = self._next_offset
            due.append(DueWindow(o, self._normalized(o, c.window)))
            self._pending.append(o)
            self._next_offset = o + c.stride
        self._trim_ring()
        self.n_windows += len(due)
        return due

    def finish(self) -> List[DueWindow]:
        """Mark end-of-stream; return the remaining due window, if any:
        the right-aligned tail (when distinct from the last regular
        offset) or the zero-padded window of a short record."""
        if self._finished:
            return []
        self._finished = True
        c = self.config
        n = self.n_samples
        if n == 0:
            self._total_len = 0
            return []
        if n < c.window:
            # annotate's pad-and-trim contract for short records: zero
            # right-pad to one window, normalize the PADDED window.
            pad = c.window - n
            self._total_len = c.window
            raw = np.concatenate(
                [self._ring, np.zeros((pad, c.in_channels), np.float32)], axis=0
            )
            self.n_windows += 1
            self._pending.append(0)
            return [DueWindow(0, _znorm(raw), pad=pad)]
        tail = n - c.window
        last_regular = self._next_offset - c.stride
        if self._next_offset == 0 or tail != last_regular:
            self.n_windows += 1
            self._pending.append(tail)
            return [DueWindow(tail, self._normalized(tail, c.window))]
        return []

    # --------------------------------------------------------- integrate
    def integrate(self, offset: int, probs: np.ndarray) -> Dict[str, list]:
        """Stitch one window's (window, 3) probabilities at ``offset``;
        advance the finality frontier; return newly final picks."""
        c = self.config
        probs = np.asarray(probs, np.float32)
        if probs.shape != (c.window, 3):
            raise ValueError(f"probs must be ({c.window}, 3), got {probs.shape}")
        if c.combine == "max" and c.channel0 == "non":
            # Event-evidence space (annotate's max/'non' branch).
            probs = probs.copy()
            probs[:, 0] = 1.0 - probs[:, 0]
        try:
            self._pending.remove(offset)
        except ValueError:
            raise ValueError(f"no window pending at offset {offset}") from None
        self._ensure_curve(offset + c.window)
        lo = offset - self._curve_base
        if lo < 0:
            raise ValueError(f"window at {offset} precedes retained curve")
        if c.combine == "mean":
            self._acc[lo : lo + c.window] += probs
            self._hits[lo : lo + c.window] += 1.0
        else:
            np.maximum(
                self._evmax[lo : lo + c.window],
                probs,
                out=self._evmax[lo : lo + c.window],
            )
        return self._advance()

    def abandon(self, offset: int) -> Dict[str, list]:
        """Drop a handed-out window whose forward failed (shed, queue
        full, replica dying). The slot leaves ``_pending`` so the
        finality frontier can keep advancing — without this, one dropped
        window wedges the frontier forever and the station never emits
        another pick. The un-stitched span becomes a coverage hole
        (rendered as pure noise by :meth:`_curve`); newly final picks on
        either side are returned exactly like :meth:`integrate`."""
        try:
            self._pending.remove(offset)
        except ValueError:
            raise ValueError(f"no window pending at offset {offset}") from None
        # Zero-fill the accumulators across the hole: the frontier may
        # now advance past territory no integrate() ever grew the curve
        # for, and pickers must see explicit zeros, not a short slice.
        self._ensure_curve(offset + self.config.window)
        return self._advance()

    def finalize(self) -> Dict[str, list]:
        """After integrating :meth:`finish`'s windows: flush the pickers
        over the (now fully final) record tail."""
        if not self._finished:
            raise RuntimeError("finalize before finish()")
        if self._pending:
            raise RuntimeError(
                f"finalize with {len(self._pending)} un-integrated windows"
            )
        if self._finalized:
            return {"ppk": [], "spk": [], "det": []}
        self._finalized = True
        return self._advance(at_end=True)

    @property
    def picks(self) -> Dict[str, list]:
        """All picks emitted so far (the running union)."""
        return {k: list(v) for k, v in self._picks.items()}

    @property
    def context_samples(self) -> int:
        """Raw samples currently retained (the ring buffer)."""
        return self._ring.shape[0]

    # -------------------------------------------------- snapshot/restore
    def snapshot(self) -> Dict[str, object]:
        """Serializable session state: ``{"meta": <JSON-able dict>,
        "arrays": <name -> ndarray>}``. Bounded by design: the ring and
        retained curve are already trimmed to O(window), so a journal
        entry costs the same regardless of stream length.

        Only quiescent sessions snapshot — ``_pending`` must be empty
        (the mux journals between feeds, under the entry lock, where
        every handed-out window has been integrated or abandoned). A
        mid-flight snapshot would need the un-integrated window replayed
        on restore, which nothing can do after the process died."""
        if self._pending:
            raise RuntimeError(
                f"snapshot with {len(self._pending)} in-flight windows"
            )
        c = self.config
        meta: Dict[str, object] = {
            "version": STATE_VERSION,
            "config": asdict(c),
            "n_samples": self.n_samples,
            "n_windows": self.n_windows,
            "next_offset": self._next_offset,
            "base": self._base,
            "curve_base": self._curve_base,
            "final_upto": self._final_upto,
            "finished": self._finished,
            "finalized": self._finalized,
            "total_len": self._total_len,
            "ppk": {"comp": self._ppk._comp, "scanned": self._ppk._scanned},
            "spk": {"comp": self._spk._comp, "scanned": self._spk._scanned},
            "det": {
                "on": self._det._on,
                "off": self._det._off,
                "scanned": self._det._scanned,
            },
        }
        arrays: Dict[str, np.ndarray] = {"ring": self._ring.copy()}
        if c.combine == "mean":
            arrays["acc"] = self._acc.copy()
            arrays["hits"] = self._hits.copy()
        else:
            arrays["evmax"] = self._evmax.copy()
        return {"meta": meta, "arrays": arrays}

    @classmethod
    def restore(cls, state: Mapping[str, object]) -> "StreamSession":
        """Rebuild a session from :meth:`snapshot` output. Parity-pinned:
        restore at any packet boundary then feed the remaining packets
        and the emitted pick stream is bit-identical to the session that
        never died (tests/test_torch_stream_session.py). Raises ``ValueError``
        on version/shape mismatch — callers treat that as journal loss
        and fall back to a fresh session (gap-stitch re-warm)."""
        meta = state["meta"]
        arrays = state["arrays"]
        if meta.get("version") != STATE_VERSION:
            raise ValueError(
                f"session state version {meta.get('version')!r}, "
                f"want {STATE_VERSION}"
            )
        cfg = SessionConfig(**dict(meta["config"]))
        sess = cls(cfg)
        sess.n_samples = int(meta["n_samples"])
        sess.n_windows = int(meta["n_windows"])
        sess._next_offset = int(meta["next_offset"])
        sess._base = int(meta["base"])
        sess._curve_base = int(meta["curve_base"])
        sess._final_upto = int(meta["final_upto"])
        sess._finished = bool(meta["finished"])
        sess._finalized = bool(meta["finalized"])
        tl = meta["total_len"]
        sess._total_len = None if tl is None else int(tl)
        ring = np.asarray(arrays["ring"], np.float32)
        if ring.ndim != 2 or ring.shape[1] != cfg.in_channels:
            raise ValueError(f"ring shape {ring.shape} != (*, {cfg.in_channels})")
        sess._ring = ring.copy()
        if cfg.combine == "mean":
            sess._acc = np.asarray(arrays["acc"], np.float32).copy()
            sess._hits = np.asarray(arrays["hits"], np.float32).copy()
            if sess._acc.shape != (sess._hits.shape[0], 3):
                raise ValueError("acc/hits shape mismatch")
        else:
            sess._evmax = np.asarray(arrays["evmax"], np.float32).copy()
        for picker, key in ((sess._ppk, "ppk"), (sess._spk, "spk")):
            pm = meta[key]
            picker._comp = [(int(p), float(h)) for p, h in pm["comp"]]
            picker._scanned = int(pm["scanned"])
        dm = meta["det"]
        sess._det._on = None if dm["on"] is None else int(dm["on"])
        sess._det._off = int(dm["off"])
        sess._det._scanned = int(dm["scanned"])
        return sess

    # ---------------------------------------------------------- plumbing
    def _normalized(self, offset: int, length: int) -> np.ndarray:
        s = offset - self._base
        return _znorm(self._ring[s : s + length])

    def _trim_ring(self) -> None:
        # Keep raw samples any future window can need: the next regular
        # offset, or the tail window of a stream ending right now.
        keep_from = min(self._next_offset, max(0, self.n_samples - self.config.window))
        drop = keep_from - self._base
        if drop > 0:
            self._ring = self._ring[drop:]
            self._base = keep_from

    def _ensure_curve(self, upto: int) -> None:
        have = self._curve_base + (
            self._hits.shape[0] if self.config.combine == "mean" else self._evmax.shape[0]
        )
        grow = upto - have
        if grow <= 0:
            return
        grow = max(grow, self.config.window)  # amortize
        if self.config.combine == "mean":
            self._acc = np.concatenate(
                [self._acc, np.zeros((grow, 3), np.float32)], axis=0
            )
            self._hits = np.concatenate(
                [self._hits, np.zeros((grow,), np.float32)], axis=0
            )
        else:
            self._evmax = np.concatenate(
                [self._evmax, np.zeros((grow, 3), np.float32)], axis=0
            )

    def _frontier(self) -> int:
        """First sample a FUTURE window could still cover: pending
        (handed out, not yet integrated) windows gate finality exactly
        like un-pushed ones."""
        pend = min(self._pending) if self._pending else None
        if self._finished:
            total = self._total_len if self._total_len is not None else self.n_samples
            return total if pend is None else pend
        cands = [self._next_offset, self.n_samples - self.config.window]
        if pend is not None:
            cands.append(pend)
        return max(0, min(cands))

    def _curve(self, a: int, b: int) -> np.ndarray:
        """Final stitched curve over absolute [a, b) — the exact float32
        op sequence annotate applies to the stitched accumulators."""
        c = self.config
        lo, hi = a - self._curve_base, b - self._curve_base
        if c.combine == "mean":
            cur = self._acc[lo:hi] / np.maximum(self._hits[lo:hi], 1.0)[:, None]
            if c.channel0 == "non":
                # Coverage holes (abandoned windows) have zero hits, so
                # the raw quotient reads noise=0 -> strength 1-0 = 1.0:
                # a phantom full-strength detection spanning the hole.
                # Render holes as pure noise instead. Non-degraded
                # sessions never have zero-hit final samples, so the
                # offline-parity pin is untouched.
                hole = self._hits[lo:hi] == 0.0
                if hole.any():
                    cur[hole, 0] = 1.0
        else:
            cur = self._evmax[lo:hi].copy()
            if c.channel0 == "non":
                cur[:, 0] = np.float32(1.0) - cur[:, 0]
        return cur

    def _advance(self, at_end: bool = False) -> Dict[str, list]:
        c = self.config
        new_final = self._frontier()
        if at_end:
            new_final = self._total_len if self._total_len is not None else self.n_samples
        if new_final < self._final_upto:
            new_final = self._final_upto
        self._final_upto = max(self._final_upto, new_final)
        out: Dict[str, list] = {"ppk": [], "spk": [], "det": []}
        if new_final <= 0:
            return out
        # Pickers re-read a little context behind their cursors (peak
        # candidates need t-1); hand them the curve from the earliest
        # cursor - 1. Curve memory stays O(window + stride): cursors trail
        # the frontier by at most one component span.
        lo = max(0, min(self._ppk._scanned, self._spk._scanned, self._det._scanned) - 1)
        cur = self._curve(lo, new_final)
        strength = (
            np.float32(1.0) - cur[:, 0] if c.channel0 == "non" else cur[:, 0]
        )
        trim = self.n_samples if self._total_len == c.window else None
        for name, picker, chan in (("ppk", self._ppk, 1), ("spk", self._spk, 2)):
            got = picker.scan(cur[:, chan], lo, new_final, at_end)
            if trim is not None:  # short record: drop picks inside the pad
                got = [p for p in got if p < trim]
            out[name].extend(got)
            self._picks[name].extend(got)
        runs = self._det.scan(strength, lo, new_final, at_end)
        if trim is not None:  # clip detections at the true record end
            runs = [(on, min(off, trim - 1)) for on, off in runs if on < trim]
        out["det"].extend(runs)
        self._picks["det"].extend(runs)
        self._trim_curve()
        return out

    def _trim_curve(self) -> None:
        keep_from = max(
            0,
            min(self._ppk._scanned, self._spk._scanned, self._det._scanned) - 1,
        )
        # Never trim past unstitched territory either.
        keep_from = min(keep_from, self._final_upto)
        drop = keep_from - self._curve_base
        if drop > 256:  # amortize the copies
            if self.config.combine == "mean":
                self._acc = self._acc[drop:]
                self._hits = self._hits[drop:]
            else:
                self._evmax = self._evmax[drop:]
            self._curve_base = keep_from


def _znorm(win: np.ndarray) -> np.ndarray:
    """Per-window z-normalization, bit-identical to annotate's
    ``normalize(chunk, "std", axis=1)``: the reductions are per-window
    along the time axis, so a (1, window, C) batch of one reproduces the
    offline batch row exactly."""
    return normalize(win[None], "std", axis=1)[0]
