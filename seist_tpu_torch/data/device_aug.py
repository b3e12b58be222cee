"""Device-side augmentation and soft-label synthesis over a batch (the
port's counterpart of ``seist_tpu/data/device_aug.py``).

``--device-aug step|cached`` moves the whole train-time preprocessing of
``DataPreprocessor`` onto the card: window cut, event add and shift,
noise generation, channel drop, amplitude scale, pre-emphasis, SNR noise,
gaps, normalisation and the soft labels. The host only gathers raw rows
(``step``), or not even that (``cached``: the raw epoch lives on the card
and a step receives sample indices).

The JAX package writes each op for one sample under ``vmap``; here every
op takes a leading batch axis B: waveforms (B, C, L), phase arrays (B, P)
int64 holding the valid phases first and ``_BIG`` after them, counts and
gates (B,). Per-sample shifts and slices (``jnp.roll``,
``lax.dynamic_slice``, the ``dynamic_update_slice`` of the soft labels)
are index arithmetic and gathers, with every index clipped as the JAX
code's clamping implies. Nothing reads the device back, so a processor
runs inside a CUDA graph (``train/graph.py``).

Randomness: sample b's key is ``fold_in(fold_in(PRNGKey(seed), epoch),
idx[b])`` and each decision takes the named subkey ``fold_in(key, TAG)``
with the JAX package's frozen tags, so the draws equal ``jax.random``'s
(``ops/threefry.py``): one call of :func:`~seist_tpu_torch.ops.threefry.
aug_draws` per batch, the kernel K3 on the card. A processed batch equals
the JAX package's up to float rounding: phases, counts and gates exactly,
waveforms and labels within 1e-5 (``tests/test_torch_device_aug.py``).

The per-sample keys are ``ops/threefry.sample_keys`` (the JAX package's
``sample_key``). ``ScriptedRNG``, ``build_replay_script`` and ``u2i_np``
(the JAX package's replay of device draws into the numpy preprocessor)
are test tooling there and are not ported: the port's tests hold these
functions against the JAX ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from seist_tpu_torch import taskspec
from seist_tpu_torch.data import pipeline
from seist_tpu_torch.data.preprocess import DataPreprocessor, make_soft_window, pad_phases
from seist_tpu_torch.ops import threefry

# Invalid phase-slot sentinel: sorts after every real sample index.
_BIG = 2**30

# Named-draw tags: the JAX package's frozen fold_in constants.
_T_GEN_GATE = 1
_T_GEN_FIELD = 2
_T_ADD_GATE = 3
_T_ADD_TARGET = 4
_T_ADD_POS = 5
_T_ADD_SCALE = 6
_T_SHIFT_GATE = 7
_T_SHIFT = 8
_T_DROP_GATE = 9
_T_DROP_NUM = 10
_T_DROP_CH = 11
_T_SCALE_GATE = 12
_T_SCALE_FLIP = 13
_T_SCALE_FACTOR = 14
_T_PRE_GATE = 15
_T_NOISE_GATE = 16
_T_SNR = 17
_T_NOISE_FIELD = 18
_T_GAP_GATE = 19
_T_GAP_POS = 20
_T_GAP_START = 21
_T_GAP_END = 22
_T_CROP = 23

# SOFT io-items the label synthesizer implements.
_SOFT_SUPPORTED = {"ppk", "spk", "non", "det"}


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Static configuration of the device pipeline; field names and
    meanings are :class:`DataPreprocessor`'s constructor arguments."""

    seed: int
    window: int              # in_samples
    raw_len: int             # uniform raw trace length of the dataset
    channels: int
    phase_slots: int         # P: capacity of the phase arrays
    data_channels: Tuple[str, ...]
    sampling_rate: int
    norm_mode: str = "std"
    coda_ratio: float = 1.4
    min_event_gap: int = 0   # samples (DataPreprocessor.min_event_gap)
    max_event_num: int = 1
    add_event_rate: float = 0.0
    shift_event_rate: float = 0.0
    generate_noise_rate: float = 0.0
    drop_channel_rate: float = 0.0
    scale_amplitude_rate: float = 0.0
    pre_emphasis_rate: float = 0.0
    pre_emphasis_ratio: float = 0.97
    add_noise_rate: float = 0.0
    add_gap_rate: float = 0.0
    soft_label_shape: str = "gaussian"
    soft_label_width: int = 50

    @classmethod
    def from_preprocessor(cls, pre: DataPreprocessor, *, seed: int, raw_len: int,
                          phase_slots: int) -> "AugConfig":
        return cls(
            seed=int(seed),
            window=int(pre.in_samples),
            raw_len=int(raw_len),
            channels=len(pre.data_channels),
            phase_slots=int(phase_slots),
            data_channels=tuple(pre.data_channels),
            sampling_rate=int(pre.sampling_rate),
            norm_mode=pre.norm_mode,
            coda_ratio=float(pre.coda_ratio),
            min_event_gap=int(pre.min_event_gap),
            max_event_num=int(pre._max_event_num),
            add_event_rate=float(pre.add_event_rate),
            shift_event_rate=float(pre.shift_event_rate),
            generate_noise_rate=float(pre.generate_noise_rate),
            drop_channel_rate=float(pre.drop_channel_rate),
            scale_amplitude_rate=float(pre.scale_amplitude_rate),
            pre_emphasis_rate=float(pre.pre_emphasis_rate),
            pre_emphasis_ratio=float(pre.pre_emphasis_ratio),
            add_noise_rate=float(pre.add_noise_rate),
            add_gap_rate=float(pre.add_gap_rate),
            soft_label_shape=pre.soft_label_shape,
            soft_label_width=int(pre.soft_label_width),
        )


# --------------------------------------------------------------------- draws
def _draw_layout(cfg: AugConfig):
    """The named draws of :func:`draw_all`: (name, tag, count, scalar) of
    every uniform draw in slot order, and (name, tag) of every normal
    field the config can fire."""
    k = max(cfg.max_event_num, 1)
    c = cfg.channels
    uniforms = [
        ("gen_gate", _T_GEN_GATE, 1, True),
        ("add_gate", _T_ADD_GATE, k, False),
        ("add_target", _T_ADD_TARGET, k, False),
        ("add_pos", _T_ADD_POS, k, False),
        ("add_scale", _T_ADD_SCALE, k, False),
        ("shift_gate", _T_SHIFT_GATE, 1, True),
        ("shift_u", _T_SHIFT, 1, True),
        ("drop_gate", _T_DROP_GATE, 1, True),
        ("drop_num_u", _T_DROP_NUM, 1, True),
        ("drop_ch_u", _T_DROP_CH, max(c - 1, 1), False),
        ("scale_gate", _T_SCALE_GATE, 1, True),
        ("scale_flip", _T_SCALE_FLIP, 1, True),
        ("scale_factor_u", _T_SCALE_FACTOR, 1, True),
        ("pre_gate", _T_PRE_GATE, 1, True),
        ("noise_gate", _T_NOISE_GATE, 1, True),
        ("snr_u", _T_SNR, c, False),
        ("gap_gate", _T_GAP_GATE, 1, True),
        ("gap_pos_u", _T_GAP_POS, 1, True),
        ("gap_start_u", _T_GAP_START, 1, True),
        ("gap_end_u", _T_GAP_END, 1, True),
        ("crop_u", _T_CROP, 1, True),
    ]
    fields = []
    # The (C, L) normal fields are the expensive draws: only those whose op
    # can fire (named keying means skipping one shifts no other draw).
    if cfg.generate_noise_rate > 0:
        fields.append(("gen_field", _T_GEN_FIELD))
    if cfg.add_noise_rate > 0:
        fields.append(("noise_field", _T_NOISE_FIELD))
    return uniforms, fields


def draw_all(cfg: AugConfig, epoch: torch.Tensor, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every named draw of the batch's samples: (B,) for a scalar draw,
    (B, n) for a vector one, (B, C, L) for a field; uniforms on [0, 1),
    fields standard normal. One :func:`~seist_tpu_torch.ops.threefry.
    aug_draws` call (K3 on the card)."""
    uniforms, fields = _draw_layout(cfg)
    slots = [(tag, pos) for _, tag, n, _ in uniforms for pos in range(n)]
    u, f = threefry.aug_draws(cfg.seed, epoch.reshape(()).to(torch.int32), idx, slots,
                              [tag for _, tag in fields], cfg.channels * cfg.raw_len)
    draws: Dict[str, torch.Tensor] = {}
    start = 0
    for name, _, n, scalar in uniforms:
        draws[name] = u[:, start] if scalar else u[:, start:start + n]
        start += n
    for i, (name, _) in enumerate(fields):
        draws[name] = f[:, i].reshape(-1, cfg.channels, cfg.raw_len)
    return draws


def _u2i(u: torch.Tensor, n) -> torch.Tensor:
    """``floor(u * n)`` clamped to [0, n-1], the product in float32: the
    JAX package's one integer-draw formula. ``n`` an int or an int tensor."""
    if isinstance(n, int):  # no tensor made from a host value: capture-safe
        return torch.clamp(torch.floor(u * float(np.float32(n))).to(torch.int64), max=n - 1)
    v = torch.floor(u * n.to(torch.float32)).to(torch.int64)
    return torch.minimum(v, n - 1)


# ----------------------------------------------------------------- phase ops
def _col(x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1), to broadcast against a (B, n) axis."""
    return x.unsqueeze(-1)


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` with a (B,) mask broadcast over a's trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def _sorted_insert(vals: torch.Tensor, n: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Insert ``new`` at slot ``n`` of each sorted-valid-prefix row and
    re-sort (invalid slots hold _BIG and stay at the tail)."""
    ar = torch.arange(vals.shape[1], device=vals.device)
    return torch.sort(torch.where(ar == _col(n), _col(new), vals), dim=1).values


def _coda_end(cfg: AugConfig, ppk: torch.Tensor, spk: torch.Tensor) -> torch.Tensor:
    """``int(spk + coda_ratio * (spk - ppk))`` in float32, truncated toward
    zero like python ``int()``; the multiply-add rounds once, as XLA's CPU
    code fuses it (float64 holds the float32 product exactly)."""
    v = (spk.to(torch.float32).double()
         + float(np.float32(cfg.coda_ratio)) * (spk - ppk).to(torch.float32).double())
    return v.to(torch.float32).to(torch.int32).to(torch.int64)


def _roll(data: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-sample ``jnp.roll(data[b], shift[b], axis=-1)`` of (B, C, L)."""
    length = data.shape[-1]
    cols = torch.arange(length, device=data.device)
    src = torch.remainder(cols - _col(shift), length)  # (B, L)
    return torch.gather(data, 2, src.unsqueeze(1).expand_as(data))


# ------------------------------------------------------------- augment ops
def normalize(data: torch.Tensor, mode: str) -> torch.Tensor:
    """``preprocess.normalize`` per channel over the last axis: demean, then
    divide by the SIGNED max ('max', the reference's training quirk), the
    population std ('std'), or nothing ('')."""
    data = data - data.mean(dim=-1, keepdim=True)
    if mode == "":
        return data
    if mode == "max":
        scale = data.amax(dim=-1, keepdim=True)
    elif mode == "std":
        scale = data.std(dim=-1, keepdim=True, correction=0)
    else:
        raise ValueError(f"Supported modes: 'max', 'std', '', got '{mode}'")
    return data / torch.where(scale == 0, torch.ones_like(scale), scale)


def generate_noise(cfg: AugConfig, data, ppks, np_p, spks, np_s, field):
    """Wipe every phase+coda span with the noise field (position-indexed:
    column t of a span gets ``field[..., t]``, so overlapping spans agree,
    as numpy's sequential overwrite)."""
    length = data.shape[-1]
    cols = torch.arange(length, device=data.device)
    npair = torch.minimum(np_p, np_s)
    for j in range(cfg.phase_slots):
        ppk, spk = ppks[:, j], spks[:, j]
        ce = torch.clamp(_coda_end(cfg, ppk, spk), 0, length)
        wipe = _col(j < npair) & (cols >= _col(ppk)) & (cols < _col(ce))
        data = torch.where(wipe.unsqueeze(1), field, data)
    return data


def add_event_once(cfg: AugConfig, data, ppks, np_p, spks, np_s, u_t, u_pos, u_scale, active):
    """One iteration of the event-duplication augment: pick event
    ``floor(u_t * n)``, add a ``u_scale``-scaled copy at ``left +
    floor(u_pos * (right-left))`` where a slot exists."""
    length = data.shape[-1]
    j = _u2i(u_t, torch.clamp(np_p, min=1))
    ppk = torch.gather(ppks, 1, _col(j))[:, 0]
    spk = torch.gather(spks, 1, _col(j))[:, 0]
    ce = _coda_end(cfg, ppk, spk)
    left = ce + cfg.min_event_gap
    right = length - (spk - ppk) - cfg.min_event_gap
    fire = active & (np_p > 0) & (left < right)
    pos = left + _u2i(u_pos, torch.clamp(right - left, min=1))
    spk_add = pos + spk - ppk
    space = torch.minimum(length - pos, ce - ppk)
    cols = torch.arange(length, device=data.device)
    seg = (cols >= _col(pos)) & (cols < _col(pos + space))
    rolled = _roll(data, pos - ppk)
    add = data + rolled * u_scale.reshape(-1, 1, 1)
    data = torch.where((_col(fire) & seg).unsqueeze(1), add, data)
    ppks = _sel(fire, _sorted_insert(ppks, np_p, pos), ppks)
    spks = _sel(fire, _sorted_insert(spks, np_s, spk_add), spks)
    return data, ppks, np_p + fire.to(np_p.dtype), spks, np_s + fire.to(np_s.dtype)


def shift_event(data, ppks, np_p, spks, np_s, shift):
    """Circular time shift of every sample by its ``shift``."""
    length = data.shape[-1]
    ar = torch.arange(ppks.shape[1], device=ppks.device)

    def sh(vals, n):
        moved = torch.remainder(vals + _col(shift), length)
        return torch.sort(torch.where(ar < _col(n), moved, _BIG), dim=1).values

    return _roll(data, shift), sh(ppks, np_p), np_p, sh(spks, np_s), np_s


def drop_channel(data, u_num, u_ch):
    """Zero ``1 + floor(u_num*(C-1))`` channels, chosen one after another
    from the ascending list of the remaining ones."""
    c = data.shape[1]
    if c < 2:
        return data
    drop_num = 1 + _u2i(u_num, c - 1)
    cand = torch.ones(data.shape[0], c, dtype=torch.bool, device=data.device)
    chans = torch.arange(c, device=data.device)
    for i in range(c - 1):
        active = i < drop_num
        k = _u2i(u_ch[:, i], c - i)
        rank = torch.cumsum(cand.to(torch.int64), dim=1) - 1
        sel = torch.argmax(((rank == _col(k)) & cand).to(torch.int32), dim=1)
        hit = _col(active) & (chans == _col(sel))
        data = torch.where(hit.unsqueeze(-1), torch.zeros_like(data), data)
        cand = cand & ~hit
    return data


def adjust_amplitude(data):
    """Post-drop rescale by C / the count of channels still nonzero."""
    nnz = (data.abs().amax(dim=2) != 0).sum(dim=1)
    factor = torch.where(nnz > 0, data.shape[1] / torch.clamp(nnz, min=1).to(torch.float32),
                         torch.ones((), dtype=torch.float32, device=data.device))
    return data * factor.reshape(-1, 1, 1)


def scale_amplitude(data, u_flip, u_factor):
    """Multiply or divide by U(1, 3)."""
    factor = (1.0 + 2.0 * u_factor).reshape(-1, 1, 1)
    return torch.where((u_flip < 0.5).reshape(-1, 1, 1), data * factor, data / factor)


def pre_emphasis(data, ratio: float):
    """First-order pre-emphasis filter."""
    return torch.cat([data[..., :1], data[..., 1:] - ratio * data[..., :-1]], dim=-1)


def add_noise(data, u_snr, field):
    """Per-channel gaussian noise at SNR ``10 + floor(u*40)`` dB."""
    snr = 10 + _u2i(u_snr, 40)
    px = (data ** 2).sum(dim=-1) / data.shape[-1]
    pn = px * torch.pow(10.0, -snr.to(torch.float32) / 10.0)
    return data + field * torch.sqrt(pn).unsqueeze(-1)


def add_gaps(data, ppks, np_p, spks, np_s, u_pos, u_start, u_end):
    """Zero a random span between phases: the unique sorted phases and
    L-1, an interval of them, a random sub-span of it (a random span of
    the trace when there is no phase)."""
    length = data.shape[-1]
    b, p = ppks.shape
    ar = torch.arange(p, device=ppks.device)
    vals = torch.cat([
        torch.where(ar < _col(np_p), ppks, _BIG),
        torch.where(ar < _col(np_s), spks, _BIG),
        torch.full((b, 1), length - 1, dtype=ppks.dtype, device=ppks.device),
    ], dim=1)
    vals = torch.sort(vals, dim=1).values
    # set()-dedup: mark repeats invalid, re-sort so uniques pack the front.
    dup = torch.cat([torch.zeros(b, 1, dtype=torch.bool, device=vals.device),
                     vals[:, 1:] == vals[:, :-1]], dim=1)
    uniq = torch.sort(torch.where(dup, _BIG, vals), dim=1).values
    n_u = (uniq < _BIG).sum(dim=1)
    has = (np_p + np_s) > 0

    ip = _u2i(u_pos, torch.clamp(n_u - 1, min=1))
    lo = torch.gather(uniq, 1, _col(ip))[:, 0]
    hi = torch.gather(uniq, 1, _col(torch.clamp(ip + 1, max=uniq.shape[1] - 1)))[:, 0]
    sgt_p = lo + _u2i(u_start, torch.clamp(hi - lo, min=1))
    egt_p = sgt_p + _u2i(u_end, torch.clamp(hi - sgt_p, min=1))

    sgt_n = _u2i(u_start, length - 1)
    egt_n = sgt_n + 1 + _u2i(u_end, torch.clamp(length - 1 - sgt_n, min=1))

    sgt = torch.where(has, sgt_p, sgt_n)
    egt = torch.where(has, egt_p, egt_n)
    cols = torch.arange(length, device=data.device)
    gap = (cols >= _col(sgt)) & (cols < _col(egt))
    return torch.where(gap.unsqueeze(1), torch.zeros_like(data), data)


def cut_window(cfg: AugConfig, data, ppks, np_p, spks, np_s, u_crop):
    """Cut the raw traces to ``cfg.window`` (the random-crop branch; the
    p_position_ratio mode is host-only). Shorter traces are zero-padded,
    equal lengths pass through: both draw-free, as in numpy."""
    length, w, p = cfg.raw_len, cfg.window, cfg.phase_slots
    if length == w:
        return data, ppks, np_p, spks, np_s
    if length < w:
        pad = torch.zeros(data.shape[:2] + (w - length,), dtype=data.dtype, device=data.device)
        return torch.cat([data, pad], dim=-1), ppks, np_p, spks, np_s
    ar = torch.arange(p, device=ppks.device)
    min_ppk = torch.where(ar < _col(np_p), ppks, _BIG).amin(dim=1)
    bound = torch.clamp(torch.clamp(min_ppk, max=length - w) - cfg.min_event_gap, min=1)
    c_l = _u2i(u_crop, bound)
    # lax.dynamic_slice clamps its start so that the slice fits.
    start = torch.clamp(c_l, 0, length - w)
    cols = _col(start) + torch.arange(w, device=data.device)
    win = torch.gather(data, 2, cols.unsqueeze(1).expand(data.shape[0], data.shape[1], w))

    def cutp(vals, n):
        keep = (ar < _col(n)) & (vals >= _col(c_l)) & (vals < _col(c_l + w))
        return (torch.sort(torch.where(keep, vals - _col(c_l), _BIG), dim=1).values,
                keep.sum(dim=1))

    ppks2, np_p2 = cutp(ppks, np_p)
    spks2, np_s2 = cutp(spks, np_s)
    return win, ppks2, np_p2, spks2, np_s2


# ------------------------------------------------------------- soft labels
def pad_phases_dev(ppks, np_p, spks, np_s, padding_idx: int, num_samples):
    """``preprocess.pad_phases``'s positional pairing on phase arrays:
    (B, 2P) arrays carrying the real sentinel values (-pad and
    num_samples+pad) and the padded count."""
    b, p = ppks.shape
    pad = abs(int(padding_idx))
    ar = torch.arange(p, device=ppks.device)
    cont = torch.ones(b, dtype=torch.bool, device=ppks.device)
    k = torch.zeros(b, dtype=torch.int64, device=ppks.device)
    n_min = torch.minimum(np_p, np_s)
    # k = the longest prefix with ppk[i] < spk[b-idx-1+i] for all i <= idx.
    for idx in range(p):
        sp_idx = torch.clamp(_col(np_s) - idx - 1 + ar, 0, p - 1)
        ok = torch.where(ar <= idx, ppks < torch.gather(spks, 1, sp_idx), True).all(dim=1)
        cont = cont & (idx < n_min) & ok
        k = k + cont.to(torch.int64)
    n_lead = np_s - k  # sentinel ppks prepended
    n_tot = np_p + np_s - k
    i2 = torch.arange(2 * p, device=ppks.device)
    ppks_pad = torch.where(
        i2 < _col(n_lead), -pad,
        torch.gather(ppks, 1, torch.clamp(i2 - _col(n_lead), 0, p - 1)))
    spks_pad = torch.where(
        i2 < _col(np_s), torch.gather(spks, 1, torch.clamp(i2, 0, p - 1).expand(b, -1)),
        num_samples + pad)
    return ppks_pad, spks_pad, n_tot


def soft_label_place(idxs, valid, window_arr, length: int):
    """Sum label windows centred at ``idxs`` (B, J): an index outside [0,
    length-1] contributes nothing (the reference skips it whole); windows
    in range are cropped at the edges. Windows add in j order, one
    scatter per j, as the JAX package's update loop adds them."""
    width = window_arr.shape[0] - 1
    left = width // 2
    off = width + 1
    b = idxs.shape[0]
    buf = torch.zeros(b, length + 2 * off, dtype=torch.float32, device=idxs.device)
    taps = torch.arange(width + 1, device=idxs.device)
    for j in range(idxs.shape[1]):
        idx = idxs[:, j]
        ok = valid[:, j] & (idx >= 0) & (idx <= length - 1)
        start = torch.where(ok, idx - left + off, 0)
        vals = torch.where(_col(ok), window_arr, 0.0).expand(b, -1)
        buf = buf.scatter_add(1, _col(start) + taps, vals)
    return buf[:, off:off + length]


def label_pick(cfg: AugConfig, vals, n, window_arr):
    """'ppk' / 'spk' soft label from the raw phase list."""
    valid = torch.arange(cfg.phase_slots, device=vals.device) < _col(n)
    return soft_label_place(vals, valid, window_arr, cfg.window)


def label_non(cfg: AugConfig, ppks, np_p, spks, np_s, window_arr):
    """'non' = 1 - soft(padded ppks) - soft(padded spks), clipped at 0."""
    w = cfg.window
    pp, ss, n_tot = pad_phases_dev(ppks, np_p, spks, np_s, cfg.soft_label_width, w)
    valid = torch.arange(pp.shape[1], device=pp.device) < _col(n_tot)
    lbl = (1.0 - soft_label_place(pp, valid, window_arr, w)
           - soft_label_place(ss, valid, window_arr, w))
    return torch.clamp(lbl, min=0.0)


def label_det(cfg: AugConfig, ppks, np_p, spks, np_s, window_arr):
    """'det': per padded pair, soft windows at (ppk, coda end) plus 1.0
    over [clip(ppk), clip(coda end)); summed and clipped at 1."""
    w = cfg.window
    pp, ss, n_tot = pad_phases_dev(ppks, np_p, spks, np_s, cfg.soft_label_width, w)
    cols = torch.arange(w, device=pp.device)
    label = torch.zeros(pp.shape[0], w, dtype=torch.float32, device=pp.device)
    for j in range(pp.shape[1]):
        ok = j < n_tot
        dst = pp[:, j]
        det = _coda_end(cfg, dst, ss[:, j])
        li = soft_label_place(torch.stack([dst, det], 1), torch.stack([ok, ok], 1),
                              window_arr, w)
        fill = (_col(ok) & (cols >= _col(torch.clamp(dst, 0, w)))
                & (cols < _col(torch.clamp(det, 0, w))))
        label = label + torch.where(fill, 1.0, li)
    return torch.clamp(label, max=1.0)


# ------------------------------------------------------------- composition
def process_event(cfg: AugConfig, data, ppks, np_p, spks, np_s, draws, augment):
    """The full train-time preprocessing of a batch: augmentation (where
    ``augment`` (B,) is set), window cut, normalisation. The phase arrays
    are the ``_is_noise``/``pad_phases`` state :func:`host_prepare` made.

    Returns ``dict(win, ppks, np_p, spks, np_s, gen_fired)``: ``win`` the
    normalised (B, C, window) waveforms, the phases window-relative.
    Every op is guarded by a static ``rate > 0`` check, so a disabled op
    costs nothing; named draws keep the enabled ops' streams the same."""
    augment = augment.to(torch.bool)

    def gate(name, rate):
        return augment & (draws[name] < float(np.float32(rate)))

    # -- generate-noise branch: wipe, clear, drop?, scale?
    if cfg.generate_noise_rate > 0:
        gen_fired = gate("gen_gate", cfg.generate_noise_rate)
        gdata = generate_noise(cfg, data, ppks, np_p, spks, np_s, draws["gen_field"])
        if cfg.drop_channel_rate > 0:
            g_drop = gate("drop_gate", cfg.drop_channel_rate)
            gd = adjust_amplitude(drop_channel(gdata, draws["drop_num_u"], draws["drop_ch_u"]))
            gdata = _sel(g_drop, gd, gdata)
        if cfg.scale_amplitude_rate > 0:
            g_scale = gate("scale_gate", cfg.scale_amplitude_rate)
            gdata = _sel(g_scale, scale_amplitude(gdata, draws["scale_flip"],
                                                  draws["scale_factor_u"]), gdata)
    else:
        gen_fired = torch.zeros_like(augment)

    # -- regular branch: add*, shift?, drop?, scale?, pre?, noise?, gap?
    e, epp, enp, ess, ens = data, ppks, np_p, spks, np_s
    n0 = np_p
    if cfg.add_event_rate > 0:
        rate = float(np.float32(cfg.add_event_rate))
        for i in range(cfg.max_event_num):
            act = augment & (i < cfg.max_event_num - n0) & (draws["add_gate"][:, i] < rate)
            e, epp, enp, ess, ens = add_event_once(
                cfg, e, epp, enp, ess, ens, draws["add_target"][:, i], draws["add_pos"][:, i],
                draws["add_scale"][:, i], act)
    if cfg.shift_event_rate > 0:
        sh_fire = gate("shift_gate", cfg.shift_event_rate)
        shift = _u2i(draws["shift_u"], cfg.raw_len)
        se, sepp, _, sess, _ = shift_event(e, epp, enp, ess, ens, shift)
        e = _sel(sh_fire, se, e)
        epp = _sel(sh_fire, sepp, epp)
        ess = _sel(sh_fire, sess, ess)
    if cfg.drop_channel_rate > 0:
        d_fire = gate("drop_gate", cfg.drop_channel_rate)
        de = adjust_amplitude(drop_channel(e, draws["drop_num_u"], draws["drop_ch_u"]))
        e = _sel(d_fire, de, e)
    if cfg.scale_amplitude_rate > 0:
        s_fire = gate("scale_gate", cfg.scale_amplitude_rate)
        e = _sel(s_fire, scale_amplitude(e, draws["scale_flip"], draws["scale_factor_u"]), e)
    if cfg.pre_emphasis_rate > 0:
        p_fire = gate("pre_gate", cfg.pre_emphasis_rate)
        e = _sel(p_fire, pre_emphasis(e, cfg.pre_emphasis_ratio), e)
    if cfg.add_noise_rate > 0:
        n_fire = gate("noise_gate", cfg.add_noise_rate)
        e = _sel(n_fire, add_noise(e, draws["snr_u"], draws["noise_field"]), e)
    if cfg.add_gap_rate > 0:
        gp_fire = gate("gap_gate", cfg.add_gap_rate)
        e = _sel(gp_fire, add_gaps(e, epp, enp, ess, ens, draws["gap_pos_u"],
                                   draws["gap_start_u"], draws["gap_end_u"]), e)

    # -- branch select (a sample not augmented falls through: every gate
    # above is & augment).
    if cfg.generate_noise_rate > 0:
        data = _sel(gen_fired, gdata, e)
        ppks = _sel(gen_fired, torch.full_like(ppks, _BIG), epp)
        spks = _sel(gen_fired, torch.full_like(spks, _BIG), ess)
        np_p = torch.where(gen_fired, 0, enp)
        np_s = torch.where(gen_fired, 0, ens)
    else:
        data, ppks, spks, np_p, np_s = e, epp, ess, enp, ens

    win, ppks, np_p, spks, np_s = cut_window(cfg, data, ppks, np_p, spks, np_s, draws["crop_u"])
    win = normalize(win, cfg.norm_mode)
    return {"win": win, "ppks": ppks, "np_p": np_p, "spks": spks, "np_s": np_s,
            "gen_fired": gen_fired}


def _soft_item(cfg: AugConfig, name: str, proc, window_arr):
    if name == "ppk":
        return label_pick(cfg, proc["ppks"], proc["np_p"], window_arr)
    if name == "spk":
        return label_pick(cfg, proc["spks"], proc["np_s"], window_arr)
    if name == "non":
        return label_non(cfg, proc["ppks"], proc["np_p"], proc["spks"], proc["np_s"],
                         window_arr)
    if name == "det":
        return label_det(cfg, proc["ppks"], proc["np_p"], proc["spks"], proc["np_s"],
                         window_arr)
    if name in cfg.data_channels:
        return proc["win"][:, cfg.data_channels.index(name)]
    if name in [f"d{c}" for c in cfg.data_channels]:
        ch = proc["win"][:, cfg.data_channels.index(name[-1])]
        return torch.cat([torch.zeros_like(ch[:, :1]), torch.diff(ch, dim=-1)], dim=-1)
    raise NotImplementedError(f"device-aug: unsupported soft item '{name}'")


def assemble_io(cfg: AugConfig, names, proc, values, onehots, window_arr):
    """``DataPreprocessor.get_inputs`` / ``get_targets_for_loss`` over the
    batch: grouped names stack channels-last, the waveform group is the
    window transposed to (B, L, C); a VALUE label is (B, 1) float32, a
    ONEHOT one (B, classes) int64, as the host pipeline gives them."""
    items = []
    for name in names:
        if isinstance(name, (tuple, list)):
            if tuple(name) == tuple(cfg.data_channels):
                items.append(proc["win"].transpose(1, 2))
            else:
                items.append(torch.stack([_soft_item(cfg, sub, proc, window_arr)
                                          for sub in name], dim=-1))
            continue
        kind = taskspec.get_kind(name)
        if kind == taskspec.SOFT:
            items.append(_soft_item(cfg, name, proc, window_arr))
        elif kind == taskspec.VALUE:
            # generate_noise clears value fields (ref _clear_event_except).
            items.append(_sel(proc["gen_fired"], torch.zeros_like(values[name]), values[name]))
        elif kind == taskspec.ONEHOT:
            classes = torch.arange(taskspec.get_num_classes(name), device=onehots[name].device)
            items.append((_col(onehots[name].to(torch.int64)) == classes).to(torch.int64))
        else:  # pragma: no cover - the catalog has exactly three kinds
            raise NotImplementedError(name)
    return tuple(items) if len(items) > 1 else items[0]


class _Windows:
    """The soft-label window on each device, made at first use (eagerly:
    a processor's first call runs before any capture of it)."""

    def __init__(self, cfg: AugConfig):
        self.host = torch.from_numpy(
            make_soft_window(cfg.soft_label_width, cfg.soft_label_shape).astype(np.float32))
        self.on: Dict[torch.device, torch.Tensor] = {}

    def __call__(self, device: torch.device) -> torch.Tensor:
        if device not in self.on:
            self.on[device] = self.host.to(device)
        return self.on[device]


def make_row_processor(cfg: AugConfig, input_names, label_names):
    """``process(rows, idx, aug, epoch) -> (inputs, loss_targets)``: the
    batch's device preprocessing. ``rows`` is a raw-row batch
    (``pipeline.RawStore``) on the device, ``idx`` the (B,) int32 epoch
    indices keying the draws, ``aug`` the (B,) augment flags (the 2x-epoch
    rule), ``epoch`` a scalar int32 tensor."""
    windows = _Windows(cfg)

    def process(rows, idx, aug, epoch):
        window_arr = windows(idx.device)
        draws = draw_all(cfg, epoch, idx)
        proc = process_event(cfg, rows["data"], rows["ppks"].to(torch.int64),
                             rows["np_p"].to(torch.int64), rows["spks"].to(torch.int64),
                             rows["np_s"].to(torch.int64), draws, aug)
        values = rows.get("values", {})
        onehots = rows.get("onehots", {})
        return (assemble_io(cfg, input_names, proc, values, onehots, window_arr),
                assemble_io(cfg, label_names, proc, values, onehots, window_arr))

    return process


def make_cache_processor(cfg: AugConfig, input_names, label_names, n_raw: int,
                         augmentation: bool, mesh=None):
    """``process(cache, idx, epoch)``: the raw rows gathered from the
    resident cache by ``idx % n_raw`` (the 2x-epoch rule maps ``idx >=
    n_raw`` to the augmented copy), then the row processor. The draws
    are keyed by the global epoch index, so a sample's raw and augmented
    copies draw from different streams, and a row draws the same on
    whichever rank trains on it.

    ``idx`` of shape (B,): the cache holds every row. Under a mesh with a
    process group (``mesh``), ``idx`` is (D, B), every data rank's slots of
    the step (``pipeline.DeviceEpochCache.exchange_index_chunks``), the
    cache holds this rank's shard, and the rank's rows come from their
    owners through ``pipeline.exchange_rows`` (one ``all_to_all`` over the
    data group); the rank then processes its own B rows."""
    row_proc = make_row_processor(cfg, input_names, label_names)
    me = mesh.data_index if mesh is not None else 0
    group = mesh.data_group if mesh is not None else None

    def process(cache, idx, epoch):
        raw_all = torch.remainder(idx, n_raw) if augmentation else idx
        raw_all = raw_all.to(torch.int64)
        if idx.dim() == 2:
            rows = pipeline.exchange_rows(cache, raw_all, me, group)
            idx = idx[me]
        else:
            rows = pipeline._tree_map(lambda a: a.index_select(0, raw_all), cache)
        aug = idx >= n_raw if augmentation else torch.zeros_like(idx, dtype=torch.bool)
        return row_proc(rows, idx, aug, epoch)

    return process


# ------------------------------------------------------- support / fallback
def unsupported_reasons(pre: DataPreprocessor, input_names, label_names) -> List[str]:
    """Configuration features the device pipeline does not implement (the
    worker falls back to the host path and logs them)."""
    reasons = []
    if pre.mask_percent > 0 or pre.noise_percent > 0:
        reasons.append("mask_percent/noise_percent window masking")
    if 0 <= pre.p_position_ratio <= 1:
        reasons.append("p_position_ratio pinned-P windowing")
    if pre.norm_mode not in ("std", "max", ""):
        reasons.append(f"norm_mode '{pre.norm_mode}'")
    names = taskspec.flatten_io_names(list(input_names) + list(label_names))
    diff_names = {f"d{c}" for c in pre.data_channels}
    for name in names:
        kind = taskspec.get_kind(name)
        if kind == taskspec.SOFT and name not in (
                _SOFT_SUPPORTED | set(pre.data_channels) | diff_names):
            reasons.append(f"soft io-item '{name}'")
        if kind in (taskspec.VALUE, taskspec.ONEHOT) and pre.generate_noise_rate > 0:
            # The host path fails here (cleared value lists stack as
            # shape (0,)); refuse rather than invent semantics.
            reasons.append(f"generate_noise_rate > 0 with {kind} label '{name}'")
    return reasons


def hbm_budget_bytes(explicit_gb: float = 0.0, device=None) -> int:
    """The device memory budget of the resident epoch cache on one card: an
    explicit ``--device-aug-hbm-gb`` wins; otherwise half the card's total
    memory (``torch.cuda.mem_get_info``); 4 GiB for the CPU. Several data
    ranks compare it with their own share of the cache, as the JAX package
    compares per-device bytes (``seist_tpu/train/worker.py``'s ``est //
    data_axis``): a dataset too large for one card may fit on several."""
    if explicit_gb and explicit_gb > 0:
        return int(explicit_gb * (1 << 30))
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total) // 2
    return 4 << 30


def select_device_aug_mode(requested: str, est_bytes: int, budget_bytes: int,
                           reasons: Sequence[str]) -> Tuple[str, str]:
    """The effective ``--device-aug`` mode: an unsupported configuration ->
    'off' (host path); 'cached' over the memory budget -> 'step' (device
    augmentation of host-fed raw rows). Returns (mode, reason)."""
    if requested not in ("off", "step", "cached"):
        raise ValueError(f"--device-aug must be off|step|cached, got '{requested}'")
    if requested == "off":
        return "off", ""
    if reasons:
        return "off", "unsupported by device pipeline: " + "; ".join(reasons)
    if requested == "cached":
        if est_bytes > budget_bytes:
            return "step", (f"epoch cache ~{est_bytes / 2**20:.0f} MiB exceeds HBM "
                            f"budget {budget_bytes / 2**20:.0f} MiB")
        return "cached", ""
    return "step", ""


def host_prepare(pre: DataPreprocessor, event: dict, phase_slots: int) -> Dict[str, Any]:
    """The draw-free host half of the device pipeline, applied once per raw
    sample: ``_is_noise`` (clearing a noise trace's phases) and
    ``pad_phases``. Returns the fixed-shape numpy row the processor takes."""
    data = np.ascontiguousarray(np.asarray(event["data"], np.float32))
    ppks, spks = list(event["ppks"]), list(event["spks"])
    is_noise = pre._is_noise(data, ppks, spks, event["snr"])
    if is_noise:
        ppks, spks = [], []
    ppks, spks = pad_phases(ppks, spks, pre.min_event_gap, pre.in_samples)
    if max(len(ppks), len(spks)) > phase_slots:
        raise ValueError(f"event has {max(len(ppks), len(spks))} phases > "
                         f"phase_slots {phase_slots}")

    def arr(vals):
        return np.asarray(list(vals) + [_BIG] * (phase_slots - len(vals)), np.int32)

    return {
        "data": data,
        "ppks": arr(ppks),
        "np_p": np.int32(len(ppks)),
        "spks": arr(spks),
        "np_s": np.int32(len(spks)),
        "is_noise": bool(is_noise),
    }
