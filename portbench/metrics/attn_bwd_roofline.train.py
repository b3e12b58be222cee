"""attn_bwd_roofline.train: the pooled-attention backward's share of its
roofline in the train step.

Work per attention call of (L, M, H, E) at batch N, 4-byte elements, each
input read once and each output written once: q, g and o (L), k and v (M)
and the forward's log-sum-exp (N·H·L floats) read, dq (L), dk and dv (M)
written; ``10·N·L·M·H·E`` operations (the scores rebuilt, then dP, dV,
dQ and dK). The least time is the larger of the bytes over the card's HBM
bandwidth and the operations over its TF32 tensor-core peak. Summed over
the configuration's attention calls, over the device seconds of the
kernels named ``KERNELS`` (the backward and its row-split reduce) in the
traced steps. In %.
"""

KERNELS = r"seist::.*\b(bwd_kernel|reduce_slabs)<|5seist.*(10bwd_kernel|12reduce_slabs)I"


def work(n, length, m, heads, e):
    """(operations, bytes) of one call."""
    ops = 10 * n * length * m * heads * e
    nbytes = 4 * n * heads * e * (4 * length + 4 * m) + 4 * n * heads * length
    return ops, nbytes


def read(run):
    t = run.get("trace")
    calls = run["config"].get("attention_calls") or []
    if run.get("lane") != "train" or t is None or not calls:
        return None
    secs, launches = t.kernel_seconds(KERNELS)
    if launches == 0:
        return None
    peak, bw = run["peaks"]["flops"]["tf32_tensor"], run["peaks"]["hbm_bytes_per_s"]
    least = sum(max(o / peak, b / bw) for o, b in
                (work(run["batch"], *c) for c in calls)) * t.calls
    return 100.0 * least / secs
