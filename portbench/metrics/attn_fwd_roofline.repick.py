"""attn_fwd_roofline.repick: the pooled-attention forward kernel's share of
its roofline in the re-picking program.

Work per attention call of (L, M, H, E) at batch N, 4-byte elements, each
input read once and each output written once: q (L), k and v (M) read, o
(L) written (no log-sum-exp: the program needs no backward);
``4·N·L·M·H·E`` operations. The least time is the larger of the bytes
over the card's HBM bandwidth and the operations over its TF32
tensor-core peak. Summed over the configuration's attention calls, for
every batch of every device call in the traced passes, over the device
seconds of the kernels named ``KERNELS``. In %.
"""

KERNELS = r"seist::.*\bfwd_kernel<|5seist.*10fwd_kernelI"


def work(n, length, m, heads, e):
    """(operations, bytes) of one call."""
    ops = 4 * n * length * m * heads * e
    nbytes = 4 * n * heads * e * (2 * length + 2 * m)
    return ops, nbytes


def read(run):
    t = run.get("trace")
    calls = run["config"].get("attention_calls") or []
    if run.get("lane") != "repick" or t is None or not calls:
        return None
    secs, launches = t.kernel_seconds(KERNELS)
    if launches == 0:
        return None
    peak, bw = run["peaks"]["flops"]["tf32_tensor"], run["peaks"]["hbm_bytes_per_s"]
    batches = run["trace_calls"] * run["batches_per_call"]
    least = sum(max(o / peak, b / bw) for o, b in
                (work(run["batch"], *c) for c in calls)) * batches
    return 100.0 * least / secs
