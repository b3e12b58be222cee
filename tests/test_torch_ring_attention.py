"""The port's ring attention (``seist_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``ring_attention`` on the conftest's 8-device
CPU mesh.

Four gloo ranks start once for the module (``tests/_torch_dist_worker.py``,
the port's env contract): a seq-4 mesh and a data-2 x seq-2 mesh, every
case in that one start. Each case's q, k, v come from numpy with a seed;
the JAX package runs the same arrays through its ring over ``S`` devices
(``make_mesh(data=1, seq=S)``, or ``data=2, seq=2`` with ``batch_axis``).

Limits, those of ``tests/test_ring_attention.py``: outputs 2e-5 (rtol and
atol); extreme logits and every gradient 1e-4. The block dropout mask is
compared bit for bit, also where the global counters wrap past 2^32.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seist_tpu.ops import ring_attention as jra
from seist_tpu.parallel.mesh import make_mesh

from seist_tpu_torch.ops import ring_attention as tra

from _torch_dist_worker import Launch

TOL, LOOSE = 2e-5, 1e-4
LAUNCH_TIMEOUT_S = 240.0


def _qkv(rng, n=2, l=64, m=None, h=2, e=8):
    m = l if m is None else m
    return (rng.normal(size=(n, l, h, e)).astype(np.float32),
            rng.normal(size=(n, m, h, e)).astype(np.float32),
            rng.normal(size=(n, m, h, e)).astype(np.float32))


def _inputs():
    rng = np.random.default_rng(17)
    q, k, v = _qkv(rng)
    ext = (q * 30.0, k, v)
    return {
        "plain": _qkv(rng),
        "pooled": _qkv(rng, l=128, m=16),
        "extreme": ext,
        "dropout": _qkv(rng),
        "dropout_pooled": _qkv(rng, l=128, m=16),
        "batch": _qkv(rng, n=4),
        "dropout_batch": _qkv(rng, n=4),
        "grads": _qkv(rng, l=32),
        "dropout_grads": _qkv(rng, l=32),
    }


#: (name, S, extra) per case; ``batch_axis`` cases shard the batch over
#: the data axis of the data-2 x seq-2 mesh.
CASES = [(name, s, extra) for s in (2, 4) for name, extra in (
    ("plain", {}),
    ("pooled", {}),
    ("extreme", {}),
    ("dropout", {"rate": 0.3, "seed": 1234}),
    ("dropout_pooled", {"rate": 0.25, "seed": 7}),
    ("grads", {"grad": "sum"}),
    ("dropout_grads", {"rate": 0.3, "seed": 1234, "grad": "square"}),
)] + [("batch", 2, {"batch_axis": True}),
      ("dropout_batch", 2, {"batch_axis": True, "rate": 0.3, "seed": 3})]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    arrays = _inputs()
    np.savez(out / "inputs.npz", **{f"{n}_{t}": a for n, qkv in arrays.items()
                                    for t, a in zip("qkv", qkv)})
    spec = {"out": str(out), "inputs": str(out / "inputs.npz"),
            "cases": [dict(extra, name=n, seq=s) for n, s, extra in CASES]}
    launch = Launch("ring", spec, 4, LAUNCH_TIMEOUT_S)
    launch.wait()
    return arrays, [torch.load(out / f"ring_rank{r}.pt") for r in range(4)]


def _mesh(s, batch_axis):
    if batch_axis:
        return make_mesh(data=2, model=1, seq=2, devices=jax.devices()[:4]), "data"
    return make_mesh(data=1, model=1, seq=s, devices=jax.devices()[:s]), None


def _jax_case(qkv, mesh, axis, extra):
    """JAX's output, and its gradients where the case asks."""
    seed = jnp.asarray([extra["seed"]], jnp.int32) if "seed" in extra else None

    def run(q, k, v):
        return jra.ring_attention(q, k, v, mesh, batch_axis=axis,
                                  dropout_rate=extra.get("rate", 0.0), dropout_seed=seed)

    out = run(*qkv)
    if not extra.get("grad"):
        return out, None

    def loss(q, k, v):
        o = run(q, k, v)
        return (o ** 2).sum() if extra["grad"] == "square" else o.sum()

    return out, jax.grad(loss, argnums=(0, 1, 2))(*qkv)


@pytest.fixture(scope="module")
def jax_side(ranks):
    """Every case's JAX result, one jitted program per mesh (compiling
    each case alone costs seconds apiece)."""
    arrays = ranks[0]
    groups = {}
    for name, s, extra in CASES:
        groups.setdefault((s, bool(extra.get("batch_axis"))), []).append((name, extra))
    want = {}
    for (s, batch_axis), cases in groups.items():
        mesh, axis = _mesh(s, batch_axis)

        def all_cases(arrs, cases=cases, mesh=mesh, axis=axis):
            return {name: _jax_case(arrs[name], mesh, axis, extra) for name, extra in cases}

        got = jax.jit(all_cases)({name: arrays[name] for name, _ in cases})
        for name, (out, grads) in got.items():
            want[(name, s)] = (np.asarray(out),
                               None if grads is None else [np.asarray(g) for g in grads])
    return want


@pytest.mark.parametrize("name,s,extra", CASES, ids=[f"{n}-s{s}" for n, s, _ in CASES])
def test_ring_matches_jax(ranks, jax_side, name, s, extra):
    results = ranks[1]
    want, want_grads = jax_side[(name, s)]
    if extra.get("batch_axis"):  # data rank 0 holds ranks 0-1, data rank 1 ranks 2-3
        got = np.concatenate([results[0][f"{name}_s{s}"]["out"].numpy(),
                              results[2][f"{name}_s{s}"]["out"].numpy()])
    else:
        got = results[0][f"{name}_s{s}"]["out"].numpy()
        for r in range(1, 4 if s == 4 else 2):  # every rank of the seq group holds the output
            np.testing.assert_array_equal(results[r][f"{name}_s{s}"]["out"].numpy(), got)
    tol = LOOSE if name == "extreme" else TOL
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if want_grads is not None:
        for t, g, w in zip("qkv", results[0][f"{name}_s{s}"]["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), w, rtol=LOOSE, atol=LOOSE, err_msg=f"d{t}")


def test_ring_refuses_what_jax_refuses(ranks):
    errors = ranks[1][0]["errors"]
    assert "not divisible" in errors["indivisible"]
    assert "dropout_seed" in errors["no_seed"]


@pytest.mark.parametrize("n0,row0,col0,l_total,m_total", [
    (0, 0, 0, 64, 16),
    (62, 512, 64, 1024, 128),               # seist_l_dpk's first stage, b64, seq 2
    (3, 1 << 15, 1 << 12, 1 << 16, 1 << 13),  # counters past 2^31 and 2^32: they wrap
])
def test_block_dropout_mask_is_jax_s_bit_for_bit(n0, row0, col0, l_total, m_total):
    n, h, lq, mk, rate, seed = 2, 3, 16, 8, 0.3, 987654321
    want = np.asarray(jra._block_dropout_mult(jnp.int32(seed), rate, n, h, lq, mk, n0, row0,
                                              col0, l_total, m_total))
    got = tra._block_dropout_mult(seed, rate, n, h, lq, mk, n0, row0, col0, l_total, m_total,
                                  "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    seed_t = torch.tensor(seed, dtype=torch.int32)  # the kernels' seed tensor
    np.testing.assert_array_equal(
        tra._block_dropout_mult(seed_t, rate, n, h, lq, mk, n0, row0, col0, l_total, m_total,
                                "cpu").numpy(), want)


def test_one_rank_ring_is_dense_attention():
    """Without a group the ring is one block: the dense path's math."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, l=32, m=8))
    got = tra.ring_attention(q, k, v, None, dropout_rate=0.3, dropout_seed=11)
    want = tra.dense_attention(q, k, v, dropout_rate=0.3, dropout_seed=11)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
