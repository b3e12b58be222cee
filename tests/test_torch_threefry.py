"""The port's threefry draws (``seist_tpu_torch/ops/threefry.py``) against
``jax.random`` on the CPU, under the JAX release's
``jax_threefry_partitionable`` layout.

Keys and uniforms bit for bit; normals within 1e-6 absolute (XLA's and
torch's ``log1p`` may round differently: about 1% of draws differ, by at
most 4.8e-7), with the exact share printed."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (caps torch's threads first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seist_tpu.data import device_aug as jda

from seist_tpu_torch.ops import threefry as tf

CASES = [(0, 0, 0), (1234, 3, 77), (7, 1, 2**31 - 1), (2**31 - 1, 5, 12345), (42, 199, 2**31 - 2)]


def test_partitionable_layout_is_the_one_reproduced():
    assert jax.config.jax_threefry_partitionable


def _jkey(seed, epoch, idx):
    return jda.sample_key(seed, jnp.int32(epoch), jnp.int32(idx))


def _tkey(seed, epoch, idx):
    return tf.sample_keys(seed, torch.tensor(epoch, dtype=torch.int32),
                          torch.tensor([idx], dtype=torch.int32))


@pytest.mark.parametrize("seed,epoch,idx", CASES)
def test_keys_bit_exact(seed, epoch, idx):
    want = np.asarray(jax.random.key_data(_jkey(seed, epoch, idx))).astype(np.int64)
    np.testing.assert_array_equal(_tkey(seed, epoch, idx)[0].numpy(), want)
    for tag in (1, 18, 23):
        sub = np.asarray(jax.random.key_data(jax.random.fold_in(_jkey(seed, epoch, idx), tag)))
        np.testing.assert_array_equal(tf.fold_in(_tkey(seed, epoch, idx), tag)[0].numpy(),
                                      sub.astype(np.int64))


@pytest.mark.parametrize("seed,epoch,idx", CASES)
@pytest.mark.parametrize("n", [1, 2, 3, 1000])
def test_uniforms_bit_exact(seed, epoch, idx, n):
    key = jax.random.fold_in(_jkey(seed, epoch, idx), 17)
    want = np.asarray(jax.random.uniform(key, () if n == 1 else (n,), jnp.float32)).reshape(-1)
    got = tf.uniform(tf.fold_in(_tkey(seed, epoch, idx), 17), n)[0].numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,epoch,idx", CASES[:3])
def test_normal_field_within_1e6(seed, epoch, idx):
    """A (3, 12000) field, the raw trace of the synthetic dataset."""
    key = jax.random.fold_in(_jkey(seed, epoch, idx), 18)
    want = np.asarray(jax.random.normal(key, (3, 12000), jnp.float32)).reshape(-1)
    got = tf.normal(tf.fold_in(_tkey(seed, epoch, idx), 18), 36000)[0].numpy()
    d = np.abs(got - want)
    worst = np.argsort(-d)[:5]
    report = (f"normals: {float((d == 0).mean()):.4f} of {d.size} exact, max abs "
              f"{float(d.max()):.3g}; largest at {worst.tolist()}: port "
              f"{got[worst].tolist()}, XLA {want[worst].tolist()}")
    print(report)
    assert d.max() <= 1e-6, report
    assert (d == 0).mean() >= 0.95, report


def test_erfinv_edges_and_torch_difference():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999, 0.999], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = tf.erfinv_xla(x).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=1e-6)


def test_aug_draws_plain_layout():
    """Slot s of :func:`aug_draws` is element pos of its tag's uniform
    draw; field f the normal draw of its tag, per sample."""
    seed, epoch = 3, 9
    idx = np.array([0, 11, 2**31 - 1], np.int32)
    slots = [(1, 0), (3, 0), (3, 1), (11, 1), (23, 0)]
    out = (torch.empty(3, len(slots)), torch.empty(3, 2, 50))
    u, f = tf.aug_draws(seed, torch.tensor(epoch, dtype=torch.int32), torch.from_numpy(idx),
                        slots, [2, 18], 50, out=out)
    assert u is out[0] and f is out[1]
    for b, i in enumerate(idx):
        key = _jkey(seed, epoch, int(i))
        for s, (tag, pos) in enumerate(slots):
            want = np.asarray(jax.random.uniform(jax.random.fold_in(key, tag), (pos + 1,)))[pos]
            assert u[b, s].item() == want
        for j, tag in enumerate((2, 18)):
            want = np.asarray(jax.random.normal(jax.random.fold_in(key, tag), (50,)))
            np.testing.assert_allclose(f[b, j].numpy(), want, rtol=0, atol=1e-6)
    assert tf.launches == 0  # the CPU path launches no kernel
