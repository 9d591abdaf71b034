"""The port's counter-hash dropout masks (``glow_tts_tpu_torch/ops/
dropmask.py``, int64 arithmetic cut to 32 bits) against the JAX package's
(``glow_tts_tpu/ops/dropmask.py``, uint32): equal bit for bit, so every
comparison here is exact, over seeds (negative ones included, read as
uint32), flow steps, layers, row offsets and rates; and the threshold's
clamp at rates within 2⁻³² of 0 and 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops import dropmask as jdrop
from glow_tts_tpu_torch.ops import dropmask as tdrop


@pytest.mark.parametrize('seed', [0, 1, 1234, 2 ** 31 - 1, -1, -77,
                                  -2 ** 31])
def test_hash_and_salt_equal_jax(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    values = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    ref = np.asarray(jdrop.hash_u32(jnp.asarray(values.astype(np.uint32))))
    got = tdrop.hash_u32(torch.from_numpy(values.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    for step, layer, n in [(0, 0, 4), (11, 3, 4), (5, 1, 2), (1000, 7, 8)]:
        ref = int(jdrop.layer_salt(jnp.int32(seed), step, layer, n))
        assert tdrop.layer_salt(seed, step, layer, n) == ref


@pytest.mark.parametrize('rate', [0.05, 0.3, 0.5, 0.97])
@pytest.mark.parametrize('seed,step,layer,row0', [
    (0, 0, 0, 0), (1234, 3, 1, 517), (-5, 11, 3, 2 ** 20 + 3),
    (77, 2, 0, 16 * 1028 - 7)])
def test_keep_scale_equals_jax(rate, seed, step, layer, row0):
    shape, cols_dim = (37, 24), 32
    salt_ref = jdrop.layer_salt(jnp.int32(seed), step, layer, 4)
    ref = np.asarray(jdrop.keep_scale(salt_ref, row0, shape, cols_dim, rate))
    got = tdrop.keep_scale(tdrop.layer_salt(seed, step, layer, 4), row0,
                           shape, cols_dim, rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref == 0).sum() < ref.size


def test_stack_mask_is_keep_scale_per_sample():
    """Sample b, frame τ is the global row b·(T + k − 1) + τ."""
    seed, step, layer, n = 9, 4, 1, 4
    b, t, k, cols, rate = 3, 13, 5, 32, 0.3
    got = tdrop.stack_mask(seed, step, layer, n, b, t, k, cols, rate)
    assert got.shape == (b, t, cols)
    salt = jdrop.layer_salt(jnp.int32(seed), step, layer, n)
    for sample in range(b):
        ref = jdrop.keep_scale(salt, sample * (t + k - 1), (t, cols), cols,
                               rate)
        np.testing.assert_array_equal(got[sample].numpy(), np.asarray(ref))


def test_mask_statistics():
    rate = 0.3
    mask = tdrop.keep_scale(tdrop.layer_salt(9, 4, 1, 4), 0, (512, 384), 384,
                            rate).numpy()
    assert abs((mask == 0).mean() - rate) < 5e-3
    np.testing.assert_allclose(mask.mean(), 1.0, rtol=5e-3)
    np.testing.assert_array_equal(np.unique(mask),
                                  [0, np.float32(1 / (1 - rate))])


@pytest.mark.parametrize('rate', [0.05, 0.3, 0.5, 0.999])
def test_threshold_and_scale_equal_jax(rate):
    assert tdrop.keep_threshold(rate) == int(jdrop.keep_threshold(rate))
    assert tdrop.keep_scale_value(rate) == float(
        np.asarray(1.0 / (1.0 - rate), np.float32))


def test_threshold_is_clamped_to_uint32():
    assert tdrop.keep_threshold(0.0) == 2 ** 32 - 1
    assert tdrop.keep_threshold(1.0 - 2.0 ** -40) == 0
    assert tdrop.keep_threshold(1.0) == 0
    for rate in (0.0, 1e-12, 0.5, 1.0 - 1e-12, 1.0):
        assert 0 <= tdrop.keep_threshold(rate) <= 2 ** 32 - 1
