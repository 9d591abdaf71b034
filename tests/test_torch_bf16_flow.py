"""The port's flow kernels' plain versions at bfloat16 against the JAX
package's Pallas kernels at ``dt = bfloat16`` in interpret mode, from the
same f32 weights and inputs (``glow_tts_tpu_torch/ops/coupling.py``,
``ops/coupling_grad.py``): the flow step (#3) forward and reverse, the
coupling alone (#2's function), and the train-direction flow stack
(#5 and #6): ``z``, the logdet and every gradient, with and without the
conditioning rows and the pitch operand, at dropout rate 0 and 0.3 (the
hash masks are bit-equal on both sides).

Tolerance, as ``tests/torch_port_helpers.py`` states it once: max|port −
jax_bf16| ≤ 2·max|jax_bf16 − jax_f32| + 1e-6 on every result, and the
gradients leaf by leaf within 3e-2 norm-relative of JAX's f32 ones and at
most twice as far from JAX's bf16 ones as those are from the f32 ones,
plus 1e-4.  The port's plain versions round where the TPU kernels cast, so
in practice they land on JAX's bf16 result to a few f32 ulps; JAX's f32
result is the Pallas kernel at f32 (interpret mode: exact f32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops import coupling_grad as JCG
from glow_tts_tpu.ops.coupling import fused_coupling, fused_flow_step
from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.ops import coupling_grad as TCG
from tests.test_torch_coupling import _weights as step_weights
from tests.test_torch_coupling_grad import _problem
from tests.torch_port_helpers import (assert_bf16_close, assert_bf16_grads,
                                      ragged, t)

BF = jnp.bfloat16


def _jnp(value):
    if isinstance(value, dict):
        return {key: jnp.asarray(v) for key, v in value.items()}
    return None if value is None else jnp.asarray(value)


def _step_problem(seed, lengths, pitch):
    rng = np.random.default_rng(seed)
    c, n, k, ch = 16, 2, 5, 16
    x, mask = ragged(rng, len(lengths), max(lengths), c, lengths)
    w = step_weights(rng, c, n, k, ch, pitch_size=2 if pitch else 0)
    cond = (rng.standard_normal((n, len(lengths), 2 * ch)) * .2
            ).astype(np.float32)
    p = ((rng.standard_normal((len(lengths), max(lengths), 2)) * mask
          ).astype(np.float32) if pitch else None)
    return x, mask, w, cond, p


@pytest.mark.parametrize('pitch', [False, True])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('lengths', [[9, 6, 3], [13, 1, 5, 12]])
def test_plain_bf16_flow_step_matches_pallas(lengths, reverse, pitch):
    x, mask, w, cond, p = _step_problem(len(lengths) + 7, lengths, pitch)
    refs = {}
    for dtype in (jnp.float32, BF):
        z, ld = fused_flow_step(jnp.asarray(x, dtype), jnp.asarray(mask),
                                _jnp(w), jnp.asarray(cond), _jnp(p),
                                reverse=reverse, interpret=True)
        refs[dtype] = (np.asarray(z, np.float32),
                       None if ld is None else np.asarray(ld))
    z, ld = tc.flow_step(t(x).to(torch.bfloat16), t(mask),
                         {key: t(v) for key, v in w.items()}, t(cond),
                         reverse=reverse, pitch=None if p is None else t(p))
    assert z.dtype == torch.bfloat16 and refs[BF][0].dtype == np.float32
    assert_bf16_close(z, refs[BF][0], refs[jnp.float32][0], 'z')
    if reverse:
        assert ld is None
    else:
        assert ld.dtype == torch.float32
        assert_bf16_close(ld, refs[BF][1], refs[jnp.float32][1], 'logdet')


@pytest.mark.parametrize('reverse', [False, True])
def test_plain_bf16_coupling_matches_pallas(reverse):
    x, mask, w, cond, p = _step_problem(31, [11, 7, 4], True)
    c2 = x.shape[-1] // 2
    own = {key: v for key, v in w.items()
           if key not in ('an_logs', 'an_bias', 'mix_t', 'ld_const')}
    refs = {}
    for dtype in (jnp.float32, BF):
        xj = jnp.asarray(x, dtype)
        z, ld = fused_coupling(xj[..., :c2], xj[..., c2:], jnp.asarray(mask),
                               _jnp(own), jnp.asarray(cond), pitch=_jnp(p),
                               reverse=reverse, interpret=True)
        refs[dtype] = (np.asarray(z, np.float32),
                       None if ld is None else np.asarray(ld))
    xt = t(x).to(torch.bfloat16)
    z, ld = tc.coupling(xt[..., :c2], xt[..., c2:], t(mask),
                        {key: t(v) for key, v in own.items()}, t(cond),
                        pitch=t(p), reverse=reverse)
    assert z.dtype == torch.bfloat16
    assert_bf16_close(z, refs[BF][0], refs[jnp.float32][0], 'z_b')
    if not reverse:
        assert_bf16_close(ld, refs[BF][1], refs[jnp.float32][1], 'logdet')


def _stack_refs(x, mask, weights, cond, pitch, zt, ld_weight, rate, seed):
    """JAX's train-direction kernel pair at f32 and bf16: (z, logdet) and the
    gradients of a loss of z and the logdet by weights, x, cond, pitch."""
    out = {}
    for dtype in (jnp.float32, BF):
        def loss(w_, x_, c_, p_, dtype=dtype):
            z, ld = JCG.fused_flow_stack_train(
                x_.astype(dtype), jnp.asarray(mask), w_, c_, p_,
                seed=jnp.int32(seed), dropout_rate=rate, interpret=True)
            z = z.astype(jnp.float32)
            return jnp.sum(z * zt) + 0.7 * jnp.sum(ld * ld_weight), (z, ld)

        (_, (z, ld)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(
            _jnp(weights), _jnp(x), _jnp(cond), _jnp(pitch))
        out[dtype] = (np.asarray(z), np.asarray(ld), grads)
    return out


@pytest.mark.parametrize('rate', [0.0, 0.3])
@pytest.mark.parametrize('conditioning', ['none', 'cond', 'pitch'])
def test_plain_bf16_flow_stack_train_matches_pallas(rate, conditioning):
    seed = 4321
    x, mask, weights, cond, pitch, zt = _problem(5, [11, 7, 4], conditioning)
    ld_weight = np.arange(1., 4.).astype(np.float32)
    refs = _stack_refs(x, mask, weights, cond, pitch, zt, ld_weight, rate,
                       seed)

    def leaf(value):
        return None if value is None else t(value).requires_grad_()

    tw = {key: leaf(v) for key, v in weights.items()}
    tx, tcond, tpitch = leaf(x), leaf(cond), leaf(pitch)
    z, ld = TCG.flow_stack_train(tx.to(torch.bfloat16), t(mask), tw, tcond,
                                 tpitch, seed=seed, dropout_rate=rate)
    assert z.dtype == torch.bfloat16 and ld.dtype == torch.float32
    (torch.sum(z.float() * t(zt))
     + 0.7 * torch.sum(ld * t(ld_weight))).backward()
    (z16, ld16, g16), (z32, ld32, g32) = refs[BF], refs[jnp.float32]
    assert_bf16_close(z, z16, z32, 'z')
    assert_bf16_close(ld, ld16, ld32, 'logdet')
    got = {key: tw[key].grad for key in weights}
    got['x'] = tx.grad
    ref16, ref32 = dict(g16[0]), dict(g32[0])
    ref16['x'], ref32['x'] = g16[1], g32[1]
    for name, mine, i in (('cond', tcond, 2), ('pitch', tpitch, 3)):
        if mine is not None:
            got[name], ref16[name], ref32[name] = mine.grad, g16[i], g32[i]
    assert all(value.dtype == torch.float32 for value in got.values())
    assert assert_bf16_grads(got, ref16, ref32) < 3e-2


@pytest.mark.parametrize('reverse', [False, True])
def test_f32_flow_step_is_unchanged_by_the_dtype_argument(reverse):
    """At float32 the plain version computes what it computed before the
    dtype existed: the rounding helpers return their argument."""
    x, mask, w, cond, p = _step_problem(3, [9, 6, 3], True)
    tw = {key: t(v) for key, v in w.items()}
    z, ld = tc.flow_step(t(x), t(mask), tw, t(cond), reverse=reverse,
                         pitch=t(p))
    z_ref, ld_ref = fused_flow_step(
        jnp.asarray(x), jnp.asarray(mask), _jnp(w), jnp.asarray(cond),
        jnp.asarray(p), reverse=reverse, interpret=True)
    assert z.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=3e-5,
                               atol=3e-6)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_saved_bytes_count_the_stores_of_the_compute_dtype(dtype):
    """A bf16 forward stores bf16 (the TPU kernel keeps its checkpoint in
    ``dt``): half the bytes a frame, so the stored route holds up to twice
    the frames of the f32 one; the buffers are what is counted."""
    for steps in (None, 3):
        buffers = TCG._saved_buffers(24, 16, 16, 2, 'cpu', steps, dtype)
        assert all(v.dtype == dtype for v in buffers.values())
        assert sum(v.numel() * v.element_size() for v in buffers.values()) \
            == (steps or 1) * TCG.saved_bytes_per_step(24, 16, 16, 2, dtype)
    f32 = TCG.saved_bytes_per_step(16384, 160, 192, 4)
    assert TCG.saved_bytes_per_step(16384, 160, 192, 4, dtype) \
        == f32 // (1 if dtype == torch.float32 else 2)
    per_frame = TCG.saved_bytes_per_step(1, 160, 192, 4)
    frames = TCG.STORE_BUDGET_BYTES // (12 * per_frame) + 1  # past f32's
    assert not TCG.stores_activations(12, frames, 160, 192, 4)
    assert TCG.stores_activations(12, frames, 160, 192, 4, dtype) == (
        dtype == torch.bfloat16)
