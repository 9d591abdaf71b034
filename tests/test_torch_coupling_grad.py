"""The train-direction flow stack of the port on the CPU
(``glow_tts_tpu_torch/ops/coupling_grad.py``; a CPU tensor takes the plain
version, differentiated by autograd) against the JAX package's
``flow_stack_train_reference`` and against its Pallas kernel pair
``fused_flow_stack_train(..., interpret=True)``: ``z``, ``logdet``, ``dx``,
every weight gradient and ``dcond``, at dropout rate 0 and 0.3 (the masks
are bit-equal, so dropout adds no tolerance), with and without ``cond``,
ragged masks.

Tolerances are those of ``tests/test_coupling_train.py`` (both sides f32,
sums in another order): z rtol/atol 2e-5, logdet rtol 2e-5 / atol 2e-4,
gradients rtol/atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops import coupling_grad as JCG
from glow_tts_tpu_torch.ops import coupling_grad as TCG
from tests.torch_port_helpers import ragged, t

Z_TOL = dict(rtol=2e-5, atol=2e-5)
LD_TOL = dict(rtol=2e-5, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
S, N, K, CH, C = 3, 2, 5, 16, 16
SEED = 1234


def _weights(rng, pitch_size=None):
    c2, ch2 = C // 2, 2 * CH
    shapes = [
        ('w_start', (S, c2, CH), .3), ('b_start', (S, CH), .1),
        ('w_in', (S, N, K, CH, ch2), .2), ('w_rs', (S, N, CH, ch2), .2),
        ('b_rs', (S, N, ch2), .1), ('w_end', (S, CH, C), .2),
        ('b_end', (S, C), .1), ('b_in', (S, N, ch2), .1),
        ('an_logs', (S, C), .1), ('an_bias', (S, C), .1),
        ('mix_t', (S, C, C), .2), ('ld_const', (S,), .1)]
    if pitch_size:
        shapes.append(('w_pitch', (S, N, pitch_size, ch2), .2))
    return {key: (rng.standard_normal(shape) * scale).astype(np.float32)
            for key, shape, scale in shapes}


def _problem(seed, lengths, conditioning):
    rng = np.random.default_rng(seed)
    b, frames = len(lengths), max(lengths)
    x, mask = ragged(rng, b, frames, C, lengths)
    weights = _weights(rng, 2 if conditioning == 'pitch' else None)
    cond = ((rng.standard_normal((S, N, b, 2 * CH)) * .2).astype(np.float32)
            if conditioning == 'cond' else None)
    pitch = ((rng.standard_normal((b, frames, 2)).astype(np.float32)) * mask
             if conditioning == 'pitch' else None)
    z_weight = rng.standard_normal((b, frames, C)).astype(np.float32)
    return x, mask, weights, cond, pitch, z_weight


def _jnp(value):
    if isinstance(value, dict):
        return {key: jnp.asarray(v) for key, v in value.items()}
    return None if value is None else jnp.asarray(value)


def _leaf(value):
    return None if value is None else t(value).requires_grad_()


@pytest.mark.parametrize('rate', [0.0, 0.3])
@pytest.mark.parametrize('conditioning', ['none', 'cond', 'pitch'])
@pytest.mark.parametrize('oracle', ['twin', 'pallas'])
def test_forward_matches_jax(rate, conditioning, oracle):
    x, mask, weights, cond, pitch, _ = _problem(0, [13, 12, 8, 5, 2],
                                                conditioning)
    fn = (JCG.flow_stack_train_reference if oracle == 'twin' else
          lambda *a, **kw: JCG.fused_flow_stack_train(*a, interpret=True,
                                                      **kw))
    z_ref, ld_ref = fn(_jnp(x), _jnp(mask), _jnp(weights), _jnp(cond),
                       _jnp(pitch), seed=jnp.int32(SEED), dropout_rate=rate)
    z, ld = TCG.flow_stack_train(
        t(x), t(mask), {key: t(v) for key, v in weights.items()},
        None if cond is None else t(cond),
        None if pitch is None else t(pitch), seed=SEED, dropout_rate=rate)
    assert z.dtype == ld.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)
    assert (z.numpy()[np.broadcast_to(mask, z.shape) == 0] == 0).all()


@pytest.mark.parametrize('rate', [0.0, 0.3])
@pytest.mark.parametrize('conditioning', ['none', 'cond', 'pitch'])
@pytest.mark.parametrize('oracle', ['twin', 'pallas'])
def test_gradients_match_jax(rate, conditioning, oracle):
    """A loss that touches z and the logdet (a weight per sample, so that
    ``dld`` differs between samples)."""
    seed = -77                                  # a negative int32 seed
    x, mask, weights, cond, pitch, zt = _problem(1, [11, 7, 4], conditioning)
    ld_weight = np.arange(1., 4.).astype(np.float32)
    fn = (JCG.flow_stack_train_reference if oracle == 'twin' else
          lambda *a, **kw: JCG.fused_flow_stack_train(*a, interpret=True,
                                                      **kw))

    def jax_loss(w_, x_, c_, p_):
        z, ld = fn(x_, _jnp(mask), w_, c_, p_, seed=jnp.int32(seed),
                   dropout_rate=rate)
        return jnp.sum(z * zt) + 0.7 * jnp.sum(ld * ld_weight)

    argnums = [0, 1] + ([2] if cond is not None else []) \
        + ([3] if pitch is not None else [])
    ref = dict(zip(argnums, jax.grad(jax_loss, argnums=argnums)(
        _jnp(weights), _jnp(x), _jnp(cond), _jnp(pitch))))

    tw = {key: _leaf(v) for key, v in weights.items()}
    tx, tcond, tpitch = _leaf(x), _leaf(cond), _leaf(pitch)
    z, ld = TCG.flow_stack_train(tx, t(mask), tw, tcond, tpitch, seed=seed,
                                 dropout_rate=rate)
    (torch.sum(z * t(zt)) + 0.7 * torch.sum(ld * t(ld_weight))).backward()

    for key in weights:
        np.testing.assert_allclose(tw[key].grad.numpy(),
                                   np.asarray(ref[0][key]), **GRAD_TOL,
                                   err_msg=f'weight grad {key}')
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[1]),
                               **GRAD_TOL, err_msg='dx')
    if cond is not None:
        np.testing.assert_allclose(tcond.grad.numpy(), np.asarray(ref[2]),
                                   **GRAD_TOL, err_msg='dcond')
    if pitch is not None:
        np.testing.assert_allclose(tpitch.grad.numpy(), np.asarray(ref[3]),
                                   **GRAD_TOL, err_msg='dpitch')


def test_dropout_changes_the_output_and_is_a_function_of_the_seed():
    x, mask, weights, _, _, _ = _problem(2, [9, 6], 'none')
    tw = {key: t(v) for key, v in weights.items()}

    def run(seed, rate=0.3):
        return TCG.flow_stack_train(t(x), t(mask), tw, seed=seed,
                                    dropout_rate=rate)[0]

    assert torch.equal(run(5), run(5))
    assert (run(5) - run(6)).abs().max() > 1e-4
    assert (run(5) - run(5, 0.0)).abs().max() > 1e-4


def test_wrapper_refuses_a_rate_outside_the_unit_interval():
    x, mask, weights, _, _, _ = _problem(3, [4], 'none')
    tw = {key: t(v) for key, v in weights.items()}
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match='dropout_rate'):
            TCG.flow_stack_train(t(x), t(mask), tw, seed=0,
                                 dropout_rate=rate)
