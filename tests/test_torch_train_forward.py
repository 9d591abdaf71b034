"""The port's train forward (``GlowTTS.forward``: encoder prior, forward
flow with its logdet, prior log-likelihood, MAS, aligned statistics)
against the JAX model's ``apply(..., deterministic=True)`` on the same
parameters and batch, at ``tiny_config`` size on the CPU.

Tolerances (both sides f32; sums run in another order): ``log_p`` 1e-5
abs on values of order 10; z, mel_mean, mel_log_std and log_durations
rtol 3e-5 / atol 3e-6 as the decoder tests; the summed logdet rtol 3e-5 /
atol 1e-4.  Attentions and the durations they sum to are compared for
equality of the path: every seed below gives the same path on both sides (a seed whose
``log_p`` held a near-tie below the ``log_p`` tolerance could differ in
whole frames and would be replaced, not tolerated); the log of the equal
durations to rtol 1e-6 / atol 2e-7, one bit of the two ``log``s.  MAS fed the JAX
model's own ``log_p`` must equal its attentions whatever the seed."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.models import glow_tts as jglow
from glow_tts_tpu.ops.mas import maximum_path_scan
from glow_tts_tpu_torch.models import glow_tts as tglow
from glow_tts_tpu_torch.ops.mas import maximum_path
from tests.torch_port_helpers import jax_model, port_model, t

Z_TOL = dict(rtol=3e-5, atol=3e-6)
LD_TOL = dict(rtol=3e-5, atol=1e-4)
LOG_P_ATOL = 1e-5
SEEDS = [0, 1, 2]


@pytest.fixture(scope='module', params=SEEDS)
def both(request):
    cfg, model, params, batch = jax_model(seed=request.param)
    ref = model.apply({'params': params}, deterministic=True, **{
        key: jnp.asarray(batch[key])
        for key in ('tokens', 'token_lengths', 'mels', 'mel_lengths')})
    port = port_model(cfg, params)
    with torch.no_grad():
        got = port(t(batch['tokens']), t(batch['token_lengths']),
                   t(batch['mels']), t(batch['mel_lengths']))
    return types.SimpleNamespace(batch=batch, ref=ref, got=got, port=port,
                                 model=model, params=params)


@pytest.mark.parametrize('seed', [0, 1])
def test_prior_log_likelihood_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, t_tok, t_mel, m = 3, 7, 11, 8
    mean = rng.standard_normal((b, t_tok, m)).astype(np.float32)
    log_std = (0.3 * rng.standard_normal((b, t_tok, m))).astype(np.float32)
    z = rng.standard_normal((b, t_mel, m)).astype(np.float32)
    mask = (rng.random((b, t_tok, t_mel)) < 0.8).astype(np.float32)
    ref = jglow.prior_log_likelihood(*(jnp.asarray(a) for a in
                                       (mean, log_std, z, mask)))
    got = tglow.prior_log_likelihood(t(mean), t(log_std), t(z), t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=LOG_P_ATOL)
    assert (got.numpy()[mask == 0] == 0).all()


def test_forward_returns_the_jax_keys(both):
    ref, got = both.ref, both.got
    live = {key for key, value in ref.items() if value is not None}
    assert set(got) == live


@pytest.mark.parametrize('key', ['z', 'mel_mean', 'mel_log_std',
                                 'log_durations'])
def test_forward_values_match_jax(both, key):
    ref, got = both.ref, both.got
    assert got[key].shape == ref[key].shape
    np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                               **Z_TOL)


def test_forward_logdet_and_mask_match_jax(both):
    ref, got = both.ref, both.got
    np.testing.assert_allclose(got['log_dets'].numpy(),
                               np.asarray(ref['log_dets']), **LD_TOL)
    np.testing.assert_array_equal(got['mel_mask'].numpy(),
                                  np.asarray(ref['mel_mask']))


def test_forward_attentions_equal_jax(both):
    batch, ref, got = both.batch, both.ref, both.got
    np.testing.assert_array_equal(got['attentions'].numpy(),
                                  np.asarray(ref['attentions']))
    # equal durations; the two log implementations differ in the last bit
    np.testing.assert_allclose(got['log_duration_targets'].numpy(),
                               np.asarray(ref['log_duration_targets']),
                               rtol=1e-6, atol=2e-7)
    frames = got['attentions'].sum(dim=(1, 2)).numpy()
    np.testing.assert_array_equal(frames, batch['mel_lengths'])


def test_mas_on_jax_log_p_equals_jax_attentions(both):
    batch, ref, model, params = both.batch, both.ref, both.model, both.params
    token_mask = (np.arange(batch['tokens'].shape[1])[None, :, None]
                  < batch['token_lengths'][:, None, None]).astype(np.float32)
    # the JAX model's own log_p: its encoder's statistics and its z
    mean, log_std, _ = model.apply(
        {'params': params}, jnp.asarray(batch['tokens']),
        jnp.asarray(token_mask), None, True,
        method=lambda m, *args: m.encoder(*args))
    attn_mask = token_mask * np.asarray(ref['mel_mask'])[:, None, :, 0]
    log_p = np.asarray(jglow.prior_log_likelihood(
        mean, log_std, ref['z'], jnp.asarray(attn_mask)))
    got = maximum_path(t(log_p), t(batch['token_lengths']),
                       t(batch['mel_lengths']))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref['attentions']))
    np.testing.assert_array_equal(got.numpy(), np.asarray(maximum_path_scan(
        jnp.asarray(log_p), jnp.asarray(batch['token_lengths']),
        jnp.asarray(batch['mel_lengths']))))


def test_forward_carries_gradients_to_the_encoder_on_cpu(both):
    """MAS runs on detached statistics; the aligned statistics still
    depend on the encoder's parameters."""
    batch, port = both.batch, both.port
    out = port(t(batch['tokens']), t(batch['token_lengths']),
               t(batch['mels']), t(batch['mel_lengths']))
    assert not out['attentions'].requires_grad
    assert out['mel_mean'].requires_grad and out['log_durations'].requires_grad
