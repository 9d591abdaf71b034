"""The port's losses, eval step, alignment metric and ActNorm
data-dependent initialisation against the JAX package's, on the CPU at
``tiny_config`` size.  Tolerances: losses and the metric 1e-5 relative
(f32 sums in another order); ActNorm ``logs``/``bias`` 1e-5 absolute."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.training import losses as jlosses
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.trainer import (attention_diagonality,
                                           attention_diagonality_device)
from glow_tts_tpu_torch.models.decoder import squeeze
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, initial_state_dict
from glow_tts_tpu_torch.models.layers import sequence_mask
from glow_tts_tpu_torch.training import losses as tlosses
from glow_tts_tpu_torch.training import step as tstep
from glow_tts_tpu_torch.weights import load_jax_params, load_state_dict
from tests.helpers import synthetic_batch, tiny_config
from tests.torch_port_helpers import jax_model, port_config, port_model, t

REL = 1e-5
DDI_ATOL = 1e-5


def _loss_inputs(seed, b=3, t_mel=12, m=8, t_tok=5):
    rng = np.random.default_rng(seed)
    arrays = {
        'z': rng.standard_normal((b, t_mel, m)),
        'mel_mean': rng.standard_normal((b, t_mel, m)),
        'mel_log_std': 0.3 * rng.standard_normal((b, t_mel, m)),
        'log_dets': 10 * rng.standard_normal(b),
        'log_durations': rng.standard_normal((b, t_tok, 1)),
        'log_duration_targets': rng.standard_normal((b, t_tok, 1)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    arrays['mel_lengths'] = np.array([12, 7, 4], np.int32)
    return arrays


@pytest.mark.parametrize('seed', [0, 1])
def test_mle_loss_matches_jax(seed):
    a = _loss_inputs(seed)
    keys = ('z', 'mel_mean', 'mel_log_std', 'log_dets', 'mel_lengths')
    ref = jlosses.mle_loss(*(jnp.asarray(a[k]) for k in keys), 2, 8)
    got = tlosses.mle_loss(*(t(a[k]) for k in keys), 2, 8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=REL)


@pytest.mark.parametrize('seed', [0, 1])
def test_duration_loss_matches_jax(seed):
    a = _loss_inputs(seed)
    keys = ('log_durations', 'log_duration_targets')
    ref = jlosses.duration_loss(*(jnp.asarray(a[k]) for k in keys))
    got = tlosses.duration_loss(*(t(a[k]) for k in keys))
    np.testing.assert_allclose(got.item(), float(ref), rtol=REL)


@pytest.fixture(scope='module', params=[0, 1])
def evaluated(request):
    cfg, model, params, batch = jax_model(seed=request.param)
    ref_losses, ref_out = jstep.make_eval_step(cfg, model)(
        types.SimpleNamespace(params=params),
        {key: jnp.asarray(value) for key, value in batch.items()})
    port = port_model(cfg, params)
    pcfg = port_config(cfg)
    tbatch = tstep.batch_to_device(batch, 'cpu')
    got_losses, got_out = tstep.make_eval_step(pcfg, port)(tbatch)
    return batch, tbatch, ref_losses, ref_out, got_losses, got_out


@pytest.mark.parametrize('key', ['mle', 'duration', 'total'])
def test_eval_step_losses_match_jax(evaluated, key):
    _, _, ref_losses, _, got_losses, _ = evaluated
    assert sorted(got_losses) == sorted(ref_losses)
    np.testing.assert_allclose(got_losses[key].item(),
                               float(ref_losses[key]), rtol=REL)


def test_eval_step_runs_without_gradients(evaluated):
    *_, got_losses, got_out = evaluated
    assert not got_losses['total'].requires_grad
    assert not got_out['z'].requires_grad


def test_attention_diagonality_matches_jax(evaluated):
    batch, tbatch, _, ref_out, _, got_out = evaluated
    got = tstep.attention_diagonality(
        got_out['attentions'], tbatch['token_lengths'],
        tbatch['mel_lengths'])
    ref = attention_diagonality_device(
        ref_out['attentions'], jnp.asarray(batch['token_lengths']),
        jnp.asarray(batch['mel_lengths']))
    np.testing.assert_allclose(got.item(), float(ref), rtol=REL)
    host = attention_diagonality(np.asarray(ref_out['attentions']),
                                 batch['token_lengths'],
                                 batch['mel_lengths'])
    np.testing.assert_allclose(got.item(), host, rtol=REL)


def test_attention_diagonality_skips_degenerate_samples():
    attn = torch.zeros(2, 3, 4)
    attn[0, 0, 0] = attn[0, 1, 1] = attn[0, 2, 2] = attn[0, 2, 3] = 1
    attn[1, 0, 0] = 1
    tl, ml = np.array([3, 1], np.int32), np.array([4, 1], np.int32)
    got = tstep.attention_diagonality(attn, t(tl), t(ml))
    ref = attention_diagonality_device(jnp.asarray(attn.numpy()),
                                       jnp.asarray(tl), jnp.asarray(ml))
    np.testing.assert_allclose(got.item(), float(ref), rtol=REL)


@pytest.mark.parametrize('seed', [0, 3])
def test_actnorm_data_dependent_init_matches_jax(seed):
    """``create_train_state`` initialises the JAX model on a batch; the
    port, given the same other parameters with its ActNorms at zero,
    must arrive at the same ``logs``/``bias`` in every step."""
    cfg = tiny_config()
    batch = synthetic_batch(cfg, rng=np.random.default_rng(seed), batch=4)
    _, state = jstep.create_train_state(cfg, jax.random.PRNGKey(seed), batch)
    params = jax.tree_util.tree_map(np.array, state.params)
    pcfg = port_config(cfg)
    port = load_jax_params(GlowTTS(pcfg), params, pcfg)
    flows = port.layer_Dict['Decoder'].layer_Dict['Flows']
    expected = [(s.layers[0].logs.detach().clone(),
                 s.layers[0].bias.detach().clone()) for s in flows]
    with torch.no_grad():
        for s in flows:
            s.layers[0].logs.zero_()
            s.layers[0].bias.zero_()
    port.prepare().data_dependent_init(t(batch['mels']),
                                       t(batch['mel_lengths']))
    assert any(logs.abs().max() > 0.05 for logs, _ in expected)
    for k, (s, (logs, bias)) in enumerate(zip(flows, expected)):
        np.testing.assert_allclose(s.layers[0].logs.detach().numpy(),
                                   logs.numpy(), rtol=0, atol=DDI_ATOL,
                                   err_msg=f'logs of step {k}')
        np.testing.assert_allclose(s.layers[0].bias.detach().numpy(),
                                   bias.numpy(), rtol=0, atol=DDI_ATOL,
                                   err_msg=f'bias of step {k}')
    # the packed kernel weights follow the new ActNorm
    for s in flows:
        assert torch.equal(s.weights(False)['an_logs'],
                           s.layers[0].logs.detach().reshape(-1))


def test_from_scratch_init_then_ddi_whitens_the_first_step():
    cfg = port_config(tiny_config())
    state = initial_state_dict(cfg, seed=1)
    assert all(value.abs().max() == 0 for key, value in state.items()
               if '.End.' in key or '.layers.0.' in key)
    port = load_state_dict(GlowTTS(cfg), state).prepare()
    batch = synthetic_batch(tiny_config(), rng=np.random.default_rng(2))
    mels, lengths = t(batch['mels']), t(batch['mel_lengths'])
    port.data_dependent_init(mels, lengths)
    x, mask = squeeze(mels, sequence_mask(lengths, mels.shape[1]),
                      cfg.decoder.num_squeeze)
    n = mask.sum().item()
    x, mask = x.double().numpy(), mask.double().numpy()
    mean = (x * mask).sum(axis=(0, 1)) / n
    std = np.sqrt((x * x * mask).sum(axis=(0, 1)) / n - mean ** 2)
    first = port.layer_Dict['Decoder'].layer_Dict['Flows'][0].layers[0]
    np.testing.assert_allclose(first.logs.detach().numpy().ravel(),
                               -np.log(std), atol=1e-5)
    np.testing.assert_allclose(first.bias.detach().numpy().ravel(),
                               -mean / std, atol=1e-5)
    # an evaluable model: finite losses from the freshly initialised state
    loss_dict, _ = tstep.make_eval_step(cfg, port)(
        tstep.batch_to_device(batch, 'cpu'))
    assert all(torch.isfinite(v) for v in loss_dict.values())
