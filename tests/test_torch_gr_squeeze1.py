"""GR mode at ``Num_Squeeze: 1``: the flow as wide as the mel, so GR's pitch
operand is 1 wide (at full width, MiniSpeech's 80 channels; on the card the
flow kernels' 80-channel pitch builds).  The port against the JAX
package under ``'mega_interpret'`` (its Pallas train kernels in interpret
mode) at float32 and at bfloat16, from the same f32 parameters and batch
at ``tiny_config`` size with every dropout rate 0: the first train step's
losses and gradients, leaf by leaf, and a decode (the decoder's inverse
from a latent in the compute dtype, with the batch's conditioning) under
each route, ``'modules'`` at bf16 against JAX's ``'flax'`` decode.  The
port takes the JAX side's MAS path of the step at each dtype (a near-tie
at bf16 moves whole frames).

Tolerances: at float32 those of ``tests/test_torch_train_step.py`` (losses
2e-5 relative, gradients rtol 2e-4 / atol 2e-5) and, on the decoded mel,
of ``tests/test_torch_modes.py`` (1e-5); at bfloat16 the bar of
``tests/torch_port_helpers.py`` (max|port − jax_bf16| ≤
2·max|jax_bf16 − jax_f32| + 1e-6; the gradients leaf by leaf as
``assert_bf16_grads`` holds a whole model's).  JAX's gradients are taken
op by op, as ``tests/test_torch_bf16_train_step.py`` takes them; its
inverse under ``'mega_interpret'`` is one jitted call per dtype, under
``'flax'`` op by op (under ``jit`` XLA keeps the flax modules' bf16 chains
in f32), through a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.training import step as jstep
from glow_tts_tpu_torch.models.layers import sequence_mask
from glow_tts_tpu_torch.ops.coupling import pitch_width
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import build_model, make_train_step
from glow_tts_tpu_torch.weights import gradients_as_jax_params, load_jax_params
from tests.helpers import synthetic_batch, tiny_config
from tests.test_torch_bf16_train_step import _perturbed
from tests.torch_port_helpers import (assert_bf16_close, assert_bf16_grads,
                                      at_dtype, port_config, t,
                                      with_backend, with_dropout)

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
MEL_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_KEYS = ('mle', 'duration', 'speaker', 'total')
DTYPES = ('float32', 'bfloat16')


def _config():
    base = tiny_config().decoder
    decoder = {'Stack': base.stack, 'Num_Squeeze': 1,
               'Num_Split': base.num_split,
               'Affine_Coupling': {
                   'Calc_Channels': base.affine_coupling.calc_channels,
                   'WaveNet': {'Num_Layers': 2, 'Kernel_Size': 5,
                               'Dropout_Rate': 0.05}}}
    return with_backend(with_dropout(tiny_config('GR', Decoder=decoder), 0.0),
                        'mega_interpret')


def _jax_run(cfg, params, batch, latent):
    """The first step's losses, gradients and MAS path, and the decoder's
    inverse from ``latent`` under ``cfg``'s backend and, op by op, under
    ``'flax'``."""
    model = jstep.build_model(cfg)
    flax_model = jstep.build_model(with_backend(cfg, 'flax'))
    jbatch = {key: jnp.asarray(value) for key, value in batch.items()}

    def loss_fn(p):
        outputs = model.apply({'params': p}, deterministic=False,
                              rngs={'dropout': jax.random.PRNGKey(1)},
                              **jbatch)
        losses = jstep.compute_losses(cfg, outputs, jbatch)
        return losses['total'], (losses, outputs['attentions'])

    def inverse(m, latent):
        speaker, prosody, _ = m._conditions(
            jbatch['mels'], jbatch['mel_lengths'], jbatch['speakers'], None,
            True)
        mask = (jnp.arange(latent.shape[1])[None]
                < jbatch['mel_lengths'][:, None])[..., None].astype(
                    jnp.float32)
        x, _, _ = m.decoder(latent.astype(m.dtype or jnp.float32), mask,
                            speaker, prosody, jbatch['pitches'],
                            reverse=True)
        return x

    p = jax.tree_util.tree_map(jnp.asarray, params)
    # op by op, as tests/test_torch_bf16_train_step.py takes JAX's
    # gradients: under jit XLA fuses bf16 chains and rounds less often
    (_, (losses, path)), grads = jax.value_and_grad(loss_fn,
                                                    has_aux=True)(p)
    mel = jax.jit(lambda p, latent: model.apply(
        {'params': p}, latent, method=inverse))(p, jnp.asarray(latent))
    flax_mel = flax_model.apply({'params': p}, jnp.asarray(latent),
                                method=inverse)
    return dict(losses={key: float(v) for key, v in losses.items()},
                path=np.asarray(path), grads=grads,
                mel=np.asarray(mel, np.float32),
                flax_mel=np.asarray(flax_mel, np.float32))


@pytest.fixture(scope='module')
def runs():
    cfg = _config()
    assert cfg.decoder.num_squeeze == 1 and cfg.uses_gradient_reversal
    batch = synthetic_batch(cfg, batch=4)
    params = _perturbed(cfg, batch)
    rng = np.random.default_rng(23)
    mask = (np.arange(batch['mels'].shape[1])[None]
            < batch['mel_lengths'][:, None])[..., None]
    latent = (0.8 * rng.standard_normal(batch['mels'].shape) * mask
              ).astype(np.float32)
    refs = {dtype: _jax_run(at_dtype(cfg, dtype), params, batch, latent)
            for dtype in DTYPES}
    ports = {}
    for dtype in DTYPES:
        pcfg = port_config(at_dtype(cfg, dtype))
        port = load_jax_params(build_model(pcfg), params, pcfg).prepare(
            fold=False)
        path = torch.from_numpy(refs[dtype]['path'].copy())
        step = make_train_step(pcfg, port,
                               make_optimizer(pcfg, port.parameters()),
                               seed=0, mas_fn=lambda *a, path=path: path)
        metrics = step({key: t(value) for key, value in batch.items()})
        ports[dtype] = dict(pcfg=pcfg, metrics={
            key: float(v) for key, v in metrics.items()},
            grads=gradients_as_jax_params(port, pcfg))
    return dict(cfg=cfg, batch=batch, params=params, latent=latent,
                refs=refs, ports=ports)


def test_the_pitch_operand_is_one_wide(runs):
    pcfg = runs['ports']['float32']['pcfg']
    channels = pcfg.sound.mel_dim * pcfg.decoder.num_squeeze
    assert channels == pcfg.sound.mel_dim
    model = build_model(pcfg)
    decoder = model.layer_Dict['Decoder']
    tensors = {key: t(value) for key, value in runs['batch'].items()}
    mask = sequence_mask(tensors['mel_lengths'], tensors['mels'].shape[1])
    pitch = decoder._squeezed_pitch(tensors['pitches'], mask)
    assert pitch.shape[-1] == 1
    # num_squeeze wide, as the JAX package squeezes it, at any flow width
    assert pitch_width(pcfg) == pitch_width(1) == 1 and pitch_width(2) == 2


def test_first_step_losses_match_jax(runs):
    r32, r16 = runs['refs']['float32'], runs['refs']['bfloat16']
    keys = [key for key in LOSS_KEYS if key in r32['losses']]
    assert 'speaker' in keys
    got32 = runs['ports']['float32']['metrics']
    for key in keys:
        assert abs(got32[key] - r32['losses'][key]) <= LOSS_RTOL * max(
            abs(r32['losses'][key]), 1.0), (key, got32[key], r32['losses'])
    got16 = runs['ports']['bfloat16']['metrics']
    assert_bf16_close([got16[key] for key in keys],
                      [r16['losses'][key] for key in keys],
                      [r32['losses'][key] for key in keys], 'losses')


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(value) for path, value
            in jax.tree_util.tree_leaves_with_path(tree)}


def test_first_step_gradients_match_jax(runs):
    j32 = _leaves(runs['refs']['float32']['grads'])
    j16 = _leaves(runs['refs']['bfloat16']['grads'])
    got32 = _leaves(runs['ports']['float32']['grads'])
    got16 = _leaves(runs['ports']['bfloat16']['grads'])
    assert set(got32) == set(j32) == set(got16)
    assert any('Pitch' in key or 'pitch' in key for key in j32)
    for key, ref in j32.items():
        np.testing.assert_allclose(got32[key], ref, err_msg=key, **GRAD_TOL)
    assert_bf16_grads(got16, j16, j32, beyond_own=True)


@pytest.mark.parametrize('dtype', DTYPES)
def test_decode_matches_jax_under_every_route(runs, dtype):
    """The decoder's inverse at ``Num_Squeeze: 1`` under each route, from
    the latent in the compute dtype as a decode hands it over: at f32
    every route against JAX's; at bf16 ``'mega'`` and ``'fused'`` (the TPU
    kernels' bf16 policy) against JAX's ``'mega_interpret'``, and
    ``'modules'`` against JAX's ``'flax'``."""
    ref = runs['refs'][dtype]['mel']
    ref32 = runs['refs']['float32']['mel']
    tensors = {key: t(value) for key, value in runs['batch'].items()}
    mask = sequence_mask(tensors['mel_lengths'], tensors['mels'].shape[1])
    pcfg = runs['ports'][dtype]['pcfg']
    for route in ('fused', 'modules', 'mega'):
        cfg = dataclasses.replace(pcfg, coupling_backend=route)
        port = load_jax_params(build_model(cfg), runs['params'], cfg).prepare()
        with torch.no_grad():
            speaker, prosody, _ = port.conditions(
                tensors['mels'], tensors['mel_lengths'], tensors['speakers'])
            mel, _, _ = port.layer_Dict['Decoder'](
                t(runs['latent']).to(port.dtype), mask, reverse=True,
                speaker=speaker, prosody=prosody, pitch=tensors['pitches'])
        assert mel.dtype == torch.float32 and torch.isfinite(mel).all()
        if dtype == 'float32':
            np.testing.assert_allclose(mel.numpy(), ref, err_msg=route,
                                       **MEL_TOL)
        elif route == 'modules':
            assert_bf16_close(mel, runs['refs'][dtype]['flax_mel'],
                              runs['refs']['float32']['flax_mel'],
                              'decoded mel modules')
        else:
            assert_bf16_close(mel, ref, ref32, f'decoded mel {route}')
