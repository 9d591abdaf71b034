"""The deterministic routes ``'modules'`` (the coupling kernel #2) and
``'mega'`` (the one-launch stack #4) at bfloat16 against the JAX package at
bfloat16 and at float32, from the same f32 parameters and batch at
``tiny_config`` size, in Vanilla and GR mode: the port's ``'modules'``
against JAX's ``'flax'`` route and its ``'mega'`` against
``'mega_interpret'`` (the Pallas stack kernel in interpret mode), as
``tests/test_torch_bf16_train_modes.py`` pairs them.  Per case: the ActNorm
data-dependent initialisation against ``create_train_state``'s at bf16;
one eval step's losses and ``z``; the decoder's forward ``z`` and logdet
from the float32 mels (as the eval step hands them over) and its inverse
from a latent in the compute dtype (as a decode hands it over: the
decoded mel, with the batch's conditioning), against the JAX model's
decoder under the same backend.  And
the plain bf16 ``flow_stack_reference`` against ``fused_flow_stack``
(interpret mode) at bf16, both directions, with and without the pitch
operand.

Tolerance (``tests/torch_port_helpers.py``): max|port − jax_bf16| ≤
2·max|jax_bf16 − jax_f32| + 1e-6.  Under ``'mega'`` both sides run the
TPU kernels' bf16 policy; under ``'modules'`` both keep the stream in the
decoder input's dtype between ActNorm, the mixing and the coupling, and
the JAX side's flax coupling rounds where XLA does, the port's where the
TPU kernel does: two bf16 policies of the same size of error.  One JAX compile per case and
dtype (the eval step and the decoder's two directions in one jitted
function), through a module-scoped fixture.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops.coupling import fused_flow_stack
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu_torch.models.layers import sequence_mask
from glow_tts_tpu_torch.ops import coupling as tc
from glow_tts_tpu_torch.training.step import build_model, make_eval_step
from glow_tts_tpu_torch.weights import load_jax_params
from tests.test_torch_bf16_train_step import _batch, _config, _perturbed
from tests.test_torch_flow_stack import _weights as stack_weights
from tests.torch_port_helpers import (assert_bf16_close, at_dtype,
                                      port_config, ragged, t)

DTYPES = ('float32', 'bfloat16')
# (mode, the port's route, the JAX side's backend)
CASES = [('Vanilla', 'modules', 'flax'), ('Vanilla', 'mega', 'mega_interpret'),
         ('GR', 'modules', 'flax'), ('GR', 'mega', 'mega_interpret')]


def _latent(batch, cfg):
    """A latent [B, T, M] for the inverse pass, zero past each length."""
    rng = np.random.default_rng(17)
    mask = (np.arange(batch['mels'].shape[1])[None]
            < batch['mel_lengths'][:, None])[..., None]
    return (0.8 * rng.standard_normal(batch['mels'].shape) * mask
            ).astype(np.float32)


def _jax_run(cfg, params, batch, latent):
    """The eval step's losses, ``z`` and path (one jitted call), and the
    JAX model's decoder under the route's backend forward from the mels
    and inverse from ``latent`` cast to the compute dtype, with the
    batch's conditioning, op by op: under ``jit`` XLA keeps the flax
    modules' bf16 chains in f32 and rounds only where a fusion ends, so
    the jitted decoder is a third bf16 policy; op by op each flax op's
    result is rounded to bf16 as its dtype says (the way
    ``tests/test_torch_bf16_train_step.py`` takes JAX's gradients)."""
    model = jstep.build_model(cfg)
    eval_step = jstep.make_eval_step(cfg, model)
    gr = cfg.uses_gradient_reversal

    def conditions(m, mels, mel_lengths, speakers):
        return m._conditions(mels, mel_lengths, speakers, None, True)[:2]

    def flow(m, x, mask, speaker, prosody, pitch, reverse):
        if reverse:
            x = x.astype(m.dtype or jnp.float32)
        x, logdet, _ = m.decoder(x, mask, speaker, prosody, pitch,
                                 reverse=reverse)
        return x, logdet

    p = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {key: jnp.asarray(value) for key, value in batch.items()}
    losses, outputs = jax.jit(lambda p, b: eval_step(
        types.SimpleNamespace(params=p), b))(p, jbatch)
    mels, lengths = jbatch['mels'], jbatch['mel_lengths']
    mask = (jnp.arange(mels.shape[1])[None] < lengths[:, None]
            )[..., None].astype(jnp.float32)
    speaker, prosody = model.apply({'params': p}, mels, lengths,
                                   jbatch.get('speakers'), method=conditions)
    pitch = jbatch['pitches'] if gr else None
    z, logdet = model.apply({'params': p}, mels, mask, speaker, prosody,
                            pitch, False, method=flow)
    x, _ = model.apply({'params': p}, jnp.asarray(latent), mask, speaker,
                       prosody, pitch, True, method=flow)
    return ({key: float(v) for key, v in losses.items()},
            *(np.asarray(a, np.float32) for a in
              (outputs['z'], outputs['attentions'], z, logdet, x)))


@functools.lru_cache(maxsize=None)
def _jax_actnorm(mode):
    """The ActNorm logs and bias of every flow step after
    ``create_train_state``'s initialisation at each dtype (the JAX
    package's init runs the flow step by step as flax modules under every
    backend), and the f32 state's parameters."""
    cfg = _config(mode, 'flax')
    batch = _batch(cfg, False)
    states = {dtype: jstep.create_train_state(
        at_dtype(cfg, dtype), jax.random.PRNGKey(0), batch)[1].params
        for dtype in DTYPES}
    actnorm = {dtype: np.concatenate([
        np.asarray(states[dtype]['decoder'][f'flow_{i}']['actnorm'][key])
        .reshape(-1) for i in range(cfg.decoder.stack)
        for key in ('logs', 'bias')]) for dtype in DTYPES}
    return actnorm, jax.tree_util.tree_map(np.asarray, states['float32'])


@pytest.fixture(scope='module', params=CASES,
                ids=[f'{m}-{r}' for m, r, _ in CASES])
def case(request):
    mode, route, backend = request.param
    cfg = _config(mode, backend)
    batch = _batch(cfg, False)
    params = _perturbed(cfg, batch)
    latent = _latent(batch, cfg)
    refs = {dtype: _jax_run(at_dtype(cfg, dtype), params, batch, latent)
            for dtype in DTYPES}
    pcfg = port_config(at_dtype(cfg, 'bfloat16'))
    assert pcfg.flow_route == route and pcfg.compute_dtype == 'bfloat16'
    port = load_jax_params(build_model(pcfg), params, pcfg).prepare()
    assert port.dtype == torch.bfloat16
    return dict(mode=mode, route=route, cfg=cfg, pcfg=pcfg, batch=batch,
                params=params, latent=latent, refs=refs, port=port)


def test_bf16_eval_step_matches_jax(case):
    """The eval step's losses and ``z`` (its decoder forward) against the
    JAX model's eval step under the route's JAX backend (``'flax'`` for
    ``'modules'``), the JAX bf16 side's MAS path handed to the port (a
    near-tie at bf16 moves whole frames)."""
    port, refs, batch = case['port'], case['refs'], case['batch']
    path = torch.from_numpy(refs['bfloat16'][2].copy())
    losses, outputs = make_eval_step(case['pcfg'], port,
                                     mas_fn=lambda *a: path)(
        {key: t(value) for key, value in batch.items()})
    keys = sorted(refs['float32'][0])
    assert sorted(losses) == keys
    assert_bf16_close([float(losses[key]) for key in keys],
                      [refs['bfloat16'][0][key] for key in keys],
                      [refs['float32'][0][key] for key in keys], 'losses')
    assert outputs['z'].dtype == torch.float32
    assert_bf16_close(outputs['z'], refs['bfloat16'][1], refs['float32'][1],
                      'z')


def test_bf16_decoder_both_directions_match_jax(case):
    """The decoder's forward (``z`` and the logdet from the float32 mels)
    and its inverse from a bf16 latent (the decoded mel) under the route at
    bf16, with the batch's conditioning (GR: the speaker and prosody
    vectors and the pitch track), against the JAX model's decoder under
    the route's backend (``'flax'`` for ``'modules'``, whose stream is
    float32 forward and bfloat16 inverse on both sides)."""
    port, refs, batch = case['port'], case['refs'], case['batch']
    tensors = {key: t(value) for key, value in batch.items()}
    decoder = port.layer_Dict['Decoder']
    mask = sequence_mask(tensors['mel_lengths'], tensors['mels'].shape[1])
    with torch.no_grad():
        speaker, prosody, _ = port.conditions(
            tensors['mels'], tensors['mel_lengths'], tensors.get('speakers'),
            tensors.get('mels_for_ge2e'))
        pitch = tensors.get('pitches') if case['mode'] == 'GR' else None
        z, logdet, _ = decoder(tensors['mels'], mask, speaker=speaker,
                               prosody=prosody, pitch=pitch)
        x, _, _ = decoder(t(case['latent']).to(port.dtype), mask,
                          reverse=True, speaker=speaker, prosody=prosody,
                          pitch=pitch)
    assert z.dtype == x.dtype == logdet.dtype == torch.float32
    for name, got, i in (('z', z, 3), ('logdet', logdet, 4),
                         ('decoded mel', x, 5)):
        assert_bf16_close(got, refs['bfloat16'][i], refs['float32'][i], name)


def test_bf16_actnorm_init_under_the_route_matches_jax(case):
    """ActNorm's statistics from the first batch under the route at bf16
    (the init runs step by step through the flow-step function under every
    route) against ``create_train_state`` at bf16."""
    actnorm, state = _jax_actnorm(case['mode'])
    pcfg, batch = case['pcfg'], case['batch']
    port = load_jax_params(build_model(pcfg), state, pcfg).prepare(
        fold=False)
    for step in port.layer_Dict['Decoder'].layer_Dict['Flows']:
        with torch.no_grad():
            step.layers[0].logs.zero_()
            step.layers[0].bias.zero_()
    tensors = {key: t(value) for key, value in batch.items()}
    port.data_dependent_init(tensors['mels'], tensors['mel_lengths'],
                             **{key: tensors[key] for key in
                                ('speakers', 'mels_for_ge2e', 'pitches')
                                if key in tensors})
    got = np.concatenate([
        getattr(step.layers[0], key).detach().reshape(-1).numpy()
        for step in port.layer_Dict['Decoder'].layer_Dict['Flows']
        for key in ('logs', 'bias')])
    assert_bf16_close(got, actnorm['bfloat16'], actnorm['float32'],
                      'ActNorm logs, bias')


@pytest.mark.parametrize('pitch_size', [0, 2])
@pytest.mark.parametrize('reverse', [False, True])
def test_plain_bf16_flow_stack_matches_pallas(reverse, pitch_size):
    """``flow_stack_reference`` at bf16 (the stream bf16 between the steps)
    against ``fused_flow_stack`` in interpret mode at ``dt = bfloat16``,
    three steps over a ragged batch."""
    lengths = [13, 1, 5, 12]
    rng = np.random.default_rng(60 + pitch_size + reverse)
    x, mask = ragged(rng, len(lengths), max(lengths), 16, lengths)
    w = stack_weights(rng, 3, pitch_size)
    cond = (rng.standard_normal((3, 2, len(lengths), 32)) * .2
            ).astype(np.float32)
    pitch = ((rng.standard_normal((len(lengths), max(lengths), pitch_size))
              * mask).astype(np.float32) if pitch_size else None)
    refs = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        z, ld = fused_flow_stack(
            jnp.asarray(x, dtype), jnp.asarray(mask),
            {key: jnp.asarray(v) for key, v in w.items()}, jnp.asarray(cond),
            pitch=None if pitch is None else jnp.asarray(pitch),
            reverse=reverse, interpret=True)
        refs[dtype] = (np.asarray(z, np.float32),
                       None if ld is None else np.asarray(ld))
    z, ld = tc.flow_stack(t(x).to(torch.bfloat16), t(mask),
                          {key: t(v) for key, v in w.items()}, t(cond),
                          pitch=None if pitch is None else t(pitch),
                          reverse=reverse)
    assert z.dtype == torch.bfloat16
    assert_bf16_close(z, refs[jnp.bfloat16][0], refs[jnp.float32][0], 'z')
    if reverse:
        assert ld is None
    else:
        assert_bf16_close(ld, refs[jnp.bfloat16][1], refs[jnp.float32][1],
                          'logdet')



def _tiny_port(dtype):
    from tests.torch_port_helpers import jax_model
    cfg, _, params, _ = jax_model(seed=6)
    pcfg = port_config(at_dtype(cfg, dtype))
    return load_jax_params(build_model(pcfg), params, pcfg).prepare()


@pytest.mark.parametrize('dtype', DTYPES)
def test_coupling_module_packs_for_its_input_dtype(dtype):
    """``AffineCoupling.forward`` with no pack of its own packs the weights
    for ``x``'s dtype: at bf16 those the bf16 kernel takes rounded, as
    ``FlowStep.weights(reverse, bf16)`` packs them; at f32 the f32 pack as
    before, and the result bit-equal to the coupling on that pack."""
    port = _tiny_port(dtype)
    step = port.layer_Dict['Decoder'].layer_Dict['Flows'][0]
    module = step.layers[2]
    rng = np.random.default_rng(3)
    c = step.layers[0].logs.shape[1]
    x, mask = ragged(rng, 3, 9, c, [9, 4, 6])
    x = t(x).to(port.dtype)
    seen = {}

    def recording(x_a, x_b, mask_, weights, cond, pitch=None, reverse=False):
        seen.update(weights)
        return tc.coupling(x_a, x_b, mask_, weights, cond, pitch, reverse)

    with torch.no_grad():
        z, logdet = module(x, t(mask), coupling_fn=recording)
    pack = step.weights(False, port.dtype)
    for key in tc.COUPLING_WEIGHT_KEYS:
        assert torch.equal(seen[key], pack[key]), key
    if port.dtype == torch.bfloat16:
        for key in tc.BF16_ROUNDED_KEYS:
            if key in seen:
                assert torch.equal(seen[key],
                                   seen[key].to(torch.bfloat16).float()), key
        assert not torch.equal(seen['w_start'],
                               step.weights(False)['w_start'])
    c2 = c // 2
    own = {key: pack[key] for key in tc.COUPLING_WEIGHT_KEYS}
    z_b, ld = tc.coupling(x[..., :c2], x[..., c2:], t(mask), own,
                          step.cond(3))
    assert torch.equal(z, torch.cat([x[..., :c2], z_b], dim=-1))
    assert torch.equal(logdet, ld)


def test_stacked_weights_are_kept_per_direction_and_dtype():
    """``FlowDecoder.stacked_weights(reverse, dtype)``: each (direction,
    dtype) its own stack of the steps' packs of that dtype, kept until
    ``invalidate()``, which forgets them all; the f32 stack is the f32
    packs stacked, as before the dtype argument."""
    decoder = _tiny_port('float32').layer_Dict['Decoder']
    flows = decoder.layer_Dict['Flows']
    stacks = {(reverse, dtype): decoder.stacked_weights(reverse, dtype)
              for reverse in (False, True)
              for dtype in (torch.float32, torch.bfloat16)}
    assert decoder.stacked_weights(False) is stacks[(False, torch.float32)]
    for (reverse, dtype), stack in stacks.items():
        assert decoder.stacked_weights(reverse, dtype) is stack
        for key, value in stack.items():
            assert torch.equal(value, torch.stack(
                [step.weights(reverse, dtype)[key] for step in flows])), key
    assert not torch.equal(stacks[(False, torch.bfloat16)]['mix_t'],
                           stacks[(False, torch.float32)]['mix_t'])
    decoder.invalidate()
    for (reverse, dtype), stack in stacks.items():
        assert decoder.stacked_weights(reverse, dtype) is not stack
