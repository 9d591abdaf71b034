"""The decoder's three ``coupling_backend`` routes, the port against the
JAX package on the same parameters at ``tiny_config`` size, inputs from a
numpy seed:

* the port's ``FlowDecoder`` under ``'modules'``, ``'fused'`` and ``'mega'``
  against the JAX ``FlowDecoder`` under ``'flax'``, ``'fused_interpret'``
  and ``'mega_interpret'`` (the Pallas kernels in interpret mode), forward
  and reverse, ragged lengths;
* ``ActNorm``, ``InvertibleConv`` and ``AffineCoupling`` forward and
  reverse against their flax modules;
* the slice as a whole under ``'mega'`` and ``'modules'``: the
  ``Inferencer``'s two-phase mels and the ``eval_step`` losses against
  JAX's under the matching backend;
* ActNorm's data-dependent initialisation and ``invalidate()`` under every
  route.

Tolerances: those of ``tests/test_torch_decoder.py`` (z rtol 3e-5 / atol
3e-6, logdet rtol 3e-5 / atol 1e-4); mel MAE < 1e-3 (the repo's bar) with
mel lengths and attentions equal; losses 1e-5 relative."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.models import decoder as jd
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS, initial_state_dict
from glow_tts_tpu_torch.ops.coupling import COUPLING_WEIGHT_KEYS
from glow_tts_tpu_torch.training import step as tstep
from glow_tts_tpu_torch.weights import load_state_dict
from tests.torch_port_helpers import (jax_model, port_config, port_model,
                                      ragged, t, with_backend)

Z_TOL = dict(rtol=3e-5, atol=3e-6)
LD_TOL = dict(rtol=3e-5, atol=1e-4)
LOSS_REL = 1e-5
MEL_MAE = 1e-3
# the port's route, and the JAX backend that runs the same route on the CPU
ROUTES = {'modules': 'flax', 'fused': 'fused_interpret',
          'mega': 'mega_interpret'}


@pytest.fixture(scope='module')
def setup():
    cfg, _, params, batch = jax_model(seed=6)
    ports = {route: port_model(with_backend(cfg, backend), params)
             for route, backend in ROUTES.items()}
    return cfg, params, batch, ports


def test_each_port_model_takes_its_route(setup):
    _, _, _, ports = setup
    for route, port in ports.items():
        decoder = port.layer_Dict['Decoder']
        assert port.config.flow_route == route
        assert decoder.mega_route == (route == 'mega')
        assert all(step.modules_route == (route == 'modules')
                   for step in decoder.layer_Dict['Flows'])


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('length,lengths', [(12, [12, 8, 4]),
                                            (15, [14, 2, 9])])
@pytest.mark.parametrize('route', list(ROUTES))
def test_flow_decoder_route_matches_jax_backend(setup, route, length,
                                                lengths, reverse):
    cfg, params, _, ports = setup
    x, mask = ragged(np.random.default_rng(80 + length), len(lengths),
                     length, cfg.sound.mel_dim, lengths)
    dec = jd.FlowDecoder(with_backend(cfg, ROUTES[route]))
    z_ref, ld_ref, m_ref = dec.apply({'params': params['decoder']},
                                     jnp.asarray(x), jnp.asarray(mask),
                                     reverse=reverse)
    with torch.no_grad():
        z, ld, m = ports[route].layer_Dict['Decoder'](t(x), t(mask),
                                                      reverse=reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    if reverse:
        assert ld is None and ld_ref is None
    else:
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


@pytest.mark.parametrize('route', list(ROUTES))
def test_flow_decoder_route_round_trip(setup, route):
    cfg, _, _, ports = setup
    x, mask = ragged(np.random.default_rng(5), 2, 12, cfg.sound.mel_dim,
                     [12, 6])
    dec = ports[route].layer_Dict['Decoder']
    with torch.no_grad():
        z, _, m = dec(t(x), t(mask))
        back, _, _ = dec(z, m, reverse=True)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-5)


def _squeezed(cfg, seed, lengths=(9, 6, 3)):
    c = cfg.sound.mel_dim * cfg.decoder.num_squeeze
    return ragged(np.random.default_rng(seed), len(lengths), max(lengths), c,
                  list(lengths))


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('layer,flax_module,name', [
    (0, lambda cfg: jd.ActNorm(), 'actnorm'),
    (1, lambda cfg: jd.InvertibleConv(cfg.decoder.num_split), 'invconv'),
    (2, lambda cfg: jd.AffineCoupling(with_backend(cfg, 'flax')),
     'coupling')])
def test_flow_step_module_matches_flax(setup, layer, flax_module, name,
                                       reverse):
    """Each of the three modules of flow step 1, forward and reverse, and
    its round trip.  The coupling packs its own weights here."""
    cfg, params, _, ports = setup
    x, mask = _squeezed(cfg, 90 + layer)
    z_ref, ld_ref = flax_module(cfg).apply(
        {'params': params['decoder']['flow_1'][name]}, jnp.asarray(x),
        jnp.asarray(mask), reverse=reverse)
    module = (ports['modules'].layer_Dict['Decoder'].layer_Dict['Flows'][1]
              .layers[layer])
    with torch.no_grad():
        z, ld = module(t(x), t(mask), reverse)
        back, _ = module(z, t(mask), not reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **Z_TOL)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-5)
    if reverse:
        assert ld is None and ld_ref is None
    else:
        assert ld.shape == (x.shape[0],)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **LD_TOL)


def test_coupling_module_on_the_steps_pack_is_its_own_pack(setup):
    """``FlowStep`` hands its cached pack to the coupling; the module alone
    packs the same weights itself."""
    cfg, _, _, ports = setup
    x, mask = _squeezed(cfg, 93)
    step = ports['modules'].layer_Dict['Decoder'].layer_Dict['Flows'][2]
    weights = step.weights(False)
    packed = ({key: weights[key] for key in COUPLING_WEIGHT_KEYS},
              step.cond(x.shape[0]))
    with torch.no_grad():
        alone = step.layers[2](t(x), t(mask))
        cached = step.layers[2](t(x), t(mask), packed=packed)
    for a, b in zip(alone, cached):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _state(params):
    return types.SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, params))


@pytest.mark.parametrize('route', ['mega', 'modules'])
def test_two_phase_slice_matches_jax_under_route(setup, route):
    """The serving slice through the ``Inferencer``'s model: both sides fed
    the JAX durations and JAX's own noise."""
    cfg, params, batch, ports = setup
    jcfg = with_backend(cfg, ROUTES[route])
    state = _state(params)
    scales = np.array([1.0, 1.7, 0.6, 2.3], np.float32)
    jbatch = {'tokens': jnp.asarray(batch['tokens']),
              'token_lengths': jnp.asarray(batch['token_lengths']),
              'length_scales': jnp.asarray(scales)}
    prior_step, decode_for = jstep.make_two_phase_inference(
        jcfg, jstep.build_model(jcfg))
    prior_ref = prior_step(state, jbatch)
    durations_ref = np.asarray(prior_ref['durations'])

    inferencer = Inferencer(ports[route].state_dict(), port_config(jcfg),
                            'cpu', max_mel_length=64,
                            mel_buckets=[16, 32, 48])
    assert inferencer.config.flow_route == route
    model = inferencer.model
    prior = model.inference_prior(t(batch['tokens']).long(),
                                  t(batch['token_lengths']).long(),
                                  t(scales))
    bucket = inferencer.pick_bucket(t(durations_ref))
    key = jax.random.PRNGKey(7)
    out_ref = decode_for(bucket)(state, prior_ref, jbatch, key,
                                 np.float32(1.0))
    noise = jax.random.normal(key, (len(scales), bucket, cfg.sound.mel_dim),
                              jnp.float32)
    out = model.inference_decode({**prior, 'durations': t(durations_ref)},
                                 noise=t(noise), max_mel_length=bucket)
    np.testing.assert_array_equal(out['durations'].numpy(), durations_ref)
    np.testing.assert_array_equal(out['mel_lengths'].numpy(),
                                  np.asarray(out_ref['mel_lengths']))
    np.testing.assert_array_equal(out['attentions'].numpy(),
                                  np.asarray(out_ref['attentions']))
    mels_ref = np.asarray(out_ref['mels'])
    assert out['mels'].shape == mels_ref.shape
    assert np.abs(out['mels'].numpy() - mels_ref).mean() < MEL_MAE


@pytest.mark.parametrize('route', ['mega', 'modules'])
def test_eval_step_losses_match_jax_under_route(setup, route):
    cfg, params, batch, ports = setup
    jcfg = with_backend(cfg, ROUTES[route])
    ref_losses, ref_out = jstep.make_eval_step(jcfg, jstep.build_model(jcfg))(
        _state(params),
        {key: jnp.asarray(value) for key, value in batch.items()})
    got_losses, got_out = tstep.make_eval_step(
        port_config(jcfg), ports[route])(tstep.batch_to_device(batch, 'cpu'))
    assert sorted(got_losses) == sorted(ref_losses)
    for key in ('mle', 'duration', 'total'):
        np.testing.assert_allclose(got_losses[key].item(),
                                   float(ref_losses[key]), rtol=LOSS_REL,
                                   err_msg=key)
    np.testing.assert_array_equal(got_out['attentions'].numpy(),
                                  np.asarray(ref_out['attentions']))
    np.testing.assert_allclose(got_out['log_dets'].numpy(),
                               np.asarray(ref_out['log_dets']), **LD_TOL)


def test_data_dependent_init_is_the_same_under_every_route(setup):
    """The initialisation runs step by step whatever the route, so the
    three routes arrive at the same ActNorm parameters, and each route's
    forward pass then whitens nothing differently."""
    cfg, _, batch, _ = setup
    mels, lengths = t(batch['mels']), t(batch['mel_lengths'])
    results = {}
    for route in ROUTES:
        pcfg = dataclasses.replace(port_config(cfg), coupling_backend=route)
        port = load_state_dict(GlowTTS(pcfg),
                               initial_state_dict(pcfg, seed=1)).prepare()
        port.data_dependent_init(mels, lengths)
        flows = port.layer_Dict['Decoder'].layer_Dict['Flows']
        losses, _ = tstep.make_eval_step(pcfg, port)(
            tstep.batch_to_device(batch, 'cpu'))
        results[route] = ([step.layers[0].logs.detach().clone()
                           for step in flows], losses['total'])
    assert any(logs.abs().max() > 0.05 for logs in results['fused'][0])
    for route in ('mega', 'modules'):
        for a, b in zip(results[route][0], results['fused'][0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(results[route][1], results['fused'][1],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize('route', list(ROUTES))
def test_invalidate_drops_every_cached_pack(setup, route):
    """After a parameter changes, ``invalidate()`` makes every route pack
    again (the stacked pack of ``'mega'`` included); without it the old
    weights would still be served."""
    cfg, params, _, _ = setup
    port = port_model(with_backend(cfg, ROUTES[route]), params)
    decoder = port.layer_Dict['Decoder']
    x, mask = ragged(np.random.default_rng(8), 2, 12, cfg.sound.mel_dim,
                     [12, 6])
    with torch.no_grad():
        before, _, _ = decoder(t(x), t(mask))
        end = decoder.layer_Dict['Flows'][1].layers[2].layer_Dict['End']
        end.bias.add_(0.25)
        decoder.invalidate()
        after, _, _ = decoder(t(x), t(mask))
        fresh = port_model(with_backend(cfg, 'fused_interpret'), params)
        fresh_end = (fresh.layer_Dict['Decoder'].layer_Dict['Flows'][1]
                     .layers[2].layer_Dict['End'])
        fresh_end.bias.add_(0.25)
        fresh.layer_Dict['Decoder'].pack()
        expected, _, _ = fresh.layer_Dict['Decoder'](t(x), t(mask))
    assert (after - before).abs().max() > 1e-3
    np.testing.assert_allclose(after.numpy(), expected.numpy(), **Z_TOL)
