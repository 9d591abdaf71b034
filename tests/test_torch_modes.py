"""Serving in the conditioned modes (SE with the look-up table, SE with
GE2E, PE, GR), the PyTorch port against the JAX package at ``tiny_config``
size on the same converted parameters (a nonzero end conv), the same
numpy inputs on both sides:

* the two serving phases against ``make_two_phase_inference`` with JAX's
  noise: mean, log_std and log-durations to 1e-5, the ceiled durations
  exactly away from a ceil boundary, mel lengths and the path exactly,
  mels to MAE < 1e-4 (GR with a pitch track resampled to the bucket);
* the deterministic forward against ``GlowTTS.__call__``: z and logdets to
  1e-5, the MAS path exactly, GR's ``classified_speakers`` to 1e-5;
* a GR decode under the three routes of ``coupling_backend``, equal;
* two batches of other speakers, references and pitch served back to back
  equal to each served alone (the decoder keeps weights across calls,
  never a batch's conditioning);
* the name map per mode (the JAX exporter's keys, order and values; GE2E
  mode's encoder under the port's names beside them) and its inverse;
* ``Inferencer`` from a state dict, an ``S_<step>.pt`` (GE2E mode taking
  its encoder from ``Checkpoint_Path``) and a checkpoint directory, items
  naming reference wavs refused (ROADMAP.md A.6), the TSV route serving
  the look-up table's speaker ids;
* a GR YAML through ``load_config``/``save_config`` and against the JAX
  package's config, field by field.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from glow_tts_tpu.config import load_config as jax_load_config
from glow_tts_tpu.training.step import make_two_phase_inference
from glow_tts_tpu.utils.torch_export import (convert_params_to_reference,
                                             save_reference_checkpoint)
from glow_tts_tpu_torch.config import load_config, save_config
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS
from glow_tts_tpu_torch.ops.coupling import (coupling_reference,
                                             flow_stack_reference,
                                             flow_step_reference)
from glow_tts_tpu_torch.weights import (GE2E_PREFIX, load_jax_params,
                                        reference_to_params)
from glow_tts_tpu_torch.weights import \
    convert_params_to_reference as port_convert
from tests.torch_port_helpers import (MODES, jax_model, port_config,
                                      port_model, t, with_backend)

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ['HELLO THERE.', 'A SHORT ONE', 'THE QUICK BROWN FOX!', 'WHY NOT?']


@pytest.fixture(scope='module', params=MODES)
def setup(request):
    cfg, model, params, _ = jax_model(seed=21, mode=request.param)
    return request.param, cfg, model, params, port_model(cfg, params)


def _items(cfg, seed, texts=TEXTS):
    """Serving items with the features of every mode, as arrays."""
    rng = np.random.default_rng(seed)
    mel_dim, speakers = cfg.sound.mel_dim, cfg.speaker_embedding.num_speakers
    return [{'label': f'u{i}', 'text': text,
             'length_scale': float(rng.uniform(0.8, 1.6)),
             'speaker_id': int(rng.integers(speakers)),
             'mel_for_ge2e': rng.standard_normal(
                 (int(rng.integers(10, 40)), mel_dim)).astype(np.float32),
             'mel_for_prosody': rng.uniform(
                 -4, 4, (int(rng.integers(5, 50)), mel_dim)
             ).astype(np.float32),
             'pitch': rng.random(int(rng.integers(1, 40))).astype(np.float32)}
            for i, text in enumerate(texts)]


def _jax_batch(inferencer, items):
    """The port's collated batch as the JAX serving functions take it."""
    return {key: jnp.asarray(value.cpu().numpy().astype(
        np.int32 if value.dtype == torch.long else np.float32))
        for key, value in inferencer.batch(items).items()}


def _condition(prior):
    vectors = [prior[k] for k in ('speaker_vec', 'prosody_vec')
               if prior.get(k) is not None]
    return sum(vectors[1:], vectors[0]) if vectors else None


def test_two_phase_serving_matches_jax(setup):
    mode, cfg, model, params, port = setup
    state = types.SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    inferencer = Inferencer(port.state_dict(), port.config, 'cpu',
                            max_mel_length=64, mel_buckets=[32])
    items = _items(cfg, 7)
    batch = inferencer.batch(items)
    jbatch = _jax_batch(inferencer, items)
    prior_step, decode_for = make_two_phase_inference(cfg, model)
    prior_ref = prior_step(state, jbatch)
    mask = np.asarray(prior_ref['token_mask'])
    _, _, log_dur_ref = model.apply(
        {'params': state.params}, jbatch['tokens'], jnp.asarray(mask),
        _condition(prior_ref), True, method=lambda m, *a: m.encoder(*a))

    prior = port.inference_prior(
        batch['tokens'], batch['token_lengths'], batch['length_scales'],
        batch.get('mels_for_prosody'), batch.get('mel_lengths_for_prosody'),
        batch.get('speakers'), batch.get('mels_for_ge2e'))
    for key, ref in (('mean', prior_ref['mean']),
                     ('log_std', prior_ref['log_std']),
                     ('log_durations', log_dur_ref),
                     ('speaker_vec', prior_ref['speaker_vec']),
                     ('prosody_vec', prior_ref['prosody_vec'])):
        if ref is None:
            assert prior[key] is None, key
            continue
        np.testing.assert_allclose(prior[key].numpy(), np.asarray(ref),
                                   err_msg=key, **TOL)
    durations_ref = np.asarray(prior_ref['durations'])
    scales = batch['length_scales'].numpy()
    scaled = (np.exp(np.asarray(log_dur_ref)[..., 0].astype(np.float64))
              * mask[..., 0] * scales[:, None])
    decided = np.abs(scaled - np.round(scaled)) > 1e-4
    np.testing.assert_array_equal(prior['durations'].numpy()[decided],
                                  durations_ref[decided])

    bucket = 64
    key = jax.random.PRNGKey(5)
    out_ref = decode_for(bucket)(state, prior_ref, jbatch, key,
                                 np.float32(1.0))
    noise = jax.random.normal(key, (len(items), bucket, cfg.sound.mel_dim),
                              jnp.float32)
    out = port.inference_decode(
        {**prior, 'durations': t(durations_ref)}, noise=t(noise),
        max_mel_length=bucket, pitches=batch.get('pitches'),
        pitch_lengths=batch.get('pitch_lengths'))
    np.testing.assert_array_equal(out['mel_lengths'].numpy(),
                                  np.asarray(out_ref['mel_lengths']))
    np.testing.assert_array_equal(out['attentions'].numpy(),
                                  np.asarray(out_ref['attentions']))
    assert np.abs(out['mels'].numpy() - np.asarray(out_ref['mels'])
                  ).mean() < 1e-4


def test_deterministic_forward_matches_jax(setup):
    mode, cfg, model, params, port = setup
    rng = np.random.default_rng(8)
    from tests.helpers import synthetic_batch
    batch = synthetic_batch(cfg, rng, batch=4, t_tok=12, t_mel=40)
    if cfg.uses_gradient_reversal:
        batch['pitches'] = rng.random(batch['mels'].shape[:2]).astype(
            np.float32)
    ref = model.apply({'params': params}, **{
        key: jnp.asarray(value) for key, value in batch.items()},
        deterministic=True)
    with torch.no_grad():
        got = port(t(batch['tokens']).long(), t(batch['token_lengths']),
                   t(batch['mels']), t(batch['mel_lengths']),
                   speakers=(t(batch['speakers']) if 'speakers' in batch
                             else None),
                   mels_for_ge2e=(t(batch['mels_for_ge2e'])
                                  if 'mels_for_ge2e' in batch else None),
                   pitches=(t(batch['pitches']) if 'pitches' in batch
                            else None))
    for key in ('z', 'log_dets', 'mel_mean', 'mel_log_std', 'log_durations'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)
    np.testing.assert_array_equal(got['attentions'].numpy(),
                                  np.asarray(ref['attentions']))
    if cfg.uses_gradient_reversal:
        np.testing.assert_allclose(got['classified_speakers'].numpy(),
                                   np.asarray(ref['classified_speakers']),
                                   **TOL)
    else:
        assert 'classified_speakers' not in got


def test_routes_agree_on_a_gr_decode():
    cfg, _, params, _ = jax_model(seed=22, mode='GR')
    items = _items(cfg, 9)
    outs = {}
    for backend in ('fused', 'flax', 'mega'):
        port = port_model(with_backend(cfg, backend), params)
        inferencer = Inferencer(port.state_dict(), port.config, 'cpu',
                                max_mel_length=64)
        outs[port.config.flow_route] = inferencer.synthesize_items(items,
                                                                   seed=4)
    assert sorted(outs) == ['fused', 'mega', 'modules']
    for route in ('modules', 'mega'):
        for a, b in zip(outs[route], outs['fused']):
            assert a['mel'].shape == b['mel'].shape
            np.testing.assert_allclose(a['mel'], b['mel'], **TOL)


def test_plain_routes_take_the_pitch_operand():
    """The three plain versions on one GR step's packed weights agree,
    and the pitch term moves the result."""
    cfg, _, params, _ = jax_model(seed=23, mode='GR')
    port = port_model(cfg, params)
    decoder = port.layer_Dict['Decoder']
    rng = np.random.default_rng(1)
    x = t(rng.standard_normal((2, 10, 16)).astype(np.float32))
    mask = torch.ones(2, 10, 1)
    pitch = t(rng.random((2, 10, 2)).astype(np.float32))
    cond = decoder.conditioning(2, torch.zeros(2, 16), torch.zeros(2, 16),
                                pitch=True)
    weights = decoder.stacked_weights(False)
    one = {key: value[0] for key, value in weights.items()}
    z_step, _ = flow_step_reference(x, mask, one, cond[0], False, pitch)
    z_stack, _ = flow_stack_reference(
        x, mask, {key: value[:1] for key, value in weights.items()},
        cond[:1], pitch)
    torch.testing.assert_close(z_step, z_stack, rtol=0, atol=0)
    z_none, _ = flow_step_reference(x, mask, one, cond[0], False)
    assert (z_step - z_none).abs().max() > 1e-3
    step = decoder.layer_Dict['Flows'][0]
    y, _ = step.layers[0](x, mask)
    y, _ = step.layers[1](y, mask)
    z_b, _ = coupling_reference(y[..., :8], y[..., 8:], mask,
                                step.weights(False), cond[0], pitch)
    torch.testing.assert_close(z_b, z_step[..., 8:], **TOL)


def test_back_to_back_batches_equal_each_alone(setup):
    mode, cfg, _, params, port = setup
    first, second = _items(cfg, 30), _items(cfg, 31, TEXTS[::-1])
    for item in second:
        item['speaker_id'] = (item['speaker_id'] + 1) % \
            cfg.speaker_embedding.num_speakers

    def served(model_items):
        inferencer = Inferencer(port.state_dict(), port.config, 'cpu',
                                max_mel_length=64)
        return [inferencer.synthesize_items(items, seed=2)
                for items in model_items]

    both = served([first, second])
    alone = served([second])[0] + served([first])[0]
    for a, b in zip(both[1] + both[0], alone):
        np.testing.assert_array_equal(a['mel'], b['mel'])
    if mode != 'Vanilla':       # the conditioning does reach the mels
        swapped = [dict(item, **{k: other[k] for k in (
            'speaker_id', 'mel_for_ge2e', 'mel_for_prosody', 'pitch')})
            for item, other in zip(first, second)]
        again = served([swapped])[0]
        assert any(a['mel'].shape != b['mel'].shape
                   or not np.array_equal(a['mel'], b['mel'])
                   for a, b in zip(again, both[0]))


def test_name_map_and_its_inverse(setup):
    mode, cfg, _, params, port = setup
    exported = convert_params_to_reference(params, cfg)
    own = port_convert(params, port_config(cfg))
    ge2e = [key for key in own if key.startswith(GE2E_PREFIX)]
    assert bool(ge2e) == (mode == 'SE-GE2E')
    assert [key for key in own if key not in ge2e] == list(exported)
    for key, value in exported.items():
        assert own[key].dtype == value.dtype, key
        np.testing.assert_array_equal(own[key], value, err_msg=key)
    state = port.state_dict()
    assert sorted(state) == sorted(own)
    model = load_jax_params(GlowTTS(port_config(cfg)), params, cfg)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), own[key], err_msg=key)
    back = reference_to_params(state, port_config(cfg))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=0,
                                   atol=0, err_msg=jax.tree_util.keystr(path))


def test_inferencer_serves_from_every_source(setup, tmp_path):
    mode, cfg, _, params, port = setup
    pcfg = port_config(cfg)
    items = _items(cfg, 40)
    expected = Inferencer(port.state_dict(), pcfg, 'cpu',
                          max_mel_length=64).synthesize_items(items, seed=1)
    for r in expected:
        assert np.isfinite(r['mel']).all()
        assert r['attention'].sum() == r['mel'].shape[0]

    path = str(tmp_path / 'S_7.pt')
    save_reference_checkpoint(params, cfg, 7, path)
    if mode == 'SE-GE2E':
        # the reference keeps GE2E apart: without its path it cannot load
        with pytest.raises(KeyError, match='Checkpoint_Path'):
            Inferencer(path, pcfg, 'cpu')
        ge2e = str(tmp_path / 'ge2e.pt')
        torch.save({key[len(GE2E_PREFIX):]: value for key, value in
                    port.state_dict().items()
                    if key.startswith(GE2E_PREFIX)}, ge2e)
        speaker = dataclasses.replace(
            pcfg.speaker_embedding, ge2e=dataclasses.replace(
                pcfg.speaker_embedding.ge2e, checkpoint_path=ge2e))
        pcfg = dataclasses.replace(pcfg, speaker_embedding=speaker)
    directory = tmp_path / 'checkpoints'
    directory.mkdir()
    torch.save({'Model': port.state_dict(), 'Steps': 3},
               str(directory / 'S_3.pt'))
    save_config(pcfg, str(directory / 'Hyper_Parameters.yaml'))
    for source, config in ((path, pcfg), (str(directory), None)):
        got = Inferencer(source, config, 'cpu', max_mel_length=64
                         ).synthesize_items(items, seed=1)
        for a, b in zip(got, expected):
            np.testing.assert_array_equal(a['mel'], b['mel'])


def test_items_that_name_wavs_are_refused(setup, tmp_path):
    mode, cfg, _, params, port = setup
    inferencer = Inferencer(port.state_dict(), port.config, 'cpu',
                            max_mel_length=64)
    tsv = tmp_path / 'lines.tsv'
    tsv.write_text('Label\tText\tLength_Scale\tSpeaker\tGE2E\tProsody\t'
                   'Pitch\nx\tHello there.\t1.0\t2\ta.wav\tb.wav\tc.wav\n'
                   'y\tA second line.\t1.2\t1\ta.wav\tb.wav\tc.wav\n')
    if mode == 'SE-LUT':
        results = inferencer.inference_from_file(str(tsv))
        programmatic = inferencer.inference(['x', 'y'], ['Hello there.',
                                                         'A second line.'],
                                            [1.0, 1.2], speakers=[2, 1])
        for a, b in zip(results, programmatic):
            np.testing.assert_array_equal(a['mel'], b['mel'])
        return
    with pytest.raises(NotImplementedError, match='A.6'):
        inferencer.inference_from_file(str(tsv))
    item = dict(_items(cfg, 1)[0])
    feature = {'SE-GE2E': 'mel_for_ge2e', 'PE': 'mel_for_prosody',
               'GR': 'pitch'}[mode]
    item[feature] = None
    item['wav_for_' + feature.replace('mel_for_', '')] = 'ref.wav'
    with pytest.raises(NotImplementedError, match='A.6'):
        inferencer.synthesize_items([item])
    del item['wav_for_' + feature.replace('mel_for_', '')]
    with pytest.raises(ValueError, match=feature):
        inferencer.synthesize_items([item])


def test_gr_config_round_trip(tmp_path):
    path = os.path.join(REPO, 'configs', 'Hyper_Parameters.yaml')
    with open(path, encoding='utf-8') as f:
        data = yaml.safe_load(f)
    data['Mode'] = 'GR'
    data['Speaker_Embedding']['GE2E']['Checkpoint_Path'] = 'ge2e.pt'
    config = load_config(data)
    ref = jax_load_config(data)
    for section in ('speaker_embedding', 'prosody_encoder',
                    'speaker_classifier_gr'):
        assert (dataclasses.asdict(getattr(config, section))
                == dataclasses.asdict(getattr(ref, section))), section
    assert (config.train.adversarial_speaker_weight
            == ref.train.adversarial_speaker_weight)
    for prop in ('uses_speaker_embedding', 'uses_prosody_encoder',
                 'uses_gradient_reversal', 'condition_size'):
        assert getattr(config, prop) == getattr(ref, prop), prop
    save_config(config, str(tmp_path / 'snapshot.yaml'))
    assert load_config(str(tmp_path / 'snapshot.yaml')) == config
