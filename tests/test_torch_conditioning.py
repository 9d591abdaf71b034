"""The conditioned modes' encoders of the PyTorch port against the JAX
package's (``glow_tts_tpu/models/conditioning.py``), each on the
parameters of one JAX model at ``tiny_config`` size converted by the
port's name map, the same numpy inputs on both sides:

* the speaker look-up table exactly;
* GE2E per slice and pooled over an utterance's slices, rtol = atol = 1e-5;
* the GST prosody encoder on ragged reference lengths (one not a multiple
  of the convs' total stride, one of a single frame), 1e-5;
* GR mode's speaker classifier, 1e-5;
* ``interpolate_pitch`` to 1e-6, new length 1 and base length 1 among the
  cases;
* the gradient reversal: identity forward, −weight·g backward;
* ``load_ge2e_checkpoint`` on a torch state dict the test writes under
  names of its own, from a file, and its error listing the keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.models import conditioning as jcond
from glow_tts_tpu.ops.grl import gradient_reversal as jax_reversal
from glow_tts_tpu_torch.models import conditioning as tcond
from glow_tts_tpu_torch.ops.grl import gradient_reversal
from glow_tts_tpu_torch.weights import (GE2E_PREFIX,
                                        convert_params_to_reference,
                                        load_ge2e_checkpoint)
from tests.torch_port_helpers import jax_model, port_config, port_model, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def gr():
    cfg, model, params, _ = jax_model(seed=11, mode='GR')
    return cfg, model, params, port_model(cfg, params)


@pytest.fixture(scope='module')
def ge2e():
    cfg, model, params, _ = jax_model(seed=12, mode='SE-GE2E')
    return cfg, model, params, port_model(cfg, params)


def _apply(model, params, method, *args):
    return np.asarray(model.apply({'params': params}, *args, method=method))


def test_speaker_lut_is_exact(gr):
    cfg, model, params, port = gr
    ids = np.array([3, 0, 2, 2, 1], np.int32)
    ref = _apply(model, params, lambda m, s: m.speaker_lut(s), ids)
    got = port.layer_Dict['LUT'](t(ids).long()).detach().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('pooled', [False, True])
def test_ge2e_matches_jax(ge2e, pooled):
    cfg, model, params, port = ge2e
    inference = cfg.speaker_embedding.ge2e.inference
    rng = np.random.default_rng(3)
    slices = rng.standard_normal(
        (3 * inference.samples, inference.slice_length,
         cfg.sound.mel_dim)).astype(np.float32)
    if pooled:
        ref = _apply(model, params, lambda m, x: m.ge2e.embed_utterances(x),
                     slices)
        got = port.layer_Dict['GE2E'].embed_utterances(t(slices))
        assert got.shape == (3, cfg.speaker_embedding.embedding_size)
    else:
        ref = _apply(model, params, lambda m, x: m.ge2e(x), slices)
        got = port.layer_Dict['GE2E'](t(slices))
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(np.linalg.norm(ref, axis=-1), 1.0, rtol=1e-5)


def test_ge2e_normalize_matches_jax():
    x = np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32)
    x[2] = 0.0                                         # the eps floor
    np.testing.assert_allclose(tcond.ge2e_normalize(t(x)).numpy(),
                               np.asarray(jcond.ge2e_normalize(x)), **TOL)


@pytest.mark.parametrize('lengths', [[40, 37, 9, 1], [16, 15, 40, 3]])
def test_gst_prosody_encoder_matches_jax(gr, lengths):
    cfg, model, params, port = gr
    rng = np.random.default_rng(sum(lengths))
    mels = rng.standard_normal((len(lengths), 40, cfg.sound.mel_dim)
                               ).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    mels[np.arange(40)[None, :] >= lengths[:, None]] = -4.0
    ref = _apply(model, params, lambda m, x, n: m.prosody_encoder(x, n),
                 mels, lengths)
    got = port.layer_Dict['Prosody_Encoder'](t(mels), t(lengths).long())
    assert got.shape == (len(lengths), cfg.prosody_encoder.size)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


def test_speaker_classifier_matches_jax(gr):
    cfg, model, params, port = gr
    prosody = np.random.default_rng(5).standard_normal(
        (4, cfg.prosody_encoder.size)).astype(np.float32)
    ref = _apply(model, params, lambda m, p: m.speaker_classifier(p),
                 prosody)
    got = port.layer_Dict['Speaker_Classifier_GR'](t(prosody))
    assert got.shape == (4, cfg.speaker_embedding.num_speakers)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize('base,new,capacity', [
    ([30, 17, 1, 30], [60, 9, 5, 1], 64),
    ([8, 8], [8, 2], 8),
    ([1, 12], [1, 30], 32),
])
def test_interpolate_pitch_matches_jax(base, new, capacity):
    rng = np.random.default_rng(len(base) + capacity)
    pitches = rng.random((len(base), max(base))).astype(np.float32)
    base, new = np.array(base, np.int32), np.array(new, np.int32)
    ref = np.asarray(jcond.interpolate_pitch(
        jnp.asarray(pitches), jnp.asarray(base), jnp.asarray(new), capacity))
    got = tcond.interpolate_pitch(t(pitches), t(base), t(new), capacity)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[np.arange(capacity)[None, :] >= new[:, None]]
            == 0).all()


def test_gradient_reversal():
    x = torch.randn(3, 4, requires_grad=True)
    y = gradient_reversal(x, 0.25)
    assert torch.equal(y, x)
    g = torch.randn(3, 4)
    y.backward(g)
    assert torch.equal(x.grad, -0.25 * g)
    # the JAX package's custom_vjp gives the same
    jg = jax.grad(lambda v: jnp.sum(jnp.asarray(g.numpy())
                                    * jax_reversal(v, 0.25)))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(np.asarray(jg), x.grad.numpy())


def _own_names(state, rename):
    """The port's GE2E tensors under the names a GE2E checkpoint of its
    own might use."""
    out = {}
    for key, value in state.items():
        name = key[len(GE2E_PREFIX):]
        out[rename(name)] = torch.as_tensor(np.ascontiguousarray(value))
    return out


def test_load_ge2e_checkpoint(ge2e, tmp_path):
    cfg, _, params, port = ge2e
    expected = {key: value for key, value in
                convert_params_to_reference(params, cfg).items()
                if key.startswith(GE2E_PREFIX)}
    state = _own_names(expected, lambda name: 'encoder.' + name.replace(
        'LSTM', 'lstm').replace('Projection', 'linear'))
    # a tensor of another shape beside it is not taken for the projection
    state['encoder.extra.weight'] = torch.zeros(3, 3)
    state['encoder.extra.bias'] = torch.zeros(3)
    for source in (state, {'Model': state}):
        got = load_ge2e_checkpoint(source, port_config(cfg))
        assert sorted(got) == sorted(expected)
        for key, value in expected.items():
            np.testing.assert_array_equal(got[key].numpy(), value)
    path = str(tmp_path / 'ge2e.pt')
    torch.save({'Model': state}, path)
    got = load_ge2e_checkpoint(path, port_config(cfg))
    for key, value in got.items():
        torch.testing.assert_close(value, port.state_dict()[key], rtol=0,
                                   atol=0)

    missing = {k: v for k, v in state.items() if 'bias_hh_l1' not in k}
    with pytest.raises(KeyError, match='bias_hh_l1') as error:
        load_ge2e_checkpoint(missing, port_config(cfg))
    assert 'encoder.lstm.weight_ih_l0' in str(error.value)   # keys listed
    two = dict(state, **{'other.weight': state['encoder.linear.weight'],
                         'other.bias': state['encoder.linear.bias']})
    with pytest.raises(KeyError, match='projection'):
        load_ge2e_checkpoint(two, port_config(cfg))
