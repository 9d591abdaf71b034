"""The port's ``TrainCollater`` (Vanilla fields) and ``InferenceCollater``
(the serving fields of all four modes) against the JAX package's on the
same items: every array equal, dtype included."""

import numpy as np
import pytest

from glow_tts_tpu import text as jtext
from glow_tts_tpu.data import collate as jcollate
from glow_tts_tpu_torch import text as ttext
from glow_tts_tpu_torch.data import collate as tcollate
from tests.helpers import tiny_config
from tests.torch_port_helpers import MODES, mode_config, port_config

TEXTS = ['HELLO, WORLD!', 'A', "IT'S A TEST - FINE?",
         'THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG.']


def _items(seed, mel_dim, lengths):
    rng = np.random.default_rng(seed)
    return [{'text': TEXTS[i % len(TEXTS)],
             'mel': rng.uniform(-4, 4, (n, mel_dim)).astype(np.float32),
             'pitch': rng.random(n).astype(np.float32)}
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize('seed,lengths', [
    (0, [40, 17, 128, 3]),        # odd lengths are cut to the squeeze
    (1, [129, 2]),                # one frame over a mel bucket
    (2, [5]),
])
def test_train_collater_matches_jax(seed, lengths):
    cfg = tiny_config()
    items = _items(seed, cfg.sound.mel_dim, lengths)
    ref = jcollate.TrainCollater(cfg, jtext.Tokenizer())(items)
    got = tcollate.TrainCollater(port_config(cfg), ttext.Tokenizer())(items)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    s = cfg.decoder.num_squeeze
    assert (got['mel_lengths'] % s == 0).all()
    assert got['mels'].shape[1] % cfg.tpu.mel_bucket == 0
    assert got['tokens'].shape[1] % cfg.tpu.token_bucket == 0


@pytest.mark.parametrize('value,multiple', [(1, 32), (32, 32), (33, 32),
                                            (1000, 128)])
def test_round_up_matches_jax(value, multiple):
    assert (tcollate.round_up(value, multiple)
            == jcollate.round_up(value, multiple))


def _serving_items(seed, mel_dim, n, speakers=4):
    rng = np.random.default_rng(seed)
    return [{'text': TEXTS[i % len(TEXTS)],
             'length_scale': float(rng.uniform(0.5, 2.0)),
             'speaker_id': int(rng.integers(speakers)),
             'mel_for_ge2e': rng.standard_normal(
                 (int(rng.integers(3, 60)), mel_dim)).astype(np.float32),
             'mel_for_prosody': rng.uniform(
                 -4, 4, (int(rng.integers(1, 200)), mel_dim)
             ).astype(np.float32),
             'pitch': rng.random(int(rng.integers(1, 200))
                                 ).astype(np.float32)}
            for i in range(n)]


@pytest.mark.parametrize('mode', ['Vanilla', *MODES])
@pytest.mark.parametrize('seed,n', [(0, 4), (1, 1), (2, 7)])
def test_inference_collater_matches_jax(mode, seed, n):
    """The serving batch of every mode: speaker ids (look-up table), GE2E
    slices (reflect-padded when short, offsets from the batch's
    fingerprint), prosody mels padded with −max_abs_mel and pitch tracks
    padded with 0 to the mel bucket, with their lengths."""
    cfg = mode_config(mode)
    items = _serving_items(seed, cfg.sound.mel_dim, n)
    ref = jcollate.InferenceCollater(cfg, jtext.Tokenizer())(items)
    got = tcollate.InferenceCollater(port_config(cfg), ttext.Tokenizer())(
        items)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
