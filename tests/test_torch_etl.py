"""The port's ETL (``glow_tts_tpu_torch/data/pattern_generator.py``), its
reference-wav features and the wav export of ``Inferencer`` on the CPU,
against the JAX package (``glow_tts_tpu/data/pattern_generator.py``,
``ops/vocoder.py``):

* the eight corpus loaders on the directory layouts that
  ``tests/test_etl_all_corpora.py`` builds: equal paths, texts, speakers;
* ``generate_patterns`` on a 4-utterance MiniSpeech corpus
  (``examples/make_minispeech.py``, a subprocess) with the same train/eval
  split: each pickle's ``Mel`` within ``MEL_TOL`` (max-abs on the ±4
  scale) of JAX's, ``Pitch`` equal where the YIN has no near-tie (as
  ``tests/test_torch_dsp.py`` rules; none on this corpus), the rest of
  each pickle, the metadata and ``Token.yaml``'s bytes equal;
* ``load_reference_features`` per conditioned mode equal to JAX's (the
  same tolerances);
* ``Inferencer.synthesize_items(export_wav=True)`` writing wavs of
  ``hop · (frames − 1)`` samples, as JAX's ``mel_to_audio`` gives;
* the MiniSpeech tool's copy of the corpus's phone table, and its scoring
  on the corpus's own mels.
"""

import dataclasses
import os
import pickle
import random
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import tests.torch_port_helpers as helpers
from glow_tts_tpu.config import load_config as jax_load_config
from glow_tts_tpu.data import pattern_generator as jpg
from glow_tts_tpu.ops import vocoder as jvocoder
from glow_tts_tpu_torch.data import pattern_generator as pg
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import random_state_dict
from glow_tts_tpu_torch.tools import minispeech_e2e
from tests.test_etl_all_corpora import BUILDERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_TOL = 2e-3


@pytest.mark.parametrize('corpus', list(BUILDERS))
def test_loaders_equal_to_jaxs(corpus, tmp_path):
    builder, has_text = BUILDERS[corpus]
    builder(tmp_path / corpus)
    root = str(tmp_path / corpus)
    got = pg.LOADERS[corpus](root, has_text)
    want = {'LJ': jpg.lj_info, 'BC2013': jpg.bc2013_info,
            'CMUA': jpg.cmua_info, 'VCTK': jpg.vctk_info,
            'Libri': jpg.libri_info, 'VC1': jpg.vc1_info,
            'VC2': jpg.vc2_info, 'VC1T': jpg.vc1t_info}[corpus](root,
                                                               has_text)
    assert sorted(got[0]) == sorted(want[0]) and len(got[0]) == 4
    assert got[1] == want[1] and got[2] == want[2]
    if not has_text:
        with pytest.raises(ValueError, match='no transcripts'):
            pg.LOADERS[corpus](root, True)


def jax_minispeech_config(root):
    """The JAX package's MiniSpeech config with the tool's paths."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cfg = jax_load_config(minispeech_e2e.MINISPEECH)
    patterns = os.path.join(root, 'patterns')
    train = dataclasses.replace(
        cfg.train, train_pattern=dataclasses.replace(
            cfg.train.train_pattern, path=os.path.join(patterns, 'Train')),
        eval_pattern=dataclasses.replace(
            cfg.train.eval_pattern, path=os.path.join(patterns, 'Eval')))
    return dataclasses.replace(cfg, train=train, token_path=os.path.join(
        patterns, 'Token.yaml'))


@pytest.fixture(scope='module')
def minispeech(tmp_path_factory):
    """A 4-utterance MiniSpeech corpus through both ETLs: (port config,
    JAX config) with their pattern roots."""
    work = tmp_path_factory.mktemp('minispeech')
    corpus = str(work / 'corpus')
    subprocess.run([sys.executable, os.path.join(REPO, 'examples',
                                                 'make_minispeech.py'),
                    '--n', '4', '--out', corpus, '--seed', '3'], check=True,
                   capture_output=True)
    configs = {}
    for side in ('port', 'jax'):
        if side == 'jax':
            cfg = jax_minispeech_config(str(work / side))
            etl = jpg.generate_patterns
        else:
            cfg = minispeech_e2e.minispeech_config(str(work / side))
            etl = pg.generate_patterns
        kwargs = {'device': 'cpu'} if side == 'port' else {}
        random.seed(0)
        etl(cfg, {'LJ': corpus}, use_text=True, eval_ratio=0.25,
            eval_min=1, max_workers=2, **kwargs)
        configs[side] = cfg
    return configs, corpus


def _pickles(root):
    return sorted(os.path.relpath(p, root)
                  for p in minispeech_e2e.pattern_files(root))


def test_generate_patterns_equal_to_jaxs(minispeech):
    configs, _ = minispeech
    port, jax_cfg = configs['port'], configs['jax']
    for split in ('train_pattern', 'eval_pattern'):
        ours = getattr(port.train, split).path
        theirs = getattr(jax_cfg.train, split).path
        names = _pickles(ours)
        assert names == _pickles(theirs) and names
        for name in names:
            with open(os.path.join(ours, name), 'rb') as f:
                got = pickle.load(f)
            with open(os.path.join(theirs, name), 'rb') as f:
                want = pickle.load(f)
            assert set(got) == set(want)
            assert got['Mel'].shape == want['Mel'].shape
            assert np.abs(got['Mel'] - want['Mel']).max() <= MEL_TOL, name
            np.testing.assert_array_equal(got['Pitch'], want['Pitch'])
            np.testing.assert_array_equal(got['Audio'], want['Audio'])
            for key in ('Speaker_ID', 'Speaker', 'Dataset', 'Text'):
                assert got[key] == want[key], key
        with open(os.path.join(ours, 'METADATA.PICKLE'), 'rb') as f:
            got = pickle.load(f)
        with open(os.path.join(theirs, 'METADATA.PICKLE'), 'rb') as f:
            want = pickle.load(f)
        assert got == want
    with open(port.token_path, 'rb') as f, open(jax_cfg.token_path, 'rb') as g:
        assert f.read() == g.read()


def test_scoring_on_the_corpus_own_mels(minispeech):
    """The tool's free-run length error and phone correlation on the ETL's
    mels, sliced by the generator's durations: near 0 and near 1."""
    from examples import make_minispeech
    assert minispeech_e2e.LETTERS == make_minispeech.LETTERS
    assert minispeech_e2e.PAUSE_FRAMES == make_minispeech.PAUSE_FRAMES
    for i in range(len(make_minispeech.LETTERS)):
        assert (minispeech_e2e.phone_params(i)
                == make_minispeech.phone_params(i))
    configs, _ = minispeech
    root = configs['port'].train.train_pattern.path
    results = []
    for path in minispeech_e2e.pattern_files(root):
        with open(path, 'rb') as f:
            pattern = pickle.load(f)
        durations = [0] + [minispeech_e2e.expected_frames(ch)
                           for ch in pattern['Text']] + [0]
        mel = pattern['Mel'][:sum(durations)]
        attention = np.zeros((len(durations), mel.shape[0]), np.float32)
        ends = np.cumsum(durations)
        for i, (a, b) in enumerate(zip(ends - durations, ends)):
            attention[i, a:b] = 1.0
        results.append({'text': pattern['Text'], 'mel': mel,
                        'attention': attention})
    scores = minispeech_e2e.score(
        results, minispeech_e2e.phone_signatures(root))
    assert scores['free_run_length_rel_err'] < 0.01, scores
    assert scores['phone_signature_corr_min'] > 0.9, scores
    assert scores['n_phones_checked'] > 10, scores


@pytest.mark.parametrize('mode', ['SE-GE2E', 'PE', 'GR'])
def test_reference_features_equal_to_jaxs(minispeech, mode):
    _, corpus = minispeech
    wavs = sorted(os.path.join(corpus, 'wavs', name)
                  for name in os.listdir(os.path.join(corpus, 'wavs')))
    jax_cfg = helpers.mode_config(mode)
    entry = {'label': 'x', 'text': 'HELLO.', 'wav_for_ge2e': wavs[0],
             'wav_for_prosody': wavs[1], 'wav_for_pitch': wavs[2]}
    got = pg.load_reference_features(helpers.port_config(jax_cfg), entry,
                                     'cpu')
    want = jpg.load_reference_features(jax_cfg, entry)
    assert set(got) == set(want)
    for key in ('mel_for_ge2e', 'mel_for_prosody'):
        assert (key in got) == (key in want)
        if key in got:
            assert got[key].shape == want[key].shape
            assert np.abs(got[key] - want[key]).max() <= MEL_TOL
    if 'pitch' in want:
        np.testing.assert_array_equal(got['pitch'], want['pitch'])


def test_export_writes_wavs_of_the_mels_length(tmp_path):
    cfg = helpers.port_config(helpers.tiny_config())
    inferencer = Inferencer(random_state_dict(cfg, 3), cfg, 'cpu',
                            max_mel_length=64)
    items = [{'label': f'u{i}', 'text': text}
             for i, text in enumerate(['HELLO THERE.', 'A SHORT ONE'])]
    results = inferencer.synthesize_items(items, out_dir=str(tmp_path),
                                          export_wav=True,
                                          griffin_lim_iterations=8)
    sound = helpers.tiny_config().sound
    for result in results:
        frames = result['mel'].shape[0]
        rate, audio = wavfile.read(str(tmp_path / 'WAV'
                                       / f'{result["label"]}.wav'))
        assert rate == cfg.sound.sample_rate and audio.dtype == np.int16
        assert audio.shape == result['audio'].shape == (
            cfg.sound.frame_shift * (frames - 1),)
        assert jvocoder.mel_to_audio(result['mel'], sound,
                                     iterations=2).shape == audio.shape
        np.testing.assert_array_equal(
            audio, (np.clip(result['audio'], -1, 1) * 32767).astype(
                np.int16))
        assert np.abs(result['audio']).max() == 1.0
    again = inferencer.synthesize_items(items, out_dir=str(tmp_path / 'b'),
                                        export_wav=True,
                                        griffin_lim_iterations=8)
    for a, b in zip(results, again):
        assert torch.equal(torch.as_tensor(a['audio']),
                           torch.as_tensor(b['audio']))
    plain = inferencer.synthesize_items(items, export_wav=True)
    assert all('audio' not in r for r in plain)


def test_the_cli_runs_the_etl(tmp_path):
    """``glow-tts-torch-patterns`` on an LJ layout with ``--device cpu``;
    without the flag it asks for the card, and raises where there is
    none."""
    from glow_tts_tpu_torch.cli import patterns_main
    from glow_tts_tpu_torch.config import save_config
    from tests.test_etl_all_corpora import _etl_config
    BUILDERS['LJ'][0](tmp_path / 'LJ')
    cfg = helpers.port_config(_etl_config(tmp_path / 'work'))
    hp = str(tmp_path / 'hp.yaml')
    save_config(cfg, hp)
    argv = ['-hp', hp, '-lj', str(tmp_path / 'LJ'), '-text', '-evalr',
            '0.25', '-mw', '2']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            patterns_main(argv)
    patterns_main(argv + ['--device', 'cpu'])
    for split in ('Train', 'Eval'):
        with open(tmp_path / 'work' / split / 'METADATA.PICKLE', 'rb') as f:
            assert pickle.load(f)['File_List'], split
    assert (tmp_path / 'work' / 'Token.yaml').exists()
