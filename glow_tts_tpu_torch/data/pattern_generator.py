"""The ETL: corpora → pattern archives (audio, mel and pitch pickles).

The port of ``glow_tts_tpu/data/pattern_generator.py``: the per-corpus
loaders (LJ, BC2013, CMUA, VCTK, Libri, VC1, VC2, VC1-test) with their
transcript parsing and speakers, the per-dataset trim thresholds, the
token dictionary, the train/eval split, the fan-out over utterances, one
pickle per utterance and ``METADATA.PICKLE``, in the layout that
:mod:`glow_tts_tpu_torch.data.patterns` and the JAX package's loader both
read.

The mel and the YIN pitch run on ``device`` (:mod:`glow_tts_tpu_torch.ops.
stft`, :mod:`~glow_tts_tpu_torch.ops.yin`); decoding, the trim and the
peak normalisation run on the host (:mod:`glow_tts_tpu_torch.data.
audio_io`).  The CLI runs the DSP on the card unless ``--device cpu`` is
given, and raises where there is no card.

    glow-tts-torch-patterns -hp <config.yaml> -lj <path> [-vctk <path> ...]
        -text [-evalr 0.001] [-evalm 1] [-mw 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from random import shuffle
from typing import Dict, List, Optional, Tuple

import numpy as np

from glow_tts_tpu_torch.config import Config, load_config
from glow_tts_tpu_torch.data.audio_io import load_audio
from glow_tts_tpu_torch.data.patterns import (build_metadata, save_metadata,
                                              save_pattern)
from glow_tts_tpu_torch.ops import stft as stft_ops
from glow_tts_tpu_torch.ops import yin as yin_ops
from glow_tts_tpu_torch.ops.stft import Device, card_or_cpu
from glow_tts_tpu_torch.text import (build_token_dict, save_token_dict,
                                     text_filtering)

AUDIO_EXTENSIONS = ('.WAV', '.M4A', '.FLAC')

# per-dataset trim thresholds (reference Pattern_Generator.py:20)
TOP_DB = {'LJ': 60, 'BC2013': 60, 'VCTK': 15, 'VC1': 23, 'VC1T': 23,
          'VC2': 23, 'Libri': 23, 'CMUA': 60}


# ---------------------------------------------------------------------------
# audio and features
# ---------------------------------------------------------------------------

def audio_prep(path: str, sample_rate: int,
               trim_top_db: float = 60.0) -> np.ndarray:
    """Load, trim the silence, peak-normalise."""
    audio = load_audio(path, sample_rate)
    audio = stft_ops.trim_silence(audio, top_db=trim_top_db,
                                  frame_length=512, hop_length=256)
    return stft_ops.normalize_audio(audio)


def pattern_generate(config: Config, path: str, top_db: float = 60.0,
                     device: Device = 'cuda') -> Tuple[np.ndarray, ...]:
    """(audio, mel ``[T, M]``, normalised pitch ``[T]``) of one utterance,
    the mel and the pitch made on ``device``."""
    sound = config.sound
    audio = audio_prep(path, sound.sample_rate, top_db)
    mel = stft_ops.mel_spectrogram_host(
        audio,
        sample_rate=sound.sample_rate,
        num_frequency=sound.spectrogram_dim,
        num_mel=sound.mel_dim,
        window_length=sound.frame_length,
        hop_length=sound.frame_shift,
        device=device,
        mel_fmin=sound.mel_f_min,
        mel_fmax=sound.mel_f_max,
        max_abs_value=sound.max_abs_mel)
    pitch = yin_ops.pitch_calc(
        audio, sound.sample_rate,
        w_len=sound.frame_length, w_step=sound.frame_shift,
        f0_min=sound.pitch_min, f0_max=sound.pitch_max,
        confidence_threshold=sound.confidence_threshold,
        gaussian_smoothing_sigma=sound.gaussian_smoothing_sigma,
        device=device)
    pitch = yin_ops.normalize_pitch(pitch)
    n = min(mel.shape[0], pitch.shape[0])
    return audio, mel[:n], pitch[:n]


def load_reference_features(config: Config, entry: Dict,
                            device: Device = 'cuda') -> Dict:
    """An inference entry with the features its mode reads from reference
    wavs (made on ``device``, trimmed at 30 dB): ``mel_for_ge2e`` from
    ``wav_for_ge2e`` (GE2E), ``mel_for_prosody`` from ``wav_for_prosody``
    (PE, GR), ``pitch`` from ``wav_for_pitch`` (GR)."""
    item = dict(entry)
    if config.uses_ge2e:
        _, mel, _ = pattern_generate(config, entry['wav_for_ge2e'], 30,
                                     device)
        item['mel_for_ge2e'] = mel
    if config.uses_prosody_encoder:
        _, mel, _ = pattern_generate(config, entry['wav_for_prosody'], 30,
                                     device)
        item['mel_for_prosody'] = mel
    if config.uses_gradient_reversal:
        _, _, pitch = pattern_generate(config, entry['wav_for_pitch'], 30,
                                       device)
        item['pitch'] = pitch
    return item


# ---------------------------------------------------------------------------
# corpus loaders: (paths, text_dict, speaker_dict)
# ---------------------------------------------------------------------------

def _walk_audio(path: str) -> List[str]:
    found = []
    for root, _, files in os.walk(path):
        for file in files:
            if os.path.splitext(file)[1].upper() in AUDIO_EXTENSIONS:
                found.append(os.path.join(root, file).replace('\\', '/'))
    return found


def lj_info(path: str, use_text: bool = False):
    """LJSpeech: metadata.csv with ``file|raw|normalized`` rows."""
    paths = _walk_audio(path)
    text_dict = {}
    if use_text:
        with open(os.path.join(path, 'metadata.csv'), encoding='utf-8') as f:
            for line in f:
                file, _, text = line.strip().split('|')
                filtered = text_filtering(text)
                if filtered is None:
                    continue
                text_dict[os.path.join(path, 'wavs', f'{file}.wav')
                          .replace('\\', '/')] = filtered
        paths = list(text_dict.keys())
    return paths, text_dict, {p: 'LJ' for p in paths}


def bc2013_info(path: str, use_text: bool = False):
    """Blizzard 2013: a sibling .txt per wav."""
    paths = _walk_audio(path)
    text_dict = {}
    if use_text:
        for p in paths:
            txt = p.replace('wav', 'txt')
            if os.path.exists(txt):
                with open(txt, encoding='utf-8') as f:
                    filtered = text_filtering(f.readline().strip())
                if filtered is not None:
                    text_dict[p] = filtered
        paths = list(text_dict.keys())
    return paths, text_dict, {p: 'BC2013' for p in paths}


def cmua_info(path: str, use_text: bool = False):
    """CMU Arctic: etc/txt.done.data per voice; the speaker from the
    directory's name."""
    paths = _walk_audio(path)
    text_dict = {}
    if use_text:
        for root, _, _ in os.walk(path):
            done = os.path.join(root, 'txt.done.data')
            if not os.path.exists(done):
                continue
            with open(done, encoding='utf-8') as f:
                for line in f:
                    head, text, _ = line.strip().split('"')
                    file = head.strip().split(' ')[1]
                    wav = os.path.join(root.replace('etc', 'wav'),
                                       f'{file}.wav').replace('\\', '/')
                    filtered = text_filtering(text)
                    if filtered is not None:
                        text_dict[wav] = filtered
        paths = list(text_dict.keys())
    speakers = {p: 'CMUA.{}'.format(p.split('/')[-3].split('_')[2].upper())
                for p in paths}
    return paths, text_dict, speakers


def vctk_info(path: str, use_text: bool = False):
    """VCTK: wav48/<speaker>/*.wav with txt/<speaker>/*.txt; p315 has no
    transcripts; an optional list of the non-outliers."""
    wav_root = os.path.join(path, 'wav48').replace('\\', '/')
    non_outlier = None
    filter_file = os.path.join(wav_root, 'VCTK.NonOutlier.txt')
    if os.path.exists(filter_file):
        with open(filter_file, encoding='utf-8') as f:
            non_outlier = {x.strip() for x in f}
    paths = [p for p in _walk_audio(wav_root)
             if non_outlier is None or os.path.basename(p) in non_outlier]
    text_dict = {}
    if use_text:
        for p in paths:
            if 'P315' in p.upper():
                continue
            txt = p.replace('wav48', 'txt').replace('.wav', '.txt')
            if not os.path.exists(txt):
                continue
            with open(txt, encoding='utf-8') as f:
                filtered = text_filtering(f.readline())
            if filtered is not None:
                text_dict[p] = filtered
        paths = list(text_dict.keys())
    speakers = {p: 'VCTK.{}'.format(p.split('/')[-2].upper())
                for p in paths}
    return paths, text_dict, speakers


def libri_info(path: str, use_text: bool = False):
    """LibriTTS: <utt>.normalized.txt beside each wav; the speaker is the
    top directory."""
    paths = _walk_audio(path)
    text_dict = {}
    if use_text:
        for p in paths:
            txt = f'{os.path.splitext(p)[0]}.normalized.txt'
            if not os.path.exists(txt):
                continue
            with open(txt, encoding='utf-8') as f:
                filtered = text_filtering(f.readline())
            if filtered is not None:
                text_dict[p] = filtered
        paths = list(text_dict.keys())
    speakers = {p: 'Libri.{:04d}'.format(int(p.split('/')[-3]))
                for p in paths}
    return paths, text_dict, speakers


def _voxceleb_info(path: str, label: str):
    paths = _walk_audio(path)
    speakers = {p: '{}.{}'.format(label, p.split('/')[-3].upper())
                for p in paths}
    return paths, {}, speakers


def vc1_info(path: str, use_text: bool = False):
    if use_text:
        raise ValueError('VoxCeleb1 has no transcripts.')
    return _voxceleb_info(path, 'VC1')


def vc2_info(path: str, use_text: bool = False):
    if use_text:
        raise ValueError('VoxCeleb2 has no transcripts.')
    return _voxceleb_info(path, 'VC2')


def vc1t_info(path: str, use_text: bool = False):
    if use_text:
        raise ValueError('VoxCeleb1-test has no transcripts.')
    return _voxceleb_info(path, 'VC1T')


LOADERS = {'LJ': lj_info, 'BC2013': bc2013_info, 'CMUA': cmua_info,
           'VCTK': vctk_info, 'Libri': libri_info, 'VC1': vc1_info,
           'VC2': vc2_info, 'VC1T': vc1t_info}


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def pattern_file_generate(config: Config, path: str, speaker_id: int,
                          speaker: str, dataset: str,
                          text: Optional[str], eval_split: bool,
                          device: Device = 'cuda') -> None:
    """One utterance → one pickle; a file that exists is skipped, so a
    run can be repeated; an utterance that fails is reported and
    skipped."""
    pattern_root = (config.train.eval_pattern.path if eval_split
                    else config.train.train_pattern.path)
    stem = os.path.splitext(os.path.basename(path))[0]
    name = (speaker if dataset in speaker else f'{dataset}.{speaker}')
    file = os.path.join(pattern_root, dataset, speaker,
                        f'{name}.{stem}.PICKLE'.upper())
    if os.path.exists(file):
        return
    try:
        audio, mel, pitch = pattern_generate(
            config, path, TOP_DB.get(dataset, 60), device)
        assert mel.shape[0] == pitch.shape[0], \
            f'mel/pitch length mismatch {mel.shape} vs {pitch.shape}'
        pattern = {
            'Audio': audio.astype(np.float32),
            'Mel': mel.astype(np.float32),
            'Pitch': pitch.astype(np.float32),
            'Speaker_ID': speaker_id,
            'Speaker': speaker,
            'Dataset': dataset,
        }
        if text is not None:
            pattern['Text'] = text
    except Exception as error:
        print(f'Error: {error} in {path}')
        return
    save_pattern(file, pattern)


def split_eval(paths: List[str], eval_ratio: float = 0.001,
               min_eval: int = 1):
    shuffle(paths)
    index = max(int(len(paths) * eval_ratio), min_eval)
    return paths[index:], paths[:index]


def generate_patterns(config: Config, corpora: Dict[str, str],
                      use_text: bool = False, eval_ratio: float = 0.001,
                      eval_min: int = 1, max_workers: int = 10,
                      device: Device = 'cuda') -> None:
    """Every utterance of ``corpora`` (dataset → root) into the config's
    train and eval pattern directories, ``Token.yaml`` at its
    ``token_path`` when ``use_text``; ``max_workers`` threads, the DSP of
    each on ``device``."""
    device = card_or_cpu(device)
    all_paths: List[str] = []
    text_dict: Dict[str, str] = {}
    speaker_dict: Dict[str, str] = {}
    dataset_dict: Dict[str, str] = {}
    for dataset, root in corpora.items():
        paths, texts, speakers = LOADERS[dataset](root, use_text)
        print(f'{dataset}: {len(paths)} utterances')
        all_paths.extend(paths)
        text_dict.update(texts)
        speaker_dict.update(speakers)
        dataset_dict.update({p: dataset for p in paths})

    if use_text:
        save_token_dict(build_token_dict(list(text_dict.values())),
                        config.token_path)
    speaker_index = {s: i for i, s in
                     enumerate(sorted(set(speaker_dict.values())))}
    train_paths, eval_paths = split_eval(all_paths, eval_ratio, eval_min)

    def work(args):
        path, eval_split = args
        pattern_file_generate(
            config, path, speaker_index[speaker_dict[path]],
            speaker_dict[path], dataset_dict[path],
            text_dict.get(path) if use_text else None, eval_split, device)

    jobs = ([(p, False) for p in train_paths]
            + [(p, True) for p in eval_paths])
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        list(pool.map(work, jobs))

    for eval_split in (False, True):
        root = (config.train.eval_pattern.path if eval_split
                else config.train.train_pattern.path)
        save_metadata(root, build_metadata(root, config.sound, use_text))
    print('Pattern generation done.')


def main(argv=None):
    parser = argparse.ArgumentParser(prog='glow-tts-torch-patterns')
    parser.add_argument('-hp', '--hyper_parameters',
                        default='configs/Hyper_Parameters.yaml')
    parser.add_argument('-lj', '--lj_path')
    parser.add_argument('-bc2013', '--bc2013_path')
    parser.add_argument('-cmua', '--cmua_path')
    parser.add_argument('-vctk', '--vctk_path')
    parser.add_argument('-libri', '--libri_path')
    parser.add_argument('-vc1', '--vc1_path')
    parser.add_argument('-vc2', '--vc2_path')
    parser.add_argument('-vc1t', '--vc1_test_path')
    parser.add_argument('-text', '--use_text', action='store_true')
    parser.add_argument('-evalr', '--eval_ratio', default=0.001, type=float)
    parser.add_argument('-evalm', '--eval_min', default=1, type=int)
    parser.add_argument('-mw', '--max_worker', default=10, type=int)
    parser.add_argument('--device', default='cuda',
                        help="torch device of the DSP (default 'cuda')")
    args = parser.parse_args(argv)

    config = load_config(args.hyper_parameters)
    corpora = {}
    for dataset, value in [('LJ', args.lj_path), ('BC2013', args.bc2013_path),
                           ('CMUA', args.cmua_path), ('VCTK', args.vctk_path),
                           ('Libri', args.libri_path), ('VC1', args.vc1_path),
                           ('VC2', args.vc2_path),
                           ('VC1T', args.vc1_test_path)]:
        if value:
            corpora[dataset] = value
    if not corpora:
        parser.error('no corpus paths given')
    generate_patterns(config, corpora, args.use_text, args.eval_ratio,
                      args.eval_min, args.max_worker, args.device)


if __name__ == '__main__':
    main()
