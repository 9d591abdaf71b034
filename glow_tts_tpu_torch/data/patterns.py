"""Pattern archive IO (port of ``glow_tts_tpu/data/patterns.py``, the
parts that training and serving read; numpy and the standard library
only).

A *pattern* is one utterance, pickled as a dict with keys
``Audio / Mel / Pitch / Speaker_ID / Speaker / Dataset [/ Text]``; a
pattern directory carries a ``METADATA.PICKLE`` with the file list and the
length dictionaries.  Archives written by either package, or by the
reference's pattern generator, load in the others.  Unpickle only archives
you made: loading a pickle can run code.
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from glow_tts_tpu_torch.text import text_filtering


def load_pattern(path: str) -> Dict:
    with open(path, 'rb') as f:
        return pickle.load(f)


def save_pattern(path: str, pattern: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(pattern, f, protocol=4)


def load_metadata(pattern_path: str,
                  metadata_file: str = 'METADATA.PICKLE') -> Dict:
    with open(os.path.join(pattern_path, metadata_file), 'rb') as f:
        return pickle.load(f)


def build_metadata(pattern_path: str, sound_config,
                   use_text: bool = True) -> Dict:
    """Walk a pattern tree and build its metadata dict (the reference's
    keys, so either implementation can consume it)."""
    metadata = {
        'Spectrogram_Dim': sound_config.spectrogram_dim,
        'Mel_Dim': sound_config.mel_dim,
        'Frame_Shift': sound_config.frame_shift,
        'Frame_Length': sound_config.frame_length,
        'Sample_Rate': sound_config.sample_rate,
        'Max_Abs_Mel': sound_config.max_abs_mel,
        'File_List': [],
        'Audio_Length_Dict': {},
        'Mel_Length_Dict': {},
        'Pitch_Length_Dict': {},
        'Speaker_ID_Dict': {},
        'Speaker_Dict': {},
        'Dataset_Dict': {},
        'File_List_by_Speaker_Dict': {},
    }
    if use_text:
        metadata['Text_Length_Dict'] = {}

    for root, _, files in os.walk(pattern_path):
        for file in files:
            full = os.path.join(root, file)
            if file.upper() == 'METADATA.PICKLE' or \
                    not file.upper().endswith('.PICKLE'):
                continue
            try:
                pattern = load_pattern(full)
                rel = os.path.relpath(full, pattern_path).replace('\\', '/')
                metadata['Audio_Length_Dict'][rel] = pattern['Audio'].shape[0]
                metadata['Mel_Length_Dict'][rel] = pattern['Mel'].shape[0]
                metadata['Pitch_Length_Dict'][rel] = pattern['Pitch'].shape[0]
                metadata['Speaker_ID_Dict'][rel] = pattern['Speaker_ID']
                metadata['Speaker_Dict'][rel] = pattern['Speaker']
                metadata['Dataset_Dict'][rel] = pattern['Dataset']
                if use_text:
                    metadata['Text_Length_Dict'][rel] = len(pattern['Text'])
                metadata['File_List'].append(rel)
                metadata['File_List_by_Speaker_Dict'].setdefault(
                    pattern['Speaker'], []).append(rel)
            except Exception as error:   # not a pattern: skipped, as there
                print(f'Skipping non-pattern file {full}: {error}')
    return metadata


def save_metadata(pattern_path: str, metadata: Dict,
                  metadata_file: str = 'METADATA.PICKLE') -> None:
    with open(os.path.join(pattern_path, metadata_file.upper()), 'wb') as f:
        pickle.dump(metadata, f, protocol=4)


@dataclass
class PatternDataset:
    """Training/eval dataset over a pattern directory with length
    filtering, epoch accumulation and an optional in-RAM cache."""
    pattern_path: str
    metadata_file: str = 'METADATA.PICKLE'
    accumulated_dataset_epoch: int = 1
    mel_length_min: float = -math.inf
    mel_length_max: float = math.inf
    text_length_min: float = -math.inf
    text_length_max: float = math.inf
    use_cache: bool = False
    _cache: Dict[int, Dict] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        metadata = load_metadata(self.pattern_path, self.metadata_file)
        self.files: List[str] = [
            f for f in metadata['File_List']
            if (self.mel_length_min <= metadata['Mel_Length_Dict'][f]
                <= self.mel_length_max)
            and (self.text_length_min <= metadata['Text_Length_Dict'][f]
                 <= self.text_length_max)
        ]
        self.metadata = metadata
        self.base_length = len(self.files)

    def __len__(self) -> int:
        return self.base_length * self.accumulated_dataset_epoch

    def mel_length(self, idx: int) -> int:
        return self.metadata['Mel_Length_Dict'][
            self.files[idx % self.base_length]]

    def __getitem__(self, idx: int) -> Dict:
        key = idx % self.base_length
        if key in self._cache:
            return self._cache[key]
        pattern = load_pattern(
            os.path.join(self.pattern_path, self.files[key]))
        item = {
            'text': pattern['Text'],
            'mel': np.asarray(pattern['Mel'], np.float32),
            'pitch': np.asarray(pattern['Pitch'], np.float32),
            'speaker_id': int(pattern['Speaker_ID']),
            'speaker': pattern['Speaker'],
        }
        if self.use_cache:
            self._cache[key] = item
        return item


@dataclass
class InferenceDataset:
    """TSV inference specs: ``label  text  length_scale  speaker
    wav_for_ge2e  wav_for_prosody  wav_for_pitch`` under a header row;
    rows with fewer columns, or whose text the filter rejects, are
    skipped."""
    path: str

    def __post_init__(self):
        self.entries = []
        with open(self.path, encoding='utf-8') as f:
            lines = f.readlines()[1:]
        for line in lines:
            parts = [x.strip() for x in line.strip().split('\t')]
            if len(parts) < 7:
                continue
            label, text, scale, speaker, wav_ge2e, wav_pros, wav_pitch = \
                parts[:7]
            filtered = text_filtering(text)
            if filtered is None:
                continue
            self.entries.append({
                'label': label,
                'text': filtered,
                'length_scale': float(scale),
                'speaker_id': int(speaker),
                'wav_for_ge2e': wav_ge2e,
                'wav_for_prosody': wav_pros,
                'wav_for_pitch': wav_pitch,
            })

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict:
        return self.entries[idx]
