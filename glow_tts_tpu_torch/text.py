"""Text normalisation and tokenisation for serving.

The same rules, token ids and token dictionary files as ``glow_tts_tpu.text``
(reference ``Pattern_Generator.py:22-39`` and ``Datasets.py:17-30``); a CPU
test holds them against it.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import yaml

_CHARSET_RE = re.compile(r"[A-Z,.?!'\-\s]+")

BOS = '<S>'
EOS = '<E>'


def text_filtering(text: str) -> Optional[str]:
    """Uppercase, strip brackets and quotes, collapse doubled spaces; return
    ``None`` unless the result is one run of the accepted charset that does
    not start with an apostrophe."""
    text = text.upper().strip()
    for ch in '()"[]:;':
        text = text.replace(ch, '')
    for old, new in (('  ', ' '), (' ,', ','), ("' ", "'")):
        text = text.replace(old, new)
    text = text.strip()
    runs = _CHARSET_RE.findall(text)
    if len(runs) != 1 or text.startswith("'"):
        return None
    return runs[0]


def default_token_dict() -> Dict[str, int]:
    """The 35-token dictionary: ``<S>``, ``<E>``, then the sorted charset."""
    letters = sorted(set(" ',-.?!" + 'ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    return {token: i for i, token in enumerate([BOS, EOS] + letters)}


def build_token_dict(texts: Sequence[str]) -> Dict[str, int]:
    """The letter → id dictionary of a corpus: ``<S>``, ``<E>``, then its
    sorted letters."""
    letters = sorted(set(''.join(texts)))
    return {token: i for i, token in enumerate([BOS, EOS] + letters)}


def save_token_dict(token_dict: Dict[str, int], path: str) -> None:
    """``Token.yaml``, byte for byte as the JAX package writes it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w', encoding='utf-8') as f:
        yaml.dump(token_dict, f, allow_unicode=True)


def load_token_dict(path: str) -> Dict[str, int]:
    with open(path, encoding='utf-8') as f:
        return yaml.safe_load(f)


class Tokenizer:
    """Letters → ids, bracketed by ``<S>``/``<E>``."""

    def __init__(self, token_dict: Optional[Dict[str, int]] = None):
        self.token_dict = dict(token_dict or default_token_dict())

    @property
    def eos_id(self) -> int:
        return self.token_dict[EOS]

    def encode(self, text: str) -> np.ndarray:
        unknown = sorted({c for c in text if c not in self.token_dict})
        if unknown:
            raise ValueError(f'characters missing from the token '
                             f'dictionary: {unknown!r} in {text!r}')
        return np.array([self.token_dict[c] for c in [BOS, *text, EOS]],
                        dtype=np.int32)

    def encode_batch(self, texts: Sequence[str],
                     pad_to: Optional[int] = None):
        """Encode and right-pad with ``<E>``: (tokens [B, T], lengths [B])."""
        encoded: List[np.ndarray] = [self.encode(t) for t in texts]
        lengths = np.array([e.shape[0] for e in encoded], dtype=np.int32)
        tokens = np.full((len(encoded), pad_to or int(lengths.max())),
                         self.eos_id, dtype=np.int32)
        for i, e in enumerate(encoded):
            tokens[i, :e.shape[0]] = e
        return tokens, lengths
