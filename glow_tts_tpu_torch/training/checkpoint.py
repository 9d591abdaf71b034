"""Step-indexed checkpoints (port of ``glow_tts_tpu/training/checkpoint.py``).

* One file per step, ``<dir>/S_<step>.pt``, named as the reference names
  them; ``restore(0)`` restores the highest step, ``restore(n)`` exactly
  ``n``.
* A file is written under a temporary name, synced and renamed over its
  final name, and the directory synced before an older file is pruned, so
  a run killed while saving leaves every earlier file whole and no partial
  ``S_<step>.pt``.
* ``Hyper_Parameters.yaml``, the config snapshot, is written beside the
  files once.

The payload is a ``torch.save`` dict with the reference's keys ``Model``
(the model's state dict under the reference's names, weight norm
unfolded), ``Optimizer``, ``Steps`` and ``Epochs``, and the port's own
``seed`` and ``generator`` (the encoder's dropout generator state):
:func:`train_payload` builds it, and ``weights.load_reference_checkpoint``
reads its ``Model``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from glow_tts_tpu_torch.config import save_config

SNAPSHOT = 'Hyper_Parameters.yaml'
_FILE = re.compile(r'S_(\d+)\.pt')


def train_payload(model: torch.nn.Module, optimizer, step: int, epoch: int,
                  seed: int, generator: torch.Generator) -> Dict:
    """A train state as a checkpoint holds it, copied to the CPU."""
    return {
        'Model': {key: value.detach().to('cpu', copy=True)
                  for key, value in model.state_dict().items()},
        'Optimizer': optimizer.state_dict(model),
        'Steps': int(step),
        'Epochs': int(epoch),
        'seed': int(seed),
        'generator': generator.get_state(),
    }


class CheckpointManager:
    def __init__(self, directory: str, config=None,
                 max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        if config is not None:
            snapshot = os.path.join(self.directory, SNAPSHOT)
            if not os.path.exists(snapshot):
                save_config(config, snapshot)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'S_{int(step)}.pt')

    def steps(self) -> List[int]:
        """The steps that have a whole file, ascending."""
        return sorted(int(match.group(1)) for match in map(
            _FILE.fullmatch, os.listdir(self.directory)) if match)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict) -> str:
        """Write ``payload`` as step ``step``'s file (replacing one of the
        same step) and drop the oldest beyond ``max_to_keep``."""
        path = self.path(step)
        temporary = path + '.tmp'
        with open(temporary, 'wb') as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(temporary, path)
        # the rename lasts through a crash before an older file goes
        directory = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(directory)
        finally:
            os.close(directory)
        if self.max_to_keep is not None:
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return path

    def restore(self, step: int = 0) -> Optional[Dict]:
        """The payload of step ``step`` (``0``: the highest step), on the
        CPU; ``None`` if ``step`` is 0 and there is no checkpoint.  A step
        that has no file raises ``FileNotFoundError``."""
        target = step or self.latest_step()
        if target is None:
            return None
        path = self.path(target)
        if not os.path.exists(path):
            raise FileNotFoundError(f'no checkpoint of step {target} in '
                                    f'{self.directory} (steps: '
                                    f'{self.steps()})')
        return torch.load(path, map_location='cpu', weights_only=True)
