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
``seed``, ``generator`` (the encoder's dropout generator state; rank 0's
under data parallelism), ``generators`` (every rank's, in rank order),
``world_size`` and, in a run with the 'em' alignment warmup, ``em_stats``
(its table statistics ``[cnt, s0, s1]``, the same on every rank):
:func:`train_payload` builds it, ``weights.load_reference_checkpoint``
reads its ``Model``, :func:`restored_em_stats` its ``em_stats`` under the
JAX package's rule across configurations and :func:`restore_generator`
this rank's generator state.  Under tensor parallelism the payload holds
the full weights and moments, gathered over the model group: a world of
one's layout, which a world of one resumes from, and a sharded run shards
again after loading (:func:`restore_train_state`).
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, List, Optional, Sequence

import torch

from glow_tts_tpu_torch.config import save_config
from glow_tts_tpu_torch.parallel import tp
from glow_tts_tpu_torch.parallel.data import SINGLE, World, shard_seed
from glow_tts_tpu_torch.utils.logging import logger
from glow_tts_tpu_torch.weights import load_state_dict

SNAPSHOT = 'Hyper_Parameters.yaml'
_FILE = re.compile(r'S_(\d+)\.pt')


def train_payload(model: torch.nn.Module, optimizer, step: int, epoch: int,
                  seed: int, generator: torch.Generator,
                  em_stats: Optional[Sequence[torch.Tensor]] = None,
                  world: World = SINGLE) -> Dict:
    """A train state as a checkpoint holds it, copied to the CPU; the 'em'
    warmup's statistics where the run has them.  Collective under data
    parallelism: every rank's generator state is gathered (each rank calls
    it; rank 0 writes the payload); under tensor parallelism the weights
    and the moments are gathered whole over the model group too."""
    generators = world.gather_bytes(generator.get_state())
    specs = tp.specs_of(model)
    optimizer_state = optimizer.state_dict(model)
    for key in ('mu', 'nu'):
        optimizer_state[key] = {
            name: value.to('cpu') for name, value in tp.gather_state_dict(
                optimizer_state[key], world, specs).items()}
    payload = {
        'Model': {key: value.detach().to('cpu', copy=True)
                  for key, value in tp.full_state_dict(model, world).items()},
        'Optimizer': optimizer_state,
        'Steps': int(step),
        'Epochs': int(epoch),
        'seed': int(seed),
        'generator': generators[0],
        'generators': generators,
        'world_size': world.size,
    }
    if em_stats is not None:
        payload['em_stats'] = [t.detach().to('cpu', copy=True)
                               for t in em_stats]
    return payload


def restored_em_stats(payload: Dict, config, device):
    """The 'em' warmup's statistics a run restored from ``payload``
    continues with, on ``device``, by the JAX package's rule: a config
    without that warmup drops a checkpoint's statistics (with a warning),
    one with it takes the checkpoint's, or, where the checkpoint has none,
    fresh zeros (with a warning: the running sums pool again within about
    1/(1 − decay) batches).  None where the config does not use them."""
    from glow_tts_tpu_torch.training.step import init_em_stats
    stored = payload.get('em_stats')
    if not config.train.uses_em_stats:
        if stored is not None:
            warnings.warn('checkpoint carries em_stats the current config '
                          'does not use; dropping them')
        return None
    if stored is None:
        warnings.warn('checkpoint has no em_stats; resuming with '
                      'freshly-initialised EM table statistics')
        return init_em_stats(config, device)
    return tuple(t.to(device) for t in stored)


def restore_train_state(model: torch.nn.Module, optimizer, payload: Dict,
                        world: World = SINGLE) -> None:
    """Load ``payload``'s full weights and moments into ``model`` and
    ``optimizer``, each rank keeping its shard where the model is sharded
    over ``world``'s model group."""
    specs = tp.specs_of(model)
    load_state_dict(model, tp.shard_state_dict(payload['Model'], world,
                                               specs))
    state = dict(payload['Optimizer'])
    for key in ('mu', 'nu'):
        state[key] = tp.shard_state_dict(state[key], world, specs)
    optimizer.load_state_dict(state, model)


def restore_generator(generator: torch.Generator, payload: Dict,
                      world: World = SINGLE) -> None:
    """Set ``generator`` to this rank's state in ``payload``.  A checkpoint
    of another world size (one without ``world_size`` is of a world of
    one) holds no state of this rank's to continue: the generator is
    re-seeded from ``shard_seed(seed, rank)``, with a warning."""
    saved = int(payload.get('world_size', 1))
    if saved == world.size:
        states = payload.get('generators', [payload['generator']])
        generator.set_state(states[world.rank])
        return
    logger.warning('checkpoint of %d data-parallel ranks restored on %d: '
                   'the encoder dropout streams restart from the seed',
                   saved, world.size)
    generator.manual_seed(shard_seed(payload['seed'], world.rank))


class CheckpointManager:
    def __init__(self, directory: str, config=None,
                 max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if config is not None:
            # a manager without a config only reads (a rank other than 0)
            os.makedirs(self.directory, exist_ok=True)
            snapshot = os.path.join(self.directory, SNAPSHOT)
            if not os.path.exists(snapshot):
                save_config(config, snapshot)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'S_{int(step)}.pt')

    def steps(self) -> List[int]:
        """The steps that have a whole file, ascending."""
        if not os.path.isdir(self.directory):
            return []
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
        os.makedirs(self.directory, exist_ok=True)
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
