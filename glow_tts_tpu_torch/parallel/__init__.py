"""Training on more than one card (port of ``glow_tts_tpu/parallel/``):
data parallelism, one process per card (:mod:`.data`)."""

from glow_tts_tpu_torch.parallel.data import (SINGLE, World, initialize,
                                              process_count, process_index,
                                              shard_seed)

__all__ = ['SINGLE', 'World', 'initialize', 'process_count',
           'process_index', 'shard_seed']
