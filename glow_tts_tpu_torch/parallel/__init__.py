"""Training and serving on more than one card (port of
``glow_tts_tpu/parallel/``): data parallelism, one process per card
(:mod:`.data`), and tensor parallelism, the model sharded over a group of
ranks (:mod:`.tp`)."""

from glow_tts_tpu_torch.parallel.data import (SINGLE, World, initialize,
                                              process_count, process_index,
                                              shard_seed)

__all__ = ['SINGLE', 'World', 'initialize', 'process_count',
           'process_index', 'shard_seed']
