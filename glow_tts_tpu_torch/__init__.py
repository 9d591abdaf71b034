"""glow_tts_tpu_torch — Glow-TTS in PyTorch: serving and training in the
four modes (Vanilla, SE, PE, GR): the loss/eval path, the train step with
the alignment curriculum (linear, anchored and EM warmups, the decoder
freeze) and the trainer around it (pattern datasets, the loader,
checkpoints with exact resume, the CLI), the ETL from wavs and the
Griffin-Lim export (``ops/stft.py``, ``ops/yin.py``, ``ops/vocoder.py``,
``data/pattern_generator.py``), with the decoder's flow step, its
coupling alone, the whole flow stack in one launch (the three routes of
``config.coupling_backend``), the monotonic
alignment search and the train-direction flow stack (forward and
backward) as CUDA kernels for Hopper (H100).

The port of ``glow_tts_tpu`` (JAX), which stays beside it as the
reference: same layouts at the public functions ([B, T, C]), same
reference state-dict names, tested against it on the CPU.  This package
imports torch and never jax.
"""

from glow_tts_tpu_torch.config import Config, load_config
from glow_tts_tpu_torch.data.collate import InferenceCollater, TrainCollater
from glow_tts_tpu_torch.inference import Inferencer
from glow_tts_tpu_torch.models.glow_tts import (GlowTTS, initial_state_dict,
                                                random_state_dict)
from glow_tts_tpu_torch.training.checkpoint import CheckpointManager
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import (EMState,
                                              attention_diagonality,
                                              batch_to_device, build_model,
                                              init_em_stats, make_eval_step,
                                              make_train_step)
from glow_tts_tpu_torch.training.trainer import Trainer

__all__ = ['CheckpointManager', 'Config', 'EMState', 'GlowTTS',
           'InferenceCollater', 'Inferencer', 'TrainCollater', 'Trainer',
           'attention_diagonality', 'batch_to_device', 'build_model',
           'init_em_stats', 'initial_state_dict', 'load_config',
           'make_eval_step', 'make_optimizer', 'make_train_step',
           'random_state_dict']
