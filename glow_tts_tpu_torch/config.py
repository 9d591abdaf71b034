"""The slice of the configuration that the PyTorch port reads.

It loads the same YAML schema as ``glow_tts_tpu.config.load_config``
(``configs/Hyper_Parameters.yaml``) and exposes the same attribute names
(``config.encoder.channels``, ``config.decoder.affine_coupling`` …), so
either object drives the port.  Only the fields of Vanilla-mode serving,
of the loss/eval path, of the train step (dropout rates, optimiser) and of
the trainer (pattern sets, intervals, output paths) are kept; unknown keys
are ignored, as there.  A CPU test holds every field against
``glow_tts_tpu.config`` on the same input.  :func:`save_config` writes the
snapshot a checkpoint directory carries, which :func:`load_config` reads
back to an equal ``Config``.

``coupling_backend`` chooses the route of the deterministic flow decoder
(serving, evaluation), each route through its own CUDA kernel on the card
(``ops/coupling.py``) and through that kernel's plain version on the CPU:
``'fused'`` one ``flow_step`` call per flow step, ``'mega'`` one
``flow_stack`` call for the whole stack, ``'modules'`` ActNorm, invertible
1×1 and ``coupling`` as three modules per step; ``'auto'`` is ``'fused'``.
Training goes through ``ops.coupling_grad.flow_stack_train`` under every
value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

import yaml


@dataclass(frozen=True)
class SoundConfig:
    spectrogram_dim: int = 1025
    mel_dim: int = 80
    frame_length: int = 1024
    frame_shift: int = 256
    sample_rate: int = 24000
    max_abs_mel: float = 4.0


@dataclass(frozen=True)
class PrenetConfig:
    kernel_size: int = 5
    dropout_rate: float = 0.5
    stacks: int = 3


@dataclass(frozen=True)
class AttentionConfig:
    heads: int = 2
    window_size: int = 4


@dataclass(frozen=True)
class TransformerConvConfig:
    kernel_size: int = 3
    calc_channels: int = 768


@dataclass(frozen=True)
class TransformerConfig:
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    conv: TransformerConvConfig = field(default_factory=TransformerConvConfig)
    dropout_rate: float = 0.1
    stacks: int = 6


@dataclass(frozen=True)
class DurationPredictorConfig:
    kernel_size: int = 3
    channels: int = 256
    stacks: int = 2
    dropout_rate: float = 0.1


@dataclass(frozen=True)
class EncoderConfig:
    channels: int = 192
    embedding_tokens: int = 35
    prenet: PrenetConfig = field(default_factory=PrenetConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    duration_predictor: DurationPredictorConfig = field(
        default_factory=DurationPredictorConfig)


@dataclass(frozen=True)
class WaveNetConfig:
    num_layers: int = 4
    kernel_size: int = 5
    dropout_rate: float = 0.05


@dataclass(frozen=True)
class AffineCouplingConfig:
    calc_channels: int = 192
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)


@dataclass(frozen=True)
class DecoderConfig:
    stack: int = 12
    num_squeeze: int = 2
    num_split: int = 4
    affine_coupling: AffineCouplingConfig = field(
        default_factory=AffineCouplingConfig)


@dataclass(frozen=True)
class PatternConfig:
    path: str = './patterns/Train'
    metadata_file: str = 'METADATA.PICKLE'
    mel_length_min: int = 50
    mel_length_max: int = 1000
    text_length_min: int = 10
    text_length_max: int = 200
    accumulated_dataset_epoch: int = 1


@dataclass(frozen=True)
class LearningRateConfig:
    initial: float = 1.0e-3
    base: int = 4000


@dataclass(frozen=True)
class AdamConfig:
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1.0e-6


@dataclass(frozen=True)
class TrainConfig:
    use_pattern_cache: bool = True
    train_pattern: PatternConfig = field(default_factory=PatternConfig)
    eval_pattern: PatternConfig = field(
        default_factory=lambda: PatternConfig(path='./patterns/Eval'))
    num_workers: int = 4
    batch_size: int = 32
    learning_rate: LearningRateConfig = field(
        default_factory=LearningRateConfig)
    adam: AdamConfig = field(default_factory=AdamConfig)
    weight_decay: float = 1.0e-6
    gradient_norm: float = 5.0
    max_step: int = 400000
    checkpoint_save_interval: int = 1000
    logging_interval: int = 100
    evaluation_interval: int = 1000
    inference_interval: int = 1000
    initial_inference: bool = False
    inference_pattern_file_in_train: Optional[str] = None


COUPLING_BACKENDS = ('auto', 'fused', 'mega', 'modules')


def coupling_backend_name(value: str) -> str:
    """A ``TPU.coupling_backend`` of the YAML as the port names it: the
    JAX package's ``'flax'`` is ``'modules'``, and an ``'*_interpret'``
    value is its base name (the port has no interpreter: the tensor's
    device picks kernel or plain version)."""
    name = str(value)
    if name.endswith('_interpret'):
        name = name[:-len('_interpret')]
    name = 'modules' if name == 'flax' else name
    if name not in COUPLING_BACKENDS:
        raise ValueError(f'coupling_backend must be one of '
                         f'{COUPLING_BACKENDS} (or flax, *_interpret), '
                         f'got {value!r}')
    return name


@dataclass(frozen=True)
class Config:
    sound: SoundConfig = field(default_factory=SoundConfig)
    mode: str = 'Vanilla'
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    token_path: str = './Token.yaml'
    inference_batch_size: Optional[int] = None
    inference_path: str = './results/Inference'
    checkpoint_path: str = './results/Checkpoint'
    log_path: str = './results/Log'
    # token axis padded up to a multiple of this (the YAML's
    # ``TPU.token_bucket``): one padded shape per length class
    token_bucket: int = 32
    # mel axis of a training batch padded up to a multiple of this (the
    # YAML's ``TPU.mel_bucket``)
    mel_bucket: int = 128
    # route of the deterministic flow decoder (the YAML's
    # ``TPU.coupling_backend``), one of COUPLING_BACKENDS
    coupling_backend: str = 'auto'

    def __post_init__(self):
        object.__setattr__(self, 'coupling_backend',
                           coupling_backend_name(self.coupling_backend))

    @property
    def flow_route(self) -> str:
        """``coupling_backend`` with ``'auto'`` resolved: ``'fused'``,
        ``'mega'`` or ``'modules'``."""
        return ('fused' if self.coupling_backend == 'auto'
                else self.coupling_backend)


def _coerce(cls: type, data: Optional[Mapping]) -> Any:
    """Build dataclass ``cls`` from a mapping whose keys are the YAML's
    ``Title_Case`` names or their lower-case forms."""
    if data is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        name = key.lower()
        if name not in fields:
            # a pattern set's ``Mel_Length: {Min, Max}`` block fills the
            # flat ``mel_length_min`` / ``mel_length_max`` fields
            if isinstance(value, Mapping) and all(
                    f'{name}_{k.lower()}' in fields for k in value):
                kwargs.update({f'{name}_{k.lower()}': v
                               for k, v in value.items()})
            continue
        ftype = fields[name].type
        sub = _SECTIONS.get(ftype)
        kwargs[name] = (_coerce(sub, value) if sub is not None
                        and isinstance(value, Mapping) else value)
    return cls(**kwargs)


_SECTIONS = {cls.__name__: cls for cls in (
    SoundConfig, PrenetConfig, AttentionConfig, TransformerConvConfig,
    TransformerConfig, DurationPredictorConfig, EncoderConfig, WaveNetConfig,
    AffineCouplingConfig, DecoderConfig, PatternConfig, LearningRateConfig,
    AdamConfig, TrainConfig)}


# the fields the YAML keeps under ``TPU``
_TPU_FIELDS = ('token_bucket', 'mel_bucket', 'coupling_backend')


def load_config(path_or_dict) -> Config:
    """Load from a ``Hyper_Parameters.yaml`` path or an equivalent dict."""
    if isinstance(path_or_dict, Mapping):
        data = path_or_dict
    else:
        with open(path_or_dict, encoding='utf-8') as f:
            data = yaml.safe_load(f)
    config = _coerce(Config, data)
    if config.mode.upper() != 'VANILLA':
        raise NotImplementedError(
            f'the PyTorch port serves Vanilla mode only (got {config.mode!r})')
    tpu = data.get('TPU') or data.get('tpu') or {}
    from_tpu = {name: tpu[name] for name in _TPU_FIELDS if name in tpu}
    return dataclasses.replace(config, **from_tpu)


def save_config(config: Config, path: str) -> None:
    """Write ``config`` as YAML (the snapshot beside checkpoints), in the
    schema :func:`load_config` reads: lower-case keys, the bucket and
    backend fields under ``tpu`` as the JAX package's snapshot has them."""
    data = dataclasses.asdict(config)
    data['tpu'] = {name: data.pop(name) for name in _TPU_FIELDS}
    with open(path, 'w', encoding='utf-8') as f:
        yaml.safe_dump(data, f, sort_keys=False)
