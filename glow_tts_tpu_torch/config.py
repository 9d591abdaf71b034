"""The slice of the configuration that the PyTorch port reads.

It loads the same YAML schema as ``glow_tts_tpu.config.load_config``
(``configs/Hyper_Parameters.yaml``) and exposes the same attribute names
(``config.encoder.channels``, ``config.decoder.affine_coupling`` …), so
either object drives the port.  Only the fields of serving in the four
modes (Vanilla, SE, PE, GR: the conditioning encoders' widths), of the
loss/eval path, of the train step (dropout rates, optimiser) and of the
trainer (pattern sets, intervals, output paths, the alignment curriculum)
are kept; unknown keys are ignored, as there.  ``TPU.data_parallel`` is
the number of processes, one per card, that train on shares of the global
batch (0: every visible card; ``parallel/data.py``); a batch that does
not divide by it raises.  ``TPU.model_parallel`` is the size of the model
groups that tensor parallelism shards the model over
(``parallel/tp.py``): a run is ``data_parallel × model_parallel``
processes.  The precision fields are the JAX
package's (``TPU.compute_dtype``, ``param_dtype``, ``inference_dtype``,
and the reference's ``Use_Mixed_Precision`` where the ``TPU`` section
names no compute dtype): training and evaluation compute at
``compute_dtype``, float32 or bfloat16, serving at ``inference_dtype or
compute_dtype``, and the parameters stay float32; any other dtype raises
(A.5).  A CPU test holds every field against
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
import warnings
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

import yaml

MODES = ('VANILLA', 'SE', 'PE', 'GR')


@dataclass(frozen=True)
class SoundConfig:
    spectrogram_dim: int = 1025
    mel_dim: int = 80
    frame_length: int = 1024
    frame_shift: int = 256
    sample_rate: int = 24000
    mel_f_min: int = 125
    mel_f_max: int = 7600
    max_abs_mel: float = 4.0
    confidence_threshold: float = 0.6
    gaussian_smoothing_sigma: float = 0.0
    pitch_min: float = 100.0
    pitch_max: float = 500.0


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
class GE2ELSTMConfig:
    sizes: int = 256
    stacks: int = 3


@dataclass(frozen=True)
class GE2EInferenceConfig:
    samples: int = 5
    slice_length: int = 64
    overlap_length: int = 32


@dataclass(frozen=True)
class GE2EConfig:
    lstm: GE2ELSTMConfig = field(default_factory=GE2ELSTMConfig)
    inference: GE2EInferenceConfig = field(
        default_factory=GE2EInferenceConfig)
    checkpoint_path: Optional[str] = None


@dataclass(frozen=True)
class SpeakerEmbeddingConfig:
    type: str = 'LUT'           # 'LUT' | 'GE2E'
    num_speakers: int = 109
    embedding_size: int = 256
    ge2e: GE2EConfig = field(default_factory=GE2EConfig)


@dataclass(frozen=True)
class ReferenceEncoderConvConfig:
    kernel_size: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    channels: Tuple[int, ...] = (32, 32, 64, 64, 128, 128)
    strides: Tuple[int, ...] = (2, 2, 2, 2, 2, 2)


@dataclass(frozen=True)
class ReferenceEncoderGRUConfig:
    size: int = 128
    stacks: int = 1


@dataclass(frozen=True)
class ReferenceEncoderConfig:
    conv: ReferenceEncoderConvConfig = field(
        default_factory=ReferenceEncoderConvConfig)
    gru: ReferenceEncoderGRUConfig = field(
        default_factory=ReferenceEncoderGRUConfig)


@dataclass(frozen=True)
class StyleTokenConfig:
    num_tokens: int = 128
    size: int = 256
    attention_head: int = 4


@dataclass(frozen=True)
class ProsodyEncoderConfig:
    size: int = 256
    reference_encoder: ReferenceEncoderConfig = field(
        default_factory=ReferenceEncoderConfig)
    style_token: StyleTokenConfig = field(default_factory=StyleTokenConfig)


@dataclass(frozen=True)
class SpeakerClassifierConfig:
    channels: Tuple[int, ...] = (256,)


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
    adversarial_speaker_weight: float = 0.0005
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
    # PE and GR: steps between two GST embedding projectors of the eval
    # set's sampled speakers (``Trainer.prosody_check``)
    prosody_check_interval: int = 5000
    # The alignment curriculum, as the JAX package's ``TrainConfig`` has it
    # (its comments give the measurements behind each field).  For the
    # first ``alignment_warmup_steps`` steps the path comes from the warmup
    # instead of learned-prior MAS: ``'linear'`` the uniform path,
    # ``'anchored'`` MAS over a pause/silence-anchored guided-diagonal
    # score, ``'em'`` MAS over a closed-form per-token-ID Gaussian table
    # fitted to the detached z from the anchored path, with the network
    # prior distilled onto the table; 0 is MAS from the first step.
    alignment_warmup_steps: int = 0
    alignment_warmup_mode: str = 'linear'
    # 'em': decay of the table statistics' running sums across steps, and
    # the weight of the distillation loss
    em_stats_decay: float = 0.875
    em_distill_weight: float = 1.0
    # 'anchored', 'em': the token ids of pauses, and the frame channel-mean
    # below which a frame is silent (on the ±max_abs_mel scale)
    anchor_pause_tokens: Tuple[int, ...] = ()
    anchor_silence_level: float = -3.5
    # the flow decoder's updates are zero for the first N steps (its
    # gradients and the optimiser's moments are not)
    decoder_freeze_steps: int = 0

    def __post_init__(self):
        # a typo'd mode would train the warmup steps with plain
        # learned-prior MAS, the cold start the curriculum exists to avoid
        valid = ('linear', 'anchored', 'em')
        if self.alignment_warmup_mode not in valid:
            raise ValueError(
                f'Train.Alignment_Warmup_Mode must be one of {valid}, '
                f'got {self.alignment_warmup_mode!r}')

    @property
    def uses_em_stats(self) -> bool:
        """The run carries the 'em' warmup's table statistics."""
        return (self.alignment_warmup_steps > 0
                and self.alignment_warmup_mode == 'em')


COUPLING_BACKENDS = ('auto', 'fused', 'mega', 'modules')
# the compute dtypes the port runs: the JAX package's kernels know these
# two alone (``glow_tts_tpu/ops/coupling_grad.py``'s ``gdt``)
COMPUTE_DTYPES = ('float32', 'bfloat16')


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
    mode: str = 'Vanilla'       # 'Vanilla' | 'SE' | 'PE' | 'GR'
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    speaker_embedding: SpeakerEmbeddingConfig = field(
        default_factory=SpeakerEmbeddingConfig)
    prosody_encoder: ProsodyEncoderConfig = field(
        default_factory=ProsodyEncoderConfig)
    speaker_classifier_gr: SpeakerClassifierConfig = field(
        default_factory=SpeakerClassifierConfig)
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
    # the precision policy (the YAML's ``TPU`` fields, the JAX package's
    # defaults): activations and products of training and evaluation at
    # ``compute_dtype``, parameters at ``param_dtype``, serving at
    # ``inference_dtype or compute_dtype``; logdets, the prior likelihood,
    # MAS and the losses stay float32 at any of them
    compute_dtype: str = 'bfloat16'
    param_dtype: str = 'float32'
    inference_dtype: Optional[str] = 'float32'
    # data parallelism (the YAML's ``TPU.data_parallel``): the number of
    # processes, one per card, that share the global ``Train.Batch_Size``;
    # 0 is every visible card (``parallel/data.py``)
    data_parallel: int = 0
    # tensor parallelism (``TPU.model_parallel``): the ranks of a model
    # group, over which the model is sharded (``parallel/tp.py``)
    model_parallel: int = 1

    def __post_init__(self):
        if self.mode.upper() not in MODES:
            raise ValueError(f'Mode must be one of Vanilla, SE, PE, GR; '
                             f'got {self.mode!r}')
        if self.uses_speaker_embedding and \
                self.speaker_embedding.type.upper() not in ('LUT', 'GE2E'):
            raise ValueError(f'Speaker_Embedding.Type must be LUT or GE2E, '
                             f'got {self.speaker_embedding.type!r}')
        if self.mode.upper() == 'GR' and (
                self.speaker_embedding.embedding_size
                != self.prosody_encoder.size):
            raise ValueError('in GR mode Speaker_Embedding.Embedding_Size '
                             'and Prosody_Encoder.Size must match')
        object.__setattr__(self, 'coupling_backend',
                           coupling_backend_name(self.coupling_backend))
        for name in ('compute_dtype', 'inference_dtype'):
            value = getattr(self, name)
            if value is not None and value not in COMPUTE_DTYPES:
                raise ValueError(
                    f'TPU.{name} must be one of {COMPUTE_DTYPES}, got '
                    f'{value!r}: the port computes at these (ROADMAP.md '
                    f'A.5)')
        if self.param_dtype != 'float32':
            raise ValueError(f'TPU.param_dtype must be float32, got '
                             f'{self.param_dtype!r} (ROADMAP.md A.5)')
        if self.data_parallel < 0:
            raise ValueError(f'TPU.data_parallel must be 0 (every card) or '
                             f'a process count, got {self.data_parallel}')
        if self.data_parallel and self.train.batch_size % self.data_parallel:
            raise ValueError(f'global batch size {self.train.batch_size} '
                             f'must divide by TPU.data_parallel '
                             f'{self.data_parallel}')

    @property
    def uses_speaker_embedding(self) -> bool:
        return self.mode.upper() in ('SE', 'GR')

    @property
    def uses_ge2e(self) -> bool:
        """The speaker vector comes from the GE2E encoder (else the LUT)."""
        return (self.uses_speaker_embedding
                and self.speaker_embedding.type.upper() == 'GE2E')

    @property
    def uses_prosody_encoder(self) -> bool:
        return self.mode.upper() in ('PE', 'GR')

    @property
    def uses_gradient_reversal(self) -> bool:
        """GR mode: the adversarial classifier and the pitch operand."""
        return self.mode.upper() == 'GR'

    @property
    def condition_size(self) -> int:
        """Width of the conditioning vector the duration predictor takes
        (0 in Vanilla mode)."""
        if self.uses_speaker_embedding:
            return self.speaker_embedding.embedding_size
        if self.uses_prosody_encoder:
            return self.prosody_encoder.size
        return 0

    @property
    def serve_dtype(self) -> str:
        """The dtype serving computes at: ``inference_dtype``, else
        ``compute_dtype`` (``glow_tts_tpu/training/step.py``'s rule)."""
        return self.inference_dtype or self.compute_dtype

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
        if sub is not None and isinstance(value, Mapping):
            value = _coerce(sub, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


_SECTIONS = {cls.__name__: cls for cls in (
    SoundConfig, PrenetConfig, AttentionConfig, TransformerConvConfig,
    TransformerConfig, DurationPredictorConfig, EncoderConfig, WaveNetConfig,
    AffineCouplingConfig, DecoderConfig, GE2ELSTMConfig, GE2EInferenceConfig,
    GE2EConfig, SpeakerEmbeddingConfig, ReferenceEncoderConvConfig,
    ReferenceEncoderGRUConfig, ReferenceEncoderConfig, StyleTokenConfig,
    ProsodyEncoderConfig, SpeakerClassifierConfig, PatternConfig,
    LearningRateConfig, AdamConfig, TrainConfig)}


# the fields the YAML keeps under ``TPU``
_TPU_FIELDS = ('token_bucket', 'mel_bucket', 'coupling_backend',
               'compute_dtype', 'param_dtype', 'inference_dtype',
               'data_parallel', 'model_parallel')


def _section(data: Mapping, name: str) -> Mapping:
    """``data``'s section ``name``, its keys lower-cased (empty if none)."""
    section = data.get(name) or data.get(name.lower()) or {}
    return {str(key).lower(): value for key, value in section.items()}


_WARNED = set()


def _warn_once(key: str, message: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(message, stacklevel=4)


def load_config(path_or_dict) -> Config:
    """Load from a ``Hyper_Parameters.yaml`` path or an equivalent dict.
    The reference's ``Use_Mixed_Precision`` gives the compute dtype where the
    ``TPU`` section names none (``true``: bfloat16).  Raises ``ValueError``
    on an unknown ``Train.Alignment_Warmup_Mode`` and on a dtype the port
    does not compute at."""
    if isinstance(path_or_dict, Mapping):
        data = path_or_dict
    else:
        with open(path_or_dict, encoding='utf-8') as f:
            data = yaml.safe_load(f)
    config = _coerce(Config, data)
    tpu = data.get('TPU') or data.get('tpu') or {}
    from_tpu = {name: tpu[name] for name in _TPU_FIELDS if name in tpu}
    for name, empty in (('data_parallel', 0), ('model_parallel', 1)):
        if name in from_tpu:
            from_tpu[name] = int(from_tpu[name] or empty)
    if 'compute_dtype' not in from_tpu and 'Use_Mixed_Precision' in data:
        from_tpu['compute_dtype'] = ('bfloat16' if data['Use_Mixed_Precision']
                                     else 'float32')
    return dataclasses.replace(config, **from_tpu)


def save_config(config: Config, path: str) -> None:
    """Write ``config`` as YAML (the snapshot beside checkpoints), in the
    schema :func:`load_config` reads: lower-case keys, the bucket, backend,
    dtype and parallel fields under ``tpu`` as the JAX package's snapshot
    has them."""
    data = dataclasses.asdict(config)
    data['tpu'] = {name: data.pop(name) for name in _TPU_FIELDS}
    with open(path, 'w', encoding='utf-8') as f:
        yaml.safe_dump(data, f, sort_keys=False)
