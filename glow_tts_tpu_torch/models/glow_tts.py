"""Glow-TTS (port of ``glow_tts_tpu/models/glow_tts.py``), in the four
modes: Vanilla, SE (a speaker vector from the look-up table or the GE2E
encoder), PE (a GST prosody vector from a reference mel) and GR (both, the
adversarial speaker classifier and the pitch operand).  The train forward
(:meth:`GlowTTS.forward`: conditioning, encoder prior, forward flow with its
logdet, prior log-likelihood, MAS) is deterministic for the loss and eval
path and has dropout and gradients for the train step, in every mode, and
takes the alignment curriculum's warmup paths (:func:`linear_alignment_path`,
:func:`anchored_alignment_path`, :func:`em_alignment_path` with its token
table, :func:`fit_token_table` and :func:`table_prior_log_likelihood`);
serving is two-phase.  The GE2E speaker encoder is pre-trained and frozen,
as in the JAX package: its parameters require no gradient (so the
optimiser leaves them out) and it runs without autograd.

The model computes at its ``dtype`` (``GlowTTS(config, dtype)``, float32
unless given; ``training.step.build_model`` passes
``config.compute_dtype``), an attribute of its modules and not of its
parameters, which stay float32, so one state dict serves a bfloat16 train
model and a float32 serving model (:meth:`GlowTTS.set_compute_dtype`).  At
bfloat16 the JAX package's float32 islands stay float32 here too: the
prior log-likelihood and MAS, the EM table, the expansion of mean and log
std along the path, the logdets and the losses.

Serving has two phases, as the JAX package serves: :meth:`GlowTTS.inference_prior`
does the token-length work (conditioning, encoder prior, ceiled
durations), the host picks a mel bucket from the summed durations, and
:meth:`GlowTTS.inference_decode` does the mel-capacity work (hard path,
z sample, pitch resampled to the bucket, inverse flow).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from glow_tts_tpu_torch.models.conditioning import (
    GE2ESpeakerEncoder, GSTProsodyEncoder, SpeakerClassifier,
    interpolate_pitch)
from glow_tts_tpu_torch.models.decoder import (
    ActNorm, FlowDecoder, FlowStackFn, FlowStepFn, InvertibleConv)
from glow_tts_tpu_torch.models.encoder import TextEncoder
from glow_tts_tpu_torch.models.layers import (
    Conv1d, RelativePositionMultiHeadAttention, WNConv1d, fold_weight_norm,
    sequence_mask, set_compute_dtype)
from glow_tts_tpu_torch.ops.coupling import coupling, flow_stack, flow_step
from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
from glow_tts_tpu_torch.ops.mas import maximum_path
from glow_tts_tpu_torch.ops.precision import torch_dtype

LOG_2PI = 1.8378770664093453  # log(2π)
MasFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def prior_log_likelihood(mean: torch.Tensor, log_std: torch.Tensor,
                         z: torch.Tensor,
                         attn_mask: torch.Tensor) -> torch.Tensor:
    """log N(z_j; mean_i, std_i) summed over mel channels, for every
    (token i, frame j) pair, as two batched matrix products.

    mean, log_std: [B, T_tok, M]; z: [B, T_mel, M];
    attn_mask: [B, T_tok, T_mel].  Returns [B, T_tok, T_mel] float32."""
    mean, log_std, z = mean.float(), log_std.float(), z.float()
    inv_var = torch.exp(-2.0 * log_std)                     # [B, T_tok, M]
    t_const = torch.sum(-0.5 * LOG_2PI - log_std, dim=-1)   # [B, T_tok]
    t_mean = torch.sum(-0.5 * mean * mean * inv_var, dim=-1)
    quad = torch.einsum('bim,bjm->bij', inv_var, -0.5 * z * z)
    cross = torch.einsum('bim,bjm->bij', mean * inv_var, z)
    return ((t_const + t_mean)[:, :, None] + quad + cross) * attn_mask


def generate_path(durations: torch.Tensor,
                  attn_mask: torch.Tensor) -> torch.Tensor:
    """Hard monotonic alignment from durations: durations [B, T_tok],
    attn_mask [B, T_tok, T_mel] → path [B, T_tok, T_mel] of 0/1."""
    cum = torch.cumsum(durations, dim=1)
    frames = torch.arange(attn_mask.shape[-1], device=durations.device)
    ends = (frames[None, None, :] < cum[:, :, None]).to(attn_mask.dtype)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    return (ends - starts) * attn_mask


def linear_alignment_path(token_lengths: torch.Tensor,
                          mel_lengths: torch.Tensor,
                          attn_mask: torch.Tensor) -> torch.Tensor:
    """The 'linear' warmup's uniform left-to-right path: token ``i`` of a
    length-``L`` utterance of ``T`` frames owns frames ``[floor(i·T/L),
    floor((i+1)·T/L))``, in float32 as the JAX package computes it.
    attn_mask [B, T_tok, T_mel] → path [B, T_tok, T_mel]."""
    t_tok = attn_mask.shape[1]
    device = attn_mask.device
    tl = token_lengths.float().clamp_min(1.0)[:, None]
    ml = mel_lengths.float()[:, None]
    i = torch.arange(t_tok, dtype=torch.float32, device=device)[None, :]
    cum = torch.where(i < tl, torch.floor((i + 1.0) * ml / tl), ml)
    durations = cum - F.pad(cum, (1, 0))[:, :-1]
    return generate_path(durations, attn_mask)


def anchored_alignment_path(tokens: torch.Tensor,
                            token_lengths: torch.Tensor,
                            mels: torch.Tensor, mel_lengths: torch.Tensor,
                            attn_mask: torch.Tensor,
                            pause_tokens: Sequence[int],
                            silence_level: float, mas_fn: MasFn,
                            anchor_weight: float = 2.0,
                            diag_weight: float = 10.0) -> torch.Tensor:
    """The 'anchored' warmup's path: ``mas_fn`` on a surrogate score of
    ±``anchor_weight`` where "this token is a pause" (``tokens`` in
    ``pause_tokens``) agrees or not with "this frame is silent" (its
    channel mean below ``silence_level``), plus the guided-attention
    diagonal −``diag_weight``·(i/L − j/T)².  ``mels [B, T, M]`` on the raw
    timeline are cut to the decoder's ``attn_mask.shape[-1]`` frames."""
    t_mel = attn_mask.shape[-1]
    device = attn_mask.device
    frame_energy = mels[:, :t_mel].float().mean(dim=-1)           # [B, T_mel]
    is_sil = frame_energy < silence_level
    is_pause = torch.zeros(tokens.shape, dtype=torch.bool, device=device)
    for pid in pause_tokens:
        is_pause = is_pause | (tokens == pid)                     # [B, T_tok]
    agree = is_pause[:, :, None] == is_sil[:, None, :]
    anchor = torch.where(agree, anchor_weight, -anchor_weight)

    tl = token_lengths.float().clamp_min(1.0)
    ml = mel_lengths.float().clamp_min(1.0)
    i_norm = ((torch.arange(attn_mask.shape[1], dtype=torch.float32,
                            device=device)[None, :] + 0.5) / tl[:, None])
    j_norm = ((torch.arange(t_mel, dtype=torch.float32,
                            device=device)[None, :] + 0.5) / ml[:, None])
    diag = -diag_weight * torch.square(i_norm[:, :, None]
                                       - j_norm[:, None, :])
    score = (anchor + diag) * attn_mask
    return mas_fn(score, token_lengths, mel_lengths)


EMStats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
StatsReduce = Callable[[EMStats], Sequence[torch.Tensor]]


def fit_token_table(tokens: torch.Tensor, path: torch.Tensor,
                    z: torch.Tensor, mel_mask: torch.Tensor,
                    vocab: int) -> EMStats:
    """The hard-EM M-step's batch statistics: each valid frame belongs to
    the token the ``path [B, T_tok, T_mel]`` gives it, and count, sum and
    sum of squares of ``z [B, T_mel, C]`` are gathered per token *id*, as
    one-hot products.  Returns ``(cnt [V], s0 [V, C], s1 [V, C])``,
    float32.  Past a sample's length the path's column is zero, its argmax
    token 0, and ``mel_mask [B, T_mel, 1]`` takes the frame out."""
    owner = torch.argmax(path, dim=1)                             # [B, T_mel]
    ids = torch.gather(tokens.long(), 1, owner)                   # [B, T_mel]
    mask = mel_mask.float()
    onehot = F.one_hot(ids, vocab).float() * mask                 # [B, T, V]
    z32 = z.float() * mask
    cnt = onehot.sum(dim=(0, 1))
    s0 = torch.einsum('btv,btc->vc', onehot, z32)
    s1 = torch.einsum('btv,btc->vc', onehot, z32 * z32)
    return cnt, s0, s1


def table_prior_log_likelihood(tokens: torch.Tensor, z: torch.Tensor,
                               stats: EMStats, attn_mask: torch.Tensor):
    """The Gaussian log-likelihood score [B, T_tok, T_mel] of ``z`` under
    the per-token-id table of ``stats = (cnt, s0, s1)`` (mean ``s0/cnt``,
    variance ``s1/cnt − mean²`` floored at 1e-4), as const + quad + cross
    (two batched products, as :func:`prior_log_likelihood`), with the
    table's mean and log std at the batch's tokens, the distillation
    targets.  Returns ``(log_p, mean [B, T_tok, C], log_std [B, T_tok, C])``."""
    cnt, s0, s1 = stats
    cc = cnt.clamp_min(1.0)[:, None]                              # [V, 1]
    mu = s0 / cc
    var = torch.clamp(s1 / cc - mu * mu, min=1e-4)
    ids = tokens.long()
    m_tok, v_tok = mu[ids], var[ids]                              # [B, T, C]
    inv_v = 1.0 / v_tok
    z32 = z.float()
    const = torch.sum(-0.5 * torch.log(2.0 * math.pi * v_tok)
                      - 0.5 * m_tok * m_tok * inv_v, dim=-1)      # [B, T_tok]
    quad = torch.einsum('bic,bjc->bij', -0.5 * inv_v, z32 * z32)
    cross = torch.einsum('bic,bjc->bij', m_tok * inv_v, z32)
    log_p = (const[:, :, None] + quad + cross) * attn_mask
    return log_p, m_tok, 0.5 * torch.log(v_tok)


def em_alignment_path(tokens: torch.Tensor, token_lengths: torch.Tensor,
                      mels: torch.Tensor, mel_lengths: torch.Tensor,
                      z: torch.Tensor, attn_mask: torch.Tensor,
                      mel_mask: torch.Tensor, em_stats: EMStats, vocab: int,
                      pause_tokens: Sequence[int], silence_level: float,
                      stats_decay: float, mas_fn: MasFn,
                      reduce: Optional[StatsReduce] = None):
    """The 'em' warmup's path, on the detached ``z``: the anchored path
    (:func:`anchored_alignment_path`), the token table fitted to it and
    pooled with the running statistics (``decay · em_stats + batch``), MAS
    on the table's score (:func:`table_prior_log_likelihood`) as the
    training path, and the running statistics updated with the table fitted
    to that path.  Both MAS calls go through ``mas_fn``.  ``reduce`` maps
    each fitted table's statistics to the global batch's before they are
    merged (a sum over the data-parallel ranks, as the JAX package's sums
    run over the sharded global batch), so every rank holds the same table
    and its MAS reads the global fit.  Returns ``(path, new em_stats,
    distill_mean, distill_log_std)``, all without gradient: the
    distillation targets are constants of the loss."""
    reduce = reduce or tuple
    with torch.no_grad():
        z = z.detach()
        init_path = anchored_alignment_path(
            tokens, token_lengths, mels, mel_lengths, attn_mask,
            pause_tokens, silence_level, mas_fn)
        batch_stats = reduce(fit_token_table(tokens, init_path, z, mel_mask,
                                             vocab))
        merged = tuple(stats_decay * prev + cur
                       for prev, cur in zip(em_stats, batch_stats))
        log_p, m_tok, log_std_tok = table_prior_log_likelihood(
            tokens, z, merged, attn_mask)
        path = mas_fn(log_p, token_lengths, mel_lengths)
        final_stats = reduce(fit_token_table(tokens, path, z, mel_mask,
                                             vocab))
        new_stats = tuple(stats_decay * prev + cur
                          for prev, cur in zip(em_stats, final_stats))
    return path, new_stats, m_tok, log_std_tok


class GlowTTS(nn.Module):
    def __init__(self, config, dtype=torch.float32):
        super().__init__()
        self.config = config
        modules = {'Encoder': TextEncoder(config),
                   'Decoder': FlowDecoder(config)}
        cfg = config.speaker_embedding
        if config.uses_ge2e:
            # frozen (glow_tts_tpu/training/optim.py labels it so)
            modules['GE2E'] = GE2ESpeakerEncoder(config).requires_grad_(False)
        elif config.uses_speaker_embedding:
            modules['LUT'] = nn.Embedding(cfg.num_speakers,
                                          cfg.embedding_size)
        if config.uses_prosody_encoder:
            modules['Prosody_Encoder'] = GSTProsodyEncoder(config)
        if config.uses_gradient_reversal:
            modules['Speaker_Classifier_GR'] = SpeakerClassifier(config)
        self.layer_Dict = nn.ModuleDict(modules)
        self.set_compute_dtype(dtype)

    def set_compute_dtype(self, dtype) -> 'GlowTTS':
        """Compute at ``dtype`` (``'float32'``, ``'bfloat16'`` or a torch
        dtype) from now on, on the same parameters; the speaker classifier
        stays float32, as it has no dtype in the JAX package."""
        self.dtype = torch_dtype(dtype)
        set_compute_dtype(self, self.dtype)
        if 'Speaker_Classifier_GR' in self.layer_Dict:
            set_compute_dtype(self.layer_Dict['Speaker_Classifier_GR'],
                              torch.float32)
        return self

    @contextlib.contextmanager
    def computing_at(self, dtype):
        """Compute at ``dtype`` inside the block (the trainer's decode at
        the serving dtype), at the model's own dtype again after it."""
        before = self.dtype
        self.set_compute_dtype(dtype)
        try:
            yield self
        finally:
            self.set_compute_dtype(before)
    def conditions(self, mels: Optional[torch.Tensor] = None,
                   mel_lengths: Optional[torch.Tensor] = None,
                   speakers: Optional[torch.Tensor] = None,
                   mels_for_ge2e: Optional[torch.Tensor] = None):
        """The mode's conditioning vectors ``(speaker [B, E] | None,
        prosody [B, P] | None, classified speakers [B, speakers] | None)``:
        the speaker vector from ``speakers [B]`` (LUT) or ``mels_for_ge2e
        [B·S, T_slice, M]`` (GE2E), the prosody vector from the reference
        ``mels [B, T, M]`` and their lengths, and GR mode's classifier on
        the prosody vector.  The GE2E vector is computed without autograd
        (``stop_gradient`` in the JAX package)."""
        cfg, layers = self.config, self.layer_Dict
        speaker = prosody = classified = None
        if cfg.uses_ge2e:
            if mels_for_ge2e is None:
                raise ValueError('GE2E mode needs mels_for_ge2e')
            with torch.no_grad():
                speaker = layers['GE2E'].embed_utterances(mels_for_ge2e)
        elif cfg.uses_speaker_embedding:
            if speakers is None:
                raise ValueError('speaker-embedding mode needs speakers')
            speaker = layers['LUT'](speakers.long())
        if cfg.uses_prosody_encoder:
            if mels is None or mel_lengths is None:
                raise ValueError('prosody mode needs reference mels and '
                                 'their lengths')
            prosody = layers['Prosody_Encoder'](mels, mel_lengths)
        if cfg.uses_gradient_reversal:
            classified = layers['Speaker_Classifier_GR'](prosody)
        return speaker, prosody, classified

    @staticmethod
    def duration_condition(speaker: Optional[torch.Tensor],
                           prosody: Optional[torch.Tensor]
                           ) -> Optional[torch.Tensor]:
        """What the duration predictor reads: the sum of the conditioning
        vectors there are, or None."""
        vectors = [v for v in (speaker, prosody) if v is not None]
        return sum(vectors[1:], vectors[0]) if vectors else None

    @torch.no_grad()
    def prepare(self, fold: bool = True) -> 'GlowTTS':
        """Fix the loaded weights: fold weight norm (serving, evaluation)
        or keep ``weight_g``/``weight_v`` live (``fold=False``, training),
        and pack the flow-step kernel weights on the model's device.  Run
        after ``load_state_dict`` and ``.to(device)``."""
        fold_weight_norm(self, fold)
        self.layer_Dict['Decoder'].pack()
        return self.eval()

    def forward(self, tokens: torch.Tensor, token_lengths: torch.Tensor,
                mels: torch.Tensor, mel_lengths: torch.Tensor,
                step_fn: FlowStepFn = flow_step,
                mas_fn: MasFn = maximum_path, deterministic: bool = True,
                seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                stack_fn: FlowStackFn = flow_stack_train,
                coupling_fn: FlowStepFn = coupling,
                flow_stack_fn: FlowStepFn = flow_stack,
                speakers: Optional[torch.Tensor] = None,
                mels_for_ge2e: Optional[torch.Tensor] = None,
                pitches: Optional[torch.Tensor] = None,
                linear_alignment: bool = False,
                anchored_alignment: bool = False,
                em_alignment: bool = False,
                em_stats: Optional[EMStats] = None,
                em_reduce: Optional[StatsReduce] = None
                ) -> Dict[str, torch.Tensor]:
        """The train forward: tokens [B, T_tok] int, mels [B, T_mel, M],
        lengths [B] int (mel lengths multiples of ``num_squeeze``).  MAS
        runs on detached statistics and is not differentiated through.
        The conditioned modes take ``speakers [B]`` (LUT), ``mels_for_ge2e
        [B·S, T_slice, M]`` (GE2E) and, in GR mode, ``pitches [B, T_mel]``;
        the prosody vector comes from ``mels``.  GR mode also returns the
        classifier's ``classified_speakers [B, speakers]``, which reads the
        prosody vector through the gradient reversal.
        ``step_fn``, ``coupling_fn``, ``flow_stack_fn``, ``stack_fn`` and
        ``mas_fn`` are the kernels' wrappers unless a caller compares them
        with their plain versions.

        Deterministic (the default) there is no dropout and the flow runs
        by the route of ``config.coupling_backend`` through ``step_fn``,
        ``coupling_fn`` or ``flow_stack_fn``, which have no backward: on
        the card that is for ``torch.no_grad()``.  ``deterministic=False`` is
        the train step's forward: encoder dropout from ``generator`` (on
        the tensors' device), the flow through ``stack_fn`` with WaveNet
        dropout from the int32 ``seed``, differentiable throughout.

        The alignment curriculum's warmup takes the path from elsewhere than
        learned-prior MAS: ``linear_alignment`` the uniform path,
        ``anchored_alignment`` MAS on the anchored score, ``em_alignment``
        the EM table's path from the running ``em_stats`` (``(cnt, s0,
        s1)``), which also returns ``em_stats`` updated and what the
        distillation loss reads: ``prior_mean``, ``prior_log_std``,
        ``distill_mean``, ``distill_log_std`` and ``token_mask``;
        ``em_reduce`` (:func:`em_alignment_path`'s ``reduce``) sums the
        fitted statistics over the data-parallel ranks.  Every MAS call
        goes through ``mas_fn``."""
        token_lengths = token_lengths.to(torch.int32)
        mel_lengths = mel_lengths.to(torch.int32)
        token_mask = sequence_mask(token_lengths, tokens.shape[1])
        mel_mask = sequence_mask(mel_lengths, mels.shape[1])
        speaker, prosody, classified = self.conditions(
            mels, mel_lengths, speakers, mels_for_ge2e)
        pitch = pitches if self.config.uses_gradient_reversal else None

        mean, log_std, log_durations = self.layer_Dict['Encoder'](
            tokens, token_mask, self.duration_condition(speaker, prosody),
            deterministic, generator)
        z, log_dets, mel_mask = self.layer_Dict['Decoder'](
            mels, mel_mask, step_fn=step_fn, deterministic=deterministic,
            seed=seed, stack_fn=stack_fn, coupling_fn=coupling_fn,
            flow_stack_fn=flow_stack_fn, speaker=speaker, prosody=prosody,
            pitch=pitch)

        attn_mask = token_mask * mel_mask[:, None, :, 0]    # [B,T_tok,T_mel]
        train = self.config.train
        em_out = {}
        with torch.no_grad():
            if em_alignment:
                attentions, new_stats, distill_mean, distill_log_std = \
                    em_alignment_path(
                        tokens, token_lengths, mels, mel_lengths, z,
                        attn_mask, mel_mask, em_stats,
                        self.config.encoder.embedding_tokens,
                        train.anchor_pause_tokens,
                        train.anchor_silence_level, train.em_stats_decay,
                        mas_fn, em_reduce)
                em_out = {'em_stats': new_stats, 'prior_mean': mean,
                          'prior_log_std': log_std,
                          'distill_mean': distill_mean,
                          'distill_log_std': distill_log_std,
                          'token_mask': token_mask}
            elif linear_alignment:
                attentions = linear_alignment_path(token_lengths,
                                                   mel_lengths, attn_mask)
            elif anchored_alignment:
                attentions = anchored_alignment_path(
                    tokens, token_lengths, mels, mel_lengths, attn_mask,
                    train.anchor_pause_tokens, train.anchor_silence_level,
                    mas_fn)
            else:
                log_p = prior_log_likelihood(mean, log_std, z, attn_mask)
                attentions = mas_fn(log_p, token_lengths, mel_lengths)

        # float32 sums of the (possibly bfloat16) prior along the path
        mel_mean = torch.einsum('bim,bij->bjm', mean.float(), attentions)
        mel_log_std = torch.einsum('bim,bij->bjm', log_std.float(),
                                   attentions)
        durations = attentions.sum(dim=-1, keepdim=True)    # [B, T_tok, 1]
        log_duration_targets = torch.log(durations + 1e-7) * token_mask
        out = {'z': z, 'mel_mean': mel_mean, 'mel_log_std': mel_log_std,
               'log_dets': log_dets, 'log_durations': log_durations,
               'log_duration_targets': log_duration_targets,
               'attentions': attentions, 'mel_mask': mel_mask, **em_out}
        if classified is not None:
            out['classified_speakers'] = classified
        return out

    @torch.no_grad()
    def data_dependent_init(self, mels: torch.Tensor,
                            mel_lengths: torch.Tensor,
                            step_fn: FlowStepFn = flow_step,
                            speakers: Optional[torch.Tensor] = None,
                            mels_for_ge2e: Optional[torch.Tensor] = None,
                            pitches: Optional[torch.Tensor] = None
                            ) -> 'GlowTTS':
        """Initialise every flow step's ActNorm from the batch
        ``mels [B, T_mel, M]`` and the mode's conditioning (as
        :meth:`forward` takes it), as training starts (the JAX package does
        it inside ``create_train_state``).  Run after :meth:`prepare`."""
        mel_mask = sequence_mask(mel_lengths, mels.shape[1])
        speaker, prosody, _ = self.conditions(mels, mel_lengths, speakers,
                                              mels_for_ge2e)
        self.layer_Dict['Decoder'].data_dependent_init(
            mels, mel_mask, step_fn, speaker, prosody,
            pitches if self.config.uses_gradient_reversal else None)
        return self

    @torch.no_grad()
    def encode_prosody(self, mels: torch.Tensor,
                       mel_lengths: torch.Tensor) -> torch.Tensor:
        """The GST prosody vectors ``[B, P]`` of reference ``mels [B, T,
        M]`` and their lengths, at the model's compute dtype, without
        autograd (PE and GR; the trainer's prosody check)."""
        if not self.config.uses_prosody_encoder:
            raise ValueError(f'{self.config.mode} mode has no prosody '
                             f'encoder (PE and GR have)')
        return self.layer_Dict['Prosody_Encoder'](mels, mel_lengths)

    @torch.no_grad()
    def inference_prior(self, tokens: torch.Tensor,
                        token_lengths: torch.Tensor,
                        length_scale: Union[float, torch.Tensor] = 1.0,
                        mels_for_prosody: Optional[torch.Tensor] = None,
                        mel_lengths_for_prosody: Optional[torch.Tensor] = None,
                        speakers: Optional[torch.Tensor] = None,
                        mels_for_ge2e: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """Phase 1: the mode's conditioning (``speakers [B]``,
        ``mels_for_ge2e``, the reference ``mels_for_prosody [B, T, M]`` and
        their lengths), the encoder prior and the scaled integer durations.
        The conditioning vectors ride in the result to the decode phase."""
        token_mask = sequence_mask(token_lengths, tokens.shape[1])
        speaker, prosody, _ = self.conditions(
            mels_for_prosody, mel_lengths_for_prosody, speakers,
            mels_for_ge2e)
        mean, log_std, log_durations = self.layer_Dict['Encoder'](
            tokens, token_mask, self.duration_condition(speaker, prosody))
        scale = torch.as_tensor(length_scale, dtype=torch.float32,
                                device=tokens.device).reshape(-1, 1)
        durations = torch.ceil(torch.exp(log_durations[..., 0].float())
                               * token_mask[..., 0] * scale)
        return {'mean': mean, 'log_std': log_std,
                'log_durations': log_durations, 'durations': durations,
                'token_mask': token_mask, 'speaker_vec': speaker,
                'prosody_vec': prosody}

    @torch.no_grad()
    def inference_decode(self, prior: Dict[str, torch.Tensor],
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         noise_scale: float = 1.0,
                         max_mel_length: int = 1024,
                         step_fn: FlowStepFn = flow_step,
                         coupling_fn: FlowStepFn = coupling,
                         flow_stack_fn: FlowStepFn = flow_stack,
                         pitches: Optional[torch.Tensor] = None,
                         pitch_lengths: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
        """Phase 2 at the static capacity ``max_mel_length``: path, z and
        the inverse flow by the route of ``config.coupling_backend``.  The
        unit-normal ``noise [B, max_mel_length, M]`` is drawn from
        ``generator`` unless given.  In GR mode ``pitches [B, T_pitch]`` of
        ``pitch_lengths [B]`` are resampled to the predicted lengths."""
        mean, log_std = prior['mean'], prior['log_std']
        durations, token_mask = prior['durations'], prior['token_mask']
        s = self.config.decoder.num_squeeze

        mel_lengths = durations.sum(dim=1).clamp(1.0, max_mel_length)
        mel_lengths = torch.div(mel_lengths.to(torch.int32), s,
                                rounding_mode='floor') * s
        mel_lengths = mel_lengths.clamp_min(s)
        mel_mask = sequence_mask(mel_lengths, max_mel_length)
        attn_mask = token_mask * mel_mask[:, None, :, 0]
        attentions = generate_path(durations, attn_mask)

        align = attentions.transpose(1, 2)                  # [B, T_mel, T_tok]
        mel_mean = align @ mean.float()
        mel_log_std = align @ log_std.float()
        if noise is None:
            noise = torch.randn(mel_mean.shape, generator=generator,
                                device=mel_mean.device)
        z = (mel_mean + torch.exp(mel_log_std) * noise * noise_scale) \
            * mel_mask
        pitch = None
        if self.config.uses_gradient_reversal and pitches is not None:
            pitch = interpolate_pitch(pitches.float(), pitch_lengths,
                                      mel_lengths, max_mel_length)
        # the latent in the compute dtype, as the JAX package hands it to
        # the decoder
        mels, _, mel_mask = self.layer_Dict['Decoder'](
            z.to(self.dtype), mel_mask, reverse=True, step_fn=step_fn,
            coupling_fn=coupling_fn, flow_stack_fn=flow_stack_fn,
            speaker=prior.get('speaker_vec'), prosody=prior.get('prosody_vec'),
            pitch=pitch)
        fill = torch.full_like(mels, -self.config.sound.max_abs_mel)
        mels = torch.where(mel_mask > 0, mels, fill)
        return {'mels': mels, 'mel_lengths': mel_lengths,
                'attentions': attentions, 'durations': durations}


@torch.no_grad()
def random_state_dict(config, seed: int) -> Dict[str, torch.Tensor]:
    """A reference-format state dict of random weights drawn from ``seed``,
    on the CPU.  Every layer is live: the end conv is not zero (the
    trained-from-scratch init zeroes it, which makes each coupling the
    identity and would hide any error in it)."""
    gen = torch.Generator().manual_seed(seed)
    model = GlowTTS(config)

    def normal_(tensor, std, mean=0.0):
        tensor.copy_(torch.randn(tensor.shape, generator=gen) * std + mean)

    for module in model.modules():
        if isinstance(module, Conv1d):
            fan_in = module.weight.shape[1] * module.weight.shape[2]
            normal_(module.weight, fan_in ** -0.5)
            normal_(module.bias, 0.02)
        elif isinstance(module, WNConv1d):
            v = module.weight_v
            normal_(v, (v.shape[1] * v.shape[2]) ** -0.5)
            norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
            normal_(module.weight_g, 0.05, 1.0)
            module.weight_g.mul_(norm)
            normal_(module.bias, 0.02)
        elif isinstance(module, nn.LayerNorm):
            normal_(module.weight, 0.02, 1.0)
            normal_(module.bias, 0.02)
        elif isinstance(module, nn.Embedding):
            normal_(module.weight, module.weight.shape[1] ** -0.5)
        elif isinstance(module, RelativePositionMultiHeadAttention):
            d = module.weight_K.shape[-1]
            normal_(module.weight_K, d ** -0.5)
            normal_(module.weight_V, d ** -0.5)
        elif isinstance(module, ActNorm):
            normal_(module.logs, 0.05)
            normal_(module.bias, 0.05)
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            normal_(module.weight, fan_in ** -0.5)
            if module.bias is not None:
                normal_(module.bias, 0.02)
        elif isinstance(module, (nn.LSTM, nn.GRU)):
            for name, param in module.named_parameters():
                normal_(param, 0.02 if name.startswith('bias')
                        else module.hidden_size ** -0.5)
        elif isinstance(module, GSTProsodyEncoder):
            normal_(module.gst_Tokens, 0.5)
        elif isinstance(module, InvertibleConv):
            q, _ = torch.linalg.qr(torch.randn(module.weight.shape,
                                               generator=gen))
            q[:, 0] *= torch.sign(torch.linalg.det(q))
            module.weight.copy_(q)
    for step in model.layer_Dict['Decoder'].layer_Dict['Flows']:
        end = step.layers[2].layer_Dict['End']
        # small logs keep the inverse flow's exp(-logs) well-conditioned
        end.weight.mul_(0.1)
    return {key: value.detach().clone()
            for key, value in model.state_dict().items()}


def initial_state_dict(config, seed: int) -> Dict[str, torch.Tensor]:
    """A from-scratch state dict, as training starts from: random weights
    from ``seed`` with every coupling's end conv zero (each coupling starts
    as the identity) and ActNorm at zero, to be set from a batch by
    :meth:`GlowTTS.data_dependent_init`."""
    state = random_state_dict(config, seed)
    for key, value in state.items():
        if key.endswith(('.layer_Dict.End.weight', '.layer_Dict.End.bias',
                         '.layers.0.logs', '.layers.0.bias')):
            value.zero_()
    return state
