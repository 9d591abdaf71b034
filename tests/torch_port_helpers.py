"""Shared set-up of the PyTorch port's parity tests: one JAX model at
``tiny_config`` size with perturbed parameters (a nonzero end conv, so no
coupling is the identity), and the port loaded from the same numbers."""

import dataclasses

import jax
import numpy as np
import torch

from glow_tts_tpu.training.step import create_train_state
from glow_tts_tpu_torch.config import load_config as port_load_config
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.weights import load_jax_params
from tests.helpers import synthetic_batch, tiny_config


def with_backend(cfg, backend):
    return dataclasses.replace(
        cfg, tpu=dataclasses.replace(cfg.tpu, coupling_backend=backend))


def port_config(jax_cfg):
    """The port's config read from the JAX config's own field tree."""
    return port_load_config(dataclasses.asdict(jax_cfg))


# the conditioned modes the tests run: the config's Mode, and GE2E in
# place of the look-up table for the speaker vector
MODES = ('SE-LUT', 'SE-GE2E', 'PE', 'GR')


def mode_config(mode='Vanilla'):
    """``tiny_config`` in one of ``'Vanilla'`` and :data:`MODES`."""
    if mode != 'SE-GE2E':
        return tiny_config(mode.split('-')[0])
    speaker = tiny_config('SE').speaker_embedding
    return tiny_config('SE', Speaker_Embedding={
        'Type': 'GE2E', 'Num_Speakers': speaker.num_speakers,
        'Embedding_Size': speaker.embedding_size,
        'GE2E': dataclasses.asdict(speaker.ge2e)})


def jax_model(seed=0, perturb=0.03, mode='Vanilla'):
    """(cfg, flax model, numpy params, batch) at tiny size, in ``mode``
    (:func:`mode_config`)."""
    cfg = mode_config(mode)
    batch = synthetic_batch(cfg, batch=4)
    model, state = create_train_state(cfg, jax.random.PRNGKey(seed), batch)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p, np.float32)
                   + perturb * rng.standard_normal(p.shape).astype(
                       np.float32)),
        state.params)
    return cfg, model, params, batch


def port_model(jax_cfg, params):
    cfg = port_config(jax_cfg)
    return load_jax_params(PortGlowTTS(cfg), params, cfg).prepare()


def ragged(rng, b, t, c, lengths):
    """x [B, T, C] masked to ``lengths``, and the mask [B, T, 1]."""
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = (np.arange(t)[None, :, None]
            < np.asarray(lengths)[:, None, None]).astype(np.float32)
    return x * mask, mask


def t(array):
    return torch.from_numpy(np.array(array))


def with_dropout(cfg, rate):
    """``cfg`` (the JAX config) with every dropout rate at ``rate``."""
    enc, dec = cfg.encoder, cfg.decoder
    rep = dataclasses.replace
    enc = rep(enc, prenet=rep(enc.prenet, dropout_rate=rate),
              transformer=rep(enc.transformer, dropout_rate=rate),
              duration_predictor=rep(enc.duration_predictor,
                                     dropout_rate=rate))
    coupling = rep(dec.affine_coupling, wavenet=rep(
        dec.affine_coupling.wavenet, dropout_rate=rate))
    return rep(cfg, encoder=enc, decoder=rep(dec, affine_coupling=coupling))
