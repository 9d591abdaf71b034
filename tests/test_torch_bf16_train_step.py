"""The slice at bfloat16: the port's train step, eval step and ActNorm
initialisation at ``TPU.compute_dtype: 'bfloat16'`` against the JAX
package's at bfloat16 and at float32, from the same f32 parameters and
batch at ``tiny_config`` size, every dropout rate 0 (the frameworks draw
other bits):

* three train steps against JAX ``make_train_step`` under ``'flax'`` and
  ``'mega_interpret'`` (its Pallas train kernels in interpret mode), in
  Vanilla mode here (GR mode, the 'em' warmup's step at ``Num_Squeeze:
  1``, the eval step and the ActNorm init are
  ``tests/test_torch_bf16_train_modes.py``): the losses of the three
  steps, the first step's gradients leaf by leaf;
* the f32 path untouched: one state dict built both ways;
* the ``Trainer`` at bf16 (it trains and evaluates at bf16, its
  free-running decode and an ``Inferencer`` on its checkpoint serve at
  float32 from the same float32 parameters).

Tolerance (``tests/torch_port_helpers.py``): max|port − jax_bf16| ≤
2·max|jax_bf16 − jax_f32| + 1e-6, the result of the train steps being the
vector of every loss of the three steps; ``grad_norm`` within 3e-2 of
JAX's f32 one; the gradients leaf by leaf no more than twice as far from
JAX's bf16 ones as those are from the f32 ones, plus 1e-4, and within 3e-2
(norm-relative) of JAX's f32 ones beyond JAX's bf16 own distance from them
(at this size JAX's bf16 gradients are up to 0.3 from its f32 ones on the
encoder's leaves, so the flat 3e-2 bar, the JAX package's for the flow
stack, is held where it holds there: ``tests/test_torch_bf16_flow.py``).
Under ``'mega_interpret'`` the port lands on JAX's bf16 losses to a few
f32 ulps; under ``'flax'`` JAX's bf16 keeps the flow's stream in
f32 between the steps where the TPU kernels (and the port) keep it in
bf16, so there the two are two bf16 policies of the same size of error.

MAS near-ties: at bf16 a near-tie can move whole frames of the path, so
the port's steps take the JAX bf16 side's paths through ``mas_fn``; a
separate test counts the frames the two paths share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.optim import make_optimizer as jax_make_optimizer
from glow_tts_tpu_torch.models.glow_tts import GlowTTS
from glow_tts_tpu_torch.ops.mas import maximum_path
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import (EMState, build_model,
                                              init_em_stats, make_train_step)
from glow_tts_tpu_torch.weights import (gradients_as_jax_params,
                                        load_jax_params)
from tests.helpers import synthetic_batch, tiny_config
from tests.test_torch_curriculum import (CURRICULUM, _train_section,
                                         em_lock_corpus)
from tests.torch_port_helpers import (assert_bf16_close, assert_bf16_grads,
                                      at_dtype, norm_rel, port_config, t,
                                      with_backend, with_dropout)

STEPS = 3
LOSS_KEYS = ('mle', 'duration', 'speaker', 'distill', 'total')


def _config(mode, backend, em=False):
    overrides = {}
    if em:
        base = tiny_config().decoder
        coupling = {'Calc_Channels': base.affine_coupling.calc_channels,
                    'WaveNet': {'Num_Layers': 2, 'Kernel_Size': 5,
                                'Dropout_Rate': 0.05}}
        overrides = {
            'Train': _train_section(**CURRICULUM),
            'Decoder': {'Stack': base.stack, 'Num_Squeeze': 1,
                        'Num_Split': base.num_split,
                        'Affine_Coupling': coupling}}
    return with_backend(with_dropout(tiny_config(mode, **overrides), 0.0),
                        backend)


def _batch(cfg, em):
    if not em:
        return synthetic_batch(cfg, batch=4)
    batch, _ = em_lock_corpus(np.random.default_rng(11))
    return batch


def _perturbed(cfg, batch):
    _, state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(100)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * rng.standard_normal(
            p.shape).astype(np.float32), state.params)


def _jax_run(cfg, params, batch, flags):
    """Three JAX train steps: the losses of each, the path each step's
    forward took, the first step's gradients."""
    model = jstep.build_model(cfg)
    jbatch = {key: jnp.asarray(value) for key, value in batch.items()}
    state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch)[1]
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jax_make_optimizer(cfg).init(params))
    em = flags.get('em_alignment', False)

    def forward(p, em_stats):
        return model.apply({'params': p}, deterministic=False,
                           rngs={'dropout': jax.random.PRNGKey(1)},
                           em_alignment=em,
                           em_stats=em_stats if em else None, **jbatch)

    def loss_fn(p):
        return jstep.compute_losses(cfg, forward(p, state.em_stats),
                                    jbatch)['total']

    grads = jax.grad(loss_fn)(state.params)
    path_of = jax.jit(lambda p, s: forward(p, s)['attentions'])
    step = jax.jit(jstep.make_train_step(cfg, model, **flags))
    metrics, paths = [], []
    for _ in range(STEPS):
        paths.append(np.asarray(path_of(state.params, state.em_stats)))
        state, m = step(state, jbatch)
        metrics.append({key: float(v) for key, v in m.items()})
    return dict(metrics=metrics, paths=paths, grads=grads)


def _handing(paths, em):
    """A ``mas_fn`` that returns the JAX side's path of each step (in EM
    mode the final MAS call of a step; its anchored first call is the
    port's own MAS on a score that does not depend on the dtype)."""
    calls = []

    def mas_fn(log_p, token_lengths, mel_lengths):
        calls.append(1)
        if em and len(calls) % 2:
            return maximum_path(log_p, token_lengths, mel_lengths)
        return torch.from_numpy(
            paths[(len(calls) - 1) // (2 if em else 1)].copy())

    return mas_fn


CASES = [('Vanilla', 'flax', False), ('Vanilla', 'mega_interpret', False)]


def _run(mode, backend, em):
    """Three steps of JAX at f32 and at bf16 and of the port at bf16, the
    port handed the JAX bf16 side's paths."""
    cfg = _config(mode, backend, em)
    flags = dict(em_alignment=True, freeze_decoder=True) if em else {}
    batch = _batch(cfg, em)
    params = _perturbed(cfg, batch)
    refs = {dtype: _jax_run(at_dtype(cfg, dtype), params, batch, flags)
            for dtype in ('float32', 'bfloat16')}
    pcfg = port_config(at_dtype(cfg, 'bfloat16'))
    port = load_jax_params(build_model(pcfg), params, pcfg).prepare(
        fold=False)
    assert port.dtype == torch.bfloat16
    em_state = EMState(init_em_stats(pcfg)) if em else None
    train_step = make_train_step(
        pcfg, port, make_optimizer(pcfg, port.parameters()), seed=0,
        mas_fn=_handing(refs['bfloat16']['paths'], em), em_state=em_state,
        **flags)
    tensors = {key: t(value) for key, value in batch.items()}
    metrics, grads = [], None
    for _ in range(STEPS):
        metrics.append({key: float(v)
                        for key, v in train_step(tensors).items()})
        if grads is None:
            grads = gradients_as_jax_params(port, pcfg)
    return dict(refs=refs, metrics=metrics, grads=grads, pcfg=pcfg)


@pytest.fixture(scope='module', params=CASES,
                ids=[f'{m}-{b}' for m, b, _ in CASES])
def run(request):
    return _run(*request.param)


def _check_losses(run):
    r16, r32 = run['refs']['bfloat16'], run['refs']['float32']
    keys = [key for key in LOSS_KEYS if key in r16['metrics'][0]]
    assert set(run['metrics'][0]) == set(r16['metrics'][0])

    def vector(metrics):
        return np.array([[m[key] for key in keys] for m in metrics])

    got = vector(run['metrics'])
    assert np.isfinite(got).all()
    assert_bf16_close(got, vector(r16['metrics']), vector(r32['metrics']),
                      f'losses {keys} of {STEPS} steps')
    for got_m, ref_m in zip(run['metrics'], r32['metrics']):
        assert abs(got_m['grad_norm'] - ref_m['grad_norm']) \
            < 3e-2 * ref_m['grad_norm']


def _check_gradients(run):
    r16, r32 = run['refs']['bfloat16'], run['refs']['float32']

    def leaves(tree):
        return {jax.tree_util.keystr(path): value for path, value
                in jax.tree_util.tree_leaves_with_path(tree)}

    got, j16, j32 = (leaves(tree) for tree in (run['grads'], r16['grads'],
                                               r32['grads']))
    assert len(got) > 100 and set(got) == set(j32)
    assert_bf16_grads(got, j16, j32, beyond_own=True)


def test_three_bf16_steps_match_jax(run):
    _check_losses(run)


def test_first_bf16_step_gradients_leaf_by_leaf(run):
    _check_gradients(run)


@pytest.mark.parametrize('mode', ['Vanilla', 'GR'])
def test_mas_paths_at_bf16_share_their_frames(mode):
    """The port's own MAS at bf16 against the JAX bf16 side's path on the
    first step's forward: the frames whose token agrees, reported and held
    above 90 % (a near-tie moves whole frames, not the bulk)."""
    cfg = _config(mode, 'mega_interpret')
    batch = _batch(cfg, False)
    params = _perturbed(cfg, batch)
    ref = _jax_run(at_dtype(cfg, 'bfloat16'), params, batch, {})['paths'][0]
    pcfg = port_config(at_dtype(cfg, 'bfloat16'))
    port = load_jax_params(build_model(pcfg), params, pcfg).prepare(
        fold=False)
    tensors = {key: t(value) for key, value in batch.items()}
    with torch.no_grad():
        out = port(tensors['tokens'], tensors['token_lengths'],
                   tensors['mels'], tensors['mel_lengths'],
                   deterministic=False, seed=0,
                   generator=torch.Generator().manual_seed(0),
                   **{key: tensors[key] for key in ('speakers', 'pitches')
                      if key in tensors})
    got = out['attentions'].numpy()
    frames = np.arange(ref.shape[2])[None] < batch['mel_lengths'][:, None]
    same = (got.argmax(1) == ref.argmax(1)) & frames
    share = same.sum() / frames.sum()
    print(f'{mode}: the paths share {same.sum()} of {frames.sum()} frames '
          f'({100 * share:.1f} %)')
    assert share > 0.9


def test_f32_path_is_untouched_by_a_bf16_model():
    """One state dict built at both dtypes: the f32 model's outputs are
    bit for bit those of a model that never heard of a dtype (``GlowTTS``'s
    default), and the bf16 model's move."""
    cfg = _config('Vanilla', 'fused')
    batch = _batch(cfg, False)
    params = _perturbed(cfg, batch)
    pcfg = port_config(cfg)
    assert pcfg.compute_dtype == 'float32'
    tensors = {key: t(value) for key, value in batch.items()}
    plain = load_jax_params(GlowTTS(pcfg), params, pcfg).prepare()
    outs = {}
    for dtype in ('float32', 'bfloat16'):
        model = load_jax_params(
            build_model(dataclasses.replace(pcfg, compute_dtype=dtype)),
            params, pcfg).prepare()
        with torch.no_grad():
            outs[dtype] = model(tensors['tokens'], tensors['token_lengths'],
                                tensors['mels'], tensors['mel_lengths'])
    with torch.no_grad():
        ref = plain(tensors['tokens'], tensors['token_lengths'],
                    tensors['mels'], tensors['mel_lengths'])
    for key in ('z', 'log_dets', 'mel_mean', 'mel_log_std', 'log_durations'):
        assert torch.equal(outs['float32'][key], ref[key]), key
        assert not torch.equal(outs['bfloat16'][key].float(), ref[key]), key
    assert norm_rel(outs['bfloat16']['z'], ref['z']) < 3e-2


def test_trainer_trains_at_bf16_and_serves_at_the_inference_dtype(
        tmp_path):
    """The ``Trainer`` of a bf16 config builds, initialises, trains and
    evaluates at bf16; its free-running decode and an ``Inferencer`` on its
    checkpoint serve at ``inference_dtype`` (float32) from the same float32
    parameters, which is what the checkpoint holds."""
    import os

    from glow_tts_tpu_torch.inference import Inferencer
    from glow_tts_tpu_torch.training.trainer import Trainer
    from glow_tts_tpu_torch.utils.logging import MemoryWriter
    from tests.torch_patterns import trainer_config, write_pattern_archive
    jcfg = tiny_config()
    root = str(tmp_path)
    write_pattern_archive(os.path.join(root, 'train'), 8, jcfg.sound, 0)
    write_pattern_archive(os.path.join(root, 'eval'), 4, jcfg.sound, 1)
    cfg = trainer_config(
        port_config(at_dtype(jcfg, 'bfloat16')), root, num_workers=1,
        batch_size=4, max_step=2, checkpoint_save_interval=2,
        logging_interval=1, evaluation_interval=2, inference_interval=100)
    assert (cfg.compute_dtype, cfg.serve_dtype) == ('bfloat16', 'float32')
    trainer = Trainer(cfg, device='cpu', max_mel_length=64,
                      writers={'train': MemoryWriter(),
                               'eval': MemoryWriter()})
    assert trainer.model.dtype == torch.bfloat16
    decoded_at = []
    decode = trainer.model.inference_decode

    def recording(*args, **kwargs):
        decoded_at.append(trainer.model.layer_Dict['Decoder'].dtype)
        return decode(*args, **kwargs)

    trainer.model.inference_decode = recording
    trainer.train()
    totals = [v for _, v in trainer.writers['train'].scalars['Loss/total']]
    assert len(totals) == 2 and np.isfinite(totals).all()
    assert decoded_at and set(decoded_at) == {torch.float32}
    assert trainer.model.dtype == torch.bfloat16     # back after the decode
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    step = trainer.checkpoints.latest_step()
    assert step == 2
    inferencer = Inferencer(cfg.checkpoint_path, cfg, 'cpu',
                            max_mel_length=64, step=step)
    assert inferencer.model.dtype == torch.float32
    result = inferencer.inference(['a'], ['The birch canoe slid.'])[0]
    assert np.isfinite(result['mel']).all()
