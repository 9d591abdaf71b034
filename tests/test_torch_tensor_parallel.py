"""Tensor parallelism of the PyTorch port (``glow_tts_tpu_torch/parallel/
tp.py`` and the modules it shards, ``training/{optim,step,checkpoint,
trainer}.py``, ``inference.py``, ``cli.py``) on the CPU: gloo ranks, each
a process spawned by ``tests/torch_tp_worker.py`` (one spawn per world
layout), at ``tests/helpers.py::tiny_config`` size.

* (a) the port's rules shard the families of ``glow_tts_tpu/parallel/
  tp.py::param_specs`` on the same dimension, read off the JAX rules
  through the weight bridge; sharded dims divide, indivisible ones
  replicate with a warning, an attention whose heads do not divide
  replicates, and more than 30 % of the parameters are sharded.
* (b) 2 ranks (data 1 × model 2), Vanilla at f32 with every dropout rate
  0, 2 train steps against the JAX package's step on its ``model`` 2 mesh
  of the virtual CPU devices (``tests/test_tp.py``'s tolerances: losses
  rtol 2e-4, parameters after rtol 5e-3 / atol 1e-5); the replicated
  parameters' gradients bit-equal across the ranks.
* (c) one GR step the same way (the conditioned WaveNet, the pitch
  operand, the GRL and the CE loss under tensor parallelism).
* (d) the eval step and a decode under tensor parallelism against the
  port's world of one: eval losses rtol 5e-5 / atol 1e-6, durations
  equal, decoded mels to 1e-5 at f32 and to the port's bf16 bar at bf16.
* (e) dropout on, 2 steps against the world of one from the same seed:
  the flow masks bit for bit, losses and parameters at (b)'s tolerances.
* (f) 4 ranks (data 2 × model 2), one step on halves of the batch
  against one process on the whole batch, at (b)'s tolerances, and one
  'em' step whose table is bit-equal across each model group.
* (g) checkpoints: a world of one's restores under tensor parallelism and
  saves again bit for bit, a sharded run's loads in a world of one bit for
  bit; a ``Trainer`` run stopped after step 2 and resumed repeats the
  uninterrupted run bit for bit, rank 0 alone writes, and its model group
  decodes and serves the inference file.
* (h) ``check_world``, ``ranks_to_launch`` and ``glow-tts-torch-train``
  with ``model_parallel`` 2 and no launcher.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.parallel import mesh as mesh_lib
from glow_tts_tpu.parallel import tp as jtp
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.optim import make_optimizer as jax_make_optimizer
from glow_tts_tpu_torch.config import load_config
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.models.glow_tts import random_state_dict
from glow_tts_tpu_torch.parallel import data as pdata
from glow_tts_tpu_torch.parallel import tp
from glow_tts_tpu_torch.training.checkpoint import (restore_train_state,
                                                    train_payload)
from glow_tts_tpu_torch.training.optim import make_optimizer
from glow_tts_tpu_torch.training.step import build_model
from glow_tts_tpu_torch.weights import (convert_params_to_reference,
                                        load_jax_params, load_state_dict,
                                        reference_to_params)
from tests import torch_tp_worker as worker
from tests.helpers import synthetic_batch, tiny_config
from tests.torch_patterns import (trainer_config, write_inference_tsv,
                                  write_pattern_archive)
from tests.torch_port_helpers import (BF16_ATOL, BF16_FACTOR, port_config,
                                      with_backend, with_dropout)

LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=5e-3, atol=1e-5)
EVAL_TOL = dict(rtol=5e-5, atol=1e-6)
MEL_ATOL = 1e-5
MODEL = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EM_TRAIN = {'Batch_Size': 4,
            'Learning_Rate': {'Initial': 1.0e-3, 'Base': 100},
            'ADAM': {'Beta1': 0.9, 'Beta2': 0.999, 'Epsilon': 1.0e-6},
            'Weight_Decay': 1.0e-6, 'Gradient_Norm': 5.0,
            'Alignment_Warmup_Mode': 'em', 'Alignment_Warmup_Steps': 10,
            'Decoder_Freeze_Steps': 10, 'Anchor_Pause_Tokens': [2],
            'Anchor_Silence_Level': -3.5}


def jax_config(mode='Vanilla', em=False):
    """``tiny_config`` at f32 under ``'flax'``, every dropout rate 0, on a
    1 × 2 mesh (``data_parallel`` 1, ``model_parallel`` 2); with ``em``
    the 'em' alignment warmup."""
    extra = {'Train': EM_TRAIN} if em else {}
    return with_dropout(with_backend(tiny_config(
        mode, TPU={'compute_dtype': 'float32', 'mas_backend': 'scan',
                   'model_parallel': MODEL, 'data_parallel': 1},
        **extra), 'flax'), 0.0)


def tp_config(jcfg, data=1):
    """The port's config of ``jcfg`` on ``data × MODEL`` ranks."""
    return dataclasses.replace(port_config(jcfg), data_parallel=data,
                               model_parallel=MODEL)


def one_config(config):
    """``config`` as a world of one runs it."""
    return dataclasses.replace(config, data_parallel=0, model_parallel=1)


def perturbed_state(jcfg, batch):
    """The JAX model, its train state with parameters perturbed by 0.03
    (a live end conv), and those parameters as numpy."""
    model, state = jstep.create_train_state(jcfg, jax.random.PRNGKey(0),
                                            batch)
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * rng.standard_normal(
            p.shape).astype(np.float32), state.params)
    return model, state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jax_make_optimizer(jcfg).init(params)), params


def jax_tp_steps(jcfg, model, state, batch, steps):
    """JAX's train step on its ``model`` 2 mesh (``tests/test_tp.py::
    _run_tp``): the metrics of each step and the parameters after."""
    mesh = mesh_lib.make_mesh(jcfg, jax.devices()[:MODEL])
    assert dict(mesh.shape) == {'data': 1, 'model': MODEL}
    state = jtp.place_state(state, mesh)
    sharded = mesh_lib.shard_batch(mesh, batch)
    step = jax.jit(jstep.make_train_step(jcfg, model))
    metrics = []
    with mesh_lib.activate_mesh(mesh):
        for _ in range(steps):
            state, m = step(state, sharded)
            metrics.append({key: float(v) for key, v in m.items()})
    return metrics, state.params


def _halves(batch):
    half = len(batch['tokens']) // 2
    return [{key: value[r * half:(r + 1) * half]
             for key, value in batch.items()} for r in range(2)]


@pytest.fixture(scope='module')
def two(tmp_path_factory):
    """The JAX mesh steps (Vanilla 2, GR 1), one spawn of 2 ranks running
    every scenario, and the world of one where it is the reference."""
    jcfg, gcfg = jax_config(), jax_config('GR')
    batch = synthetic_batch(jcfg, batch=4)
    gr_batch = synthetic_batch(gcfg, batch=4)
    out = {'jcfg': jcfg, 'batch': batch}
    model, state, params = perturbed_state(jcfg, batch)
    out['jax'] = jax_tp_steps(jcfg, model, state, batch, 2)
    gmodel, gstate, gparams = perturbed_state(gcfg, gr_batch)
    out['jax_gr'] = jax_tp_steps(gcfg, gmodel, gstate, gr_batch, 1)

    pcfg, gpcfg = tp_config(jcfg), tp_config(gcfg)
    state = load_jax_params(PortGlowTTS(one_config(pcfg)), params,
                            pcfg).state_dict()
    gr_state = load_jax_params(PortGlowTTS(one_config(gpcfg)), gparams,
                               gpcfg).state_dict()
    live = tp_config(tiny_config())           # every dropout rate on
    noise = torch.randn(4, 64, pcfg.sound.mel_dim,
                        generator=torch.Generator().manual_seed(5))
    # served: the world of one under 'fused'
    fused = dataclasses.replace(pcfg, coupling_backend='fused')
    # a world of one's checkpoint after one step, for the round trip
    one = one_config(pcfg)
    saved_one = worker.saved_after_steps(one, state, batch, 1, pdata.SINGLE)
    scenarios = {
        'vanilla': {'config': pcfg, 'batches': [batch], 'steps': 2},
        'dropout': {'config': live, 'batches': [batch], 'steps': 2},
        'served_f32': {'kind': 'served', 'config': fused,
                       'batches': [batch], 'dtype': torch.float32,
                       'noise': noise},
        'served_bf16': {'kind': 'served', 'config': fused,
                        'batches': [batch], 'dtype': torch.bfloat16,
                        'noise': noise},
        'init': {'kind': 'init', 'config': pcfg, 'batches': [batch]},
        'collectives': {'kind': 'collectives', 'batches': [batch]},
        'round_trip': {'kind': 'round_trip', 'config': pcfg,
                       'batches': [batch], 'payload': saved_one},
        'saved': {'kind': 'saved', 'config': pcfg, 'batches': [batch],
                  'steps': 1}}
    ranks = worker.spawn({'kind': 'steps', 'config': pcfg, 'state': state,
                          'scenarios': scenarios},
                         str(tmp_path_factory.mktemp('tp_steps')))
    gr_ranks = worker.spawn(
        {'kind': 'steps', 'config': gpcfg, 'state': gr_state,
         'scenarios': {'gr': {'config': gpcfg, 'batches': [gr_batch],
                              'steps': 1}}},
        str(tmp_path_factory.mktemp('tp_gr')))
    for rank, result in zip(ranks, gr_ranks):
        rank.update(result)
    out.update(ranks=ranks, pcfg=pcfg, gpcfg=gpcfg, state=state,
               saved_one=saved_one, noise=noise, one={
                   'dropout': worker.train_steps(one_config(live), state,
                                                 batch, 2, pdata.SINGLE),
                   'init': worker.initialised(one, state, batch,
                                              pdata.SINGLE),
                   **{f'served_{name}': worker.served(
                       one_config(fused), state, batch, pdata.SINGLE, dtype,
                       noise)
                      for name, dtype in (('f32', torch.float32),
                                          ('bf16', torch.bfloat16))}})
    return out


# ---------------------------------------------------------------------------
# (a) the rules


def _marked_params(jcfg, specs, params):
    """JAX ``params`` with each leaf ``i`` set to ``1000·(i + 1)`` plus
    its index along the dimension its spec shards (0 elsewhere), and
    ``{i + 1: (path, dim)}``."""
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    leaves, ids = [], {}
    for i, (path, leaf) in enumerate(flat):
        name = jtp._path_str(path)
        dim = next((d for d, axis in enumerate(specs[name])
                    if axis == 'model'), None)
        value = np.full(leaf.shape, 1000.0 * (i + 1), np.float32)
        if dim is not None:
            value += np.arange(leaf.shape[dim], dtype=np.float32).reshape(
                [-1 if d == dim else 1 for d in range(leaf.ndim)])
        leaves.append(value)
        ids[i + 1] = (name, dim)
    return jax.tree_util.tree_unflatten(tree, leaves), ids


def test_rules_shard_the_jax_families_on_the_same_dimension():
    """Through the weight bridge: each port tensor that a sharded JAX leaf
    becomes varies along the dimension the port's rules shard, every other
    port tensor is replicated, and the sharded families match."""
    jcfg = jax_config()
    batch = synthetic_batch(jcfg, batch=4)
    _, state = jstep.create_train_state(jcfg, jax.random.PRNGKey(0), batch)
    jspecs = jtp.param_specs(state.params, MODEL)
    marked, ids = _marked_params(jcfg, jspecs, state.params)
    bridged = convert_params_to_reference(marked, jcfg)
    specs = tp.param_specs(PortGlowTTS(one_config(tp_config(jcfg))), MODEL)
    assert set(bridged) == set(specs)
    jax_sharded = {name for name, dim in ids.values() if dim is not None}
    port_sharded = set()
    for name, value in bridged.items():
        value = np.asarray(value)
        leaf, dim = ids[int(round(value.min() / 1000.0))]
        varying = [d for d in range(value.ndim)
                   if np.ptp(value, axis=d).max() > 0]
        assert varying == ([] if dim is None else [specs[name]]), \
            (name, leaf, varying, specs[name])
        if specs[name] is not None:
            port_sharded.add(leaf)
    assert port_sharded == jax_sharded and len(jax_sharded) > 10


@pytest.mark.parametrize('config_path', [None, 'Hyper_Parameters.yaml'])
def test_sharded_dims_divide_and_cover_a_third(config_path):
    """At ``tiny_config`` and at the shipped YAML's widths, model 2: each
    sharded dim divides and more than 30 % of the parameters are
    sharded, as ``tests/test_tp.py`` asks of the JAX rules."""
    config = (one_config(tp_config(jax_config())) if config_path is None
              else load_config(os.path.join(REPO, 'configs', config_path)))
    model = PortGlowTTS(config)
    specs = tp.param_specs(model, MODEL)
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    for name, dim in specs.items():
        if dim is not None:
            assert shapes[name][dim] % MODEL == 0, name
    sharded, total = tp.sharded_param_count(specs, shapes)
    assert sharded > 0.3 * total, (sharded, total)


def test_indivisible_dims_replicate_with_a_warning(caplog):
    """At model 64 no width of ``tiny_config`` divides: every family
    replicates, each with its warning (``tests/test_tp.py::
    test_indivisible_dim_falls_back_to_replicated``)."""
    model = PortGlowTTS(one_config(tp_config(jax_config())))
    with caplog.at_level(logging.WARNING, logger=tp.logger.name):
        specs = tp.param_specs(model, 64)
    assert all(dim is None for dim in specs.values())
    # 2 attentions, 2 FFNs, the duration predictor and 3 couplings
    assert len([r for r in caplog.records if 'replicating' in r.message]) \
        == 8


def test_attention_whose_heads_do_not_divide_replicates(caplog):
    """``tiny_config`` has 2 heads: at model 4 the attention replicates
    (a rank computes whole heads) while every other family, whose widths
    divide by 4, stays sharded."""
    model = PortGlowTTS(one_config(tp_config(jax_config())))
    with caplog.at_level(logging.WARNING, logger=tp.logger.name):
        specs = tp.param_specs(model, 4)
    attention = {name for name in specs if '.Attention.layer_Dict.' in name
                 and 'Prosody' not in name}
    assert attention and all(specs[name] is None for name in attention)
    assert specs['layer_Dict.Encoder.layer_Dict.Transformer.layer_Dict.'
                 'ANCRDCN_0.layer_Dict.Conv_0.weight'] == 0
    assert specs['layer_Dict.Decoder.layer_Dict.Flows.0.layers.2.layer_Dict.'
                 'WaveNet.layer_Dict.In_0.weight_v'] == 1
    assert 'heads not divisible' in caplog.text


def test_the_four_collectives_are_megatrons_conjugate_pairs(two):
    """On rank r, x = arange(8).reshape(2, 4) + 10 r and the loss
    (r + 1)·Σ y: ``copy_to_model`` is the identity with the ranks' weights
    summed backward (3), ``reduce_from_model`` the ranks' sum with the
    identity backward, ``scatter_to_model`` rank r's columns with their
    weights gathered whole backward, ``gather_from_model`` the ranks'
    columns side by side with rank r's slice backward."""
    x = [torch.arange(8.0).reshape(2, 4) + 10 * r for r in range(MODEL)]
    for rank, result in enumerate(two['ranks']):
        got = result['collectives']
        weight = rank + 1.0
        y, grad = got['copy']
        assert torch.equal(y, x[rank])
        assert torch.equal(grad, torch.full((2, 4), 3.0))
        y, grad = got['reduce']
        assert torch.equal(y, x[0] + x[1])
        assert torch.equal(grad, torch.full((2, 4), weight))
        y, grad = got['scatter']
        assert torch.equal(y, x[rank][:, 2 * rank:2 * rank + 2])
        assert torch.equal(grad, torch.tensor([[1.0, 1.0, 2.0, 2.0]] * 2))
        y, grad = got['gather']
        assert torch.equal(y, torch.cat(x, dim=1))
        assert torch.equal(grad, torch.full((2, 4), weight))


# ---------------------------------------------------------------------------
# (b), (c) against the JAX package's model mesh


def _assert_metrics(got, ref, keys=('total', 'mle', 'duration')):
    for key in keys:
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in ref], rtol=LOSS_RTOL,
                                   err_msg=key)


def _assert_params_match_jax(params, jax_params, pcfg):
    ported = dict(jax.tree_util.tree_leaves_with_path(
        reference_to_params(params, pcfg)))
    leaves = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(leaves) > 100
    for path, value in leaves:
        np.testing.assert_allclose(ported[path], np.asarray(value),
                                   **PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_ranks_agree(ranks, scenario):
    """Every rank reports the same metrics, the same full parameters and
    the same gradient of every replicated parameter, bit for bit."""
    first = ranks[0][scenario]
    replicated = [name for name, dim in first['specs'].items()
                  if dim is None]
    assert len(replicated) > 50
    for other in ranks[1:]:
        got = other[scenario]
        assert got['metrics'] == first['metrics']
        for name in replicated:
            assert torch.equal(got['grads'][name], first['grads'][name]), \
                name
        for key, value in first['params'].items():
            assert torch.equal(got['params'][key], value), key


@pytest.mark.parametrize('scenario,jax_key', [('vanilla', 'jax'),
                                              ('gr', 'jax_gr')])
def test_model_ranks_match_the_jax_model_mesh(two, scenario, jax_key):
    """(b) and (c): 2 ranks against JAX's model 2 mesh, at rate 0."""
    ranks = two['ranks']
    _assert_ranks_agree(ranks, scenario)
    got = ranks[0][scenario]
    jax_metrics, jax_params = two[jax_key]
    keys = ('total', 'mle', 'duration') + (('speaker',) if scenario == 'gr'
                                           else ())
    _assert_metrics(got['metrics'], jax_metrics, keys)
    assert any(dim is not None for dim in got['specs'].values())
    _assert_params_match_jax(got['params'], jax_params,
                             two['gpcfg' if scenario == 'gr' else 'pcfg'])


def test_every_model_rank_takes_the_same_mas_paths(two):
    for scenario in ('vanilla', 'gr', 'dropout'):
        first = two['ranks'][0][scenario]['paths']
        assert first
        for a, b in zip(first, two['ranks'][1][scenario]['paths']):
            assert int((a != b).sum()) == 0


# ---------------------------------------------------------------------------
# (d) evaluation and decoding


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_eval_and_decode_match_one_process(two, dtype):
    """At f32 the eval step's losses to rtol 5e-5 / atol 1e-6 and the
    decoded mels to 1e-5; at bf16 both within the port's bf16 bar, twice
    the world of one's bf16 distance from its f32 plus 1e-6.  First the
    durations, equal (on this batch no ceil flips: the row-parallel
    duration predictor sums in another order)."""
    got = two['ranks'][0][f'served_{dtype}']
    ref = two['one'][f'served_{dtype}']
    f32 = two['one']['served_f32']
    for other in two['ranks'][1:]:
        assert torch.equal(other[f'served_{dtype}']['mels'], got['mels'])
    assert torch.equal(got['durations'], ref['durations'])
    assert torch.equal(got['mel_lengths'], ref['mel_lengths'])
    for key, value in ref['losses'].items():
        if dtype == 'f32':
            np.testing.assert_allclose(got['losses'][key], value,
                                       **EVAL_TOL, err_msg=key)
        else:
            bar = BF16_FACTOR * abs(value - f32['losses'][key]) + BF16_ATOL
            assert abs(got['losses'][key] - value) <= bar, (key, bar)
    err = (got['mels'] - ref['mels']).abs().max().item()
    if dtype == 'f32':
        assert err <= MEL_ATOL, err
    else:
        bar = BF16_FACTOR * (ref['mels'] - f32['mels']).abs().max().item() \
            + BF16_ATOL
        assert err <= bar, (err, bar)


def test_actnorm_init_through_the_sharded_stack_matches_one_process(two):
    """ActNorm's data-dependent initialisation runs step by step through
    the sharded plain flow step under tensor parallelism: every step's
    statistics within 1e-5 of the world of one's (which runs the flow
    step's plain version), the other weights untouched."""
    got, ref = two['ranks'][0]['init'], two['one']['init']
    moved = 0
    for name, value in ref.items():
        assert torch.equal(two['ranks'][1]['init'][name], got[name]), name
        if '.layers.0.' in name:
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       atol=1e-5, err_msg=name)
            moved += not torch.equal(value, two['state'][name])
        else:
            assert torch.equal(got[name], value), name
    assert moved == 2 * two['pcfg'].decoder.stack


# ---------------------------------------------------------------------------
# (e) dropout on


def test_dropout_masks_and_steps_match_one_process(two):
    """Every rank of the model group draws the world of one's flow masks
    (``dropmask.stack_mask``, the seed of data index 0) bit for bit, and
    the encoder's dropout the whole masks of the world of one; the steps
    land at (b)'s tolerances."""
    _assert_ranks_agree(two['ranks'], 'dropout')
    got, ref = two['ranks'][0]['dropout'], two['one']['dropout']
    assert len(got['masks']) == len(ref['masks']) > 0
    for (seed, where, mask), (ref_seed, ref_where, ref_mask) in zip(
            got['masks'], ref['masks']):
        assert (seed, where) == (ref_seed, ref_where)
        assert int((mask != ref_mask).sum()) == 0
        assert 0 < int((mask == 0).sum()) < mask.numel()
    _assert_metrics(got['metrics'], ref['metrics'])
    for key, value in ref['params'].items():
        np.testing.assert_allclose(got['params'][key].numpy(),
                                   value.numpy(), **PARAM_TOL, err_msg=key)


# ---------------------------------------------------------------------------
# (f) data × model


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    """4 ranks (data 2 × model 2): one step and one 'em' step on halves of
    the batch; the world of one on the whole batch."""
    jcfg = jax_config()
    batch = synthetic_batch(jcfg, batch=4)
    _, _, params = perturbed_state(jcfg, batch)
    pcfg = tp_config(jcfg, data=2)
    em_cfg = tp_config(jax_config(em=True), data=2)
    state = load_jax_params(PortGlowTTS(one_config(pcfg)), params,
                            pcfg).state_dict()
    ranks = worker.spawn(
        {'kind': 'steps', 'config': pcfg, 'state': state, 'scenarios': {
            'step': {'config': pcfg, 'batches': _halves(batch), 'steps': 1},
            'em': {'config': em_cfg, 'batches': _halves(batch), 'steps': 1,
                   'em': True}}},
        str(tmp_path_factory.mktemp('tp_grid')), ranks=4)
    one = {'step': worker.train_steps(one_config(pcfg), state, batch, 1,
                                      pdata.SINGLE),
           'em': worker.train_steps(one_config(em_cfg), state, batch, 1,
                                    pdata.SINGLE, em=True)}
    return dict(ranks=ranks, one=one)


def test_data_by_model_matches_one_process(grid):
    """(f): every rank ends on the same full weights, within (b)'s
    tolerances of one process on the whole batch."""
    ranks = grid['ranks']
    _assert_ranks_agree(ranks[:2], 'step')
    _assert_ranks_agree(ranks[2:], 'step')
    ref = grid['one']['step']
    for result in ranks:
        got = result['step']
        _assert_metrics(got['metrics'], ref['metrics'])
        np.testing.assert_allclose(got['metrics'][0]['grad_norm'],
                                   ref['metrics'][0]['grad_norm'], rtol=2e-4)
        for key, value in ref['params'].items():
            assert torch.equal(got['params'][key],
                               ranks[0]['step']['params'][key]), key
            np.testing.assert_allclose(got['params'][key].numpy(),
                                       value.numpy(), **PARAM_TOL,
                                       err_msg=key)


def test_em_table_is_bit_equal_across_each_model_group(grid):
    ranks = grid['ranks']
    for group in (ranks[:2], ranks[2:]):
        for a, b in zip(group[0]['em']['em_stats'],
                        group[1]['em']['em_stats']):
            assert int((a != b).sum()) == 0
    cnt = ranks[0]['em']['em_stats'][0]
    assert torch.equal(cnt, grid['one']['em']['em_stats'][0])
    assert cnt.sum() > 0


# ---------------------------------------------------------------------------
# (g) checkpoints


def test_a_world_of_one_checkpoint_restores_sharded_and_saves_again(two):
    """Each rank restores its slices of the world of one's payload, and
    gathered again they are the payload, weights and moments, bit for
    bit."""
    saved = two['saved_one']
    for rank, result in enumerate(two['ranks']):
        got = result['round_trip']
        specs = two['ranks'][0]['vanilla']['specs']
        world = pdata.World(rank=rank, size=MODEL, model_size=MODEL)
        want = tp.shard_state_dict(saved['Model'], world, specs)
        for name, value in want.items():
            assert torch.equal(got['shards'][name], value), name
        again = got['payload']
        for name, value in saved['Model'].items():
            assert torch.equal(again['Model'][name], value), name
        for key in ('mu', 'nu'):
            assert set(again['Optimizer'][key]) == set(
                saved['Optimizer'][key])
            for name, value in saved['Optimizer'][key].items():
                assert torch.equal(again['Optimizer'][key][name], value), \
                    (key, name)


def test_a_sharded_checkpoint_loads_in_a_world_of_one(two):
    """The payload a sharded run saves has a world of one's layout: it
    loads strictly into one process, weights and moments bit for bit,
    and lies within (b)'s tolerances of the world of one's own."""
    saved = two['ranks'][0]['saved']
    for other in two['ranks'][1:]:
        for name, value in saved['Model'].items():
            assert torch.equal(other['saved']['Model'][name], value)
    config = one_config(two['pcfg'])
    model = load_state_dict(build_model(config), random_state_dict(
        config, 7)).prepare(fold=False)
    optimizer = make_optimizer(config, model.parameters())
    restore_train_state(model, optimizer, saved)
    for name, value in model.state_dict().items():
        assert torch.equal(value, saved['Model'][name]), name
    names = dict(model.named_parameters())
    reread = optimizer.state_dict(model)
    for key in ('mu', 'nu'):
        for name, value in saved['Optimizer'][key].items():
            assert value.shape == names[name].shape
            assert torch.equal(reread[key][name], value), (key, name)
    ref = two['saved_one']
    for name, value in ref['Model'].items():
        np.testing.assert_allclose(saved['Model'][name].numpy(),
                                   value.numpy(), **PARAM_TOL, err_msg=name)
    payload = train_payload(model, optimizer, 1, 0, 0, torch.Generator())
    assert payload['world_size'] == 1


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tp_trainer'))
    sound = tiny_config().sound
    write_pattern_archive(os.path.join(root, 'train'), 9, sound, 0,
                          mel=(30, 60), text=(8, 14))
    write_pattern_archive(os.path.join(root, 'eval'), 4, sound, 1,
                          mel=(30, 60), text=(8, 14))
    tsv = write_inference_tsv(os.path.join(root, 'sentences.tsv'),
                              ['The birch canoe slid.'])
    cfg = trainer_config(tp_config(tiny_config()), root, num_workers=1,
                         max_step=4, checkpoint_save_interval=2,
                         logging_interval=2, evaluation_interval=4,
                         inference_interval=4,
                         inference_pattern_file_in_train=tsv)

    def run(name):
        return dataclasses.replace(
            cfg, checkpoint_path=os.path.join(root, name, 'ckpt'),
            log_path=os.path.join(root, name, 'log'),
            inference_path=os.path.join(root, name, 'inf'))
    runs = {'whole': run('whole'), 'stopped': run('stopped'),
            'resumed': run('stopped')}
    ranks = worker.spawn({'kind': 'trainer', 'config': cfg, 'runs': runs},
                         os.path.join(root, 'job'))
    return dict(root=root, ranks=ranks)


def test_a_stopped_tp_run_resumes_bit_for_bit(trained):
    """Both ranks take the same batches (one data share); a stop on rank 1
    after step 2 stops both, and the resumed run repeats the
    uninterrupted one: losses, full weights, generators."""
    for result in trained['ranks']:
        whole = result['whole']
        assert (whole['start'], whole['step']) == (0, 4)
        assert whole['batches'] == trained['ranks'][0]['whole']['batches']
        stopped, resumed = result['stopped'], result['resumed']
        assert stopped['step'] == 2 and stopped['interrupted']
        assert (resumed['start'], resumed['step']) == (2, 4)
        assert stopped['batches'] + resumed['batches'] == whole['batches']
        for key, value in whole['params'].items():
            assert torch.equal(resumed['params'][key], value), key
        assert torch.equal(resumed['generator'], whole['generator'])
        assert any(dim is not None for dim in whole['specs'].values())
    main = trained['ranks'][0]
    for tag, values in main['whole']['logged']['train'].items():
        if tag.startswith('Loss/'):
            parts = (main['stopped']['logged']['train'].get(tag, [])
                     + main['resumed']['logged']['train'].get(tag, []))
            assert parts == values, tag


def test_rank_zero_writes_and_its_model_group_decodes(trained):
    """Only rank 0 saves; both ranks of its model group decode in the
    evaluation and serve the inference file (rank 0 writes it); the
    checkpoint holds the full weights, the histograms every parameter."""
    main, other = trained['ranks']
    for run in ('whole', 'stopped', 'resumed'):
        assert all(rank == 0 for rank, _ in main[run]['saves'])
        assert other[run]['saves'] == []
    assert main['whole']['free_running'] and other['whole']['free_running']
    root = trained['root']
    payload = torch.load(os.path.join(root, 'whole', 'ckpt', 'S_4.pt'),
                         weights_only=True)
    assert (payload['world_size'], len(payload['generators'])) == (2, 2)
    assert torch.equal(*payload['generators'])      # one data index
    for name, value in main['whole']['params'].items():
        assert torch.equal(payload['Model'][name], value), name
    model = PortGlowTTS(one_config(tp_config(tiny_config())))
    model.load_state_dict(payload['Model'], strict=True)
    assert len(main['whole']['histograms']) == len(
        list(model.parameters()))
    assert os.listdir(os.path.join(root, 'whole', 'inf')) == ['Step-4']
    assert os.listdir(os.path.join(root, 'whole', 'inf', 'Step-4'))


# ---------------------------------------------------------------------------
# (h) the configuration and the launch


def test_check_world_wants_data_by_model_ranks():
    config = load_config({'TPU': {'model_parallel': 2},
                          'Train': {'Batch_Size': 4}})
    pdata.check_world(config, pdata.World(size=4, model_size=2))
    pdata.check_world(config, pdata.World(size=2, model_size=2))
    with pytest.raises(ValueError, match='model groups have 1'):
        pdata.check_world(config, pdata.World(size=4))
    with pytest.raises(ValueError, match='2 but 3 processes'):
        pdata.check_world(config, pdata.World(size=3, model_size=2))
    fixed = dataclasses.replace(config, data_parallel=2)
    with pytest.raises(ValueError, match='launch 4'):
        pdata.check_world(fixed, pdata.World(size=2, model_size=2))
    odd = load_config({'TPU': {'model_parallel': 2},
                       'Train': {'Batch_Size': 3}})
    with pytest.raises(ValueError, match='must divide by process count 2'):
        pdata.check_world(odd, pdata.World(size=4, model_size=2))
    world = pdata.World(rank=5, size=6, model_size=2)
    assert (world.data_index, world.model_index, world.data_size) == (2, 1,
                                                                      3)


def test_ranks_to_launch_is_data_by_model(monkeypatch):
    config = load_config({'TPU': {'model_parallel': 2}})
    assert pdata.ranks_to_launch(config, 'cpu') == 2
    assert pdata.ranks_to_launch(dataclasses.replace(
        config, data_parallel=2), 'cpu') == 4
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert pdata.ranks_to_launch(config, 'cuda') == 4
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='one card per rank'):
        pdata.ranks_to_launch(config, 'cuda')
    assert pdata.ranks_to_launch(config, 'cuda', backend='gloo') == 2


def test_the_cli_starts_both_model_ranks(tmp_path):
    """``glow-tts-torch-train`` with no launcher and ``model_parallel`` 2
    starts the two ranks of one model group itself (on the CPU, over
    gloo); the checkpoint holds a world of one's weights."""
    from glow_tts_tpu_torch.cli import train_main
    from glow_tts_tpu_torch.config import save_config
    root = str(tmp_path)
    sound = tiny_config().sound
    write_pattern_archive(os.path.join(root, 'train'), 8, sound, 0,
                          mel=(30, 60), text=(8, 14))
    write_pattern_archive(os.path.join(root, 'eval'), 4, sound, 1,
                          mel=(30, 60), text=(8, 14))
    cfg = trainer_config(tp_config(tiny_config(), data=0), root,
                         num_workers=1, max_step=2,
                         checkpoint_save_interval=2, logging_interval=2,
                         evaluation_interval=100, inference_interval=100)
    hp = os.path.join(root, 'hp.yaml')
    save_config(cfg, hp)
    train_main(['-hp', hp, '--device', 'cpu'])
    payload = torch.load(os.path.join(cfg.checkpoint_path, 'S_2.pt'),
                         weights_only=True)
    assert (payload['Steps'], payload['world_size']) == (2, MODEL)
    model = PortGlowTTS(one_config(cfg))
    model.load_state_dict(payload['Model'], strict=True)
