"""Data parallelism of the PyTorch port (``glow_tts_tpu_torch/parallel/
data.py``, ``training/{losses,step,checkpoint,trainer}.py``, ``cli.py``) on
the CPU: two ranks over gloo, each a process spawned by
``tests/torch_dp_worker.py`` (one spawn for the train steps, one for the
``Trainer``), at ``tests/helpers.py::tiny_config`` size, every dropout
rate 0 where results are compared across frameworks.

* (a) 2 ranks, each on its half of one collated batch, against the JAX
  package's train step sharded over a 2-device ``data`` mesh of the
  virtual CPU devices on the whole batch (``tests/test_sharding.py``'s
  pattern), 3 steps: the losses rtol 2e-5, ``grad_norm`` rtol 2e-4, the
  parameters after rtol 5e-4 / atol 5e-5, the tolerances of
  ``tests/test_torch_train_step.py``; both ranks' parameters bit-equal.
  At bf16 (one step, the mesh's MAS paths handed to the port): the
  2-rank split moves the port's gradients by the order the 2-way mesh
  moves JAX's, within the bf16 bar of one process, and the 2 ranks land
  on JAX's mesh as one process lands on JAX's one device.
* (b) 2 ranks on halves collated apart (other paddings than the whole
  batch's) against 1 rank on the whole batch: the same tolerances, and
  the first update's summed gradients leaf by leaf rtol 2e-4 / atol 2e-5.
* (c) rank r's flow-dropout seed at step k is ``shard_seed(flow_seed(0,
  k), r)``, and its masks are the JAX package's shard-r masks,
  ``keep_scale(layer_salt(seed + r·0x68E31DA4, …))``, bit for bit.
* (d) one 'em' step (the warmup with the decoder frozen): the 2-rank
  table statistics bit-equal between the ranks and equal to the 1-rank
  table on the same samples (counts exactly; sums rtol 1e-5 / atol 1e-4,
  ``tests/test_torch_curriculum.py``'s bar), the losses rtol 2e-5.
* (e) a ``Trainer`` on each rank over 11 train patterns (6 and 5 a rank,
  so 3 and 2 batches an epoch: both ranks take 2) with dropout on: the
  same steps on both ranks; only rank 0 saves, logs, decodes and runs
  inference; a run that rank 1 stops with SIGTERM after step 2 stops both
  ranks there, and resumed it repeats the uninterrupted run bit for bit
  (losses, weights, each rank's own generator state).
* (f) ``load_config`` takes ``TPU.data_parallel`` without a warning (both
  shipped YAMLs), and ``model_parallel`` above 1 too (tensor parallelism,
  ``tests/test_torch_tensor_parallel.py``), raises on a batch that does
  not divide; ``check_world`` and ``ranks_to_launch`` (0
  is every visible card); ``glow-tts-torch-train`` with no launcher and
  ``data_parallel`` 2 starts both ranks itself; a checkpoint restored at
  another world size re-seeds each rank's generator.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops import dropmask as jdrop
from glow_tts_tpu.parallel import mesh as mesh_lib
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.training.optim import make_optimizer as jax_make_optimizer
from glow_tts_tpu_torch.config import load_config
from glow_tts_tpu_torch.data.collate import TrainCollater
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.ops import dropmask as tdrop
from glow_tts_tpu_torch.parallel import data as pdata
from glow_tts_tpu_torch.text import Tokenizer
from glow_tts_tpu_torch.training.step import flow_seed
from glow_tts_tpu_torch.weights import load_jax_params, reference_to_params
from tests import torch_dp_worker as worker
from tests.helpers import tiny_config
from tests.torch_patterns import (trainer_config, write_inference_tsv,
                                  write_pattern_archive)
from tests.torch_port_helpers import (GRAD_ATOL, GRAD_FACTOR, at_dtype,
                                      norm_rel, port_config, with_backend,
                                      with_dropout)

LOSS_RTOL = 2e-5
NORM_RTOL = 2e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-4)
STEPS = 3
RANKS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# four utterances, the first half short and the second long, so the
# halves collated apart pad to other lengths than the whole batch
TEXT_CHARS = (5, 6, 11, 12)
MEL_FRAMES = (20, 22, 36, 40)
BUCKETS = dict(token_bucket=4, mel_bucket=8)
EM_TRAIN = {'Batch_Size': 4,
            'Learning_Rate': {'Initial': 1.0e-3, 'Base': 100},
            'ADAM': {'Beta1': 0.9, 'Beta2': 0.999, 'Epsilon': 1.0e-6},
            'Weight_Decay': 1.0e-6, 'Gradient_Norm': 5.0,
            'Alignment_Warmup_Mode': 'em', 'Alignment_Warmup_Steps': 10,
            'Decoder_Freeze_Steps': 10, 'Anchor_Pause_Tokens': [2],
            'Anchor_Silence_Level': -3.5}


def _items(config):
    rng = np.random.default_rng(16)
    letters = np.array(list('ABCDEFGHIJKLMNOPQRSTUVWXYZ'))
    items = []
    for chars, frames in zip(TEXT_CHARS, MEL_FRAMES):
        text = rng.choice(letters, chars)
        text[2::4] = ' '
        mel = rng.uniform(-4, 4, (frames, config.sound.mel_dim))
        mel[:, :] -= 2.0 * (np.arange(frames) % 7 == 0)[:, None]
        items.append({'text': ''.join(text), 'mel': mel.astype(np.float32)})
    return items


def _jax_grads(cfg, params, whole, mesh=None):
    """JAX's first gradients of ``whole``'s total loss from ``params``, as
    its train step takes them, on one device or sharded over ``mesh``'s
    ``data`` axis (the train step's shardings), by leaf name, with the MAS
    paths of the forward."""
    model = jstep.build_model(cfg)

    def loss(p, batch):
        out = model.apply({'params': p}, deterministic=False,
                          rngs={'dropout': jax.random.PRNGKey(1)},
                          tokens=batch['tokens'],
                          token_lengths=batch['token_lengths'],
                          mels=batch['mels'], mel_lengths=batch['mel_lengths'])
        return jstep.compute_losses(cfg, out, batch)['total'], \
            out['attentions']

    grad = jax.grad(loss, has_aux=True)
    if mesh is None:
        grads, paths = jax.jit(grad)(
            params, {key: jnp.asarray(value) for key, value in whole.items()})
    else:
        rep = mesh_lib.replicated(mesh)
        with mesh_lib.activate_mesh(mesh):
            grads, paths = jax.jit(
                grad, in_shardings=(rep, mesh_lib.batch_sharding(mesh)),
                out_shardings=(rep, rep))(jax.device_put(params, rep),
                                           mesh_lib.shard_batch(mesh, whole))
    return ({jax.tree_util.keystr(path): np.asarray(value) for path, value
             in jax.tree_util.tree_leaves_with_path(grads)},
            np.asarray(paths))


def _halves(batch):
    half = len(batch['tokens']) // RANKS
    return [{key: value[r * half:(r + 1) * half]
             for key, value in batch.items()} for r in range(RANKS)]


def dp_problem():
    """The batch and weights of these tests: ``tiny_config`` under
    ``'flax'`` with every dropout rate 0 (the JAX config, and the port's
    with the buckets above), the items, the whole batch collated, and the
    JAX model, train state and parameters (perturbed by 0.03, numpy)."""
    jcfg = with_backend(with_dropout(tiny_config(), 0.0), 'flax')
    pcfg = dataclasses.replace(port_config(jcfg), **BUCKETS)
    items = _items(pcfg)
    whole = TrainCollater(pcfg, Tokenizer())(items)
    model, state = jstep.create_train_state(jcfg, jax.random.PRNGKey(0),
                                            whole)
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * rng.standard_normal(
            p.shape).astype(np.float32), state.params)
    return jcfg, pcfg, items, whole, model, state, params


@pytest.fixture(scope='module')
def stepped(tmp_path_factory):
    """The JAX mesh step, the ranks' steps in every scenario, and one rank
    on the whole batch where it is the reference."""
    jcfg, pcfg, items, whole, model, state, params = dp_problem()
    collate = TrainCollater(pcfg, Tokenizer())
    apart = [collate(items[r * 2:(r + 1) * 2]) for r in range(RANKS)]

    # the JAX package's step on the whole batch, sharded over 'data'
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jax_make_optimizer(jcfg).init(params))
    mesh = mesh_lib.make_mesh(jcfg, jax.devices()[:RANKS])
    assert mesh.shape['data'] == RANKS
    rep = mesh_lib.replicated(mesh)
    step = jax.jit(jstep.make_train_step(jcfg, model),
                   in_shardings=(rep, mesh_lib.batch_sharding(mesh)),
                   out_shardings=(rep, rep))
    state = jax.device_put(state, rep)
    sharded = mesh_lib.shard_batch(mesh, whole)
    jax_metrics = []
    for _ in range(STEPS):
        state, metrics = step(state, sharded)
        jax_metrics.append({key: float(v) for key, v in metrics.items()})

    port_state = load_jax_params(PortGlowTTS(pcfg), params,
                                 pcfg).state_dict()
    # bf16: JAX's first gradients on one device and on the 2-way mesh,
    # and the f32 ones; the mesh's MAS paths go to the port's steps
    j16 = at_dtype(jcfg, 'bfloat16')
    jax_grads = {'f32': _jax_grads(jcfg, params, whole)[0],
                 'one': _jax_grads(j16, params, whole)[0]}
    jax_grads['mesh'], paths = _jax_grads(j16, params, whole, mesh)
    pcfg16 = dataclasses.replace(port_config(j16), **BUCKETS)
    em_cfg = dataclasses.replace(port_config(with_dropout(
        tiny_config(Train=EM_TRAIN), 0.0)), **BUCKETS)
    em_apart = [TrainCollater(em_cfg, Tokenizer())(items[r * 2:(r + 1) * 2])
                for r in range(RANKS)]
    scenarios = {
        'halves': {'config': pcfg, 'batches': _halves(whole),
                   'steps': STEPS},
        'apart': {'config': pcfg, 'batches': apart, 'steps': STEPS},
        'em': {'config': em_cfg, 'batches': em_apart, 'steps': 1,
               'em': True},
        'bf16': {'config': pcfg16, 'batches': _halves(whole), 'steps': 1,
                 'paths': [[half] for half in np.split(paths, RANKS)]}}
    ranks = worker.spawn({'kind': 'steps', 'config': pcfg,
                          'state': port_state, 'scenarios': scenarios},
                         str(tmp_path_factory.mktemp('dp_steps')))
    one = {'apart': worker.train_steps(pcfg, port_state, whole, STEPS,
                                       pdata.SINGLE),
           'em': worker.train_steps(
               em_cfg, port_state,
               TrainCollater(em_cfg, Tokenizer())(items), 1, pdata.SINGLE,
               em=True),
           'bf16': worker.train_steps(pcfg16, port_state, whole, 1,
                                      pdata.SINGLE, paths=[paths])}
    return dict(jax_metrics=jax_metrics, jax_params=state.params,
                pcfg=pcfg, ranks=ranks, one=one, whole=whole, apart=apart,
                jax_grads=jax_grads)


def _assert_metrics(got, ref, keys=('total', 'mle', 'duration')):
    for key in keys:
        np.testing.assert_allclose([m[key] for m in got],
                                   [m[key] for m in ref], rtol=LOSS_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose([m['grad_norm'] for m in got],
                               [m['grad_norm'] for m in ref],
                               rtol=NORM_RTOL)


def _assert_ranks_agree(ranks, scenario):
    """Every rank holds the same weights and reports the same metrics."""
    first = ranks[0][scenario]
    for other in ranks[1:]:
        assert other[scenario]['metrics'] == first['metrics']
        for key, value in first['params'].items():
            assert torch.equal(other[scenario]['params'][key], value), key


def test_two_ranks_match_the_jax_mesh_sharded_step(stepped):
    """(a): halves of one collated batch against JAX's 2-way mesh."""
    _assert_ranks_agree(stepped['ranks'], 'halves')
    got = stepped['ranks'][0]['halves']
    _assert_metrics(got['metrics'], stepped['jax_metrics'])
    assert got['metrics'][-1]['total'] < got['metrics'][0]['total']
    ported = dict(jax.tree_util.tree_leaves_with_path(
        reference_to_params(got['params'], stepped['pcfg'])))
    leaves = jax.tree_util.tree_leaves_with_path(stepped['jax_params'])
    assert len(leaves) > 100
    for path, value in leaves:
        np.testing.assert_allclose(ported[path], np.asarray(value),
                                   **PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_two_ranks_on_halves_collated_apart_match_one_rank(stepped):
    """(b): each rank's own padding against the whole batch's."""
    whole, apart = stepped['whole'], stepped['apart']
    assert [a['tokens'].shape[1] for a in apart] == [8, 16]
    assert [a['mels'].shape[1] for a in apart] == [24, 40]
    assert (whole['tokens'].shape[1], whole['mels'].shape[1]) == (16, 40)
    _assert_ranks_agree(stepped['ranks'], 'apart')
    got, ref = stepped['ranks'][0]['apart'], stepped['one']['apart']
    _assert_metrics(got['metrics'], ref['metrics'])
    assert set(got['grads']) == set(ref['grads'])
    for name, value in ref['grads'].items():
        np.testing.assert_allclose(got['grads'][name].numpy(),
                                   value.numpy(), **GRAD_TOL, err_msg=name)
    for key, value in ref['params'].items():
        np.testing.assert_allclose(got['params'][key].numpy(),
                                   value.numpy(), **PARAM_TOL, err_msg=key)


def test_rank_flow_masks_are_the_jax_shard_masks(stepped):
    """(c): rank r's seed and masks are JAX's shard r's."""
    wavenet = stepped['pcfg'].decoder.affine_coupling.wavenet
    layers, rate = wavenet.num_layers, 0.05
    b, t, k, cols = 2, 20, wavenet.kernel_size, 32
    for rank, result in enumerate(stepped['ranks']):
        seeds = result['halves']['seeds']
        assert len(seeds) == STEPS
        for step, seed in enumerate(seeds):
            base = flow_seed(0, step)
            assert seed == pdata.shard_seed(base, rank)
            if rank == 0:
                assert seed == base        # the single-card seed
            jseed = jnp.int32(base) + jnp.int32(rank) * np.int32(0x68E31DA4)
            assert int(jseed) == seed
            for flow in range(2):
                for layer in range(layers):
                    got = tdrop.stack_mask(seed, flow, layer, layers, b, t,
                                           k, cols, rate)
                    salt = jdrop.layer_salt(jseed, flow, layer, layers)
                    for sample in range(b):
                        ref = jdrop.keep_scale(salt, sample * (t + k - 1),
                                               (t, cols), cols, rate)
                        np.testing.assert_array_equal(got[sample].numpy(),
                                                      np.asarray(ref))
    assert (stepped['ranks'][0]['halves']['seeds']
            != stepped['ranks'][1]['halves']['seeds'])


@pytest.mark.parametrize('seed', [0, 1234, 2 ** 31 - 1, -1, -2 ** 31])
@pytest.mark.parametrize('rank', [0, 1, 7, 63])
def test_shard_seed_is_jax_int32_arithmetic(seed, rank):
    ref = jnp.int32(seed) + jnp.int32(rank) * np.int32(0x68E31DA4)
    assert pdata.shard_seed(seed, rank) == int(ref)


def test_em_step_table_is_the_global_batch_table(stepped):
    """(d): the ranks' table statistics summed before they are merged."""
    ranks = stepped['ranks']
    ref = stepped['one']['em']
    for result in ranks:
        for got, other in zip(result['em']['em_stats'],
                              ranks[0]['em']['em_stats']):
            assert torch.equal(got, other)
    cnt, s0, s1 = ranks[0]['em']['em_stats']
    assert torch.equal(cnt, ref['em_stats'][0]) and cnt.sum() > 0
    for got, want in zip((s0, s1), ref['em_stats'][1:]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **STATS_TOL)
    _assert_metrics(ranks[0]['em']['metrics'], ref['metrics'],
                    keys=('total', 'mle', 'duration', 'distill'))


def _port_grads(result, pcfg):
    """A worker's first gradients by the JAX package's leaf names."""
    return {jax.tree_util.keystr(path): np.asarray(value) for path, value
            in jax.tree_util.tree_leaves_with_path(reference_to_params(
                result['grads'], pcfg))}


def test_bf16_ranks_split_like_the_jax_mesh(stepped):
    """(a) at bf16, one step from the same f32 weights, the JAX mesh's MAS
    paths handed to the port's steps.  Splitting the batch over 2 ranks
    moves the port's bf16 gradients by the same order as the 2-way mesh
    moves JAX's (a bf16 weight gradient is rounded per shard before the
    sum): the worst leaves within a factor 10 of each other, neither
    zero.  Leaf by leaf the split stays within the bf16 bar of one
    process, at most twice its distance from f32 plus 1e-4 (the bar
    ``chip_smoke.py``'s gloo phase holds on the card), and the 2 ranks
    land on JAX's mesh as one process lands on JAX's one device: no
    further than that plus the larger of the two splits and 1e-4.  The
    bf16 bar of ``assert_bf16_grads`` against JAX (at most twice JAX's
    bf16-vs-f32 distance from JAX's bf16, plus 1e-4) is not held here:
    on this batch one process misses it on 18 of 113 leaves, at most 1.70
    times over, and so do the 2 ranks; leaves near it cross it either way
    with the split (``PERF.md`` §6).  The miss is XLA's excess
    precision in JAX's jitted step, not a cast of the port's:
    ``tests/test_torch_bf16_encoder_walk.py`` walks the encoder layer by
    layer on this batch and names the op (``ROADMAP.md`` C.2)."""
    pcfg, jg = stepped['pcfg'], stepped['jax_grads']
    two = _port_grads(stepped['ranks'][0]['bf16'], pcfg)
    one = _port_grads(stepped['one']['bf16'], pcfg)
    f32 = _port_grads(stepped['one']['apart'], pcfg)
    assert len(two) > 100 and set(two) == set(jg['mesh'])
    floor = 1e-5 * max(np.linalg.norm(v) for v in jg['f32'].values())
    port_split = jax_split = 0.0
    for key, ref in jg['f32'].items():
        if np.linalg.norm(ref) < floor:      # blind leaves: rounding noise
            continue
        split = norm_rel(two[key], one[key])
        assert split <= GRAD_FACTOR * norm_rel(one[key], f32[key]) \
            + GRAD_ATOL, key
        mesh_split = norm_rel(jg['mesh'][key], jg['one'][key])
        port_split, jax_split = (max(port_split, split),
                                 max(jax_split, mesh_split))
        assert norm_rel(two[key], jg['mesh'][key]) <= norm_rel(
            one[key], jg['one'][key]) + max(split, mesh_split) \
            + GRAD_ATOL, key
    assert port_split > 0 and jax_split > 0
    assert 0.1 <= port_split / jax_split <= 10.0, (port_split, jax_split)


# ---------------------------------------------------------------------------
# (e) the trainer


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dp_trainer'))
    sound = tiny_config().sound
    write_pattern_archive(os.path.join(root, 'train'), 11, sound, 0,
                          mel=(30, 60), text=(8, 14))
    write_pattern_archive(os.path.join(root, 'eval'), 5, sound, 1,
                          mel=(30, 60), text=(8, 14))
    tsv = write_inference_tsv(os.path.join(root, 'sentences.tsv'),
                              ['The birch canoe slid.'])
    cfg = trainer_config(port_config(tiny_config()), root, num_workers=1,
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


def test_every_rank_takes_the_same_steps(trained):
    whole = [r['whole'] for r in trained['ranks']]
    for result in whole:
        assert (result['start'], result['step']) == (0, 4)
        assert len(result['batches']) == 4
        assert all(len(b) == 2 for b in result['batches'])
    # 6 and 5 patterns: 3 and 2 batches of 2 an epoch, 2 taken by both
    assert whole[0]['batches'] != whole[1]['batches']


def test_only_rank_zero_writes(trained):
    main, other = trained['ranks']
    for run in ('whole', 'stopped', 'resumed'):
        assert all(rank == 0 for rank, _ in main[run]['saves'])
        assert other[run]['saves'] == []
        assert other[run]['writers'] == {'train': 'NullWriter',
                                         'eval': 'NullWriter'}
        assert main[run]['writers'] == {'train': 'MemoryWriter',
                                        'eval': 'MemoryWriter'}
    assert [step for _, step in main['whole']['saves']] == [2, 4, 4]
    assert main['whole']['free_running'] and \
        not other['whole']['free_running']
    assert main['whole']['logged']['train']['Loss/total']
    root = trained['root']
    assert sorted(os.listdir(os.path.join(root, 'whole', 'ckpt'))) == [
        'Hyper_Parameters.yaml', 'S_2.pt', 'S_4.pt']
    payload = torch.load(os.path.join(root, 'whole', 'ckpt', 'S_4.pt'),
                         weights_only=True)
    assert payload['world_size'] == RANKS
    assert len(payload['generators']) == RANKS
    assert torch.equal(payload['generator'], payload['generators'][0])
    assert torch.equal(payload['generators'][1], other['whole']['generator'])
    assert os.listdir(os.path.join(root, 'whole', 'inf')) == ['Step-4']


def test_a_stop_on_one_rank_stops_both_and_the_resume_repeats(trained):
    for rank, result in enumerate(trained['ranks']):
        stopped, resumed = result['stopped'], result['resumed']
        assert stopped['step'] == 2 and stopped['interrupted']
        assert (resumed['start'], resumed['step']) == (2, 4)
        whole = result['whole']
        assert stopped['batches'] + resumed['batches'] == whole['batches']
        for key, value in whole['params'].items():
            assert torch.equal(resumed['params'][key], value), (rank, key)
        assert torch.equal(resumed['generator'], whole['generator'])
    main = trained['ranks'][0]
    assert main['stopped']['interrupted'] == 'stopped by another rank'
    assert trained['ranks'][1]['stopped']['interrupted'] == 'SIGTERM'
    for writer in ('train', 'eval'):
        whole = main['whole']['logged'][writer]
        parts = {tag: main['stopped']['logged'][writer].get(tag, [])
                 + main['resumed']['logged'][writer].get(tag, [])
                 for tag in whole}
        losses = [tag for tag in whole if tag.startswith('Loss/')]
        assert losses
        for tag in losses:
            assert parts[tag] == whole[tag], tag
    # the ranks draw their own encoder dropout
    assert not torch.equal(main['whole']['generator'],
                           trained['ranks'][1]['whole']['generator'])


# ---------------------------------------------------------------------------
# (f) the configuration


@pytest.fixture
def fresh(monkeypatch):
    from glow_tts_tpu_torch import config as tconfig
    monkeypatch.setattr(tconfig, '_WARNED', set())


def _load(data):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        config = load_config(data)
    return config, [str(w.message) for w in caught]


@pytest.mark.parametrize('name', ['Hyper_Parameters.yaml',
                                  'MiniSpeech.yaml'])
def test_shipped_yamls_take_every_card_without_a_warning(fresh, name):
    config, messages = _load(os.path.join(REPO, 'configs', name))
    assert messages == []
    assert (config.data_parallel, config.model_parallel) == (0, 1)
    assert pdata.ranks_to_launch(config, 'cpu') == 1
    pdata.check_world(config, pdata.World(size=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            pdata.ranks_to_launch(config, 'cuda')


def test_model_parallel_still_warns(fresh):
    """Named for what it checked before tensor parallelism was ported:
    ``model_parallel`` 2 now loads with no warning, and is honoured."""
    config, messages = _load({'TPU': {'model_parallel': 2}})
    assert messages == []
    assert config.model_parallel == 2


@pytest.mark.parametrize('tpu,batch,error', [
    ({'data_parallel': 3}, 32, 'divide by TPU.data_parallel'),
    ({'data_parallel': -1}, 32, 'data_parallel'),
    ({'data_parallel': 4}, 32, None),
])
def test_data_parallel_loads_and_an_indivisible_batch_raises(fresh, tpu,
                                                             batch, error):
    data = {'TPU': tpu, 'Train': {'Batch_Size': batch}}
    if error:
        with pytest.raises(ValueError, match=error):
            load_config(data)
        return
    config, messages = _load(data)
    assert messages == [] and config.data_parallel == 4
    assert pdata.ranks_to_launch(config, 'cpu') == 4
    pdata.check_world(config, pdata.World(size=4))
    with pytest.raises(ValueError, match='4 but 2 processes'):
        pdata.check_world(config, pdata.World(size=2))


def test_without_a_launcher_the_world_is_one_process(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    world = pdata.initialize(load_config({}), 'cpu')
    assert world == pdata.World(device=torch.device('cpu'))
    assert (world.group, world.is_main) == (None, True)
    assert (pdata.process_index(), pdata.process_count()) == (0, 1)
    tensor = torch.arange(3.0)
    assert world.all_sum(tensor) is tensor
    assert world.host_max(4, 7) == [4, 7]
    with pytest.raises(ValueError, match='must divide by process count'):
        pdata.check_world(load_config({'Train': {'Batch_Size': 3}}),
                          pdata.World(size=2))


def test_the_launched_world_must_divide_the_batch():
    config = load_config({'Train': {'Batch_Size': 32}})
    pdata.check_world(config, pdata.World(size=8))
    with pytest.raises(ValueError, match='must divide by process count 3'):
        pdata.check_world(config, pdata.World(size=3))


def test_the_snapshot_keeps_the_parallel_fields(tmp_path):
    from glow_tts_tpu_torch.config import save_config
    config = load_config({'TPU': {'data_parallel': 2}})
    save_config(config, str(tmp_path / 'hp.yaml'))
    assert load_config(str(tmp_path / 'hp.yaml')) == config


def test_zero_is_every_visible_card(monkeypatch):
    """On a node of 4 visible cards (faked), 0 launches 4 ranks; asking
    for more ranks than cards raises, NCCL taking one card per rank."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert pdata.ranks_to_launch(load_config({}), 'cuda') == 4
    assert pdata.ranks_to_launch(
        load_config({'TPU': {'data_parallel': 2}}), 'cuda') == 2
    with pytest.raises(ValueError, match='one card per rank'):
        pdata.ranks_to_launch(load_config({'TPU': {'data_parallel': 8}}),
                              'cuda')


def test_the_cli_starts_one_process_per_rank(tmp_path):
    """``glow-tts-torch-train`` with no launcher and ``data_parallel`` 2
    starts the two ranks itself (on the CPU, over gloo)."""
    from glow_tts_tpu_torch.cli import train_main
    from glow_tts_tpu_torch.config import save_config
    root = str(tmp_path)
    sound = tiny_config().sound
    write_pattern_archive(os.path.join(root, 'train'), 8, sound, 0,
                          mel=(30, 60), text=(8, 14))
    write_pattern_archive(os.path.join(root, 'eval'), 4, sound, 1,
                          mel=(30, 60), text=(8, 14))
    cfg = dataclasses.replace(
        trainer_config(port_config(tiny_config()), root, num_workers=1,
                       max_step=2, checkpoint_save_interval=2,
                       logging_interval=2, evaluation_interval=100,
                       inference_interval=100), data_parallel=RANKS)
    hp = os.path.join(root, 'hp.yaml')
    save_config(cfg, hp)
    train_main(['-hp', hp, '--device', 'cpu'])
    payload = torch.load(os.path.join(cfg.checkpoint_path, 'S_2.pt'),
                         weights_only=True)
    assert (payload['Steps'], payload['world_size']) == (2, RANKS)
    assert not torch.equal(*payload['generators'])


def test_a_resume_at_another_world_size_reseeds_each_rank(caplog):
    """A checkpoint holds every rank's generator state: restored at the
    same world size each rank continues its own; at another it re-seeds
    from ``shard_seed(seed, rank)``, with a warning."""
    from glow_tts_tpu_torch.training.checkpoint import restore_generator
    states = [torch.Generator().manual_seed(s).get_state() for s in (5, 6)]
    payload = {'seed': 3, 'generator': states[0], 'generators': states,
               'world_size': 2}
    generator = torch.Generator()
    restore_generator(generator, payload, pdata.World(rank=1, size=2))
    assert torch.equal(generator.get_state(), states[1])
    for world in (pdata.World(rank=1, size=4), pdata.World()):
        with caplog.at_level('WARNING'):
            restore_generator(generator, payload, world)
        expected = torch.Generator().manual_seed(
            pdata.shard_seed(3, world.rank)).get_state()
        assert torch.equal(generator.get_state(), expected)
        assert 'restart from the seed' in caplog.text
    # a checkpoint of one process, written before it held 'generators'
    single = {'seed': 3, 'generator': states[1]}
    restore_generator(generator, single, pdata.World())
    assert torch.equal(generator.get_state(), states[1])
