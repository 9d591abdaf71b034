"""Data-parallel serving of the PyTorch port (``glow_tts_tpu_torch/
inference.py`` over a world of ``parallel/data.py``, and ``cli.py``) on
the CPU: gloo ranks, each a process spawned by
``tests/torch_serve_worker.py`` (one spawn per world layout), at
``tests/helpers.py::tiny_config`` size, float32, every dropout rate 0.

* data 2 × model 1 serves 5 items at ``batch_size`` 4 (a ragged last chunk,
  padded with its last item) as the port's world of one does on the same
  weights at ``noise_scale`` 0.667: every rank returns the whole list in
  item order, durations (the attention paths) and buckets equal, mels to
  1e-5; rank 0 writes each item's files exactly once and the other rank
  writes nothing; with ``export_wav`` each rank runs Griffin-Lim on its own
  items only and the gathered audio equals a world of one's to the DSP's
  bar (max error 1e-5 of the max).
* the same items against the JAX package's ``Inferencer(use_mesh=True)``
  on its data mesh of the virtual CPU devices, at ``noise_scale`` 0:
  buckets, mel lengths and attentions exactly, mels to MAE 1e-4
  (``tests/test_torch_inference.py``'s bar).
* data 2 × model 2 (4 ranks), GR (speaker ids, reference mels and pitch
  split with the rows), 3 items in one chunk against the world of one at
  the same bars.
* ``glow-tts-torch-infer`` with ``TPU.data_parallel`` 2 and no launcher
  starts 2 ranks, prints and writes the inference file's items once.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.inference import Inferencer as JaxInferencer
from glow_tts_tpu.training import checkpoint as jckpt
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu_torch.inference import Inferencer, bucket_ladder
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.parallel import data as pdata
from glow_tts_tpu_torch.training.checkpoint import CheckpointManager
from glow_tts_tpu_torch.weights import load_jax_params
from tests import torch_serve_worker as worker
from tests.helpers import synthetic_batch, tiny_config
from tests.torch_patterns import write_inference_tsv
from tests.torch_port_helpers import port_config, with_backend, with_dropout

MEL_ATOL = 1e-5
JAX_MEL_MAE = 1e-4
DSP_REL = 1e-5
BUCKETS, MAX_MEL = [16, 32, 48], 64
BATCH = 4
NOISE = 0.667
GRIFFIN_ITERATIONS = 4
TEXTS = ['HELLO WORLD.', 'A SHORT LINE OF TEXT HERE.', 'SEVEN.',
         'MUCH LONGER, IT NEEDS MORE FRAMES THAN THE OTHERS.',
         'THE LAST ONE IS ALONE IN ITS CHUNK.']


def jax_config(mode='Vanilla'):
    return with_dropout(with_backend(tiny_config(mode), 'flax'), 0.0)


def perturbed(jcfg, seed):
    """The JAX train state with parameters perturbed by 0.03 (a live end
    conv), and those parameters as numpy."""
    batch = synthetic_batch(jcfg, batch=4)
    _, state = jstep.create_train_state(jcfg, jax.random.PRNGKey(seed),
                                        batch)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.03 * rng.standard_normal(
            p.shape).astype(np.float32), state.params)
    return state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                       params)), params


def port_state(pcfg, params):
    return load_jax_params(PortGlowTTS(pcfg), params, pcfg).state_dict()


def grid(pcfg, data, model=1):
    return dataclasses.replace(pcfg, data_parallel=data,
                               model_parallel=model)


def case(config, state, items, **synthesize):
    return {'config': config, 'state': state, 'items': items,
            'inferencer': {'batch_size': BATCH, 'max_mel_length': MAX_MEL,
                           'mel_buckets': BUCKETS},
            'synthesize': synthesize}


def vanilla_items():
    return [{'label': f'u{i}', 'text': text, 'length_scale': 1.0 + 0.2 * i}
            for i, text in enumerate(TEXTS)]


def gr_items(config):
    rng = np.random.default_rng(8)
    items = []
    for i, frames in enumerate((30, 17, 41)):
        items.append({
            'label': f'g{i}', 'text': TEXTS[i], 'length_scale': 1.0,
            'speaker_id': i + 1,
            'mel_for_prosody': rng.standard_normal(
                (frames, config.sound.mel_dim)).astype(np.float32),
            'pitch': rng.uniform(0.0, 1.0, frames + 3).astype(np.float32)})
    return items


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """One spawn of data 2 (Vanilla: the noisy run with its files and
    wavs, and the noiseless one), one of data 2 × model 2 (GR), the world
    of one's runs and the JAX mesh's."""
    root = tmp_path_factory.mktemp('dp_serving')
    jcfg, gcfg = jax_config(), jax_config('GR')
    jstate, params = perturbed(jcfg, 0)
    _, gparams = perturbed(gcfg, 1)
    pcfg, gpcfg = port_config(jcfg), port_config(gcfg)
    state, gstate = port_state(pcfg, params), port_state(gpcfg, gparams)
    items, gitems = vanilla_items(), gr_items(gpcfg)

    def cases(config, gconfig, out):
        return {
            'noisy': case(config, state, items, noise_scale=NOISE, seed=3,
                          out_dir=os.path.join(root, out), export_wav=True,
                          griffin_lim_iterations=GRIFFIN_ITERATIONS),
            'still': case(config, state, items, noise_scale=0.0),
            'gr': case(gconfig, gstate, gitems, noise_scale=NOISE, seed=5)}

    one = {name: worker.served(pdata.SINGLE, c) for name, c in cases(
        grid(pcfg, 0), grid(gpcfg, 0), 'one').items()}
    two = cases(grid(pcfg, 2), None, 'two')
    del two['gr']
    ranks = worker.spawn({'config': grid(pcfg, 2), 'cases': two},
                         str(root / 'job2'), ranks=2)
    four = {'gr': case(grid(gpcfg, 2, 2), gstate, gitems, noise_scale=NOISE,
                       seed=5)}
    grid_ranks = worker.spawn({'config': grid(gpcfg, 2, 2), 'cases': four},
                              str(root / 'job4'), ranks=4)

    checkpoint = str(root / 'jax_checkpoint')
    manager = jckpt.CheckpointManager(checkpoint, jcfg)
    manager.save(1, jstate, wait=True)
    manager.close()
    meshed = JaxInferencer(checkpoint, config=jcfg, batch_size=BATCH,
                           max_mel_length=MAX_MEL, use_mesh=True,
                           mel_buckets=BUCKETS)
    assert meshed.mesh is not None and meshed.mesh.shape['data'] > 2
    jax_results = meshed.synthesize_items(items, noise_scale=0.0)
    return {'one': one, 'ranks': ranks, 'grid': grid_ranks,
            'jax': jax_results, 'items': items, 'gitems': gitems,
            'out_dirs': {'two': os.path.join(root, 'two')}}


def assert_same(got, ref):
    """Item order, buckets and durations (the 0/1 attention paths) equal,
    mels to ``MEL_ATOL``."""
    assert [r['label'] for r in got] == [r['label'] for r in ref]
    for g, r in zip(got, ref):
        assert g['bucket'] == r['bucket'], g['label']
        np.testing.assert_array_equal(g['attention'], r['attention'],
                                      err_msg=g['label'])
        assert g['mel'].shape == r['mel'].shape, g['label']
        np.testing.assert_allclose(g['mel'], r['mel'], rtol=0,
                                   atol=MEL_ATOL, err_msg=g['label'])


@pytest.mark.parametrize('rank', [0, 1])
@pytest.mark.parametrize('name', ['noisy', 'still'])
def test_data_two_serves_a_world_of_ones_results(served, name, rank):
    assert_same(served['ranks'][rank][name]['results'],
                served['one'][name]['results'])


def test_the_ranks_agree_on_a_bucket_neither_picks_alone(served):
    """In the first chunk rank 0's items (0, 1) fit a smaller bucket than
    rank 1's (2, 3): rank 0 decoded in the larger one all the same."""
    ladder = bucket_ladder(MAX_MEL, jax_config().decoder.num_squeeze,
                           BUCKETS)
    results = served['one']['still']['results']

    def alone(indices):
        need = max(int(results[i]['attention'].sum()) for i in indices)
        return next((b for b in ladder if b >= need), ladder[-1])
    assert alone([0, 1]) < alone([2, 3]) == results[0]['bucket']
    assert served['ranks'][0]['still']['results'][0]['bucket'] == \
        alone([2, 3])


def test_rank_zero_alone_writes_each_item_once(served):
    """Rank 0 calls each writer (NPY tree, PNG figure, wav) once per item;
    rank 1 calls none; the NPY file holds the returned mel."""
    labels = sorted(item['label'] for item in served['items'])
    writes = served['ranks'][0]['noisy']['writes']
    for kind in ('npy', 'png', 'wav'):
        assert sorted(label for what, label in writes if what == kind) \
            == labels, kind
    assert len(writes) == 3 * len(labels)
    assert served['ranks'][1]['noisy']['writes'] == []
    out = served['out_dirs']['two']
    for result in served['ranks'][0]['noisy']['results']:
        saved = np.load(os.path.join(out, 'NPY', 'Mel',
                                     f'{result["label"]}.npy'))
        np.testing.assert_array_equal(saved.T, result['mel'])


def test_each_rank_runs_griffin_lim_on_its_own_items(served):
    """Chunk 1 (4 items) splits 2 + 2, chunk 2 (1 item, padded to 2)
    leaves rank 1 only the padding row: rank 0 vocodes items 0, 1 and 4,
    rank 1 items 2 and 3; the gathered audio equals a world of one's."""
    one = served['one']['noisy']
    mine = {0: [0, 1, 4], 1: [2, 3]}
    for rank, indices in mine.items():
        griffin = served['ranks'][rank]['noisy']['griffin']
        results = served['ranks'][rank]['noisy']['results']
        assert len(griffin) == len(indices)
        for mel, i in zip(griffin, indices):
            np.testing.assert_array_equal(mel, results[i]['mel'])
        for got, ref in zip(results, one['results']):
            err = np.abs(got['audio'] - ref['audio']).max()
            assert got['audio'].shape == ref['audio'].shape
            assert err <= DSP_REL * np.abs(ref['audio']).max(), got['label']
    assert len(one['griffin']) == len(TEXTS)


def test_data_two_matches_the_jax_data_mesh(served):
    """At ``noise_scale`` 0, against the JAX ``Inferencer`` serving the
    same weights over its data mesh."""
    got = served['ranks'][0]['still']['results']
    ref = served['jax']
    assert [r['label'] for r in got] == [r['label'] for r in ref]
    for g, r in zip(got, ref):
        assert g['mel'].shape == r['mel'].shape, g['label']
        np.testing.assert_array_equal(g['attention'], r['attention'],
                                      err_msg=g['label'])
        assert np.abs(g['mel'] - r['mel']).mean() < JAX_MEL_MAE, g['label']


@pytest.mark.parametrize('rank', [0, 1, 2, 3])
def test_data_by_model_serves_a_world_of_ones_results(served, rank):
    """GR on data 2 × model 2: the speaker ids, the reference mels and
    the pitch tracks split with the rows; every rank returns the whole
    list; rank 0 alone would write (no files asked here)."""
    assert_same(served['grid'][rank]['gr']['results'],
                served['one']['gr']['results'])
    assert served['grid'][rank]['gr']['writes'] == []


def test_rows_of_takes_every_row_of_an_item():
    """``mels_for_ge2e`` holds S rows an item: item j's rows are
    ``[j·S, (j+1)·S)``; the padding row repeats the last item's."""
    n, s = 3, 2
    batch = {'tokens': torch.arange(n)[:, None].repeat(1, 4),
             'mels_for_ge2e': torch.arange(n * s)[:, None, None].float()}
    rows = Inferencer.rows_of(batch, n, [2, 2])
    assert rows['tokens'][:, 0].tolist() == [2, 2]
    assert rows['mels_for_ge2e'].flatten().tolist() == [4, 5, 4, 5]
    assert Inferencer.rows_of(batch, n, [0, 1, 2])['tokens'] is \
        batch['tokens']


def test_a_model_group_world_is_a_world_of_its_own():
    world = dataclasses.replace(pdata.SINGLE, rank=5, size=6, model_size=2,
                                group=object(), host_group=object())
    alone = world.within_model_group()
    assert (alone.rank, alone.size, alone.model_size, alone.model_index,
            alone.data_size, alone.group, alone.host_group) == (
                1, 2, 2, 1, 1, None, None)
    assert pdata.SINGLE.gather_data({'x': 1}) == [{'x': 1}]


def test_the_cli_serves_on_two_data_ranks(tmp_path, capfd):
    """``glow-tts-torch-infer`` on a checkpoint whose snapshot asks for
    ``TPU.data_parallel`` 2, with no launcher: two ranks, each line
    printed once, each item's files written."""
    from glow_tts_tpu_torch.cli import infer_main
    jcfg = jax_config()
    _, params = perturbed(jcfg, 0)
    pcfg = grid(port_config(jcfg), 2)
    checkpoint = str(tmp_path / 'checkpoint')
    CheckpointManager(checkpoint, pcfg).save(
        1, {'Model': port_state(grid(pcfg, 0), params), 'Steps': 1})
    tsv = write_inference_tsv(str(tmp_path / 'lines.tsv'), TEXTS[:3])
    out = str(tmp_path / 'out')
    infer_main(['-c', checkpoint, '-f', tsv, '-o', out, '--device', 'cpu',
                '-b', '2'])
    printed = capfd.readouterr().out
    for i in range(3):
        assert printed.count(f'L{i}: ') == 1, printed
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out, 'NPY', 'Mel', '*.npy'))) == \
        [f'L{i}.npy' for i in range(3)]
