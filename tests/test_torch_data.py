"""The port's pattern IO and loader (``glow_tts_tpu_torch/data/
{patterns,loader}.py``) against the JAX package's on the same pattern
archive, which the tests write themselves: the metadata, the files kept
under the length filters, the inference TSV's entries, the sampler's index
batches and the loader's collated batches, all equal.  Also: a consumer
that stops early, or a collater that raises, ends the producer threads."""

import threading

import numpy as np
import pytest

from glow_tts_tpu import text as jtext
from glow_tts_tpu.data import collate as jcollate
from glow_tts_tpu.data import loader as jloader
from glow_tts_tpu.data import patterns as jpatterns
from glow_tts_tpu_torch import text as ttext
from glow_tts_tpu_torch.data import collate as tcollate
from glow_tts_tpu_torch.data import loader as tloader
from glow_tts_tpu_torch.data import patterns as tpatterns
from tests.helpers import tiny_config
from tests.torch_patterns import write_inference_tsv, write_pattern_archive
from tests.torch_port_helpers import port_config

N_PATTERNS = 23          # not a multiple of a batch: a ragged tail
THREAD_WAIT = 10.0       # seconds a test waits for producer threads


@pytest.fixture(scope='module')
def archive(tmp_path_factory):
    cfg = tiny_config()
    path = str(tmp_path_factory.mktemp('patterns'))
    write_pattern_archive(path, N_PATTERNS, cfg.sound, seed=3,
                          mel=(30, 200), text=(5, 40))
    return cfg, path


def test_build_metadata_matches_jax(archive):
    cfg, path = archive
    got = tpatterns.build_metadata(path, port_config(cfg).sound)
    ref = jpatterns.build_metadata(path, cfg.sound)
    assert got == ref
    assert len(got['File_List']) == N_PATTERNS
    assert got == tpatterns.load_metadata(path)


@pytest.mark.parametrize('limits', [
    {},
    {'mel_length_min': 60, 'mel_length_max': 150},
    {'text_length_min': 12, 'text_length_max': 30,
     'accumulated_dataset_epoch': 2},
])
def test_pattern_dataset_matches_jax(archive, limits):
    _, path = archive
    got = tpatterns.PatternDataset(path, **limits)
    ref = jpatterns.PatternDataset(path, **limits)
    assert got.files == ref.files and len(got) == len(ref)
    assert 0 < got.base_length
    if limits:
        assert got.base_length < N_PATTERNS
    for i in range(len(ref)):
        assert got.mel_length(i) == ref.mel_length(i)
        a, b = got[i], ref[i]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_inference_dataset_matches_jax(tmp_path):
    path = write_inference_tsv(str(tmp_path / 'sentences.tsv'), [
        'Hello, world!', 'The (quick) fox; "jumps".', 'Numbers 42 fail',
        "'Leading apostrophe", 'It is fine.'])
    with open(path, 'a', encoding='utf-8') as f:
        f.write('Short\tA row of three\t1.0\n')
    got = tpatterns.InferenceDataset(path).entries
    ref = jpatterns.InferenceDataset(path).entries
    assert got == ref
    assert [e['label'] for e in got] == ['L0', 'L1', 'L4']


def _batches(sampler, epochs=2):
    return [[b.tolist() for b in sampler] for _ in range(epochs)]


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('shuffle', [True, False])
@pytest.mark.parametrize('shard', [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize('drop_last', [True, False])
def test_batch_sampler_matches_jax(archive, seed, shuffle, shard, drop_last):
    _, path = archive
    dataset = tpatterns.PatternDataset(path)
    kwargs = dict(shuffle=shuffle, seed=seed, drop_last=drop_last,
                  shard_index=shard[0], num_shards=shard[1])
    got = tloader.BatchSampler(dataset, 4, **kwargs)
    ref = jloader.BatchSampler(jpatterns.PatternDataset(path), 4, **kwargs)
    assert len(got) == len(ref)
    batches = _batches(got)
    assert batches == _batches(ref)
    assert all(len(epoch) == len(got) for epoch in batches)
    if shuffle:
        assert batches[0] != batches[1]          # each epoch its own order


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize('workers,prefetch', [(1, 0), (1, 2), (3, 6)])
@pytest.mark.parametrize('shuffle', [True, False])
def test_loader_matches_jax(archive, workers, prefetch, shuffle):
    """Collated batches (Vanilla fields) in the sampler's order, two
    epochs, against the JAX loader with the JAX collater."""
    cfg, path = archive
    port_cfg = port_config(cfg)
    kwargs = dict(shuffle=shuffle, seed=5, prefetch=prefetch,
                  workers=workers, drop_last=shuffle)
    got_loader = tloader.DataLoader(
        tpatterns.PatternDataset(path),
        tcollate.TrainCollater(port_cfg, ttext.Tokenizer()), 4, **kwargs)
    ref_loader = jloader.DataLoader(
        jpatterns.PatternDataset(path),
        jcollate.TrainCollater(cfg, jtext.Tokenizer()), 4, **kwargs)
    for _ in range(2):
        got, ref = list(got_loader), list(ref_loader)
        assert len(got) == len(got_loader)
        _assert_batches_equal(got, ref)


def _producers():
    """The live producer threads of the port's loaders."""
    return [t for t in threading.enumerate()
            if isinstance(getattr(getattr(t, '_target', None), '__self__',
                                  None), tloader.DataLoader)]


def _wait_for_no_producers():
    for t in _producers():
        t.join(THREAD_WAIT)
    assert not _producers()


def test_loader_stops_its_threads_when_the_consumer_stops(archive):
    cfg, path = archive
    loader = tloader.DataLoader(
        tpatterns.PatternDataset(path),
        tcollate.TrainCollater(port_config(cfg), ttext.Tokenizer()), 2,
        workers=3, prefetch=3)
    iterator = iter(loader)
    next(iterator)
    assert _producers()
    iterator.close()
    _wait_for_no_producers()


def test_loader_raises_a_producer_error_in_the_consumer(archive):
    _, path = archive
    calls = []

    def collater(items):
        calls.append(len(items))
        if len(calls) == 3:
            raise ValueError('bad pattern')
        return {'n': np.array(len(items))}

    loader = tloader.DataLoader(tpatterns.PatternDataset(path), collater, 2,
                                workers=3, prefetch=3)
    with pytest.raises(ValueError, match='bad pattern'):
        list(loader)
    _wait_for_no_producers()
