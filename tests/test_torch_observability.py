"""The port's observability (``glow_tts_tpu_torch/utils/{logging,plotting,
prosody_viz}.py``, ``data/{patterns,collate}.py``' prosody check,
``GlowTTS.encode_prosody``, the ``Trainer``'s images, histograms, prosody
check and profiler window, ``Inferencer``'s PNGs, the CLI's ``--profile``)
against the JAX package, on the CPU at ``tiny_config`` size in PE mode:

* ``export_mel_figure`` draws the JAX package's figure: the two PNGs read
  back by ``matplotlib.image.imread`` are equal pixel for pixel;
* ``SummaryLogger.add_histograms`` on the state dict that ``weights.py``
  bridges from JAX parameters writes, for every JAX leaf that the bridge
  maps to one tensor (the same values, laid out anew), the histogram the
  JAX package's logger writes for that leaf: equal ``num``, ``min``,
  ``max``, bucket limits and counts, ``sum`` and ``sum_squares`` within
  1e-6 relative (read back from both event files with a TFRecord reader
  over ``tensorboardX.proto.event_pb2``);
* ``ProsodyCheckDataset`` samples the JAX package's file list for the same
  archive, counts and seed, and ``ProsodyCheckCollater`` gives its arrays;
* ``GlowTTS.encode_prosody`` matches JAX's ``encode_prosody`` within 1e-5
  of its max-abs at float32 and within the port's bf16 bar at bfloat16
  (``tests/torch_port_helpers.py``);
* a ``Trainer`` with ``MemoryWriter``s writes at each evaluation the three
  images (the MAS path bit-equal to the eval step's, the target mel and
  the free-running path equal to their slices) and one histogram per
  parameter equal to it, the ``GST`` embedding at its interval (equal to
  ``encode_prosody`` of its weights, within 1e-5 of JAX's on the same
  weights, its labels the dataset's speakers) and a PNG per inference
  sentence; ``prosody_viz.main`` on its checkpoint writes the t-SNE PNG;
* ``glow-tts-torch-train --profile 1:2`` writes a Chrome trace under
  ``<Log_Path>/profile``; ``SummaryLogger`` raises ``ImportError`` naming
  tensorboardX where it does not import, and where matplotlib does not
  import the figures are skipped with one warning and the rest is written
  (both simulated through ``sys.modules``).
"""

import dataclasses
import glob
import json
import logging
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.data import collate as jcollate
from glow_tts_tpu.data import patterns as jpatterns
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu.utils import logging as jlogging
from glow_tts_tpu.utils import plotting as jplotting
from glow_tts_tpu_torch.cli import train_main
from glow_tts_tpu_torch.config import save_config
from glow_tts_tpu_torch.data.collate import ProsodyCheckCollater
from glow_tts_tpu_torch.data.patterns import ProsodyCheckDataset
from glow_tts_tpu_torch.training.trainer import Trainer
from glow_tts_tpu_torch.utils import logging as tlogging
from glow_tts_tpu_torch.utils import plotting as tplotting
from glow_tts_tpu_torch.utils import prosody_viz
from glow_tts_tpu_torch.weights import (convert_params_to_reference,
                                        reference_to_params)
from tests.torch_patterns import (trainer_config, write_inference_tsv,
                                  write_pattern_archive)
from tests.torch_port_helpers import (assert_bf16_close, at_dtype,
                                      jax_model, port_config, port_model)

EMBED_ATOL = 1e-5          # of the f32 GST vectors' max-abs
HIST_RTOL = 1e-6           # a histogram's sum and sum of squares
SPEAKERS = 3
EVAL_PATTERNS = 12         # 3 whole batches of 4: one shape for JAX


def read_events(log_dir):
    """Every ``Event`` of the event files under ``log_dir``, in order:
    TFRecord framing (length, its CRC, the record, its CRC)."""
    from tensorboardX.proto import event_pb2
    events = []
    for path in sorted(glob.glob(os.path.join(log_dir, 'events.*'))):
        with open(path, 'rb') as f:
            while True:
                header = f.read(12)
                if len(header) < 12:
                    break
                length, = struct.unpack('<Q', header[:8])
                event = event_pb2.Event()
                event.ParseFromString(f.read(length))
                f.read(4)
                events.append(event)
    return events


def histograms(log_dir):
    """``tag → HistogramProto`` of the event files under ``log_dir``."""
    return {value.tag: value.histo for event in read_events(log_dir)
            for value in event.summary.value if value.HasField('histo')}


@pytest.fixture(scope='module')
def pe():
    """PE mode at tiny size: (JAX config, flax model, numpy params, port
    config, the port model on the same weights)."""
    jcfg, model, params, _ = jax_model(mode='PE')
    return jcfg, model, params, port_config(jcfg), port_model(jcfg, params)


@pytest.fixture(scope='module')
def root(tmp_path_factory, pe):
    """Archives of 3 speakers: 12 train, ``EVAL_PATTERNS`` eval patterns,
    and an inference TSV."""
    sound = pe[0].sound
    path = str(tmp_path_factory.mktemp('observed'))
    write_pattern_archive(os.path.join(path, 'train'), 12, sound, 0,
                          speakers=SPEAKERS)
    write_pattern_archive(os.path.join(path, 'eval'), EVAL_PATTERNS, sound,
                          1, speakers=SPEAKERS)
    write_inference_tsv(os.path.join(path, 'sentences.tsv'),
                        ['The birch canoe slid.', 'Glue the sheet.'])
    return path


@pytest.fixture(scope='module')
def jax_gst(pe):
    """JAX's ``encode_prosody``, jitted, at float32 and at bfloat16."""
    def jitted(model):
        return jax.jit(lambda params, mels, lengths: model.apply(
            {'params': params}, mels, lengths, method='encode_prosody'))
    return {dtype: jitted(jstep.build_model(at_dtype(pe[0], dtype)))
            for dtype in ('float32', 'bfloat16')}


def check_batches(pcfg, path):
    """The prosody check's batches of the archive at ``path`` (its length
    filter open), as the trainer makes them."""
    dataset = ProsodyCheckDataset(path, mel_length_min=0)
    collate = ProsodyCheckCollater(pcfg)
    size = pcfg.train.batch_size
    return [collate([dataset[i] for i in range(start, start + size)])
            for start in range(0, len(dataset), size)]


# ---------------------------------------------------------------------------
# figures and histograms


def test_mel_figure_has_the_jax_packages_pixels(tmp_path):
    from matplotlib.image import imread
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((37, 8)).astype(np.float32)
    attention = (rng.random((9, 37)) > 0.7).astype(np.float32)
    for name, attn in (('both', attention), ('mel', None)):
        jpath, tpath = (str(tmp_path / side / f'{name}.png')
                        for side in ('jax', 'port'))
        jplotting.export_mel_figure(jpath, mel, attn, title='A test.')
        tplotting.export_mel_figure(tpath, mel, attn, title='A test.')
        want, got = imread(jpath), imread(tpath)
        assert want.shape == got.shape and want.shape[0] > 100
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_histograms_of_the_bridged_state_dict_are_jaxs(pe, tmp_path):
    jcfg, _, params, pcfg, _ = pe
    jax_writer = jlogging.SummaryLogger(str(tmp_path / 'jax'))
    jax_writer.add_histograms(params, 3)
    jax_writer.close()
    state_dict = convert_params_to_reference(params, jcfg)
    port_writer = tlogging.SummaryLogger(str(tmp_path / 'port'))
    port_writer.add_histograms(state_dict, 3)
    port_writer.close()
    want, got = histograms(str(tmp_path / 'jax')), histograms(
        str(tmp_path / 'port'))
    assert set(got) == {tlogging.histogram_tag(name) for name in state_dict}

    # the leaves the bridge maps to one tensor: the same multiset of values
    by_values = {}
    for name, value in state_dict.items():
        flat = np.sort(np.asarray(value, np.float32).reshape(-1))
        by_values.setdefault(flat.tobytes(), []).append(name)
    compared = 0
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in leaves:
        flat = np.sort(np.asarray(leaf, np.float32).reshape(-1))
        names = by_values.get(flat.tobytes(), [])
        if len(names) != 1:
            continue
        jtag = '/'.join(str(getattr(p, 'key', p)) for p in path
                        ).replace('.', '_')
        a, b = want[jtag], got[tlogging.histogram_tag(names[0])]
        assert (a.num, a.min, a.max) == (b.num, b.min, b.max), jtag
        assert list(a.bucket_limit) == list(b.bucket_limit), jtag
        assert list(a.bucket) == list(b.bucket), jtag
        np.testing.assert_allclose([b.sum, b.sum_squares],
                                   [a.sum, a.sum_squares], rtol=HIST_RTOL,
                                   err_msg=jtag)
        compared += 1
    assert compared >= 0.8 * len(leaves), (compared, len(leaves))


# ---------------------------------------------------------------------------
# the prosody check's data and the GST vector


@pytest.mark.parametrize('speakers,per_speaker,seed', [
    (50, 100, 0), (2, 3, 0), (2, 3, 7)])
def test_prosody_check_dataset_and_collater_are_jaxs(pe, root, speakers,
                                                     per_speaker, seed):
    jcfg, pcfg = pe[0], pe[3]
    path = os.path.join(root, 'eval')
    kwargs = dict(check_speakers=speakers, sample_per_speaker=per_speaker,
                  mel_length_min=60, mel_length_max=110, seed=seed)
    want = jpatterns.ProsodyCheckDataset(path, **kwargs)
    got = ProsodyCheckDataset(path, **kwargs)
    assert got.files == want.files and len(got) == len(want) > 0
    items = [got[i] for i in range(len(got))]
    ref = jcollate.ProsodyCheckCollater(jcfg)(
        [want[i] for i in range(len(want))])
    out = ProsodyCheckCollater(pcfg)(items)
    assert out['labels'] == ref['labels']
    for key in ('mels', 'mel_lengths'):
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_encode_prosody_matches_jax(pe, root, jax_gst):
    _, _, params, pcfg, model = pe
    batch = check_batches(pcfg, os.path.join(root, 'eval'))[0]
    mels, lengths = batch['mels'], batch['mel_lengths']
    j32 = np.asarray(jax_gst['float32'](params, mels, lengths), np.float32)
    j16 = np.asarray(jax_gst['bfloat16'](params, mels, lengths), np.float32)
    args = (torch.from_numpy(mels), torch.from_numpy(lengths))
    got = model.encode_prosody(*args)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), j32, rtol=0,
                               atol=EMBED_ATOL * np.abs(j32).max())
    with model.computing_at('bfloat16'):
        got16 = model.encode_prosody(*args)
    assert_bf16_close(got16, j16, j32, 'encode_prosody')


def test_encode_prosody_needs_a_prosody_mode():
    from tests.helpers import tiny_config
    from glow_tts_tpu_torch.models.glow_tts import GlowTTS
    model = GlowTTS(port_config(tiny_config()))
    with pytest.raises(ValueError, match='prosody encoder'):
        model.encode_prosody(torch.zeros(1, 16, 8), torch.tensor([16]))


# ---------------------------------------------------------------------------
# the trainer


@pytest.fixture(scope='module')
def trained(pe, root):
    """A PE ``Trainer`` with ``MemoryWriter``s, 2 steps: evaluations at 0
    and 2, the prosody check at 2; the eval step's last outputs
    recorded."""
    cfg = trainer_config(
        pe[3], root, num_workers=1, max_step=2, checkpoint_save_interval=2,
        logging_interval=2, evaluation_interval=2, inference_interval=100,
        prosody_check_interval=2)
    cfg = dataclasses.replace(
        cfg, checkpoint_path=os.path.join(root, 'run', 'ckpt'),
        log_path=os.path.join(root, 'run', 'log'),
        inference_path=os.path.join(root, 'run', 'inference'))
    writers = {'train': tlogging.MemoryWriter(),
               'eval': tlogging.MemoryWriter()}
    trainer = Trainer(cfg, device='cpu', max_mel_length=128, writers=writers)
    seen, step = [], trainer.eval_step

    def recorded(batch):
        out = step(batch)
        seen.append((batch, out[1]))
        return out

    trainer.eval_step = recorded
    trainer.train()
    return trainer, writers['eval'], seen[-1]


def test_evaluation_writes_the_three_images_and_every_histogram(trained):
    trainer, writer, (batch, outputs) = trained
    assert sorted(writer.images) == ['Attention/From_Inference',
                                     'Attention/From_Train', 'Mel/Target']
    for tag, entries in writer.images.items():
        assert [step for step, _ in entries] == [0, 2], tag
    t_tok, t_mel = int(batch['token_lengths'][0]), int(batch['mel_lengths'][0])
    images = {tag: entries[-1][1] for tag, entries in writer.images.items()}
    assert np.array_equal(
        images['Attention/From_Train'],
        outputs['attentions'][0, :t_tok, :t_mel].numpy())
    assert images['Attention/From_Train'].sum() == t_mel
    assert np.array_equal(images['Mel/Target'],
                          batch['mels'][0, :t_mel].numpy().T)
    assert np.array_equal(
        images['Attention/From_Inference'],
        trainer.free_running['attentions'][0, :t_tok].numpy())

    params = dict(trainer.model.named_parameters())
    assert set(writer.histograms) == {tlogging.histogram_tag(name)
                                      for name in params}
    for name, value in params.items():
        entries = writer.histograms[tlogging.histogram_tag(name)]
        assert [step for step, _ in entries] == [0, 2], name
        assert np.array_equal(entries[-1][1], value.detach().numpy()), name


def test_prosody_check_writes_the_gst_embedding(trained, pe, root, jax_gst):
    trainer, writer, _ = trained
    (step, embeddings, labels), = writer.embeddings['GST']
    assert step == 2
    dataset = ProsodyCheckDataset(os.path.join(root, 'eval'),
                                  mel_length_min=0)
    assert labels == [dataset[i]['speaker'] for i in range(len(dataset))]
    assert len(set(labels)) == SPEAKERS
    assert embeddings.shape == (EVAL_PATTERNS,
                                trainer.config.prosody_encoder.size)
    pcfg = trainer.config
    batches = check_batches(pcfg, os.path.join(root, 'eval'))
    mine = np.concatenate([trainer.model.encode_prosody(
        torch.from_numpy(b['mels']), torch.from_numpy(b['mel_lengths'])
    ).numpy() for b in batches])
    assert np.array_equal(embeddings, mine)
    params = reference_to_params(trainer.model.state_dict(), pcfg)
    ref = np.concatenate([np.asarray(jax_gst['float32'](
        params, b['mels'], b['mel_lengths'])) for b in batches])
    np.testing.assert_allclose(embeddings, ref, rtol=0,
                               atol=EMBED_ATOL * np.abs(ref).max())


def test_prosody_viz_plots_the_checkpoints_embeddings(trained, tmp_path):
    trainer, writer, _ = trained
    embeddings, labels = prosody_viz.embed_prosody_dataset(
        trainer.config.checkpoint_path, device='cpu')
    (_, want, want_labels), = writer.embeddings['GST']
    assert labels == want_labels
    np.testing.assert_allclose(embeddings, want, rtol=0,
                               atol=EMBED_ATOL * np.abs(want).max())
    out = str(tmp_path / 'viz' / 'tsne.png')
    prosody_viz.main(['-c', trainer.config.checkpoint_path, '-o', out,
                      '--device', 'cpu'])
    from matplotlib.image import imread
    assert imread(out).shape[0] > 100


# ---------------------------------------------------------------------------
# the profiler window and the packages


def test_cli_profile_writes_a_chrome_trace_and_inference_pngs(root,
                                                               tmp_path):
    """Vanilla (the TSV's sentences need no reference wav): the window of
    step 1 (0-based) traced, and the inference at step 2 writes a PNG per
    sentence beside the NPY tree."""
    from matplotlib.image import imread
    from tests.helpers import tiny_config
    cfg = trainer_config(
        port_config(tiny_config()), root, num_workers=1, max_step=2,
        checkpoint_save_interval=2, logging_interval=2,
        evaluation_interval=100, inference_interval=2,
        inference_pattern_file_in_train=os.path.join(root, 'sentences.tsv'))
    cfg = dataclasses.replace(cfg, checkpoint_path=str(tmp_path / 'ckpt'),
                              log_path=str(tmp_path / 'log'),
                              inference_path=str(tmp_path / 'inference'))
    hp = str(tmp_path / 'hp.yaml')
    save_config(cfg, hp)
    train_main(['-hp', hp, '--device', 'cpu', '--profile', '1:2'])
    traces = glob.glob(str(tmp_path / 'log' / 'profile' /
                           'rank0.*.pt.trace.json'))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        trace = json.load(f)
    assert any(event.get('ph') == 'X' for event in trace['traceEvents'])
    out = str(tmp_path / 'inference' / 'Step-2')
    assert sorted(os.listdir(os.path.join(out, 'PNG'))) == ['L0.png',
                                                            'L1.png']
    assert sorted(os.listdir(os.path.join(out, 'NPY', 'Mel'))) == [
        'L0.npy', 'L1.npy']
    assert imread(os.path.join(out, 'PNG', 'L0.png')).ndim == 3


def test_summary_logger_needs_tensorboardx(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    with pytest.raises(ImportError, match='tensorboardX'):
        tlogging.SummaryLogger(str(tmp_path))


def test_without_matplotlib_figures_are_skipped_with_one_warning(
        monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(tplotting, '_MISSING', [])
    for name in ('matplotlib', 'matplotlib.pyplot'):
        monkeypatch.setitem(sys.modules, name, None)
    writer = tlogging.SummaryLogger(str(tmp_path / 'log'))
    mel = np.zeros((20, 8), np.float32)
    with caplog.at_level(logging.WARNING, logger='glow_tts_tpu_torch'):
        writer.add_images({'Mel/Target': mel.T}, 1)
        tplotting.export_mel_figure(str(tmp_path / 'PNG' / 'a.png'), mel)
        writer.add_images({'Mel/Target': mel.T}, 2)
        writer.add_scalars({'Loss/total': 1.5}, 1)
        writer.add_histograms({'a.b': torch.arange(6.0)}, 1)
        tplotting.export_npy(str(tmp_path), 'a', mel)
    writer.close()
    warnings = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and 'matplotlib' in warnings[0], warnings
    assert not os.path.exists(tmp_path / 'PNG')
    assert os.path.exists(tmp_path / 'NPY' / 'Mel' / 'a.npy')
    histos = histograms(str(tmp_path / 'log'))
    assert list(histos) == ['a/b'] and histos['a/b'].num == 6
    tags = {value.tag for event in read_events(str(tmp_path / 'log'))
            for value in event.summary.value}
    assert tags == {'Loss/total', 'a/b'}
