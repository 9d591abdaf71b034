"""The rank processes of ``tests/test_torch_dp_serving.py``: the PyTorch
port's ``Inferencer`` over gloo ranks on the CPU, each rank a process
started by :func:`spawn`.  Imports neither JAX nor the JAX package.

A job holds the world's ``config`` and named ``cases``, each the keyword
arguments of one ``Inferencer`` and one ``synthesize_items`` call.  Each
rank writes, per case, the results it returned, the files it wrote and
the mels it ran Griffin-Lim on to ``rank<r>.pt`` in the job's directory.
"""

import os

import torch

from tests import torch_tp_worker


def spawn(job, job_dir, ranks):
    """``job`` on ``ranks`` gloo ranks: their results in rank order."""
    return torch_tp_worker.spawn(job, job_dir, ranks=ranks,
                                 rank_fn=run_rank)


def run_rank(rank, ranks, port, job_dir):
    """One rank: the environment torchrun gives it, its world over gloo,
    every case of the job."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(ranks), MASTER_ADDR='localhost',
                      MASTER_PORT=str(port))
    torch.set_num_threads(torch_tp_worker.THREADS)
    from glow_tts_tpu_torch.parallel import data
    job = torch.load(os.path.join(job_dir, 'job.pt'), weights_only=False)
    world = data.initialize(job['config'], 'cpu')
    assert (world.rank, world.size, world.backend) == (rank, ranks, 'gloo')
    result = {name: served(world, case)
              for name, case in job['cases'].items()}
    torch.save(result, os.path.join(job_dir, f'rank{rank}.pt'))
    data.close()


def served(world, case):
    """One case under ``world`` (or a world of one where ``world`` is
    ``parallel.data.SINGLE``): ``results``, ``writes`` (what, label) in
    the order this rank wrote them, and ``griffin`` (the mels this rank
    ran Griffin-Lim on, in order)."""
    from glow_tts_tpu_torch import inference
    from glow_tts_tpu_torch.ops import vocoder
    writes, griffin = [], []
    real = {'npy': inference.export_npy,
            'png': inference.export_mel_figure,
            'wav': vocoder.save_wav, 'griffin': vocoder.mel_to_audio}

    def export_npy(out_dir, label, *args):
        writes.append(('npy', label))
        return real['npy'](out_dir, label, *args)

    def export_mel_figure(path, *args, **kwargs):
        writes.append(('png', os.path.basename(path)[:-4]))
        return real['png'](path, *args, **kwargs)

    def save_wav(path, *args):
        writes.append(('wav', os.path.basename(path)[:-4]))
        return real['wav'](path, *args)

    def mel_to_audio(mel, *args, **kwargs):
        griffin.append(mel.copy())
        return real['griffin'](mel, *args, **kwargs)

    inference.export_npy, inference.export_mel_figure = (export_npy,
                                                         export_mel_figure)
    vocoder.save_wav, vocoder.mel_to_audio = save_wav, mel_to_audio
    try:
        inferencer = inference.Inferencer(
            case['state'], case['config'], 'cpu', world=world,
            **case['inferencer'])
        results = inferencer.synthesize_items(case['items'],
                                              **case['synthesize'])
    finally:
        inference.export_npy, inference.export_mel_figure = (
            real['npy'], real['png'])
        vocoder.save_wav, vocoder.mel_to_audio = (real['wav'],
                                                  real['griffin'])
    return {'results': results, 'writes': writes, 'griffin': griffin}
