"""The MiniSpeech chain's duration metrics (``tools/minispeech_e2e.py``:
``token_frames``, ``duration_errors``, ``DurationMetrics`` and the eval
trajectory that carries them) on a tiny synthetic eval batch whose MAS
paths and predictor outputs are made by hand, so both errors are known
exactly."""

import math

import torch

from glow_tts_tpu_torch.models.glow_tts import generate_path
from glow_tts_tpu_torch.tools import minispeech_e2e as e2e

TOKENS = {'<S>': 0, '<E>': 1, ' ': 2,
          **{ch: 3 + i for i, ch in enumerate(e2e.LETTERS)}}


def tiny_batch():
    """Two texts, 'AB C' and 'J', with <S> and <E>; MAS durations off the
    corpus's by known frames, the predictor off MAS's by known frames."""
    texts = ['AB C', 'J']
    ids = [[0, *[TOKENS[ch] for ch in text], 1] for text in texts]
    t_tok = max(map(len, ids))
    tokens = torch.zeros((2, t_tok), dtype=torch.int64)
    for i, row in enumerate(ids):
        tokens[i, :len(row)] = torch.tensor(row)
    lengths = torch.tensor([len(row) for row in ids])
    truth = [[e2e.phone_params(e2e.LETTERS.index(ch))[4] if ch != ' '
              else e2e.PAUSE_FRAMES for ch in text] for text in texts]
    # MAS: <S> 1 frame, each timed token its truth + offset, <E> 2 frames
    offsets = [[1, -2, 0, 3], [-1]]
    mas = torch.zeros((2, t_tok))
    for i in range(2):
        d = [1] + [t + o for t, o in zip(truth[i], offsets[i])] + [2]
        mas[i, :len(d)] = torch.tensor(d, dtype=torch.float32)
    t_mel = int(mas.sum(dim=1).max())
    mel_lengths = mas.sum(dim=1).long()
    token_mask = (torch.arange(t_tok)[None] < lengths[:, None]).float()
    frame_mask = (torch.arange(t_mel)[None] < mel_lengths[:, None]).float()
    attn_mask = token_mask[:, :, None] * frame_mask[:, None, :]
    attentions = generate_path(mas, attn_mask)
    # predictor: MAS's durations + 0.5 frames on every valid token
    log_durations = torch.log(mas + 0.5)[..., None] * token_mask[..., None]
    batch = {'tokens': tokens, 'token_lengths': lengths,
             'mel_lengths': mel_lengths}
    outputs = {'attentions': attentions, 'log_durations': log_durations}
    n_timed = sum(map(len, offsets))
    mas_err = sum(abs(o) for row in offsets for o in row) / n_timed
    return batch, outputs, mas_err, int(lengths.sum())


def test_token_frames_follow_the_corpus():
    frames = e2e.token_frames(TOKENS)
    assert frames[TOKENS['<S>']] == -1 and frames[TOKENS['<E>']] == -1
    assert frames[TOKENS[' ']] == e2e.PAUSE_FRAMES
    for i, ch in enumerate(e2e.LETTERS):
        assert frames[TOKENS[ch]] == e2e.phone_params(i)[4]


def test_duration_errors_on_known_paths():
    batch, outputs, mas_err, n_tokens = tiny_batch()
    sums = e2e.duration_errors(outputs, batch, e2e.token_frames(TOKENS))
    assert sums['timed_tokens'] == 5 and sums['tokens'] == n_tokens
    assert math.isclose(sums['mas_vs_corpus'] / sums['timed_tokens'],
                        mas_err, rel_tol=1e-6)
    assert math.isclose(sums['predictor_vs_mas'] / sums['tokens'], 0.5,
                        rel_tol=1e-5)


def test_duration_metrics_through_the_eval_trajectory(tmp_path):
    batch, outputs, mas_err, _ = tiny_batch()
    metrics = e2e.DurationMetrics(e2e.token_frames(TOKENS))
    step = metrics.wrap(lambda b: ({'mle': 1.0}, outputs))
    writer = e2e.TrajectoryWriter(str(tmp_path / 'trajectory.jsonl'), 'eval',
                                  metrics)
    for at in (100, 200):
        step(batch)
        step(batch)          # two batches an evaluation: the same means
        writer.add_scalars({'Loss/mle': 1.0, 'Loss/duration': 0.1,
                            'Alignment/diagonality': 0.9}, at)
    rows = e2e.eval_trajectory(writer)
    assert [row['step'] for row in rows] == [100, 200]
    for row in rows:
        assert math.isclose(row['mas_duration_abs_err_frames'], mas_err,
                            rel_tol=1e-6)
        assert math.isclose(row['predictor_duration_abs_err_frames'], 0.5,
                            rel_tol=1e-5)
    assert metrics.take() == {}
