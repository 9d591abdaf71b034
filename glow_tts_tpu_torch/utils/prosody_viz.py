"""Prosody (GST) embedding visualisation (port of
``glow_tts_tpu/utils/prosody_viz.py``): embeds the prosody-check dataset
(``data.patterns.ProsodyCheckDataset`` over the config's eval patterns)
with a trained PE or GR checkpoint of the port, projects the vectors with
t-SNE and draws a scatter per speaker.  The embedding runs on ``--device``
(the card by default); the projection and the plot run on the host and
need sklearn and matplotlib, which raise ``ImportError`` where absent: the
plot is the tool's only output.

    python -m glow_tts_tpu_torch.utils.prosody_viz -c <checkpoint_dir> \\
        -o out.png [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def embed_prosody_dataset(checkpoint_path: str, config=None, step: int = 0,
                          batch_size: int = 16,
                          max_items: Optional[int] = None,
                          device: str = 'cuda'
                          ) -> Tuple[np.ndarray, List[str]]:
    """(embeddings ``[N, P]`` float32, speaker labels ``[N]``) of the
    checkpoint's model (served as ``Inferencer`` serves it, at
    ``config.serve_dtype``) over the first ``max_items`` files of the
    prosody-check dataset, or all of them."""
    from glow_tts_tpu_torch.data.collate import ProsodyCheckCollater
    from glow_tts_tpu_torch.data.loader import DataLoader
    from glow_tts_tpu_torch.data.patterns import ProsodyCheckDataset
    from glow_tts_tpu_torch.inference import Inferencer

    inferencer = Inferencer(checkpoint_path, config, device, step=step)
    cfg = inferencer.config
    if not cfg.uses_prosody_encoder:
        raise ValueError('prosody visualisation needs PE or GR mode')
    pattern = cfg.train.eval_pattern
    dataset = ProsodyCheckDataset(
        pattern_path=pattern.path, metadata_file=pattern.metadata_file,
        mel_length_min=pattern.mel_length_min,
        mel_length_max=pattern.mel_length_max)
    if max_items:
        dataset.files = dataset.files[:max_items]
    loader = DataLoader(dataset, ProsodyCheckCollater(cfg), batch_size,
                        shuffle=False, prefetch=0, drop_last=False)
    embeddings, labels = [], []
    for batch in loader:
        out = inferencer.model.encode_prosody(
            torch.as_tensor(batch['mels'], device=inferencer.device),
            torch.as_tensor(batch['mel_lengths'], device=inferencer.device))
        embeddings.append(out.float().cpu().numpy())
        labels.extend(batch['labels'])
    return np.concatenate(embeddings), labels


def plot_embeddings(embeddings: np.ndarray, labels: Sequence[str],
                    out_path: str, perplexity: float = 30.0) -> None:
    """t-SNE of ``embeddings`` (the first two dimensions where there are
    fewer than 4), a colour per speaker, saved to ``out_path``."""
    from sklearn.manifold import TSNE
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if len(labels) < 4:
        projected = embeddings[:, :2]
    else:
        perplexity = min(perplexity, len(labels) - 1)
        projected = TSNE(n_components=2, perplexity=perplexity,
                         init='pca', random_state=0).fit_transform(embeddings)

    speakers = sorted(set(labels))
    cmap = plt.get_cmap('tab20', max(len(speakers), 1))
    fig = plt.figure(figsize=(10, 10))
    for idx, speaker in enumerate(speakers):
        sel = np.array([label == speaker for label in labels])
        plt.scatter(projected[sel, 0], projected[sel, 1], s=8,
                    color=cmap(idx % 20), label=speaker)
    if len(speakers) <= 25:
        plt.legend(fontsize=7, markerscale=2)
    plt.title(f'GST prosody embeddings (t-SNE) — {len(speakers)} speakers')
    plt.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog='python -m glow_tts_tpu_torch.utils.prosody_viz')
    parser.add_argument('-c', '--checkpoint', required=True,
                        help='checkpoint directory (with config snapshot)')
    parser.add_argument('-s', '--step', default=0, type=int,
                        help='checkpoint step; 0 = latest')
    parser.add_argument('-o', '--output', default='prosody_tsne.png')
    parser.add_argument('-b', '--batch_size', default=16, type=int)
    parser.add_argument('-n', '--max_items', default=None, type=int)
    parser.add_argument('--device', default='cuda',
                        help="torch device to embed on (default 'cuda')")
    args = parser.parse_args(argv)

    embeddings, labels = embed_prosody_dataset(
        args.checkpoint, step=args.step, batch_size=args.batch_size,
        max_items=args.max_items, device=args.device)
    plot_embeddings(embeddings, labels, args.output)
    print(f'{embeddings.shape[0]} embeddings → {args.output}')


if __name__ == '__main__':
    main()
