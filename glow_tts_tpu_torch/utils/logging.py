"""Training logs (port of ``glow_tts_tpu/utils/logging.py``): TensorBoard
summaries of scalars, images, parameter histograms and embeddings, a
writer that drops everything, one that keeps everything in memory, and the
step-time / throughput timer.

``SummaryLogger`` needs tensorboardX (it raises ``ImportError`` without
it); its image summaries need matplotlib, and where matplotlib does not
import they are skipped with one warning per process
(``utils.plotting.figures``) while the rest is written."""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger('glow_tts_tpu_torch')


def host_parameters(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, np.ndarray]:
    """``name → float32 array`` of a module's parameters or of a state
    dict's tensors, copied to the host at once: one device-to-host copy
    of all of them, not one per tensor."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    tensors = {name: torch.as_tensor(value).detach()
               for name, value in params.items()}
    if not tensors:
        return {}
    flat = torch.cat([value.reshape(-1).float()
                      for value in tensors.values()]).cpu().numpy()
    out, start = {}, 0
    for name, value in tensors.items():
        out[name] = flat[start:start + value.numel()].reshape(value.shape)
        start += value.numel()
    return out


class NullWriter:
    """The writers' surface, doing nothing."""

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        pass

    def add_images(self, images: Mapping[str, np.ndarray], step: int,
                   origin_lower: bool = True) -> None:
        pass

    def add_histograms(self, params, step: int, prefix: str = '') -> None:
        pass

    def add_embedding(self, embeddings: np.ndarray, labels: Sequence[str],
                      step: int, tag: str = 'embedding') -> None:
        pass


class MemoryWriter(NullWriter):
    """Keeps everything written, in the order written: ``scalars[tag]``
    a list of ``(step, value)``, ``images[tag]`` and ``histograms[tag]``
    lists of ``(step, array)`` (the histograms' tags as
    :class:`SummaryLogger` writes them), ``embeddings[tag]`` a list of
    ``(step, array, labels)``."""

    def __init__(self):
        self.scalars: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self.images: Dict[str, List[Tuple[int, np.ndarray]]] = \
            defaultdict(list)
        self.histograms: Dict[str, List[Tuple[int, np.ndarray]]] = \
            defaultdict(list)
        self.embeddings: Dict[str, List[Tuple[int, np.ndarray, List[str]]]] \
            = defaultdict(list)

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.scalars[tag].append((int(step), float(value)))

    def add_images(self, images: Mapping[str, np.ndarray], step: int,
                   origin_lower: bool = True) -> None:
        for tag, data in images.items():
            self.images[tag].append((int(step), np.array(data)))

    def add_histograms(self, params, step: int, prefix: str = '') -> None:
        for name, values in host_parameters(params).items():
            self.histograms[histogram_tag(name, prefix)].append(
                (int(step), values))

    def add_embedding(self, embeddings: np.ndarray, labels: Sequence[str],
                      step: int, tag: str = 'embedding') -> None:
        self.embeddings[tag].append((int(step), np.array(embeddings),
                                     list(labels)))


def histogram_tag(name: str, prefix: str = '') -> str:
    """A parameter's histogram tag: its name with ``.`` as ``/``, so that
    TensorBoard groups the tags by module as it groups the JAX package's
    ``/``-joined parameter paths."""
    return prefix + name.replace('.', '/')


class SummaryLogger(NullWriter):
    """TensorBoard event files under ``log_dir`` (tensorboardX, imported
    when the logger is built: without it this raises ``ImportError``)."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as error:
            raise ImportError(
                f'SummaryLogger writes TensorBoard event files with '
                f'tensorboardX, which does not import here ({error}); '
                f'install tensorboardX or hand the Trainer other writers '
                f'(utils.logging.MemoryWriter, NullWriter)') from error
        self.writer = SummaryWriter(log_dir)

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.writer.add_scalar(tag, float(value), step)

    def add_images(self, images: Mapping[str, np.ndarray], step: int,
                   origin_lower: bool = True) -> None:
        """Each ``[H, W]`` array as a matplotlib figure summary."""
        from glow_tts_tpu_torch.utils.plotting import figures
        if not figures():
            return
        import matplotlib.pyplot as plt
        for tag, data in images.items():
            fig = plt.figure(figsize=(10, 4))
            plt.imshow(np.asarray(data), aspect='auto',
                       origin='lower' if origin_lower else 'upper')
            plt.colorbar()
            plt.title(tag)
            plt.tight_layout()
            self.writer.add_figure(tag.replace('.', '/'), fig, step)
            plt.close(fig)

    def add_histograms(self, params, step: int, prefix: str = '') -> None:
        """One histogram per parameter of a module or tensor of a state
        dict, tagged by :func:`histogram_tag`."""
        for name, values in host_parameters(params).items():
            self.writer.add_histogram(histogram_tag(name, prefix), values,
                                      step)

    def add_embedding(self, embeddings: np.ndarray, labels: Sequence[str],
                      step: int, tag: str = 'embedding') -> None:
        self.writer.add_embedding(np.asarray(embeddings),
                                  metadata=list(labels), global_step=step,
                                  tag=tag)

    def close(self) -> None:
        self.writer.close()


class StepTimer:
    """Step time and mel frames per second: ``add_frames`` counts each
    step's frames, ``tick(steps)`` turns the interval since the last tick
    into ``step_time_sec`` and ``mel_frames_per_sec``."""

    def __init__(self):
        self._last: Optional[float] = None
        self._frames: int = 0

    def add_frames(self, frames: int) -> None:
        self._frames += int(frames)

    def tick(self, steps: int = 1) -> Dict[str, float]:
        now = time.perf_counter()
        metrics: Dict[str, float] = {}
        if self._last is not None and steps > 0:
            dt = now - self._last
            metrics['step_time_sec'] = dt / steps
            if self._frames:
                metrics['mel_frames_per_sec'] = self._frames / dt
        self._last = now
        self._frames = 0
        return metrics
