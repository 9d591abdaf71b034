"""Training logs (port of ``glow_tts_tpu/utils/logging.py``, scalars only):
TensorBoard scalar summaries, a writer that drops everything, one that
keeps the scalars in memory, and the step-time / throughput timer."""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Tuple

logger = logging.getLogger('glow_tts_tpu_torch')


class NullWriter:
    """The writers' surface, doing nothing."""

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        pass

    def add_images(self, *args, **kwargs) -> None:
        pass

    def add_histograms(self, *args, **kwargs) -> None:
        pass

    def add_embedding(self, *args, **kwargs) -> None:
        pass


class MemoryWriter(NullWriter):
    """Keeps every scalar written: ``scalars[tag]`` is a list of
    ``(step, value)`` in the order written."""

    def __init__(self):
        self.scalars: Dict[str, List[Tuple[int, float]]] = defaultdict(list)

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.scalars[tag].append((int(step), float(value)))


class SummaryLogger(NullWriter):
    """TensorBoard event files under ``log_dir`` (tensorboardX, imported
    when the logger is built).  Scalars only: images, histograms and
    embeddings are not written yet."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(log_dir)

    def add_scalars(self, scalars: Mapping[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.writer.add_scalar(tag, float(value), step)

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
