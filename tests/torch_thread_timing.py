"""Time the CPU train steps of one port test under xdist's thread cap.

    JAX_PLATFORMS=cpu python -m tests.torch_thread_timing {default,capped} STEPS

Builds the setup of ``test_torch_curriculum.py::
test_em_release_transition_keeps_lock`` (the EM step with the decoder
frozen, at ``tiny_config`` size) and prints the min, median and max
wall time of ``STEPS`` steps after one warm-up step.  ``capped`` sets
``PYTEST_XDIST_WORKER_COUNT=6`` before ``tests.torch_port_helpers`` is
imported, so torch runs on the share of the cores one of 6 xdist workers
gets; ``default`` keeps torch's default threads.  Start six at once to
see what the workers of ``-n 6`` see.
"""

import os
import sys
import time


def main(argv):
    mode, steps = argv[0], int(argv[1])
    if mode == 'capped':
        os.environ['PYTEST_XDIST_WORKER_COUNT'] = '6'
    import tests.conftest  # noqa: F401  (JAX on the CPU, as the tests)
    import jax
    import numpy as np
    import torch

    from glow_tts_tpu.training import step as jstep
    from glow_tts_tpu_torch.models.glow_tts import GlowTTS
    from glow_tts_tpu_torch.training.optim import make_optimizer
    from glow_tts_tpu_torch.training.step import (EMState, init_em_stats,
                                                  make_train_step)
    from glow_tts_tpu_torch.weights import load_jax_params
    from tests import test_torch_curriculum as curriculum
    from tests.helpers import tiny_config
    from tests.torch_port_helpers import port_config, t

    cfg = tiny_config(Train=curriculum._train_section(
        **{**curriculum.CURRICULUM, 'Alignment_Warmup_Steps': 150,
           'Decoder_Freeze_Steps': 0,
           'Learning_Rate': {'Initial': 3.0e-3, 'Base': 4000}}))
    batch, _ = curriculum.em_lock_corpus(np.random.default_rng(7))
    _, state = jstep.create_train_state(cfg, jax.random.PRNGKey(0), batch)
    pcfg = port_config(cfg)
    port = load_jax_params(
        GlowTTS(pcfg), jax.tree_util.tree_map(np.asarray, state.params),
        pcfg).prepare(fold=False)
    step = make_train_step(
        pcfg, port, make_optimizer(pcfg, port.parameters()), seed=0,
        generator=torch.Generator().manual_seed(0), em_alignment=True,
        freeze_decoder=True, em_state=EMState(init_em_stats(pcfg)))
    tensors = {key: t(value) for key, value in batch.items()}
    step(tensors)
    times = []
    for _ in range(steps):
        start = time.perf_counter()
        step(tensors)
        times.append(time.perf_counter() - start)
    print(f'{mode}: torch threads {torch.get_num_threads()}, {steps} EM '
          f'steps: min {min(times):.4f} median {np.median(times):.4f} max '
          f'{max(times):.4f} s', flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
