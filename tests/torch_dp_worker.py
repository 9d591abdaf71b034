"""The rank processes of ``tests/test_torch_data_parallel.py``: data
parallelism of the PyTorch port over gloo on the CPU, each rank a process
started by :func:`spawn`.  Imports neither JAX nor the JAX package.

A job is a dict saved beside the ranks' results: ``kind`` (``'steps'``
or ``'trainer'``) and what that kind reads.  Each rank writes what it saw
to ``rank<r>.pt`` in the job's directory.
"""

import os
import signal
import socket
import time

import torch

# two ranks of tiny models: one thread each keeps them off each other
THREADS = 1


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(('localhost', 0))
        return probe.getsockname()[1]


def spawn(job, job_dir, ranks=2, timeout=300):
    """Run ``job`` on ``ranks`` gloo ranks, each a spawned process, and
    return their results in rank order.  A rank that raises fails the
    call with its traceback; ranks still running after ``timeout``
    seconds are killed and the call fails."""
    import torch.multiprocessing as mp
    os.makedirs(job_dir, exist_ok=True)
    torch.save(job, os.path.join(job_dir, 'job.pt'))
    context = mp.start_processes(run_rank, args=(ranks, _free_port(),
                                                 job_dir),
                                 nprocs=ranks, join=False,
                                 start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f'ranks still running after {timeout} s')
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
    return [torch.load(os.path.join(job_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(ranks)]


def run_rank(rank, ranks, port, job_dir):
    """One rank: the environment torchrun gives it, its world over gloo,
    the job."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(ranks), MASTER_ADDR='localhost',
                      MASTER_PORT=str(port))
    torch.set_num_threads(THREADS)
    from glow_tts_tpu_torch.parallel import data
    job = torch.load(os.path.join(job_dir, 'job.pt'), weights_only=False)
    world = data.initialize(job['config'], 'cpu')
    assert (world.rank, world.size, world.backend) == (rank, ranks, 'gloo')
    result = {'steps': steps_job, 'trainer': trainer_job}[job['kind']](
        world, job)
    torch.save(result, os.path.join(job_dir, f'rank{rank}.pt'))
    data.close()


# ---------------------------------------------------------------------------
# train steps


def train_steps(config, state, batch, steps, world, em=False, paths=None):
    """``steps`` train steps of the port from ``state`` on ``batch`` (this
    rank's share under ``world``), seed 0: the metrics of each, the
    gradients the first update read (summed over the ranks), the flow
    seed each step handed the train stack, the parameters after, and
    with ``em`` the 'em' warmup's table statistics.  ``paths``, where
    given, holds the MAS path each step takes (for this rank's rows)."""
    from glow_tts_tpu_torch.ops.coupling_grad import flow_stack_train
    from glow_tts_tpu_torch.ops.mas import maximum_path
    from glow_tts_tpu_torch.training.optim import make_optimizer
    from glow_tts_tpu_torch.training.step import (EMState, build_model,
                                                  init_em_stats,
                                                  make_train_step)
    from glow_tts_tpu_torch.weights import load_state_dict
    model = load_state_dict(build_model(config), state).prepare(fold=False)
    optimizer = make_optimizer(config, model.parameters())
    seeds, grads = [], []
    step_update = optimizer.step

    def recording_step(frozen=()):
        if not grads:
            names = {id(p): name for name, p in model.named_parameters()}
            grads.append({names[id(p)]: p.grad.detach().clone()
                          for p in optimizer.params})
        return step_update(frozen)

    def recording_stack(*args, seed, **kwargs):
        seeds.append(seed)
        return flow_stack_train(*args, seed=seed, **kwargs)

    def handed_path(*args):
        return torch.as_tensor(paths[len(seeds) - 1])

    optimizer.step = recording_step
    em_state = EMState(init_em_stats(config)) if em else None
    step = make_train_step(config, model, optimizer, seed=0,
                           stack_fn=recording_stack,
                           mas_fn=maximum_path if paths is None
                           else handed_path, em_alignment=em,
                           freeze_decoder=em, em_state=em_state, world=world)
    batch = {key: torch.as_tensor(value) for key, value in batch.items()}
    metrics = [{key: float(value) for key, value in step(batch).items()}
               for _ in range(steps)]
    return {'metrics': metrics, 'grads': grads[0], 'seeds': seeds,
            'params': {key: value.detach().clone()
                       for key, value in model.state_dict().items()},
            'em_stats': None if em_state is None else [
                t.clone() for t in em_state.stats]}


def steps_job(world, job):
    """Each scenario's steps on this rank's batch."""
    return {name: train_steps(scenario['config'], job['state'],
                              scenario['batches'][world.rank],
                              scenario['steps'], world,
                              em=scenario.get('em', False),
                              paths=scenario['paths'][world.rank]
                              if 'paths' in scenario else None)
            for name, scenario in job['scenarios'].items()}


# ---------------------------------------------------------------------------
# the trainer


def trainer_job(world, job):
    """Three ``Trainer`` runs of ``job['runs']`` (name → config): the
    uninterrupted run, then a run that rank 1 stops with SIGTERM after
    its second step, resumed by a third.  Per run: the batches each step
    took, the losses rank 0 logged, the checkpoint saves this rank made,
    its writers' types and its parameters at the end."""
    from glow_tts_tpu_torch.training.checkpoint import CheckpointManager
    from glow_tts_tpu_torch.training.trainer import Trainer
    from glow_tts_tpu_torch.utils.logging import MemoryWriter

    saves = []
    save = CheckpointManager.save

    def recording_save(self, step, payload):
        saves.append((world.rank, int(step)))
        return save(self, step, payload)

    CheckpointManager.save = recording_save
    out = {}
    for name in ('whole', 'stopped', 'resumed'):
        saves.clear()
        trainer = Trainer(job['runs'][name], device='cpu', max_mel_length=64,
                          writers={'train': MemoryWriter(),
                                   'eval': MemoryWriter()})
        start = trainer.step
        seen, step_fn = [], trainer.train_step

        def wrapped(batch, step_fn=step_fn, seen=seen):
            seen.append(batch['mel_lengths'].tolist())
            metrics = step_fn(batch)
            if name == 'stopped' and world.rank == 1 and len(seen) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        trainer.train_step = wrapped
        interrupted = None
        try:
            trainer.train()
        except KeyboardInterrupt as stop:
            interrupted = str(stop)
        out[name] = {
            'start': start, 'step': trainer.step, 'batches': seen,
            'interrupted': interrupted, 'saves': list(saves),
            'writers': {key: type(w).__name__
                        for key, w in trainer.writers.items()},
            'logged': {key: {tag: list(values) for tag, values in
                             getattr(writer, 'scalars', {}).items()}
                       for key, writer in trainer.writers.items()},
            'free_running': trainer.free_running is not None,
            'params': {key: value.detach().clone() for key, value in
                       trainer.model.state_dict().items()},
            'generator': trainer.generator.get_state()}
    CheckpointManager.save = save
    return out
