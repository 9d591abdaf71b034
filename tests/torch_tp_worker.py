"""The rank processes of ``tests/test_torch_tensor_parallel.py``: tensor
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

# tiny models on a few ranks: one thread each keeps them off each other
THREADS = 1


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(('localhost', 0))
        return probe.getsockname()[1]


def spawn(job, job_dir, ranks=2, timeout=300, rank_fn=None):
    """Run ``job`` on ``ranks`` gloo ranks, each a spawned process running
    ``rank_fn(rank, ranks, port, job_dir)`` (default :func:`run_rank`),
    and return their results in rank order.  A rank that raises fails the
    call with its traceback; ranks still running after ``timeout``
    seconds are killed and the call fails."""
    import torch.multiprocessing as mp
    os.makedirs(job_dir, exist_ok=True)
    torch.save(job, os.path.join(job_dir, 'job.pt'))
    context = mp.start_processes(rank_fn or run_rank,
                                 args=(ranks, _free_port(), job_dir),
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
# train steps, evaluation and decoding


class Recorder:
    """Records what a run hands the flow's dropout (every mask
    ``dropmask.stack_mask`` draws, with its arguments) and what MAS
    returns, through the modules' own names, so the world of one and a
    sharded run record alike."""

    def __init__(self):
        from glow_tts_tpu_torch.ops import dropmask
        self.module, self.draw = dropmask, dropmask.stack_mask
        self.masks, self.paths = [], []

    def __enter__(self):
        def recording(seed, *args, **kwargs):
            mask = self.draw(seed, *args, **kwargs)
            self.masks.append((seed, args[:2], mask.clone()))
            return mask
        self.module.stack_mask = recording
        return self

    def __exit__(self, *exc):
        self.module.stack_mask = self.draw

    def mas(self, *args):
        from glow_tts_tpu_torch.ops.mas import maximum_path
        path = maximum_path(*args)
        self.paths.append(path.clone())
        return path


def train_steps(config, state, batch, steps, world, em=False):
    """``steps`` train steps of the port from the full ``state`` on
    ``batch`` (this rank's data share under ``world``), seed 0, the model
    sharded over ``world``'s model group: the metrics of each, the first
    update's gradients of this rank's parameters (its shards and its
    replicated tensors) by name, the flow masks drawn and the MAS paths
    taken, the full parameters after (gathered), and with ``em`` the 'em'
    warmup's table statistics."""
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.training.optim import make_optimizer
    from glow_tts_tpu_torch.training.step import (EMState, build_model,
                                                  init_em_stats,
                                                  make_train_step)
    from glow_tts_tpu_torch.weights import load_state_dict
    model = tp.shard_model(load_state_dict(build_model(config), state),
                           world).prepare(fold=False)
    optimizer = make_optimizer(config, model.parameters())
    grads = []
    step_update = optimizer.step

    def recording_step(frozen=()):
        if not grads:
            names = {id(p): name for name, p in model.named_parameters()}
            grads.append({names[id(p)]: p.grad.detach().clone()
                          for p in optimizer.params})
        return step_update(frozen)

    optimizer.step = recording_step
    em_state = EMState(init_em_stats(config)) if em else None
    batch = {key: torch.as_tensor(value) for key, value in batch.items()}
    with Recorder() as recorder:
        step = make_train_step(config, model, optimizer, seed=0,
                               mas_fn=recorder.mas, em_alignment=em,
                               freeze_decoder=em, em_state=em_state,
                               world=world)
        metrics = [{key: float(value) for key, value in step(batch).items()}
                   for _ in range(steps)]
    return {'metrics': metrics, 'grads': grads[0],
            'specs': tp.specs_of(model), 'masks': recorder.masks,
            'paths': recorder.paths,
            'params': tp.full_state_dict(model, world),
            'em_stats': None if em_state is None else [
                t.clone() for t in em_state.stats]}


def served(config, state, batch, world, dtype, noise):
    """The eval step's losses and one decode (``noise`` given) of the full
    ``state`` served at ``dtype``, sharded over ``world``'s model group
    (``Inferencer``'s weights: weight norm folded)."""
    from glow_tts_tpu_torch.models.glow_tts import GlowTTS
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.training.step import make_eval_step
    from glow_tts_tpu_torch.weights import load_state_dict
    model = tp.shard_model(load_state_dict(GlowTTS(config, dtype), state),
                           world).prepare()
    batch = {key: torch.as_tensor(value) for key, value in batch.items()}
    losses, outputs = make_eval_step(config, model, world=world)(batch)
    prior = model.inference_prior(batch['tokens'], batch['token_lengths'])
    decoded = model.inference_decode(prior, noise=noise,
                                     max_mel_length=noise.shape[1])
    return {'losses': {key: float(value) for key, value in losses.items()},
            'attentions': outputs['attentions'],
            'durations': prior['durations'], 'mels': decoded['mels'],
            'mel_lengths': decoded['mel_lengths']}


def initialised(config, state, batch, world):
    """The full weights after ActNorm's data-dependent initialisation on
    ``batch`` of the full ``state`` sharded over ``world``'s model group
    (through the sharded stack, step by step)."""
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.training.step import build_model
    from glow_tts_tpu_torch.weights import load_state_dict
    model = tp.shard_model(load_state_dict(build_model(config), state),
                           world).prepare(fold=False)
    model.data_dependent_init(torch.as_tensor(batch['mels']),
                              torch.as_tensor(batch['mel_lengths']))
    return tp.full_state_dict(model, world)


def collectives(world):
    """The four autograd functions of ``parallel/tp.py`` on this rank's
    tensors: what each gives forward, and the gradient of a weighted sum
    of it (weight ``model_index + 1``) backward."""
    from glow_tts_tpu_torch.parallel import tp
    out = {}
    weight = world.model_index + 1.0
    for name in ('copy', 'reduce', 'scatter', 'gather'):
        x = (torch.arange(8.0).reshape(2, 4) + 10 * world.model_index
             ).requires_grad_()
        y = {'copy': lambda: tp.copy_to_model(x, world),
             'reduce': lambda: tp.reduce_from_model(x, world),
             'scatter': lambda: tp.scatter_to_model(x, 1, world),
             'gather': lambda: tp.gather_from_model(x, 1, world)}[name]()
        (y * weight).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def payload_round_trip(config, payload, world):
    """A world of one's checkpoint ``payload`` restored sharded over
    ``world``'s model group (into a model of other weights), and the
    payload that state saves again."""
    from glow_tts_tpu_torch.models.glow_tts import random_state_dict
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.training.checkpoint import (restore_train_state,
                                                        train_payload)
    from glow_tts_tpu_torch.training.optim import make_optimizer
    from glow_tts_tpu_torch.training.step import build_model
    from glow_tts_tpu_torch.weights import load_state_dict
    model = tp.shard_model(load_state_dict(
        build_model(config), random_state_dict(config, 7)),
        world).prepare(fold=False)
    optimizer = make_optimizer(config, model.parameters())
    restore_train_state(model, optimizer, payload, world)
    shards = {name: value.clone() for name, value
              in model.state_dict().items()}
    generator = torch.Generator().manual_seed(0)
    again = train_payload(model, optimizer, payload['Steps'],
                          payload['Epochs'], payload['seed'], generator,
                          world=world)
    return {'shards': shards, 'payload': again}


def saved_after_steps(config, state, batch, steps, world):
    """The checkpoint payload a sharded run saves after ``steps`` train
    steps from the full ``state``."""
    from glow_tts_tpu_torch.parallel import tp
    from glow_tts_tpu_torch.training.checkpoint import train_payload
    from glow_tts_tpu_torch.training.optim import make_optimizer
    from glow_tts_tpu_torch.training.step import build_model, make_train_step
    from glow_tts_tpu_torch.weights import load_state_dict
    model = tp.shard_model(load_state_dict(build_model(config), state),
                           world).prepare(fold=False)
    optimizer = make_optimizer(config, model.parameters())
    generator = torch.Generator().manual_seed(0)
    step = make_train_step(config, model, optimizer, seed=0,
                           generator=generator, world=world)
    batch = {key: torch.as_tensor(value) for key, value in batch.items()}
    for _ in range(steps):
        step(batch)
    return train_payload(model, optimizer, steps, 0, 0, generator,
                         world=world)


def steps_job(world, job):
    """Each scenario on this rank's share of its batch: ``'steps'``
    (:func:`train_steps`), ``'served'``, ``'collectives'``, ``'init'``,
    ``'round_trip'`` or ``'saved'``."""
    out = {}
    for name, scenario in job['scenarios'].items():
        batch = scenario['batches'][world.data_index]
        kind = scenario.get('kind', 'steps')
        if kind == 'steps':
            out[name] = train_steps(scenario['config'], job['state'], batch,
                                    scenario['steps'], world,
                                    em=scenario.get('em', False))
        elif kind == 'served':
            out[name] = served(scenario['config'], job['state'], batch,
                               world, scenario['dtype'], scenario['noise'])
        elif kind == 'collectives':
            out[name] = collectives(world)
        elif kind == 'init':
            out[name] = initialised(scenario['config'], job['state'], batch,
                                    world)
        elif kind == 'round_trip':
            out[name] = payload_round_trip(scenario['config'],
                                           scenario['payload'], world)
        else:
            out[name] = saved_after_steps(scenario['config'], job['state'],
                                          batch, scenario['steps'], world)
    return out


# ---------------------------------------------------------------------------
# the trainer


def trainer_job(world, job):
    """Three ``Trainer`` runs of ``job['runs']`` (name → config): the
    uninterrupted run, then a run that rank 1 stops with SIGTERM after
    its second step, resumed by a third.  Per run: the batches each step
    took, the losses rank 0 logged, the checkpoint saves this rank made,
    whether it decoded, the files of its inference, its parameters at the
    end (gathered whole) and its generator."""
    from glow_tts_tpu_torch.parallel import tp
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
        writer = trainer.writers['eval']
        out[name] = {
            'start': start, 'step': trainer.step, 'batches': seen,
            'interrupted': interrupted, 'saves': list(saves),
            'logged': {key: {tag: list(values) for tag, values in
                             getattr(w, 'scalars', {}).items()}
                       for key, w in trainer.writers.items()},
            'histograms': sorted(getattr(writer, 'histograms', {})),
            'free_running': trainer.free_running is not None,
            'specs': tp.specs_of(trainer.model),
            'params': tp.full_state_dict(trainer.model, world),
            'generator': trainer.generator.get_state()}
    CheckpointManager.save = save
    return out
