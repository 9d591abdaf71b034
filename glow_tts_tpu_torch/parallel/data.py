"""Data parallelism, one process per card (the data axis of
``glow_tts_tpu/parallel/mesh.py``), and the grid of ranks that tensor
parallelism (``parallel/tp.py``) adds a model axis to.

The JAX package shards the global batch over a mesh's ``data`` axis and
lets XLA insert the gradient sum.  Here every rank is a process with its
own card (``cuda:LOCAL_RANK``), its own stride of the data and its own
share of the global batch, and the train step reduces what the global
batch needs explicitly: the losses' denominators, the 'em' warmup's table
statistics, the gradients (one sum over a flat buffer) and the reported
metrics.  A :class:`World` carries the rank and the process group; every
reduction of a world of one without a group (:data:`SINGLE`) is an
identity, and a world of one with a group (``torchrun --nproc_per_node
1``) reduces through the group, which changes no value.

On a card the backend is NCCL, and a CUDA build of torch without NCCL
raises; on the CPU it is gloo.  Another backend is taken only when the
caller names it (``initialize(..., backend='gloo')`` runs two ranks on one
card, which NCCL refuses).  Host values (the stop flag, batch counts,
generator states) go through a gloo group of the whole world, so agreeing
on them never waits for the card.

With ``TPU.model_parallel`` M above 1 the launched world is a ``data ×
model`` grid: rank r has data index ``r // M`` and model index ``r % M``,
the order of ``mesh.make_mesh``'s ``reshape(data, model)``.  The M ranks of
one data index form a model group, which holds one copy of the model
sharded (``parallel/tp.py``) and sees one share of the batch; the ranks of
one model index form a data group, over which every reduction of this
module runs (the losses' denominators, the gradients, the metrics, the EM
table).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# the stride between the ranks' flow-dropout seeds: the JAX package's
# ``seed + axis_index('data') * 0x68E31DA4`` in int32
# (``glow_tts_tpu/ops/coupling_grad.py:897-902``)
SHARD_SEED_STRIDE = 0x68E31DA4


def shard_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s int32 dropout seed from the run's ``seed``: ``seed +
    rank · 0x68E31DA4`` wrapped to int32, so rank r draws the masks of
    the JAX package's shard r; rank 0's is ``seed``."""
    mixed = (int(seed) + int(rank) * SHARD_SEED_STRIDE) & 0xFFFFFFFF
    return mixed - (1 << 32) if mixed >= (1 << 31) else mixed


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks of a run: ``rank`` of
    ``size``, ``local_rank`` on its node, the ``device`` it trains on, the
    process ``group`` of the data group's device collectives (None: a data
    group of one rank, which reduces nothing), its ``backend``, the gloo
    ``host_group`` of host values (the whole world), the ``model_size``
    ranks of its model group and that group's ``model_group`` (None where
    it has one rank)."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device('cpu')
    group: Optional[object] = None
    backend: Optional[str] = None
    host_group: Optional[object] = None
    model_size: int = 1
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes logs, checkpoints and inference."""
        return self.rank == 0

    @property
    def data_index(self) -> int:
        """This rank's share of the batch: its index in its data group."""
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        """This rank's shard of the model: its index in its model group."""
        return self.rank % self.model_size

    @property
    def data_size(self) -> int:
        """The ranks of a data group: the shares the global batch splits
        into."""
        return self.size // self.model_size

    @property
    def data_group(self):
        """The process group of the data reductions (:attr:`group`)."""
        return self.group

    def all_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the ranks, in place, and returned."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_sum_each(self, tensors: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Each of ``tensors`` (one dtype, one device) summed over the
        ranks, through one flat buffer; the tensors themselves where there
        is no group."""
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_sum(flat)
        return [piece.view_as(t) for piece, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def reduce_gradients(self, params: Sequence[torch.Tensor]) -> None:
        """Sum every parameter's gradient over the ranks, in ``params``'
        order, through one flat buffer (a missing gradient counts as
        zero), so that every rank holds the same gradients.  The sums are
        copied back into the gradients' own tensors: the optimiser then
        reads tensors laid out as in a world of one (a view of the buffer
        may be aligned otherwise, and a reduction over it sum in another
        order)."""
        if self.group is None:
            return
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        for p, grad, total in zip(params, grads, self.all_sum_each(grads)):
            p.grad = grad.copy_(total)

    def broadcast_(self, tensor: torch.Tensor, src: int = 0
                   ) -> torch.Tensor:
        """``tensor`` overwritten with that of the rank of data index
        ``src`` in this rank's data group, in place."""
        if self.group is not None:
            dist.broadcast(tensor, src * self.model_size + self.model_index,
                           group=self.group)
        return tensor

    # host values (Python ints), through the gloo group: the sum, max and
    # min all-reduces

    def _host(self, values: Sequence[int], op) -> List[int]:
        if self.host_group is None:
            return [int(v) for v in values]
        tensor = torch.tensor([int(v) for v in values], dtype=torch.int64)
        dist.all_reduce(tensor, op=op, group=self.host_group)
        return tensor.tolist()

    def host_sum(self, *values: int) -> List[int]:
        """Python ints summed over the ranks (a rendezvous of the hosts)."""
        return self._host(values, dist.ReduceOp.SUM)

    def host_max(self, *values: int) -> List[int]:
        return self._host(values, dist.ReduceOp.MAX)

    def host_min(self, *values: int) -> List[int]:
        return self._host(values, dist.ReduceOp.MIN)

    def gather_bytes(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's copy of a uint8 CPU ``tensor`` of one size on all
        ranks (a generator's state), in rank order."""
        if self.host_group is None:
            return [tensor]
        out = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(out, tensor, group=self.host_group)
        return out


    def gather_data(self, obj) -> List:
        """Each data index's ``obj`` (any picklable host value), in data
        order, on every rank: model index 0's of each model group, through
        the gloo group of host values."""
        if self.host_group is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out[::self.model_size]

    def within_model_group(self) -> 'World':
        """This rank's model group as a world of its own: the same model
        shards and device, data size 1, no data group and no host group
        (for what the ranks of one data index run alone, as the trainer's
        inference)."""
        return dataclasses.replace(self, rank=self.model_index,
                                   size=self.model_size, group=None,
                                   host_group=None)


SINGLE = World()

# the world this process initialised (a process group is made once)
_CURRENT: List[World] = []


def launched() -> bool:
    """A launcher (``torchrun``, or the CLI's own) set this process's
    rank: ``WORLD_SIZE`` is in the environment."""
    return 'WORLD_SIZE' in os.environ


def initialize(config, device='cuda', backend: Optional[str] = None
               ) -> World:
    """This process's :class:`World`.  Under a launcher, from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): a process group over TCP, the card ``cuda:LOCAL_RANK``
    made current where ``device`` is CUDA, backend NCCL there and gloo on
    the CPU unless ``backend`` names another.  Without one, a world of one
    on ``device`` with no group.  Made once per process; a second call
    returns the same world.  Raises where CUDA is asked for and absent,
    where NCCL is wanted and this torch has none, and where ``config``
    does not fit the launched world (:func:`check_world`)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           f'available')
    if _CURRENT:
        world = _CURRENT[0]
        if world.device.type != device.type:
            raise RuntimeError(f'this process already trains on '
                               f'{world.device}, not {device}')
    elif not launched():
        world = World(device=device)
    else:
        env = os.environ
        rank, size = int(env['RANK']), int(env['WORLD_SIZE'])
        local_rank = int(env.get('LOCAL_RANK', rank))
        if device.type == 'cuda':
            device = torch.device('cuda', local_rank)
            # before anything allocates: pinned copies and NCCL's buffers
            # go to this rank's own card
            torch.cuda.set_device(device)
            backend = backend or 'nccl'
            if backend == 'nccl' and not dist.is_nccl_available():
                raise RuntimeError('training on the card needs NCCL, and '
                                   'this build of torch has none')
        else:
            backend = backend or 'gloo'
        address = env.get('MASTER_ADDR', 'localhost')
        dist.init_process_group(
            backend, init_method=f'tcp://{address}:{env["MASTER_PORT"]}',
            world_size=size, rank=rank)
        host_group = (dist.group.WORLD if backend == 'gloo'
                      else dist.new_group(backend='gloo'))
        model = max(config.model_parallel, 1)
        if size % model:
            raise ValueError(f'TPU.model_parallel {model} does not divide '
                             f'the {size} processes launched')
        group, model_group = _grid_groups(rank, size, model)
        world = World(rank, size, local_rank, device, group, backend,
                      host_group, model, model_group)
        _CURRENT.append(world)
    check_world(config, world)
    return world


def _grid_groups(rank: int, size: int, model: int):
    """(this rank's data group, its model group) of the ``size // model ×
    model`` grid: every group made once, with ``dist.new_group``, in the
    same order on every rank (a rank takes part in making the groups it is
    not in).  A data group is the whole world where ``model`` is 1, and
    None (an identity) where it has one rank; no model group is made where
    ``model`` is 1."""
    if model == 1:
        return dist.group.WORLD, None
    data = size // model
    groups = {}
    for d in range(data):
        members = [d * model + m for m in range(model)]
        made = dist.new_group(members)
        if rank in members:
            groups['model'] = made
    if data > 1:
        for m in range(model):
            members = [d * model + m for d in range(data)]
            made = dist.new_group(members)
            if rank in members:
                groups['data'] = made
    return groups.get('data'), groups['model']


def check_world(config, world: World) -> None:
    """Raise where ``config`` does not fit ``world``: a world that is not
    ``data × model`` ranks (``TPU.data_parallel`` × ``TPU.model_parallel``,
    data 0 taking every launched rank as in ``mesh.make_mesh``), a model
    group of another size, or a global ``Train.Batch_Size`` that does not
    divide by the data size."""
    model = max(config.model_parallel, 1)
    if world.model_size != model:
        raise ValueError(f'TPU.model_parallel is {model} but this world\'s '
                         f'model groups have {world.model_size} ranks')
    data = config.data_parallel or world.size // model
    if data * model != world.size:
        grid = '' if model == 1 else f' × TPU.model_parallel {model}'
        raise ValueError(f'TPU.data_parallel is {config.data_parallel}{grid} '
                         f'but {world.size} processes were launched; set '
                         f'data_parallel to 0 (every launched process) or '
                         f'launch {data * model}')
    if config.train.batch_size % data:
        raise ValueError(f'global batch size {config.train.batch_size} '
                         f'must divide by process count {data}'
                         + ('' if model == 1 else
                            f' (the data size of {world.size} ranks in '
                            f'model groups of {model})'))


def close() -> None:
    """Destroy this process's group, if it made one."""
    if _CURRENT:
        _CURRENT.clear()
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 outside a launched run)."""
    return _CURRENT[0].rank if _CURRENT else 0


def process_count() -> int:
    """The number of ranks (1 outside a launched run)."""
    return _CURRENT[0].size if _CURRENT else 1


def ranks_to_launch(config, device, backend: Optional[str] = None) -> int:
    """The processes a run of ``config`` on ``device`` takes with no
    launcher: ``data × model``, ``TPU.data_parallel`` × ``TPU.model_parallel``,
    where data 0 is every visible card left over by the model groups (one
    on the CPU, and at least one).  NCCL takes one card per rank, so more
    ranks than visible cards raises, as CUDA asked for and absent does,
    unless the caller names ``backend`` gloo (ranks sharing a card)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           f'available')
    visible = torch.cuda.device_count() if device.type == 'cuda' else 1
    model = max(config.model_parallel, 1)
    wanted = (config.data_parallel or max(visible // model, 1)) * model
    if device.type == 'cuda' and wanted > visible and backend != 'gloo':
        raise ValueError(f'TPU.data_parallel × TPU.model_parallel {wanted} '
                         f'needs {wanted} cards (NCCL takes one card per '
                         f'rank); {visible} visible (gloo runs ranks on '
                         f'one card)')
    return wanted
