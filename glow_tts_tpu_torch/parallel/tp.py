"""Tensor parallelism over a ``model`` group of ranks (port of
``glow_tts_tpu/parallel/tp.py``).

The JAX package gives its parameters ``PartitionSpec``s over the mesh's
``model`` axis and lets GSPMD insert the collectives.  Here every rank is a
process that holds its slice of each sharded parameter and a whole copy of
the rest, and the modules call the collectives themselves, as Megatron's
column- and row-parallel layers do.  The layout is the JAX package's
(:data:`PARTITION_RULES`, written over the port's parameter names):

* encoder attention: Query/Key/Value column-parallel by whole heads, the
  projection row-parallel (its bias added once, after the sum);
* encoder FFN: ``Conv_0`` column-parallel over the hidden channels,
  ``Conv_1`` row-parallel;
* duration predictor: the same pair (``CRND_0``, ``CRND_1``) over its
  channels, the projection replicated;
* coupling WaveNet: ``Start`` column-parallel, so the hidden stream lives
  sharded; every ``In_i`` row-parallel, one sum per layer, so the gate's
  pre-activations come out replicated; ``Res_Skip``, ``End`` and the
  conditioning convs replicated;
* everything else replicated.

A sharded dimension that does not divide by the group's size replicates
its family (with one warning), as ``tp.py::_spec_for`` replicates the
parameter; so does an attention whose head count does not divide (the JAX
package's GSPMD would split mid-head, which changes where the values live
and not what they are; a rank here computes whole heads).

The activations cross the group through four autograd functions, the
conjugate pairs of Megatron (:func:`copy_to_model`, :func:`reduce_from_model`,
:func:`scatter_to_model`, :func:`gather_from_model`): a replicated tensor
entering a sharded computation passes :func:`copy_to_model`, whose backward
sums the ranks' partial gradients, so every replicated parameter gets the
whole gradient, the same bits on every rank, and no gradient is summed over
the group afterwards.  Each is the identity where the group has one rank.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENC = r'layer_Dict\.Encoder\.layer_Dict'
_BLOCK = (r'(?P<owner>' + _ENC
          + r'\.Transformer\.layer_Dict\.ANCRDCN_\d+)\.layer_Dict')
_DURATION = r'(?P<owner>' + _ENC + r'\.Duration_Predictor)\.layer_Dict'
_COUPLING = (r'(?P<owner>layer_Dict\.Decoder\.layer_Dict\.Flows\.\d+)'
             r'\.layers\.2\.layer_Dict')

# (family, parameter regex, sharded dimension in the torch layout): the
# JAX package's rules (``glow_tts_tpu/parallel/tp.py:56-80``) over the
# port's names, a conv weight ``[out, in, k]`` column-parallel on 0 and
# row-parallel on 1; the group ``owner`` names the module a family
# belongs to.  The first full match wins; no match is replicated.
PARTITION_RULES: List[Tuple[str, str, int]] = [
    ('attention', _BLOCK + r'\.Attention\.layer_Dict\.(Query|Key|Value)'
                           r'\.(weight|bias)', 0),
    ('attention', _BLOCK + r'\.Attention\.layer_Dict\.Projection\.weight', 1),
    ('ffn', _BLOCK + r'\.Conv_0\.(weight|bias)', 0),
    ('ffn', _BLOCK + r'\.Conv_1\.weight', 1),
    ('duration', _DURATION + r'\.CRND_0\.layer_Dict\.Conv\.(weight|bias)', 0),
    ('duration', _DURATION + r'\.CRND_1\.layer_Dict\.Conv\.weight', 1),
    ('coupling', _COUPLING + r'\.Start\.(weight_g|weight_v|bias)', 0),
    ('coupling', _COUPLING + r'\.WaveNet\.layer_Dict\.In_\d+\.weight_v', 1),
]

Specs = Dict[str, Optional[int]]

# collectives of the model group since the last reset_collectives():
# calls and bytes of each kind (chip_smoke.py prints a step's)
COLLECTIVES = {'all_reduce': 0, 'all_reduce_bytes': 0, 'all_gather': 0,
               'all_gather_bytes': 0}


def reset_collectives() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


def _family(name: str) -> Optional[Tuple[str, str, int]]:
    """(family, the module it belongs to, sharded dim) of ``name``, or
    None where no rule matches."""
    for family, pattern, dim in PARTITION_RULES:
        match = re.fullmatch(pattern, name)
        if match:
            return family, match.group('owner'), dim
    return None


def param_specs(model: torch.nn.Module, tp: int) -> Specs:
    """Each parameter name of the full-size ``model`` (a ``GlowTTS``) →
    the dimension sharded over a model group of ``tp`` ranks, or None
    (replicated).  A family of parameters (one attention, FFN, duration
    predictor or coupling) is sharded whole or replicated whole: where a
    dimension does not divide by ``tp``, or the heads of an attention do
    not, or the duration predictor has no second conv, with one warning
    each."""
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    specs: Specs = {name: None for name in shapes}
    if tp <= 1:
        return specs
    members: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
    for name in shapes:
        found = _family(name)
        if found is not None:
            family, owner, dim = found
            members.setdefault((family, owner), []).append((name, dim))
    heads = model.config.encoder.transformer.attention.heads
    for (family, owner), params in members.items():
        reason = None
        for name, dim in params:
            if shapes[name][dim] % tp:
                reason = (f'{name} dim {dim} ({shapes[name][dim]}) not '
                          f'divisible by model={tp}')
                break
        if reason is None and family == 'attention' and heads % tp:
            reason = f'{owner}: {heads} heads not divisible by model={tp}'
        if reason is None and family == 'duration' and len(params) < 3:
            reason = f'{owner}: no second conv to pair CRND_0 with'
        if reason is not None:
            logger.warning('tp: %s — replicating', reason)
            continue
        for name, dim in params:
            specs[name] = dim
    return specs


def sharded_param_count(specs: Specs, shapes: Mapping[str, Sequence[int]]
                        ) -> Tuple[int, int]:
    """(parameters with a sharded dimension, all parameters) of the full
    ``shapes``, for the trainer's log line."""
    total = sum(math.prod(shape) for shape in shapes.values())
    sharded = sum(math.prod(shapes[name]) for name, dim in specs.items()
                  if dim is not None)
    return sharded, total


def _slice(tensor: torch.Tensor, dim: int, world) -> torch.Tensor:
    part = tensor.shape[dim] // world.model_size
    return tensor.narrow(dim, world.model_index * part, part)


def shard_state_dict(full: Mapping[str, torch.Tensor], world,
                     specs: Specs) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full state dict (or of anything keyed by
    parameter names: the optimiser's moments), as copies; entries the
    specs do not shard are copied whole."""
    out = {}
    for name, value in full.items():
        value = torch.as_tensor(value)
        dim = specs.get(name)
        if dim is not None and world.model_size > 1:
            value = _slice(value, dim, world)
        out[name] = value.detach().clone().contiguous()
    return out


def gather_state_dict(shard: Mapping[str, torch.Tensor], world,
                      specs: Specs) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shard (collective over the
    model group: every rank of it calls it), as copies on the shards'
    device: the sharded tensors through one all-gather of a flat buffer on
    the world's device (NCCL gathers CUDA tensors only), the rest
    copied."""
    out = {name: value.detach().clone() for name, value in shard.items()}
    names = [name for name in shard if specs.get(name) is not None]
    if not names or world.model_size <= 1:
        return out
    flat = torch.cat([shard[name].detach().float().reshape(-1).to(
        world.device) for name in names])
    parts = [torch.empty_like(flat) for _ in range(world.model_size)]
    _all_gather(parts, flat, world)
    sizes = [shard[name].numel() for name in names]
    pieces = [part.split(sizes) for part in parts]
    for i, name in enumerate(names):
        local = shard[name]
        out[name] = torch.cat([piece[i].view_as(local) for piece in pieces],
                              dim=specs[name]).to(local.device, local.dtype)
    return out


# ---------------------------------------------------------------------------
# the collectives of the model group


def _all_reduce(tensor: torch.Tensor, world) -> torch.Tensor:
    COLLECTIVES['all_reduce'] += 1
    COLLECTIVES['all_reduce_bytes'] += tensor.numel() * tensor.element_size()
    dist.all_reduce(tensor, group=world.model_group)
    return tensor


def _all_gather(parts: List[torch.Tensor], tensor: torch.Tensor,
                world) -> None:
    COLLECTIVES['all_gather'] += 1
    COLLECTIVES['all_gather_bytes'] += (tensor.numel() * tensor.element_size()
                                        * world.model_size)
    dist.all_gather(parts, tensor, group=world.model_group)


def _gather(x: torch.Tensor, dim: int, world) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world.model_size)]
    _all_gather(parts, x, world)
    return torch.cat(parts, dim=dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.world), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        return _all_reduce(x.contiguous().clone(), world)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, world):
        ctx.dim, ctx.world = dim, world
        return _slice(x, dim, world).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.world), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, world):
        ctx.dim, ctx.world = dim, world
        return _gather(x, dim, world)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.world).contiguous(), None, None


def _active(world) -> bool:
    return world is not None and world.model_size > 1


def copy_to_model(x: torch.Tensor, world) -> torch.Tensor:
    """A replicated tensor entering a sharded computation: the identity
    forward, its gradient summed over the model group backward."""
    return _Copy.apply(x, world) if _active(world) else x


def reduce_from_model(x: torch.Tensor, world) -> torch.Tensor:
    """The ranks' partial sums added into the replicated value (an
    all-reduce forward, the identity backward)."""
    return _Reduce.apply(x, world) if _active(world) else x


def scatter_to_model(x: torch.Tensor, dim: int, world) -> torch.Tensor:
    """This rank's slice of a replicated tensor along ``dim`` forward, the
    slices' gradients gathered backward."""
    return _Scatter.apply(x, dim, world) if _active(world) else x


def gather_from_model(x: torch.Tensor, dim: int, world) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim`` forward, this rank's
    slice of the gradient backward."""
    return _Gather.apply(x, dim, world) if _active(world) else x


# ---------------------------------------------------------------------------
# a model's layout


@dataclasses.dataclass(frozen=True)
class Shard:
    """What a sharded parameter carries (``param.tp_shard``): the
    dimension it is sliced along and the world of its model group."""
    dim: int
    world: object


def shard_model(model: torch.nn.Module, world) -> torch.nn.Module:
    """Shard the full-size ``model`` (a ``GlowTTS`` on its device, weights
    loaded) over ``world``'s model group in place: each parameter of
    :func:`param_specs` becomes this rank's slice (carrying a
    :class:`Shard` as ``tp_shard``), the modules of each sharded family
    take the group, and the flow decoder's packed weights are dropped.
    Sets ``model.tp_specs`` and ``model.tp_shapes`` (the full shapes).
    The identity for a model group of one rank."""
    if world.model_size <= 1:
        return model
    from glow_tts_tpu_torch.models import decoder as decoder_lib
    from glow_tts_tpu_torch.models import encoder as encoder_lib
    from glow_tts_tpu_torch.models import layers as layers_lib
    specs = param_specs(model, world.model_size)
    model.tp_shapes = {name: tuple(p.shape)
                       for name, p in model.named_parameters()}
    model.tp_specs = specs
    with torch.no_grad():
        for name, param in model.named_parameters():
            dim = specs[name]
            if dim is not None:
                param.data = _slice(param.data, dim, world).clone()
                param.tp_shard = Shard(dim, world)
    names = {id(module): name for name, module in model.named_modules()}

    def sharded(module, param_name):
        return specs.get(f'{names[id(module)]}.{param_name}') is not None

    for module in model.modules():
        if isinstance(module, layers_lib.RelativePositionMultiHeadAttention):
            if sharded(module.layer_Dict['Query'], 'weight'):
                module.shard(world)
        elif isinstance(module, encoder_lib.TransformerBlock):
            if sharded(module.layer_Dict['Conv_0'], 'weight'):
                module.shard(world)
        elif isinstance(module, encoder_lib.DurationPredictor):
            conv = module.layer_Dict['CRND_0'].layer_Dict['Conv']
            if sharded(conv, 'weight'):
                module.shard(world)
        elif isinstance(module, decoder_lib.FlowDecoder):
            steps = list(module.layer_Dict['Flows'])
            if all(sharded(step.layers[2].layer_Dict['Start'], 'weight_v')
                   for step in steps):
                module.shard(world)
    sharded_count, total = sharded_param_count(specs, model.tp_shapes)
    logger.info('tensor parallel over model=%d: %d / %d parameters sharded '
                '(%.0f%%)', world.model_size, sharded_count, total,
                100.0 * sharded_count / max(total, 1))
    return model


def specs_of(model: torch.nn.Module) -> Specs:
    """The layout :func:`shard_model` gave ``model`` (every parameter
    replicated for a model that was not sharded)."""
    return getattr(model, 'tp_specs', None) or {
        name: None for name, _ in model.named_parameters()}


def full_state_dict(model: torch.nn.Module, world) -> Dict[str, torch.Tensor]:
    """``model``'s state dict at full size (collective over the model
    group where it is sharded): the layout a world of one's checkpoint
    has."""
    return gather_state_dict(model.state_dict(), world, specs_of(model))



def shard_dims(params: Sequence[torch.nn.Parameter]
               ) -> List[Optional[Shard]]:
    """Each parameter's :class:`Shard`, or None where it is whole."""
    return [getattr(p, 'tp_shard', None) for p in params]
