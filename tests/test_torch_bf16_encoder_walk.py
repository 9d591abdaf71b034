"""ROADMAP C.2's bf16 gradient gap, traced to one op on
``tests/test_torch_data_parallel.py``'s batch and weights (``tiny_config``
under ``'flax'``, dropout 0), in one process, at bf16.

On that batch the port's bf16 gradients miss the bar of
``assert_bf16_grads`` against the JAX package's jitted bf16 step (at most
twice JAX's own bf16-vs-f32 distance from JAX's bf16, plus 1e-4) on 18 of
113 leaves, most of them the encoder's.  These tests walk the text encoder
alone, layer by layer, the JAX package's and the port's from the same f32
weights and inputs, and from the same cotangents at its three outputs
(JAX's f32 cotangents of the train loss there):

* forward, every layer's output: the port's bf16 is bit-equal to JAX's
  bf16 computed op by op (the same jit compiled with
  ``xla_allow_excess_precision`` off) at every layer, and to JAX's jitted
  bf16 up to the prenet's first LayerNorm, the first layer whose output
  the jit moves; from there on it sits within 0.84 of the 2× bar;
* backward, the leaves' gradients layer by layer from the output back:
  against JAX's jitted bf16, 36 of the encoder's 53 leaves miss the bar,
  and the first layer with a leaf past it is ``block_1``'s ``conv_0`` (the
  feed-forward's first conv of the last block: its kernel 2.06×, its bias
  1.49×; the worst leaf ``block_1``'s ``rel_emb_k``, 3.15×).  JAX's own
  op-by-op bf16 misses its jitted bf16 there by as much (2.06×), and the
  port sits within 0.41 of the bar against JAX's op-by-op bf16 on every
  leaf.

So the gap is XLA's, not a cast of the port's: with excess precision
allowed (XLA's default on the CPU) XLA drops the bf16 round trips inside
its fused chains, so the jitted bf16 gradient sits nearer f32 than flax's
op-by-op rounding, which the port follows.  The tests pin the measured
distances (the first miss's ratio in (1, 2.5], the worst at most 3.5) and
hold the port to the bar against the op-by-op result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from glow_tts_tpu.models.encoder import TextEncoder as JaxTextEncoder
from glow_tts_tpu.training import step as jstep
from glow_tts_tpu_torch.models.glow_tts import GlowTTS as PortGlowTTS
from glow_tts_tpu_torch.weights import load_jax_params, reference_to_params
from tests.test_torch_data_parallel import BUCKETS, dp_problem
from tests.torch_port_helpers import (GRAD_ATOL, GRAD_FACTOR, at_dtype,
                                      norm_rel, port_config)

# op by op: what XLA computes when it may not keep a bf16 value in f32
OP_BY_OP = {'xla_allow_excess_precision': False}
FIRST_MOVED = 'prenet/norm_0'     # the first output the jit moves
FIRST_MISS = 'block_1/conv_0'     # its kernel 2.06 × the bar, bias 1.49
FIRST_MISS_RATIO = (1.0, 2.5)
WORST_RATIO = 3.5                  # measured 3.15 (block_1's rel_emb_k)
BLOCKS = 2


def _layers():
    """(JAX module path, the port's module under the encoder) of every
    layer, in forward order."""
    out = [('embedding', 'layer_Dict.Embedding')]
    prenet = 'layer_Dict.Prenet.layer_Dict'
    for i in range(2):
        out += [(f'prenet/conv_{i}', f'{prenet}.CLRD_{i}.layer_Dict.Conv'),
                (f'prenet/norm_{i}',
                 f'{prenet}.CLRD_{i}.layer_Dict.LayerNorm')]
    out += [('prenet/proj', f'{prenet}.Conv1x1'),
            ('prenet', 'layer_Dict.Prenet')]
    for i in range(BLOCKS):
        block = f'layer_Dict.Transformer.layer_Dict.ANCRDCN_{i}'
        attention = f'{block}.layer_Dict.Attention'
        out += [(f'block_{i}/attention/{j}',
                 f'{attention}.layer_Dict.{p}') for j, p in (
                     ('query', 'Query'), ('key', 'Key'), ('value', 'Value'),
                     ('proj', 'Projection'))]
        out += [(f'block_{i}/attention', attention)]
        out += [(f'block_{i}/{j}', f'{block}.layer_Dict.{p}') for j, p in (
            ('norm_0', 'LayerNorm_0'), ('conv_0', 'Conv_0'),
            ('conv_1', 'Conv_1'), ('norm_1', 'LayerNorm_1'))]
        out += [(f'block_{i}', block)]
    return out + [('project', 'layer_Dict.Project')]


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.fixture(scope='module')
def walk():
    """The encoder's inputs, the cotangents at its outputs, JAX's layer
    outputs and leaf gradients (jitted at f32 and bf16, and op by op at
    bf16), and the port's at bf16."""
    jcfg, pcfg, _, whole, _, _, params = dp_problem()
    assert len(_layers()) and jcfg.encoder.transformer.stacks == BLOCKS
    batch = {key: jnp.asarray(value) for key, value in whole.items()}
    t_tok = whole['tokens'].shape[1]
    mask = (np.arange(t_tok)[None, :] < whole['token_lengths'][:, None]
            )[..., None].astype(np.float32)

    # the cotangents of the f32 train loss at the encoder's three outputs
    model = jstep.build_model(jcfg)

    def loss(p, probes):
        def add_probes(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == '__call__' and \
                    context.module.scope.path == ('encoder',):
                out = tuple(o + q for o, q in zip(out, probes))
            return out
        with nn.intercept_methods(add_probes):
            out = model.apply({'params': p}, deterministic=False,
                              rngs={'dropout': jax.random.PRNGKey(1)},
                              tokens=batch['tokens'],
                              token_lengths=batch['token_lengths'],
                              mels=batch['mels'],
                              mel_lengths=batch['mel_lengths'])
        return jstep.compute_losses(jcfg, out, batch)['total']
    b, m = whole['tokens'].shape[0], jcfg.sound.mel_dim
    probes = tuple(jnp.zeros((b, t_tok, c), jnp.float32) for c in (m, m, 1))
    cotangents = [np.asarray(c) for c in jax.jit(jax.grad(
        loss, argnums=1))(params, probes)]

    def jax_side(dtype, options=None):
        cfg = at_dtype(jcfg, dtype)
        encoder = JaxTextEncoder(cfg, jnp.dtype(dtype))

        def run(p):
            layers = {}

            def record(next_fun, args, kwargs, context):
                out = next_fun(*args, **kwargs)
                path = context.module.scope.path
                if context.method_name == '__call__' and path:
                    layers['/'.join(path)] = _first(out)
                return out
            with nn.intercept_methods(record):
                out = encoder.apply({'params': p}, batch['tokens'],
                                    jnp.asarray(mask), None, True)
            return out, layers

        def grads(p):
            out, vjp = jax.vjp(lambda q: run(q)[0], p)
            return vjp(tuple(jnp.asarray(c, o.dtype)
                             for c, o in zip(cotangents, out)))[0]
        compiled = {name: jax.jit(fn).lower(params['encoder']).compile(
            compiler_options=options) for name, fn in (
                ('layers', lambda p: run(p)[1]), ('grads', grads))}
        layers = {k: np.asarray(v, np.float32) for k, v in
                  compiled['layers'](params['encoder']).items()}
        leaves = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                  for k, v in jax.tree_util.tree_leaves_with_path(
                      compiled['grads'](params['encoder']))}
        return layers, leaves

    # the port at bf16, each layer's output recorded by a hook
    pcfg16 = dataclasses.replace(port_config(at_dtype(jcfg, 'bfloat16')),
                                 **BUCKETS)
    port = load_jax_params(PortGlowTTS(pcfg16), params, pcfg16).prepare(
        fold=False).set_compute_dtype('bfloat16')
    encoder = port.layer_Dict['Encoder']
    modules = dict(encoder.named_modules())
    layers = {}
    for jax_name, port_name in _layers():
        modules[port_name].register_forward_hook(
            lambda module, args, out, key=jax_name: layers.__setitem__(
                key, _first(out).detach().to(torch.bfloat16).float()
                .numpy()))
    outs = encoder(torch.from_numpy(whole['tokens']).long(),
                   torch.from_numpy(mask), None, True)
    torch.autograd.backward(outs, [torch.tensor(c).to(o.dtype)
                                   for c, o in zip(cotangents, outs)])
    state = {name: torch.zeros_like(value)
             for name, value in port.state_dict().items()}
    state.update({name: p.grad for name, p in port.named_parameters()
                  if p.grad is not None})
    port_leaves = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                   for k, v in jax.tree_util.tree_leaves_with_path(
                       reference_to_params(state, pcfg16)['encoder'])}
    return {'f32': jax_side('float32'), 'jit': jax_side('bfloat16'),
            'op_by_op': jax_side('bfloat16', OP_BY_OP),
            'port': (layers, port_leaves)}


def _ratios(port, j16, j32):
    """Leaf by leaf in ``j32``'s order, the norm-relative distance of the
    port from ``j16`` over the bar ``2·‖j16 − j32‖/‖j32‖ + 1e-4``; leaves
    whose f32 gradient is rounding noise (``assert_bf16_grads``'s floor)
    left out."""
    floor = 1e-5 * max(np.linalg.norm(v) for v in j32.values())
    return {key: norm_rel(port[key], j16[key])
            / (GRAD_FACTOR * norm_rel(j16[key], j32[key]) + GRAD_ATOL)
            for key in j32 if np.linalg.norm(j32[key]) >= floor}


def test_forward_layer_by_layer(walk):
    port, j16, j32 = (walk[k][0] for k in ('port', 'jit', 'f32'))
    op_by_op = walk['op_by_op'][0]
    moved = []
    for name, _ in _layers():
        got = float(np.abs(port[name] - j16[name]).max())
        own = float(np.abs(j16[name] - j32[name]).max())
        assert got <= GRAD_FACTOR * own + 1e-6, (name, got, own)
        np.testing.assert_array_equal(port[name], op_by_op[name],
                                      err_msg=name)
        if got:
            moved.append(name)
    assert moved[0] == FIRST_MOVED, moved


def _layer_of(key):
    """The innermost layer of :func:`_layers` that holds leaf ``key``
    (None for the duration predictor's, which reads detached features)."""
    held = [name for name, _ in _layers() if key.startswith(
        ''.join(f"['{part}']" for part in name.split('/')))]
    return max(held, key=len) if held else None


def test_gradients_leaf_by_leaf_name_the_op(walk):
    port, j32 = walk['port'][1], walk['f32'][1]
    jit, op_by_op = walk['jit'][1], walk['op_by_op'][1]
    assert set(port) == set(jit) == set(op_by_op) == set(j32)
    against_jit = _ratios(port, jit, j32)
    against_op_by_op = _ratios(port, op_by_op, j32)
    jax_own = _ratios(op_by_op, jit, j32)
    # from the output back, the first layer with a leaf past the bar
    by_layer = {}
    for key, ratio in against_jit.items():
        by_layer.setdefault(_layer_of(key), []).append(key)
    walked = [name for name, _ in reversed(_layers()) if name in by_layer]
    misses = [name for name in walked
              if max(against_jit[key] for key in by_layer[name]) > 1.0]
    assert misses and misses[0] == FIRST_MISS, misses
    first = max(by_layer[FIRST_MISS], key=against_jit.get)
    low, high = FIRST_MISS_RATIO
    assert low < against_jit[first] <= high, (first, against_jit[first])
    assert max(against_jit.values()) <= WORST_RATIO, max(
        against_jit.values())
    # JAX's op-by-op bf16 misses its jitted bf16 there as the port does
    assert jax_own[first] > 1.0 and abs(
        jax_own[first] - against_jit[first]) <= 0.1 * against_jit[first], (
        jax_own[first], against_jit[first])
    # and against the op-by-op result the port meets the bar everywhere
    worst = max(against_op_by_op, key=against_op_by_op.get)
    assert against_op_by_op[worst] <= 1.0, (worst, against_op_by_op[worst])
