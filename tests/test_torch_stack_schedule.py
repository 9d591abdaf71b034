"""The one-launch flow stack's schedule (``csrc/flow_stack.cu``), held on
the CPU through its Python twin ``stack_tile_schedule``.

The kernel deals a list of items to G persistent blocks (block g takes the
items g, g + G, … in order): first the dead tiles' zeroing, then (step,
live tile) step by step.  Step j + 1 on tile i waits for step j on tiles
i − 1, i and i + 1 of the sample, and the steps go to and fro between two
buffers, the last one into ``z``.  Held here:

* (a) every (step, live tile) appears once, every dead tile once, and every
  item waits for exactly the items whose rows its halo reads, all earlier
  in the list;
* (b) G blocks that take their items in order and wait on the flags
  finish on any grid, with at most ceil(steps · L / G) live items a block;
* (c) under random interleavings that respect the flags, every read of a
  buffer region sees the write of the step before (or the dead tile's
  zeros): no region is overwritten two steps on before its readers are
  done, and ``z`` ends with the last step's rows;
* the stack run tile by tile in such an order, each tile
  ``flow_step_reference`` on its halo window (TT = 4 frames, N = 2 layers,
  k = 5, so HALO = 4 ≤ TT) written into two buffers that start as NaN,
  equals ``flow_stack_reference`` and the JAX package's ``fused_flow_stack``
  in interpret mode, within ``tests/test_torch_flow_stack.py``'s
  tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_tpu.ops.coupling import fused_flow_stack
from glow_tts_tpu_torch.ops import coupling as tc
from tests.test_torch_flow_stack import C, CH, K, LD_TOL, N, Z_TOL, _weights
from tests.torch_port_helpers import t

STEPS = 3
# (T, lengths, holes): frames [a, b) of sample i set to 0 inside its length
MASKS = {
    'ragged': (200, [1, 32, 33, 200, 96], {}),
    'holes': (130, [130, 70, 64], {0: (10, 90), 2: (31, 40)}),
    'empty sample': (70, [0, 70, 5], {}),
}
GRIDS = ['1', '3', 'L', 'all']        # L: the live tiles of a step; all: more
                                      # blocks than items
# the float32 builds' time tile and the bfloat16 build's (its ring body)
TILES = pytest.mark.parametrize('tile', [tc.TIME_TILE, tc.RING_TIME_TILE],
                                ids=['tt32', 'tt48'])


def _mask(name):
    frames, lengths, holes = MASKS[name]
    mask = (np.arange(frames)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.float32)
    for i, (a, b) in holes.items():
        mask[i, a:b] = 0.0
    return mask[..., None]


def _schedule(name, tile=tc.TIME_TILE, steps=STEPS):
    mask = _mask(name)
    lengths = tc.valid_lengths(t(mask)).tolist()
    return tc.stack_tile_schedule(lengths, mask.shape[1], steps, tile), \
        lengths, mask.shape[1]


def _grid(grid, items):
    live = sum(item.live for item in items) // STEPS
    return {'1': 1, '3': 3, 'L': live, 'all': len(items) + 5}[grid]


def _buffers(step, steps):
    """(read, written) buffers of step ``step``: the input, then to and fro
    between 'other' and 'z' so that the last step writes 'z'."""
    def out(j):
        return 'z' if (steps - 1 - j) % 2 == 0 else 'other'
    return ('x' if step == 0 else out(step - 1)), out(step)


def _interleave(items, grid, rng):
    """A random order of the blocks' events that respects the flags: each
    block starts its next item once the items it waits for have finished,
    and finishes it later.  Yields ('start' | 'finish', position)."""
    queues = [list(range(g, len(items), grid)) for g in range(grid)]
    done = [False] * len(items)
    running = [None] * grid
    while any(queues) or any(n is not None for n in running):
        events = [(g, 'finish') for g in range(grid) if running[g] is not None]
        events += [(g, 'start') for g in range(grid)
                   if running[g] is None and queues[g]
                   and all(done[a] for a in items[queues[g][0]].after)]
        assert events, 'no block can go on: the schedule deadlocks'
        g, kind = events[rng.integers(len(events))]
        if kind == 'start':
            running[g] = queues[g].pop(0)
        else:
            done[running[g]] = True
        yield kind, running[g]
        if kind == 'finish':
            running[g] = None


@TILES
@pytest.mark.parametrize('name', MASKS)
def test_stack_schedule_lists_each_item_once_after_what_it_reads(name, tile):
    items, lengths, frames = _schedule(name, tile)
    tiles = tc.live_tile_schedule(lengths, frames, tile)
    live = [(b, i) for b, i, alive in tiles if alive]
    dead = [(b, i) for b, i, alive in tiles if not alive]
    n_tiles = -(-frames // tile)
    # the dead tiles first, once each, then each step's live tiles in the
    # live-tile order
    assert [(it.sample, it.tile) for it in items[:len(dead)]] == dead
    assert not any(it.live or it.after for it in items[:len(dead)])
    assert [(it.step, it.sample, it.tile) for it in items[len(dead):]] == [
        (j, b, i) for j in range(STEPS) for b, i in live]
    where = {}
    for n, it in enumerate(items):
        if not it.live:
            for j in range(STEPS):
                where[(j, it.sample, it.tile)] = n
            continue
        want = () if it.step == 0 else tuple(
            where[(it.step - 1, it.sample, i)]
            for i in (it.tile - 1, it.tile, it.tile + 1) if 0 <= i < n_tiles)
        assert it.after == want
        assert all(a < n for a in it.after)
        where[(it.step, it.sample, it.tile)] = n
    if name == 'empty sample':
        assert not any(it.sample == 0 and it.live for it in items)


@TILES
@pytest.mark.parametrize('grid', GRIDS)
@pytest.mark.parametrize('name', MASKS)
def test_blocks_taking_items_in_order_finish_in_the_predicted_rounds(name,
                                                                    grid,
                                                                    tile):
    items, _, _ = _schedule(name, tile)
    blocks = _grid(grid, items)
    order = list(_interleave(items, blocks, np.random.default_rng(0)))
    finished = [n for kind, n in order if kind == 'finish']
    assert sorted(finished) == list(range(len(items)))
    per_block = [sum(items[n].live for n in range(g, len(items), blocks))
                 for g in range(blocks)]
    live = sum(item.live for item in items)
    assert max(per_block) == -(-live // blocks)
    assert sum(per_block) == live


@TILES
@pytest.mark.parametrize('grid', GRIDS)
@pytest.mark.parametrize('name', MASKS)
def test_no_buffer_region_is_overwritten_before_it_is_read(name, grid, tile):
    items, lengths, frames = _schedule(name, tile)
    n_tiles = -(-frames // tile)
    blocks = _grid(grid, items)
    for seed in range(8):
        last_write = {}                   # (buffer, sample, tile) -> item
        for kind, n in _interleave(items, blocks,
                                   np.random.default_rng(seed)):
            it = items[n]
            if kind == 'finish':
                if it.live:
                    last_write[(_buffers(it.step, STEPS)[1], it.sample,
                                it.tile)] = n
                else:
                    for buffer in ('z', 'other'):
                        last_write[(buffer, it.sample, it.tile)] = n
                continue
            if not it.live or it.step == 0:
                continue                  # reads nothing, or the input x
            read = _buffers(it.step, STEPS)[0]
            for i in (it.tile - 1, it.tile, it.tile + 1):
                if not 0 <= i < n_tiles:
                    continue
                writer = items[last_write[(read, it.sample, i)]]
                assert (writer.sample, writer.tile) == (it.sample, i)
                assert not writer.live or writer.step == it.step - 1, (
                    f'item {n} reads tile {i} as step {writer.step} left it')
        for (buffer, b, i), n in last_write.items():
            if buffer == 'z':
                assert (not items[n].live) or items[n].step == STEPS - 1


TILE = 4                                  # HALO = N (K - 1) / 2 = 4 <= TILE
EMULATED = {                              # (T, lengths, holes)
    'ragged': (13, [5, 13, 12, 1], {}),
    'holes and an empty sample': (13, [13, 0, 9], {0: (2, 6), 2: (4, 5)}),
}


def _emulate(x, mask, w, cond, reverse, blocks, seed):
    """The stack as the kernel runs it: the items of ``stack_tile_schedule``
    in a random order the flags allow, each live tile read from its halo
    window when it starts and computed and written when it finishes."""
    b, frames, c = x.shape
    halo = N * (K - 1) // 2
    steps = w['w_in'].shape[0]
    items = tc.stack_tile_schedule(tc.valid_lengths(mask).tolist(), frames,
                                   steps, TILE)
    buffers = {'x': x, 'z': torch.full_like(x, float('nan')),
               'other': torch.full_like(x, float('nan'))}
    ld_part = torch.full((b, -(-frames // TILE)), float('nan'))
    windows = {}
    for kind, n in _interleave(items, blocks, np.random.default_rng(seed)):
        it = items[n]
        own = slice(it.tile * TILE, min((it.tile + 1) * TILE, frames))
        if not it.live:
            if kind == 'finish':
                for buffer in ('z', 'other'):
                    buffers[buffer][it.sample, own] = 0.0
                ld_part[it.sample, it.tile] = 0.0
            continue
        read, written = _buffers(it.step, steps)
        lo = max(0, it.tile * TILE - halo)
        hi = min(frames, (it.tile + 1) * TILE + halo)
        if kind == 'start':
            windows[n] = buffers[read][it.sample:it.sample + 1, lo:hi].clone()
            continue
        s = steps - 1 - it.step if reverse else it.step
        ws = {key: value[s] for key, value in w.items()}
        m = mask[it.sample:it.sample + 1, lo:hi]
        cs = cond[s][:, it.sample:it.sample + 1]
        window = windows.pop(n)
        rows = slice(own.start - lo, own.stop - lo)
        z, _ = tc.flow_step_reference(window, m, ws, cs, reverse)
        buffers[written][it.sample, own] = z[0, rows]
        if not reverse:
            # the owned frames' share of the step's logdet, added in step
            # order as the kernel adds it
            y = ((ws['an_bias'] + torch.exp(ws['an_logs']) * window) * m
                 @ ws['mix_t']) * m
            _, logs = tc.wavenet_stats(y[..., :c // 2], m, ws, cs)
            share = ((logs * m)[0, rows].sum()
                     + ws['ld_const'] * m[0, rows].sum())
            ld_part[it.sample, it.tile] = share if it.step == 0 else \
                ld_part[it.sample, it.tile] + share
    return buffers['z'], (None if reverse else ld_part.sum(dim=1))


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('blocks', [1, 3, 7])
@pytest.mark.parametrize('name', EMULATED)
def test_the_stack_tile_by_tile_equals_the_plain_and_the_pallas_stack(
        name, blocks, reverse):
    frames, lengths, holes = EMULATED[name]
    b = len(lengths)
    rng = np.random.default_rng(80 + blocks + 10 * reverse)
    mask = (np.arange(frames)[None, :]
            < np.asarray(lengths)[:, None]).astype(np.float32)
    for i, (lo, hi) in holes.items():
        mask[i, lo:hi] = 0.0
    mask = mask[..., None]
    x = rng.standard_normal((b, frames, C)).astype(np.float32)  # unmasked
    w = _weights(rng, STEPS)
    if reverse:
        del w['ld_const']
    cond = (rng.standard_normal((STEPS, N, b, 2 * CH)) * .2
            ).astype(np.float32)
    wt = {key: t(value) for key, value in w.items()}
    z, ld = _emulate(t(x), t(mask), wt, t(cond), reverse, blocks, seed=blocks)
    assert torch.isfinite(z).all(), 'a row nothing wrote reached z'
    z_ref, ld_ref = tc.flow_stack_reference(t(x), t(mask), wt, t(cond),
                                            reverse=reverse)
    z_jax, ld_jax = fused_flow_stack(
        jnp.asarray(x), jnp.asarray(mask),
        {key: jnp.asarray(value) for key, value in w.items()},
        jnp.asarray(cond), reverse=reverse, interpret=True)
    np.testing.assert_allclose(z.numpy(), z_ref.numpy(), **Z_TOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_jax), **Z_TOL)
    if reverse:
        assert ld is None
    else:
        np.testing.assert_allclose(ld.numpy(), ld_ref.numpy(), **LD_TOL)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_jax), **LD_TOL)
