"""Plain twins of the shared-memory arithmetic of the bf16 train kernels
(``csrc/bf16_mma.cuh``, the ``GLOW_BF16`` builds of ``csrc/flow_train_bwd.cu``
and ``csrc/flow_train_fwd.cu``), so that the CPU tests can hold the layouts
and the fragment addressing that only the card runs.

* :func:`sw128_offsets`, :func:`stage_sw128`, :func:`unstage_sw128`: a tile
  of 64-deep bfloat16 rows in the 128-byte swizzle, as the backward's
  activation-gradient tiles are staged for ``wgmma``;
  :func:`wgmma_k_major_rows` reads a 16-deep step of it back the way a
  matrix descriptor addresses it (start address advanced by 32 bytes a
  step, the swizzle applied to the whole address).
* :func:`ldmatrix_x4` and :func:`mma_m16n8k16`: what ``ldmatrix.x4`` (with
  or without ``.trans``) gives each lane from shared memory, and the warp's
  ``mma.sync.m16n8k16`` product of such fragments.
* :func:`wgrad_lane_rows`, :func:`forward_lane_rows`: the rows each lane
  hands to ``ldmatrix`` in the weight-gradient tile and in the forward's
  bf16 body.
* :func:`wgrad_slices`: the weight gradients' walk of a chunk's samples in
  32-frame slices.
* The ring body of the bfloat16 flow step and coupling
  (``csrc/flow_ring.cuh``):
  :func:`ring_slice_operand`, a product's B operand as ``wgmma`` reads a
  warpgroup's columns from a staged slice; :func:`ring_lane_rows`, the rows
  and depth each lane hands to ``ldmatrix`` for A, the k-tap conv's tap
  one row further each; :func:`ring_accumulator_cells`, the (row, column)
  of each accumulator register of a warpgroup's product, and
  :func:`ring_gate_channels`, the gate's channel of each column pair;
  :func:`ring_program`, the slices a tile stages in turn (the flow
  step's, or the coupling's without the mixing).

Nothing here runs in the port's paths; each function mirrors a line of
device code named in its docstring.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

ROW_BYTES = 128        # a 64-deep bfloat16 row of a swizzled tile
CHUNK_BYTES = 16       # one cp.async, one ldmatrix row: 8 bfloat16
WGRAD_SLICE = 32       # frames of a weight-gradient slice (BK)


def sw128_offsets(rows: int) -> torch.Tensor:
    """``[rows, 8]`` byte offsets of the 16-byte chunk ``c`` of row ``r`` of
    a swizzled tile: ``128 r + 16 (c ^ (r % 8))`` (``bf16_mma.cuh::sw128``)."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(ROW_BYTES // CHUNK_BYTES)[None, :]
    return r * ROW_BYTES + CHUNK_BYTES * (c ^ (r % 8))


def stage_sw128(tile: torch.Tensor) -> torch.Tensor:
    """The shared-memory image (``[rows * 64]`` bfloat16) of ``tile [rows,
    64]`` staged chunk by chunk at :func:`sw128_offsets`."""
    rows, depth = tile.shape
    assert depth == ROW_BYTES // 2, tile.shape
    image = torch.zeros(rows * depth, dtype=tile.dtype)
    at = sw128_offsets(rows) // 2
    for c in range(depth // 8):
        for e in range(8):
            image[at[:, c] + e] = tile[:, 8 * c + e]
    return image


def unstage_sw128(image: torch.Tensor, rows: int) -> torch.Tensor:
    """The tile :func:`stage_sw128` staged into ``image``."""
    at = sw128_offsets(rows) // 2
    return torch.stack([image[at[:, c] + e] for c in range(8)
                        for e in range(8)], dim=1)


def wgmma_k_major_rows(image: torch.Tensor, row0: int, rows: int,
                       k: int) -> torch.Tensor:
    """``[rows, 16]``: the 16-deep step ``k`` of rows ``row0 ..`` of a
    swizzled tile as ``wgmma`` reads it through a K-major descriptor whose
    start address is the tile's (1024-byte aligned) plus ``128 row0 + 32
    k`` bytes: element ``(r, j)`` at the unswizzled address ``start + 128 r
    + 2 j``, whose 16-byte chunk bits (4-6) are XORed with its row bits
    (7-9)."""
    r = torch.arange(rows)[:, None]
    j = torch.arange(16)[None, :]
    plain = ROW_BYTES * row0 + 32 * k + ROW_BYTES * r + 2 * j
    swizzled = plain ^ (((plain >> 7) & 7) << 4)
    return image[swizzled // 2]


def ldmatrix_x4(smem: torch.Tensor, lane_bytes: torch.Tensor,
                trans: bool = False) -> torch.Tensor:
    """``[32, 4, 2]``: lane ``4g + t``'s four registers (two 16-bit values
    each, the low half first) from ``ldmatrix.x4`` on ``smem`` (16-bit
    elements, byte addresses): lanes ``8i .. 8i + 7`` give the 16-byte rows
    of matrix ``i``; lane ``4g + t`` receives row ``g``, elements ``2t`` and
    ``2t + 1`` (``.trans``: rows ``2t`` and ``2t + 1`` of column ``g``)."""
    rows = torch.stack([smem[lane_bytes // 2 + e] for e in range(8)], dim=1)
    out = torch.empty((32, 4, 2), dtype=smem.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            matrix = rows[8 * i: 8 * i + 8]
            if trans:
                out[lane, i] = matrix[2 * t: 2 * t + 2, g]
            else:
                out[lane, i] = matrix[g, 2 * t: 2 * t + 2]
    return out


def mma_m16n8k16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The warp's ``[16, 8]`` product of the fragments ``a [32, 4, 2]``
    (A's a0..a3) and ``b [32, 2, 2]`` (B's b0, b1), in float64 (exact for
    bfloat16 operands at this depth): a0 ``(g, 2t..)``, a1 ``(g + 8,
    2t..)``, a2 ``(g, 2t + 8..)``, a3 ``(g + 8, 2t + 8..)``; b0 ``(2t..,
    g)``, b1 ``(2t + 8.., g)``."""
    A = torch.empty((16, 16), dtype=torch.float64)
    B = torch.empty((16, 8), dtype=torch.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r, k: k + 2] = a[lane, i].double()
        for i, k in enumerate((2 * t, 2 * t + 8)):
            B[k: k + 2, g] = b[lane, i].double()
    return A @ B


def wgrad_lane_rows(warp_m: int, warp_n: int, ldp: int = 104,
                    ldg: int = 136) -> Tuple[torch.Tensor, torch.Tensor]:
    """The element offsets each lane hands to ``ldmatrix.x4.trans`` for the
    weight-gradient tile's first 16-frame step (``gemm_tn_tile``'s
    ``a_off`` and ``b_off``): in the P slice ``[32, ldp]`` (frames by the
    tile's 96 channels) for the warp's first m16 tile, and in the G slice
    ``[32, ldg]`` for its first pair of n8 tiles.  Each further m16 tile is
    16 elements on, each pair of n8 tiles 16, each 16-frame step ``16 ld``."""
    lane = torch.arange(32)
    mi, mr = lane // 8, lane % 8
    a_off = (mr + 8 * (mi // 2)) * ldp + 48 * warp_m + 8 * (mi % 2)
    b_off = (mr + 8 * (mi % 2)) * ldg + 32 * warp_n + 8 * (mi // 2)
    return a_off, b_off


def forward_lane_rows(pitch: int) -> torch.Tensor:
    """The byte offsets each lane hands to ``ldmatrix.x4`` for a 16 x 16 A
    block of rows ``pitch`` bytes apart (``tc_gemm_bf16_tiles``'s
    ``lane_at``): row ``(l % 8) + 8 ((l / 8) % 2)``, depth ``8 (l / 16)``."""
    lane = torch.arange(32)
    return ((lane % 8) + 8 * ((lane // 8) % 2)) * pitch + 16 * (lane // 16)


def wgrad_slices(lengths: List[int], samples_per_chunk: int
                 ) -> List[Tuple[int, int, int]]:
    """``(chunk, sample, first frame)`` of every slice the weight-gradient
    tiles stage, in their order (``gemm_tn_tile``'s walk): chunk ``c``
    takes the samples ``[c spc, (c + 1) spc)``, each in slices of
    :data:`WGRAD_SLICE` frames up to its length, samples of length 0
    skipped."""
    out = []
    b_count = len(lengths)
    for chunk in range(-(-b_count // samples_per_chunk)):
        begin = chunk * samples_per_chunk
        for b in range(begin, min(begin + samples_per_chunk, b_count)):
            for frame in range(0, lengths[b], WGRAD_SLICE):
                out.append((chunk, b, frame))
    return out


def ring_slice_operand(image: torch.Tensor, warpgroup: int, nw: int,
                       j: int, k: int) -> torch.Tensor:
    """``[96, 16]``: the B operand (columns by depths) of the ``wgmma``
    that warpgroup ``warpgroup`` issues for its ``j``-th 96 columns of a
    product whose warpgroups take ``nw`` x 96 columns each, at the 16-deep
    step ``k`` of a staged slice ``image`` (a ring slot, 1024-byte aligned,
    64-deep rows in the 128-byte swizzle): the descriptor's start is the
    slot's plus ``128 (warpgroup nw + j) 96 + 32 k`` bytes (``ring_gemm``'s
    ``b0``)."""
    return wgmma_k_major_rows(image, (warpgroup * nw + j) * 96, 96, k)


def ring_lane_rows(pitch: int, tap: int = 0) -> torch.Tensor:
    """``[4, 32]``: the byte offset, from a bfloat16 tile's row 0, each lane
    of warp ``w`` of a warpgroup hands to ``ldmatrix.x4`` for its 16 rows
    of a 16 x 16 A block (rows ``pitch`` bytes apart), with the k-tap
    conv's tap ``tap`` ``tap`` rows further on (``ring_lane_at`` plus the
    tap's rows in ``ring_flow_step_tile``): row ``16 w + (l % 8) + 8 ((l /
    8) % 2) + tap``, depth ``8 (l / 16)``."""
    lane = torch.arange(32)[None, :]
    warp = torch.arange(4)[:, None]
    return ((16 * warp + lane % 8 + 8 * ((lane // 8) % 2) + tap) * pitch
            + 16 * (lane // 16))


def ring_accumulator_cells(nw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows, columns)``, each ``[4, 32, nw, 48]``: the tile row and the
    column of its warpgroup's half of register ``e`` of accumulator ``j``
    of lane ``l`` of warp ``w`` of a warpgroup (``ring_gemm``'s epilogue
    calls): row ``16 w + g + 8 h``, column ``96 j + 8 n + 2 t + p`` for
    ``e = 4 n + 2 h + p``, lane ``4 g + t``."""
    w = torch.arange(4)[:, None, None, None]
    lane = torch.arange(32)[None, :, None, None]
    j = torch.arange(nw)[None, None, :, None]
    e = torch.arange(48)[None, None, None, :]
    g, t = lane // 4, lane % 4
    n, h, p = e // 4, (e // 2) % 2, e % 2
    rows = 16 * w + g + 8 * h + 0 * j
    cols = 96 * j + 8 * n + 2 * t + p + 0 * w
    return rows.expand(4, 32, nw, 48), cols.expand(4, 32, nw, 48)


def ring_gate_channels(warpgroup: int, columns: torch.Tensor) -> torch.Tensor:
    """The gate's channel whose tanh (even column) or sigmoid (odd) half a
    k-tap conv column of warpgroup ``warpgroup``'s half holds (its
    epilogue's ``(192 wg + col) / 2``)."""
    return (192 * warpgroup + columns) // 2


def ring_program(channels: int, reverse: bool, layers: int = 4,
                 taps: int = 5, ch: int = 192, mixing: bool = True
                 ) -> List[Tuple[str, object, int]]:
    """``(ring weight, layer or None, slice)`` of each position ``p`` of a
    tile's program as ``ring_slice`` maps it (forward: the mixing first;
    then the start conv, each layer's k-tap and res/skip slices, the end
    conv; reverse: the mixing last), one entry a position; without
    ``mixing`` the coupling's program (``ring_coupling_tile``: no mixing
    slices)."""
    def slices(depth):
        return -(-depth // (ROW_BYTES // 2))
    s_mix = slices(channels) if mixing else 0
    s_start = slices(channels // 2)
    s_in, s_rs, s_end = slices(taps * ch), slices(ch), slices(ch)
    out = []
    for p in range(s_mix + s_start + layers * (s_in + s_rs) + s_end):
        if mixing and not reverse:
            if p < s_mix:
                out.append(('mix_ring', None, p))
                continue
            p -= s_mix
        if p < s_start:
            out.append(('start_ring', None, p))
            continue
        p -= s_start
        if p < layers * (s_in + s_rs):
            layer, q = divmod(p, s_in + s_rs)
            out.append(('in_ring', layer, q) if q < s_in
                       else ('rs_ring', layer, q - s_in))
            continue
        p -= layers * (s_in + s_rs)
        out.append(('end_ring', None, p) if not mixing or p < s_end
                   else ('mix_ring', None, p - s_end))
    return out
