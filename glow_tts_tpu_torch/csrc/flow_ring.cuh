// The bfloat16 body of the deterministic flow step and of the affine coupling
// alone on Hopper (GLOW_BF16_RING, defined by the GLOW_BF16 builds of
// flow_step.cu, flow_stack.cu and coupling.cu: #3, #4 and #2 at bfloat16):
// the step of flow_common.cuh's flow_step_tile on one time tile
// (ring_flow_step_tile), or its coupling without ActNorm and the mixing
// (ring_coupling_tile), with every product on the tensor cores through
// wgmma and the weights streamed through shared memory.  Both run the same
// WaveNet (ring_wavenet: start conv through end conv) and the same affine
// (ring_affine, ring_unaffine); the coupling's program is the flow step's
// without the mixing's slices.  The train kernels' builds do not include
// it.
//
// What bounds it on an H100: the tensor cores' rate (3.6 MFLOP a frame,
// 0.06 ms at B = 32 x T = 512 at the bf16 peak).  The earlier bf16 body
// (flow_common.cuh's coupling_net with bfloat16 operands, since removed)
// read each warp's weights from L2 into registers for a 48-row tile,
// widened h and the gate from float32 at every 16-deep step, added every
// mma.sync product into float32 and ran the three 1x1 convs as f32 FMA (a
// third of its tile's time).  This body:
// * tiles time by TT = 48 owned frames, R = 64 rows with the halo, so every
//   product is one m64 row block: the rows computed per owned row fall from
//   1.5 to 1.33 (every layer computes all 64 rows: the rows outside its
//   valid window are never read into a valid one), and a tile's weight
//   bytes serve 48 frames in place of 32;
// * holds h, the gate, x_a, the ActNorm output and the masked skip sum in
//   bfloat16 in shared memory, rounded where the TPU kernel casts them
//   (flow_common.cuh's list); x_b, the skip sum, mean and logs, the logdet
//   stay float32;
// * runs every product, the 1x1 convs included, as wgmma.m64n96k16 with A
//   from registers (ldmatrix.x4 from the unswizzled bfloat16 tiles, so the
//   k-tap conv's one-row shift of tap d is d rows further on) and B from
//   shared memory in the 128-byte swizzle (sw128_desc); each 64-deep slice's
//   product summed in the tensor cores, then added into float32
//   (kSumDepth16: chip_smoke.py's bars hold at 16, 64 and the whole depth,
//   the card tests' logdet bar on 12 steps of random weights, at 1.02 of
//   it, not at the whole depth; PERF.md);
// * streams the weights through a ring of two 48 KB slots: 64-deep slices
//   of a product's weights, packed once in the ring's order and swizzle
//   (ops/coupling.py::ring_layout_bf16), each copied by one bulk copy
//   (cp.async.bulk, completion on an mbarrier) that the warp releasing the
//   slot last issues, so every weight byte crosses L2 once a tile for all
//   its rows.  The copies hide behind the products: a tile takes as long
//   with none at all, and as long on 16 SMs as on 132;
// * splits each product's columns between the two warpgroups: the k-tap
//   conv's 384 (w_in's tanh and sigmoid columns interleaved, so a thread's
//   accumulator pair (8j + 2t, + 1) is one channel's and the gate is fused
//   into the epilogue), the res/skip conv's res half (warpgroup 0) and skip
//   half (warpgroup 1), and each 1x1's two output halves (x_a and x_b,
//   mean and logs), each padded to 96 columns;
// * keeps the epilogues short, since the products run at the tensor cores'
//   rate and the epilogues between them were half a tile's time: the gate
//   by ex2.approx and one rcp.approx (gate), a thread's cells walked a
//   column pair at a time for both its rows (ring_cols), each warpgroup's
//   epilogue its own code, the rows' masks in registers.
// The shared memory: the ring 96 KB (+ 1 KB to align it), h, the gate (also
// the ActNorm output, the masked skip sum and the inverse mixing's input),
// the skip sum (also x_a before layer 0, mean and logs after the end conv),
// x_b and the mask: 206 KB at 160 channels, with the live-tile list and the
// pitch stage within the 227 KB of a block, one block an SM.  Tried and
// dropped (PERF.md): four 24 KB slots of 32-deep slices (slower), a slice
// in several copies (slower), a third slot (no faster), the slices staged
// by every thread's cp.async (no faster).
//
// Other decoder shapes (ROADMAP B.2; RingShape<C, CH, NL, KS, TT>, the
// build's GLOW_CHANNELS, GLOW_LAYERS and GLOW_KSIZE): the WaveNet always
// computes at 192 channels, ch up to 192 zero-padded (ops/coupling.py::
// padded_wavenet: weights, biases, conditioning rows and w_pitch; the
// padded channels stay exact zeros), so the two warpgroups' 96-column
// halves and a tap's whole 64-deep slices hold at any ch.  A tile owns TT =
// 64 - 2 halo frames, at most 48 (the f32 buffers of TT rows keep the
// shipped room), and fewer where the block has no room for them
// (ring_time_tile: the largest multiple of 8 that fits, 40 at C = 216 ..
// 256 without a pitch operand, so 128-bin mels' C = 256 takes 13 tiles of
// a 512-frame sample where 48 frames would take 11).  The mixing's and the
// end conv's output halves are 96 columns, or 2 x 96 where C/2 is over 96
// (NWS; the start conv's stay 96).  A half's rows are read 16 bytes at a
// time, or 8 where C/2 = 4 mod 8 (100-bin mels' C = 200), or 4 where C/2 =
// 2 mod 4 (C = 100: VEC), a whole row 16 or 8 bytes (XVEC); the start
// conv's depth is whole 64-deep slices of zero-padded weights (KSTART) and
// the epilogues of the 1x1 convs drop the column pairs past C/2
// (ring_past: C/2 is even, so a pair lies within or past it).  w_pitch is
// staged where the block has room for it, else the epilogue reads it where
// it lies.  The block fits every shape of the envelope (C a multiple of 4
// up to 256).

#pragma once

#include "bf16_mma.cuh"

#ifndef GLOW_RING_SUM_DEPTH
#define GLOW_RING_SUM_DEPTH 64
#endif

namespace {

// 16-deep steps summed in the tensor cores before an f32 add; 0: all
constexpr int kSumDepth16 = GLOW_RING_SUM_DEPTH / 16;
// the 16-deep steps of one chain of wgmma into a zeroed accumulator
constexpr int kChain16 = kSumDepth16 ? kSumDepth16 : 1;
static_assert(GLOW_RING_SUM_DEPTH == 0 || GLOW_RING_SUM_DEPTH == 16 ||
                  GLOW_RING_SUM_DEPTH == 64,
              "summing depth: 16, 64 or 0 (the whole depth)");

HD constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }

// The ring's slice depth and slots (two 48 KB slots of 64-deep slices beat
// four 24 KB ones of 32-deep slices in the same room: PERF.md)
constexpr int kRingDepth = 64, kRingStages = 2;

// The ring body's shape: C flow channels, the WaveNet at CH = 192 (ch up to
// 192 padded with zeros: ops/coupling.py::padded_wavenet; the products' two
// warpgroups take 96-column halves, and a tap's depth is whole 64-deep
// slices), NL layers of KS taps, TT owned frames a tile (ring_time_tile).
template <int C_, int CH_, int NL_, int KS_, int TT_>
struct RingShape {
  static constexpr int C = C_, C2 = C / 2, CH = CH_, CH2 = 2 * CH, NL = NL_,
                       KS = KS_;
  static_assert(CH == 192, "the ring body's WaveNet width: ch padded to 192");
  static constexpr int PAD = (KS - 1) / 2, HALO = NL * PAD;
  // a tile is one m64 row block with its halo: TT owned frames, at most 64
  // - 2 HALO (48 at the shipped 4 layers of k 5; 32 at the halo of 16) and
  // at most 48 (a smaller halo leaves rows past the halo that no owned row
  // reads: the f32 buffers of TT rows, x_b, the skip sum, mean and logs,
  // keep the shipped room)
  static constexpr int R = 64, TT = TT_;
  static_assert(TT >= 32 && TT <= 48 && TT + 2 * HALO <= R && KS % 2 == 1,
                "a halo of at most 16 frames");
  // a slice's depth (a 128-byte row of B a column, in the 128-byte
  // swizzle), its 16-deep steps, and the ring's slots
  static constexpr int SK = kRingDepth, KK = SK / 16, STAGES = kRingStages;
  static_assert(SK == 64, "one 128-byte swizzled row a column");
  // depths of the products, padded to whole slices with zero weights
  static constexpr int KMIX = round_up(C, SK), KSTART = round_up(C2, SK);
  static constexpr int S_MIX = KMIX / SK, S_START = KSTART / SK;
  static constexpr int S_IN = KS * CH / SK, S_RS = CH / SK, S_END = CH / SK;
  static constexpr int S_TAP = CH / SK;   // a k-tap conv's slices a tap
  static constexpr int S_LAYER = S_IN + S_RS;
  // a coupling's slices (start conv .. end conv), and a flow step's
  static constexpr int S_NET = S_START + NL * S_LAYER + S_END;
  static constexpr int S_TILE = S_MIX + S_NET;
  // a slice's rows of B (the product's columns): the mixing's and the end
  // conv's two halves (x_a and x_b, mean and logs) each padded to NWS 96
  // columns (NWS = 1 up to C/2 = 96, 2 up to 192); the start conv's 192 in
  // two halves of 96; the 384 of a WaveNet product
  static constexpr int NWS = ceil_div(C2, 96);
  static_assert(C % 4 == 0 && NWS <= 2, "C a multiple of 4, C/2 <= 192");
  static constexpr int N_SMALL = 2 * 96 * NWS, N_START = CH, N_BIG = CH2;
  static constexpr int SMALL_BYTES = 2 * SK * N_SMALL,
                       START_BYTES = 2 * SK * N_START,
                       BIG_BYTES = 2 * SK * N_BIG;
  static_assert(SMALL_BYTES <= BIG_BYTES, "a slice within a slot");
  // bfloat16 elements of a half's row that one load moves: 16 bytes, or 8
  // where the row (C/2 elements) is not a multiple of 16 bytes (C = 200),
  // or 4 where it is not a multiple of 8 (C = 100); and of a whole row (C
  // elements), 16 bytes or 8
  static constexpr int VEC = C2 % 8 == 0 ? 8 : C2 % 4 == 0 ? 4 : 2;
  static constexpr int XVEC = C % 8 == 0 ? 8 : 4;
  // bfloat16 row pitches (elements): an odd number of 16-byte chunks, so
  // an ldmatrix read of 8 rows touches 32 banks
  static constexpr int XP = KMIX + 8, AP = KSTART + 8, HP = CH + 8,
                       GP = CH + 8;
  static constexpr int SP = CH + 8;     // the f32 skip sum's
  static constexpr int H_ROWS = R + 2 * PAD;   // tile rows -PAD .. R + PAD
  // byte offsets from the 1024-aligned base
  static constexpr int RING = 0;
  static constexpr int H_OFF = RING + STAGES * BIG_BYTES;
  static constexpr int G_OFF = H_OFF + 2 * H_ROWS * HP;
  static constexpr int G_BYTES = 2 * R * cmax(GP, XP);
  static constexpr int S_OFF = G_OFF + G_BYTES;
  static constexpr int S_BYTES =
      cmax(4 * TT * SP, cmax(2 * R * AP, 4 * TT * C));
  static constexpr int XB_OFF = S_OFF + S_BYTES;
  static constexpr int M_OFF = XB_OFF + 4 * TT * C2;
  static constexpr int BYTES = M_OFF + 4 * R;
  // dynamic shared memory: the buffers, 1 KB to align them, the list
  static constexpr size_t smem_bytes = BYTES + 1024;
  // static shared memory besides a pitch stage: the ActNorm tables (a
  // flow step's), the warps' sums and the ring's barriers (a bound)
  static constexpr int STATIC_BYTES = 8 * C + 128;
  // what write_geometry reports of the ring
  static constexpr int RING_DEPTH = SK, HALF_SMALL = 96 * NWS, HALF_BIG = CH;
  // elements (bfloat16) of a step's packed weights, a slice's
  static constexpr size_t MIX_ELEMS = S_MIX * SK * N_SMALL;
  static constexpr size_t START_ELEMS = S_START * SK * N_START;
  static constexpr size_t IN_ELEMS = NL * S_IN * SK * N_BIG;
  static constexpr size_t RS_ELEMS = NL * S_RS * SK * N_BIG;
  static constexpr size_t END_ELEMS = S_END * SK * N_SMALL;
  static_assert(XP / 8 % 2 == 1 && AP / 8 % 2 == 1 && HP / 8 % 2 == 1,
                "ldmatrix pitches");
};

// The owned frames of a tile at C channels, NL layers of KS taps and a pitch
// operand PS wide (0: none): TT, the most a 64-row tile with its halo holds
// (at most 48), where the block (its buffers, the live-tile list of
// kMaxBatch samples, the static arrays and the 64 pitch rows; w_pitch's
// stage only where it fits beside them) fits an H100's shared memory, else
// the largest multiple of 8 below it that fits: 40 at C = 216 .. 256 without
// pitch, 32 at C = 256 with it (ops/coupling.py::ring_time_tile).
template <int C, int NL, int KS, int PS,
          int TT = (64 - NL * (KS - 1) < 48 ? 64 - NL * (KS - 1) : 48)>
HD constexpr int ring_time_tile() {
  using S = RingShape<C, 192, NL, KS, TT>;
  if constexpr (TT <= 32 ||
                S::smem_bytes + 4 * (2 * kMaxBatch + 1) + S::STATIC_BYTES +
                        4 * PS * S::R <=
                    static_cast<size_t>(kBlockBytes)) {
    return TT;
  } else {
    return ring_time_tile<C, NL, KS, PS, (TT - 1) / 8 * 8>();
  }
}
using RingBuilt =
    RingShape<GLOW_CHANNELS, 192, GLOW_LAYERS, GLOW_KSIZE,
              ring_time_tile<GLOW_CHANNELS, GLOW_LAYERS, GLOW_KSIZE,
                             kPitch ? kPitchSize : 0>()>;
// the buffers, the static arrays, the pitch stage and the live-tile list
// of a batch of up to kMaxBatch within the 227 KB of a block
static_assert(RingBuilt::smem_bytes + 4 * (2 * kMaxBatch + 1) +
                      RingBuilt::STATIC_BYTES +
                      pitch_stage_bytes<RingBuilt>() <=
                  static_cast<size_t>(kBlockBytes),
              "over the 227 KB block limit");

constexpr long long kRingTimeoutCycles = 1LL << 31;   // over a second

// ---------------------------------------------------------------------------
// Hopper pieces: mbarriers, the bulk copy, wgmma with A from registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Returns once the phase of parity `parity` has completed; a wait longer
// than a second traps, so a fault is an error and not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kRingTimeoutCycles) __trap();
  }
}
// bytes (a multiple of 16) from global to shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d[64 x 96] (= or +=, by scale_d) A[64 x 16] . B[96 x 16]^T: A from
// registers (warp w of the warpgroup gives rows 16 w .. 16 w + 15 as
// mma.sync's A fragment), B K-major in shared memory through a descriptor
__device__ __forceinline__ void wgmma_rs_m64n96k16(float (&d)[48],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the weights, and the order the ring stages them in
// ---------------------------------------------------------------------------

// One flow step's weights as the ring body takes them: the five products'
// in ops/coupling.py::ring_layout_bf16 (bfloat16 slices [rows of B, SK
// deep] in the 64-byte swizzle, a step's slices in the order of use), the
// rest float32.
struct RingWeights {
  const float* an_logs;   // [C]
  const float* an_bias;   // [C]
  const act_t* mix;       // [S_MIX, N_SMALL, SK] this direction's mixing
  const act_t* start;     // [S_START, N_SMALL, SK]
  const float* b_start;   // [CH]
  const act_t* w_in;      // [NL, S_IN, N_BIG, SK], gate columns interleaved
  const act_t* w_rs;      // [NL, S_RS, N_BIG, SK], last layer's res half 0
  const float* b_rs;      // [NL, 2CH]
  const act_t* end;       // [S_END, N_SMALL, SK]
  const float* b_end;     // [C]
};

// The entry points' weight pointers (StepWeights' slots) as the ring
// body's: mix_t, w_start, w_in, w_rs and w_end point at the packed slices.
__device__ __forceinline__ RingWeights ring_weights(const StepWeights& w) {
  return {w.an_logs,
          w.an_bias,
          reinterpret_cast<const act_t*>(w.mix_t),
          reinterpret_cast<const act_t*>(w.w_start),
          w.b_start,
          reinterpret_cast<const act_t*>(w.w_in),
          reinterpret_cast<const act_t*>(w.w_rs),
          w.b_rs,
          reinterpret_cast<const act_t*>(w.w_end),
          w.b_end};
}

// Flow step s of weights stacked along a leading axis.
template <class S>
__device__ __forceinline__ RingWeights ring_step_of_stack(const RingWeights& w,
                                                          int s) {
  return {w.an_logs + s * S::C,         w.an_bias + s * S::C,
          w.mix + s * S::MIX_ELEMS,     w.start + s * S::START_ELEMS,
          w.b_start + s * S::CH,        w.w_in + s * S::IN_ELEMS,
          w.w_rs + s * S::RS_ELEMS,     w.b_rs + s * S::NL * S::CH2,
          w.end + s * S::END_ELEMS,     w.b_end + s * S::C};
}

// The slices of a tile's program: a flow step's (MIXING), or the coupling's
// alone (coupling.cu: no mixing slices).
template <class S, bool MIXING>
HD constexpr int ring_tile_slices() {
  return MIXING ? S::S_TILE : S::S_NET;
}

// Slice p (0 .. ring_tile_slices - 1) of a tile's products in the order of
// use: forward the mixing, the start conv, per layer the k-tap conv's and
// the res/skip conv's slices, the end conv; reverse the mixing last.
// Without MIXING, the same program without the mixing's slices.
template <class S, bool REVERSE, bool MIXING>
__device__ __forceinline__ const act_t* ring_slice(const RingWeights& w,
                                                   int p, uint32_t& bytes) {
  constexpr int SMALL = S::SK * S::N_SMALL, BIG = S::SK * S::N_BIG;
  constexpr int START = S::SK * S::N_START;
  bytes = S::SMALL_BYTES;
  if (MIXING && !REVERSE) {
    if (p < S::S_MIX) return w.mix + p * SMALL;
    p -= S::S_MIX;
  }
  if (p < S::S_START) {
    bytes = S::START_BYTES;
    return w.start + p * START;
  }
  p -= S::S_START;
  if (p < S::NL * S::S_LAYER) {
    bytes = S::BIG_BYTES;
    const int layer = p / S::S_LAYER, q = p % S::S_LAYER;
    return q < S::S_IN
               ? w.w_in + static_cast<size_t>(layer * S::S_IN + q) * BIG
               : w.w_rs +
                     static_cast<size_t>(layer * S::S_RS + q - S::S_IN) * BIG;
  }
  p -= S::NL * S::S_LAYER;
  if (!MIXING || p < S::S_END) return w.end + p * SMALL;
  return w.mix + (p - S::S_END) * SMALL;
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

// The weight ring of a block: STAGES slots of BIG_BYTES, a full mbarrier
// and a release count each.  Slices are numbered by a running count q over
// the block's life: slice q lands in slot q % STAGES, completing phase q /
// STAGES of full[q % STAGES].  Each warp adds one to the slot's count once
// it has done with slice q, and the warp whose addition completes the
// slice's (the count reaches kWarps (q / STAGES + 1)) issues slice q +
// STAGES into the slot: no warp waits for the others to release a slot.
struct Ring {
  uint32_t slots;    // shared address of slot 0, 1024-aligned
  uint32_t bars;     // full[STAGES], 8 bytes each
  unsigned* counts;  // [STAGES] the slots' releases, in shared memory
  uint32_t q;        // the next slice to consume
  uint32_t end;      // one past the current tile's last slice
  const RingWeights* w;

  __device__ uint32_t full(uint32_t slot) const { return bars + 8 * slot; }
  // One thread: slice q (position p of the tile's program) into its slot,
  // which slice q - STAGES has left.
  template <class S, bool REVERSE, bool MIXING>
  __device__ void issue(uint32_t slice, int p) const {
    static_assert(S::STAGES == kRingStages, "the ring's barriers");
    const uint32_t slot = slice % S::STAGES;
    uint32_t bytes;
    const act_t* src = ring_slice<S, REVERSE, MIXING>(*w, p, bytes);
    mbar_expect_tx(full(slot), bytes);
    bulk_load(slots + slot * S::BIG_BYTES, src, bytes, full(slot));
  }
  // A tile's program on `weights`: its end, and its first STAGES slices
  // issued by thread 0 (their slots are free: the block's last tile ended
  // on a barrier).  q runs on across the block's tiles.
  template <class S, bool REVERSE, bool MIXING>
  __device__ void begin(const RingWeights& weights) {
    w = &weights;
    end = q + ring_tile_slices<S, MIXING>();
    if (threadIdx.x == 0)
      for (int p = 0; p < S::STAGES; ++p) issue<S, REVERSE, MIXING>(q + p, p);
  }
};

// A warpgroup's share of one product over SLICES slices from the ring into
// out[NW][48]: the 64 rows by its NW x 96 columns (B rows (wg NW + j) 96
// ..), A's lane address a_at(slice, kk) for the 16-deep step kk of a
// slice.  ACTIVE false: the warpgroup takes the slices without a product
// (its columns are all zero weights), out untouched.  With the whole depth
// summed in the tensor cores out is wgmma's accumulator; else a partial
// sum is added into out every kSumDepth16 steps.  REVERSE and MIXING name
// the tile's program (ring_slice), whose slices the last warp to release a
// slot issues.
template <class S, bool REVERSE, bool MIXING, int NW, int SLICES, class AAt>
__device__ __forceinline__ void ring_gemm(Ring& ring, bool active,
                                          const AAt& a_at,
                                          float (&out)[NW][48]) {
  using namespace bf16mma;
  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128;
  float acc[NW][48];   // wgmma's accumulator
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 48; ++e) out[j][e] = acc[j][e] = 0.f;
  constexpr int KK = S::KK, ROW = 2 * S::SK;   // a B row's bytes
  const uint32_t q0 = ring.q;
#pragma unroll 1
  for (int s = 0; s < SLICES; ++s) {
    const uint32_t q = q0 + s, slot = q % S::STAGES;
    uint32_t a[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) ldsm_x4(a[kk], a_at(s, kk));
    mbar_wait(ring.full(slot), (q / S::STAGES) & 1);
    if (active) {
      const uint32_t b0 =
          ring.slots + slot * S::BIG_BYTES + wg * NW * 96 * ROW;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        // the 16-deep step's place in the product, and in its chain
        const int k16 = s * KK + kk;
        const bool first = kSumDepth16 ? k16 % kChain16 == 0 : k16 == 0;
        const bool flush = kSumDepth16 && (k16 % kChain16 == kChain16 - 1 ||
                                           k16 == SLICES * KK - 1);
        if (kk == 0 || first) {
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < NW; ++j) fence_operands(acc[j]);
        }
#pragma unroll
        for (int j = 0; j < NW; ++j)
          wgmma_rs_m64n96k16(acc[j], a[kk],
                             sw128_desc(b0 + j * 96 * ROW + 32 * kk),
                             first ? 0 : 1);
        if (flush) {
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            fence_operands(acc[j]);
#pragma unroll
            for (int e = 0; e < 48; ++e) out[j][e] += acc[j][e];
          }
        }
      }
      // every product reading the slot is done before it is released
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NW; ++j) fence_operands(acc[j]);
    }
    // the slot is free once every warp says so (its products waited for,
    // its count fenced on both sides): the last one refills it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(ring.counts + slot, 1u) ==
              kWarps * (q / S::STAGES + 1) - 1 &&
          q + S::STAGES < ring.end) {
        __threadfence_block();
        ring.issue<S, REVERSE, MIXING>(
            q + S::STAGES,
            q + S::STAGES - (ring.end - ring_tile_slices<S, MIXING>()));
      }
    }
    __syncwarp();
  }
  ring.q = q0 + SLICES;
  if constexpr (!kSumDepth16) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 48; ++e) out[j][e] = acc[j][e];
  }
}

// A thread's cells of a warpgroup's product v[NW][48] lie in two rows,
// ring_row0() and 8 further, and in the column pairs ring_col0() + k of its
// half, k = 96 j + 8 n: f(k, v, v') on the first row, g(k, u, u') on the
// second, one k after the other, so that an epilogue reads what a column
// needs once for both rows and addresses it as a per-thread base plus a
// constant.
__device__ __forceinline__ int ring_row0() {
  return 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
}
__device__ __forceinline__ int ring_col0() { return 2 * (threadIdx.x % 4); }
template <int NW, class F>
__device__ __forceinline__ void ring_cols(const float (&v)[NW][48],
                                          const F& f) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int n = 0; n < 12; ++n)
      f(96 * j + 8 * n, make_float2(v[j][4 * n], v[j][4 * n + 1]),
        make_float2(v[j][4 * n + 2], v[j][4 * n + 3]));
}

// Whether the column pair col0 + k of a 1x1 conv's output half lies past
// its C2 columns (C2 even: a pair lies wholly within or past them).  Where
// C2 is a multiple of 8 that is k past them, a constant once ring_cols is
// unrolled; at C2 = 4 mod 8 (C = 200) one 8-column group straddles C2.
template <class S>
__device__ __forceinline__ bool ring_past(int k, int col0) {
  if constexpr (S::C2 % 8 == 0) return k >= S::C2;
  return col0 + k >= S::C2;
}

// The gate tanh(a) sigmoid(b) with two ex2.approx and one rcp.approx
// (denormals flushed: they only ever reach 0 or 1 here), where tanhf and
// sigmoidf take some sixty instructions: in the k-tap conv's epilogue the
// 64 x 192 gates of a layer and tile ran as long as the product itself
// (PERF.md).  tanh(a) sigmoid(b) = sign(a) (1 - e^{-2|a|}) / ((1 +
// e^{-2|a|}) (1 + e^{-b})): a relative error of about 1e-6 beside a
// bfloat16 gate's 4e-3, so the rounded gate is tanhf's and sigmoidf's but
// for a rare last-bit tie, and tanh keeps its relative accuracy near 0 (an
// absolute error of about 1e-7).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float gate(float a, float b) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float ta = ex2_ftz(-2.f * kLog2e * fabsf(a));
  const float eb = ex2_ftz(-kLog2e * b);
  return copysignf(1.f - ta, a) * rcp_ftz((1.f + ta) * (1.f + eb));
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The byte offset, from a bfloat16 tile's row 0, of the row and depth this
// lane hands to ldmatrix.x4 for its warp's 16 rows of a 16 x 16 A block of
// rows `pitch` bytes apart: row 16 wq + (l % 8) + 8 ((l / 8) % 2), depth
// 8 (l / 16) (ops/bf16_tiles.py::ring_lane_rows).
__device__ __forceinline__ uint32_t ring_lane_at(int pitch) {
  const int lane = threadIdx.x % 32, wq = (threadIdx.x % 128) / 32;
  return (16 * wq + (lane % 8) + 8 * ((lane / 8) % 2)) * pitch +
         16 * (lane / 16);
}

// ---------------------------------------------------------------------------
// a tile
// ---------------------------------------------------------------------------

// V bfloat16 as one load or store: 16 bytes (8), 8 bytes (4) or 4 (2)
template <int V>
struct BfVec;
template <>
struct BfVec<8> {
  using T = uint4;
};
template <>
struct BfVec<4> {
  using T = uint2;
};
template <>
struct BfVec<2> {
  using T = uint32_t;
};

// A block's buffers and the tile it works on: the TT frames from t0 + HALO
// of sample b; row r of a buffer of R rows is frame t0 + r, row r of a
// buffer of TT rows frame t0 + HALO + r.
template <class S>
struct RingTile {
  uint32_t base;         // shared address of the 1024-aligned buffers
  act_t* h;              // [H_ROWS, HP]: tile row r at row r + PAD
  act_t* g;              // [R, GP]: the gate; [R, XP] the mixing's input;
                         // [R, GP] the end conv's
  float* s;              // [TT, SP] the skip sum; [R, AP] bf16 x_a;
                         // [TT, C] mean and logs
  float* xb;             // [TT, C2] x_b
  float* m;              // [R] the mask
  int b, index, B, T, t0;
  size_t sample;

  __device__ RingTile(char* aligned, int B_, int T_, int b_, int index_)
      : base(bf16mma::smem_u32(aligned)),
        h(reinterpret_cast<act_t*>(aligned + S::H_OFF)),
        g(reinterpret_cast<act_t*>(aligned + S::G_OFF)),
        s(reinterpret_cast<float*>(aligned + S::S_OFF)),
        xb(reinterpret_cast<float*>(aligned + S::XB_OFF)),
        m(reinterpret_cast<float*>(aligned + S::M_OFF)),
        b(b_), index(index_), B(B_), T(T_), t0(index_ * S::TT - S::HALO),
        sample(static_cast<size_t>(b_) * T_) {}

  __device__ act_t* xa() const { return reinterpret_cast<act_t*>(s); }

  // z[B*T, W] (a flow step's C, a coupling's C2) gets zeros at the owned
  // frames below T: a dead tile's output, V elements a store.
  template <int W = S::C, int V = S::XVEC>
  __device__ void zero_owned(act_t* z) const {
    using Vec = typename BfVec<V>::T;
    for (int i = threadIdx.x; i < S::TT * (W / V); i += kThreads) {
      const int t = t0 + S::HALO + i / (W / V), c = V * (i % (W / V));
      if (t < T) *reinterpret_cast<Vec*>(z + (sample + t) * W + c) = Vec{};
    }
  }
};

// The pre-gate's staging and layer i's epilogue for the ring body
// (flow_common.cuh's BiasPreGate and PitchPreGate on a RingTile).
template <class S>
__device__ __forceinline__ void ring_stage(const BiasPreGate&,
                                           const RingTile<S>&) {}
template <class S>
__device__ __forceinline__ BiasPreGate::Layer ring_layer(
    const BiasPreGate& pre, int i, const RingTile<S>& tile) {
  return {pre.cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2};
}
// no barrier: the load phase's closing one publishes it
template <class S, int PS>
__device__ __forceinline__ void ring_stage(const PitchPreGate<PS>& pre,
                                           const RingTile<S>& tile) {
  float* const st = pitch_stage<S, PS>();
  for (int i = threadIdx.x; i < S::R * PS; i += kThreads) {
    const int t = tile.t0 + i / PS;
    st[i] = t >= 0 && t < tile.T
                ? __ldg(pre.pitch + (tile.sample + t) * PS + i % PS)
                : 0.f;
  }
  if constexpr (stages_w_pitch<S, PS>())
    for (int i = threadIdx.x; i < S::NL * PS * S::CH2; i += kThreads)
      st[S::R * PS + i] = __ldg(pre.w_pitch + i);
}
// w_pitch staged where the block has room for it (stages_w_pitch), else
// read where it lies
template <class S, int PS>
__device__ __forceinline__ typename PitchPreGate<PS>::template Layer<S>
ring_layer(const PitchPreGate<PS>& pre, int i, const RingTile<S>& tile) {
  const float* const st = pitch_stage<S, PS>();
  return {pre.cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2, st,
          stages_w_pitch<S, PS>() ? st + S::R * PS + i * PS * S::CH2
                                  : pre.w_pitch + i * PS * S::CH2};
}

// The phases of a tile that a timed instantiation clocks, in order.
enum RingPhase {
  kLoad,        // mask, x (forward: ActNorm and the mixing)
  kStart,       // the start conv
  kLayer0,      // layer i: kLayer0 + 2 i the k-tap conv and the gate,
                // kLayer0 + 2 i + 1 the res/skip conv
  kEnd = kLayer0 + 8,   // the masked skip sum and the end conv
  kStore,       // the affine and z (reverse: the inverse mixing)
  kRingPhases
};

// A timed instantiation's row of a block: the cycles of each phase summed
// over its tiles, then the block's cycles and %globaltimer ns from its start
// to its end (their ratio is the SM clock).
constexpr int kClockSlots = kRingPhases + 2;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long cycles() { return clock64(); }

// clock64 at a tile's phase boundaries (after each barrier): thread 0 of
// every block adds the cycles of each phase to its row of `clocks` [grid,
// kClockSlots] (zeroed by the caller); a no-op unless TIMED.
template <bool TIMED>
struct PhaseClock {
  long long* row;
  long long last, start, start_ns;
  __device__ explicit PhaseClock(long long* clocks)
      : row(TIMED && clocks ? clocks + blockIdx.x * kClockSlots : nullptr),
        last(0), start(TIMED ? cycles() : 0),
        start_ns(TIMED ? global_ns() : 0) {}
  __device__ __forceinline__ void begin() {
    if constexpr (TIMED) last = cycles();
  }
  __device__ __forceinline__ void mark(int phase) {
    if constexpr (TIMED) {
      if (threadIdx.x == 0 && row) {
        const long long now = cycles();
        row[phase] += now - last;
        last = now;
      }
    }
  }
  __device__ __forceinline__ void finish() {
    if constexpr (TIMED) {
      if (threadIdx.x == 0 && row) {
        row[kRingPhases] = cycles() - start;
        row[kRingPhases + 1] = global_ns() - start_ns;
      }
    }
  }
};

// Ends on a barrier.
template <class S>
__device__ __forceinline__ void ring_load_mask(const RingTile<S>& tile,
                                               const float* mask) {
  for (int r = threadIdx.x; r < S::R; r += kThreads) {
    const int t = tile.t0 + r;
    tile.m[r] = t >= 0 && t < tile.T ? mask[tile.sample + t] : 0.f;
  }
  __syncthreads();
}

// V elements of x at frame t0 + r, channel c (a multiple of V), or zeros
// where the frame lies outside [0, T) or its mask is 0 (rows past a
// sample's length never reach a valid row, even as NaN): one load of V
// bfloat16, 16, 8 or 4 bytes (S::XVEC for a whole row, S::VEC for a half's)
template <class S, int V = 8>
__device__ __forceinline__ typename BfVec<V>::T ring_x(
    const RingTile<S>& tile, const act_t* x, int r, int c) {
  using Vec = typename BfVec<V>::T;
  const int t = tile.t0 + r;
  if (t < 0 || t >= tile.T || tile.m[r] == 0.f) return Vec{};
  return __ldcg(reinterpret_cast<const Vec*>(x + (tile.sample + t) * S::C +
                                             c));
}

// The same of rows with strides of their own (ring_coupling_tile's halves:
// Rows' data, batch_stride and row_stride, the strides in elements and
// multiples of V, the address 2 V-byte aligned, as ops/coupling.py checks)
template <class S>
__device__ __forceinline__ uint4 ring_x8(const RingTile<S>& tile,
                                         const act_t* x, int r, int c) {
  return ring_x<S, 8>(tile, x, r, c);
}

template <class S, int V, class Rows>
__device__ __forceinline__ typename BfVec<V>::T ring_rows(
    const RingTile<S>& tile, const Rows& x, int r, int c) {
  using Vec = typename BfVec<V>::T;
  const int t = tile.t0 + r;
  if (t < 0 || t >= tile.T || tile.m[r] == 0.f) return Vec{};
  return __ldg(reinterpret_cast<const Vec*>(
      x.data + tile.b * x.batch_stride + t * x.row_stride + c));
}

__device__ __forceinline__ float bf_at(const uint4& u, int e) {
  const uint32_t w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  return e % 2 ? tf32::bf16_hi(w) : tf32::bf16_lo(w);
}
__device__ __forceinline__ float bf_at(const uint2& u, int e) {
  const uint32_t w = e < 2 ? u.x : u.y;
  return e % 2 ? tf32::bf16_hi(w) : tf32::bf16_lo(w);
}
__device__ __forceinline__ float bf_at(const uint32_t& w, int e) {
  return e % 2 ? tf32::bf16_hi(w) : tf32::bf16_lo(w);
}
// V floats rounded to bfloat16, packed as one store
__device__ __forceinline__ void bf_pack(const float (&v)[8], uint4& out) {
  out = make_uint4(tf32::pack_bf16(v[0], v[1]), tf32::pack_bf16(v[2], v[3]),
                   tf32::pack_bf16(v[4], v[5]), tf32::pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void bf_pack(const float (&v)[4], uint2& out) {
  out = make_uint2(tf32::pack_bf16(v[0], v[1]), tf32::pack_bf16(v[2], v[3]));
}
__device__ __forceinline__ void bf_pack(const float (&v)[2], uint32_t& out) {
  out = tf32::pack_bf16(v[0], v[1]);
}

// x_a's padding to the start conv's depth: zeros in the columns C2 ..
// KSTART of every row of tile.xa(), S::VEC at a time
template <class S>
__device__ __forceinline__ void ring_pad_xa(const RingTile<S>& tile) {
  constexpr int V = S::VEC;
  using Vec = typename BfVec<V>::T;
  constexpr int CHUNKS = (S::KSTART - S::C2) / V;
  act_t* const xa = tile.xa();
  for (int i = threadIdx.x; i < S::R * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = S::C2 + V * (i % CHUNKS);
    *reinterpret_cast<Vec*>(xa + r * S::AP + c) = Vec{};
  }
}

// The coupling network on a tile, the part a flow step and a coupling share
// (flow_common.cuh::coupling_net in this body): start 1x1 on x_a (tile.xa(),
// all R rows, rounded, zero from C2 to KSTART) -> NL gated k-tap layers ->
// end 1x1 on the masked skip sum, leaving mean and logs of the owned rows in
// tile.s [TT, C] (float32).  Takes the mask, the staged pre-gate and x_a
// published by a barrier, and the start conv's slices next on the ring
// (REVERSE and MIXING: the tile's program); clocks kStart .. kEnd; ends on
// a barrier.
template <class S, bool REVERSE, bool MIXING, bool TIMED, class PreGate>
__device__ __forceinline__ void ring_wavenet(const RingTile<S>& tile,
                                             Ring& ring,
                                             const PreGate& pre_gate,
                                             const RingWeights& w,
                                             PhaseClock<TIMED>& clock) {
  constexpr int C = S::C, C2 = S::C2, CH = S::CH, TT = S::TT, R = S::R;
  constexpr int HALO = S::HALO, PAD = S::PAD;
  const int tid = threadIdx.x, wg = tid / 128;
  // a thread's rows and column pairs of a product (ring_cols), the rows'
  // masks
  const int row0 = ring_row0(), col0 = ring_col0();
  const float m0 = tile.m[row0], m1 = tile.m[row0 + 8];
  act_t* const h = tile.h;
  act_t* const g = tile.g;
  const float* const m = tile.m;
  const uint32_t h_at = tile.base + S::H_OFF + ring_lane_at(2 * S::HP);
  const uint32_t g_at = tile.base + S::G_OFF + ring_lane_at(2 * S::GP);
  const uint32_t a_at = tile.base + S::S_OFF + ring_lane_at(2 * S::AP);

  // start 1x1 on x_a: h = (x_a . w_start + b_start) * m, all R rows
  float small[1][48];
  ring_gemm<S, REVERSE, MIXING, 1, S::S_START>(
      ring, true,
      [&](int s, int kk) { return a_at + 2 * (S::SK * s + 16 * kk); },
      small);
  {
    act_t* const h0 = h + (row0 + PAD) * S::HP + 96 * wg + col0;
    const float* const bias = w.b_start + 96 * wg + col0;
    ring_cols(small, [&](int k, float2 v, float2 u) {
      const float2 b = ldg2(bias + k);
      *reinterpret_cast<uint32_t*>(h0 + k) =
          tf32::pack_bf16((v.x + b.x) * m0, (v.y + b.y) * m0);
      *reinterpret_cast<uint32_t*>(h0 + 8 * S::HP + k) =
          tf32::pack_bf16((u.x + b.x) * m1, (u.y + b.y) * m1);
    });
  }
  __syncthreads();
  clock.mark(kStart);

#pragma unroll 1
  for (int i = 0; i < S::NL; ++i) {
    // k-tap conv: tile row r, tap d reads h's tile row r + d - PAD, the
    // buffer's row r + d; the epilogue is the pre-gate and the gate
    const auto pre = ring_layer(pre_gate, i, tile);
    float big[2][48];
    ring_gemm<S, REVERSE, MIXING, 2, S::S_IN>(
        ring, true,
        [&](int s, int kk) {
          return h_at + 2 * ((s / S::S_TAP) * S::HP +
                             S::SK * (s % S::S_TAP) + 16 * kk);
        },
        big);
    {
      // interleaved columns: 2c and 2c + 1 are channel c's tanh and sigmoid
      // halves, pre-gate columns c and CH + c; the thread's channels are
      // c0 + k / 2
      const int c0 = 96 * wg + col0 / 2;
      act_t* const g0 = g + row0 * S::GP + c0;
      ring_cols(big, [&](int k, float2 v, float2 u) {
        const int c = c0 + k / 2;
        g0[k / 2] = __float2bfloat16_rn(
            gate(pre(row0, c, v.x), pre(row0, CH + c, v.y)));
        g0[8 * S::GP + k / 2] = __float2bfloat16_rn(
            gate(pre(row0 + 8, c, u.x), pre(row0 + 8, CH + c, u.y)));
      });
    }
    __syncthreads();
    clock.mark(kLayer0 + 2 * i);
    // res half (warpgroup 0) updates h in place (this product reads only
    // the gate); skip half (warpgroup 1) sums on the owned rows.  The last
    // layer's res half is zero and warpgroup 0 computes nothing.
    const float* const b_rs = w.b_rs + i * S::CH2;
    const bool last = i == S::NL - 1;
    ring_gemm<S, REVERSE, MIXING, 2, S::S_RS>(
        ring, !(last && wg == 0),
        [&](int s, int kk) { return g_at + 2 * (S::SK * s + 16 * kk); },
        big);
    if (wg == 0) {
      if (!last) {
        act_t* const h0 = h + (row0 + PAD) * S::HP + col0;
        ring_cols(big, [&](int k, float2 v, float2 u) {
          const float2 b = ldg2(b_rs + col0 + k);
          uint32_t& p = *reinterpret_cast<uint32_t*>(h0 + k);
          uint32_t& q = *reinterpret_cast<uint32_t*>(h0 + 8 * S::HP + k);
          const uint32_t hp = p, hq = q;
          p = tf32::pack_bf16((tf32::bf16_lo(hp) + (v.x + b.x)) * m0,
                              (tf32::bf16_hi(hp) + (v.y + b.y)) * m0);
          q = tf32::pack_bf16((tf32::bf16_lo(hq) + (u.x + b.x)) * m1,
                              (tf32::bf16_hi(hq) + (u.y + b.y)) * m1);
        });
      }
    } else {
      // the skip sum of the thread's rows that are owned
      const bool own0 = row0 >= HALO && row0 < HALO + TT;
      const bool own1 = row0 + 8 >= HALO && row0 + 8 < HALO + TT;
      float* const s0 = tile.s + (row0 - HALO) * S::SP + col0;
      const bool first = i == 0;
      ring_cols(big, [&](int k, float2 v, float2 u) {
        const float2 b = ldg2(b_rs + CH + col0 + k);
        if (own0) {
          float2& a = *reinterpret_cast<float2*>(s0 + k);
          const float2 old = first ? make_float2(0.f, 0.f) : a;
          a = make_float2(old.x + (v.x + b.x), old.y + (v.y + b.y));
        }
        if (own1) {
          float2& a = *reinterpret_cast<float2*>(s0 + 8 * S::SP + k);
          const float2 old = first ? make_float2(0.f, 0.f) : a;
          a = make_float2(old.x + (u.x + b.x), old.y + (u.y + b.y));
        }
      });
    }
    __syncthreads();
    clock.mark(kLayer0 + 2 * i + 1);
  }

  // end 1x1 on the masked skip sum, rounded (the owned rows; rows TT.. 0)
  for (int i = tid; i < R * (CH / 2); i += kThreads) {
    const int r = i / (CH / 2), c = 2 * (i % (CH / 2));
    uint32_t u = 0;
    if (r < TT) {
      const float2 sv =
          *reinterpret_cast<const float2*>(tile.s + r * S::SP + c);
      u = tf32::pack_bf16(sv.x * m[HALO + r], sv.y * m[HALO + r]);
    }
    *reinterpret_cast<uint32_t*>(g + r * S::GP + c) = u;
  }
  __syncthreads();
  // [mean, logs] of the owned rows -> tile.s [TT, C]
  float halves[S::NWS][48];
  ring_gemm<S, REVERSE, MIXING, S::NWS, S::S_END>(
      ring, true,
      [&](int s, int kk) { return g_at + 2 * (S::SK * s + 16 * kk); },
      halves);
  {
    float* const st0 = tile.s + row0 * C + C2 * wg + col0;
    const float* const bias = w.b_end + C2 * wg + col0;
    ring_cols(halves, [&](int k, float2 v, float2 u) {
      if (ring_past<S>(k, col0)) return;
      const float2 b = ldg2(bias + k);
      if (row0 < TT)
        *reinterpret_cast<float2*>(st0 + k) = make_float2(v.x + b.x, v.y + b.y);
      if (row0 + 8 < TT)
        *reinterpret_cast<float2*>(st0 + 8 * C + k) =
            make_float2(u.x + b.x, u.y + b.y);
    });
  }
  __syncthreads();
  clock.mark(kEnd);
}

// The affine of one x_b value on its mean and logs and its frame's mask:
// forward (mean + exp(logs) x_b) m, reverse (x_b - mean) exp(-logs) m; one
// function each, so that a flow step and a coupling compute the same values.
__device__ __forceinline__ float ring_affine(float xb, float mean, float logs,
                                             float m) {
  return (mean + expf(logs) * xb) * m;
}
__device__ __forceinline__ float ring_unaffine(float xb, float mean,
                                               float logs, float m) {
  return (xb - mean) * expf(-logs) * m;
}

// The forward affine on the owned frames below T from ring_wavenet's mean
// and logs and x_b (tile.xb): z_b of frame t, rounded, at zb(t)[c]; returns
// in thread 0 the tile's sum of logs m over its owned rows, in a fixed
// order (a thread's cells, its warp's, the warps' in turn).
template <class S, class ZAt>
__device__ __forceinline__ float ring_affine_forward(const RingTile<S>& tile,
                                                     const ZAt& zb) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  const int tid = threadIdx.x;
  const float* const stats = tile.s;
  __shared__ float warp_sums[kWarps];
  float part = 0.f;
  for (int i = tid; i < TT * C2; i += kThreads) {
    const int r = i / C2, c = i % C2, row = HALO + r, t = tile.t0 + row;
    const float mr = tile.m[row];
    const float mean = stats[r * C + c], logs = stats[r * C + C2 + c];
    part += logs * mr;
    if (t < tile.T)
      zb(t)[c] = __float2bfloat16_rn(
          ring_affine(tile.xb[r * C2 + c], mean, logs, mr));
  }
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (tid % 32 == 0) warp_sums[tid / 32] = part;
  __syncthreads();
  float total = 0.f;
  if (tid == 0)
    for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
  return total;
}

// The deterministic flow step on one tile (flow_common.cuh::flow_step_tile
// in this body): forward ActNorm -> mixing -> coupling, returning in thread
// 0 the tile's logdet; REVERSE coupling^-1 -> mixing^-1 -> ActNorm^-1 with
// w.mix the inverse mixing's slices.  The ring's slices for the tile are
// issued on entry; ends on a barrier.
template <class S, bool REVERSE, bool TIMED, class PreGate>
__device__ __forceinline__ float ring_flow_step_tile(
    const RingTile<S>& tile, Ring& ring, const act_t* x, const float* mask,
    const PreGate& pre_gate, const RingWeights& w, const float* ld_const,
    act_t* z, PhaseClock<TIMED>& clock) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, R = S::R;
  constexpr int HALO = S::HALO;
  const int tid = threadIdx.x, wg = tid / 128;
  clock.begin();
  ring.begin<S, REVERSE, true>(w);
  // ActNorm's scale (exp(logs), reverse exp(-logs)) and shift a channel
  __shared__ __align__(16) float an_scale[C], an_shift[C];
  for (int c = tid; c < C; c += kThreads) {
    const float logs = __ldg(w.an_logs + c);
    an_scale[c] = expf(REVERSE ? -logs : logs);
    an_shift[c] = __ldg(w.an_bias + c);
  }
  ring_load_mask(tile, mask);
  // a thread's rows and column pairs of a product (ring_cols): their masks
  // as tile rows and as owned rows
  const int row0 = ring_row0(), col0 = ring_col0();
  const float m0 = tile.m[row0], m1 = tile.m[row0 + 8];
  const float mo0 = tile.m[HALO + row0], mo1 = tile.m[HALO + row0 + 8];
  act_t* const g = tile.g;
  act_t* const xa = tile.xa();
  const float* const m = tile.m;
  const uint32_t x_at = tile.base + S::G_OFF + ring_lane_at(2 * S::XP);

  ring_pad_xa(tile);
  ring_stage(pre_gate, tile);
  if constexpr (!REVERSE) {
    // the mixing's input: ActNorm, rounded, zero past C, 8 at a time, or 4
    // where a row is not whole 16-byte chunks (C = 100: XVEC; the loop of
    // every other width is the one its builds compiled before)
    if constexpr (S::XVEC == 8) {
      for (int i = tid; i < R * (S::KMIX / 8); i += kThreads) {
        const int r = i / (S::KMIX / 8), c = 8 * (i % (S::KMIX / 8));
        uint4 out = make_uint4(0, 0, 0, 0);
        if (c < C) {
          const uint4 in = ring_x8(tile, x, r, c);
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (an_shift[c + e] + an_scale[c + e] * bf_at(in, e)) * m[r];
          out = make_uint4(tf32::pack_bf16(v[0], v[1]),
                           tf32::pack_bf16(v[2], v[3]),
                           tf32::pack_bf16(v[4], v[5]),
                           tf32::pack_bf16(v[6], v[7]));
        }
        *reinterpret_cast<uint4*>(g + r * S::XP + c) = out;
      }
    } else {
      for (int i = tid; i < R * (S::KMIX / 4); i += kThreads) {
        const int r = i / (S::KMIX / 4), c = 4 * (i % (S::KMIX / 4));
        uint2 out = make_uint2(0, 0);
        if (c < C) {
          const uint2 in = ring_x<S, 4>(tile, x, r, c);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (an_shift[c + e] + an_scale[c + e] * bf_at(in, e)) * m[r];
          bf_pack(v, out);
        }
        *reinterpret_cast<uint2*>(g + r * S::XP + c) = out;
      }
    }
    __syncthreads();
    // [x_a, x_b] = y . mix_t * m: warpgroup 0 makes x_a (rounded; z's first
    // half), warpgroup 1 x_b (float32, the owned rows)
    float y[S::NWS][48];
    ring_gemm<S, REVERSE, true, S::NWS, S::S_MIX>(
        ring, true,
        [&](int s, int kk) { return x_at + 2 * (S::SK * s + 16 * kk); }, y);
    if (wg == 0) {
      act_t* const xa0 = xa + row0 * S::AP + col0;
      // z's rows of the thread's two rows, where they are owned frames
      auto z_row = [&](int r) -> act_t* {
        const int t = tile.t0 + r;
        return r >= HALO && r < HALO + TT && t < tile.T
                   ? z + (tile.sample + t) * C + col0 : nullptr;
      };
      act_t* const z0 = z_row(row0);
      act_t* const z1 = z_row(row0 + 8);
      ring_cols(y, [&](int k, float2 v, float2 u) {
        if (ring_past<S>(k, col0)) return;
        const uint32_t p = tf32::pack_bf16(v.x * m0, v.y * m0);
        const uint32_t q = tf32::pack_bf16(u.x * m1, u.y * m1);
        *reinterpret_cast<uint32_t*>(xa0 + k) = p;
        *reinterpret_cast<uint32_t*>(xa0 + 8 * S::AP + k) = q;
        if (z0) *reinterpret_cast<uint32_t*>(z0 + k) = p;
        if (z1) *reinterpret_cast<uint32_t*>(z1 + k) = q;
      });
    } else {
      // x_b of the thread's rows that are owned
      const bool own0 = row0 >= HALO && row0 < HALO + TT;
      const bool own1 = row0 + 8 >= HALO && row0 + 8 < HALO + TT;
      float* const xb0 = tile.xb + (row0 - HALO) * C2 + col0;
      ring_cols(y, [&](int k, float2 v, float2 u) {
        if (ring_past<S>(k, col0)) return;
        if (own0)
          *reinterpret_cast<float2*>(xb0 + k) = make_float2(v.x * m0, v.y * m0);
        if (own1)
          *reinterpret_cast<float2*>(xb0 + 8 * C2 + k) =
              make_float2(u.x * m1, u.y * m1);
      });
    }
  } else {
    // x_a (all rows, rounded as it is) and x_b (the owned rows), V at a
    // time
    constexpr int V = S::VEC;
    using Vec = typename BfVec<V>::T;
    for (int i = tid; i < R * (C2 / V); i += kThreads) {
      const int r = i / (C2 / V), c = V * (i % (C2 / V));
      *reinterpret_cast<Vec*>(xa + r * S::AP + c) =
          ring_x<S, V>(tile, x, r, c);
    }
    for (int i = tid; i < TT * (C2 / V); i += kThreads) {
      const int r = i / (C2 / V), c = V * (i % (C2 / V));
      const Vec in = ring_x<S, V>(tile, x, HALO + r, C2 + c);
#pragma unroll
      for (int e = 0; e < V; ++e) tile.xb[r * C2 + c + e] = bf_at(in, e);
    }
  }
  __syncthreads();
  clock.mark(kLoad);

  ring_wavenet<S, REVERSE, true>(tile, ring, pre_gate, w, clock);

  float logdet = 0.f;
  if constexpr (!REVERSE) {
    // z_b = (mean + exp(logs) x_b) m on the owned frames below T; the
    // logdet adds ld_const a valid frame to the tile's sum of logs m
    const float total = ring_affine_forward(
        tile, [&](int t) { return z + (tile.sample + t) * C + C2; });
    if (tid == 0) {
      float frames = 0.f;
      for (int r = 0; r < TT; ++r) frames += m[HALO + r];
      logdet = total + __ldg(ld_const) * frames;
    }
  } else {
    // the inverse mixing's input [x_a, (x_b - mean) exp(-logs) m], rounded,
    // on the owned rows (rows TT.. and the depth past C zero); x_a read
    // again where it lies (no item writes those rows of x before this one
    // is done: flow_stack.cu)
    // (V at a time: a chunk lies within x_a or x_b)
    const float* const stats = tile.s;
    constexpr int V = S::VEC;
    using Vec = typename BfVec<V>::T;
    for (int i = tid; i < R * (S::KMIX / V); i += kThreads) {
      const int r = i / (S::KMIX / V), c = V * (i % (S::KMIX / V));
      Vec out{};
      if (r < TT && c < C2) {
        out = ring_x<S, V>(tile, x, HALO + r, c);
      } else if (r < TT && c < C) {
        const float mr = m[HALO + r];
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int k = c - C2 + e;
          v[e] = ring_unaffine(tile.xb[r * C2 + k], stats[r * C + k],
                               stats[r * C + C2 + k], mr);
        }
        bf_pack(v, out);
      }
      *reinterpret_cast<Vec*>(g + r * S::XP + c) = out;
    }
    __syncthreads();
    // mixing^-1 then ActNorm^-1 into z, the owned frames below T
    float small[S::NWS][48];
    ring_gemm<S, REVERSE, true, S::NWS, S::S_MIX>(
        ring, true,
        [&](int s, int kk) { return x_at + 2 * (S::SK * s + 16 * kk); },
        small);
    // z's rows of the thread's two rows, where they are owned frames below
    // T; the ActNorm of its columns C2 wg + col0 + k
    auto z_row = [&](int r) -> act_t* {
      const int t = tile.t0 + HALO + r;
      return r < TT && t < tile.T
                 ? z + (tile.sample + t) * C + C2 * wg + col0 : nullptr;
    };
    act_t* const z0 = z_row(row0);
    act_t* const z1 = z_row(row0 + 8);
    const float* const scale = an_scale + C2 * wg + col0;
    const float* const shift = an_shift + C2 * wg + col0;
    ring_cols(small, [&](int k, float2 v, float2 u) {
      if (ring_past<S>(k, col0)) return;
      const float2 a = *reinterpret_cast<const float2*>(scale + k);
      const float2 b = *reinterpret_cast<const float2*>(shift + k);
      if (z0)
        *reinterpret_cast<uint32_t*>(z0 + k) =
            tf32::pack_bf16((v.x * mo0 - b.x) * a.x * mo0,
                            (v.y * mo0 - b.y) * a.y * mo0);
      if (z1)
        *reinterpret_cast<uint32_t*>(z1 + k) =
            tf32::pack_bf16((u.x * mo1 - b.x) * a.x * mo1,
                            (u.y * mo1 - b.y) * a.y * mo1);
    });
  }
  __syncthreads();
  clock.mark(kStore);
  return logdet;
}

// The affine coupling alone on one tile (coupling.cu's bfloat16 build): the
// flow step's program without the mixing's slices, ActNorm or the mixing.
// x_a (all R rows) and x_b (the owned rows) are read where they lie through
// strides of their own (Rows: data, batch_stride, row_stride; the caller's
// halves of one [B, T, C] tensor), and z_b [B*T, C2] written on the owned
// frames below T: forward z_b = (mean + exp(logs) x_b) m, returning in
// thread 0 the tile's sum of logs m (ring_flow_step_tile's logdet before
// its per-frame constant); reverse z_b = (x_b - mean) exp(-logs) m.  The
// ring's slices for the tile are issued on entry; ends on a barrier.
template <class S, bool REVERSE, bool TIMED, class Rows, class PreGate>
__device__ __forceinline__ float ring_coupling_tile(
    const RingTile<S>& tile, Ring& ring, const Rows& x_a, const Rows& x_b,
    const float* mask, const PreGate& pre_gate, const RingWeights& w,
    act_t* z_b, PhaseClock<TIMED>& clock) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, R = S::R, HALO = S::HALO;
  const int tid = threadIdx.x;
  clock.begin();
  ring.begin<S, REVERSE, false>(w);
  ring_load_mask(tile, mask);
  ring_pad_xa(tile);
  ring_stage(pre_gate, tile);
  // x_a (all rows, as it is) and x_b (the owned rows), V at a time
  constexpr int V = S::VEC;
  using Vec = typename BfVec<V>::T;
  act_t* const xa = tile.xa();
  for (int i = tid; i < R * (C2 / V); i += kThreads) {
    const int r = i / (C2 / V), c = V * (i % (C2 / V));
    *reinterpret_cast<Vec*>(xa + r * S::AP + c) =
        ring_rows<S, V>(tile, x_a, r, c);
  }
  for (int i = tid; i < TT * (C2 / V); i += kThreads) {
    const int r = i / (C2 / V), c = V * (i % (C2 / V));
    const Vec in = ring_rows<S, V>(tile, x_b, HALO + r, c);
#pragma unroll
    for (int e = 0; e < V; ++e) tile.xb[r * C2 + c + e] = bf_at(in, e);
  }
  __syncthreads();
  clock.mark(kLoad);

  ring_wavenet<S, REVERSE, false>(tile, ring, pre_gate, w, clock);

  float logdet = 0.f;
  if constexpr (!REVERSE) {
    logdet = ring_affine_forward(
        tile, [&](int t) { return z_b + (tile.sample + t) * C2; });
  } else {
    const float* const stats = tile.s;
    for (int i = tid; i < TT * C2; i += kThreads) {
      const int r = i / C2, c = i % C2, row = HALO + r, t = tile.t0 + row;
      if (t < tile.T)
        z_b[(tile.sample + t) * C2 + c] = __float2bfloat16_rn(
            ring_unaffine(tile.xb[r * C2 + c], stats[r * C + c],
                          stats[r * C + C2 + c], tile.m[row]));
    }
  }
  __syncthreads();
  clock.mark(kStore);
  return logdet;
}

// A block's ring and buffers: the dynamic shared memory aligned to 1024
// bytes, the mbarriers initialised and the release counts zeroed, h's
// border rows zeroed (no product writes them).  Ends on a barrier.
template <class S>
__device__ __forceinline__ char* ring_block(float4* smem, Ring& ring) {
  __shared__ __align__(8) unsigned long long bars[kRingStages];
  __shared__ unsigned counts[kRingStages];
  // aligned by an offset from the shared array itself, so that the
  // compiler keeps every access through it a shared-memory one
  const uint32_t at = bf16mma::smem_u32(smem);
  char* const aligned =
      reinterpret_cast<char*>(smem) + (((at + 1023u) & ~1023u) - at);
  ring.slots = bf16mma::smem_u32(aligned) + S::RING;
  ring.bars = bf16mma::smem_u32(bars);
  ring.counts = counts;
  ring.q = 0;
  ring.end = 0;
  ring.w = nullptr;
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < kRingStages; ++slot) {
      mbar_init(ring.full(slot), 1);
      counts[slot] = 0;
    }
    mbar_fence_init();
  }
  act_t* const h = reinterpret_cast<act_t*>(aligned + S::H_OFF);
  for (int i = threadIdx.x; i < 2 * S::PAD * (S::HP / 2); i += kThreads) {
    const int r = i / (S::HP / 2), c = 2 * (i % (S::HP / 2));
    const int row = r < S::PAD ? r : S::R + r;
    *reinterpret_cast<uint32_t*>(h + row * S::HP + c) = 0u;
  }
  __syncthreads();
  return aligned;
}

}  // namespace
