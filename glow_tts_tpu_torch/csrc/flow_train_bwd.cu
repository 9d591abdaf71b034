// Backward of one train-direction flow step of the Glow-TTS decoder,
// float32: from the cotangent of the step's output to the cotangent of its
// input and the gradients of all of the step's weights.
//
// Replaces glow_tts_tpu/ops/coupling_grad.py::_make_train_bwd_kernel (the
// Pallas kernel behind _bwd_call, the custom_vjp of
// fused_flow_stack_train), phases 2-4.  Phase 1 there is a recompute of the
// step from its checkpoint; here the activations come from
// flow_train_fwd.cu, which either stored them during the forward pass or
// recomputes them step by step (the caller decides by their size).  The
// plain PyTorch version is autograd of
// glow_tts_tpu_torch/ops/coupling_grad.py::flow_stack_train_reference.
//
// What bounds it: arithmetic.  The activation gradients (dgrad) and the
// weight gradients (wgrad) each repeat the forward's 3.6 MFLOP per valid
// frame, while a step's activations (190 MB at 32 x 512 frames) cross
// device memory about once: by operations it is far above the card's
// 3.35 TB/s line, so the GEMMs go to the tensor cores.
//
// Design.  The TPU kernel keeps a batch block's whole step in on-chip
// memory and emits per-block weight gradients.  On this card gradients
// flow 8 frames each way through the 4 k=5 layers, so a time-tiled block
// would need a 16-frame halo and four saved layer inputs beside it (more
// than 227 KB).  So the step is a fixed sequence of 22 launches on one
// stream over activations in device memory:
// * dgrad tiles (gemm_nt_tile): out[frame, n] = sum over taps and k of
//   A[frame + pad - tap, k] . W[tap][n, k], one block per (sample, 128
//   frames, 96 columns), with an epilogue per product: masks, the gate's
//   backward with the regenerated dropout factors, ActNorm's backward;
// * wgrad tiles (gemm_tn_tile): dW[kd, n] = sum over frames of P[frame +
//   tap - pad, kd] . G[frame, n], one block per (96 x 128 tile of dW, chunk
//   of whole samples); each chunk writes its own partial;
// * gemm_pair: where a dgrad and a wgrad product do not depend on each
//   other (the k-tap conv's, the end conv's, the start conv's, the
//   mixing's) they are one launch, dgrad tiles first: the ragged batch
//   leaves about as many live dgrad tiles as the card has SMs, one round
//   and a few, and the wgrad tiles take the SMs that would idle;
// * column_sums: per-sample column sums (bias gradients, dcond, ActNorm),
//   up to four tensors a launch;
// * reduce_partials: once a step, every partial of the chunks and of the
//   samples added in its order into the step's gradient tensors.
// Both GEMMs run on the tensor cores (mma.sync.m16n8k8, TF32 operands,
// float32 accumulation; tf32_mma.cuh) as the error-compensated 3xTF32
// product, which keeps float32 accuracy at a third of the TF32 rate; a
// single pass is kept as a measuring option.  Operands reach shared memory
// through a 4-deep cp.async ring of 32-deep slices with one barrier a
// slice; the k-tap conv's shifted rows are shifted tile loads, zero-filled
// outside the sample.  wgrad contracts over frames, so both its operands
// lie depth-major in memory: mma.sync reads fragments by address from
// shared memory, and nothing is transposed.  A block keeps two sets of
// accumulators (the tensor cores' and a float32 sum of them, see
// tf32_mma.cuh), 170-180 registers a thread: one block of 8 warps per SM.
// Valid frames only: every gradient operand is zero past a sample's last
// valid frame (each is produced under the mask), so a dgrad block wholly
// past it skips its k-loop and stores the epilogue of zeros, a warp past it
// skips its products, and a wgrad chunk walks only its samples' valid rows.
// No value changes: the skipped terms are x . 0.
// No atomics: every frame is counted once, chunks and partials are added in
// a fixed order, so two runs give the same bits.
// GR mode's pitch operand is a build of its own (GLOW_PITCH), so the
// Vanilla kernels do not change.  It adds one launch per layer
// (pitch_backward) on dacc, the pre-gate gradient after the dropout, where
// the forward added the pitch term: dw_pitch[i] = pitch^T . dacc as
// per-sample partials (a [PS, 2CH] reduction over the valid frames, added
// by reduce_partials in the samples' order), and, when the pitch operand's
// gradient is wanted, dpitch += dacc . w_pitch[i]^T, a warp per frame
// (depth 2CH, a butterfly in a fixed order), layer after layer in launch
// order: still no atomics.
// A GLOW_BF16 build is the backward of flow_train_fwd.cu's GLOW_BF16 build,
// what the TPU kernel computes at dt = bfloat16: it reads the bfloat16 values
// that forward stored (act_t: the step's input, y, yd, the layers' inputs,
// the gate halves, the skip sum, logs) and writes the gate it recomputes in
// bfloat16; every GEMM runs on bfloat16 operands, as the TPU kernel casts
// each dot's operands (the cotangents too) to dt; sums, gradients and the
// elementwise backward stay float32.  What bounds it at bf16: the same 2 x
// 3.6 MFLOP a valid frame at the 989 TFLOP/s bf16 peak, about 0.06 ms a
// flow step at the training shape, against 0.04 ms of bytes; what held the
// first bf16 build at 1/33 of that was the operand path, not the tensor
// cores (threads widening each bf16 operand into a float32 ring, fragments
// read one element at a time and packed by cvt, every cotangent re-rounded
// by every tile that read it).  The design does about it:
// * every cotangent a product reads (douts, drs, dpre, dyd) is written in
//   bfloat16 by the epilogue that makes it (round to nearest even, the
//   value the TPU kernel's .astype(dt) gives), beside the float32 value the
//   column sums and the elementwise backward read; the weights arrive in
//   bfloat16 (ops/coupling_grad.py::backward_weights_bf16);
// * tiles go to shared memory as they lie in device memory, 16 bytes a
//   cp.async, zero-filled at the edges: half the bytes of the float32 ring,
//   no thread work;
// * the activation gradients (dgrad, the larger half) run on wgmma
//   (m64n96k16, two warpgroups a 128 x 96 tile, both operands K-major in
//   the 128-byte swizzle through matrix descriptors, bf16_mma.cuh): the
//   k-tap conv's shift is applied where a slice is loaded, so every staged
//   tile starts on a swizzle atom;
// * the weight gradients (wgrad) run on mma.sync.m16n8k16 fed by
//   ldmatrix.trans: both operands are frame-major, their tile is 96 rows
//   (one tap's channels) and a chunk walks 32-frame slices of whole samples,
//   so a wgmma version would need the transposed (MN-major) swizzle atoms
//   and a 128-row re-tiling; this build keeps the f32 design's chunks and
//   tiles and reads every fragment with one ldmatrix per 16 x 16 block;
// * two blocks an SM (at most 128 registers a thread; the dgrad ring 3
//   slices deep, 85 KB): 12 % off a flow step against one block with a
//   4-deep ring (PERF.md);
// * the epilogues whose rows past a sample's length no launch reads
//   (GateBackward, MaskedStore: the products zero-fill those rows, the
//   column sums stop at the length) store none there; ActNormBackward's
//   dx is the caller's gradient and is written at every frame.
// Kept from the float32 design: live tiles only, the dgrad/wgrad pairs in
// one launch, per-chunk partials added in a fixed order (no atomics), the
// pitch build's pitch_backward.  Its products accumulate in the tensor
// cores alone over the whole depth, one instantiation each (passes 1;
// PASSES and TAIL are the float32 builds': the depth predicate of the
// staging zero-fills any tail).  The TPU kernel's bfloat16 weight-gradient
// partials of w_in and w_rs (its VMEM is scarce) have no counterpart: the
// partials here are float32.

#include <cuda_runtime.h>

#include <cstddef>

#ifdef GLOW_BF16
#include <cuda_bf16.h>
#endif

#include "dropmask.cuh"
#include "tf32_mma.cuh"
#ifdef GLOW_BF16
#include "bf16_mma.cuh"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;   // depth of the cp.async ring
constexpr int BK = 32;       // depth of a staged slice

// The decoder shape of this build, as for flow_common.cuh: the flow's
// channel count C (the shipped config's 160 unless the build defines
// another: -DGLOW_CHANNELS=80 for MiniSpeech's Num_Squeeze 1, 200 for
// 100-bin mels) and the WaveNet's ch, layers and taps (192, 4, 5 unless
// defined; ops/coupling.py::build_defines).  The products are sized at run
// time from the entry's arguments, which must be these.  What the shape
// changes in the device code: the depth of the activation-gradient
// products is C (the end conv's and the mixing's), ch (the start conv's)
// or 2ch (the res/skip and k-tap convs'); where one of them is not a
// multiple of a slice, the build has the float32 instantiations that
// zero-fill a slice past the depth (TAIL), so the builds whose depths all
// are (160 channels at the shipped WaveNet) keep the kernels they had.
#ifndef GLOW_CHANNELS
#define GLOW_CHANNELS 160
#endif
#ifndef GLOW_CH
#define GLOW_CH 192
#endif
#ifndef GLOW_LAYERS
#define GLOW_LAYERS 4
#endif
#ifndef GLOW_KSIZE
#define GLOW_KSIZE 5
#endif
constexpr int kChannels = GLOW_CHANNELS;
constexpr bool kDepthTail = kChannels % BK != 0 || GLOW_CH % BK != 0;
// The TF32 passes of the float32 builds' measuring instantiations (one
// pass): 1 in the builds of the shipped shapes (160 and 80 channels at the
// shipped WaveNet), which keep them; every other shape's build compiles the
// shipped 3 passes alone, in half the time, and its entries refuse 1.
constexpr bool kShippedShape = GLOW_CH == 192 && GLOW_LAYERS == 4 &&
                               GLOW_KSIZE == 5 &&
                               (kChannels == 160 || kChannels == 80);
constexpr int kOnePass = kShippedShape ? 1 : 3;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float act_f(float v) { return v; }

// The type of the activations the forward pass stored: float, or bfloat16
// in a GLOW_BF16 build.
#ifdef GLOW_BF16
constexpr bool kBf16 = true;
using act_t = __nv_bfloat16;
__device__ __forceinline__ float act_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(tf32::bf16_lo(u), tf32::bf16_hi(u));
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = tf32::pack_bf16(a, b);
}
#else
constexpr bool kBf16 = false;
using act_t = float;
#endif
// blocks of the GEMM kernels resident on an SM: a GLOW_BF16 build's fit two
// (at most 128 registers a thread, 85 KB of shared memory a block)
constexpr int kMinBlocks = kBf16 ? 2 : 1;

#ifdef GLOW_BF16
// A GLOW_BF16 build stages its operands' rows 16 bytes (8 elements) a
// cp.async, as they lie.  Where a row of C elements is not whole 16-byte
// chunks (C = 4 mod 8, as at C = 100: the C-wide cotangents douts and dyd,
// y, yd, mix_t and w_end), a build stages every chunk as two 8-byte halves
// instead, each zero-filled where its own first element lies at or past
// the depth or width `end` (a half's row of C/2 = 50 is then whole 4-element
// halves; a half at 48 .. 51 reads yd's columns 50 and 51, which reach only
// rows of a weight gradient past its depth, never stored).
constexpr bool kHalfChunks = kChannels % 8 != 0;

// Elements k .. k + 7 of the bf16 row at `row` into smem as two 8-byte
// halves: half h where row_ok and k + 4 h < end, else zeros (`any`: an
// address inside the tensor).
__device__ __forceinline__ void stage_halves(uint32_t smem, const act_t* row,
                                             int k, bool row_ok, int end,
                                             const act_t* any) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row_ok && k + 4 * h < end;
    bf16mma::cp_async8(smem + 8 * h, ok ? row + k + 4 * h : any, ok);
  }
}
#endif

// ---------------------------------------------------------------------------
// activation gradients
// ---------------------------------------------------------------------------

// dgrad tile: 128 frames x 96 columns; warps 4 x 2, each 32 x 48.  Rows of
// both operands are k-contiguous and padded to 36 floats, so a fragment
// read (8 rows x 4 depths) touches 32 banks.
constexpr int NT_BM = 128, NT_BN = 96, NT_LD = BK + 4;
constexpr int NT_WM = 32, NT_WN = 48;
#ifdef GLOW_BF16
// A GLOW_BF16 build's dgrad tile: the same 128 x 96, two warpgroups of 64
// frames each over all 96 columns (wgmma m64n96k16), slices 64 deep: one
// 128-byte row a frame or a column in the 128-byte swizzle (bf16_mma.cuh),
// 28 KB a stage; 1 KB more to align the ring to 1024 bytes.
constexpr int NT_BK = 64, NT_STAGES = 3;
constexpr int NT_A_BYTES = NT_BM * 128, NT_W_BYTES = NT_BN * 128;
constexpr size_t kNtSmem = NT_STAGES * (NT_A_BYTES + NT_W_BYTES) + 1024;
static_assert(NT_BM == 2 * 64 && kThreads == 2 * 128, "two warpgroups");
#else
constexpr size_t kNtSmem =
    sizeof(float) * kStages * (NT_BM + NT_BN) * NT_LD;
static_assert((NT_BM / NT_WM) * (NT_BN / NT_WN) == kThreads / 32, "warps");
#endif

// out[b*T + t, n] = sum_tap sum_k A[b*T + t + pad - tap, k] * W[tap][n, k]:
// a shifted frame outside [0, lengths[b]) is zero.  A has row stride lda and
// kseg columns, W[tap] is [N, kseg] with row stride ldw and the taps
// tap_stride apart.  kseg % 32 == 0 (kseg % 4 == 0 with TAIL); N % 2 == 0;
// lda, ldw % 4 == 0.  In a GLOW_BF16 build A and W are bfloat16 and kseg,
// lda, ldw % 8 == 0, or % 4 in a kHalfChunks build (any depth: the slice
// past kseg is zero-filled).
struct NtArgs {
  const act_t* a;
  const act_t* w;
  int lda, ldw, kseg, taps, pad, tap_stride;
  int N, T;
  const int* lengths;   // [B] one past the last valid frame of each sample
};

#ifdef GLOW_BF16
// The tile (column tile bx, frame tile by, sample b) of the product, on
// wgmma: both operands K-major in the 128-byte swizzle, every frame and
// column a 128-byte row of a 64-deep slice staged by cp.async as it lies in
// device memory, zero-filled outside the sample, past N and past kseg (so
// one instantiation takes every depth: PASSES and TAIL are the float32
// builds').  The k-tap conv's shifted rows are shifted tile loads, so each
// staged tile starts on a swizzle atom.  Warpgroup w owns frames [64 w,
// 64 w + 64) and skips its products when they lie past the sample's length;
// its accumulators take the whole depth.  One wgmma group is in flight at a
// time: it is waited for before the barrier after which its slot is staged
// again.
template <int PASSES, bool TAIL, class Epilogue>
__device__ __forceinline__ void gemm_nt_tile(const NtArgs& g,
                                             const Epilogue& epilogue, int bx,
                                             int by, int b, float* smem) {
  using namespace bf16mma;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t a_ring = base, w_ring = base + NT_STAGES * NT_A_BYTES;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = tid % 128 / 32;
  const int n0 = bx * NT_BN, t0 = by * NT_BM;
  const int len = g.lengths[b];
  const size_t sample = static_cast<size_t>(b) * g.T;
  float acc[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.f;

  const int kslices = (g.kseg + NT_BK - 1) / NT_BK;
  // a tile wholly past the sample's valid frames has an all-zero product
  const int n_it = t0 < len ? g.taps * kslices : 0;
  const bool wg_live = t0 + wg * 64 < len;

  auto stage = [&](int it) {
    const int tap = it / kslices, k0 = (it % kslices) * NT_BK;
    const int shift = g.pad - tap;
    const uint32_t as = a_ring + (it % NT_STAGES) * NT_A_BYTES;
    const uint32_t ws = w_ring + (it % NT_STAGES) * NT_W_BYTES;
    for (int i = tid; i < NT_BM * 8; i += kThreads) {
      const int m = i / 8, c = i % 8, k = k0 + 8 * c;
      const int t = t0 + m + shift;
      if constexpr (kHalfChunks) {
        stage_halves(as + sw128(m, c), g.a + (sample + t) * g.lda, k,
                     t >= 0 && t < len, g.kseg, g.a);
      } else {
        const bool ok = t >= 0 && t < len && k < g.kseg;
        cp_async16(as + sw128(m, c),
                   ok ? g.a + (sample + t) * g.lda + k : g.a, ok);
      }
    }
    const act_t* w_tap = g.w + static_cast<size_t>(tap) * g.tap_stride;
    for (int i = tid; i < NT_BN * 8; i += kThreads) {
      const int n = i / 8, c = i % 8, k = k0 + 8 * c;
      if constexpr (kHalfChunks) {
        stage_halves(ws + sw128(n, c),
                     w_tap + static_cast<size_t>(n0 + n) * g.ldw, k,
                     n0 + n < g.N, g.kseg, w_tap);
      } else {
        const bool ok = n0 + n < g.N && k < g.kseg;
        cp_async16(ws + sw128(n, c),
                   ok ? w_tap + static_cast<size_t>(n0 + n) * g.ldw + k
                      : w_tap,
                   ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NT_STAGES - 1; ++s) {
    if (s < n_it) stage(s);
    tf32::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    tf32::cp_async_wait<NT_STAGES - 2>();   // slice `it` has landed
    fence_proxy_async();                  // for wgmma's reads
    __syncthreads();                      // and every wgmma of it-1 is done
    if (it + NT_STAGES - 1 < n_it) stage(it + NT_STAGES - 1);
    tf32::cp_async_commit();
    if (!wg_live) continue;
    const uint32_t as = a_ring + (it % NT_STAGES) * NT_A_BYTES + wg * 64 * 128;
    const uint32_t ws = w_ring + (it % NT_STAGES) * NT_W_BYTES;
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < NT_BK / 16; ++kk)
      wgmma_m64n96k16(acc, sw128_desc(as + 32 * kk), sw128_desc(ws + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
  }
  tf32::cp_async_wait<0>();

  // an epilogue whose rows past the sample's length no launch reads stores
  // none there (a tile wholly past it does nothing)
  const int rows = Epilogue::kValidRowsOnly ? len : g.T;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + wg * 64 + warp * 16 + gq + 8 * half;
    if (t >= rows) continue;
#pragma unroll
    for (int j = 0; j < NT_BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col < g.N)
        epilogue(static_cast<int>(sample) + t, col, acc[4 * j + 2 * half],
                 acc[4 * j + 2 * half + 1]);
    }
  }
}
#else
// The tile (column tile bx, frame tile by, sample b) of the product.  With
// TAIL the last slice of each tap may reach past kseg, and is zero there.
template <int PASSES, bool TAIL, class Epilogue>
__device__ __forceinline__ void gemm_nt_tile(const NtArgs& g,
                                             const Epilogue& epilogue, int bx,
                                             int by, int b, float* smem) {
  float* const a_ring = smem;
  float* const w_ring = a_ring + kStages * NT_BM * NT_LD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int n0 = bx * NT_BN, t0 = by * NT_BM;
  const int len = g.lengths[b];
  const size_t sample = static_cast<size_t>(b) * g.T;
  float acc[NT_WM / 16][NT_WN / 8][4] = {};   // of the slice in hand
  float sum[NT_WM / 16][NT_WN / 8][4] = {};   // of the slices before it

  const int kslices = TAIL ? (g.kseg + BK - 1) / BK : g.kseg / BK;
  // a tile wholly past the sample's valid frames has an all-zero product
  const int n_it = t0 < len ? g.taps * kslices : 0;
  const bool warp_live = t0 + wm * NT_WM < len;

  auto stage = [&](int it) {
    const int tap = it / kslices, k0 = (it % kslices) * BK;
    const int shift = g.pad - tap;
    float* as = a_ring + (it % kStages) * NT_BM * NT_LD;
    float* ws = w_ring + (it % kStages) * NT_BN * NT_LD;
    for (int i = tid; i < NT_BM * (BK / 4); i += kThreads) {
      const int m = i / (BK / 4), q = 4 * (i % (BK / 4));
      const int t = t0 + m + shift;
      const bool ok = t >= 0 && t < len && (!TAIL || k0 + q < g.kseg);
      // (a slice past the depth reads nothing: any address will do)
      tf32::cp_async16_zfill(
          as + m * NT_LD + q,
          TAIL && !ok ? g.a : g.a + (sample + (ok ? t : 0)) * g.lda + k0 + q,
          ok);
    }
    const float* w_tap = g.w + static_cast<size_t>(tap) * g.tap_stride;
    for (int i = tid; i < NT_BN * (BK / 4); i += kThreads) {
      const int n = i / (BK / 4), q = 4 * (i % (BK / 4));
      const bool ok = n0 + n < g.N && (!TAIL || k0 + q < g.kseg);
      tf32::cp_async16_zfill(
          ws + n * NT_LD + q,
          TAIL && !ok ? w_tap
                      : w_tap + static_cast<size_t>(ok ? n0 + n : 0) * g.ldw +
                            k0 + q,
          ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_it) stage(s);
    tf32::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    tf32::cp_async_wait<kStages - 2>();   // slice `it` has landed
    __syncthreads();                      // and every warp is done with it-1
    if (it + kStages - 1 < n_it) stage(it + kStages - 1);
    tf32::cp_async_commit();
    if (!warp_live) continue;
    const float* as =
        a_ring + (it % kStages) * NT_BM * NT_LD + wm * NT_WM * NT_LD;
    const float* ws =
        w_ring + (it % kStages) * NT_BN * NT_LD + wn * NT_WN * NT_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8)
      tf32::warp_step<NT_WM / 16, NT_WN / 8, PASSES>(
          acc, [&](int i, int k) { return as[i * NT_LD + kk + k]; },
          [&](int k, int j) { return ws[j * NT_LD + kk + k]; });
    tf32::flush(acc, sum);
  }
  tf32::cp_async_wait<0>();

  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < NT_WM / 16; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + wm * NT_WM + 16 * mt + gq + 8 * half;
      if (t >= g.T) continue;
#pragma unroll
      for (int nt = 0; nt < NT_WN / 8; ++nt) {
        const int col = n0 + wn * NT_WN + 8 * nt + 2 * tq;
        if (col < g.N)
          epilogue(static_cast<int>(sample) + t, col, sum[mt][nt][2 * half],
                   sum[mt][nt][2 * half + 1]);
      }
    }
}

#endif

template <int PASSES, class Epilogue>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gemm_nt(const NtArgs g, const Epilogue epilogue) {
  extern __shared__ float4 smem4[];
  gemm_nt_tile<PASSES, false>(g, epilogue, blockIdx.x, blockIdx.y,
                              blockIdx.z, reinterpret_cast<float*>(smem4));
}

// gemm_nt over a depth that is not a multiple of a slice (kDepthTail builds)
template <int PASSES, class Epilogue>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gemm_nt_tail(const NtArgs g, const Epilogue epilogue) {
  extern __shared__ float4 smem4[];
  gemm_nt_tile<PASSES, true>(g, epilogue, blockIdx.x, blockIdx.y, blockIdx.z,
                             reinterpret_cast<float*>(smem4));
}

// out[row, col..col+1] = (v + add[row, col..]) * mask[row]; add may be out
// itself (each element is read and written by one thread) or null.  In a
// GLOW_BF16 build out_bf (or null) gets the same values rounded to
// bfloat16, the operand of the products that read them, and out may be
// null.
struct MaskedStore {
  float* out;
  const float* add;
  const float* mask;
  int ld_out, ld_add;
#ifdef GLOW_BF16
  act_t* out_bf;
  // what it writes past a sample's length is never read: the products
  // zero-fill those rows, the column sums stop at the length
  static constexpr bool kValidRowsOnly = true;
#endif
  __device__ void operator()(int row, int col, float v0, float v1) const {
    if (add) {
      const float2 a = ld2(add + static_cast<size_t>(row) * ld_add + col);
      v0 += a.x;
      v1 += a.y;
    }
    const float m = mask[row];
#ifdef GLOW_BF16
    const size_t at = static_cast<size_t>(row) * ld_out + col;
    if (out) st2(out + at, v0 * m, v1 * m);
    if (out_bf) st2(out_bf + at, v0 * m, v1 * m);
#else
    st2(out + static_cast<size_t>(row) * ld_out + col, v0 * m, v1 * m);
#endif
  }
};

// The gate's backward on dg = d(tanh . sigmoid): dacc = [dg s (1 - t^2),
// dg t s (1 - s)] (the conditioning's gradient), dpre = dacc * dropout
// factor (the conv + bias gradient); and the gate t s itself, the res/skip
// weight gradient's operand.
struct GateBackward {
  const act_t* ts;   // [M, 2CH] tanh half, sigmoid half
  float* dpre;       // [M, 2CH]
  float* dacc;       // [M, 2CH] or null
  act_t* gate;       // [M, CH]
  int ch, T;
  unsigned rows_per_sample, salt;
  dropmask::Dropout drop;
#ifdef GLOW_BF16
  act_t* dpre_bf;    // [M, 2CH] dpre rounded to bfloat16
  static constexpr bool kValidRowsOnly = true;   // as MaskedStore's
#endif
  __device__ void operator()(int row, int col, float dg0, float dg1) const {
    const size_t base = static_cast<size_t>(row) * 2 * ch;
    const float2 t2 = ld2(ts + base + col), s2 = ld2(ts + base + ch + col);
    const float dg[2] = {dg0, dg1};
    const float t[2] = {t2.x, t2.y};
    const float s[2] = {s2.x, s2.y};
    float da1[2], da2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      da1[e] = dg[e] * s[e] * (1.f - t[e] * t[e]);
      da2[e] = dg[e] * t[e] * s[e] * (1.f - s[e]);
    }
    st2(gate + static_cast<size_t>(row) * ch + col, t[0] * s[0], t[1] * s[1]);
    if (dacc) {
      st2(dacc + base + col, da1[0], da1[1]);
      st2(dacc + base + ch + col, da2[0], da2[1]);
    }
    if (drop.enabled) {
      const unsigned counter = dropmask::row_counter(
          row / T, row % T, rows_per_sample, 2 * ch, salt) + col;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        da1[e] *= dropmask::keep_factor(drop, counter + e);
        da2[e] *= dropmask::keep_factor(drop, counter + ch + e);
      }
    }
    st2(dpre + base + col, da1[0], da1[1]);
    st2(dpre + base + ch + col, da2[0], da2[1]);
#ifdef GLOW_BF16
    st2(dpre_bf + base + col, da1[0], da1[1]);
    st2(dpre_bf + base + ch + col, da2[0], da2[1]);
#endif
  }
};

// ActNorm's backward on v = dyd . mix: dy = v * mask; dx = dy * exp(logs);
// stats[row] = [dy, dy * exp(logs) * x], whose column sums are the
// gradients of an_bias and an_logs.
struct ActNormBackward {
  const act_t* x;        // [M, C] the step's input
  const float* an_logs;  // [C]
  const float* mask;     // [M]
  float* dx;             // [M, C]
  float* stats;          // [M, 2C]
  int c;
#ifdef GLOW_BF16
  // dx is the step's input gradient, the caller's at every frame
  static constexpr bool kValidRowsOnly = false;
#endif
  __device__ void operator()(int row, int col, float v0, float v1) const {
    const float m = mask[row];
    const float2 x2 = ld2(x + static_cast<size_t>(row) * c + col);
    const float2 l2 = ld2(an_logs + col);
    const float v[2] = {v0, v1};
    const float xv[2] = {x2.x, x2.y};
    const float lg[2] = {l2.x, l2.y};
    float dy[2], dxv[2], dl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dy[e] = v[e] * m;
      dxv[e] = dy[e] * expf(lg[e]);
      dl[e] = dxv[e] * xv[e];
    }
    st2(dx + static_cast<size_t>(row) * c + col, dxv[0], dxv[1]);
    float* out = stats + static_cast<size_t>(row) * 2 * c;
    st2(out + col, dy[0], dy[1]);
    st2(out + c + col, dl[0], dl[1]);
  }
};

dim3 nt_grid(const NtArgs& g, int B) {
  return dim3((g.N + NT_BN - 1) / NT_BN, (g.T + NT_BM - 1) / NT_BM, B);
}

template <int PASSES, bool TAIL, class Epilogue>
cudaError_t launch_nt_as(const NtArgs& g, const Epilogue& epilogue, int B,
                         cudaStream_t stream) {
  void (*kernel)(const NtArgs, const Epilogue);
  if constexpr (TAIL)
    kernel = gemm_nt_tail<PASSES, Epilogue>;
  else
    kernel = gemm_nt<PASSES, Epilogue>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kNtSmem));
  if (err != cudaSuccess) return err;
  kernel<<<nt_grid(g, B), kThreads, kNtSmem, stream>>>(g, epilogue);
  return cudaGetLastError();
}

template <class Epilogue>
cudaError_t launch_nt(const NtArgs& g, const Epilogue& epilogue, int B,
                      int passes, cudaStream_t stream) {
  if constexpr (kBf16) {   // one instantiation: passes is 1 (the entry's)
    return launch_nt_as<1, false>(g, epilogue, B, stream);
  } else {
  if constexpr (kDepthTail) {
    if (g.kseg % BK)
      return passes == 1 ? launch_nt_as<kOnePass, true>(g, epilogue, B, stream)
                         : launch_nt_as<3, true>(g, epilogue, B, stream);
  }
  return passes == 1 ? launch_nt_as<kOnePass, false>(g, epilogue, B, stream)
                     : launch_nt_as<3, false>(g, epilogue, B, stream);
  }
}

// ---------------------------------------------------------------------------
// weight gradients
// ---------------------------------------------------------------------------

// wgrad tile: 96 rows of dW (channels of one tap) x 128 columns, 32 frames a
// slice; warps 2 x 4, each 48 x 32.  Both operands lie frame-major; a
// fragment read is 4 frames x 8 neighbours, so rows are padded to 8 mod 32
// floats.
// In a GLOW_BF16 build the same pitches hold bfloat16, 208 and 272 bytes: an
// ldmatrix read of 8 frames' 16 bytes touches 32 banks.
constexpr int TN_BM = 96, TN_BN = 128;
constexpr int TN_LDP = TN_BM + 8, TN_LDG = TN_BN + 8;
constexpr int TN_WM = 48, TN_WN = 32;
constexpr size_t kTnSmem = sizeof(act_t) * kStages * BK * (TN_LDP + TN_LDG);
static_assert((TN_BM / TN_WM) * (TN_BN / TN_WN) == kThreads / 32, "warps");

// part[chunk][kd, n] = sum over the valid frames t of the chunk's samples of
// P[b*T + t + kd / kseg - pad, kd % kseg] * G[b*T + t, n] (zero when the
// shifted frame leaves [0, T)).  K = taps * kseg; N % 4 == 0, kseg even
// (its last 4-column group may read two columns past it, within the row:
// the start conv's x_a at C/2 = 2 mod 4, whose rows of dW past kseg are
// never stored).  Chunk c holds the samples [c * spc, (c + 1) * spc).  In a
// GLOW_BF16 build P and G are bfloat16 and N, ldp, ldg % 8 == 0, or % 4 in
// a kHalfChunks build.
struct TnArgs {
  const act_t* p;
  const act_t* g;
  float* part;
  int ldp, ldg, kseg, taps, pad;
  int N, T, B, spc;
  const int* lengths;
};

__host__ __device__ constexpr int tn_tiles_per_tap(int kseg) {
  return (kseg + TN_BM - 1) / TN_BM;
}

// Samples per chunk: as many as leave about 512 blocks for the product, at
// least one.  A function of the shapes alone, so the order of the sums is
// fixed.
int tn_samples_per_chunk(int B, int taps, int kseg, int N) {
  const int tiles = taps * tn_tiles_per_tap(kseg) * ((N + TN_BN - 1) / TN_BN);
  const int spc = (B * tiles + 256) / 512;
  return spc < 1 ? 1 : (spc > B ? B : spc);
}

int tn_chunks(int B, int taps, int kseg, int N) {
  const int spc = tn_samples_per_chunk(B, taps, kseg, N);
  return (B + spc - 1) / spc;
}

#ifdef GLOW_BF16
// The tile (row tile bx, column tile by) of dW over chunk `chunk` from
// bfloat16 operands, on mma.sync.m16n8k16: each 32-frame slice of P and G
// staged by cp.async as it lies in device memory (frame-major, zero-filled
// past the sample's length, outside [0, T) and past kseg or N), both
// operands' fragments read by ldmatrix.trans, the products accumulated in
// the tensor cores over the whole chunk.
template <int PASSES>
__device__ __forceinline__ void gemm_tn_tile(const TnArgs& g, int bx, int by,
                                             int chunk, float* smem) {
  using namespace bf16mma;
  act_t* const p_ring = reinterpret_cast<act_t*>(smem);
  act_t* const g_ring = p_ring + kStages * BK * TN_LDP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int per_tap = tn_tiles_per_tap(g.kseg);
  const int tap = bx / per_tap, c0 = (bx % per_tap) * TN_BM;
  const int shift = tap - g.pad;
  const int n0 = by * TN_BN;
  const int b_begin = chunk * g.spc;
  const int b_end = min(b_begin + g.spc, g.B);
  constexpr int MT = TN_WM / 16, NT = TN_WN / 8;
  float acc[MT][NT][4] = {};

  int n_it = 0;
  for (int b = b_begin; b < b_end; ++b) n_it += (g.lengths[b] + BK - 1) / BK;
  // where the next staged slice starts: sample, frame
  int pb = b_begin, pr = 0;
  while (pb < b_end && g.lengths[pb] <= 0) ++pb;

  auto stage = [&](int it) {
    const int len = g.lengths[pb];
    const size_t sample = static_cast<size_t>(pb) * g.T;
    act_t* ps = p_ring + (it % kStages) * BK * TN_LDP;
    act_t* gs = g_ring + (it % kStages) * BK * TN_LDG;
    for (int i = tid; i < BK * (TN_BM / 8); i += kThreads) {
      const int r = i / (TN_BM / 8), q = 8 * (i % (TN_BM / 8));
      const int t = pr + r + shift;
      if constexpr (kHalfChunks) {
        stage_halves(smem_u32(ps + r * TN_LDP + q),
                     g.p + (sample + t) * g.ldp, c0 + q,
                     pr + r < len && t >= 0 && t < g.T, g.kseg, g.p);
      } else {
        const bool ok =
            pr + r < len && t >= 0 && t < g.T && c0 + q < g.kseg;
        cp_async16(smem_u32(ps + r * TN_LDP + q),
                   ok ? g.p + (sample + t) * g.ldp + c0 + q : g.p, ok);
      }
    }
    for (int i = tid; i < BK * (TN_BN / 8); i += kThreads) {
      const int r = i / (TN_BN / 8), q = 8 * (i % (TN_BN / 8));
      if constexpr (kHalfChunks) {
        stage_halves(smem_u32(gs + r * TN_LDG + q),
                     g.g + (sample + pr + r) * g.ldg, n0 + q, pr + r < len,
                     g.N, g.g);
      } else {
        const bool ok = pr + r < len && n0 + q < g.N;
        cp_async16(smem_u32(gs + r * TN_LDG + q),
                   ok ? g.g + (sample + pr + r) * g.ldg + n0 + q : g.g, ok);
      }
    }
    pr += BK;
    if (pr >= len) {
      pr = 0;
      ++pb;
      while (pb < b_end && g.lengths[pb] <= 0) ++pb;
    }
  };

  // lane l gives the address of row l % 8 of ldmatrix's matrix l / 8:
  // A = P^T's (16 kd x 16 frames) as a0..a3, B = G's (16 frames x 16
  // columns) as b0, b1 of two n8 tiles
  const int mi = lane / 8, mr = lane % 8;
  const int a_off = (mr + 8 * (mi / 2)) * TN_LDP + wm * TN_WM + 8 * (mi % 2);
  const int b_off = (mr + 8 * (mi % 2)) * TN_LDG + wn * TN_WN + 8 * (mi / 2);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_it) stage(s);
    tf32::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_it) stage(it + kStages - 1);
    tf32::cp_async_commit();
    const uint32_t ps = smem_u32(p_ring + (it % kStages) * BK * TN_LDP + a_off);
    const uint32_t gs = smem_u32(g_ring + (it % kStages) * BK * TN_LDG + b_off);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_trans(a[mt], ps + 2 * (kk * TN_LDP + 16 * mt));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4_trans(b[np], gs + 2 * (kk * TN_LDG + 16 * np));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma(acc[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)],
              b[nt / 2][2 * (nt % 2) + 1]);
    }
  }
  tf32::cp_async_wait<0>();

  const int K = g.taps * g.kseg;
  float* out = g.part + static_cast<size_t>(chunk) * K * g.N;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + wm * TN_WM + 16 * mt + gq + 8 * half;
      if (c >= g.kseg) continue;
      const size_t kd = static_cast<size_t>(tap) * g.kseg + c;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * TN_WN + 8 * nt + 2 * tq;
        if (n < g.N)
          st2(out + kd * g.N + n, acc[mt][nt][2 * half],
              acc[mt][nt][2 * half + 1]);
      }
    }
}
#else
// The tile (row tile bx, column tile by) of dW over chunk `chunk`.
template <int PASSES>
__device__ __forceinline__ void gemm_tn_tile(const TnArgs& g, int bx, int by,
                                             int chunk, float* smem) {
  float* const p_ring = smem;
  float* const g_ring = p_ring + kStages * BK * TN_LDP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int per_tap = tn_tiles_per_tap(g.kseg);
  const int tap = bx / per_tap, c0 = (bx % per_tap) * TN_BM;
  const int shift = tap - g.pad;
  const int n0 = by * TN_BN;
  const int b_begin = chunk * g.spc;
  const int b_end = min(b_begin + g.spc, g.B);
  float acc[TN_WM / 16][TN_WN / 8][4] = {};   // of the slice in hand
  float sum[TN_WM / 16][TN_WN / 8][4] = {};   // of the slices before it

  int n_it = 0;
  for (int b = b_begin; b < b_end; ++b) n_it += (g.lengths[b] + BK - 1) / BK;
  // where the next staged slice starts: sample, frame
  int pb = b_begin, pr = 0;
  while (pb < b_end && g.lengths[pb] <= 0) ++pb;

  auto stage = [&](int it) {
    const int len = g.lengths[pb];
    const size_t sample = static_cast<size_t>(pb) * g.T;
    float* ps = p_ring + (it % kStages) * BK * TN_LDP;
    float* gs = g_ring + (it % kStages) * BK * TN_LDG;
    for (int i = tid; i < BK * (TN_BM / 4); i += kThreads) {
      const int r = i / (TN_BM / 4), q = 4 * (i % (TN_BM / 4));
      const int t = pr + r + shift;
      const bool ok =
          pr + r < len && t >= 0 && t < g.T && c0 + q < g.kseg;
      tf32::cp_async16_zfill(
          ps + r * TN_LDP + q,
          g.p + (sample + (ok ? t : 0)) * g.ldp + (ok ? c0 + q : 0), ok);
    }
    for (int i = tid; i < BK * (TN_BN / 4); i += kThreads) {
      const int r = i / (TN_BN / 4), q = 4 * (i % (TN_BN / 4));
      const bool ok = pr + r < len && n0 + q < g.N;
      tf32::cp_async16_zfill(
          gs + r * TN_LDG + q,
          g.g + (sample + (ok ? pr + r : 0)) * g.ldg + (ok ? n0 + q : 0), ok);
    }
    pr += BK;
    if (pr >= len) {
      pr = 0;
      ++pb;
      while (pb < b_end && g.lengths[pb] <= 0) ++pb;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_it) stage(s);
    tf32::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_it) stage(it + kStages - 1);
    tf32::cp_async_commit();
    const float* ps = p_ring + (it % kStages) * BK * TN_LDP + wm * TN_WM;
    const float* gs = g_ring + (it % kStages) * BK * TN_LDG + wn * TN_WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8)
      tf32::warp_step<TN_WM / 16, TN_WN / 8, PASSES>(
          acc, [&](int i, int k) { return ps[(kk + k) * TN_LDP + i]; },
          [&](int k, int j) { return gs[(kk + k) * TN_LDG + j]; });
    tf32::flush(acc, sum);
  }
  tf32::cp_async_wait<0>();

  const int K = g.taps * g.kseg;
  float* out = g.part + static_cast<size_t>(chunk) * K * g.N;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < TN_WM / 16; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + wm * TN_WM + 16 * mt + gq + 8 * half;
      if (c >= g.kseg) continue;
      const size_t kd = static_cast<size_t>(tap) * g.kseg + c;
#pragma unroll
      for (int nt = 0; nt < TN_WN / 8; ++nt) {
        const int n = n0 + wn * TN_WN + 8 * nt + 2 * tq;
        if (n < g.N)
          st2(out + kd * g.N + n, sum[mt][nt][2 * half],
              sum[mt][nt][2 * half + 1]);
      }
    }
}

#endif

template <int PASSES>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gemm_tn(const TnArgs g) {
  extern __shared__ float4 smem4[];
  gemm_tn_tile<PASSES>(g, blockIdx.x, blockIdx.y, blockIdx.z,
                       reinterpret_cast<float*>(smem4));
}

dim3 tn_grid(const TnArgs& g) {
  return dim3(g.taps * tn_tiles_per_tap(g.kseg), (g.N + TN_BN - 1) / TN_BN,
              (g.B + g.spc - 1) / g.spc);
}

template <int PASSES>
cudaError_t launch_tn_as(const TnArgs& g, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_tn<PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTnSmem));
  if (err != cudaSuccess) return err;
  gemm_tn<PASSES><<<tn_grid(g), kThreads, kTnSmem, stream>>>(g);
  return cudaGetLastError();
}

// P [B*T, >= kseg] and G [B*T, >= N] into part [chunks, taps * kseg, N]
TnArgs tn_args(const act_t* p, int ldp, int kseg, int taps, int pad,
               const act_t* grad, int ldg, int N, float* part, int B, int T,
               const int* lengths) {
  return {p, grad, part, ldp, ldg, kseg, taps, pad, N, T, B,
          tn_samples_per_chunk(B, taps, kseg, N), lengths};
}

cudaError_t launch_tn(const TnArgs& g, int passes, cudaStream_t stream) {
  if constexpr (kBf16) {
    return launch_tn_as<1>(g, stream);
  } else {
  return passes == 1 ? launch_tn_as<kOnePass>(g, stream)
                     : launch_tn_as<3>(g, stream);
  }
}

// One launch for an activation-gradient and a weight-gradient product that
// do not depend on each other (the k-tap conv's pair): the dgrad tiles come
// first, and the wgrad tiles fill the SMs that the ragged batch's skipped
// dgrad tiles leave idle.
template <int PASSES, bool TAIL, class Epilogue>
__device__ __forceinline__ void gemm_pair_block(const NtArgs& nt,
                                                const Epilogue& epilogue,
                                                const dim3& nt_blocks,
                                                const TnArgs& tn,
                                                const dim3& tn_blocks) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  int id = blockIdx.x;
  const int nt_count = nt_blocks.x * nt_blocks.y * nt_blocks.z;
  if (id < nt_count) {
    gemm_nt_tile<PASSES, TAIL>(nt, epilogue, id % nt_blocks.x,
                               id / nt_blocks.x % nt_blocks.y,
                               id / (nt_blocks.x * nt_blocks.y), smem);
  } else {
    id -= nt_count;
    gemm_tn_tile<PASSES>(tn, id % tn_blocks.x, id / tn_blocks.x % tn_blocks.y,
                         id / (tn_blocks.x * tn_blocks.y), smem);
  }
}

template <int PASSES, class Epilogue>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gemm_pair(const NtArgs nt, const Epilogue epilogue, const dim3 nt_blocks,
              const TnArgs tn, const dim3 tn_blocks) {
  gemm_pair_block<PASSES, false>(nt, epilogue, nt_blocks, tn, tn_blocks);
}

// gemm_pair whose dgrad depth is not a multiple of a slice (kDepthTail
// builds)
template <int PASSES, class Epilogue>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gemm_pair_tail(const NtArgs nt, const Epilogue epilogue,
                   const dim3 nt_blocks, const TnArgs tn,
                   const dim3 tn_blocks) {
  gemm_pair_block<PASSES, true>(nt, epilogue, nt_blocks, tn, tn_blocks);
}

template <int PASSES, bool TAIL, class Epilogue>
cudaError_t launch_pair_as(const NtArgs& nt, const Epilogue& epilogue,
                           const TnArgs& tn, cudaStream_t stream) {
  constexpr size_t smem = kNtSmem > kTnSmem ? kNtSmem : kTnSmem;
  void (*kernel)(const NtArgs, const Epilogue, const dim3, const TnArgs,
                 const dim3);
  if constexpr (TAIL)
    kernel = gemm_pair_tail<PASSES, Epilogue>;
  else
    kernel = gemm_pair<PASSES, Epilogue>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 nt_blocks = nt_grid(nt, tn.B), tn_blocks = tn_grid(tn);
  const int blocks = nt_blocks.x * nt_blocks.y * nt_blocks.z +
                     tn_blocks.x * tn_blocks.y * tn_blocks.z;
  kernel<<<blocks, kThreads, smem, stream>>>(nt, epilogue, nt_blocks, tn,
                                            tn_blocks);
  return cudaGetLastError();
}

template <class Epilogue>
cudaError_t launch_pair(const NtArgs& nt, const Epilogue& epilogue,
                        const TnArgs& tn, int passes, cudaStream_t stream) {
  if constexpr (kBf16) {
    return launch_pair_as<1, false>(nt, epilogue, tn, stream);
  } else {
  if constexpr (kDepthTail) {
    if (nt.kseg % BK)
      return passes == 1 ? launch_pair_as<kOnePass, true>(nt, epilogue, tn,
                                                          stream)
                         : launch_pair_as<3, true>(nt, epilogue, tn, stream);
  }
  return passes == 1 ? launch_pair_as<kOnePass, false>(nt, epilogue, tn,
                                                      stream)
                     : launch_pair_as<3, false>(nt, epilogue, tn, stream);
  }
}

// ---------------------------------------------------------------------------
// column sums and the reduction of all partials
// ---------------------------------------------------------------------------

// out[b, n] = sum over the valid frames of sample b of x[b*T + t, n], the
// frames added in a fixed order: 8 interleaved partial sums per column.  Up
// to four tensors a launch (blockIdx.z).
constexpr int kSumCols = 32, kSumGroups = kThreads / kSumCols;
constexpr int kMaxSums = 4;

struct SumJob {
  const float* x;
  float* out;
  int ldx, N;
};
struct SumJobs {
  SumJob job[kMaxSums];
  int count;
};

__global__ void __launch_bounds__(kThreads)
    column_sums(const SumJobs jobs, const int* lengths, int T) {
  __shared__ float part[kSumGroups][kSumCols];
  const SumJob job = jobs.job[blockIdx.z];
  const int c = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const int n = blockIdx.x * kSumCols + c, b = blockIdx.y;
  if (static_cast<int>(blockIdx.x) * kSumCols >= job.N) return;
  const int len = lengths[b];
  float sum = 0.f;
  if (n < job.N)
    for (int t = grp; t < len; t += kSumGroups)
      sum += job.x[(static_cast<size_t>(b) * T + t) * job.ldx + n];
  part[grp][c] = sum;
  __syncthreads();
  if (grp == 0 && n < job.N) {
    float total = 0.f;
    for (int i = 0; i < kSumGroups; ++i) total += part[i][c];
    job.out[static_cast<size_t>(b) * job.N + n] = total;
  }
}

cudaError_t launch_sums(SumJobs jobs, int B, int T, const int* lengths,
                        cudaStream_t stream) {
  int widest = 0;
  for (int i = 0; i < jobs.count; ++i)
    widest = jobs.job[i].N > widest ? jobs.job[i].N : widest;
  column_sums<<<dim3((widest + kSumCols - 1) / kSumCols, B, jobs.count),
                kThreads, 0, stream>>>(jobs, lengths, T);
  return cudaGetLastError();
}

#ifdef GLOW_PITCH
// Width of GR mode's pitch operand, num_squeeze, as flow_common.cuh's
// kPitchSize (this source does not include that header): GLOW_PITCH_SIZE,
// or 2 at 160 channels and 1 at 80 where the build does not name it.
#ifndef GLOW_PITCH_SIZE
#if GLOW_CHANNELS == 160
#define GLOW_PITCH_SIZE 2
#elif GLOW_CHANNELS == 80
#define GLOW_PITCH_SIZE 1
#else
#error "a pitch build of this width names its num_squeeze (GLOW_PITCH_SIZE)"
#endif
#endif
constexpr int kPitchSize = GLOW_PITCH_SIZE;

// The backward of layer i's pitch term, pitch [M, kPitchSize] . w_pitch
// [kPitchSize, ch2] added to the pre-gate sum after the dropout, from dacc
// [M, ch2].  Blocks [0, sum_blocks), (sample, 32 columns) each: part[b, q,
// n] = sum over sample b's valid frames of pitch[frame, q] * dacc[frame,
// n], 8 interleaved partial sums per column added in a fixed order (as
// column_sums).  The blocks after them, with dpitch: a warp per frame
// below its sample's length, dpitch[frame, q] += sum over n of
// dacc[frame, n] * w_pitch[q, n] (dacc is zero at the other frames).
__global__ void __launch_bounds__(kThreads)
    pitch_backward(const float* dacc, const float* pitch,
                   const float* w_pitch, float* part, float* dpitch,
                   const int* lengths, int T, int ch2, int sum_blocks,
                   size_t frames) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < sum_blocks) {
    __shared__ float red[kSumGroups][kPitchSize][kSumCols];
    const int c = tid % kSumCols, grp = tid / kSumCols;
    const int col_blocks = (ch2 + kSumCols - 1) / kSumCols;
    const int b = blockIdx.x / col_blocks;
    const int n = (blockIdx.x % col_blocks) * kSumCols + c;
    const int len = lengths[b];
    float sum[kPitchSize] = {};
    if (n < ch2)
      for (int t = grp; t < len; t += kSumGroups) {
        const size_t row = static_cast<size_t>(b) * T + t;
        const float d = dacc[row * ch2 + n];
#pragma unroll
        for (int q = 0; q < kPitchSize; ++q)
          sum[q] = fmaf(pitch[row * kPitchSize + q], d, sum[q]);
      }
#pragma unroll
    for (int q = 0; q < kPitchSize; ++q) red[grp][q][c] = sum[q];
    __syncthreads();
    if (grp < kPitchSize && n < ch2) {
      float total = 0.f;
      for (int i = 0; i < kSumGroups; ++i) total += red[i][grp][c];
      part[(static_cast<size_t>(b) * kPitchSize + grp) * ch2 + n] = total;
    }
    return;
  }
  const int lane = tid % 32;
  const size_t row = static_cast<size_t>(blockIdx.x - sum_blocks) *
                         (kThreads / 32) + tid / 32;
  if (row >= frames || static_cast<int>(row % T) >= lengths[row / T]) return;
  float sum[kPitchSize] = {};
  for (int n = lane; n < ch2; n += 32) {
    const float d = dacc[row * ch2 + n];
#pragma unroll
    for (int q = 0; q < kPitchSize; ++q)
      sum[q] = fmaf(d, __ldg(w_pitch + q * ch2 + n), sum[q]);
  }
#pragma unroll
  for (int q = 0; q < kPitchSize; ++q) {
    for (int o = 16; o > 0; o >>= 1)
      sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
    if (lane == 0) dpitch[row * kPitchSize + q] += sum[q];
  }
}

cudaError_t launch_pitch_backward(const float* dacc, const float* pitch,
                                  const float* w_pitch, float* part,
                                  float* dpitch, const int* lengths, int B,
                                  int T, int ch2, cudaStream_t stream) {
  const int sum_blocks = B * ((ch2 + kSumCols - 1) / kSumCols);
  const size_t frames = static_cast<size_t>(B) * T;
  const int row_blocks =
      dpitch ? static_cast<int>((frames + kThreads / 32 - 1) / (kThreads / 32))
             : 0;
  pitch_backward<<<sum_blocks + row_blocks, kThreads, 0, stream>>>(
      dacc, pitch, w_pitch, part, dpitch, lengths, T, ch2, sum_blocks, frames);
  return cudaGetLastError();
}
#endif

// dst[j] = src[j] + src[stride + j] + ... over `parts` partials, added in
// their order; count, stride % 4 == 0.  One job per gradient tensor
// (blockIdx.y): 7 + 4 n of a step of n layers, 7 + 5 n in a pitch build, so
// the jobs are sized by the build's layers (32 bytes each: a 16-layer
// pitch build's 87 fit the 4 KB of a launch's parameters), and at least
// the 32 the builds of 4 layers have.
constexpr int kMaxReduce = 7 + 5 * GLOW_LAYERS > 32 ? 7 + 5 * GLOW_LAYERS
                                                    : 32;
constexpr int kReducePerBlock = 4 * kThreads;

struct ReduceJob {
  const float* src;
  float* dst;
  int count, parts, stride;
};
struct ReduceJobs {
  ReduceJob job[kMaxReduce];
  int count;
};

__global__ void __launch_bounds__(kThreads)
    reduce_partials(const ReduceJobs jobs) {
  const ReduceJob job = jobs.job[blockIdx.y];
  const int j = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (j >= job.count) return;
  float4 sum = ld4(job.src + j);
  for (int p = 1; p < job.parts; ++p) {
    const float4 v = ld4(job.src + static_cast<size_t>(p) * job.stride + j);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  *reinterpret_cast<float4*>(job.dst + j) = sum;
}

cudaError_t launch_reduce(const ReduceJobs& jobs, cudaStream_t stream) {
  int largest = 0;
  for (int i = 0; i < jobs.count; ++i)
    largest = jobs.job[i].count > largest ? jobs.job[i].count : largest;
  reduce_partials<<<dim3((largest + kReducePerBlock - 1) / kReducePerBlock,
                         jobs.count),
                    kThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the affine epilogue's backward, elementwise
// ---------------------------------------------------------------------------

// From dz = [dz_a, dz_b] [M, C] and the logdet cotangent dld [B]:
// douts = [dz_b m, dz_b m e^logs x_b + dld m] (the end conv's output
// gradient) and dyd[:, C/2:] = dz_b m e^logs (x_b's gradient).  In a
// GLOW_BF16 build dyd is bfloat16 (only products read it) and douts_bf gets
// douts rounded to bfloat16.
__global__ void __launch_bounds__(kThreads)
    affine_backward(const float* dz, const float* dld, const float* mask,
                    const act_t* yd, const act_t* logs, float* douts,
                    act_t* dyd, int M, int T, int c2
#ifdef GLOW_BF16
                    , act_t* douts_bf
#endif
                    ) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M * c2) return;
  const int row = i / c2, c = i % c2;
  const size_t at = static_cast<size_t>(row) * 2 * c2;
  const float m = mask[row];
  const float dzb = dz[at + c2 + c] * m;
  const float dxb = dzb * expf(act_f(logs[i]));
#ifdef GLOW_BF16
  const float dlogs = dxb * act_f(yd[at + c2 + c]) + dld[row / T] * m;
  douts[at + c] = dzb;
  douts[at + c2 + c] = dlogs;
  douts_bf[at + c] = __float2bfloat16_rn(dzb);
  douts_bf[at + c2 + c] = __float2bfloat16_rn(dlogs);
  dyd[at + c2 + c] = __float2bfloat16_rn(dxb);
#else
  douts[at + c] = dzb;
  douts[at + c2 + c] = dxb * act_f(yd[at + c2 + c]) + dld[row / T] * m;
  dyd[at + c2 + c] = dxb;
#endif
}

#define CHECK(call)                         \
  do {                                      \
    const cudaError_t err_ = (call);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)
// a kernel launch: checked, and counted into *launched
#define LAUNCH(call) \
  do {               \
    CHECK(call);     \
    ++*launched;     \
  } while (0)
// an argument only a GLOW_BF16 build has: the bfloat16 copy of a cotangent
#ifdef GLOW_BF16
#define BF16_ARG(x) , x
#else
#define BF16_ARG(x)
#endif

}  // namespace

extern "C" {

// The flow's channel count this library is built for (GLOW_CHANNELS).
int glow_flow_channels() { return kChannels; }

// The reduction's jobs a launch takes (kMaxReduce): the entry refuses a
// step that needs more.
int glow_flow_train_bwd_max_reduce() { return kMaxReduce; }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Chunks of whole samples a weight gradient of `taps` taps of kseg rows and N
// columns is split into at batch size B: the leading axis of its partials.
int glow_flow_train_bwd_chunks(int B, int taps, int kseg, int N) {
  return tn_chunks(B, taps, kseg, N);
}

// One activation-gradient product alone, for tests and timing: out[B*T, N]
// = (sum over taps of A[frame + pad - tap, :kseg] . W[tap]^T) * mask, with
// A [B*T, lda], W [taps, N, ldw] (bfloat16 in a GLOW_BF16 build, which
// leaves out's rows past each sample's length as they were) and out
// contiguous.
int glow_flow_train_bwd_dgrad_f32(const act_t* a, const act_t* w,
                                  const float* mask, const int* lengths,
                                  float* out, int B, int T, int lda, int ldw,
                                  int kseg, int taps, int N, int passes,
                                  void* stream) {
  if (passes == 1 && !kBf16 && !kShippedShape) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  return launch_nt({a, w, lda, ldw, kseg, taps, (taps - 1) / 2, N * ldw, N, T,
                    lengths},
                   MaskedStore{out, nullptr, mask, N, 0}, B, passes,
                   static_cast<cudaStream_t>(stream));
}

// One weight-gradient product alone, for tests and timing: out[taps * kseg,
// N] = sum over valid frames of P[frame + tap - pad, :kseg]^T . G[frame, :N]
// through part [chunks, taps * kseg, N], with P [B*T, ldp] and G [B*T, ldg]
// (both bfloat16 in a GLOW_BF16 build).
int glow_flow_train_bwd_wgrad_f32(const act_t* p, const act_t* g,
                                  const int* lengths, float* part, float* out,
                                  int B, int T, int ldp, int ldg, int kseg,
                                  int taps, int N, int passes, void* stream_) {
  if (passes == 1 && !kBf16 && !kShippedShape) return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  auto stream = static_cast<cudaStream_t>(stream_);
  CHECK(launch_tn(tn_args(p, ldp, kseg, taps, (taps - 1) / 2, g, ldg, N, part,
                          B, T, lengths),
                  passes, stream));
  ReduceJobs jobs{};
  const int K = taps * kseg;
  jobs.job[0] = {part, out, K * N, tn_chunks(B, taps, kseg, N), K * N};
  jobs.count = 1;
  return launch_reduce(jobs, stream);
}

// Backward of flow step `step`.  Pointers, all float32 (but lengths) and
// contiguous, with M = B*T frames, c2 = C/2, ch2 = 2*ch, and chunks(taps,
// kseg, N) = glow_flow_train_bwd_chunks(B, taps, kseg, N):
//
// in[]  0 x [M,C] (the step's input)   1 y [M,C]        2 yd [M,C]
//       3 xin [n,M,ch]                 4 ts [n,M,ch2]   5 skip [M,ch]
//       6 logs [M,c2]                  7 mask [M]       8 dld [B]
//       9 dz [M,C]                    10 an_logs [C]   11 mix_t [C,C]
//      12 w_start [c2,ch]             13 w_in [n,k,ch,ch2]
//      14 w_rs [n,ch,ch2]             15 w_end [ch,C]
//      16 lengths [B] int32: one past each sample's last valid frame
//      GLOW_PITCH builds: 17 pitch [M,PS]   18 w_pitch [n,PS,ch2]
// out[] 0 dx [M,C]
//       scratch: 1 douts [M,C]  2 drs [M,ch2]  3 dpre [M,ch2]
//                4 dacc [M,ch2] or null (no conditioning, no pitch)
//                5 dyd [M,C]    6 stats [M,2C]  7 gate [M,ch]
//       partial weight gradients, one [K,N] per chunk of samples:
//       8 w_end [chunks(1,ch,C),ch,C]
//       9 w_rs [n,chunks(1,ch,ch2),ch,ch2]
//      10 w_in [n,chunks(k,ch,ch2),k*ch,ch2]
//      11 w_start [chunks(1,c2,ch),c2,ch]   12 mix_t [chunks(1,C,C),C,C]
//       per-sample column sums:
//      13 b_end [B,C]   14 b_rs [n,B,ch2]   15 b_in [n,B,ch2]
//      16 b_start [B,ch]   17 an [B,2C] ([d an_bias, d an_logs])
//       the step's gradients:
//      18 dcond [n,B,ch2] or null   19 an_logs [C]   20 an_bias [C]
//      21 mix_t [C,C]   22 w_start [c2,ch]   23 b_start [ch]
//      24 w_in [n,k,ch,ch2]   25 b_in [n,ch2]   26 w_rs [n,ch,ch2]
//      27 b_rs [n,ch2]   28 w_end [ch,C]   29 b_end [C]
//       GLOW_PITCH builds (dacc not null):
//      30 w_pitch [n,PS,ch2]   31 dpitch [M,PS], added to, or null (not
//      wanted)   32 partials of w_pitch [n,B,PS,ch2]
//       GLOW_BF16 builds, the cotangents rounded to bfloat16 as the products
//       read them:   33 douts [M,C]   34 drs [M,ch2]   35 dpre [M,ch2]
// passes is 3 (3xTF32, float32 accuracy) or, at a shipped shape
// (kShippedShape), 1 (plain TF32); in a GLOW_BF16
// build, where in[0..6], in[11..15], out[5] and out[7] are bfloat16, it is 1
// (one bfloat16 product).  *launched receives the number of kernels the
// call launched: 6 + 4 n, and n more in a GLOW_PITCH build.  Returns a
// cudaError_t, 0 on success.
int glow_flow_train_bwd_step_f32(const float* const* in, float* const* out,
                                 int B, int T, int C, int ch, int n, int k,
                                 int step, int seed, unsigned threshold,
                                 float scale, int dropout, int passes,
                                 void* stream_ptr, int* launched) {
  *launched = 0;
  if (C != kChannels || ch != GLOW_CH || n != GLOW_LAYERS ||
      k != GLOW_KSIZE || (kBf16 && passes != 1) ||
      (!kBf16 && passes == 1 && !kShippedShape))
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
#ifdef GLOW_PITCH
  if (7 + 5 * n > kMaxReduce || !out[4] || !in[17] || !in[18] || !out[30] ||
      !out[32])
    return cudaErrorInvalidValue;
  const float *pitch = in[17], *w_pitch = in[18];
  float *dpitch = out[31], *ppitch = out[32];
#else
  if (7 + 4 * n > kMaxReduce) return cudaErrorInvalidValue;
#endif
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T, c2 = C / 2, ch2 = 2 * ch, pad = (k - 1) / 2;
  const size_t frames = static_cast<size_t>(M);
  // the stored activations, in their type
  const act_t *x = reinterpret_cast<const act_t*>(in[0]),
              *y = reinterpret_cast<const act_t*>(in[1]),
              *yd = reinterpret_cast<const act_t*>(in[2]),
              *xin = reinterpret_cast<const act_t*>(in[3]),
              *ts = reinterpret_cast<const act_t*>(in[4]),
              *skip = reinterpret_cast<const act_t*>(in[5]),
              *logs = reinterpret_cast<const act_t*>(in[6]);
  const float *mask = in[7], *dld = in[8], *dz = in[9], *an_logs = in[10];
  // the weights the activation gradients read, in their type
  const act_t *mix_t = reinterpret_cast<const act_t*>(in[11]),
              *w_start = reinterpret_cast<const act_t*>(in[12]),
              *w_in = reinterpret_cast<const act_t*>(in[13]),
              *w_rs = reinterpret_cast<const act_t*>(in[14]),
              *w_end = reinterpret_cast<const act_t*>(in[15]);
  const int* lengths = reinterpret_cast<const int*>(in[16]);
  act_t* gate = reinterpret_cast<act_t*>(out[7]);
  act_t* dyd = reinterpret_cast<act_t*>(out[5]);
#ifdef GLOW_BF16
  if (!out[33] || !out[34] || !out[35]) return cudaErrorInvalidValue;
  act_t *douts_bf = reinterpret_cast<act_t*>(out[33]),
        *drs_bf = reinterpret_cast<act_t*>(out[34]),
        *dpre_bf = reinterpret_cast<act_t*>(out[35]);
  // what the products read of each cotangent
  const act_t *douts_in = douts_bf, *drs_in = drs_bf, *dpre_in = dpre_bf;
#else
  const float *douts_in = out[1], *drs_in = out[2], *dpre_in = out[3];
#endif
  float *dx = out[0], *douts = out[1], *drs = out[2], *dpre = out[3],
        *dacc = out[4], *stats = out[6], *pw_end = out[8], *pw_rs = out[9], *pw_in = out[10],
        *pw_start = out[11], *pmix = out[12], *pb_end = out[13],
        *pb_rs = out[14], *pb_in = out[15], *pb_start = out[16],
        *pan = out[17], *dcond = out[18];
  const dropmask::Dropout drop{static_cast<unsigned>(seed), threshold, scale,
                               dropout};
  const int chunks_rs = tn_chunks(B, 1, ch, ch2);
  const int chunks_in = tn_chunks(B, k, ch, ch2);

  // ---- the affine epilogue and the end conv -----------------------------
  affine_backward<<<(M * c2 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dz, dld, mask, yd, logs, douts, dyd, M, T, c2 BF16_ARG(douts_bf));
  LAUNCH(cudaGetLastError());
  // drs = [res gradient, dskip]: the res half starts at zero (the last
  // layer has no res output), dskip = (douts . w_end^T) * m for all layers;
  // with it dW_end = skip^T . douts
  CHECK(cudaMemset2DAsync(drs, ch2 * sizeof(float), 0, ch * sizeof(float),
                          frames, stream));
#ifdef GLOW_BF16
  CHECK(cudaMemset2DAsync(drs_bf, ch2 * sizeof(act_t), 0, ch * sizeof(act_t),
                          frames, stream));
#endif
  LAUNCH(launch_pair(
      {douts_in, w_end, C, C, C, 1, 0, 0, ch, T, lengths},
      MaskedStore{drs + ch, nullptr, mask, ch2, 0 BF16_ARG(drs_bf + ch)},
      tn_args(skip, ch, ch, 1, 0, douts_in, C, C, pw_end, B, T, lengths),
      passes, stream));

  // ---- the WaveNet layers, last to first --------------------------------
  for (int i = n - 1; i >= 0; --i) {
    const act_t* ts_i = ts + i * frames * ch2;
    const act_t* w_in_i = w_in + static_cast<size_t>(i) * k * ch * ch2;
    const act_t* w_rs_i = w_rs + static_cast<size_t>(i) * ch * ch2;
    // res/skip 1x1: dgate = drs . w_rs^T, then the gate's backward
    LAUNCH(launch_nt(
        {drs_in, w_rs_i, ch2, ch2, ch2, 1, 0, 0, ch, T, lengths},
        GateBackward{ts_i, dpre, dacc, gate, ch, T,
                     static_cast<unsigned>(T + k - 1),
                     dropmask::layer_salt(drop.seed, step, i, n),
                     drop BF16_ARG(dpre_bf)},
        B, passes, stream));
    // db_rs, db_in, dcond (and, beside the last layer's, db_end)
    SumJobs sums{};
    if (i == n - 1) sums.job[sums.count++] = {douts, pb_end, C, C};
    sums.job[sums.count++] = {drs, pb_rs + static_cast<size_t>(i) * B * ch2,
                              ch2, ch2};
    sums.job[sums.count++] = {dpre, pb_in + static_cast<size_t>(i) * B * ch2,
                              ch2, ch2};
    if (dcond)
      sums.job[sums.count++] = {
          dacc, dcond + static_cast<size_t>(i) * B * ch2, ch2, ch2};
    LAUNCH(launch_sums(sums, B, T, lengths, stream));
#ifdef GLOW_PITCH
    // dw_pitch's per-sample partials and dpitch, from dacc
    LAUNCH(launch_pitch_backward(
        dacc, pitch, w_pitch + static_cast<size_t>(i) * kPitchSize * ch2,
        ppitch + static_cast<size_t>(i) * B * kPitchSize * ch2, dpitch,
        lengths, B, T, ch2, stream));
#endif
    // dW_rs = (t*s)^T . drs
    LAUNCH(launch_tn(
        tn_args(gate, ch, ch, 1, 0, drs_in, ch2, ch2,
                pw_rs + static_cast<size_t>(i) * chunks_rs * ch * ch2, B, T,
                lengths),
        passes, stream));
    // k-tap conv, one launch for both: the input gradient dpre[frame + pad -
    // tap] . w_in[tap]^T summed over the taps (the res half of drs becomes
    // (that + the res gradient) * m, the next layer's res gradient), and
    // dW[tap] = xin[frame + tap - pad]^T . dpre[frame]
    LAUNCH(launch_pair(
        {dpre_in, w_in_i, ch2, ch2, ch2, k, pad, ch * ch2, ch, T, lengths},
        MaskedStore{drs, drs, mask, ch2, ch2 BF16_ARG(drs_bf)},
        tn_args(xin + i * frames * ch, ch, ch, k, pad, dpre_in, ch2, ch2,
                pw_in + static_cast<size_t>(i) * chunks_in * k * ch * ch2, B,
                T, lengths),
        passes, stream));
  }

  // ---- start conv, mixing, ActNorm ----------------------------------------
  // drs[:, :ch] is now dh = d(start conv output) * m: dyd[:, :c2] = (dz_a +
  // dh . w_start^T) * m, and dW_start = x_a^T . dh
  LAUNCH(launch_pair(
      {drs_in, w_start, ch2, ch, ch, 1, 0, 0, c2, T, lengths},
#ifdef GLOW_BF16
      MaskedStore{nullptr, dz, mask, C, C, dyd},
#else
      MaskedStore{dyd, dz, mask, C, C},
#endif
      tn_args(yd, C, c2, 1, 0, drs_in, ch2, ch, pw_start, B, T, lengths),
      passes, stream));
  // the mixing's input gradient through ActNorm's backward, and dmix = y^T .
  // dyd
  LAUNCH(launch_pair({dyd, mix_t, C, C, C, 1, 0, 0, C, T, lengths},
                     ActNormBackward{x, an_logs, mask, dx, stats, C},
                     tn_args(y, C, C, 1, 0, dyd, C, C, pmix, B, T, lengths),
                     passes, stream));
  SumJobs sums{};
  sums.job[sums.count++] = {drs, pb_start, ch2, ch};
  sums.job[sums.count++] = {stats, pan, 2 * C, 2 * C};
  LAUNCH(launch_sums(sums, B, T, lengths, stream));

  // ---- every partial into the step's gradients, in order ------------------
  ReduceJobs red{};
  auto reduce = [&](const float* src, float* dst, int count, int parts,
                    int stride) {
    red.job[red.count++] = {src, dst, count, parts, stride};
  };
  reduce(pan + C, out[19], C, B, 2 * C);
  reduce(pan, out[20], C, B, 2 * C);
  reduce(pmix, out[21], C * C, tn_chunks(B, 1, C, C), C * C);
  reduce(pw_start, out[22], c2 * ch, tn_chunks(B, 1, c2, ch), c2 * ch);
  reduce(pb_start, out[23], ch, B, ch);
  reduce(pw_end, out[28], ch * C, tn_chunks(B, 1, ch, C), ch * C);
  reduce(pb_end, out[29], C, B, C);
  for (int i = 0; i < n; ++i) {
    const int w_in_size = k * ch * ch2, w_rs_size = ch * ch2;
    reduce(pw_in + static_cast<size_t>(i) * chunks_in * w_in_size,
           out[24] + static_cast<size_t>(i) * w_in_size, w_in_size, chunks_in,
           w_in_size);
    reduce(pb_in + static_cast<size_t>(i) * B * ch2, out[25] + i * ch2, ch2, B,
           ch2);
    reduce(pw_rs + static_cast<size_t>(i) * chunks_rs * w_rs_size,
           out[26] + static_cast<size_t>(i) * w_rs_size, w_rs_size, chunks_rs,
           w_rs_size);
    reduce(pb_rs + static_cast<size_t>(i) * B * ch2, out[27] + i * ch2, ch2, B,
           ch2);
#ifdef GLOW_PITCH
    const int w_pitch_size = kPitchSize * ch2;
    reduce(ppitch + static_cast<size_t>(i) * B * w_pitch_size,
           out[30] + i * w_pitch_size, w_pitch_size, B, w_pitch_size);
#endif
  }
  LAUNCH(launch_reduce(red, stream));
  return cudaSuccess;
}

}  // extern "C"
