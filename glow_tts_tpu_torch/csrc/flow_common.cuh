// Shared device code of the flow kernels (flow_step.cu, coupling.cu,
// flow_stack.cu, flow_train_fwd.cu): the time-tile shape arithmetic, the
// block-wide float32 GEMM of the small 1x1 convs, the tensor-core GEMM of the
// big ones, the list of live tiles of a ragged batch, and the body of a flow
// step on one tile (coupling_net, affine_forward and, for the deterministic
// kernels, flow_step_tile), which every kernel instantiates.
//
// What bounds the body on an H100: arithmetic.  The k-tap convs and the
// res/skip 1x1s are ~95 % of a step's 3.6 MFLOP per frame; as f32 FMA they
// ran at 37-39 % of the 67 TFLOP/s FMA peak with the tensor cores idle.
// What the design does about it:
// * the two big products run on the tensor cores (tc_gemm: mma.sync
//   m16n8k8, TF32 operands, f32 sums) as the error-compensated 3xTF32
//   product, which keeps f32 accuracy (tf32_mma.cuh; one TF32 pass keeps
//   three digits and is kept for measuring);
// * the weights are split into TF32 hi/lo halves once, where they are
//   packed (ops/coupling.py::tensor_core_weights), and stored in the order
//   of the mma B fragments, so a lane reads its hi and lo pair of one 8 x 8
//   block as one 16-byte load and splits nothing.  The 8 warps of a block
//   share the output columns (48 of 2CH each) and cover all rows, so each
//   weight is read by one warp of the block, straight from L2 into
//   registers, kAhead k-steps ahead: no weight ring in shared memory and no
//   barrier inside a GEMM.  The activations (h, the gate) are split where
//   they are read;
// * the tensor cores' own f32 accumulation truncates, so every 8-deep step
//   starts from zero and is added to the f32 sum in plain f32 (the second
//   accumulator set of tf32_mma.cuh, one 4-register fragment at a time);
// * the gate is fused into the k-tap conv's epilogue: w_in's tanh and
//   sigmoid columns are interleaved when packed, so one thread holds both
//   halves of a channel and the 2CH-wide pre-gate sum never exists;
// * 138 KB of shared memory a block at TT = 32 (it was 221 KB with the
//   weight ring and the pre-gate buffer).
// Timed on an H100 and dropped (PERF.md has the times): an L2 evict-last
// policy on the weight loads (a storing step alone up to 0.19 ms slower),
// the saved rows written by the TMA's bulk copies instead of the threads
// (no faster), mma issued in the order written, weights split in the warp.
//
// A GLOW_BF16 build (flow_train_fwd.cu's, #5; ops/coupling.py's bfloat16
// policy) computes what the TPU kernels compute at dt = bfloat16
// (glow_tts_tpu/ops/coupling.py::_coupling_body): the activations in device
// memory (the step's input and output, the saved values) are bfloat16
// (act_t); in shared memory they stay float32, rounded to bfloat16
// (act_round) where the TPU kernel casts them: the ActNorm output and x_a
// before the mixing and the start conv, h after every update, the gate and
// the masked skip sum before their products.  The two big products run on
// the tensor cores with bfloat16 operands (tc_gemm_bf16_tiles: mma.sync
// m16n8k16, f32 sums) on weights laid out once in bfloat16
// (ops/coupling.py::tensor_core_layout_bf16); the small FMA products read
// bfloat16 values held in float32 (operands rounded here, weights rounded
// where they are packed), whose products are exact in float32.  x_b, the
// sums and the logdet stay float32.  The float32 builds' code is what it
// was: every bfloat16 change is a type or an inline identity there.
// flow_train_fwd.cu's bfloat16 build (#5) defines GLOW_BF16_TILES for a
// body of its own (see there): h and the gate in bfloat16 in shared memory
// (hb, gb, over hs's and gs's room), read by ldmatrix in
// tc_gemm_bf16_tiles.  The bfloat16 builds of flow_step.cu, flow_stack.cu
// and coupling.cu run flow_ring.cuh's body instead (GLOW_BF16_RING).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifdef GLOW_BF16
#include <cuda_bf16.h>
#endif

#include "tf32_mma.cuh"
#ifdef GLOW_BF16_TILES
#include "bf16_mma.cuh"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One lane's B fragment of W in the tensor-core layout: of an 8 x 8 block,
// TF32 (hi, hi', lo, lo'); in a GLOW_BF16 build, of a 16 x 8 block, two
// bfloat16 pairs (rows 2t, 2t+1 and 2t+8, 2t+9 of column g).  kKStep is the
// depth of a block.
using TfFrag = float4;
#ifdef GLOW_BF16
using WFrag = uint2;
constexpr int kKStep = 16;
#else
using WFrag = TfFrag;
constexpr int kKStep = 8;
#endif

#define HD __host__ __device__

HD constexpr int cmax(int a, int b) { return a > b ? a : b; }
HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
// float4 column groups per lane for an N-wide block_gemm output
HD constexpr int lane_quads(int n) { return ceil_div(n / 4, 32); }

template <int C_, int CH_, int NL_, int KS_, int TT_>
struct Shape {
  static constexpr int C = C_, CH = CH_, NL = NL_, KS = KS_, TT = TT_;
  static constexpr int C2 = C / 2, CH2 = 2 * CH;
  static constexpr int PAD = (KS - 1) / 2;
  static constexpr int HALO = NL * PAD;
  static constexpr int R = TT + 2 * HALO;
  // row pitches: h and the gate are read as mma A fragments (8 rows x 4
  // columns a lane group), which a pitch of 4 mod 32 floats spreads over 32
  // banks; the skip sum is written as column pairs (8 mod 32)
  static constexpr int HP = CH + 4, GP = CH + 4, SP = CH + 8;
  // #5's bfloat16 copies of h and the gate (GLOW_BF16_TILES), over the
  // float32 buffers' room: rows of CH + 8 bfloat16, 16 mod 128 bytes, so an
  // ldmatrix read of 8 rows' 16 bytes touches 32 banks
  static constexpr int HPB = CH + 8, GPB = CH + 8;
  // n8 tiles across the 2CH columns of w_in and w_rs, and a warp's share
  static constexpr int NB = CH2 / 8, NT = NB / kWarps;
  static_assert(C % 4 == 0 && CH % (4 * kWarps) == 0 && KS % 2 == 1 &&
                    NB % kWarps == 0 && NT % 2 == 0,
                "shape");
  // floats of a half's row (C2 of them) that one load or store of a half
  // moves: a float4, or a float2 where C2 = 2 mod 4 (C = 100: a half's x_b
  // starts 8 bytes into a 16-byte chunk)
  static constexpr int HV = C2 % 4 == 0 ? 4 : 2;

  HD static constexpr int layer_lo(int i) { return PAD * (i + 1); }
  HD static constexpr int layer_rows(int i) { return R - 2 * PAD * (i + 1); }
  // m16 row tiles of a tensor-core GEMM over `rows` rows
  HD static constexpr int mt(int rows) { return ceil_div(rows, 16); }
  // a block_gemm over `rows` rows gives each warp mr(rows) of them; the
  // block computes span(rows) >= rows rows and stores the first `rows`
  HD static constexpr int mr(int rows) { return ceil_div(rows, kWarps); }
  HD static constexpr int span(int rows) { return kWarps * mr(rows); }

  // buffer rows: enough for every row any GEMM reads, stored or not
  HD static constexpr int x_rows() {
    return cmax(span(R), HALO + span(TT));
  }
  HD static constexpr int h_rows() {
    int m = R;
    for (int i = 0; i < NL; ++i)
      m = cmax(m, layer_lo(i) - PAD + 16 * mt(layer_rows(i)) + KS - 1);
    return m;
  }
  // the gate [rows, GP] of every layer, the mixing output [R, C] and the
  // end conv's output [TT, C] share one buffer
  HD static constexpr int g_floats() {
    int m = cmax(span(R), span(TT)) * C;
    for (int i = 0; i < NL; ++i) m = cmax(m, 16 * mt(layer_rows(i)) * GP);
    return m;
  }
  static constexpr int XS = x_rows() * C;
  static constexpr int HS = h_rows() * HP;
  static constexpr int GS = g_floats();
  static constexpr int SS = span(TT) * SP;
  static constexpr int MS = ceil_div(x_rows(), 4) * 4;
  static constexpr int FLOATS = XS + HS + GS + SS + MS;
  static constexpr size_t smem_bytes = sizeof(float) * FLOATS;
  // a saving kernel's staging of the owned rows' gate halves (tanh,
  // sigmoid) behind the buffers, so that they leave as whole rows
  static constexpr int TSP = CH2 + 4;
  static constexpr int SAVE_FLOATS = TT * TSP;
  // fragments (WFrag) of one layer's w_in and w_rs in the tensor-core
  // layout, a fragment per lane for every kKStep-deep block
  static constexpr size_t W_IN_TC =
      static_cast<size_t>(KS) * CH / kKStep * NB * 32;
  static constexpr size_t W_RS_TC = static_cast<size_t>(CH) / kKStep * NB * 32;
  // a block's static shared memory besides a pitch stage (the warps' sums:
  // a bound, as ops/coupling.py::geometry counts it), and what
  // write_geometry reports of a ring it has not
  static constexpr int STATIC_BYTES = 128;
  static constexpr int RING_DEPTH = 0, HALF_SMALL = 0, HALF_BIG = 0;
};

// The shape of this build (ops/coupling.py::build_defines passes each
// macro that differs from the shipped one): the flow's channel count, the
// shipped config's 160 (Num_Squeeze 2) unless the build defines another
// (MiniSpeech's 80, Num_Squeeze 1; 100-bin mels' 200, or 100 at
// Num_Squeeze 1; 128-bin mels' 256), and the WaveNet's ch 192, 4 layers and
// k 5 unless it defines others.  C is a multiple of 4 from 8 to 256, ch at
// most 192, k odd, the halo NL (k - 1) / 2 at most 16
// (ops/coupling.py::ENVELOPE; each body's block budget is asserted below
// and in flow_ring.cuh).
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
static_assert(GLOW_CHANNELS % 4 == 0 && GLOW_CHANNELS >= 8 &&
                  GLOW_CHANNELS <= 256 &&
                  GLOW_CH >= 1 && GLOW_CH <= 192 && GLOW_LAYERS >= 1 &&
                  GLOW_KSIZE % 2 == 1 &&
                  GLOW_LAYERS * (GLOW_KSIZE - 1) / 2 <= 16,
              "outside the flow kernels' envelope (ROADMAP.md B.2)");
// The float32 body computes the WaveNet at ch padded to the tensor-core
// tiles' grain (a multiple of 64: 2CH / 8 column tiles, an even share of
// the 8 warps), on weights, conditioning rows and pitch weights padded with
// zeros (ops/coupling.py::padded_wavenet): the padded channels of h, the
// gate, the res/skip sums stay exact zeros (tanh 0 * sigmoid 0 = 0), so z
// and the logdet are the unpadded computation's.  At ch 192 it is ch.
constexpr int kChPad = ceil_div(GLOW_CH, 64) * 64;
// The shipped shapes (160 and 80 channels at the shipped WaveNet) carry the
// measuring instantiations besides (the float32 flow step's one TF32 pass,
// the ring body's timed instantiation); the other shapes build the kernels
// the wrappers launch, in half the compile time.
#define GLOW_SHIPPED_SHAPE                                              \
  (GLOW_CH == 192 && GLOW_LAYERS == 4 && GLOW_KSIZE == 5 &&             \
   (GLOW_CHANNELS == 160 || GLOW_CHANNELS == 80))
using Built = Shape<GLOW_CHANNELS, kChPad, GLOW_LAYERS, GLOW_KSIZE, 32>;
// The width a saving instantiation (flow_train_fwd.cu) stores every
// layer's input, gate halves and the skip sum at: the true ch, not the
// body's padded one, so neither the stored bytes nor flow_train_bwd.cu's
// products (sized at ch) grow with the padding.
constexpr int kSavedCh = GLOW_CH;

// a block's shared memory on an H100 (227 KB), and the batch a launch's
// live-tile list is budgeted for
constexpr int kBlockBytes = 232448;
constexpr int kMaxBatch = 1024;

// Width of GR mode's pitch operand, num_squeeze, as the JAX package
// squeezes the pitch: GLOW_PITCH_SIZE, which ops/coupling.py::build_defines
// passes from the config unless it is the 160-channel build's 2 (the
// shipped Num_Squeeze 2) or the 80-channel build's 1 (MiniSpeech,
// Num_Squeeze 1).
#ifndef GLOW_PITCH_SIZE
#if GLOW_CHANNELS == 160
#define GLOW_PITCH_SIZE 2
#elif GLOW_CHANNELS == 80 || !defined(GLOW_PITCH)
#define GLOW_PITCH_SIZE 1
#else
#error "a pitch build of this width names its num_squeeze (GLOW_PITCH_SIZE)"
#endif
#endif
constexpr int kPitchSize = GLOW_PITCH_SIZE;

// Whether this build takes GR's pitch operand (GLOW_PITCH)
#ifdef GLOW_PITCH
constexpr bool kPitch = true;
#else
constexpr bool kPitch = false;
#endif

// Whether a block of shape S stages a saving instantiation's gate halves
// (Shape::SAVE_FLOATS) behind its buffers, so that they leave as whole rows:
// flow_train_fwd.cu defines GLOW_SAVE_STAGE, and each of its kernels has the
// stage, saving or not, where the buffers, the stage, the live-tile list of
// kMaxBatch samples, the static arrays and the pitch rows fit the block
// (every shape but 3 % of the float32 envelope, ch over 128 at C of 160 or
// more and a halo of 9 frames or more, such as C = 200 at 8 layers); where
// they do not, the saving kernel stores each gate half from the epilogue's
// registers (wavenet_layers).  No stage in every other source.
// ops/coupling.py::geometry decides the same (train: save_stage).
template <class S>
HD constexpr bool stages_saves() {
#ifdef GLOW_SAVE_STAGE
  return S::smem_bytes + sizeof(float) * S::SAVE_FLOATS +
             4 * (2 * kMaxBatch + 1) + S::STATIC_BYTES +
             4 * (kPitch ? kPitchSize : 0) * S::R <=
         static_cast<size_t>(kBlockBytes);
#else
  return false;
#endif
}
// and its bytes
template <class S>
HD constexpr size_t save_stage_bytes() {
  if constexpr (stages_saves<S>())
    return sizeof(float) * S::SAVE_FLOATS;
  else
    return 0;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
// An activation: through L2 only, never the read-only path, since
// flow_stack.cu reads what other blocks wrote earlier in the same launch.
__device__ __forceinline__ float4 ld_act4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4& at4(float* p) {
  return *reinterpret_cast<float4*>(p);
}
__device__ __forceinline__ float2 ld_act2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
// Four activations to device memory; streamed (written once, read much
// later) with stcs_act4.
__device__ __forceinline__ void st_act4(float* p, float4 v) { at4(p) = v; }
__device__ __forceinline__ void stcs_act4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ float to_act(float v, float*) { return v; }
__device__ __forceinline__ void st_act2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void stcs_act2(float* p, float2 v) {
  __stcs(reinterpret_cast<float2*>(p), v);
}

// The activations' type in device memory, and v rounded to it and held in
// float32 (the identity in a float32 build).
#ifdef GLOW_BF16
constexpr bool kBf16 = true;
using act_t = __nv_bfloat16;
__device__ __forceinline__ float act_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
using tf32::bf16_hi;
using tf32::bf16_lo;
using tf32::pack_bf16;
__device__ __forceinline__ float4 ld_act4(const __nv_bfloat16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ uint2 pack4_bf16(float4 v) {
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void st_act4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = pack4_bf16(v);
}
__device__ __forceinline__ void stcs_act4(__nv_bfloat16* p, float4 v) {
  __stcs(reinterpret_cast<uint2*>(p), pack4_bf16(v));
}
__device__ __forceinline__ __nv_bfloat16 to_act(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ void stcs_act2(__nv_bfloat16* p, float2 v) {
  __stcs(reinterpret_cast<unsigned*>(p), pack_bf16(v.x, v.y));
}
#else
constexpr bool kBf16 = false;
using act_t = float;
__device__ __forceinline__ float act_round(float v) { return v; }
#endif
__device__ __forceinline__ float4 act_round4(float4 v) {
  return make_float4(act_round(v.x), act_round(v.y), act_round(v.z),
                     act_round(v.w));
}
__device__ __forceinline__ float2& at2(float* p) {
  return *reinterpret_cast<float2*>(p);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// out[rows, N] = A[rows, K] . W[K, N] for the small contractions (the
// mixing, the start and the end 1x1, 4 % of the FLOPs), float32 FMA: A in
// shared memory with row stride lda, W in global memory with row stride
// ldw.  Warp w owns the rows [w*MR, w*MR + MR); lane l owns the float4
// column groups l + 32*j (j < NV) that lie below N/4.  A loads are
// warp-wide broadcasts, W loads 512-byte coalesced rows that the block's
// eight warps share through L1.  The epilogue sees (row, first column,
// four sums) for every owned cell.  K is a multiple of 4 but for KTAIL (K
// mod 4) depths past the last whole 4-deep step (the start conv's C/2 = 50
// at C = 100), which are taken one at a time: A's columns and W's rows past
// K are never read, so nothing beyond the depth (x_b, the next weight)
// enters the sums.
template <int MR, int NV, int KTAIL = 0, typename Epilogue>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int K,
                                           const float* __restrict__ W,
                                           int ldw, int n_quads,
                                           Epilogue epilogue) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[MR][NV][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
  bool owned[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) owned[j] = lane + 32 * j < n_quads;

  const float* a_rows = A + warp * MR * lda;
  const float4* w4 = reinterpret_cast<const float4*>(W) + lane;
  const int ldw4 = ldw / 4;
  for (int k0 = 0; k0 < K - KTAIL; k0 += 4) {
    float4 a[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r)
      a[r] = *reinterpret_cast<const float4*>(a_rows + r * lda + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 w[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        w[j] = owned[j] ? __ldg(w4 + (k0 + kk) * ldw4 + 32 * j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                       : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          acc[r][j][0] = fmaf(av, w[j].x, acc[r][j][0]);
          acc[r][j][1] = fmaf(av, w[j].y, acc[r][j][1]);
          acc[r][j][2] = fmaf(av, w[j].z, acc[r][j][2]);
          acc[r][j][3] = fmaf(av, w[j].w, acc[r][j][3]);
        }
      }
    }
  }
  if constexpr (KTAIL != 0) {
#pragma unroll
    for (int kk = 0; kk < KTAIL; ++kk) {
      const int k = K - KTAIL + kk;
      float4 w[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        w[j] = owned[j] ? __ldg(w4 + k * ldw4 + 32 * j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float av = a_rows[r * lda + k];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          acc[r][j][0] = fmaf(av, w[j].x, acc[r][j][0]);
          acc[r][j][1] = fmaf(av, w[j].y, acc[r][j][1]);
          acc[r][j][2] = fmaf(av, w[j].z, acc[r][j][2]);
          acc[r][j][3] = fmaf(av, w[j].w, acc[r][j][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (owned[j])
        epilogue(warp * MR + r, 4 * (lane + 32 * j),
                 make_float4(acc[r][j][0], acc[r][j][1], acc[r][j][2],
                             acc[r][j][3]));
}

// W's fragments are loaded this many 8-deep steps ahead of their use
constexpr int kAhead = 1;
// an 8-deep step issues its products pass by pass over groups of this many
// column tiles (and all row tiles), so that only the group's fragments
// are in flight
constexpr int kGroup = 2;

// The tensor-core GEMM of a warp: sum = A . W over K = 8 * NK8, for the m16
// row tiles mt < MT and the n8 column tiles nt0 + nt (nt < NT) of W.
//   A (row, k) = a_at(kb)[row * LDA + k - 8 kb] for k in the 8-deep block
//   kb, in shared memory (a_at moves along k, and, for the k-tap conv,
//   one row further at each tap);
//   W is in the tensor-core layout of ops/coupling.py::tensor_core_weights:
//   float4 [NK8][NB][32 lanes] = (hi(t, g), hi(t + 4, g), lo(t, g),
//   lo(t + 4, g)) of its 8 x 8 block for lane 4 g + t.
// Each 8-deep step's PASSES products (a_lo.b_hi, a_hi.b_lo, a_hi.b_hi, or
// a_hi.b_hi alone) go into a fragment that starts at zero, which is then
// added to sum in f32 (the tensor cores' own accumulation truncates).  W's
// fragments for step kb + kAhead are loaded while step kb computes.
template <int MT, int NT, int NK8, int LDA, int NB, int PASSES, class AAt>
__device__ __forceinline__ void tc_gemm(float (&sum)[MT][NT][4],
                                        const AAt& a_at,
                                        const TfFrag* __restrict__ w,
                                        int nt0) {
  static_assert(PASSES == 1 || PASSES == 3, "1xTF32 or 3xTF32");
  constexpr int Q = kAhead + 1;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
  const TfFrag* wl = w + nt0 * 32 + lane;
  TfFrag bq[Q][NT];   // W's fragments of Q consecutive steps
  auto load = [&](TfFrag (&dst)[NT], int kb) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      dst[nt] = __ldg(wl + (static_cast<size_t>(kb) * NB + nt) * 32);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < NK8) load(bq[j], j);
  for (int kb0 = 0; kb0 < NK8; kb0 += Q) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int kb = kb0 + j;
      if (kb < NK8) {
        if (kb + kAhead < NK8) load(bq[(j + kAhead) % Q], kb + kAhead);
        const float* a = a_at(kb) + g * LDA + t;
        uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* am = a + 16 * mt * LDA;
          const float av[4] = {am[0], am[8 * LDA], am[4], am[8 * LDA + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (PASSES == 3) {
              tf32::split(av[e], a_hi[mt][e], a_lo[mt][e]);
            } else {
              a_hi[mt][e] = tf32::round_rna(av[e]);
            }
          }
        }
        constexpr int G = NT % kGroup == 0 ? kGroup : NT;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += G) {
          uint32_t b_hi[G][2], b_lo[G][2];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const TfFrag b = bq[j][n0 + i];
            b_hi[i][0] = __float_as_uint(b.x);
            b_hi[i][1] = __float_as_uint(b.y);
            b_lo[i][0] = __float_as_uint(b.z);
            b_lo[i][1] = __float_as_uint(b.w);
          }
          float d[G][MT][4];
#pragma unroll
          for (int i = 0; i < G; ++i)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[i][mt][e] = 0.f;
          if constexpr (PASSES == 3) {
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                tf32::mma(d[i][mt], a_lo[mt], b_hi[i]);
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                tf32::mma(d[i][mt], a_hi[mt], b_lo[i]);
          }
#pragma unroll
          for (int i = 0; i < G; ++i)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              tf32::mma(d[i][mt], a_hi[mt], b_hi[i]);
#pragma unroll
          for (int i = 0; i < G; ++i)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[mt][n0 + i][e] += d[i][mt][e];
        }
      }
    }
  }
}

#ifdef GLOW_BF16_TILES
// #5's bfloat16 body (flow_train_fwd.cu defines GLOW_BF16_TILES in its
// GLOW_BF16 build; the other kernels' bfloat16 builds run flow_ring.cuh):
// sum = A . W over K = 16 NK16 with A in bfloat16 in shared memory, rows
// PITCH bytes apart (a_at(kb) the shared address of row 0 at depth 16 kb),
// its fragments read by ldmatrix.x4, one per m16 row tile and 16-deep step
// (mma.sync m16n8k16, bf16 x bf16 products exact); W in the layout of
// ops/coupling.py::tensor_core_layout_bf16 (uint2 [NK16][NB][32 lanes]),
// loaded kAhead steps ahead.  As in tc_gemm, every 16-deep product starts at
// zero and is added to sum in f32 (so the sums, and z, are those of the
// first bfloat16 body's, which widened A from float pairs, bit for bit):
// the tensor cores' own f32 accumulation truncates, and accumulating the
// whole depth there moved the bf16 train path's losses past
// chip_smoke.py's bar (PERF.md).
template <int MT, int NT, int NK16, int PITCH, int NB, class AAt>
__device__ __forceinline__ void tc_gemm_bf16_tiles(float (&sum)[MT][NT][4],
                                                   const AAt& a_at,
                                                   const WFrag* __restrict__ w,
                                                   int nt0) {
  constexpr int Q = kAhead + 1;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
  const WFrag* wl = w + nt0 * 32 + lane;
  WFrag bq[Q][NT];
  auto load = [&](WFrag (&dst)[NT], int kb) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      dst[nt] = __ldg(wl + (static_cast<size_t>(kb) * NB + nt) * 32);
  };
  // lane l gives row (l % 8) + 8 ((l / 8) % 2), depths 8 (l / 16) + 0..7 of
  // a 16 x 16 block: ldmatrix's matrices are then a0, a1, a2, a3
  const uint32_t lane_at =
      ((lane % 8) + 8 * ((lane / 8) % 2)) * PITCH + 16 * (lane / 16);
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < NK16) load(bq[j], j);
  for (int kb0 = 0; kb0 < NK16; kb0 += Q) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int kb = kb0 + j;
      if (kb < NK16) {
        if (kb + kAhead < NK16) load(bq[(j + kAhead) % Q], kb + kAhead);
        const uint32_t a = a_at(kb) + lane_at;
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          bf16mma::ldsm_x4(af[mt], a + 16 * mt * PITCH);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            bf16mma::mma(d, af[mt], bq[j][nt].x, bq[j][nt].y);
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[mt][nt][e] += d[e];
          }
      }
    }
  }
}
#endif

// The float32 builds' tensor-core GEMM of a warp over depth K (a multiple
// of 8): tc_gemm's 3xTF32 or one TF32 pass (PASSES).  The bfloat16 builds
// run tc_gemm_bf16_tiles (#5) or flow_ring.cuh's body (#2, #3, #4).
template <int MT, int NT, int K, int LDA, int NB, int PASSES, class AAt>
__device__ __forceinline__ void tc_product(float (&sum)[MT][NT][4],
                                           const AAt& a_at,
                                           const WFrag* __restrict__ w,
                                           int nt0) {
  tc_gemm<MT, NT, K / 8, LDA, NB, PASSES>(sum, a_at, w, nt0);
}

// epilogue(row, column, v, v') for every pair of neighbouring columns of a
// warp's tc_gemm result (rows 16 mt + g and + 8, columns 8 (nt0 + nt) + 2 t)
template <int MT, int NT, class Epilogue>
__device__ __forceinline__ void tc_epilogue(const float (&sum)[MT][NT][4],
                                            int nt0, const Epilogue& epilogue) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        epilogue(16 * mt + g + 8 * half, 8 * (nt0 + nt) + 2 * t,
                 sum[mt][nt][2 * half], sum[mt][nt][2 * half + 1]);
}

// ---------------------------------------------------------------------------
// the live tiles of a ragged batch
// ---------------------------------------------------------------------------

// A persistent launch's work item: tile `index` of sample b, which holds a
// frame before the sample's last valid one (live) or not (dead: every
// output there is zero, and the tile is not computed).
struct TileId {
  int b, index;
  bool live;
};

// The items of a launch over B samples of n_tiles tiles each: the live tiles
// first (sample by sample, tile by tile), then the dead ones, so that a grid
// walking them in steps of its size deals the live tiles out evenly.
// before[b] is the number of live tiles of the samples before b.  The plain
// twin is ops/coupling.py::live_tile_schedule.
struct LiveTiles {
  const int* before;   // [B + 1], in shared memory
  const int* length;   // [B]: one past each sample's last valid frame
  int B, n_tiles, live, items;

  __device__ TileId at(int item) const {
    // the last sample whose first item (live, or dead) is at most `item`
    int lo = 0, hi = B - 1;
    if (item < live) {
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (before[mid] <= item) lo = mid; else hi = mid - 1;
      }
      return {lo, item - before[lo], true};
    }
    const int dead = item - live;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (mid * n_tiles - before[mid] <= dead) lo = mid; else hi = mid - 1;
    }
    return {lo, before[lo + 1] - before[lo] + dead - (lo * n_tiles -
                                                      before[lo]),
            false};
  }
};

// Ints of shared memory that live_tiles needs at batch size B.
HD constexpr int live_tile_ints(int B) { return 2 * B + 1; }

// Every block builds the list from the mask [B, T]: a sample's live tiles
// are those whose first owned frame lies before one past its last frame
// with a nonzero mask.  `ints` is live_tile_ints(B) ints of shared memory.
// Ends on a barrier.
template <class S>
__device__ LiveTiles live_tiles(const float* mask, int B, int T, int* ints) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* const before = ints;
  int* const length = ints + B + 1;
  for (int b = warp; b < B; b += kWarps) {
    int last = 0;
    for (int t = lane; t < T; t += 32)
      if (mask[static_cast<size_t>(b) * T + t] != 0.f) last = t + 1;
    for (int o = 16; o > 0; o >>= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if (lane == 0) {
      length[b] = last;
      before[b + 1] = ceil_div(last, S::TT);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    before[0] = 0;
    for (int b = 0; b < B; ++b) before[b + 1] += before[b];
  }
  __syncthreads();
  const int n_tiles = ceil_div(T, S::TT);
  return {before, length, B, n_tiles, before[B], B * n_tiles};
}

// What a launch over the live tiles did, reported for measuring into
// `counts` (null in production; the caller zeroes it, and launches that
// share it add up): [0] the list's live items, [1] all its items, [2] the
// live tiles the blocks computed, [3] the most one block computed (the
// rounds), [4] the blocks of the grid.  `computed` is the calling block's.
__device__ __forceinline__ void report_tiles(int* counts, int live, int items,
                                             int computed) {
  if (!counts || threadIdx.x != 0) return;
  if (blockIdx.x == 0) {
    counts[0] = live;
    counts[1] = items;
    counts[4] = gridDim.x;
  }
  atomicAdd(counts + 2, computed);
  atomicMax(counts + 3, computed);
}
__device__ __forceinline__ void report_tiles(int* counts,
                                             const LiveTiles& items,
                                             int computed) {
  report_tiles(counts, items.live, items.items, computed);
}

// ---------------------------------------------------------------------------
// one flow step on one tile
// ---------------------------------------------------------------------------

// The weights of one flow step.  w_in and w_rs enter the tensor-core GEMMs
// in the layout of ops/coupling.py::tensor_core_weights alone.
struct StepWeights {
  const float* an_logs;  // [C]
  const float* an_bias;  // [C]
  const float* mix_t;    // [C, C]
  const float* w_start;  // [C/2, CH]
  const float* b_start;  // [CH]
  const WFrag* w_in;     // [NL, KS*CH/kKStep, 2CH/8, 32], gate columns
                         // interleaved
  const WFrag* w_rs;     // [NL, CH/kKStep, 2CH/8, 32], last layer's res
                         // half zero
  const float* b_rs;     // [NL, 2CH]
  const float* w_end;    // [CH, C]
  const float* b_end;    // [C]
};

// Flow step s of a stack whose weights are stacked along a leading axis:
// `stacked` points at step 0 of each [steps, ...] tensor.
template <class S>
HD StepWeights step_of_stack(const StepWeights& stacked, int s) {
  return {stacked.an_logs + s * S::C,
          stacked.an_bias + s * S::C,
          stacked.mix_t + s * S::C * S::C,
          stacked.w_start + s * S::C2 * S::CH,
          stacked.b_start + s * S::CH,
          stacked.w_in + s * S::NL * S::W_IN_TC,
          stacked.w_rs + s * S::NL * S::W_RS_TC,
          stacked.b_rs + s * S::NL * S::CH2,
          stacked.w_end + s * S::CH * S::C,
          stacked.b_end + s * S::C};
}

// Where a saving instantiation leaves what a backward pass reads, each over
// the B*T frames, in the activations' type; ch is kSavedCh (the true ch).
struct SavePointers {
  act_t* y;     // [B*T, C]        ActNorm output, masked
  act_t* yd;    // [B*T, C]        mixing output [x_a, x_b], masked
  act_t* xin;   // [NL, B*T, ch]   input of every layer
  act_t* ts;    // [NL, B*T, 2ch]  tanh half, sigmoid half
  act_t* skip;  // [B*T, ch]       masked skip sum
  act_t* logs;  // [B*T, C/2]
};

// A block's buffers in shared memory and the tile it works on: the TT
// frames from t0 + HALO of sample b, tile number `index` of that sample;
// row r of a buffer is frame t0 + r.
template <class S>
struct Tile {
  float* xs;    // [x_rows, C]
  float* hs;    // [h_rows, HP]
  float* gs;    // the gate [rows, GP]; the mixing's and end conv's output
  float* skip;  // [span(TT), SP]
  float* ms;    // [x_rows]
  float* ts;    // [TT, TSP] saving kernels only: the owned rows' gate halves
#ifdef GLOW_BF16_TILES
  act_t* hb;    // [h_rows, HPB] h in bfloat16, in hs's room
  act_t* gb;    // the gate [rows, GPB] in bfloat16, in gs's room
#endif
  int b, index, B, T, t0;
  size_t sample;  // first frame of sample b among the B*T

  __device__ Tile(float* smem, int B_, int T_, int b_, int index_)
      : xs(smem), hs(xs + S::XS), gs(hs + S::HS), skip(gs + S::GS),
        ms(skip + S::SS), ts(smem + S::FLOATS),
#ifdef GLOW_BF16_TILES
        hb(reinterpret_cast<act_t*>(hs)), gb(reinterpret_cast<act_t*>(gs)),
#endif
        b(b_), index(index_), B(B_),
        T(T_),
        t0(index_ * S::TT - S::HALO),
        sample(static_cast<size_t>(b_) * T_) {}

  // Zero x, h, the skip sum and the mask, then load the rows of
  // mask [B, T] whose frames lie in [0, T).  load_columns calls follow,
  // then a barrier.
  __device__ void begin(const float* mask) const {
    const int tid = threadIdx.x;
    for (int i = tid; i < (S::XS + S::HS) / 4; i += kThreads)
      at4(xs + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < (S::SS + S::MS) / 4; i += kThreads)
      at4(skip + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int r = tid; r < S::R; r += kThreads) {
      const int t = t0 + r;
      if (t >= 0 && t < T) ms[r] = mask[sample + t];
    }
  }

  // Columns [col0, col0 + n) of x get the rows of src [B, T, n] whose
  // frames lie in [0, T), V (4, or 2: a float32 half at C2 = 2 mod 4)
  // elements a load; src's samples lie batch_stride floats apart and its
  // frames row_stride (multiples of V, as are col0 and n).
  template <int V = 4, class E>
  __device__ void load_columns(const E* src, size_t batch_stride,
                               size_t row_stride, int col0, int n) const {
    const E* rows = src + b * batch_stride;
    for (int i = threadIdx.x; i < S::R * (n / V); i += kThreads) {
      const int r = i / (n / V), c = V * (i % (n / V)), t = t0 + r;
      if (t >= 0 && t < T) {
        if constexpr (V == 4)
          at4(xs + r * S::C + col0 + c) = ld_act4(rows + t * row_stride + c);
        else
          at2(xs + r * S::C + col0 + c) = ld_act2(rows + t * row_stride + c);
      }
    }
  }

  // begin, then the rows of a contiguous x [B, T, C].
  template <class E>
  __device__ void load(const E* x, const float* mask) const {
    begin(mask);
    load_columns(x, static_cast<size_t>(T) * S::C, S::C, 0, S::C);
    __syncthreads();
  }

  // out[B*T, n] gets the [TT, n] block of the owned frames below T from
  // rows_c (the owned frames' rows, `pitch` apart), V (4, or 2: a half at
  // C2 = 2 mod 4) elements a store.  What is saved for a backward pass is
  // written once and read much later (190 MB a step), so it goes out with
  // streaming stores: written the plain way it pushed the weights out of L2
  // and cost a step 0.2 ms more.
  template <int V = 4, class E>
  __device__ void store_owned(E* out, const float* rows_c, int pitch,
                              int n) const {
    for (int i = threadIdx.x; i < S::TT * (n / V); i += kThreads) {
      const int r = i / (n / V), c = V * (i % (n / V));
      const int t = t0 + S::HALO + r;
      if (t < T) {
        if constexpr (V == 4)
          stcs_act4(out + (sample + t) * n + c,
                    *reinterpret_cast<const float4*>(rows_c + r * pitch + c));
        else
          stcs_act2(out + (sample + t) * n + c,
                    *reinterpret_cast<const float2*>(rows_c + r * pitch + c));
      }
    }
  }

  // out[B*T, n] gets zeros at the owned frames below `end` (at most T), V
  // (4, or 2: a float32 half at C2 = 2 mod 4) elements a store: a dead
  // tile's output.
  template <int V = 4, class E>
  __device__ void zero_owned(E* out, int n, int end) const {
    for (int i = threadIdx.x; i < S::TT * (n / V); i += kThreads) {
      const int t = t0 + S::HALO + i / (n / V), c = V * (i % (n / V));
      if (t < end) {
        if constexpr (V == 4)
          st_act4(out + (sample + t) * n + c, make_float4(0.f, 0.f, 0.f, 0.f));
        else
          st_act2(out + (sample + t) * n + c, make_float2(0.f, 0.f));
      }
    }
  }
  template <int V = 4, class E>
  __device__ void zero_owned(E* out, int n) const {
    zero_owned<V>(out, n, T);
  }
};

// WaveNet layer I and, recursively, the layers after it.
// pre_gate.layer(I, tile) gives the k-tap conv's epilogue for this layer:
// (tile row, column of the [2CH] pre-gate sum, conv sum) -> the pre-gate
// value (bias, dropout, conditioning).
template <class S, bool SAVE, int PASSES, int I, class PreGate>
__device__ __forceinline__ void wavenet_layers(const Tile<S>& tile,
                                               const StepWeights& w,
                                               const SavePointers& save,
                                               const PreGate& pre_gate) {
  constexpr int lo = S::layer_lo(I), rows = S::layer_rows(I);
  constexpr int MT = S::mt(rows), NB = S::NB, NT = S::NT;
  constexpr int CH = S::CH, CH2 = S::CH2, HP = S::HP, GP = S::GP;
  constexpr int SP = S::SP, HALO = S::HALO, TT = S::TT;
  const int warp = threadIdx.x / 32;
  float* const hs = tile.hs;
  float* const gs = tile.gs;
  float* const skip = tile.skip;
  const float* const ms = tile.ms;
  const float* const b_rs = w.b_rs + I * CH2;
  const size_t frames = static_cast<size_t>(tile.B) * tile.T;

  // the saved values' width (the true ch: kSavedCh)
  constexpr int SCH = kSavedCh;
#ifdef GLOW_BF16_TILES
  constexpr int HPB = S::HPB, GPB = S::GPB;
  act_t* const hb = tile.hb;
  act_t* const gb = tile.gb;
  if constexpr (SAVE) {
    // the owned rows of h, 16 bytes at a time as they lie
    for (int i = threadIdx.x; i < TT * (SCH / 8); i += kThreads) {
      const int r = i / (SCH / 8), c = 8 * (i % (SCH / 8));
      const int t = tile.t0 + HALO + r;
      if (t < tile.T)
        __stcs(reinterpret_cast<uint4*>(save.xin + I * frames * SCH +
                                        (tile.sample + t) * SCH + c),
               *reinterpret_cast<const uint4*>(hb + (HALO + r) * HPB + c));
    }
  }
#else
  if constexpr (SAVE)
    tile.store_owned(save.xin + I * frames * SCH, hs + HALO * HP, HP, SCH);
#endif
  {
    // k-tap conv of rows [lo, lo + rows), which read h rows [lo - PAD,
    // lo + rows + PAD): tap d of channel c is h[(row + d) * HP + c]; the
    // epilogue is the pre-gate and the gate, into the gate buffer
    float sum[MT][NT][4];
#ifdef GLOW_BF16_TILES
    const uint32_t h0 = bf16mma::smem_u32(hb + (lo - S::PAD) * HPB);
    tc_gemm_bf16_tiles<MT, NT, S::KS * CH / 16, 2 * HPB, NB>(
        sum,
        [&](int kb) {
          const int k = 16 * kb;
          return h0 + 2 * ((k / CH) * HPB + k % CH);
        },
        w.w_in + I * S::W_IN_TC, NT * warp);
#else
    const float* h0 = hs + (lo - S::PAD) * HP;
    tc_product<MT, NT, S::KS * CH, HP, NB, PASSES>(
        sum,
        [&](int kb) {
          const int k = 8 * kb;
          return h0 + (k / CH) * HP + k % CH;
        },
        w.w_in + I * S::W_IN_TC, NT * warp);
#endif
    const auto pre = pre_gate.layer(I, tile);
    tc_epilogue<MT, NT>(sum, NT * warp, [&](int r, int col, float vt,
                                            float vs) {
      if (r >= rows) return;
      // interleaved columns: 2c and 2c + 1 are channel c's tanh and
      // sigmoid halves, columns c and CH + c of the pre-gate sum
      const int c = col / 2, row = lo + r;
      const float th = tanhf(pre(row, c, vt));
      const float sg = sigmoidf(pre(row, CH + c, vs));
#ifdef GLOW_BF16_TILES
      gb[r * GPB + c] = __float2bfloat16_rn(th * sg);
#else
      gs[r * GP + c] = act_round(th * sg);
#endif
      if constexpr (SAVE) {
        // the saved row [tanh, sigmoid], each half SCH wide (a padded
        // channel's halves are not stored): staged, or where the block has
        // no room for the stage, stored from here
        const int own = row - HALO;
        if (own >= 0 && own < TT && (SCH == CH || c < SCH)) {
          if constexpr (stages_saves<S>()) {
            tile.ts[own * S::TSP + c] = th;
            tile.ts[own * S::TSP + SCH + c] = sg;
          } else {
            const int t = tile.t0 + row;
            if (t < tile.T) {
              act_t* const out = save.ts + I * frames * 2 * SCH +
                                 (tile.sample + t) * 2 * SCH;
              out[c] = to_act(th, out);
              out[SCH + c] = to_act(sg, out);
            }
          }
        }
      }
    });
  }
  __syncthreads();
  if constexpr (SAVE && stages_saves<S>())
    tile.store_owned(save.ts + I * frames * 2 * SCH, tile.ts, S::TSP,
                     2 * SCH);
  if constexpr (I < S::NL - 1) {
    // res half updates h in place (this GEMM reads only the gate); skip
    // half accumulates on the central rows
    float sum[MT][NT][4];
#ifdef GLOW_BF16_TILES
    const uint32_t g0 = bf16mma::smem_u32(gb);
    tc_gemm_bf16_tiles<MT, NT, CH / 16, 2 * GPB, NB>(
        sum, [&](int kb) { return g0 + 32 * kb; }, w.w_rs + I * S::W_RS_TC,
        NT * warp);
#else
    tc_product<MT, NT, CH, GP, NB, PASSES>(
        sum, [&](int kb) { return gs + 8 * kb; },
        w.w_rs + I * S::W_RS_TC, NT * warp);
#endif
    tc_epilogue<MT, NT>(sum, NT * warp, [&](int r, int col, float v0,
                                            float v1) {
      if (r >= rows) return;
      const int row = lo + r;
      v0 += __ldg(b_rs + col);
      v1 += __ldg(b_rs + col + 1);
      if (col < CH) {
#ifdef GLOW_BF16_TILES
        uint32_t& h = *reinterpret_cast<uint32_t*>(hb + row * HPB + col);
        h = pack_bf16((bf16_lo(h) + v0) * ms[row], (bf16_hi(h) + v1) * ms[row]);
#else
        float2& h = at2(hs + row * HP + col);
        h = make_float2(act_round((h.x + v0) * ms[row]),
                        act_round((h.y + v1) * ms[row]));
#endif
      } else if (row >= HALO && row < HALO + TT) {
        float2& s = at2(skip + (row - HALO) * SP + col - CH);
        s = make_float2(s.x + v0, s.y + v1);
      }
    });
    __syncthreads();
    wavenet_layers<S, SAVE, PASSES, I + 1>(tile, w, save, pre_gate);
  } else {
    // the last layer feeds the skip sum only (the n8 tiles of w_rs's skip
    // half), and its rows are the TT central ones
    static_assert(lo == HALO && rows == TT, "halo bookkeeping");
    constexpr int NTH = NT / 2;
    float sum[MT][NTH][4];
#ifdef GLOW_BF16_TILES
    const uint32_t g0 = bf16mma::smem_u32(gb);
    tc_gemm_bf16_tiles<MT, NTH, CH / 16, 2 * GPB, NB>(
        sum, [&](int kb) { return g0 + 32 * kb; }, w.w_rs + I * S::W_RS_TC,
        NB / 2 + NTH * warp);
#else
    tc_product<MT, NTH, CH, GP, NB, PASSES>(
        sum, [&](int kb) { return gs + 8 * kb; },
        w.w_rs + I * S::W_RS_TC, NB / 2 + NTH * warp);
#endif
    tc_epilogue<MT, NTH>(sum, NB / 2 + NTH * warp, [&](int r, int col,
                                                       float v0, float v1) {
      if (r >= rows) return;
      float2& s = at2(skip + r * SP + col - CH);
      s = make_float2(s.x + (v0 + __ldg(b_rs + col)),
                      s.y + (v1 + __ldg(b_rs + col + 1)));
    });
    __syncthreads();
  }
}

// The coupling's network on a loaded tile.  With PROLOGUE (the forward
// direction) first ActNorm and the channel mixing, in place on x; then the
// start 1x1 on x_a, the WaveNet and the end 1x1, which leaves [mean, logs]
// of the TT owned frames in gs [TT, C].  With SAVE the owned frames'
// intermediates go to `save` on the way.
template <class S, bool PROLOGUE, bool SAVE, int PASSES, class PreGate>
__device__ __forceinline__ void coupling_net(const Tile<S>& tile,
                                             const StepWeights& w,
                                             const SavePointers& save,
                                             const PreGate& pre_gate) {
  constexpr int C = S::C, C2 = S::C2, CH = S::CH, R = S::R, TT = S::TT;
  constexpr int HALO = S::HALO, SP = S::SP;
  const int tid = threadIdx.x;
  float* const xs = tile.xs;
  float* const hs = tile.hs;
  float* const gs = tile.gs;
  float* const skip = tile.skip;
  const float* const ms = tile.ms;

  if constexpr (PROLOGUE) {
    // [x_a, x_b] = ((an_bias + exp(an_logs)*x)*m) . mix_t * m
    for (int i = tid; i < R * C; i += kThreads) {
      const int c = i % C;
      xs[i] = act_round(
          (__ldg(w.an_bias + c) + expf(__ldg(w.an_logs + c)) * xs[i]) *
          ms[i / C]);
    }
    __syncthreads();
    if constexpr (SAVE) tile.store_owned(save.y, xs + HALO * C, C, C);
    block_gemm<S::mr(R), lane_quads(C)>(
        xs, C, C, w.mix_t, C, C / 4, [&](int r, int col, float4 v) {
          if (r < R) at4(gs + r * C + col) = scale4(v, ms[r]);
        });
    __syncthreads();
    if constexpr (kBf16) {
      // x_a goes on in bfloat16, x_b in float32
      for (int i = tid; i < R * C; i += kThreads)
        xs[i] = i % C < C2 ? act_round(gs[i]) : gs[i];
    } else {
      for (int i = tid; i < R * C; i += kThreads) xs[i] = gs[i];
    }
    __syncthreads();
    if constexpr (SAVE) tile.store_owned(save.yd, xs + HALO * C, C, C);
  }

  // start 1x1 on x_a: h = (x_a . w_start + b_start) * m, all R rows
  block_gemm<S::mr(R), lane_quads(CH), C2 % 4>(
      xs, C, C2, w.w_start, CH, CH / 4, [&](int r, int col, float4 v) {
        if (r < R)
#ifdef GLOW_BF16_TILES
          *reinterpret_cast<uint2*>(tile.hb + r * S::HPB + col) =
              pack4_bf16(scale4(add4(v, ldg4(w.b_start + col)), ms[r]));
#else
          at4(hs + r * S::HP + col) =
              act_round4(scale4(add4(v, ldg4(w.b_start + col)), ms[r]));
#endif
      });
  __syncthreads();

  wavenet_layers<S, SAVE, PASSES, 0>(tile, w, save, pre_gate);

  // end 1x1 on the masked skip sum: [mean, logs] -> gs [TT, C]
  for (int i = tid; i < TT * CH; i += kThreads) {
    float& s = skip[(i / CH) * SP + i % CH];
    s = act_round(s * ms[HALO + i / CH]);
  }
  __syncthreads();
  if constexpr (SAVE) tile.store_owned(save.skip, skip, SP, kSavedCh);
  block_gemm<S::mr(TT), lane_quads(C)>(
      skip, SP, CH, w.w_end, C, C / 4, [&](int r, int col, float4 v) {
        if (r < TT) at4(gs + r * C + col) = add4(v, ldg4(w.b_end + col));
      });
  __syncthreads();
  if constexpr (SAVE)
    tile.template store_owned<S::HV>(save.logs, gs + C2, C, C2);
}

// The forward affine on the owned frames after coupling_net: z_b = (mean +
// exp(logs) * x_b) * m.  With WHOLE, z is [B, T, C] and gets [x_a, z_b];
// without, z is [B, T, C/2] and gets z_b alone.  Returns, in thread 0
// only, the tile's sum of logs * m, added in a fixed order.
template <class S, bool WHOLE = true, class E>
__device__ __forceinline__ float affine_forward(const Tile<S>& tile, E* z) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  __shared__ float warp_sums[kWarps];
  const int tid = threadIdx.x;
  const float* const xs = tile.xs;
  const float* const acc = tile.gs;
  float part = 0.f;
  for (int i = tid; i < TT * C2; i += kThreads) {
    const int r = i / C2, c = i % C2, row = HALO + r, t = tile.t0 + row;
    const float m = tile.ms[row];
    const float mean = acc[r * C + c], logs = acc[r * C + C2 + c];
    part += logs * m;
    if (t < tile.T) {
      const float zb = (mean + expf(logs) * xs[row * C + C2 + c]) * m;
      if constexpr (WHOLE) {
        E* out = z + (tile.sample + t) * C;
        out[c] = to_act(xs[row * C + c], z);
        out[C2 + c] = to_act(zb, z);
      } else {
        z[(tile.sample + t) * C2 + c] = to_act(zb, z);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (tid % 32 == 0) warp_sums[tid / 32] = part;
  __syncthreads();
  float total = 0.f;
  if (tid == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;
}

// The deterministic in-conv epilogue: the per-sample bias row of the layer
// (the in-conv bias plus any conditioning), cond [NL, B, 2CH].  A pre-gate's
// stage(tile) runs once a tile, after the tile's rows are loaded and before
// its network: this one has nothing to stage.
struct BiasPreGate {
  const float* cond;
  struct Layer {
    const float* row;    // [2CH]
    __device__ float operator()(int, int col, float v) const {
      return v + __ldg(row + col);
    }
  };
  template <class S>
  __device__ void stage(const Tile<S>&) const {}
  template <class S>
  __device__ Layer layer(int i, const Tile<S>& tile) const {
    return {cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2};
  }
};

// Whether a block of shape S stages a flow step's w_pitch [NL, PS, 2CH]
// beside its tile's pitch rows [R, PS] (12.4 KB at the shipped shape, 6.2
// KB at PS = 1): where the buffers (and a saving stage), the live-tile
// list of kMaxBatch samples, the static arrays and that stage fit the
// block; else the epilogue reads w_pitch where it lies.
// ops/coupling.py::geometry decides the same (stage_w_pitch) and the
// library reports it.
template <class S, int PS>
HD constexpr bool stages_w_pitch() {
  return S::smem_bytes + save_stage_bytes<S>() + 4 * (2 * kMaxBatch + 1) +
             S::STATIC_BYTES + 4 * PS * (S::R + S::NL * S::CH2) <=
         static_cast<size_t>(kBlockBytes);
}

// A block's copy of its tile's pitch rows [R, PS] and, where it stages it,
// of one flow step's w_pitch, in static shared memory beside the dynamic
// buffers: only a kernel that runs PitchPreGate has it.
template <class S, int PS>
__device__ __forceinline__ float* pitch_stage() {
  __shared__ __align__(16) float
      stage[S::R * PS + (stages_w_pitch<S, PS>() ? S::NL * PS * S::CH2 : 0)];
  return stage;
}

// GR mode's in-conv epilogue (the pitch operand of
// glow_tts_tpu/ops/coupling.py::_coupling_body): BiasPreGate's per-sample
// row plus, per frame, sum_p pitch[b, t, p] * w_pitch[i][p][col] with t =
// t0 + row, for both halves of the gate.  The halo's rows read the pitch of
// their own frames, and frames outside [0, T) count as pitch 0, as the
// plain version's zero padding does.  The tile's pitch and the step's
// w_pitch are staged in shared memory once a tile, so that the epilogue,
// where the body has no registers to spare, reads no global memory for
// them.
template <int PS>
struct PitchPreGate {
  const float* cond;     // [NL, B, 2CH]
  const float* pitch;    // [B, T, PS]
  const float* w_pitch;  // [NL, PS, 2CH], this flow step's
  template <class S>
  struct Layer {
    const float* row;    // [2CH], global memory
    const float* p;      // [R, PS], staged
    const float* w;      // [PS, 2CH], staged: this layer's
    __device__ float operator()(int r, int col, float v) const {
      float term = 0.f;
#pragma unroll
      for (int q = 0; q < PS; ++q)
        term = fmaf(p[r * PS + q], w[q * S::CH2 + col], term);
      return v + __ldg(row + col) + term;
    }
  };
  // Ends on a barrier.
  template <class S>
  __device__ void stage(const Tile<S>& tile) const {
    float* const st = pitch_stage<S, PS>();
    for (int i = threadIdx.x; i < S::R * PS; i += kThreads) {
      const int t = tile.t0 + i / PS;
      st[i] = t >= 0 && t < tile.T
                  ? __ldg(pitch + (tile.sample + t) * PS + i % PS)
                  : 0.f;
    }
    if constexpr (stages_w_pitch<S, PS>())
      for (int i = threadIdx.x; i < S::NL * PS * S::CH2; i += kThreads)
        st[S::R * PS + i] = __ldg(w_pitch + i);
    __syncthreads();
  }
  template <class S>
  __device__ Layer<S> layer(int i, const Tile<S>& tile) const {
    const float* const st = pitch_stage<S, PS>();
    return {cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2, st,
            stages_w_pitch<S, PS>() ? st + S::R * PS + i * PS * S::CH2
                                    : w_pitch + i * PS * S::CH2};
  }
};

// The pre-gate of a deterministic kernel of this build: a library built
// with GLOW_PITCH (ops/cuda_build.py: GR mode's instantiations, built only
// when a pitch operand asks for them) takes the pitch operand, any other
// the bias rows alone, so the Vanilla instantiations are what they were.
#ifdef GLOW_PITCH
__device__ __forceinline__ PitchPreGate<kPitchSize> step_pre_gate(
    const float* cond, const float* pitch, const float* w_pitch) {
  return {cond, pitch, w_pitch};
}
#else
__device__ __forceinline__ BiasPreGate step_pre_gate(const float* cond,
                                                     const float*,
                                                     const float*) {
  return {cond};
}
#endif

// A block's pitch stage's bytes at shape S (0 without a pitch operand).
template <class S>
HD constexpr size_t pitch_stage_bytes() {
  return !kPitch ? 0
         : stages_w_pitch<S, kPitchSize>()
             ? 4 * kPitchSize * (S::R + S::NL * S::CH2)
             : 4 * kPitchSize * S::R;
}

// The float32 body's block: the buffers (and flow_train_fwd.cu's saving
// stage), the live-tile list of kMaxBatch samples, the static arrays and the
// pitch stage within the 227 KB
static_assert(Built::smem_bytes + save_stage_bytes<Built>() +
                      4 * (2 * kMaxBatch + 1) + Built::STATIC_BYTES +
                      pitch_stage_bytes<Built>() <=
                  static_cast<size_t>(kBlockBytes),
              "over the 227 KB block limit (ROADMAP.md B.2)");

// What a flow library (a deterministic one, or flow_train_fwd.cu's) reports
// of its build, as ops/coupling.py::geometry computes it (GEOMETRY_FIELDS,
// in order): the
// shape's macros, the pitch operand's width (0 without), then the body S's
// time tile, WaveNet width, ring slice depth and half widths (0 in the
// float32 body), dynamic buffers' bytes (a saving stage included) and
// whether it stages w_pitch.
// Writes at most n ints; returns how many it has.
template <class S>
int write_geometry(int* out, int n) {
  const int fields[] = {GLOW_CHANNELS,
                        GLOW_CH,
                        GLOW_LAYERS,
                        GLOW_KSIZE,
                        kPitch ? kPitchSize : 0,
                        S::TT,
                        S::CH,
                        S::RING_DEPTH,
                        S::HALF_SMALL,
                        S::HALF_BIG,
                        static_cast<int>(S::smem_bytes +
                                         save_stage_bytes<S>()),
                        kPitch && stages_w_pitch<S, kPitchSize>()};
  constexpr int count = sizeof(fields) / sizeof(fields[0]);
  for (int i = 0; i < n && i < count; ++i) out[i] = fields[i];
  return count;
}

// One deterministic flow step on one tile, from x [B, T, C] to z [B, T, C]:
// forward ActNorm -> mixing -> coupling, returning in thread 0 the tile's
// logdet (sum of logs * m plus ld_const per valid frame); REVERSE
// coupling^-1 -> mixing^-1 -> ActNorm^-1 with w.mix_t the inverse mixing.
// pre_gate is the in-conv epilogue (step_pre_gate).  Ends on a barrier, so
// a block may go on to another tile.
template <class S, bool REVERSE, int PASSES = 3, class PreGate, class E>
__device__ __forceinline__ float flow_step_tile(const Tile<S>& tile,
                                                const E* x,
                                                const float* mask,
                                                const PreGate& pre_gate,
                                                const StepWeights& w,
                                                const float* ld_const,
                                                E* z) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  const int tid = threadIdx.x;
  float logdet = 0.f;
  tile.load(x, mask);
  pre_gate.stage(tile);
  coupling_net<S, !REVERSE, false, PASSES>(tile, w, SavePointers{},
                                           pre_gate);

  if constexpr (!REVERSE) {
    const float total = affine_forward(tile, z);
    if (tid == 0) {
      float frames = 0.f;
      for (int r = 0; r < TT; ++r) frames += tile.ms[HALO + r];
      logdet = total + __ldg(ld_const) * frames;
    }
  } else {
    float* const xs = tile.xs;
    const float* const acc = tile.gs;
    const float* const ms = tile.ms;
    // coupling^-1 in place on x_b, then mixing^-1 and ActNorm^-1
    for (int i = tid; i < TT * C2; i += kThreads) {
      const int r = i / C2, c = i % C2, row = HALO + r;
      const float mean = acc[r * C + c], logs = acc[r * C + C2 + c];
      float& xb = xs[row * C + C2 + c];
      xb = act_round((xb - mean) * expf(-logs) * ms[row]);
    }
    __syncthreads();
    block_gemm<S::mr(TT), lane_quads(C)>(
        xs + HALO * C, C, C, w.mix_t, C, C / 4,
        [&](int r, int col, float4 v) {
          const int row = HALO + r, t = tile.t0 + row;
          if (r >= TT || t >= tile.T) return;
          const float m = ms[row];
          const float4 bias = ldg4(w.an_bias + col);
          const float4 logs = ldg4(w.an_logs + col);
          st_act4(z + (tile.sample + t) * C + col, make_float4(
              (v.x * m - bias.x) * expf(-logs.x) * m,
              (v.y * m - bias.y) * expf(-logs.y) * m,
              (v.z * m - bias.z) * expf(-logs.z) * m,
              (v.w * m - bias.w) * expf(-logs.w) * m));
        });
  }
  __syncthreads();
  return logdet;
}

// Blocks of a kernel that are resident together on the current device, at
// its dynamic shared memory.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

}  // namespace
