// Shared device code of the flow kernels (flow_step.cu, coupling.cu,
// flow_stack.cu, flow_train_fwd.cu): the time-tile shape arithmetic, the two
// block-wide float32 GEMMs with A in shared memory, and the body of a flow
// step on one tile (coupling_net, affine_forward and, for the deterministic
// kernels, flow_step_tile), which every kernel instantiates.  See
// flow_step.cu for the design they serve.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// weight k-slices staged through shared memory by the big GEMMs.  Swept
// on an H100 80GB HBM3 at a 700 W power limit, shipped shape (kBK x
// kStages: step ms, B=32, T=512): 8x3 2.57,
// 8x4 2.36, 8x5 2.41, 16x2 2.29, 12x3 2.26 -- fewer barriers and a deeper
// lookahead both pay, up to the 227 KB shared-memory limit.
constexpr int kBK = 12;
constexpr int kStages = 3;
static_assert(kBK % 4 == 0, "A is read as float4 along k");

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
  // row pitches of h and of the pre-gate sum, padded by 4 floats so the
  // four row groups of a warp's tile read distinct banks
  static constexpr int HP = CH + 4, AP = CH2 + 4;
  static_assert(C % 8 == 0 && CH % 96 == 0 && CH % kBK == 0 && KS % 2 == 1,
                "shape");

  HD static constexpr int layer_lo(int i) { return PAD * (i + 1); }
  HD static constexpr int layer_rows(int i) { return R - 2 * PAD * (i + 1); }
  // a GEMM over `rows` rows gives each warp mr(rows) of them (staged_gemm
  // on 2CH columns too); the block computes span(rows) >= rows rows and
  // stores the first `rows`
  HD static constexpr int mr(int rows) { return ceil_div(rows, kWarps); }
  HD static constexpr int span(int rows) { return kWarps * mr(rows); }

  // buffer rows: enough for every row any GEMM reads, stored or not
  HD static constexpr int x_rows() {
    return cmax(span(R), HALO + span(TT));
  }
  HD static constexpr int h_rows() {
    int m = R;
    for (int i = 0; i < NL; ++i)
      m = cmax(m, PAD * i + span(layer_rows(i)) + KS - 1);
    return m;
  }
  HD static constexpr int acc_rows() {
    int m = cmax(span(R), span(TT));
    for (int i = 0; i < NL; ++i) m = cmax(m, span(layer_rows(i)));
    return m;
  }
  static constexpr int XS = x_rows() * C;
  static constexpr int HS = h_rows() * HP;
  static constexpr int AS = acc_rows() * cmax(AP, C);
  static constexpr int SS = span(TT) * CH;
  static constexpr int MS = ceil_div(x_rows(), 4) * 4;
  static constexpr int RS = kStages * kBK * CH2;    // weight ring
  static constexpr size_t smem_bytes =
      sizeof(float) * (XS + HS + AS + SS + MS + RS);
};

using Shipped = Shape<160, 192, 4, 5, 32>;
static_assert(Shipped::smem_bytes <= 232448, "over the 227 KB block limit");

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
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// out[rows, N] = A[rows, K] . W[K, N] for the small contractions: A in
// shared memory with row stride lda, W in global memory with row stride
// ldw.  Warp w owns the rows [w*MR, w*MR + MR); lane l owns the float4
// column groups l + 32*j (j < NV) that lie below N/4.  A loads are
// warp-wide broadcasts, W loads 512-byte coalesced rows that the block's
// eight warps share through L1.  The epilogue sees (row, first column,
// four sums) for every owned cell.
template <int MR, int NV, typename Epilogue>
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
  for (int k0 = 0; k0 < K; k0 += 4) {
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
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (owned[j])
        epilogue(warp * MR + r, 4 * (lane + 32 * j),
                 make_float4(acc[r][j][0], acc[r][j][1], acc[r][j][2],
                             acc[r][j][3]));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows each lane owns in a staged_gemm over `rows` rows, N columns.
HD constexpr int staged_mr(int rows, int n) {
  return ceil_div(rows, 4 * (kWarps / (n / 96)));
}

// out[rows, N] = A . W for the big contractions (N = 384 or 192).  Each
// kBK-row slice of W is copied once per block into a kStages-deep ring in
// shared memory (cp.async, overlapped with the math on earlier slices)
// and read from there by all warps.  The warps form a (8*96/N) x (N/96)
// grid of 96-column tiles; in a warp, lane (g = lane/8, c = lane%8) owns
// the rows (4*wr + g)*MR + i (i < MR) and the columns 96*wc + 4*c + 32*j
// (j < 3), so a W read is 128 contiguous bytes shared by four lanes and
// an A read touches four rows (pitches padded against bank conflicts).
// A may be an implicit im2col: column k of A is A[(k / kseg)*lda +
// k % kseg] relative to the row, i.e. K = taps * kseg with consecutive
// taps one row apart (kseg = K for a plain matrix).
template <int MR, int N, typename Epilogue>
__device__ __forceinline__ void staged_gemm(const float* A, int lda, int kseg,
                                            int K, const float* __restrict__ W,
                                            int ldw, float* ring,
                                            Epilogue epilogue) {
  constexpr int WC = N / 96, Q = N / 4;
  static_assert(N % 96 == 0 && kWarps % WC == 0, "warp grid");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = ((warp / WC) * 4 + lane / 8) * MR;
  const int col0 = (warp % WC) * 96 + (lane % 8) * 4;
  float acc[MR][3][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_kb = K / kBK;
  auto stage = [&](int kb) {
    float* dst = ring + (kb % kStages) * kBK * N;
    const float* src = W + static_cast<size_t>(kb) * kBK * ldw;
    for (int i = threadIdx.x; i < kBK * Q; i += kThreads)
      cp_async16(dst + (i / Q) * N + 4 * (i % Q),
                 src + (i / Q) * ldw + 4 * (i % Q));
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kb) stage(s);
    cp_async_commit();
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    cp_async_wait<kStages - 2>();   // slice kb has landed
    __syncthreads();                // and every warp is done with kb - 1
    if (kb + kStages - 1 < n_kb) stage(kb + kStages - 1);
    cp_async_commit();
    const int k = kb * kBK;
    const float* a = A + (row0 + k / kseg) * lda + k % kseg;
    const float* b = ring + (kb % kStages) * kBK * N + col0;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + i * lda + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 bv[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          bv[j] = *reinterpret_cast<const float4*>(b + (k4 + kk) * N + 32 * j);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            acc[i][j][0] = fmaf(x, bv[j].x, acc[i][j][0]);
            acc[i][j][1] = fmaf(x, bv[j].y, acc[i][j][1]);
            acc[i][j][2] = fmaf(x, bv[j].z, acc[i][j][2]);
            acc[i][j][3] = fmaf(x, bv[j].w, acc[i][j][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the next GEMM
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      epilogue(row0 + i, col0 + 32 * j,
               make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                           acc[i][j][3]));
}

// ---------------------------------------------------------------------------
// one flow step on one tile
// ---------------------------------------------------------------------------

// The weights of one flow step.
struct StepWeights {
  const float* an_logs;  // [C]
  const float* an_bias;  // [C]
  const float* mix_t;    // [C, C]
  const float* w_start;  // [C/2, CH]
  const float* b_start;  // [CH]
  const float* w_in;     // [NL, KS*CH, 2CH]
  const float* w_rs;     // [NL, CH, 2CH], last layer's res half zero
  const float* b_rs;     // [NL, 2CH]
  const float* w_end;    // [CH, C]
  const float* b_end;    // [C]
};

// Flow step s of a stack whose weights are stacked along a leading axis:
// `stacked` points at step 0 of each [steps, ...] tensor.
template <class S>
HD StepWeights step_of_stack(const StepWeights& stacked, int s) {
  const size_t big = static_cast<size_t>(s) * S::NL * S::CH * S::CH2;
  return {stacked.an_logs + s * S::C,
          stacked.an_bias + s * S::C,
          stacked.mix_t + s * S::C * S::C,
          stacked.w_start + s * S::C2 * S::CH,
          stacked.b_start + s * S::CH,
          stacked.w_in + big * S::KS,
          stacked.w_rs + big,
          stacked.b_rs + s * S::NL * S::CH2,
          stacked.w_end + s * S::CH * S::C,
          stacked.b_end + s * S::C};
}

// Where a saving instantiation leaves what a backward pass reads, each over
// the B*T frames.
struct SavePointers {
  float* y;     // [B*T, C]        ActNorm output, masked
  float* yd;    // [B*T, C]        mixing output [x_a, x_b], masked
  float* xin;   // [NL, B*T, CH]   input of every layer
  float* ts;    // [NL, B*T, 2CH]  tanh half, sigmoid half
  float* skip;  // [B*T, CH]       masked skip sum
  float* logs;  // [B*T, C/2]
};

// A block's buffers in shared memory and the tile it works on: the TT
// frames from t0 + HALO of sample b, tile number `index` of that sample;
// row r of a buffer is frame t0 + r.
template <class S>
struct Tile {
  float* xs;    // [x_rows, C]
  float* hs;    // [h_rows, HP]
  float* acc;   // [acc_rows, AP or C]
  float* skip;  // [span(TT), CH]
  float* ms;    // [x_rows]
  float* ring;  // [kStages, kBK, 2CH]
  int b, index, B, T, t0;
  size_t sample;  // first frame of sample b among the B*T

  __device__ Tile(float* smem, int B_, int T_, int b_, int index_)
      : xs(smem), hs(xs + S::XS), acc(hs + S::HS), skip(acc + S::AS),
        ms(skip + S::SS), ring(ms + S::MS), b(b_), index(index_), B(B_),
        T(T_), t0(index_ * S::TT - S::HALO),
        sample(static_cast<size_t>(b_) * T_) {}

  // Zero x, h, the skip sum and the mask, then load the rows of
  // mask [B, T] whose frames lie in [0, T).  load_columns calls follow,
  // then a barrier.
  __device__ void begin(const float* mask) const {
    const int tid = threadIdx.x;
    for (int i = tid; i < S::XS + S::HS; i += kThreads) xs[i] = 0.f;
    for (int i = tid; i < S::SS + S::MS; i += kThreads) skip[i] = 0.f;
    __syncthreads();
    for (int r = tid; r < S::R; r += kThreads) {
      const int t = t0 + r;
      if (t >= 0 && t < T) ms[r] = mask[sample + t];
    }
  }

  // Columns [col0, col0 + n) of x get the rows of src [B, T, n] whose
  // frames lie in [0, T); src's samples lie batch_stride floats apart and
  // its frames row_stride (multiples of 4, as are col0 and n).
  __device__ void load_columns(const float* src, size_t batch_stride,
                               size_t row_stride, int col0, int n) const {
    const float* rows = src + b * batch_stride;
    for (int i = threadIdx.x; i < S::R * (n / 4); i += kThreads) {
      const int r = i / (n / 4), c = 4 * (i % (n / 4)), t = t0 + r;
      if (t >= 0 && t < T)
        at4(xs + r * S::C + col0 + c) = ld_act4(rows + t * row_stride + c);
    }
  }

  // begin, then the rows of a contiguous x [B, T, C].
  __device__ void load(const float* x, const float* mask) const {
    begin(mask);
    load_columns(x, static_cast<size_t>(T) * S::C, S::C, 0, S::C);
    __syncthreads();
  }

  // out[B*T, n] gets the [TT, n] block of the owned frames below T from
  // rows_c (the owned frames' rows, `pitch` apart).  What is saved for a
  // backward pass is written once and read much later (190 MB a step), so
  // it goes out with streaming stores: written the plain way it pushed the
  // weights out of L2 and cost a step 0.2 ms more.
  __device__ void store_owned(float* out, const float* rows_c, int pitch,
                              int n) const {
    for (int i = threadIdx.x; i < S::TT * (n / 4); i += kThreads) {
      const int r = i / (n / 4), c = 4 * (i % (n / 4));
      const int t = t0 + S::HALO + r;
      if (t < T)
        __stcs(reinterpret_cast<float4*>(out + (sample + t) * n + c),
               *reinterpret_cast<const float4*>(rows_c + r * pitch + c));
    }
  }
};

// WaveNet layer I and, recursively, the layers after it.
// pre_gate.layer(I, tile) gives the conv's epilogue for this layer:
// (tile row, column, four conv sums) -> the pre-gate sums (bias, dropout,
// conditioning).
template <class S, bool SAVE, int I, class PreGate>
__device__ __forceinline__ void wavenet_layers(const Tile<S>& tile,
                                               const StepWeights& w,
                                               const SavePointers& save,
                                               const PreGate& pre_gate) {
  constexpr int lo = S::layer_lo(I), rows = S::layer_rows(I);
  constexpr int CH = S::CH, CH2 = S::CH2, HP = S::HP, AP = S::AP;
  constexpr int MR = staged_mr(rows, CH2);
  float* const hs = tile.hs;
  float* const acc = tile.acc;
  float* const skip = tile.skip;
  const float* const ms = tile.ms;
  const float* b_rs = w.b_rs + I * CH2;
  const float* w_rs = w.w_rs + static_cast<size_t>(I) * CH * CH2;
  const size_t frames = static_cast<size_t>(tile.B) * tile.T;

  if constexpr (SAVE)
    tile.store_owned(save.xin + I * frames * CH, hs + S::HALO * HP, HP, CH);
  // k-tap conv, then the layer's epilogue: rows [lo, lo + rows) read h rows
  // [lo - PAD, lo + rows + PAD)
  const auto epilogue = pre_gate.layer(I, tile);
  staged_gemm<MR, CH2>(
      hs + (lo - S::PAD) * HP, HP, CH, S::KS * CH,
      w.w_in + static_cast<size_t>(I) * S::KS * CH * CH2, CH2, tile.ring,
      [&](int r, int col, float4 v) {
        if (r < rows) at4(acc + r * AP + col) = epilogue(lo + r, col, v);
      });
  __syncthreads();
  // gate, in place over the tanh half
  float* ts_out = SAVE ? save.ts + I * frames * CH2 : nullptr;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    float* row = acc + r * AP;
    const float th = tanhf(row[c]), sg = sigmoidf(row[c + CH]);
    row[c] = th * sg;
    if constexpr (SAVE) {
      const int own = lo + r - S::HALO, t = tile.t0 + lo + r;
      if (own >= 0 && own < S::TT && t < tile.T) {
        __stcs(ts_out + (tile.sample + t) * CH2 + c, th);
        __stcs(ts_out + (tile.sample + t) * CH2 + CH + c, sg);
      }
    }
  }
  __syncthreads();
  if constexpr (I < S::NL - 1) {
    // res half updates h in place (this GEMM reads only the gate); skip
    // half accumulates on the central rows
    staged_gemm<MR, CH2>(
        acc, AP, CH, CH, w_rs, CH2, tile.ring, [&](int r, int col, float4 v) {
          if (r >= rows) return;
          const int row = lo + r;
          v = add4(v, ldg4(b_rs + col));
          if (col < CH) {
            float4& h = at4(hs + row * HP + col);
            h = scale4(add4(h, v), ms[row]);
          } else if (row >= S::HALO && row < S::HALO + S::TT) {
            float4& s = at4(skip + (row - S::HALO) * CH + col - CH);
            s = add4(s, v);
          }
        });
    __syncthreads();
    wavenet_layers<S, SAVE, I + 1>(tile, w, save, pre_gate);
  } else {
    // the last layer feeds the skip sum only, and its rows are the TT
    // central ones
    static_assert(lo == S::HALO && rows == S::TT, "halo bookkeeping");
    staged_gemm<staged_mr(rows, CH), CH>(
        acc, AP, CH, CH, w_rs + CH, CH2, tile.ring,
        [&](int r, int col, float4 v) {
          if (r >= rows) return;
          float4& s = at4(skip + r * CH + col);
          s = add4(s, add4(v, ldg4(b_rs + CH + col)));
        });
    __syncthreads();
  }
}

// The coupling's network on a loaded tile.  With PROLOGUE (the forward
// direction) first ActNorm and the channel mixing, in place on x; then the
// start 1x1 on x_a, the WaveNet and the end 1x1, which leaves [mean, logs]
// of the TT owned frames in acc [TT, C].  With SAVE the owned frames'
// intermediates go to `save` on the way.
template <class S, bool PROLOGUE, bool SAVE, class PreGate>
__device__ __forceinline__ void coupling_net(const Tile<S>& tile,
                                             const StepWeights& w,
                                             const SavePointers& save,
                                             const PreGate& pre_gate) {
  constexpr int C = S::C, C2 = S::C2, CH = S::CH, R = S::R, TT = S::TT;
  constexpr int HALO = S::HALO;
  const int tid = threadIdx.x;
  float* const xs = tile.xs;
  float* const hs = tile.hs;
  float* const acc = tile.acc;
  float* const skip = tile.skip;
  const float* const ms = tile.ms;

  if constexpr (PROLOGUE) {
    // [x_a, x_b] = ((an_bias + exp(an_logs)*x)*m) . mix_t * m
    for (int i = tid; i < R * C; i += kThreads) {
      const int c = i % C;
      xs[i] = (__ldg(w.an_bias + c) + expf(__ldg(w.an_logs + c)) * xs[i]) *
              ms[i / C];
    }
    __syncthreads();
    if constexpr (SAVE) tile.store_owned(save.y, xs + HALO * C, C, C);
    block_gemm<S::mr(R), lane_quads(C)>(
        xs, C, C, w.mix_t, C, C / 4, [&](int r, int col, float4 v) {
          if (r < R) at4(acc + r * C + col) = scale4(v, ms[r]);
        });
    __syncthreads();
    for (int i = tid; i < R * C; i += kThreads) xs[i] = acc[i];
    __syncthreads();
    if constexpr (SAVE) tile.store_owned(save.yd, xs + HALO * C, C, C);
  }

  // start 1x1 on x_a: h = (x_a . w_start + b_start) * m, all R rows
  block_gemm<S::mr(R), lane_quads(CH)>(
      xs, C, C2, w.w_start, CH, CH / 4, [&](int r, int col, float4 v) {
        if (r < R)
          at4(hs + r * S::HP + col) =
              scale4(add4(v, ldg4(w.b_start + col)), ms[r]);
      });
  __syncthreads();

  wavenet_layers<S, SAVE, 0>(tile, w, save, pre_gate);

  // end 1x1 on the masked skip sum: [mean, logs] -> acc [TT, C]
  for (int i = tid; i < TT * CH; i += kThreads) skip[i] *= ms[HALO + i / CH];
  __syncthreads();
  if constexpr (SAVE) tile.store_owned(save.skip, skip, CH, CH);
  block_gemm<S::mr(TT), lane_quads(C)>(
      skip, CH, CH, w.w_end, C, C / 4, [&](int r, int col, float4 v) {
        if (r < TT) at4(acc + r * C + col) = add4(v, ldg4(w.b_end + col));
      });
  __syncthreads();
  if constexpr (SAVE) tile.store_owned(save.logs, acc + C2, C, C2);
}

// The forward affine on the owned frames after coupling_net: z_b = (mean +
// exp(logs) * x_b) * m.  With WHOLE, z is [B, T, C] and gets [x_a, z_b];
// without, z is [B, T, C/2] and gets z_b alone.  Returns, in thread 0
// only, the tile's sum of logs * m, added in a fixed order.
template <class S, bool WHOLE = true>
__device__ __forceinline__ float affine_forward(const Tile<S>& tile,
                                                float* z) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  __shared__ float warp_sums[kWarps];
  const int tid = threadIdx.x;
  const float* const xs = tile.xs;
  const float* const acc = tile.acc;
  float part = 0.f;
  for (int i = tid; i < TT * C2; i += kThreads) {
    const int r = i / C2, c = i % C2, row = HALO + r, t = tile.t0 + row;
    const float m = tile.ms[row];
    const float mean = acc[r * C + c], logs = acc[r * C + C2 + c];
    part += logs * m;
    if (t < tile.T) {
      const float zb = (mean + expf(logs) * xs[row * C + C2 + c]) * m;
      if constexpr (WHOLE) {
        float* out = z + (tile.sample + t) * C;
        out[c] = xs[row * C + c];
        out[C2 + c] = zb;
      } else {
        z[(tile.sample + t) * C2 + c] = zb;
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
// (the in-conv bias plus any conditioning), cond [NL, B, 2CH].
struct BiasPreGate {
  const float* cond;
  struct Layer {
    const float* row;    // [2CH]
    __device__ float4 operator()(int, int col, float4 v) const {
      return add4(v, ldg4(row + col));
    }
  };
  template <class S>
  __device__ Layer layer(int i, const Tile<S>& tile) const {
    return {cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2};
  }
};

// One deterministic flow step on one tile, from x [B, T, C] to z [B, T, C]:
// forward ActNorm -> mixing -> coupling, returning in thread 0 the tile's
// logdet (sum of logs * m plus ld_const per valid frame); REVERSE
// coupling^-1 -> mixing^-1 -> ActNorm^-1 with w.mix_t the inverse mixing.
// Ends on a barrier, so a block may go on to another tile.
template <class S, bool REVERSE>
__device__ __forceinline__ float flow_step_tile(const Tile<S>& tile,
                                                const float* x,
                                                const float* mask,
                                                const float* cond,
                                                const StepWeights& w,
                                                const float* ld_const,
                                                float* z) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  const int tid = threadIdx.x;
  float logdet = 0.f;
  tile.load(x, mask);
  coupling_net<S, !REVERSE, false>(tile, w, SavePointers{}, BiasPreGate{cond});

  if constexpr (!REVERSE) {
    const float total = affine_forward(tile, z);
    if (tid == 0) {
      float frames = 0.f;
      for (int r = 0; r < TT; ++r) frames += tile.ms[HALO + r];
      logdet = total + __ldg(ld_const) * frames;
    }
  } else {
    float* const xs = tile.xs;
    const float* const acc = tile.acc;
    const float* const ms = tile.ms;
    // coupling^-1 in place on x_b, then mixing^-1 and ActNorm^-1
    for (int i = tid; i < TT * C2; i += kThreads) {
      const int r = i / C2, c = i % C2, row = HALO + r;
      const float mean = acc[r * C + c], logs = acc[r * C + C2 + c];
      float& xb = xs[row * C + C2 + c];
      xb = (xb - mean) * expf(-logs) * ms[row];
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
          at4(z + (tile.sample + t) * C + col) = make_float4(
              (v.x * m - bias.x) * expf(-logs.x) * m,
              (v.y * m - bias.y) * expf(-logs.y) * m,
              (v.z * m - bias.z) * expf(-logs.z) * m,
              (v.w * m - bias.w) * expf(-logs.w) * m);
        });
  }
  __syncthreads();
  return logdet;
}

}  // namespace
