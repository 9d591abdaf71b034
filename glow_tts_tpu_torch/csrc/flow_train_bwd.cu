// Backward of one train-direction flow step of the Glow-TTS decoder,
// float32: from the cotangent of the step's output to the cotangent of its
// input and the gradients of all of the step's weights.
//
// Replaces glow_tts_tpu/ops/coupling_grad.py::_make_train_bwd_kernel (the
// Pallas kernel behind _bwd_call, the custom_vjp of
// fused_flow_stack_train), phases 2-4; phase 1, the recompute from the
// step's checkpoint, is flow_train_fwd.cu with SAVE.  The plain PyTorch
// version is autograd of
// glow_tts_tpu_torch/ops/coupling_grad.py::flow_stack_train_reference.
//
// Design.  The TPU kernel keeps a batch block's whole step in on-chip
// memory and emits per-block weight gradients.  On this card gradients
// flow 8 frames each way through the 4 k=5 layers, so a time-tiled block
// would need a 16-frame recompute halo and four saved layer inputs beside
// it (more than 227 KB), and a per-block dW (5.9 MB for w_in) over 512
// tiles is out of the question.  So the step is a fixed sequence of small
// launches on one stream over activations the recompute left in device
// memory:
// * gemm_nt: out[M, N] = sum over taps of A[row + pad - tap, :] . W[tap]^T,
//   the activation gradients (the conv's is the 5-tap transpose), with an
//   epilogue per product: masks, the gate's backward with the regenerated
//   dropout factors, ActNorm's backward;
// * gemm_tn: dW[K, N] = sum over frames of A[frame + tap - pad, K]^T .
//   G[frame, N], the weight gradients, organised by output tile of dW and
//   split over the frames into chunks of kSplitRows; each chunk writes its
//   own partial and the caller adds the partials in their order.  Every
//   frame is counted once, and no atomics are used, so the gradients do
//   not depend on block order and two runs give the same bits;
// * column_sums: per-sample column sums (bias gradients, dcond, ActNorm).
// Both GEMMs are the same 128 x 64 tile of 256 threads, 8 x 4 outputs per
// thread, 16 deep, operands staged through shared memory, plain FMA.
//
// What bounds it: arithmetic.  dgrad and wgrad each repeat the forward's
// 3.7 MFLOP per frame, while the activations of a step (about 190 MB at
// B*T = 16,384 frames) cross device memory a few times.

#include <cuda_runtime.h>

#include <cstddef>

#include "dropmask.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 64, BK = 16;   // tile: rows, columns, depth
constexpr int TM = 8, TN = 4;               // outputs per thread
constexpr int kSplitRows = 1024;            // frames per weight-gradient chunk
static_assert((BM / TM) * (BN / TN) == kThreads, "thread grid");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc += As[:, rows of this thread]^T . Bs[:, columns of this thread] for
// one BK-deep slice: As is [BK][BM + 4], Bs is [BK][BN + 4].
__device__ __forceinline__ void tile_fma(const float (*As)[BM + 4],
                                         const float (*Bs)[BN + 4],
                                         float (&acc)[TM][TN]) {
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = ld4(&As[kk][ty * TM]), a1 = ld4(&As[kk][ty * TM + 4]);
    const float4 b = ld4(&Bs[kk][tx * TN]);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// activation gradients
// ---------------------------------------------------------------------------

// out[row, n] = sum_tap sum_k A[row + pad - tap, k] * W[tap][n, k]: rows are
// the B*T frames (a shifted row outside its sample's [0, T) is zero), A has
// row stride lda and kseg columns, W[tap] is [N, kseg] with row stride ldw
// and the taps tap_stride apart.  kseg % BK == 0; N, lda, ldw % 4 == 0.
struct NtArgs {
  const float* a;
  const float* w;
  int lda, ldw, kseg, taps, pad, tap_stride;
  int M, N, T;
};

template <class Epilogue>
__global__ void __launch_bounds__(kThreads)
    gemm_nt(const NtArgs g, const Epilogue epilogue) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[TM][TN] = {};

  for (int tap = 0; tap < g.taps; ++tap) {
    const int shift = g.pad - tap;
    const float* w_tap = g.w + static_cast<size_t>(tap) * g.tap_stride;
    for (int k0 = 0; k0 < g.kseg; k0 += BK) {
      // A: BM rows x BK, a float4 along k per load, stored k-major
      for (int i = tid; i < BM * (BK / 4); i += kThreads) {
        const int m = i / (BK / 4), kq = 4 * (i % (BK / 4));
        const int row = m0 + m;
        float4 v = zero4();
        if (row < g.M) {
          const int t = row % g.T + shift;
          if (t >= 0 && t < g.T)
            v = ld4(g.a + static_cast<size_t>(row + shift) * g.lda + k0 + kq);
        }
        As[kq][m] = v.x;
        As[kq + 1][m] = v.y;
        As[kq + 2][m] = v.z;
        As[kq + 3][m] = v.w;
      }
      for (int i = tid; i < BN * (BK / 4); i += kThreads) {
        const int n = i / (BK / 4), kq = 4 * (i % (BK / 4));
        float4 v = zero4();
        if (n0 + n < g.N)
          v = ld4(w_tap + static_cast<size_t>(n0 + n) * g.ldw + k0 + kq);
        Bs[kq][n] = v.x;
        Bs[kq + 1][n] = v.y;
        Bs[kq + 2][n] = v.z;
        Bs[kq + 3][n] = v.w;
      }
      __syncthreads();
      tile_fma(As, Bs, acc);
      __syncthreads();
    }
  }
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int col = n0 + tx * TN;
  if (col >= g.N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row < g.M)
      epilogue(row, col,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// out[row, col..] = (v + add[row, col..]) * mask[row]; add may be out
// itself (each element is read and written by one thread) or null.
struct MaskedStore {
  float* out;
  const float* add;
  const float* mask;
  int ld_out, ld_add;
  __device__ void operator()(int row, int col, float4 v) const {
    if (add) {
      const float4 a = ld4(add + static_cast<size_t>(row) * ld_add + col);
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    const float m = mask[row];
    st4(out + static_cast<size_t>(row) * ld_out + col,
        make_float4(v.x * m, v.y * m, v.z * m, v.w * m));
  }
};

// The gate's backward on dg = d(tanh . sigmoid): dacc = [dg s (1 - t^2),
// dg t s (1 - s)] (the conditioning's gradient), dpre = dacc * dropout
// factor (the conv + bias gradient).
struct GateBackward {
  const float* ts;   // [M, 2CH] tanh half, sigmoid half
  float* dpre;       // [M, 2CH]
  float* dacc;       // [M, 2CH] or null
  int ch, T;
  unsigned rows_per_sample, salt;
  dropmask::Dropout drop;
  __device__ void operator()(int row, int col, float4 dg4) const {
    const size_t base = static_cast<size_t>(row) * 2 * ch;
    const float4 t4 = ld4(ts + base + col), s4 = ld4(ts + base + ch + col);
    const float dg[4] = {dg4.x, dg4.y, dg4.z, dg4.w};
    const float t[4] = {t4.x, t4.y, t4.z, t4.w};
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    float da1[4], da2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      da1[e] = dg[e] * s[e] * (1.f - t[e] * t[e]);
      da2[e] = dg[e] * t[e] * s[e] * (1.f - s[e]);
    }
    if (dacc) {
      st4(dacc + base + col, make_float4(da1[0], da1[1], da1[2], da1[3]));
      st4(dacc + base + ch + col,
          make_float4(da2[0], da2[1], da2[2], da2[3]));
    }
    if (drop.enabled) {
      const unsigned counter = dropmask::row_counter(
          row / T, row % T, rows_per_sample, 2 * ch, salt) + col;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        da1[e] *= dropmask::keep_factor(drop, counter + e);
        da2[e] *= dropmask::keep_factor(drop, counter + ch + e);
      }
    }
    st4(dpre + base + col, make_float4(da1[0], da1[1], da1[2], da1[3]));
    st4(dpre + base + ch + col, make_float4(da2[0], da2[1], da2[2], da2[3]));
  }
};

// ActNorm's backward on v = dyd . mix: dy = v * mask; dx = dy * exp(logs);
// stats[row] = [dy, dy * exp(logs) * x], whose column sums are the
// gradients of an_bias and an_logs.
struct ActNormBackward {
  const float* x;        // [M, C] the step's input
  const float* an_logs;  // [C]
  const float* mask;     // [M]
  float* dx;             // [M, C]
  float* stats;          // [M, 2C]
  int c;
  __device__ void operator()(int row, int col, float4 v4) const {
    const float m = mask[row];
    const float4 x4 = ld4(x + static_cast<size_t>(row) * c + col);
    const float4 l4 = ld4(an_logs + col);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float lg[4] = {l4.x, l4.y, l4.z, l4.w};
    float dy[4], dxv[4], dl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dy[e] = v[e] * m;
      dxv[e] = dy[e] * expf(lg[e]);
      dl[e] = dxv[e] * xv[e];
    }
    st4(dx + static_cast<size_t>(row) * c + col,
        make_float4(dxv[0], dxv[1], dxv[2], dxv[3]));
    float* out = stats + static_cast<size_t>(row) * 2 * c;
    st4(out + col, make_float4(dy[0], dy[1], dy[2], dy[3]));
    st4(out + c + col, make_float4(dl[0], dl[1], dl[2], dl[3]));
  }
};

template <class Epilogue>
cudaError_t launch_nt(const NtArgs& g, const Epilogue& epilogue,
                      cudaStream_t stream) {
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  gemm_nt<<<grid, kThreads, 0, stream>>>(g, epilogue);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// weight gradients
// ---------------------------------------------------------------------------

// part[chunk][kd, n] = sum over the chunk's frames r of A(r, kd) * G[r, n]
// with A(r, kd) = P[r + kd / kseg - pad, kd % kseg] (zero when the shifted
// frame leaves its sample), times Q at the same place where Q is given (the
// gate t * s).  K = taps * kseg; kseg, N % 4 == 0.
struct TnArgs {
  const float* p;
  const float* q;
  const float* g;
  float* part;
  int ldp, ldg, kseg, pad;
  int K, N, M, T;
};

__global__ void __launch_bounds__(kThreads) gemm_tn(const TnArgs g) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * kSplitRows;
  const int r_end = min(r_begin + kSplitRows, g.M);
  float acc[TM][TN] = {};

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    for (int i = tid; i < BK * (BM / 4); i += kThreads) {
      const int r = i / (BM / 4), kd = k0 + 4 * (i % (BM / 4));
      const int row = r0 + r;
      float4 v = zero4();
      if (row < r_end && kd < g.K) {
        const int shift = kd / g.kseg - g.pad, t = row % g.T + shift;
        if (t >= 0 && t < g.T) {
          const size_t at =
              static_cast<size_t>(row + shift) * g.ldp + kd % g.kseg;
          v = ld4(g.p + at);
          if (g.q) {
            const float4 q = ld4(g.q + at);
            v = make_float4(v.x * q.x, v.y * q.y, v.z * q.z, v.w * q.w);
          }
        }
      }
      st4(&As[r][4 * (i % (BM / 4))], v);
    }
    for (int i = tid; i < BK * (BN / 4); i += kThreads) {
      const int r = i / (BN / 4), n = n0 + 4 * (i % (BN / 4));
      const int row = r0 + r;
      float4 v = zero4();
      if (row < r_end && n < g.N)
        v = ld4(g.g + static_cast<size_t>(row) * g.ldg + n);
      st4(&Bs[r][4 * (i % (BN / 4))], v);
    }
    __syncthreads();
    tile_fma(As, Bs, acc);
    __syncthreads();
  }
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int col = n0 + tx * TN;
  if (col >= g.N) return;
  float* out = g.part + static_cast<size_t>(blockIdx.z) * g.K * g.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kd = k0 + ty * TM + i;
    if (kd < g.K)
      st4(out + static_cast<size_t>(kd) * g.N + col,
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

cudaError_t launch_tn(const TnArgs& g, cudaStream_t stream) {
  const dim3 grid((g.K + BM - 1) / BM, (g.N + BN - 1) / BN,
                  (g.M + kSplitRows - 1) / kSplitRows);
  gemm_tn<<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// out[b, n] = sum over the T frames of sample b of x[b*T + t, n], the
// frames added in a fixed order: 8 interleaved partial sums per column.
constexpr int kSumCols = 32, kSumGroups = kThreads / kSumCols;

__global__ void __launch_bounds__(kThreads)
    column_sums(const float* x, int ldx, int N, int T, float* out) {
  __shared__ float part[kSumGroups][kSumCols];
  const int c = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const int n = blockIdx.x * kSumCols + c, b = blockIdx.y;
  float sum = 0.f;
  if (n < N)
    for (int t = grp; t < T; t += kSumGroups)
      sum += x[(static_cast<size_t>(b) * T + t) * ldx + n];
  part[grp][c] = sum;
  __syncthreads();
  if (grp == 0 && n < N) {
    float total = 0.f;
    for (int i = 0; i < kSumGroups; ++i) total += part[i][c];
    out[static_cast<size_t>(b) * N + n] = total;
  }
}

cudaError_t launch_sums(const float* x, int ldx, int N, int B, int T,
                        float* out, cudaStream_t stream) {
  column_sums<<<dim3((N + kSumCols - 1) / kSumCols, B), kThreads, 0, stream>>>(
      x, ldx, N, T, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the affine epilogue's backward, elementwise
// ---------------------------------------------------------------------------

// From dz = [dz_a, dz_b] [M, C] and the logdet cotangent dld [B]:
// douts = [dz_b m, dz_b m e^logs x_b + dld m] (the end conv's output
// gradient) and dyd[:, C/2:] = dz_b m e^logs (x_b's gradient).
__global__ void __launch_bounds__(kThreads)
    affine_backward(const float* dz, const float* dld, const float* mask,
                    const float* yd, const float* logs, float* douts,
                    float* dyd, int M, int T, int c2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M * c2) return;
  const int row = i / c2, c = i % c2;
  const size_t at = static_cast<size_t>(row) * 2 * c2;
  const float m = mask[row];
  const float dzb = dz[at + c2 + c] * m;
  const float dxb = dzb * expf(logs[i]);
  douts[at + c] = dzb;
  douts[at + c2 + c] = dxb * yd[at + c2 + c] + dld[row / T] * m;
  dyd[at + c2 + c] = dxb;
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

}  // namespace

extern "C" {

int glow_flow_train_bwd_split_rows() { return kSplitRows; }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Backward of flow step `step`.  Pointers, all float32 and contiguous, with
// M = B*T frames, c2 = C/2, ch2 = 2*ch, nsplit = ceil(M / split_rows):
//
// in[]  0 x [M,C] (the step's input)   1 y [M,C]        2 yd [M,C]
//       3 xin [n,M,ch]                 4 ts [n,M,ch2]   5 skip [M,ch]
//       6 logs [M,c2]                  7 mask [M]       8 dld [B]
//       9 dz [M,C]                    10 an_logs [C]   11 mix_t [C,C]
//      12 w_start [c2,ch]             13 w_in [n,k,ch,ch2]
//      14 w_rs [n,ch,ch2]             15 w_end [ch,C]
// out[] 0 dx [M,C]
//       scratch: 1 douts [M,C]  2 drs [M,ch2]  3 dpre [M,ch2]
//                4 dacc [M,ch2] or null (no conditioning)
//                5 dyd [M,C]    6 stats [M,2C]
//       partial weight gradients, one [K,N] per chunk of frames:
//       7 dw_end [nsplit,ch,C]        8 dw_rs [n,nsplit,ch,ch2]
//       9 dw_in [n,nsplit,k*ch,ch2]  10 dw_start [nsplit,c2,ch]
//      11 dmix [nsplit,C,C]
//       per-sample column sums:
//      12 db_end [B,C]   13 db_rs [n,B,ch2]   14 db_in [n,B,ch2]
//      15 dcond [n,B,ch2] or null    16 db_start [B,ch]
//      17 dan [B,2C] ([d an_bias, d an_logs])
// *launched receives the number of kernels the call launched (34, or 38
// with conditioning).  Returns a cudaError_t, 0 on success.
int glow_flow_train_bwd_step_f32(const float* const* in, float* const* out,
                                 int B, int T, int C, int ch, int n, int k,
                                 int step, int seed, unsigned threshold,
                                 float scale, int dropout, void* stream_ptr,
                                 int* launched) {
  *launched = 0;
  if (B <= 0 || T <= 0) return cudaSuccess;
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T, c2 = C / 2, ch2 = 2 * ch, pad = (k - 1) / 2;
  const int nsplit = (M + kSplitRows - 1) / kSplitRows;
  const size_t frames = static_cast<size_t>(M);
  const float *x = in[0], *y = in[1], *yd = in[2], *xin = in[3], *ts = in[4],
              *skip = in[5], *logs = in[6], *mask = in[7], *dld = in[8],
              *dz = in[9], *an_logs = in[10], *mix_t = in[11],
              *w_start = in[12], *w_in = in[13], *w_rs = in[14],
              *w_end = in[15];
  float *dx = out[0], *douts = out[1], *drs = out[2], *dpre = out[3],
        *dacc = out[4], *dyd = out[5], *stats = out[6], *dw_end = out[7],
        *dw_rs = out[8], *dw_in = out[9], *dw_start = out[10],
        *dmix = out[11], *db_end = out[12], *db_rs = out[13],
        *db_in = out[14], *dcond = out[15], *db_start = out[16],
        *dan = out[17];
  const dropmask::Dropout drop{static_cast<unsigned>(seed), threshold, scale,
                               dropout};

  // ---- the affine epilogue and the end conv -----------------------------
  affine_backward<<<(M * c2 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dz, dld, mask, yd, logs, douts, dyd, M, T, c2);
  LAUNCH(cudaGetLastError());
  LAUNCH(launch_tn({skip, nullptr, douts, dw_end, ch, C, ch, 0, ch, C, M, T},
                  stream));
  LAUNCH(launch_sums(douts, C, C, B, T, db_end, stream));
  // drs = [res gradient, dskip]: the res half starts at zero (the last
  // layer has no res output), dskip = (douts . w_end^T) * m for all layers
  CHECK(cudaMemsetAsync(drs, 0, frames * ch2 * sizeof(float), stream));
  LAUNCH(launch_nt({douts, w_end, C, C, C, 1, 0, 0, M, ch, T},
                  MaskedStore{drs + ch, nullptr, mask, ch2, 0}, stream));

  // ---- the WaveNet layers, last to first --------------------------------
  for (int i = n - 1; i >= 0; --i) {
    const float* ts_i = ts + i * frames * ch2;
    const float* w_in_i = w_in + static_cast<size_t>(i) * k * ch * ch2;
    const float* w_rs_i = w_rs + static_cast<size_t>(i) * ch * ch2;
    // res/skip 1x1: dW = (t*s)^T . drs, db, dgate = drs . w_rs^T
    LAUNCH(launch_tn({ts_i, ts_i + ch, drs,
                     dw_rs + static_cast<size_t>(i) * nsplit * ch * ch2, ch2,
                     ch2, ch, 0, ch, ch2, M, T},
                    stream));
    LAUNCH(launch_sums(drs, ch2, ch2, B, T,
                      db_rs + static_cast<size_t>(i) * B * ch2, stream));
    LAUNCH(launch_nt(
        {drs, w_rs_i, ch2, ch2, ch2, 1, 0, 0, M, ch, T},
        GateBackward{ts_i, dpre, dacc, ch, T,
                     static_cast<unsigned>(T + k - 1),
                     dropmask::layer_salt(drop.seed, step, i, n), drop},
        stream));
    if (dcond)
      LAUNCH(launch_sums(dacc, ch2, ch2, B, T,
                        dcond + static_cast<size_t>(i) * B * ch2, stream));
    LAUNCH(launch_sums(dpre, ch2, ch2, B, T,
                      db_in + static_cast<size_t>(i) * B * ch2, stream));
    // k-tap conv: dW[tap] = xin[frame + tap - pad]^T . dpre[frame], and the
    // input gradient dpre[frame + pad - tap] . w_in[tap]^T summed over the
    // taps; the res half of drs becomes (that + the res gradient) * m, the
    // next layer's res gradient
    LAUNCH(launch_tn({xin + i * frames * ch, nullptr, dpre,
                     dw_in + static_cast<size_t>(i) * nsplit * k * ch * ch2,
                     ch, ch2, ch, pad, k * ch, ch2, M, T},
                    stream));
    LAUNCH(launch_nt({dpre, w_in_i, ch2, ch2, ch2, k, pad, ch * ch2, M, ch, T},
                    MaskedStore{drs, drs, mask, ch2, ch2}, stream));
  }

  // ---- start conv, mixing, ActNorm ----------------------------------------
  // drs[:, :ch] is now dh = d(start conv output) * m
  LAUNCH(launch_tn({yd, nullptr, drs, dw_start, C, ch2, c2, 0, c2, ch, M, T},
                  stream));
  LAUNCH(launch_sums(drs, ch2, ch, B, T, db_start, stream));
  // dyd[:, :c2] = (dz_a + dh . w_start^T) * m
  LAUNCH(launch_nt({drs, w_start, ch2, ch, ch, 1, 0, 0, M, c2, T},
                  MaskedStore{dyd, dz, mask, C, C}, stream));
  LAUNCH(launch_tn({y, nullptr, dyd, dmix, C, C, C, 0, C, C, M, T}, stream));
  LAUNCH(launch_nt({dyd, mix_t, C, C, C, 1, 0, 0, M, C, T},
                  ActNormBackward{x, an_logs, mask, dx, stats, C}, stream));
  LAUNCH(launch_sums(stats, 2 * C, 2 * C, B, T, dan, stream));
  return cudaSuccess;
}

}  // extern "C"
