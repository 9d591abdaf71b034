// The WaveNet affine coupling of the Glow-TTS decoder alone, as one kernel,
// float32 throughout: start 1x1 on x_a -> gated k-tap layers -> end 1x1 ->
// z_b = (mean + exp(logs) * x_b) * m with the logdet, or on the inverse
// pass z_b = (x_b - mean) * exp(-logs) * m.
//
// Replaces glow_tts_tpu/ops/coupling.py::_make_kernel(flowstep=False), the
// Pallas kernel behind fused_coupling.  The plain PyTorch version of the
// same function is glow_tts_tpu_torch/ops/coupling.py::coupling_reference.
//
// Design: flow_step.cu's (32-frame tiles with a recomputed halo, all
// activations in shared memory, the big products on the tensor cores as
// 3xTF32 with weights split when packed; the network is the same
// flow_common.cuh::coupling_net) without the ActNorm/mixing prologue and
// epilogue.  What differs:
// * one block per (sample, tile), every tile computed: no live-tile list;
// * x_a and x_b come from two pointers, each with its own strides between
//   samples and frames, because the caller hands over the two halves of one
//   [B, T, C] tensor, which are not contiguous: the kernel reads them where
//   they lie instead of having them copied first.
// * Only z_b [B, T, C/2] is written; x_a passes through the coupling
//   unchanged and the caller concatenates.
// * The forward logdet has no per-frame constant: the tile's sum of
//   logs * m, written per (sample, tile) and summed by the caller.
//
// What bounds it: arithmetic, as flow_step.cu (it drops only the mixing
// matmul, 51 of a step's 3,609 kFLOP per frame).

#include "flow_common.cuh"

namespace {

struct Strided {
  const float* data;     // [B, T, C/2], unit stride along channels
  size_t batch_stride, row_stride;
};

struct Params {
  Strided x_a, x_b;
  const float* mask;     // [B, T]
  const float* cond;     // [NL, B, 2CH] per-layer bias: in-conv bias (+ cond.)
  StepWeights w;         // an_logs, an_bias and mix_t unused (null)
  float* z_b;            // [B, T, C/2]
  float* ld_part;        // [B, n_tiles], forward only
  int B, T, n_tiles;
};

template <class S, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1) coupling_kernel(const Params p) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  extern __shared__ float4 smem4[];
  const Tile<S> tile(reinterpret_cast<float*>(smem4), p.B, p.T, blockIdx.y,
                     blockIdx.x);
  tile.begin(p.mask);
  tile.load_columns(p.x_a.data, p.x_a.batch_stride, p.x_a.row_stride, 0, C2);
  tile.load_columns(p.x_b.data, p.x_b.batch_stride, p.x_b.row_stride, C2, C2);
  __syncthreads();
  coupling_net<S, false, false, 3>(tile, p.w, SavePointers{},
                                   BiasPreGate{p.cond});

  if constexpr (!REVERSE) {
    const float total = affine_forward<S, false>(tile, p.z_b);
    if (threadIdx.x == 0)
      p.ld_part[tile.b * p.n_tiles + tile.index] = total;
  } else {
    const float* const xs = tile.xs;
    const float* const acc = tile.gs;
    for (int i = threadIdx.x; i < TT * C2; i += kThreads) {
      const int r = i / C2, c = i % C2, row = HALO + r, t = tile.t0 + row;
      if (t >= p.T) continue;
      const float mean = acc[r * C + c], logs = acc[r * C + C2 + c];
      p.z_b[(tile.sample + t) * C2 + c] =
          (xs[row * C + C2 + c] - mean) * expf(-logs) * tile.ms[row];
    }
  }
}

template <class S, bool REVERSE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coupling_kernel<S, REVERSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::smem_bytes));
  if (err != cudaSuccess) return err;
  coupling_kernel<S, REVERSE>
      <<<dim3(p.n_tiles, p.B), kThreads, S::smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int glow_coupling_time_tile() { return Shipped::TT; }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shapes are those of Shipped (C=160, ch=192, 4 layers, k=5), w_in and
// w_rs in the tensor-core layout; the caller checks them, and that the
// strides (in floats) and pointers of x_a and x_b are multiples of 4
// floats.  Returns a cudaError_t, 0 on success.
int glow_coupling_f32(const float* x_a, long long a_batch_stride,
                      long long a_row_stride, const float* x_b,
                      long long b_batch_stride, long long b_row_stride,
                      const float* mask, const float* cond,
                      const float* w_start, const float* b_start,
                      const float* w_in, const float* w_rs, const float* b_rs,
                      const float* w_end, const float* b_end, float* z_b,
                      float* ld_part, int B, int T, int reverse,
                      void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Params p{{x_a, static_cast<size_t>(a_batch_stride),
                  static_cast<size_t>(a_row_stride)},
                 {x_b, static_cast<size_t>(b_batch_stride),
                  static_cast<size_t>(b_row_stride)},
                 mask, cond,
                 {nullptr, nullptr, nullptr, w_start, b_start,
                  reinterpret_cast<const WFrag*>(w_in),
                  reinterpret_cast<const WFrag*>(w_rs), b_rs, w_end, b_end},
                 z_b, ld_part, B, T, ceil_div(T, Shipped::TT)};
  auto s = static_cast<cudaStream_t>(stream);
  return reverse ? launch<Shipped, true>(p, s) : launch<Shipped, false>(p, s);
}

}  // extern "C"
