// One flow step of the Glow-TTS decoder as one kernel, float32 throughout.
//
// Replaces glow_tts_tpu/ops/coupling.py::_make_kernel(flowstep=True), the
// Pallas kernel behind fused_flow_step.  Forward: ActNorm -> [C, C] mixing
// matmul -> WaveNet affine coupling, with the logdet.  Reverse: coupling^-1
// -> mixing^-1 -> ActNorm^-1.  The plain PyTorch version of the same
// function is glow_tts_tpu_torch/ops/coupling.py::flow_step_reference.
//
// Design (see the module note in ops/coupling.py for what bounds it):
// * Grid (time tiles, batch).  A block of 256 threads owns TT output frames
//   of one sample.  It loads TT + 2*HALO rows, HALO = n_layers*(k-1)/2 being
//   the WaveNet's receptive field per side, and recomputes the halo rather
//   than exchanging it: layer i computes the rows [PAD*(i+1), R-PAD*(i+1)),
//   a window that shrinks by PAD per side and layer and ends on the TT
//   central rows.  Only those are written.
// * Frames outside [0, T) load as zero with a zero mask, which is what the
//   zero gaps between packed samples were in the TPU kernel; h is masked
//   after the start conv and after every residual update, as there.
// * All activations live in shared memory: x, the hidden h, the pre-gate
//   sum (reused for the gate, the end conv's output and the prologue's
//   mixing output) and the skip sum; with the weight ring, 221 KB at TT=32,
//   so one block per SM.
// * Every contraction is one block-wide GEMM with A in shared memory.  The
//   k-tap convs and res/skip 1x1s (~95 % of the FLOPs, staged_gemm) copy
//   each 12-row slice of W into a 3-deep shared-memory ring with cp.async;
//   the small 1x1s (block_gemm) read W through L1.  The k-tap conv needs no
//   im2col buffer: the k input rows of output row r are rows r..r+k-1 of
//   h, so tap d, channel c of A is h[(r + d)*pitch + c].
// * The forward logdet is written per (sample, tile) and summed by the
//   caller: no atomics, so it does not depend on block order.
// The step's body on one tile is flow_common.cuh's flow_step_tile, which
// flow_stack.cu runs too.

#include "flow_common.cuh"

namespace {

struct Params {
  const float* x;        // [B, T, C]
  const float* mask;     // [B, T]
  const float* cond;     // [NL, B, 2CH] per-layer bias: in-conv bias (+ cond.)
  StepWeights w;
  const float* ld_const; // [1], forward only
  float* z;              // [B, T, C]
  float* ld_part;        // [B, n_tiles], forward only
  int B, T, n_tiles;
};

template <class S, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1)
    flow_step_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Tile<S> tile(reinterpret_cast<float*>(smem4), p.B, p.T, blockIdx.y,
                     blockIdx.x);
  const float logdet = flow_step_tile<S, REVERSE>(tile, p.x, p.mask, p.cond,
                                                  p.w, p.ld_const, p.z);
  if (!REVERSE && threadIdx.x == 0)
    p.ld_part[tile.b * p.n_tiles + tile.index] = logdet;
}

template <class S, bool REVERSE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flow_step_kernel<S, REVERSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::smem_bytes));
  if (err != cudaSuccess) return err;
  flow_step_kernel<S, REVERSE>
      <<<dim3(p.n_tiles, p.B), kThreads, S::smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int glow_flow_step_time_tile() { return Shipped::TT; }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shapes are those of Shipped (C=160, ch=192, 4 layers, k=5); the caller
// checks them.  Returns a cudaError_t, 0 on success.
int glow_flow_step_f32(const float* x, const float* mask, const float* cond,
                       const float* an_logs, const float* an_bias,
                       const float* mix_t, const float* w_start,
                       const float* b_start, const float* w_in,
                       const float* w_rs, const float* b_rs,
                       const float* w_end, const float* b_end,
                       const float* ld_const, float* z, float* ld_part, int B,
                       int T, int reverse, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Params p{x, mask, cond,
                 {an_logs, an_bias, mix_t, w_start, b_start, w_in, w_rs, b_rs,
                  w_end, b_end},
                 ld_const, z, ld_part, B, T, ceil_div(T, Shipped::TT)};
  auto s = static_cast<cudaStream_t>(stream);
  return reverse ? launch<Shipped, true>(p, s) : launch<Shipped, false>(p, s);
}

}  // extern "C"
