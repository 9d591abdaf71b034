// The whole flow stack of the Glow-TTS decoder (S x [ActNorm -> mixing ->
// WaveNet affine coupling], the steps in reverse order on the inverse pass)
// as one kernel launch, float32 throughout.
//
// Replaces glow_tts_tpu/ops/coupling.py::_make_mega_kernel, the Pallas
// kernel behind fused_flow_stack.  The plain PyTorch version of the same
// function is glow_tts_tpu_torch/ops/coupling.py::flow_stack_reference.
//
// Design.  The TPU kernel keeps a batch block's whole time axis on chip
// across the steps.  An SM cannot: one sample's [512, 160] activation is
// 328 KB against 227 KB of shared memory, of which a step's working set
// takes 138 KB, and step j + 1's tile needs 8 halo frames of step j's
// output from the tiles beside it.  So this is a persistent cooperative
// kernel:
// * the grid is as many blocks as are resident together (one per SM at
//   this size, asked of the occupancy calculator), launched
//   with cudaLaunchCooperativeKernel, which refuses a grid that is not;
// * each block owns a fixed list of (sample, 32-frame tile) items, item i
//   going to block i mod grid, and runs flow_step.cu's body
//   (flow_common.cuh::flow_step_tile) on each of them, step after step;
// * the activation goes from step to step through two [B, T, C] buffers
//   in device memory, read through L2 (2 x 10.5 MB at B = 32, T = 512: the
//   50 MB L2 holds them).  A step never writes the buffer it reads, since
//   a neighbour may still be reading its halo there; the last step writes
//   the result tensor, so nothing is copied;
// * a grid-wide barrier separates the steps: a counter in device memory
//   that every block adds to after a fence and spins on until all have.
//   It only counts up within a launch and is cleared before each.  A block
//   that waits longer than a second traps, so a fault is an error and not
//   a hang;
// * step j's weights are step j's (reverse: S - 1 - j's) slices of the
//   stacked tensors;
// * the forward logdet is kept per item and added over the steps in step
//   order by the one block that owns the item; the caller sums over tiles.
//   No atomics touch a value, so the same inputs give the same bits.
//
// What bounds it: arithmetic, S times flow_step.cu's; a step's trip
// through device memory, which the TPU kernel exists to save, is 21 MB
// against 59 GFLOP here.

#include "flow_common.cuh"

namespace {

struct Params {
  const float* x;        // [B, T, C]
  const float* mask;     // [B, T]
  const float* cond;     // [steps, NL, B, 2CH]
  StepWeights w;         // step 0 of each stacked [steps, ...] tensor
  const float* ld_const; // [steps], forward only
  float* z;              // [B, T, C] the result: the last step writes it
  float* other;          // [B, T, C] the second buffer (unused at 1 step)
  float* ld_part;        // [B, n_tiles], forward only
  unsigned* barrier;     // [1], zero at launch
  int B, T, n_tiles, steps;
};

constexpr long long kBarrierTimeoutCycles = 1LL << 31;   // over a second

// Every block of the grid calls this the same number of times; `target`
// is the count once all have arrived at this call.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();                // this block's writes, before it arrives
    atomicAdd(counter, 1u);
    const long long start = clock64();
    while (*reinterpret_cast<volatile unsigned*>(counter) < target)
      if (clock64() - start > kBarrierTimeoutCycles) __trap();
    __threadfence();                // the others' writes, before it goes on
  }
  __syncthreads();
}

template <class S, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1)
    flow_stack_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int n_items = p.B * p.n_tiles;
  const size_t cond_step = static_cast<size_t>(S::NL) * p.B * S::CH2;
  // step j writes z if an even number of steps follow it, so the last does
  auto output = [&](int j) {
    return (p.steps - 1 - j) % 2 == 0 ? p.z : p.other;
  };
  for (int j = 0; j < p.steps; ++j) {
    const int s = REVERSE ? p.steps - 1 - j : j;
    const StepWeights w = step_of_stack<S>(p.w, s);
    const float* const in = j == 0 ? p.x : output(j - 1);
    float* const out = output(j);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Tile<S> tile(smem, p.B, p.T, item / p.n_tiles, item % p.n_tiles);
      const float logdet = flow_step_tile<S, REVERSE>(
          tile, in, p.mask, p.cond + s * cond_step, w,
          REVERSE ? nullptr : p.ld_const + s, out);
      if (!REVERSE && threadIdx.x == 0)
        p.ld_part[item] = j == 0 ? logdet : p.ld_part[item] + logdet;
    }
    if (j + 1 < p.steps) grid_barrier(p.barrier, (j + 1) * gridDim.x);
  }
}

template <class S, bool REVERSE>
cudaError_t resident(int* blocks) {
  return resident_blocks(flow_stack_kernel<S, REVERSE>, S::smem_bytes,
                         blocks);
}

template <class S, bool REVERSE>
cudaError_t launch(Params p, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = resident<S, REVERSE>(&blocks);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.n_tiles;
  const int grid = items < blocks ? items : blocks;
  err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(flow_stack_kernel<S, REVERSE>), dim3(grid),
      dim3(kThreads), args, S::smem_bytes, stream);
}

}  // namespace

extern "C" {

int glow_flow_stack_time_tile() { return Shipped::TT; }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most blocks one launch uses on the current device (a launch uses
// fewer when B * tiles is less), or minus a cudaError_t.
int glow_flow_stack_resident_blocks() {
  int blocks = 0;
  const cudaError_t err = resident<Shipped, true>(&blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// All `steps` flow steps of stacked weights ([steps, ...] each, shapes those
// of Shipped: C=160, ch=192, 4 layers, k=5, w_in and w_rs in the
// tensor-core layout; the caller checks them) in one launch.  z gets the
// result; other is a second [B, T, C] buffer (may be null at steps = 1),
// ld_part [B, tiles] and ld_const [steps] are forward only, barrier is
// one unsigned of scratch.  Returns a cudaError_t, 0 on
// success.
int glow_flow_stack_f32(const float* x, const float* mask, const float* cond,
                        const float* an_logs, const float* an_bias,
                        const float* mix_t, const float* w_start,
                        const float* b_start, const float* w_in,
                        const float* w_rs, const float* b_rs,
                        const float* w_end, const float* b_end,
                        const float* ld_const, float* z, float* other,
                        float* ld_part, unsigned* barrier, int B, int T,
                        int steps, int reverse, void* stream) {
  if (B <= 0 || T <= 0 || steps <= 0) return cudaSuccess;
  const Params p{x, mask, cond,
                 {an_logs, an_bias, mix_t, w_start, b_start,
                  reinterpret_cast<const WFrag*>(w_in),
                  reinterpret_cast<const WFrag*>(w_rs), b_rs, w_end, b_end},
                 ld_const, z, other, ld_part, barrier, B, T,
                 ceil_div(T, Shipped::TT), steps};
  auto s = static_cast<cudaStream_t>(stream);
  return reverse ? launch<Shipped, true>(p, s) : launch<Shipped, false>(p, s);
}

}  // extern "C"
