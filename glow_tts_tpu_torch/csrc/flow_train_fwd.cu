// The train-direction forward flow of the Glow-TTS decoder, float32: every
// flow step is ActNorm -> [C, C] mixing -> WaveNet affine coupling with
// dropout inside the WaveNet, the WaveNet logdet per sample, and each
// step's input kept as the checkpoint the backward pass restarts from.
//
// Replaces glow_tts_tpu/ops/coupling_grad.py::_make_train_fwd_kernel (the
// Pallas kernel behind _fwd_call and fused_flow_stack_train).  The plain
// PyTorch version of the same function is
// glow_tts_tpu_torch/ops/coupling_grad.py::flow_stack_train_reference.
//
// Design.  The TPU kernel is one call over (batch blocks, flow steps) with
// the activations resident on chip; here one launch per flow step reads
// acts[s] and writes acts[s + 1], so the "checkpoint" is simply every
// step's input left in device memory.  A launch is flow_step.cu's forward
// (one block per (sample, 32-frame tile), 8 recomputed halo frames per
// side, all activations in shared memory, see there; the body is
// flow_common.cuh's coupling_net for both) with three changes:
// * the in-conv bias is its own operand and dropout multiplies conv + bias
//   before the per-sample conditioning is added;
// * the dropout factor of an element is a hash of (seed, step, layer,
//   sample * (T + k - 1) + frame, channel) (dropmask.cuh): a halo frame
//   draws the bits of the tile that owns it, and the backward pass draws
//   them again, so no mask is stored;
// * the logdet is the WaveNet's alone (sum of logs over valid frames); the
//   per-frame ActNorm and mixing constants are added by the caller in
//   plain PyTorch, where autograd carries their gradients.
// The kernel has three instantiations (Writes).  kOutputs is the forward
// pass of a call that needs no gradient.  kSaved writes, for the frames a
// tile owns, what the backward kernels read (the ActNorm and mixing
// outputs, every layer's input and gate halves, the masked skip sum and
// logs) and neither z nor the logdet: the backward pass's recompute of one
// step from its checkpoint.  kBoth is the forward pass of a call that will
// be differentiated and whose saved values fit in device memory (190 MB a
// step at 32 x 512 frames against 80 GB): it writes z, the logdet and the
// saved values of every step, so the backward pass recomputes nothing.
// kSaved and kBoth run the same device code for the saved values, so the
// two give the backward kernels the same bits.
//
// What bounds it: arithmetic, as flow_step.cu (3.7 MFLOP per frame and
// step against a few bytes); the hash adds ~20 integer operations per
// pre-gate element, about 1 % of the step's FMAs.

#include "dropmask.cuh"
#include "flow_common.cuh"

namespace {

struct Params {
  const float* x;        // [B, T, C]   this step's input
  const float* mask;     // [B, T]
  const float* cond;     // [NL, B, 2CH] per-sample conditioning, or null
  const float* b_in;     // [NL, 2CH]
  StepWeights w;
  float* z;              // [B, T, C]
  float* ld_part;        // [B, n_tiles]
  SavePointers save;     // kSaved and kBoth only
  dropmask::Dropout drop;
  unsigned step;         // index of this flow step in the stack
  int B, T, n_tiles;
};

// The in-conv's epilogue: bias, dropout, then the per-sample conditioning.
struct DropoutPreGate {
  const float* b_in;
  const float* cond;
  dropmask::Dropout drop;
  unsigned step;
  struct Layer {
    const float* b_in;   // [2CH]
    const float* cond;   // [2CH] or null
    dropmask::Dropout drop;
    unsigned salt, rows_per_sample, ch2;
    int b, t0;
    __device__ float4 operator()(int row, int col, float4 v) const {
      v = add4(v, ldg4(b_in + col));
      if (drop.enabled) {
        // frames outside [0, T) draw some bits too; their rows never
        // reach an output
        const unsigned counter = dropmask::row_counter(
            b, t0 + row, rows_per_sample, ch2, salt) + col;
        v.x *= dropmask::keep_factor(drop, counter);
        v.y *= dropmask::keep_factor(drop, counter + 1);
        v.z *= dropmask::keep_factor(drop, counter + 2);
        v.w *= dropmask::keep_factor(drop, counter + 3);
      }
      if (cond) v = add4(v, ldg4(cond + col));
      return v;
    }
  };
  template <class S>
  __device__ Layer layer(int i, const Tile<S>& tile) const {
    return {b_in + i * S::CH2,
            cond ? cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2
                 : nullptr,
            drop, dropmask::layer_salt(drop.seed, step, i, S::NL),
            static_cast<unsigned>(tile.T + S::KS - 1), S::CH2, tile.b,
            tile.t0};
  }
};

enum class Writes { kOutputs, kSaved, kBoth };

template <class S, Writes WRITES>
__global__ void __launch_bounds__(kThreads, 1)
    flow_train_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Tile<S> tile(reinterpret_cast<float*>(smem4), p.B, p.T, blockIdx.y,
                     blockIdx.x);
  tile.load(p.x, p.mask);
  coupling_net<S, true, WRITES != Writes::kOutputs>(
      tile, p.w, p.save, DropoutPreGate{p.b_in, p.cond, p.drop, p.step});
  if constexpr (WRITES != Writes::kSaved) {
    const float total = affine_forward(tile, p.z);
    if (threadIdx.x == 0) p.ld_part[tile.b * p.n_tiles + tile.index] = total;
  }
}

template <class S, Writes WRITES>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flow_train_fwd_kernel<S, WRITES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::smem_bytes));
  if (err != cudaSuccess) return err;
  flow_train_fwd_kernel<S, WRITES>
      <<<dim3(p.n_tiles, p.B), kThreads, S::smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int glow_flow_train_time_tile() { return Shipped::TT; }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flow steps [step_begin, step_end) of a stack of stacked weights ([S, ...]
// each, shapes those of Shipped: C=160, ch=192, 4 layers, k=5; the caller
// checks them), one launch per step.  acts points at the input of step
// step_begin, [B, T, C], and every step writes its output behind its
// input: step s reads acts[s - step_begin] and writes acts[s - step_begin
// + 1]; ld_part is [S, B, n_tiles].  With save (an array of the six
// pointers of SavePointers, in their order, each at the values of step
// step_begin with the following steps' behind them) the steps also write
// what the backward pass reads; with save and no ld_part they write that
// alone, and neither acts nor ld_part.
// Returns a cudaError_t, 0 on success.
int glow_flow_train_fwd_f32(float* acts, const float* mask, const float* cond,
                            const float* an_logs, const float* an_bias,
                            const float* mix_t, const float* w_start,
                            const float* b_start, const float* w_in,
                            const float* b_in, const float* w_rs,
                            const float* b_rs, const float* w_end,
                            const float* b_end, float* ld_part,
                            float* const* save, int B, int T, int step_begin,
                            int step_end, int seed, unsigned threshold,
                            float scale, int dropout, void* stream) {
  using S = Shipped;
  if (B <= 0 || T <= 0) return cudaSuccess;
  const int n_tiles = ceil_div(T, S::TT);
  const size_t frames = static_cast<size_t>(B) * T;
  const StepWeights stacked{an_logs, an_bias, mix_t, w_start, b_start,
                            w_in, w_rs, b_rs, w_end, b_end};
  for (int s = step_begin; s < step_end; ++s) {
    Params p{};
    p.x = acts + (s - step_begin) * frames * S::C;
    p.mask = mask;
    p.cond = cond ? cond + s * (static_cast<size_t>(S::NL) * B * S::CH2)
                  : nullptr;
    p.b_in = b_in + s * S::NL * S::CH2;
    p.w = step_of_stack<S>(stacked, s);
    p.drop = dropmask::Dropout{static_cast<unsigned>(seed), threshold, scale,
                               dropout};
    p.step = static_cast<unsigned>(s);
    p.B = B;
    p.T = T;
    p.n_tiles = n_tiles;
    if (save) {
      const size_t at = (s - step_begin) * frames;
      p.save = {save[0] + at * S::C,
                save[1] + at * S::C,
                save[2] + at * S::NL * S::CH,
                save[3] + at * S::NL * S::CH2,
                save[4] + at * S::CH,
                save[5] + at * S::C2};
    }
    if (ld_part) {
      p.z = acts + (s - step_begin + 1) * frames * S::C;
      p.ld_part = ld_part + static_cast<size_t>(s) * B * n_tiles;
    }
    const auto on = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        !save ? launch<S, Writes::kOutputs>(p, on)
              : ld_part ? launch<S, Writes::kBoth>(p, on)
                        : launch<S, Writes::kSaved>(p, on);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
