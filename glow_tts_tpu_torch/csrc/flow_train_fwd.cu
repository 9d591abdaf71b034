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
// (a persistent grid over the batch's live (sample, 32-frame tile) items, 8
// recomputed halo frames per side, all activations in shared memory, the
// big products on the tensor cores as 3xTF32 with weights split when
// packed; the body is flow_common.cuh's coupling_net for both) with three
// changes:
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
// Valid tiles only.  At the training shape about half of the 32 x 512
// squeezed frames lie past their sample's last valid frame; a tile whose
// first owned frame does is not computed.  Its z is written as zeros (the
// next step reads it, and the plain version is zero there) and its logdet
// as 0.  Of its saved values only the layers' inputs at the PAD frames past
// the length are written (zeros): the k-tap conv's weight gradient in
// flow_train_bwd.cu reads that far.  Nothing else there reaches a
// gradient: the backward's tile loaders zero-fill every other row at or
// past a sample's length, its column sums stop at the length, and its
// elementwise passes write rows there that no later launch reads.
//
// GR mode's pitch operand (pitch [B, T, PS], w_pitch [S, NL, PS, 2CH], PS =
// kPitchSize) is a build of its own (GLOW_PITCH), as for flow_step.cu, so
// the Vanilla instantiations do not change: the pre-gate gains sum_p
// pitch[frame, p] * w_pitch[i][p][col] after the conditioning (both are
// added after the dropout), with the tile's pitch and the layer's w_pitch
// staged in static shared memory once a tile
// (flow_common.cuh::PitchPreGate's staging;
// frames outside [0, T) staged as 0), so the epilogue, where the body has
// no registers to spare, reads no global memory for them; at a shape whose
// block has no room for w_pitch beside the saving stage (C = 256, or k = 9,
// with the shipped WaveNet) the epilogue reads w_pitch where it lies.  All
// three instantiations and the backward's recompute have it.
//
// What bounds it: arithmetic, as flow_step.cu (3.7 MFLOP per frame and
// step against a few bytes); the hash adds ~20 integer operations per
// pre-gate element, the pitch term 2 * PS * 2CH FLOP per frame and layer.
//
// A GLOW_BF16 build computes what the TPU kernel computes at dt = bfloat16:
// every step's input and output (acts) and the saved values are bfloat16,
// as the TPU kernel keeps its checkpoint in dt, which halves the bytes a
// storing step writes and the backward reads (flow_train_bwd.cu's GLOW_BF16
// build).  What bounds it at bf16: the same 3.7 MFLOP a valid frame at the
// 989 TFLOP/s bf16 peak (0.03 ms a flow step at the training shape); the
// first shared bfloat16 body of the flow kernels sat far from that: the
// layer input and the gate kept in float32 in shared memory, A fragments
// packed from float pairs by cvt at every 16-deep step.  So this
// build has a body of its own (GLOW_BF16_TILES in flow_common.cuh): h and
// the gate live in shared memory in bfloat16 (the values are bf16 already:
// the TPU kernel rounds both), their A fragments are read by ldmatrix.x4,
// and the saved layer inputs leave shared memory 16 bytes at a time as
// they lie (tc_gemm_bf16_tiles, mma.sync m16n8k16).  Each 16-deep product
// is still added into the f32 sum (one FADD an accumulator element an
// mma), so z is the first body's bit for bit: accumulating the whole depth
// in the tensor cores, whose f32 accumulation truncates, took 12 % more
// off a flow step but moved the bf16 train path's losses past
// chip_smoke.py's bar, and W two steps ahead, a further 3 % there, spills
// with the f32 adds (PERF.md).  Re-reading the weights from L1
// instead of L2 (a timing probe) took only ~15 % off, so the weight stream
// is not what bounds it; the epilogues, the f32 adds and the halo are.
// Not wgmma: its warp tile is 48 rows (the TT + halo frames) by 48 of the
// 2CH columns; a wgmma M of 64 would pad a third of the rows, and the
// transposed product (the weights as register A, h from shared memory)
// would split each channel's interleaved tanh and sigmoid columns across
// two lanes of the accumulator, where the gate's epilogue needs both in
// one.

#ifdef GLOW_BF16
#define GLOW_BF16_TILES
#endif
// every kernel of this source has the saving stage where the block has room
// for it (flow_common.cuh::stages_saves, which counts it in the block's
// budget and in whether w_pitch is staged)
#define GLOW_SAVE_STAGE

#include "dropmask.cuh"
#include "flow_common.cuh"

namespace {

// Other decoder shapes (ROADMAP.md B.2): the body computes the WaveNet at ch
// padded to kChPad, on weights, b_in, conditioning rows and pitch weights
// padded with zeros (ops/coupling.py::padded_wavenet), and stores the saved
// values at the true ch (kSavedCh), 16 bytes (bf16) or a float4 at a time;
// ops/coupling.py::train_error refuses the widths these stores do not take.
// Where the block has no room for the saving stage (flow_common.cuh::
// stages_saves: C = 200 at 8 layers of the shipped WaveNet, 3 % of the f32
// envelope), the saving kernels store each gate half from the k-tap conv's
// epilogue, an element a store, and the block drops the stage; every other
// build keeps the staged whole-row stores.
static_assert(kSavedCh % (kBf16 ? 8 : 4) == 0,
              "the saved rows' width (ROADMAP.md B.2)");

// The column of the true pre-gate sum [2ch] that column col of the padded
// one [2CH] (two halves CH wide) is: the counter of its dropout bit, as
// glow_tts_tpu's masks are laid out over the true 2ch
// (ops/dropmask.py::stack_mask).  A padded column is zero before and after
// the dropout, so its counter does not matter.  The identity at ch = CH.
template <class S>
__device__ __forceinline__ int true_column(int col) {
  if constexpr (S::CH == kSavedCh) {
    return col;
  } else {
    return col < S::CH ? col : col - (S::CH - kSavedCh);
  }
}

struct Params {
  const act_t* x;        // [B, T, C]   this step's input
  const float* mask;     // [B, T]
  const float* cond;     // [NL, B, 2CH] per-sample conditioning, or null
  const float* pitch;    // [B, T, kPitchSize], GLOW_PITCH builds only
  const float* w_pitch;  // [NL, kPitchSize, 2CH], GLOW_PITCH builds only
  const float* b_in;     // [NL, 2CH]
  StepWeights w;
  act_t* z;              // [B, T, C]
  float* ld_part;        // [B, n_tiles]
  int* tiles;            // [5] or null: report_tiles
  SavePointers save;     // kSaved and kBoth only
  dropmask::Dropout drop;
  unsigned step;         // index of this flow step in the stack
  int B, T, n_tiles;
};

// The in-conv's epilogue: bias, dropout, then the per-sample conditioning
// and, in a GLOW_PITCH build, the pitch term.  stage(tile) runs once a
// tile, after the tile's rows are loaded and before its network.
struct DropoutPreGate {
  const float* b_in;
  const float* cond;
  dropmask::Dropout drop;
  unsigned step;
#ifdef GLOW_PITCH
  // stages the tile's pitch rows and this step's w_pitch (its cond is not
  // read)
  PitchPreGate<kPitchSize> pitch;
#endif
  struct Layer {
    const float* b_in;   // [2CH]
    const float* cond;   // [2CH] or null
    dropmask::Dropout drop;
    unsigned salt, rows_per_sample, ch2;
    int b, t0;
#ifdef GLOW_PITCH
    const float* p;      // [R, kPitchSize], staged
    const float* w;      // [kPitchSize, 2CH]: this layer's, staged where
                         // the block has room
#endif
    __device__ float operator()(int row, int col, float v) const {
      v += __ldg(b_in + col);
      if (drop.enabled)
        // frames outside [0, T) draw some bits too; their rows never
        // reach an output.  The counter runs over the true 2ch.
        v *= dropmask::keep_factor(
            drop, dropmask::row_counter(b, t0 + row, rows_per_sample,
                                        2 * kSavedCh, salt) +
                      true_column<Built>(col));
      if (cond) v += __ldg(cond + col);
#ifdef GLOW_PITCH
      float term = 0.f;
#pragma unroll
      for (int q = 0; q < kPitchSize; ++q)
        term = fmaf(p[row * kPitchSize + q], w[q * ch2 + col], term);
      v += term;
#endif
      return v;
    }
  };
  template <class S>
  __device__ void stage(const Tile<S>& tile) const {
#ifdef GLOW_PITCH
    pitch.stage(tile);
#endif
  }
  template <class S>
  __device__ Layer layer(int i, const Tile<S>& tile) const {
#ifdef GLOW_PITCH
    // w_pitch staged where the block has room for it (stages_w_pitch),
    // else read where it lies
    const float* const st = pitch_stage<S, kPitchSize>();
    const float* const w =
        stages_w_pitch<S, kPitchSize>() ? st + S::R * kPitchSize
                                        : pitch.w_pitch;
#endif
    return {b_in + i * S::CH2,
            cond ? cond + (static_cast<size_t>(i) * tile.B + tile.b) * S::CH2
                 : nullptr,
            drop, dropmask::layer_salt(drop.seed, step, i, S::NL),
            static_cast<unsigned>(tile.T + S::KS - 1), S::CH2, tile.b,
            tile.t0
#ifdef GLOW_PITCH
            , st, w + i * kPitchSize * S::CH2
#endif
    };
  }
};

enum class Writes { kOutputs, kSaved, kBoth };

template <class S, Writes WRITES, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
    flow_train_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const LiveTiles items = live_tiles<S>(
      p.mask, p.B, p.T,
      reinterpret_cast<int*>(smem + S::FLOATS +
                             save_stage_bytes<S>() / sizeof(float)));
  int computed = 0;
  for (int item = blockIdx.x; item < items.items; item += gridDim.x) {
    const TileId id = items.at(item);
    const Tile<S> tile(smem, p.B, p.T, id.b, id.index);
    if (!id.live) {
      if constexpr (WRITES != Writes::kSaved) {
        tile.zero_owned(p.z, S::C);
        if (threadIdx.x == 0) p.ld_part[tile.b * p.n_tiles + tile.index] = 0.f;
      }
      if constexpr (WRITES != Writes::kOutputs) {
        // the k-tap conv's weight gradient reads every layer's input up to
        // PAD frames past the length: zero there, as the plain version is
        const int end = min(items.length[id.b] + S::PAD, p.T);
        const size_t frames = static_cast<size_t>(p.B) * p.T;
        for (int i = 0; i < S::NL; ++i)
          tile.zero_owned(p.save.xin + i * frames * kSavedCh, kSavedCh, end);
      }
      continue;
    }
    tile.load(p.x, p.mask);
    const DropoutPreGate pre_gate{p.b_in, p.cond, p.drop, p.step
#ifdef GLOW_PITCH
                                  , {nullptr, p.pitch, p.w_pitch}
#endif
    };
    pre_gate.stage(tile);
    coupling_net<S, true, WRITES != Writes::kOutputs, PASSES>(
        tile, p.w, p.save, pre_gate);
    if constexpr (WRITES != Writes::kSaved) {
      const float total = affine_forward(tile, p.z);
      if (threadIdx.x == 0) p.ld_part[tile.b * p.n_tiles + tile.index] = total;
    }
    ++computed;
    __syncthreads();   // the buffers are free for the next tile
  }
  report_tiles(p.tiles, items, computed);
}

template <class S, Writes WRITES, int PASSES = 3>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = S::smem_bytes + save_stage_bytes<S>() +
                      sizeof(int) * live_tile_ints(p.B);
  int blocks = 0;
  const cudaError_t err = resident_blocks(
      flow_train_fwd_kernel<S, WRITES, PASSES>, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.n_tiles;
  flow_train_fwd_kernel<S, WRITES, PASSES>
      <<<items < blocks ? items : blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int glow_flow_train_time_tile() { return Built::TT; }

// The flow's channel count this library is built for (GLOW_CHANNELS).
int glow_flow_channels() { return Built::C; }

// What the build is (flow_common.cuh::write_geometry; the dynamic buffers
// with the saving stage): ops/coupling.py::geometry(..., train=True).
int glow_flow_geometry(int* out, int n) { return write_geometry<Built>(out, n); }

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flow steps [step_begin, step_end) of a stack of stacked weights ([S, ...]
// each, shapes those of the build's geometry: C, the layers and taps, and
// the WaveNet width the body computes at, ch_pad, which w_start, b_start,
// b_in, w_rs, b_rs, w_end, w_pitch and cond come padded to where it is not
// ch; the caller checks them), one launch per step.  acts points at the input of
// step step_begin, [B, T, C], and every step writes its output behind its
// input: step s reads acts[s - step_begin] and writes acts[s - step_begin + 1];
// ld_part is [S, B, n_tiles].  With save (an array of the six pointers of
// SavePointers, in their order, each at the values of step step_begin with the
// following steps' behind them) the steps also write what the backward pass
// reads, at the true ch (SavePointers); with save and no ld_part they write
// that alone, and neither acts nor
// ld_part.  w_in and w_rs are in the tensor-core layout
// (ops/coupling.py::tensor_core_weights).  passes is 3 (3xTF32) or, for
// measuring a forward pass without save at a shipped shape
// (GLOW_SHIPPED_SHAPE), 1.  tiles is null, or 5 zeroed ints
// that receive what the launches did, the computed tiles summed over the steps
// (flow_common.cuh::report_tiles).  pitch [B, T, PS] and w_pitch [S, NL, PS,
// 2CH] are null, or with a GLOW_PITCH build not null (cudaErrorInvalidValue
// otherwise; passes is then 3).  In a GLOW_BF16 build (the entry keeps its
// name) acts and the saved values are bfloat16, w_in and w_rs in the bfloat16
// layout, and passes is 3. Returns a cudaError_t, 0 on success.
int glow_flow_train_fwd_f32(act_t* acts, const float* mask, const float* cond,
                            const float* pitch, const float* w_pitch,
                            const float* an_logs, const float* an_bias,
                            const float* mix_t, const float* w_start,
                            const float* b_start, const float* w_in,
                            const float* b_in, const float* w_rs,
                            const float* b_rs, const float* w_end,
                            const float* b_end, float* ld_part,
                            act_t* const* save, int* tiles, int B, int T,
                            int step_begin,
                            int step_end, int seed, unsigned threshold,
                            float scale, int dropout, int passes,
                            void* stream) {
  using S = Built;
  if ((pitch != nullptr) != kPitch || (w_pitch != nullptr) != kPitch)
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  const int n_tiles = ceil_div(T, S::TT);
  const size_t frames = static_cast<size_t>(B) * T;
  if (passes != 3 &&
      (passes != 1 || save || kPitch || kBf16 || !GLOW_SHIPPED_SHAPE))
    return cudaErrorInvalidValue;
  const StepWeights stacked{an_logs, an_bias, mix_t, w_start, b_start,
                            reinterpret_cast<const WFrag*>(w_in),
                            reinterpret_cast<const WFrag*>(w_rs), b_rs,
                            w_end, b_end};
  for (int s = step_begin; s < step_end; ++s) {
    Params p{};
    p.x = acts + (s - step_begin) * frames * S::C;
    p.mask = mask;
    p.cond = cond ? cond + s * (static_cast<size_t>(S::NL) * B * S::CH2)
                  : nullptr;
    p.pitch = pitch;
    p.w_pitch = kPitch ? w_pitch + s * (S::NL * kPitchSize * S::CH2)
                       : nullptr;
    p.b_in = b_in + s * S::NL * S::CH2;
    p.w = step_of_stack<S>(stacked, s);
    p.drop = dropmask::Dropout{static_cast<unsigned>(seed), threshold, scale,
                               dropout};
    p.step = static_cast<unsigned>(s);
    p.tiles = tiles;
    p.B = B;
    p.T = T;
    p.n_tiles = n_tiles;
    if (save) {
      const size_t at = (s - step_begin) * frames;
      p.save = {save[0] + at * S::C,
                save[1] + at * S::C,
                save[2] + at * S::NL * kSavedCh,
                save[3] + at * S::NL * 2 * kSavedCh,
                save[4] + at * kSavedCh,
                save[5] + at * S::C2};
    }
    if (ld_part) {
      p.z = acts + (s - step_begin + 1) * frames * S::C;
      p.ld_part = ld_part + static_cast<size_t>(s) * B * n_tiles;
    }
    const auto on = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if constexpr (!kPitch && !kBf16 && GLOW_SHIPPED_SHAPE) {
      if (passes == 1) {
        err = launch<S, Writes::kOutputs, 1>(p, on);
        if (err != cudaSuccess) return err;
        continue;
      }
    }
    err = !save ? launch<S, Writes::kOutputs>(p, on)
          : ld_part ? launch<S, Writes::kBoth>(p, on)
                    : launch<S, Writes::kSaved>(p, on);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
