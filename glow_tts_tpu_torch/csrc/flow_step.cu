// One flow step of the Glow-TTS decoder as one kernel, float32 results.
//
// Replaces glow_tts_tpu/ops/coupling.py::_make_kernel(flowstep=True), the
// Pallas kernel behind fused_flow_step.  Forward: ActNorm -> [C, C] mixing
// matmul -> WaveNet affine coupling, with the logdet.  Reverse: coupling^-1
// -> mixing^-1 -> ActNorm^-1.  The plain PyTorch version of the same
// function is glow_tts_tpu_torch/ops/coupling.py::flow_step_reference.
//
// What bounds it on an H100: arithmetic, 3.6 MFLOP per frame (59 GFLOP at
// B = 32, T = 512) against ~30 MB of inputs, outputs and weights.  Design
// (the step's body on one tile, and how it puts the two big products on the
// tensor cores, is flow_common.cuh's):
// * a block of 256 threads owns TT = 32 output frames of one sample.  It
//   loads TT + 2*HALO rows, HALO = n_layers*(k-1)/2 being the WaveNet's
//   receptive field per side, and recomputes the halo rather than
//   exchanging it: layer i computes the rows [PAD*(i+1), R-PAD*(i+1)), a
//   window that shrinks by PAD per side and layer and ends on the TT
//   central rows.  Only those are written.
// * Frames outside [0, T) load as zero with a zero mask, which is what the
//   zero gaps between packed samples were in the TPU kernel; h is masked
//   after the start conv and after every residual update, as there.
// * All activations live in shared memory (138 KB: one block per SM).
// * Valid tiles only: the grid is persistent (as many blocks as are
//   resident) and walks the batch's live tiles first, then its dead ones
//   (flow_common.cuh::live_tiles, built in every block from the mask).  A
//   tile whose first owned frame lies at or past its sample's last valid
//   frame is not computed: the plain version is zero there, so the block
//   writes zeros to z and 0 to its logdet.  On the eval step's ragged batch
//   that is about half the tiles; the live ones are dealt out evenly.
// * The forward logdet is written per (sample, tile) and summed by the
//   caller: no atomics, so it does not depend on block order.
// * GR mode's pitch operand (pitch [B, T, PS], w_pitch [NL, PS, 2CH], PS =
//   kPitchSize, num_squeeze) is a build of its own (GLOW_PITCH:
//   flow_common.cuh::PitchPreGate), so the Vanilla instantiations do not
//   change; it adds 2 * PS * 2CH FLOP per frame and layer, and stages the
//   tile's pitch and the step's w_pitch in shared memory.
// * A GLOW_BF16 build (the bfloat16 flow step, ops/coupling.py's policy) is
//   this kernel on bfloat16 x and z with flow_common.cuh's bfloat16 body: the
//   TPU kernel at dt = bfloat16, its big products on bfloat16 tensor-core
//   operands at twice TF32's rate (one pass where the f32 build makes three).
//   That build runs a body of its own, designed for Hopper
//   (GLOW_BF16_RING, flow_ring.cuh: 48-frame tiles, bfloat16 tiles, every
//   product on wgmma with the weights staged through a ring of bulk
//   copies); it has a timed instantiation besides (glow_flow_step_timed:
//   the cycles of each phase of a tile, never launched by flow_step).
// flow_stack.cu runs the same body (flow_step_tile, or ring_flow_step_tile)
// on the same live tiles, all the steps in one launch.

#ifdef GLOW_BF16
#define GLOW_BF16_RING
#endif

#include "flow_common.cuh"
#ifdef GLOW_BF16_RING
#include "flow_ring.cuh"
#endif

namespace {

struct Params {
  const act_t* x;        // [B, T, C]
  const float* mask;     // [B, T]
  const float* cond;     // [NL, B, 2CH] per-layer bias: in-conv bias (+ cond.)
  const float* pitch;    // [B, T, kPitchSize], GLOW_PITCH builds only
  const float* w_pitch;  // [NL, kPitchSize, 2CH], GLOW_PITCH builds only
  StepWeights w;
  const float* ld_const; // [1], forward only
  act_t* z;              // [B, T, C]
  float* ld_part;        // [B, n_tiles], forward only
  int* tiles;            // [5] or null: report_tiles
  int B, T, n_tiles;
#ifdef GLOW_BF16_RING
  long long* clocks;     // [grid, kClockSlots]: the timed instantiation's
#endif
};

template <class S, bool REVERSE, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
    flow_step_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const LiveTiles items = live_tiles<S>(
      p.mask, p.B, p.T, reinterpret_cast<int*>(smem + S::FLOATS));
  int computed = 0;
  for (int item = blockIdx.x; item < items.items; item += gridDim.x) {
    const TileId id = items.at(item);
    const Tile<S> tile(smem, p.B, p.T, id.b, id.index);
    float logdet = 0.f;
    if (id.live) {
      logdet = flow_step_tile<S, REVERSE, PASSES>(
          tile, p.x, p.mask, step_pre_gate(p.cond, p.pitch, p.w_pitch), p.w,
          p.ld_const, p.z);
      ++computed;
    } else {
      tile.zero_owned(p.z, S::C);
    }
    if (!REVERSE && threadIdx.x == 0)
      p.ld_part[tile.b * p.n_tiles + tile.index] = logdet;
  }
  report_tiles(p.tiles, items, computed);
}

template <class S, bool REVERSE, int PASSES>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = S::smem_bytes + sizeof(int) * live_tile_ints(p.B);
  int blocks = 0;
  const cudaError_t err =
      resident_blocks(flow_step_kernel<S, REVERSE, PASSES>, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.n_tiles;
  flow_step_kernel<S, REVERSE, PASSES>
      <<<items < blocks ? items : blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

#ifdef GLOW_BF16_RING
// The bfloat16 build's kernel: the same walk over the live tiles on
// flow_ring.cuh's body, its ring and buffers set up once a block.
template <class S, bool REVERSE, bool TIMED>
__global__ void __launch_bounds__(kThreads, 1)
    flow_step_ring_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  Ring ring;
  char* const aligned = ring_block<S>(smem4, ring);
  const LiveTiles items = live_tiles<S>(
      p.mask, p.B, p.T, reinterpret_cast<int*>(aligned + S::BYTES));
  const RingWeights w = ring_weights(p.w);
  PhaseClock<TIMED> clock(p.clocks);
  int computed = 0;
  for (int item = blockIdx.x; item < items.items; item += gridDim.x) {
    const TileId id = items.at(item);
    const RingTile<S> tile(aligned, p.B, p.T, id.b, id.index);
    float logdet = 0.f;
    if (id.live) {
      logdet = ring_flow_step_tile<S, REVERSE, TIMED>(
          tile, ring, p.x, p.mask, step_pre_gate(p.cond, p.pitch, p.w_pitch),
          w, p.ld_const, p.z, clock);
      ++computed;
    } else {
      tile.zero_owned(p.z);
    }
    if (!REVERSE && threadIdx.x == 0)
      p.ld_part[tile.b * p.n_tiles + tile.index] = logdet;
  }
  clock.finish();
  report_tiles(p.tiles, items, computed);
}

template <class S, bool REVERSE, bool TIMED>
cudaError_t launch_ring(const Params& p, cudaStream_t stream) {
  const size_t smem = S::smem_bytes + sizeof(int) * live_tile_ints(p.B);
  int blocks = 0;
  const cudaError_t err = resident_blocks(
      flow_step_ring_kernel<S, REVERSE, TIMED>, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.n_tiles;
  flow_step_ring_kernel<S, REVERSE, TIMED>
      <<<items < blocks ? items : blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}
using StepShape = RingBuilt;
#else
using StepShape = Built;
#endif

// A launch of the entry points' arguments; clocks non-null only for the
// timed instantiation of a GLOW_BF16 build.
int run_step(const act_t* x, const float* mask, const float* cond,
             const float* pitch, const float* w_pitch, const float* an_logs,
             const float* an_bias, const float* mix_t, const float* w_start,
             const float* b_start, const float* w_in, const float* w_rs,
             const float* b_rs, const float* w_end, const float* b_end,
             const float* ld_const, act_t* z, float* ld_part, int* tiles,
             int B, int T, int reverse, int passes, void* stream,
             long long* clocks) {
  if ((pitch != nullptr) != kPitch || (w_pitch != nullptr) != kPitch)
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Params p{x, mask, cond, pitch, w_pitch,
                 {an_logs, an_bias, mix_t, w_start, b_start,
                  reinterpret_cast<const WFrag*>(w_in),
                  reinterpret_cast<const WFrag*>(w_rs), b_rs, w_end, b_end},
                 ld_const, z, ld_part, tiles, B, T,
                 ceil_div(T, StepShape::TT)
#ifdef GLOW_BF16_RING
                 , clocks
#endif
  };
  auto s = static_cast<cudaStream_t>(stream);
#ifdef GLOW_BF16_RING
  if (passes != 3) return cudaErrorInvalidValue;
  if (clocks) {
#if GLOW_SHIPPED_SHAPE
    return reverse ? launch_ring<RingBuilt, true, true>(p, s)
                   : launch_ring<RingBuilt, false, true>(p, s);
#else
    return cudaErrorNotSupported;
#endif
  }
  return reverse ? launch_ring<RingBuilt, true, false>(p, s)
                 : launch_ring<RingBuilt, false, false>(p, s);
#else
  (void)clocks;
  if constexpr (kPitch || kBf16) {
    if (passes != 3) return cudaErrorInvalidValue;
  } else if (passes == 1) {
#if GLOW_SHIPPED_SHAPE
    return reverse ? launch<Built, true, 1>(p, s)
                   : launch<Built, false, 1>(p, s);
#else
    return cudaErrorNotSupported;
#endif
  }
  return reverse ? launch<Built, true, 3>(p, s)
                 : launch<Built, false, 3>(p, s);
#endif
}

}  // namespace

extern "C" {

int glow_flow_step_time_tile() { return StepShape::TT; }

// The flow's channel count this library is built for (GLOW_CHANNELS).
int glow_flow_channels() { return Built::C; }

// The geometry this library is built with (flow_common.cuh::write_geometry,
// ops/coupling.py::GEOMETRY_FIELDS): at most n ints into out; returns how
// many it has.
int glow_flow_geometry(int* out, int n) {
  return write_geometry<StepShape>(out, n);
}

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The blocks one launch uses on the current device at batch size B (fewer
// when B * tiles is less), or minus a cudaError_t.
int glow_flow_step_resident_blocks(int B) {
  int blocks = 0;
#ifdef GLOW_BF16_RING
  const cudaError_t err = resident_blocks(
      flow_step_ring_kernel<RingBuilt, true, false>,
      RingBuilt::smem_bytes + sizeof(int) * live_tile_ints(B), &blocks);
#else
  const cudaError_t err = resident_blocks(
      flow_step_kernel<Built, true, 3>,
      Built::smem_bytes + sizeof(int) * live_tile_ints(B), &blocks);
#endif
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Shapes are those of the build's geometry (glow_flow_geometry: C, ch, the
// layers and taps, and the WaveNet width the body computes at, ch_pad, which
// w_start, b_start, b_rs, w_end, w_pitch and cond come padded to where it is
// not ch); w_in and w_rs in the tensor-core layout; the caller checks them.  pitch and
// w_pitch are null, or with a GLOW_PITCH build not null (cudaErrorInvalidValue
// otherwise).  passes is 3 (3xTF32, f32 accuracy) or 1 (one TF32 pass, for
// measuring; not in a GLOW_PITCH or GLOW_BF16 build).  tiles is null, or 5
// zeroed ints that receive what the launch did (flow_common.cuh::report_tiles).
// x and z are bfloat16 in a GLOW_BF16 build (the entry keeps its name), and
// mix_t, w_start, w_in, w_rs and w_end are the ring body's packed slices
// (ops/coupling.py::ring_layout_bf16). Returns a cudaError_t, 0 on success.
int glow_flow_step_f32(const act_t* x, const float* mask, const float* cond,
                       const float* pitch, const float* w_pitch,
                       const float* an_logs, const float* an_bias,
                       const float* mix_t, const float* w_start,
                       const float* b_start, const float* w_in,
                       const float* w_rs, const float* b_rs,
                       const float* w_end, const float* b_end,
                       const float* ld_const, act_t* z, float* ld_part,
                       int* tiles, int B, int T, int reverse, int passes,
                       void* stream) {
  return run_step(x, mask, cond, pitch, w_pitch, an_logs, an_bias, mix_t,
                  w_start, b_start, w_in, w_rs, b_rs, w_end, b_end, ld_const,
                  z, ld_part, tiles, B, T, reverse, passes, stream, nullptr);
}

#ifdef GLOW_BF16_RING
// The long longs of a block's row of the timed instantiation's clocks.
int glow_flow_step_clock_slots() { return kClockSlots; }

// glow_flow_step_f32 through the timed instantiation: clocks [grid,
// glow_flow_step_clock_slots()] long longs, zeroed, grid at least the
// launch's (glow_flow_step_resident_blocks), receive each block's cycles a
// phase (flow_ring.cuh::PhaseClock).
int glow_flow_step_timed(const act_t* x, const float* mask, const float* cond,
                         const float* pitch, const float* w_pitch,
                         const float* an_logs, const float* an_bias,
                         const float* mix_t, const float* w_start,
                         const float* b_start, const float* w_in,
                         const float* w_rs, const float* b_rs,
                         const float* w_end, const float* b_end,
                         const float* ld_const, act_t* z, float* ld_part,
                         int* tiles, int B, int T, int reverse, void* stream,
                         long long* clocks) {
  if (!clocks) return cudaErrorInvalidValue;
  return run_step(x, mask, cond, pitch, w_pitch, an_logs, an_bias, mix_t,
                  w_start, b_start, w_in, w_rs, b_rs, w_end, b_end, ld_const,
                  z, ld_part, tiles, B, T, reverse, 3, stream, clocks);
}
#endif

}  // extern "C"
