// The WaveNet affine coupling of the Glow-TTS decoder alone, as one kernel,
// float32 results: start 1x1 on x_a -> gated k-tap layers -> end 1x1 ->
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
// * valid tiles only, as in flow_step.cu: the grid is persistent (as many
//   blocks as are resident) and walks the batch's live tiles first, then
//   its dead ones (flow_common.cuh::live_tiles, built in every block from
//   the mask).  A dead tile (its first owned frame at or past its sample's
//   last valid frame) is not computed: the plain version is zero there, so
//   the block writes zeros to z_b and 0 to its logdet;
// * x_a and x_b come from two pointers, each with its own strides between
//   samples and frames, because the caller hands over the two halves of one
//   [B, T, C] tensor, which are not contiguous: the kernel reads them where
//   they lie instead of having them copied first.
// * Only z_b [B, T, C/2] is written; x_a passes through the coupling
//   unchanged and the caller concatenates.
// * The forward logdet has no per-frame constant: the tile's sum of
//   logs * m, written per (sample, tile) and summed by the caller.
// * GR mode's pitch operand is a build of its own, as in flow_step.cu.
// * A GLOW_BF16 build is this kernel on bfloat16 x_a, x_b and z_b (the TPU
//   kernel at dt = bfloat16) on the Hopper body of flow_step.cu's bfloat16
//   build (GLOW_BF16_RING, flow_ring.cuh::ring_coupling_tile): 48-frame
//   tiles, x_a, h and the gate in bfloat16 in shared memory, every product
//   on wgmma over weight slices streamed through a ring of bulk copies
//   (ops/coupling.py::ring_weights, without the mixing's), the WaveNet and
//   the affine the flow step's own code, so that on an identity ActNorm and
//   mixing its z_b and logdet are flow_step.cu's bit for bit.  x_a (every
//   row of a tile, with its halo) and x_b (the owned rows) are read 16
//   bytes at a time through their own strides (8 or 4 where a half's rows
//   are not whole 16-byte chunks: C = 200, C = 100).  The logdet's sums stay
//   float32.  It has a timed instantiation besides (glow_coupling_timed:
//   the cycles of each phase of a tile, never launched by coupling).
//
// What bounds it: arithmetic, as flow_step.cu (it drops only the mixing
// matmul, 51 of a step's 3,609 kFLOP per frame).

#ifdef GLOW_BF16
#define GLOW_BF16_RING
#endif

#include "flow_common.cuh"
#ifdef GLOW_BF16_RING
#include "flow_ring.cuh"
#endif

namespace {

struct Strided {
  const act_t* data;     // [B, T, C/2], unit stride along channels
  size_t batch_stride, row_stride;
};

struct Params {
  Strided x_a, x_b;
  const float* mask;     // [B, T]
  const float* cond;     // [NL, B, 2CH] per-layer bias: in-conv bias (+ cond.)
  const float* pitch;    // [B, T, kPitchSize], GLOW_PITCH builds only
  const float* w_pitch;  // [NL, kPitchSize, 2CH], GLOW_PITCH builds only
  StepWeights w;         // an_logs, an_bias and mix_t unused (null)
  act_t* z_b;            // [B, T, C/2]
  float* ld_part;        // [B, n_tiles], forward only
  int* tiles;            // [5] or null: report_tiles
  int B, T, n_tiles;
#ifdef GLOW_BF16_RING
  long long* clocks;     // [grid, kClockSlots]: the timed instantiation's
#endif
};

// The coupling on one live tile: z_b of its owned frames, and on the
// forward pass the tile's sum of logs * m, returned in thread 0.  Ends on a
// barrier, so the block may go on to another tile.
template <class S, bool REVERSE>
__device__ __forceinline__ float coupling_tile(const Tile<S>& tile,
                                               const Params& p) {
  constexpr int C = S::C, C2 = S::C2, TT = S::TT, HALO = S::HALO;
  tile.begin(p.mask);
  tile.template load_columns<S::HV>(p.x_a.data, p.x_a.batch_stride,
                                    p.x_a.row_stride, 0, C2);
  tile.template load_columns<S::HV>(p.x_b.data, p.x_b.batch_stride,
                                    p.x_b.row_stride, C2, C2);
  __syncthreads();
  const auto pre_gate = step_pre_gate(p.cond, p.pitch, p.w_pitch);
  pre_gate.stage(tile);
  coupling_net<S, false, false, 3>(tile, p.w, SavePointers{}, pre_gate);
  float total = 0.f;
  if constexpr (!REVERSE) {
    total = affine_forward<S, false>(tile, p.z_b);
  } else {
    const float* const xs = tile.xs;
    const float* const acc = tile.gs;
    for (int i = threadIdx.x; i < TT * C2; i += kThreads) {
      const int r = i / C2, c = i % C2, row = HALO + r, t = tile.t0 + row;
      if (t >= p.T) continue;
      const float mean = acc[r * C + c], logs = acc[r * C + C2 + c];
      p.z_b[(tile.sample + t) * C2 + c] = to_act(
          (xs[row * C + C2 + c] - mean) * expf(-logs) * tile.ms[row], p.z_b);
    }
  }
  __syncthreads();
  return total;
}

template <class S, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1) coupling_kernel(const Params p) {
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
      logdet = coupling_tile<S, REVERSE>(tile, p);
      ++computed;
    } else {
      tile.template zero_owned<S::HV>(p.z_b, S::C2);
    }
    if (!REVERSE && threadIdx.x == 0)
      p.ld_part[tile.b * p.n_tiles + tile.index] = logdet;
  }
  report_tiles(p.tiles, items, computed);
}

template <class S, bool REVERSE>
cudaError_t resident(int B, int* blocks) {
  return resident_blocks(coupling_kernel<S, REVERSE>,
                         S::smem_bytes + sizeof(int) * live_tile_ints(B),
                         blocks);
}

template <class S, bool REVERSE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = resident<S, REVERSE>(p.B, &blocks);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.n_tiles;
  coupling_kernel<S, REVERSE>
      <<<items < blocks ? items : blocks, kThreads,
         S::smem_bytes + sizeof(int) * live_tile_ints(p.B), stream>>>(p);
  return cudaGetLastError();
}

#ifdef GLOW_BF16_RING
// The bfloat16 build's kernel: the same walk over the live tiles on
// flow_ring.cuh's body (ring_coupling_tile), its ring and buffers set up
// once a block; the ring's slice count runs on across the block's tiles.
template <class S, bool REVERSE, bool TIMED>
__global__ void __launch_bounds__(kThreads, 1)
    coupling_ring_kernel(const Params p) {
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
      logdet = ring_coupling_tile<S, REVERSE, TIMED>(
          tile, ring, p.x_a, p.x_b, p.mask,
          step_pre_gate(p.cond, p.pitch, p.w_pitch), w, p.z_b, clock);
      ++computed;
    } else {
      tile.template zero_owned<S::C2, S::VEC>(p.z_b);
    }
    if (!REVERSE && threadIdx.x == 0)
      p.ld_part[tile.b * p.n_tiles + tile.index] = logdet;
  }
  clock.finish();
  report_tiles(p.tiles, items, computed);
}

template <class S, bool REVERSE, bool TIMED>
cudaError_t resident_ring(int B, int* blocks) {
  return resident_blocks(coupling_ring_kernel<S, REVERSE, TIMED>,
                         S::smem_bytes + sizeof(int) * live_tile_ints(B),
                         blocks);
}

template <class S, bool REVERSE, bool TIMED>
cudaError_t launch_ring(const Params& p, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = resident_ring<S, REVERSE, TIMED>(p.B, &blocks);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.n_tiles;
  coupling_ring_kernel<S, REVERSE, TIMED>
      <<<items < blocks ? items : blocks, kThreads,
         S::smem_bytes + sizeof(int) * live_tile_ints(p.B), stream>>>(p);
  return cudaGetLastError();
}
using CouplingShape = RingBuilt;
#else
using CouplingShape = Built;
#endif

// A launch of the entry points' arguments; clocks non-null only for the
// timed instantiation of a GLOW_BF16 build.
int run_coupling(const act_t* x_a, long long a_batch_stride,
                 long long a_row_stride, const act_t* x_b,
                 long long b_batch_stride, long long b_row_stride,
                 const float* mask, const float* cond, const float* pitch,
                 const float* w_pitch, const float* w_start,
                 const float* b_start, const float* w_in, const float* w_rs,
                 const float* b_rs, const float* w_end, const float* b_end,
                 act_t* z_b, float* ld_part, int* tiles, int B, int T,
                 int reverse, void* stream, long long* clocks) {
  if ((pitch != nullptr) != kPitch || (w_pitch != nullptr) != kPitch)
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Params p{{x_a, static_cast<size_t>(a_batch_stride),
                  static_cast<size_t>(a_row_stride)},
                 {x_b, static_cast<size_t>(b_batch_stride),
                  static_cast<size_t>(b_row_stride)},
                 mask, cond, pitch, w_pitch,
                 {nullptr, nullptr, nullptr, w_start, b_start,
                  reinterpret_cast<const WFrag*>(w_in),
                  reinterpret_cast<const WFrag*>(w_rs), b_rs, w_end, b_end},
                 z_b, ld_part, tiles, B, T, ceil_div(T, CouplingShape::TT)
#ifdef GLOW_BF16_RING
                 , clocks
#endif
  };
  auto s = static_cast<cudaStream_t>(stream);
#ifdef GLOW_BF16_RING
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
  return reverse ? launch<Built, true>(p, s) : launch<Built, false>(p, s);
#endif
}

}  // namespace

extern "C" {

int glow_coupling_time_tile() { return CouplingShape::TT; }

// The flow's channel count this library is built for (GLOW_CHANNELS).
int glow_flow_channels() { return Built::C; }

// The geometry this library is built with (flow_common.cuh::write_geometry,
// ops/coupling.py::GEOMETRY_FIELDS): at most n ints into out; returns how
// many it has.
int glow_flow_geometry(int* out, int n) {
  return write_geometry<CouplingShape>(out, n);
}

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The blocks one launch uses on the current device at batch size B (fewer
// when B * tiles is less), or minus a cudaError_t.
int glow_coupling_resident_blocks(int B) {
  int blocks = 0;
#ifdef GLOW_BF16_RING
  const cudaError_t err = resident_ring<RingBuilt, true, false>(B, &blocks);
#else
  const cudaError_t err = resident<Built, true>(B, &blocks);
#endif
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Shapes are those of the build's geometry (glow_flow_geometry; w_start,
// b_start, b_rs, w_end, w_pitch and cond at the WaveNet width ch_pad),
// w_in and w_rs in the tensor-core layout; the caller checks them, and that the
// strides and addresses of x_a and x_b are multiples of the bytes the build
// loads of a half's row at a time: 16 (4 float32 elements, 8 bfloat16), or
// where a half's row is not a multiple of 16 bytes 8 (a float32 half at C/2
// = 2 mod 4, Shape::HV; a bfloat16 half at C/2 = 4 mod 8) or 4 (a bfloat16
// half at C/2 = 2 mod 4; RingShape::VEC).
// pitch and w_pitch are null, or with a GLOW_PITCH build not null
// (cudaErrorInvalidValue otherwise).  tiles is null, or 5 zeroed ints that
// receive what the launch did (flow_common.cuh::report_tiles).  x_a, x_b
// and z_b are bfloat16 in a GLOW_BF16 build (the entry keeps its name; the
// strides are in elements), and w_start, w_in, w_rs and w_end are the ring
// body's packed slices (ops/coupling.py::ring_layout_bf16).  Returns a
// cudaError_t, 0 on success.
int glow_coupling_f32(const act_t* x_a, long long a_batch_stride,
                      long long a_row_stride, const act_t* x_b,
                      long long b_batch_stride, long long b_row_stride,
                      const float* mask, const float* cond,
                      const float* pitch, const float* w_pitch,
                      const float* w_start, const float* b_start,
                      const float* w_in, const float* w_rs, const float* b_rs,
                      const float* w_end, const float* b_end, act_t* z_b,
                      float* ld_part, int* tiles, int B, int T, int reverse,
                      void* stream) {
  return run_coupling(x_a, a_batch_stride, a_row_stride, x_b, b_batch_stride,
                      b_row_stride, mask, cond, pitch, w_pitch, w_start,
                      b_start, w_in, w_rs, b_rs, w_end, b_end, z_b, ld_part,
                      tiles, B, T, reverse, stream, nullptr);
}

#ifdef GLOW_BF16_RING
// The long longs of a block's row of the timed instantiation's clocks.
int glow_coupling_clock_slots() { return kClockSlots; }

// glow_coupling_f32 through the timed instantiation: clocks [grid,
// glow_coupling_clock_slots()] long longs, zeroed, grid at least the
// launch's (glow_coupling_resident_blocks), receive each block's cycles a
// phase (flow_ring.cuh::PhaseClock; kLoad is x_a, x_b and the mask alone).
int glow_coupling_timed(const act_t* x_a, long long a_batch_stride,
                        long long a_row_stride, const act_t* x_b,
                        long long b_batch_stride, long long b_row_stride,
                        const float* mask, const float* cond,
                        const float* pitch, const float* w_pitch,
                        const float* w_start, const float* b_start,
                        const float* w_in, const float* w_rs,
                        const float* b_rs, const float* w_end,
                        const float* b_end, act_t* z_b, float* ld_part,
                        int* tiles, int B, int T, int reverse, void* stream,
                        long long* clocks) {
  if (!clocks) return cudaErrorInvalidValue;
  return run_coupling(x_a, a_batch_stride, a_row_stride, x_b, b_batch_stride,
                      b_row_stride, mask, cond, pitch, w_pitch, w_start,
                      b_start, w_in, w_rs, b_rs, w_end, b_end, z_b, ld_part,
                      tiles, B, T, reverse, stream, clocks);
}
#endif

}  // extern "C"
