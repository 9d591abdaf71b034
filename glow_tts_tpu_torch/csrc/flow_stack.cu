// The whole flow stack of the Glow-TTS decoder (S x [ActNorm -> mixing ->
// WaveNet affine coupling], the steps in reverse order on the inverse pass)
// as one kernel launch, float32 results.
//
// Replaces glow_tts_tpu/ops/coupling.py::_make_mega_kernel, the Pallas
// kernel behind fused_flow_stack.  The plain PyTorch version of the same
// function is glow_tts_tpu_torch/ops/coupling.py::flow_stack_reference.
//
// Design.  The TPU kernel keeps a batch block's whole time axis on chip
// across the steps.  An SM cannot: one sample's [512, 160] activation is
// 328 KB against 227 KB of shared memory, of which a step's working set
// takes 138 KB, and step j + 1's tile needs 8 halo frames of step j's
// output from the tiles beside it.  What one launch can do that S launches
// of flow_step.cu cannot is begin step j + 1 on a tile whose neighbours
// have finished step j while other tiles of step j still run: S launches
// over L live tiles on G blocks take S * ceil(L / G) rounds, this kernel
// about ceil(S * L / G).  So:
// * the grid is as many blocks as are resident together (one per SM at
//   this size, asked of the occupancy calculator at the real shared
//   memory, the live-tile list's ints included), launched with
//   cudaLaunchCooperativeKernel, which refuses a grid that is not: a block
//   may spin on another's work only because every block is resident;
// * the work list, built in every block from the mask as flow_step.cu
//   builds its own (flow_common.cuh::live_tiles): first the dead tiles
//   (those from the sample's last valid frame on), whose rows are zeroed
//   in both buffers, then (step j, live tile) for j = 0 .. S - 1, step by
//   step, each step's live tiles in live_tiles' order.  Block b takes the
//   items b, b + G, b + 2G, ... in that order.  No step computes a dead
//   tile, and no block walks more than ceil(S * L / G) live items;
// * item (j + 1, sample, t) starts once items (j, sample, t - 1), (j,
//   sample, t) and (j, sample, t + 1) have written their rows (a tile's
//   halo, HALO = 8 frames, lies within its neighbours since HALO <= TT).
//   Each item has a flag per step in device memory (a dead tile's are all
//   set by its zeroing item), set after a fence once its rows are out and
//   waited on by thread 0 with acquire loads.  Every dependency lies
//   earlier in the list and every block takes its items in list order, so
//   the lowest unfinished item always has its dependencies done: no
//   deadlock.  A wait longer than a second traps, so a fault is an error
//   and not a hang;
// * the activation goes from step to step through two [B, T, C] buffers
//   in device memory, read through L2 (2 x 10.5 MB at B = 32, T = 512).
//   Step j writes the buffer step j - 1 read, the last step the result
//   tensor, so nothing is copied (see wait_for_neighbours for why no
//   write lands on rows still to be read);
// * step j's weights are step j's (reverse: S - 1 - j's) slices of the
//   stacked tensors, GR mode's w_pitch [steps, NL, PS, 2CH] among them in a
//   build of its own (GLOW_PITCH, as in flow_step.cu; the pitch operand
//   [B, T, PS] is the same for every step); per-tile arithmetic is
//   flow_step.cu's
//   (flow_common.cuh::flow_step_tile), so z is bit-equal to S chained
//   launches of it;
// * the forward logdet is kept per (sample, tile) and added over the steps
//   in step order: the item of step j adds its own to what step j - 1's
//   item of the same tile left, which it has waited for; the caller sums
//   over tiles.  No atomics touch a value, so the same inputs give the
//   same bits.
// The plain twin of the list and of each item's dependencies is
// ops/coupling.py::stack_tile_schedule.
// A GLOW_BF16 build is this kernel on flow_step.cu's bfloat16 body: x, z
// and the two buffers are bfloat16, so the stream is rounded to bfloat16
// between the steps, as the TPU kernel's carry is (in dt), and z is
// bit-equal to S chained launches of flow_step.cu's bfloat16 build.
//
// The GLOW_BF16 build runs flow_step.cu's bfloat16 body of its own
// (GLOW_BF16_RING, flow_ring.cuh) per item: its tiles are 48 frames, and
// each item's weight ring starts anew, the step's slices issued as the item
// begins.
//
// What bounds it: arithmetic, S times flow_step.cu's on the live tiles; a
// step's trip through device memory, which the TPU kernel exists to save,
// is 21 MB against 59 GFLOP here.

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
  const float* cond;     // [steps, NL, B, 2CH]
  const float* pitch;    // [B, T, kPitchSize], GLOW_PITCH builds only
  const float* w_pitch;  // [steps, NL, kPitchSize, 2CH], GLOW_PITCH only
  StepWeights w;         // step 0 of each stacked [steps, ...] tensor
  const float* ld_const; // [steps], forward only
  act_t* z;              // [B, T, C] the result: the last step writes it
  act_t* other;          // [B, T, C] the second buffer (null at 1 step)
  float* ld_part;        // [B, n_tiles], forward only
  unsigned* done;        // [steps, B, n_tiles], zero at launch
  int* tiles;            // [5] or null: report_tiles
  int B, T, n_tiles, steps;
};

constexpr long long kWaitTimeoutCycles = 1LL << 31;   // over a second

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Block-wide: returns once the items of step j - 1 at tiles t - 1, t and
// t + 1 of the sample (those that exist) are done; `step_flags` points at
// step j - 1's flags of the sample.  The activation loads after it go
// through L2 (ld_act4), never L1, since other SMs wrote those rows.
//
// Why no write lands on a row that is still to be read: item (j + 1, t)
// overwrites, in the buffer that step j - 1 wrote, the rows of tile t,
// which are read only by the items (j, t - 1), (j, t) and (j, t + 1),
// and those are exactly the items (j + 1, t) waits for here.
__device__ __forceinline__ void wait_for_neighbours(const unsigned* step_flags,
                                                    int t, int n_tiles) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    for (int n = t > 0 ? t - 1 : 0; n <= t + 1 && n < n_tiles; ++n)
      while (load_acquire(step_flags + n) == 0u) {
        if (clock64() - start > kWaitTimeoutCycles) __trap();
        __nanosleep(64);
      }
  }
  __syncthreads();
}

template <class S, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1)
    flow_stack_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const LiveTiles list = live_tiles<S>(
      p.mask, p.B, p.T, reinterpret_cast<int*>(smem + S::FLOATS));
  const int dead = list.items - list.live;
  const int items = dead + p.steps * list.live;
  const size_t cond_step = static_cast<size_t>(S::NL) * p.B * S::CH2;
  constexpr size_t w_pitch_step = S::NL * kPitchSize * S::CH2;
  const size_t flags_step = static_cast<size_t>(p.B) * p.n_tiles;
  // step j writes z if an even number of steps follow it, so the last does
  auto output = [&](int j) {
    return (p.steps - 1 - j) % 2 == 0 ? p.z : p.other;
  };
  int computed = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < dead) {
      // a dead tile: zero in every buffer a step or the caller reads, done
      // for every step
      const TileId id = list.at(list.live + item);
      const Tile<S> tile(smem, p.B, p.T, id.b, id.index);
      const size_t slot = static_cast<size_t>(id.b) * p.n_tiles + id.index;
      tile.zero_owned(p.z, S::C);
      if (p.other) tile.zero_owned(p.other, S::C);
      if (!REVERSE && threadIdx.x == 0) p.ld_part[slot] = 0.f;
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        for (int j = 0; j < p.steps; ++j)
          store_release(p.done + j * flags_step + slot, 1u);
      }
      continue;
    }
    const int j = (item - dead) / list.live;
    const TileId id = list.at((item - dead) % list.live);
    const size_t sample_flags = static_cast<size_t>(id.b) * p.n_tiles;
    if (j > 0)
      wait_for_neighbours(p.done + (j - 1) * flags_step + sample_flags,
                          id.index, p.n_tiles);
    const int s = REVERSE ? p.steps - 1 - j : j;
    const Tile<S> tile(smem, p.B, p.T, id.b, id.index);
    const float logdet = flow_step_tile<S, REVERSE>(
        tile, j == 0 ? p.x : output(j - 1), p.mask,
        step_pre_gate(p.cond + s * cond_step, p.pitch,
                      kPitch ? p.w_pitch + s * w_pitch_step : nullptr),
        step_of_stack<S>(p.w, s), REVERSE ? nullptr : p.ld_const + s,
        output(j));
    const size_t slot = sample_flags + id.index;
    if (!REVERSE && threadIdx.x == 0)
      p.ld_part[slot] = j == 0 ? logdet : __ldcg(p.ld_part + slot) + logdet;
    ++computed;
    if (threadIdx.x == 0) {   // the block's writes, behind flow_step_tile's
      __threadfence();        // closing barrier, then the flag
      store_release(p.done + j * flags_step + slot, 1u);
    }
  }
  report_tiles(p.tiles, p.steps * list.live, items, computed);
}

#ifdef GLOW_BF16_RING
// The bfloat16 build's kernel: flow_stack_kernel's list, flags and buffers
// on flow_ring.cuh's body, its ring and buffers set up once a block.
template <class S, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1)
    flow_stack_ring_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  Ring ring;
  char* const aligned = ring_block<S>(smem4, ring);
  const LiveTiles list = live_tiles<S>(
      p.mask, p.B, p.T, reinterpret_cast<int*>(aligned + S::BYTES));
  const RingWeights stacked = ring_weights(p.w);
  PhaseClock<false> clock(nullptr);
  const int dead = list.items - list.live;
  const int items = dead + p.steps * list.live;
  const size_t cond_step = static_cast<size_t>(S::NL) * p.B * S::CH2;
  constexpr size_t w_pitch_step = S::NL * kPitchSize * S::CH2;
  const size_t flags_step = static_cast<size_t>(p.B) * p.n_tiles;
  auto output = [&](int j) {
    return (p.steps - 1 - j) % 2 == 0 ? p.z : p.other;
  };
  int computed = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    if (item < dead) {
      const TileId id = list.at(list.live + item);
      const RingTile<S> tile(aligned, p.B, p.T, id.b, id.index);
      const size_t slot = static_cast<size_t>(id.b) * p.n_tiles + id.index;
      tile.zero_owned(p.z);
      if (p.other) tile.zero_owned(p.other);
      if (!REVERSE && threadIdx.x == 0) p.ld_part[slot] = 0.f;
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        for (int j = 0; j < p.steps; ++j)
          store_release(p.done + j * flags_step + slot, 1u);
      }
      continue;
    }
    const int j = (item - dead) / list.live;
    const TileId id = list.at((item - dead) % list.live);
    const size_t sample_flags = static_cast<size_t>(id.b) * p.n_tiles;
    if (j > 0)
      wait_for_neighbours(p.done + (j - 1) * flags_step + sample_flags,
                          id.index, p.n_tiles);
    const int s = REVERSE ? p.steps - 1 - j : j;
    const RingTile<S> tile(aligned, p.B, p.T, id.b, id.index);
    const RingWeights w = ring_step_of_stack<S>(stacked, s);
    const float logdet = ring_flow_step_tile<S, REVERSE, false>(
        tile, ring, j == 0 ? p.x : output(j - 1), p.mask,
        step_pre_gate(p.cond + s * cond_step, p.pitch,
                      kPitch ? p.w_pitch + s * w_pitch_step : nullptr),
        w, REVERSE ? nullptr : p.ld_const + s, output(j), clock);
    const size_t slot = sample_flags + id.index;
    if (!REVERSE && threadIdx.x == 0)
      p.ld_part[slot] = j == 0 ? logdet : __ldcg(p.ld_part + slot) + logdet;
    ++computed;
    if (threadIdx.x == 0) {
      __threadfence();
      store_release(p.done + j * flags_step + slot, 1u);
    }
  }
  report_tiles(p.tiles, p.steps * list.live, items, computed);
}
#define STACK_KERNEL flow_stack_ring_kernel
using StackShape = RingBuilt;
#else
#define STACK_KERNEL flow_stack_kernel
using StackShape = Built;
#endif

template <class S, bool REVERSE>
cudaError_t resident(int B, int* blocks) {
  return resident_blocks(STACK_KERNEL<S, REVERSE>,
                         S::smem_bytes + sizeof(int) * live_tile_ints(B),
                         blocks);
}

template <class S, bool REVERSE>
cudaError_t launch(Params p, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = resident<S, REVERSE>(p.B, &blocks);
  if (err != cudaSuccess) return err;
  // at most one block per item of a batch whose every tile is live
  const long long items = static_cast<long long>(p.steps) * p.B * p.n_tiles;
  const int grid = items < blocks ? static_cast<int>(items) : blocks;
  err = cudaMemsetAsync(p.done, 0,
                        sizeof(unsigned) * static_cast<size_t>(items), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(STACK_KERNEL<S, REVERSE>), dim3(grid),
      dim3(kThreads), args, S::smem_bytes + sizeof(int) * live_tile_ints(p.B),
      stream);
}

}  // namespace

extern "C" {

int glow_flow_stack_time_tile() { return StackShape::TT; }

// The flow's channel count this library is built for (GLOW_CHANNELS).
int glow_flow_channels() { return Built::C; }

// The geometry this library is built with (flow_common.cuh::write_geometry,
// ops/coupling.py::GEOMETRY_FIELDS): at most n ints into out; returns how
// many it has.
int glow_flow_geometry(int* out, int n) {
  return write_geometry<StackShape>(out, n);
}

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most blocks one launch at batch size B uses on the current device (a
// launch uses fewer when steps * B * tiles is less), or minus a
// cudaError_t.
int glow_flow_stack_resident_blocks(int B) {
  int blocks = 0;
  const cudaError_t err = resident<StackShape, true>(B, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// All `steps` flow steps of stacked weights ([steps, ...] each, shapes those
// of Built: C = glow_flow_channels(), ch=192, 4 layers, k=5, w_in and w_rs
// in the tensor-core layout; the caller checks them) in one launch.  z gets the
// result; other is a second [B, T, C] buffer (may be null at steps = 1),
// ld_part [B, tiles] and ld_const [steps] are forward only, done is
// steps * B * tiles unsigneds of scratch, tiles null or 5 zeroed ints that
// receive what the launch did (flow_common.cuh::report_tiles: its live
// items are steps * the live tiles).  pitch and w_pitch are null, or with a
// GLOW_PITCH build not null (cudaErrorInvalidValue otherwise).  x, z and
// other are bfloat16 in a GLOW_BF16 build (the entry keeps its name), and
// mix_t, w_start, w_in, w_rs and w_end are the ring body's packed slices
// (ops/coupling.py::ring_layout_bf16).  Returns a cudaError_t, 0 on
// success.
int glow_flow_stack_f32(const act_t* x, const float* mask, const float* cond,
                        const float* pitch, const float* w_pitch,
                        const float* an_logs, const float* an_bias,
                        const float* mix_t, const float* w_start,
                        const float* b_start, const float* w_in,
                        const float* w_rs, const float* b_rs,
                        const float* w_end, const float* b_end,
                        const float* ld_const, act_t* z, act_t* other,
                        float* ld_part, unsigned* done, int* tiles, int B,
                        int T, int steps, int reverse, void* stream) {
  if ((pitch != nullptr) != kPitch || (w_pitch != nullptr) != kPitch)
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || steps <= 0) return cudaSuccess;
  const Params p{x, mask, cond, pitch, w_pitch,
                 {an_logs, an_bias, mix_t, w_start, b_start,
                  reinterpret_cast<const WFrag*>(w_in),
                  reinterpret_cast<const WFrag*>(w_rs), b_rs, w_end, b_end},
                 ld_const, z, other, ld_part, done, tiles, B, T,
                 ceil_div(T, StackShape::TT), steps};
  auto s = static_cast<cudaStream_t>(stream);
  return reverse ? launch<StackShape, true>(p, s)
                 : launch<StackShape, false>(p, s);
}

}  // extern "C"
