// Monotonic alignment search (MAS), float32, bit-exact: two kernels.
//
// Replaces glow_tts_tpu/ops/mas.py::_mas_kernel, the Pallas kernel behind
// maximum_path_pallas.  For each sample: the Viterbi recurrence over mel
// frames y = 0 .. mel_length-1,
//     v[x] <- max(stay, move) + log_p[x, y]
//     stay = v[x]     (kNeg when x == y)
//     move = v[x-1]   (x == 0: 0 at y == 0, else kNeg)
// with one direction bit per cell, (x == y) | (v[x] < v[x-1]) on the column
// before the update; then the walk from (token_length-1, mel_length-1) down
// to frame 0, one token per valid frame, and the path [B, T_tok, T_mel]:
// 1 at (walk's token, frame) for frames below mel_length, 0 elsewhere.  The
// plain PyTorch version of the same function is
// glow_tts_tpu_torch/ops/mas.py::maximum_path_reference (composed of
// maximum_path_index_reference and expand_path_reference, the twins of the
// two kernels); the two are held equal, so the arithmetic here is exactly
// its own: f32, one max and one add per cell, a strict <, no fast-math.
//
// What bounds it on an H100: by the count, bytes (the valid part of log_p
// read once, the whole path written once: 38.5 MB at 32 x 224 x 1024, 11.5
// us).  In practice, first the dependent frames of the longest sample (one
// block per sample), then the path's bytes.  The design keeps the first to
// a short chain a frame and gives the second to the whole card:
// * mas_recurrence, grid (batch), one block per sample: a wavefront of
//   warps.  Lane l of warp w owns TPL consecutive tokens from
//   (32 w + l) TPL (TPL the fewest of 1, 2, 4 that 8 warps cover); the x-1
//   neighbour is a register, or one __shfl_up_sync for the lane's first
//   token, and lane 0's comes from warp w-1's last token through a ring in
//   shared memory.  A frame's dependent chain is a shuffle, a select, a max
//   and an add, with selects and no branch around it.  Warp w runs kSync
//   frames behind warp w-1; each ring entry is one 8-byte store tagged with
//   its frame, so a reader knows it is there without a fence or a flag, and
//   a count per warp of the groups it has read holds the writer back where
//   it would overwrite one.  No block barrier in the loop; warps whose
//   tokens all lie at or past token_length do nothing.
// * log_p goes straight into two register buffers of 32 frames a token (16
//   at 4 tokens a lane).  A warp's loads share one scoreboard, so a wait
//   is for every load in flight: the next buffer's loads go out right after
//   a buffer's first frame has waited for its own, a buffer ahead.
//   16-byte loads, 4-byte ones where T_mel is not a multiple of 4 or at the
//   last frames; only frames below mel_length of tokens below token_length
//   are read.
// * Direction bits stay in the lane that computes them, one bit a frame in
//   a word per token, and go out once per 32 frames into a scratch dirs
//   [B, ceil(T_mel/32), T_tok] uint32 (L2-resident): no vote and no shared
//   memory per frame, and no limit on T_mel.
// * The walk, by warp 0 after the block's barrier, 32 frames (one word of
//   dirs) at a time: in 32 frames the token drops by at most 32, so lane r
//   holds the word of token index-r (the next window's two candidates
//   brought a window ahead), 32 ballots turn them into one word per frame
//   (bit r: token index-r), and the chain over the window is m += g_f & m
//   on m = 1 << drops: no memory access on it.  It writes a compact token
//   index [B, T_mel] int32 (-1 past the sample's frames).
// * mas_expand, a second kernel on the same stream, grid (frames, batch,
//   row groups) filling the card: path[b, x, y] = (index[b, y] == x),
//   16-byte stores where T_mel is a multiple of 4.
// A timed instantiation of both (TIMED) writes %globaltimer stamps and
// clock64 cycles of the phases; maximum_path never launches it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1.0e9f;
constexpr int kMaxTokens = 1024;
constexpr int kMaxWarps = 8;  // a block; TPL grows with the tokens
constexpr int kMinTPL = 1;    // tokens a lane at least
constexpr int kChunk = 32;    // frames in a word of dirs, and in registers
constexpr int kSync = 16;     // frames a warp runs behind the warp before it
constexpr int kRing = 8;      // groups of kSync frames a warp's ring holds
constexpr int kExpandThreads = 256;
constexpr int kExpandBlocks = 132 * 8;  // what the expansion aims to launch
constexpr long long kWaitTimeoutCycles = 2000000000LL;  // ~1 s: trap

// stamps a sample of the timed instantiation writes (int64, ns unless
// cycles); row `batch` holds the expansion kernel's first start and last end
enum Stamp {
  kStart,          // the block starts
  kFillEnd,        // the last active warp begins its first frame
  kLastWarpEnd,    // the last active warp ends its frames
  kRecurrenceEnd,  // after the block's barrier
  kWalkEnd,        // warp 0 has written the token index
  kWarp0Cycles,    // warp 0's clock64 cycles over its frames
  kWarp0End,       // warp 0 ends its frames
  kLastWarpWait,   // the last active warp's clock64 cycles waiting on its ring
  kStamps
};

// the memory clobber keeps a stamp in order with the accesses around it
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ float component(const float4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// frames y .. y+3 of one token's row of log_p, zero from `ml` on and for
// a token the sample does not have, in 4-byte loads
__device__ __forceinline__ float4 load_frames(const float* row, int y, int ml,
                                              bool valid) {
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    if (y < ml) q.x = __ldg(row + y);
    if (y + 1 < ml) q.y = __ldg(row + y + 1);
    if (y + 2 < ml) q.z = __ldg(row + y + 2);
    if (y + 3 < ml) q.w = __ldg(row + y + 3);
  }
  return q;
}

// a ring entry: the last token's value after frame y, tagged with y
__device__ __forceinline__ unsigned long long tagged(float v, int y) {
  return static_cast<unsigned long long>(y) << 32 | __float_as_uint(v);
}

// lane l of the warp reads entry `at[l % kSync]` of group g, and the warp
// waits until every tag is its frame: each entry is one 8-byte store, so a
// tag that matches vouches for its value
__device__ __forceinline__ float read_group(
    const volatile unsigned long long* at, int g, int lane) {
  const unsigned frame = g * kSync + lane % kSync;
  unsigned long long e = at[lane % kSync];
  if (!__all_sync(0xffffffffu, static_cast<unsigned>(e >> 32) == frame)) {
    const long long start = clock64();
    do {
      if (clock64() - start > kWaitTimeoutCycles) __trap();
      e = at[lane % kSync];
    } while (!__all_sync(0xffffffffu, static_cast<unsigned>(e >> 32) == frame));
  }
  return __uint_as_float(static_cast<unsigned>(e));
}

// the word of the direction table for (chunk c, token t) as the walk reads
// it: 0 for no token; token 0 never steps down, so its bits are dropped
__device__ __forceinline__ unsigned dir_word(const unsigned* table, int c,
                                             int t, int t_tok) {
  return c >= 0 && t >= 1 ? table[static_cast<size_t>(c) * t_tok + t] : 0u;
}

template <int TPL, bool TIMED>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    mas_recurrence(const float* __restrict__ log_p,
                   const int* __restrict__ token_lengths,
                   const int* __restrict__ mel_lengths,
                   unsigned* __restrict__ dirs, int* __restrict__ index,
                   int t_tok, int t_mel, bool vec, long long* stamps) {
  // each warp's last token after each frame, tagged:
  // [warp][group % kRing][f]
  __shared__ unsigned long long ring[kMaxWarps][kRing][kSync];
  // groups of warp w-1's ring that warp w has read
  __shared__ int consumed[kMaxWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tl = token_lengths[b];
  const int ml = min(max(mel_lengths[b], 0), t_mel);
  const int tl_read = min(max(tl, 0), t_tok);
  // warps with a token to compute
  const int n_warps = (tl_read + 32 * TPL - 1) / (32 * TPL);
  const int n_chunks = (t_mel + kChunk - 1) / kChunk;
  const bool walks = tl >= 1 && tl <= t_tok && ml >= 1;
  const int n_groups = walks ? (ml + kSync - 1) / kSync : 0;
  // the sample's direction table [ceil(T_mel/32)][T_tok]
  unsigned* table = dirs + static_cast<size_t>(b) * n_chunks * t_tok;
  int* my_index = index + static_cast<size_t>(b) * t_mel;
  long long* my_stamps = TIMED ? stamps + static_cast<size_t>(b) * kStamps
                               : nullptr;
  if (TIMED && tid == 0) my_stamps[kStart] = global_ns();
  for (int i = tid; i < kMaxWarps * kRing * kSync; i += blockDim.x)
    (&ring[0][0][0])[i] = ~0ull;  // a tag no frame has
  if (tid < kMaxWarps) consumed[tid] = 0;
  __syncthreads();

  if (warp < n_warps && n_groups > 0) {
    const int x0 = (warp * 32 + lane) * TPL;  // the lane's first token
    const float* rows[TPL];
    bool valid[TPL];
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      valid[j] = x0 + j < tl_read;
      rows[j] = log_p + (static_cast<size_t>(b) * t_tok +
                         (valid[j] ? x0 + j : 0)) * t_mel;
    }
    const bool first = warp == 0, last = warp == n_warps - 1;
    volatile int* read_by_next = consumed + (last ? warp : warp + 1);
    int seen = 0;  // lane 31: the last value read of *read_by_next
    long long cycles = TIMED ? clock64() : 0, waited = 0;

    // log_p in two register buffers of kBuf frames each: a buffer's first
    // frame waits for its loads (all loads share one scoreboard, so a wait
    // is for every load in flight), then the next buffer's loads go out
    constexpr int kBuf = TPL <= 2 ? kChunk : kSync;
    static_assert(kBuf == kChunk || 2 * kBuf == kChunk,
                  "a buffer, or two, make a word of dirs");
    using Buffer = float4[TPL][kBuf / 4];
    auto load_buffer = [&](Buffer& q, int n) {
      const int y0 = n * kBuf;
      if (vec && y0 + kBuf <= ml) {
        // every frame valid: one predicated 16-byte load each, no branch
#pragma unroll
        for (int j = 0; j < TPL; ++j) {
          const float4* at = reinterpret_cast<const float4*>(rows[j] + y0);
#pragma unroll
          for (int i = 0; i < kBuf / 4; ++i) {
            q[j][i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (valid[j]) q[j][i] = __ldg(at + i);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < TPL; ++j)
#pragma unroll
          for (int i = 0; i < kBuf / 4; ++i)
            q[j][i] = load_frames(rows[j], y0 + 4 * i, ml, valid[j]);
      }
    };
    float v[TPL];
#pragma unroll
    for (int j = 0; j < TPL; ++j) v[j] = kNeg;
    float carry = kNeg;  // warp w-1's last token before the group's frames
    unsigned bits[TPL];  // bit f: the direction at frame 32c + f
    // buffer n of frames; `parity` = n % 2, a constant where it is called
    auto run_buffer = [&](Buffer& q, Buffer& next, int n, int parity) {
#pragma unroll
      for (int gi = 0; gi < kBuf / kSync; ++gi) {
        const int g = n * (kBuf / kSync) + gi;
        if (g >= n_groups) break;
        // the group's first frame's place in its word of dirs
        const int at0 = (parity * kBuf + gi * kSync) % kChunk;
        const long long w0 = TIMED && last ? clock64() : 0;
        // warp w-1's last token after frames g*kSync .. g*kSync+kSync-1
        float ring_in = kNeg;
        if (!first) {
          ring_in = read_group(ring[warp - 1][g % kRing], g, lane);
          if (lane == 0) consumed[warp] = g + 1;
        }
        // the next warp must have read what this group overwrites
        if (!last && lane == 31 && seen <= g - kRing) {
          const long long start = clock64();
          while ((seen = *read_by_next) <= g - kRing) {
            if (clock64() - start > kWaitTimeoutCycles) __trap();
          }
        }
        if (TIMED && last) {
          waited += clock64() - w0;
          if (g == 0 && lane == 0) my_stamps[kFillEnd] = global_ns();
        }
        if (at0 == 0) {
#pragma unroll
          for (int j = 0; j < TPL; ++j) bits[j] = 0u;
        }
        float out[kSync];  // the last token after each frame, for the ring
        // selects only: no branch among the frames
#pragma unroll
        for (int f = 0; f < kSync; ++f) {
          const int y = g * kSync + f;
          const int at = at0 + f;
          const int in_buffer = gi * kSync + f;
          const float left =
              f == 0 ? carry : __shfl_sync(0xffffffffu, ring_in, f - 1);
          // the token before the lane's first, before this frame: for the
          // comparison (shifted) and the move; they differ at token 0 only
          const float up = __shfl_up_sync(0xffffffffu, v[TPL - 1], 1);
          const float shifted = lane == 0 ? (first ? kNeg : left) : up;
          const float move =
              lane == 0 ? (first ? (y == 0 ? 0.f : kNeg) : left) : up;
          // descending, so v[j-1] is still the previous frame's
#pragma unroll
          for (int j = TPL - 1; j >= 0; --j) {
            const float below = j > 0 ? v[j > 0 ? j - 1 : 0] : shifted;
            const bool diag = x0 + j == y;
            bits[j] |= diag | (v[j] < below) ? 1u << at : 0u;
            v[j] = fmaxf(diag ? kNeg : v[j], j > 0 ? below : move) +
                   component(q[j][in_buffer / 4], in_buffer % 4);
          }
          out[f] = v[TPL - 1];
          if (in_buffer == 0) load_buffer(next, n + 1);
        }
        carry = __shfl_sync(0xffffffffu, ring_in, kSync - 1);
        if (lane == 31) {
          volatile unsigned long long* ring_out = ring[warp][g % kRing];
#pragma unroll
          for (int f = 0; f < kSync; ++f)
            ring_out[f] = tagged(out[f], g * kSync + f);
        }
        // a word of dirs is full, or the sample's frames end
        if (at0 + kSync == kChunk || g + 1 == n_groups) {
          unsigned* word =
              table + static_cast<size_t>(g * kSync / kChunk) * t_tok + x0;
#pragma unroll
          for (int j = 0; j < TPL; ++j)
            if (valid[j]) word[j] = bits[j];
        }
      }
    };
    Buffer qa, qb;
    load_buffer(qa, 0);
    for (int n = 0; n * kBuf < ml; n += 2) {
      run_buffer(qa, qb, n, 0);
      if ((n + 1) * kBuf >= ml) break;
      run_buffer(qb, qa, n + 1, 1);
    }
    if (TIMED && lane == 0) {
      if (first) {
        my_stamps[kWarp0Cycles] = clock64() - cycles;
        my_stamps[kWarp0End] = global_ns();
      }
      if (last) {
        my_stamps[kLastWarpEnd] = global_ns();
        my_stamps[kLastWarpWait] = waited;
      }
    }
  }
  // a plain barrier defers its wait to the warp's next memory access, so a
  // stamp taken right after it can precede the last warp's frames: this
  // one's count is a result the stamp waits for
  const int arrived = __syncthreads_count(1);
  if (TIMED && tid == 0 && arrived == static_cast<int>(blockDim.x))
    my_stamps[kRecurrenceEnd] = global_ns();

  // frames without a token
  for (int y = walks ? ml + tid : tid; y < t_mel; y += blockDim.x)
    my_index[y] = -1;
  if (warp != 0 || !walks) return;

  // the walk, one chunk of 32 frames a window, from the last valid frame:
  // lane r holds the word of token i-r, frames above `top` masked off
  int i = tl - 1, c = (ml - 1) / kChunk;
  const int top = (ml - 1) % kChunk;
  unsigned word = dir_word(table, c, i - lane, t_tok) &
                  (top == kChunk - 1 ? ~0u : (2u << top) - 1);
  for (; c >= 0; --c) {
    // the next window enters at a token in [i-32, i]: its words are those
    // of tokens i-63 .. i
    const unsigned near = dir_word(table, c - 1, i - lane, t_tok);
    const unsigned far = dir_word(table, c - 1, i - 32 - lane, t_tok);
    // bit r of frame_bits[f]: token i-r's direction at frame 32c + f
    unsigned frame_bits[kChunk];
#pragma unroll
    for (int f = 0; f < kChunk; ++f)
      frame_bits[f] = __ballot_sync(0xffffffffu, word & (1u << f));
    unsigned m = 1u, m_of_lane = 1u;  // m = 1 << (drops so far)
#pragma unroll
    for (int f = kChunk - 1; f > 0; --f) {
      m_of_lane = lane == f ? m : m_of_lane;
      m += frame_bits[f] & m;
    }
    m_of_lane = lane == 0 ? m : m_of_lane;
    const int drops =
        (__ffs(m) - 1) + static_cast<int>((frame_bits[0] & m) != 0);
    const int y = c * kChunk + lane;
    if (y < ml) my_index[y] = i - (__ffs(m_of_lane) - 1);
    i -= drops;
    // lane r now wants token (old i) - (drops + r)
    const int k = drops + lane;
    const unsigned from_near = __shfl_sync(0xffffffffu, near, k & 31);
    const unsigned from_far = __shfl_sync(0xffffffffu, far, k & 31);
    word = k < 32 ? from_near : from_far;
  }
  if (TIMED && lane == 0) my_stamps[kWalkEnd] = global_ns();
}

// path[b, x, y] = (index[b, y] == x) for rows x0 .. x0+rows-1; VEC: four
// frames a thread
template <bool VEC, bool TIMED>
__global__ void __launch_bounds__(kExpandThreads)
    mas_expand(const int* __restrict__ index, float* __restrict__ path,
               int t_tok, int t_mel, int rows, long long* stamps) {
  if (TIMED && threadIdx.x == 0)
    atomicMin(reinterpret_cast<unsigned long long*>(stamps),
              static_cast<unsigned long long>(global_ns()));
  const int b = blockIdx.y;
  const int x0 = blockIdx.z * rows, x1 = min(x0 + rows, t_tok);
  const int j = blockIdx.x * kExpandThreads + threadIdx.x;
  float* out = path + static_cast<size_t>(b) * t_tok * t_mel;
  if (VEC) {
    const int y = 4 * j;
    if (y < t_mel) {
      const int4 at = __ldg(reinterpret_cast<const int4*>(
          index + static_cast<size_t>(b) * t_mel + y));
      for (int x = x0; x < x1; ++x) {
        const float4 ones = make_float4(at.x == x, at.y == x, at.z == x,
                                        at.w == x);
        *reinterpret_cast<float4*>(out + static_cast<size_t>(x) * t_mel + y) =
            ones;
      }
    }
  } else if (j < t_mel) {
    const int at = __ldg(index + static_cast<size_t>(b) * t_mel + j);
    for (int x = x0; x < x1; ++x)
      out[static_cast<size_t>(x) * t_mel + j] = at == x ? 1.f : 0.f;
  }
  if (TIMED) {
    __syncthreads();
    if (threadIdx.x == 0)
      atomicMax(reinterpret_cast<unsigned long long*>(stamps) + 1,
                static_cast<unsigned long long>(global_ns()));
  }
}

template <int TPL, bool TIMED>
cudaError_t launch_recurrence(const float* log_p, const int* tl,
                              const int* ml, unsigned* dirs, int* index,
                              int batch, int t_tok, int t_mel, bool vec,
                              cudaStream_t stream, long long* stamps) {
  const int threads = 32 * ((t_tok + 32 * TPL - 1) / (32 * TPL));
  mas_recurrence<TPL, TIMED><<<batch, threads, 0, stream>>>(
      log_p, tl, ml, dirs, index, t_tok, t_mel, vec, stamps);
  return cudaGetLastError();
}

template <bool VEC, bool TIMED>
cudaError_t launch_expand(const int* index, float* path, int batch, int t_tok,
                          int t_mel, cudaStream_t stream, long long* stamps) {
  const int per_thread = VEC ? 4 : 1;
  const int columns = (t_mel + kExpandThreads * per_thread - 1) /
                      (kExpandThreads * per_thread);
  // enough row groups to fill the card
  const int wanted = (kExpandBlocks + columns * batch - 1) / (columns * batch);
  const int groups = min(max(wanted, 1), t_tok);
  const int rows = (t_tok + groups - 1) / groups;
  const dim3 grid(columns, batch, (t_tok + rows - 1) / rows);
  mas_expand<VEC, TIMED><<<grid, kExpandThreads, 0, stream>>>(
      index, path, t_tok, t_mel, rows, stamps);
  return cudaGetLastError();
}

template <bool TIMED>
int run(const float* log_p, const int* tl, const int* ml, float* path,
        unsigned* dirs, int* index, int batch, int t_tok, int t_mel,
        cudaStream_t stream, long long* stamps, int* launched) {
  const bool vec = t_mel % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(log_p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(path) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(index) % 16 == 0;
  // the fewest tokens a lane (at least kMinTPL) that kMaxWarps warps cover
  int tpl = kMinTPL;
  while (32 * kMaxWarps * tpl < t_tok) tpl *= 2;
  cudaError_t err;
  switch (tpl) {
#define GLOW_MAS_RECURRENCE(TPL)                                            \
  case TPL:                                                                 \
    err = launch_recurrence<TPL, TIMED>(log_p, tl, ml, dirs, index, batch, \
                                        t_tok, t_mel, vec, stream, stamps); \
    break;
    GLOW_MAS_RECURRENCE(1)
    GLOW_MAS_RECURRENCE(2)
    GLOW_MAS_RECURRENCE(4)
#undef GLOW_MAS_RECURRENCE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  ++*launched;
  long long* tail = TIMED ? stamps + static_cast<size_t>(batch) * kStamps
                          : nullptr;
  err = vec ? launch_expand<true, TIMED>(index, path, batch, t_tok, t_mel,
                                         stream, tail)
            : launch_expand<false, TIMED>(index, path, batch, t_tok, t_mel,
                                          stream, tail);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// int64 stamps per sample of the timed instantiation
int glow_mas_stamps_per_sample() { return kStamps; }

// frames in a word of the dirs scratch
int glow_mas_chunk_frames() { return kChunk; }

// log_p, path: float32 [batch, t_tok, t_mel] contiguous; lengths: int32
// [batch]; scratch: dirs uint32 [batch, ceil(t_mel/32), t_tok] and index
// int32 [batch, t_mel], written before they are read.  With stamps (int64
// [batch + 1, glow_mas_stamps_per_sample()], row batch holding INT64_MAX
// and 0) the timed instantiation runs.  Launches on `stream`, does not
// synchronise; *launched receives the number of kernels launched.  Returns
// a cudaError_t (0 on success).
int glow_mas_f32(const void* log_p, const void* token_lengths,
                 const void* mel_lengths, void* path, void* dirs, void* index,
                 int batch, int t_tok, int t_mel, void* stream, void* stamps,
                 int* launched) {
  *launched = 0;
  if (batch < 1 || t_tok < 1 || t_tok > kMaxTokens || t_mel < 1)
    return cudaErrorInvalidValue;
  const float* lp = static_cast<const float*>(log_p);
  const int* tl = static_cast<const int*>(token_lengths);
  const int* ml = static_cast<const int*>(mel_lengths);
  float* out = static_cast<float*>(path);
  unsigned* d = static_cast<unsigned*>(dirs);
  int* idx = static_cast<int*>(index);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* st = static_cast<long long*>(stamps);
  return st ? run<true>(lp, tl, ml, out, d, idx, batch, t_tok, t_mel, s, st,
                        launched)
            : run<false>(lp, tl, ml, out, d, idx, batch, t_tok, t_mel, s,
                         nullptr, launched);
}

}  // extern "C"
