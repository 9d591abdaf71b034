// Monotonic alignment search (MAS) as one kernel, float32, bit-exact.
//
// Replaces glow_tts_tpu/ops/mas.py::_mas_kernel, the Pallas kernel behind
// maximum_path_pallas.  For each sample: the Viterbi recurrence over mel
// frames y = 0 .. mel_length-1,
//     v[x] <- max(stay, move) + log_p[x, y]
//     stay = v[x]     (kNeg when x == y)
//     move = v[x-1]   (x == 0: 0 at y == 0, else kNeg)
// with one direction bit per cell, (x == y) | (v[x] < v[x-1]) on the column
// before the update; then the walk from (token_length-1, mel_length-1) down
// to frame 0, which writes one 1 per valid frame into the zeroed path
// [B, T_tok, T_mel].  The plain PyTorch version of the same function is
// glow_tts_tpu_torch/ops/mas.py::maximum_path_reference; the two are held
// equal, so the arithmetic here is exactly its own: f32, one max and one add
// per cell, a strict <, no fast-math.
//
// What bounds it: by the count, bytes (log_p in, path out); in practice the
// T_mel dependent steps of the recurrence, with one block per sample (a
// batch of 32 uses 32 of 132 SMs).  So the design keeps the dependent chain
// short and everything else off it:
// * Grid (batch).  Warp 0 of the block runs the recurrence alone, so no
//   block barrier sits between two frames.  Lane l owns the TPT consecutive
//   tokens l*TPT .. l*TPT+TPT-1 with their values in registers; the x-1
//   neighbour is a register, or one __shfl_up_sync at the lane edge.  TPT is
//   the power of two that covers T_tok with 32 lanes (8 at 224 tokens, at
//   most 32: T_tok <= 1024).
// * The other 7 warps stream log_p a tile of FT frames ahead of warp 0 into
//   a double buffer in shared memory with 4-byte cp.async, read along time
//   (a warp reads 32 consecutive frames of one token: one 128-byte line),
//   and stored transposed as [frame][slot], token x in slot
//   (x % TPT)*32 + x/TPT with a row pitch of 32*TPT + 1 words: warp 0 then
//   reads 32 consecutive words per j, and the writers hit 32 distinct
//   banks.  One __syncthreads per tile.  The same warps zero the path's
//   frames as they go, so the walk only writes the ones.
// * Direction bits are packed TPT to a word (uint8/16/32) per lane and
//   frame, in shared memory: 32 KB at 224 tokens x 1024 frames.
// * Only what the result needs is read: frames below mel_length, tokens
//   below token_length (the rest of the column never feeds a cell the walk
//   visits; it is computed on zeros).
// * Thread 0 walks back: one shared-memory read per frame.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kProducers = kThreads - 32;
constexpr float kNeg = -1.0e9f;
constexpr int kMaxTokens = 1024;
constexpr int kSmemLimit = 232448;  // 227 KB a block may use on sm_90
constexpr int kMaxFT = 32, kMinFT = 8;  // frames per staged tile

template <int TPT>
struct DirWord { using type = uint8_t; };
template <>
struct DirWord<16> { using type = uint16_t; };
template <>
struct DirWord<32> { using type = uint32_t; };

// words between two frames of a staged tile: one slot per (lane, j), padded
// by one so that writers of one token's 32 frames hit 32 banks
template <int TPT>
struct Pitch { static constexpr int value = 32 * TPT + 1; };

template <int TPT>
int smem_bytes(int ft, int t_mel) {
  return 2 * ft * Pitch<TPT>::value * static_cast<int>(sizeof(float)) +
         t_mel * 32 * static_cast<int>(sizeof(typename DirWord<TPT>::type));
}

__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int TPT>
__global__ void __launch_bounds__(kThreads, 1)
    mas_kernel(const float* __restrict__ log_p,
               const int* __restrict__ token_lengths,
               const int* __restrict__ mel_lengths, float* __restrict__ path,
               int t_tok, int t_mel, int ft_shift) {
  using Dir = typename DirWord<TPT>::type;
  constexpr int P = Pitch<TPT>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ft = 1 << ft_shift;
  float* tiles = reinterpret_cast<float*>(smem);               // [2][ft][P]
  Dir* dirs = reinterpret_cast<Dir*>(tiles + 2 * ft * P);      // [t_mel][32]

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tl = token_lengths[b];
  const int ml = min(max(mel_lengths[b], 0), t_mel);
  const int tl_read = min(max(tl, 0), t_tok);
  const size_t sample = static_cast<size_t>(b) * t_tok * t_mel;
  const float* lp = log_p + sample;
  float* out = path + sample;
  const int n_tiles = (t_mel + ft - 1) >> ft_shift;

  // Stage tile `tile` of log_p into its buffer and zero the path's frames
  // of that tile; `who` of `n_who` threads share the work.
  auto stage = [&](int tile, int who, int n_who) {
    float* buf = tiles + (tile & 1) * ft * P;
    const int y0 = tile << ft_shift;
    const int n = t_tok << ft_shift;
    for (int e = who; e < n; e += n_who) {
      const int l = e & (ft - 1), x = e >> ft_shift;
      const int y = y0 + l;
      if (y >= t_mel) continue;
      const size_t at = static_cast<size_t>(x) * t_mel + y;
      out[at] = 0.f;
      if (y < ml) {
        float* dst = buf + l * P + (x % TPT) * 32 + x / TPT;
        if (x < tl_read) {
          cp_async_f32(dst, lp + at);
        } else {
          *dst = 0.f;
        }
      }
    }
    cp_async_wait_all();
  };

  // slots of tokens >= t_tok are never staged: define them once
  for (int i = tid; i < 2 * ft * P; i += kThreads) tiles[i] = 0.f;
  __syncthreads();
  stage(0, tid, kThreads);
  __syncthreads();

  float v[TPT];
#pragma unroll
  for (int j = 0; j < TPT; ++j) v[j] = kNeg;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (warp == 0) {
      const float* buf = tiles + (tile & 1) * ft * P;
      const int y0 = tile << ft_shift;
      const int y1 = min(y0 + ft, ml);
      for (int y = y0; y < y1; ++y) {
        const float* row = buf + (y - y0) * P + lane;
        float lpv[TPT];
#pragma unroll
        for (int j = 0; j < TPT; ++j) lpv[j] = row[j * 32];
        // the column value of token lane*TPT - 1, for the comparison
        // (shifted) and for the move; they differ at token 0 only
        float shifted0 = __shfl_up_sync(0xffffffffu, v[TPT - 1], 1);
        float move0 = shifted0;
        if (lane == 0) {
          shifted0 = kNeg;
          move0 = y == 0 ? 0.f : kNeg;
        }
        unsigned bits = 0;
        // descending, so v[j-1] is still the previous frame's value
#pragma unroll
        for (int j = TPT - 1; j >= 0; --j) {
          const float below = v[j > 0 ? j - 1 : 0];
          const float shifted = j > 0 ? below : shifted0;
          const float move = j > 0 ? below : move0;
          const bool diag = lane * TPT + j == y;
          const float stay = diag ? kNeg : v[j];
          bits |= static_cast<unsigned>(diag || v[j] < shifted) << j;
          v[j] = fmaxf(stay, move) + lpv[j];
        }
        dirs[y * 32 + lane] = static_cast<Dir>(bits);
      }
    } else if (tile + 1 < n_tiles) {
      stage(tile + 1, tid - 32, kProducers);
    }
    __syncthreads();
  }

  if (tid == 0) {
    int index = tl - 1;
    if (index >= 0 && index < t_tok) {
      for (int y = ml - 1; y >= 0; --y) {
        out[static_cast<size_t>(index) * t_mel + y] = 1.f;
        const unsigned word = dirs[y * 32 + index / TPT];
        index -= static_cast<int>((word >> (index % TPT)) & 1u) &
                 static_cast<int>(index > 0);
      }
    }
  }
}

// Largest tile that fits beside the direction bits; 0 if none does.
template <int TPT>
int pick_ft_shift(int t_mel) {
  for (int shift = 5; (1 << shift) >= kMinFT; --shift) {
    if (smem_bytes<TPT>(1 << shift, t_mel) <= kSmemLimit) return shift;
  }
  return 0;
}

template <int TPT>
int max_mel_frames() {
  const int left = kSmemLimit - smem_bytes<TPT>(kMinFT, 0);
  return left / (32 * static_cast<int>(sizeof(typename DirWord<TPT>::type)));
}

template <int TPT>
cudaError_t launch(const float* log_p, const int* token_lengths,
                   const int* mel_lengths, float* path, int batch, int t_tok,
                   int t_mel, cudaStream_t stream) {
  static_assert((1 << 5) == kMaxFT, "pick_ft_shift starts at kMaxFT");
  const int ft_shift = pick_ft_shift<TPT>(t_mel);
  if (ft_shift == 0) return cudaErrorInvalidValue;
  const int bytes = smem_bytes<TPT>(1 << ft_shift, t_mel);
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<TPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  mas_kernel<TPT><<<batch, kThreads, bytes, stream>>>(
      log_p, token_lengths, mel_lengths, path, t_tok, t_mel, ft_shift);
  return cudaGetLastError();
}

// tokens per lane: the power of two that covers t_tok with 32 lanes
int tokens_per_lane(int t_tok) {
  int tpt = 1;
  while (32 * tpt < t_tok) tpt *= 2;
  return tpt;
}

}  // namespace

extern "C" {

const char* glow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most mel frames the kernel takes at t_tok tokens (its direction bits
// must fit in shared memory); 0 when t_tok is out of range.
int glow_mas_max_mel_frames(int t_tok) {
  if (t_tok < 1 || t_tok > kMaxTokens) return 0;
  switch (tokens_per_lane(t_tok)) {
    case 1: return max_mel_frames<1>();
    case 2: return max_mel_frames<2>();
    case 4: return max_mel_frames<4>();
    case 8: return max_mel_frames<8>();
    case 16: return max_mel_frames<16>();
    default: return max_mel_frames<32>();
  }
}

// log_p, path: float32 [batch, t_tok, t_mel] contiguous; lengths: int32
// [batch].  Launches on `stream`, does not synchronise.  Returns a
// cudaError_t (0 on success).
int glow_mas_f32(const void* log_p, const void* token_lengths,
                 const void* mel_lengths, void* path, int batch, int t_tok,
                 int t_mel, void* stream) {
  if (batch < 1 || t_tok < 1 || t_tok > kMaxTokens || t_mel < 1)
    return cudaErrorInvalidValue;
  const float* lp = static_cast<const float*>(log_p);
  const int* tl = static_cast<const int*>(token_lengths);
  const int* ml = static_cast<const int*>(mel_lengths);
  float* out = static_cast<float*>(path);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GLOW_MAS_LAUNCH(TPT) \
  return launch<TPT>(lp, tl, ml, out, batch, t_tok, t_mel, s)
  switch (tokens_per_lane(t_tok)) {
    case 1: GLOW_MAS_LAUNCH(1);
    case 2: GLOW_MAS_LAUNCH(2);
    case 4: GLOW_MAS_LAUNCH(4);
    case 8: GLOW_MAS_LAUNCH(8);
    case 16: GLOW_MAS_LAUNCH(16);
    default: GLOW_MAS_LAUNCH(32);
  }
#undef GLOW_MAS_LAUNCH
}

}  // extern "C"
