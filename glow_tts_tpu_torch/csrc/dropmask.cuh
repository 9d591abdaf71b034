// Counter-hash dropout masks of the train-direction flow kernels: the
// device twin of glow_tts_tpu_torch/ops/dropmask.py (and through it of
// glow_tts_tpu/ops/dropmask.py), bit for bit in uint32 arithmetic.
//
// An element is the pair (global row, channel) with global row =
// sample * (T + k - 1) + frame; it is kept iff
// hash(hash(row * channels + channel + salt)) <= threshold and then scaled
// by 1 / (1 - rate).  The forward kernel, the backward's recompute and the
// backward's gate kernel all call keep_factor, so no mask is stored.

#pragma once

#include <cstdint>

namespace dropmask {

struct Dropout {
  uint32_t seed;       // the int32 seed read as uint32
  uint32_t threshold;  // keep iff bits <= threshold
  float scale;         // 1 / (1 - rate), rounded to float32 by the caller
  int enabled;         // 0: rate == 0, every factor is 1
};

__host__ __device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// salt of one (flow step, WaveNet layer)
__host__ __device__ __forceinline__ uint32_t layer_salt(uint32_t seed,
                                                        uint32_t step,
                                                        uint32_t layer,
                                                        uint32_t num_layers) {
  const uint32_t sid = step * num_layers + layer;
  return hash_u32(seed ^ (sid * 0x9E3779B9u));
}

// first element's counter of a row: add the channel to it
__host__ __device__ __forceinline__ uint32_t row_counter(uint32_t sample,
                                                         uint32_t frame,
                                                         uint32_t rows_per_sample,
                                                         uint32_t channels,
                                                         uint32_t salt) {
  return (sample * rows_per_sample + frame) * channels + salt;
}

__host__ __device__ __forceinline__ float keep_factor(const Dropout& d,
                                                      uint32_t counter) {
  return hash_u32(hash_u32(counter)) <= d.threshold ? d.scale : 0.f;
}

}  // namespace dropmask
