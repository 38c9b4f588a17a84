// What the two attention kernels (attention_block.cu, B2, and
// flash_attention.cu, B3) share: the bf16 rounding and warp reductions of
// their numeric contract, the argument checks and head-width dispatch of
// their C entries, and the C helpers that ops/attention.py reads. Each
// kernel source includes this file once and builds into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxHeadDim = 128;
constexpr unsigned kFull = 0xffffffffu;

// round to bf16 (nearest even) and widen back to f32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// q, o [bh, Lq, D] and k, v [bh, Lk, D], all f32, contiguous, on the
// current device
struct AttentionArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int bh, Lq, Lk, D, causal;
  cudaStream_t stream;
};

// Checks the arguments and calls launch(std::integral_constant<int, DC>)
// with DC = ceil(D / 32), the head-dimension columns per lane. Returns a
// cudaError_t (0 = launched, or nothing to do).
template <class Launch>
int attention_entry(const AttentionArgs& a, int max_lk, Launch&& launch) {
  if (a.bh < 0 || a.bh > 65535 || a.Lq < 0 || a.Lk < 1 || a.Lk > max_lk || a.D < 1 ||
      a.D > kMaxHeadDim)
    return cudaErrorInvalidValue;
  if (a.bh == 0 || a.Lq == 0) return cudaSuccess;
  switch ((a.D + kWarp - 1) / kWarp) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    default: return launch(std::integral_constant<int, 4>{});
  }
}

}  // namespace

extern "C" {

int pio_attention_max_head_dim() { return kMaxHeadDim; }

const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
