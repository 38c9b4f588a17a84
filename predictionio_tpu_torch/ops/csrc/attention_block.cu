// Single-block attention (kernel B2): O = softmax(Q Kᵀ / √D) V per batch·head.
//
// Replaces the TPU kernel `_fused_attention_pallas` in
// predictionio_tpu/ops/attention.py (:389, pallas_call at :427). It
// computes that function with the same numeric contract: q and k rounded
// to bf16 before Q·Kᵀ, sums in f32, the score times 1/√D, an optional
// causal mask (query i sees key j iff i >= j, both from 0, no −inf guard:
// a causal row always sees key 0), the exact row max subtracted,
// p = exp(s − max) in f32, p rounded to bf16 before P·V with f32 sums, and
// the divide by the f32 row sum of p after P·V.
//
// Design. The Pallas kernel holds K, V and the whole [Lq, Lk] score tile
// of one batch·head in a TPU core's VMEM. A Hopper block has at most 227 KB
// of shared memory, and K and V alone take 512 KB in f32 at D = 128 and
// Lk = 1023. So one block takes 16 query rows (4 warps, 4 rows each) of one
// batch·head and keeps their whole score rows [16, Lk] in shared memory,
// which keeps the row max exact as in B2; K and V stream through one
// shared [64, D] chunk buffer in two passes:
//   1. scores and row max: each warp owns its rows; lane l scores keys l
//      and l+32 of the chunk against every row of its warp (the query value
//      is a broadcast read, the key row stride is odd, so no bank
//      conflicts);
//   2. p = exp(s − max) in place and the row sum (warp shuffles), then P·V
//      with lanes over the head dimension (columns l, l+32, l+64, l+96).
// Products of bf16-rounded values are exact in f32, so plain FMAs give the
// tensor-core contract. Causal tiles stop their key loop after the tile's
// last row: those keys carry p = 0, so the result is the same. Any
// 1 <= D <= 128 works (padded to an odd stride in shared memory). Lk is at
// most 2048 (172 KB of shared memory at D = 128); ops/attention.py routes a
// longer Lk to B3, which computes the same function.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 tensor, about
// 3.9 TFLOP/s of exponentials): the scorer passes one tensor x as q, k
// and v, so the function reads x once and writes o once, 8·B·H·L·D bytes
// in f32; it does 4·D tensor operations and one exponential per visible
// query-key pair. At the scorer's [64, 1, 200, 32] causal that is 3.3 MB →
// 0.98 µs by bytes, against 0.17 µs of tensor work and 0.33 µs of
// exponentials: bytes bound it. This simple kernel instead reads x three
// times, runs its products as f32 FMAs fed from shared memory and is
// limited by shared-memory loads and launch latency; wgmma, TMA and keeping
// K/V resident between the two passes are later work.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cmath>
#include <cstddef>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kChunk = 64;               // keys per K/V chunk (two per lane)
constexpr int kMaxLk = 2048;

template <int DC>
__global__ void __launch_bounds__(kThreads)
    attention_block_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Lq,
                           int Lk, int D, int ld, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBlockQ, ld] bf16-rounded queries
  float* KV = Qs + (size_t)kBlockQ * ld;   // [kChunk, ld] one K or V chunk
  float* S = KV + (size_t)kChunk * ld;     // [kBlockQ, Lk] scores, then p

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ;
  const float* qg = q + bh * (size_t)Lq * D;
  const float* kg = k + bh * (size_t)Lk * D;
  const float* vg = v + bh * (size_t)Lk * D;

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int row = row0 + r;
    Qs[r * ld + c] = row < Lq ? bf16r(qg[(size_t)row * D + c]) : 0.0f;
  }
  const int last_row = min(Lq, row0 + kBlockQ) - 1;
  const int kend = causal ? min(Lk, last_row + 1) : Lk;

  // pass 1: scores and the exact row max
  float mx[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) mx[i] = -INFINITY;
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int nk = min(kChunk, kend - c0);
    __syncthreads();  // the previous chunk is fully read
    for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
      const int j = idx / D, c = idx - j * D;
      KV[j * ld + c] = bf16r(kg[(size_t)(c0 + j) * D + c]);
    }
    __syncthreads();
    float acc[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.0f;
    const float* ka = KV + lane * ld;
    const float* kb = KV + (lane + kWarp) * ld;
    for (int d = 0; d < D; ++d) {
      const float x0 = ka[d], x1 = kb[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = Qs[(warp * kRows + i) * ld + d];
        acc[i][0] += qv * x0;
        acc[i][1] += qv * x1;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      const int row = row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jl = lane + c * kWarp;
        if (jl < nk) {
          const int j = c0 + jl;
          float s = acc[i][c] * scale;
          if (causal && j > row) s = -INFINITY;
          S[(size_t)r * Lk + j] = s;
          mx[i] = fmaxf(mx[i], s);
        }
      }
    }
  }

  // p = exp(s - max) in place, and the f32 row sum of p
  float l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float m = warp_max(mx[i]);
    float* Sr = S + (size_t)(warp * kRows + i) * Lk;
    float part = 0.0f;
    for (int j = lane; j < kend; j += kWarp) {
      const float p = expf(Sr[j] - m);
      Sr[j] = p;
      part += p;
    }
    l[i] = warp_sum(part);
  }
  __syncwarp();  // every lane reads p values other lanes wrote

  // pass 2: P·V with p rounded to bf16
  float oacc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) oacc[i][c] = 0.0f;
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int nk = min(kChunk, kend - c0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
      const int j = idx / D, c = idx - j * D;
      KV[j * ld + c] = bf16r(vg[(size_t)(c0 + j) * D + c]);
    }
    __syncthreads();
    for (int jl = 0; jl < nk; ++jl) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + c * kWarp;
        vv[c] = d < D ? KV[jl * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = bf16r(S[(size_t)(warp * kRows + i) * Lk + c0 + jl]);
#pragma unroll
        for (int c = 0; c < DC; ++c) oacc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + warp * kRows + i;
    if (row >= Lq) continue;
    float* og = o + (bh * (size_t)Lq + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + c * kWarp;
      if (d < D) og[d] = oacc[i][c] / l[i];
    }
  }
}

template <int DC>
cudaError_t launch(const AttentionArgs& a) {
  const int ld = a.D | 1;  // odd row stride: lanes reading down a column hit distinct banks
  const size_t smem =
      ((size_t)(kBlockQ + kChunk) * ld + (size_t)kBlockQ * a.Lk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_block_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(a.D)));
  const dim3 grid((unsigned)((a.Lq - 1) / kBlockQ + 1), (unsigned)a.bh);  // Lq >= 1 here
  attention_block_kernel<DC><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.Lq, a.Lk, a.D, ld, a.causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pio_attention_block_max_lk() { return kMaxLk; }

// o = attention(q, k, v) for q, o [bh, Lq, D] and k, v [bh, Lk, D], all f32,
// contiguous, on the current device; Lk <= kMaxLk. Returns a cudaError_t
// (0 = launched).
int pio_attention_block(const float* q, const float* k, const float* v, float* o, int bh,
                        int Lq, int Lk, int D, int causal, void* stream) {
  const AttentionArgs a{q, k, v, o, bh, Lq, Lk, D, causal, static_cast<cudaStream_t>(stream)};
  return attention_entry(a, kMaxLk, [&](auto dc) { return launch<decltype(dc)::value>(a); });
}

}  // extern "C"
