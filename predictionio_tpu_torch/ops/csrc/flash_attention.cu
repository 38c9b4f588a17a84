// Tiled flash attention (kernel B3): O = softmax(Q Kᵀ / √D) V per batch·head,
// with an online softmax over K tiles.
//
// Replaces the TPU kernel `_flash_attention_pallas` in
// predictionio_tpu/ops/attention.py (:285, pallas_call at :369). It
// computes that function with the same numeric contract and guards: q and
// k rounded to bf16 before Q·Kᵀ with f32 sums, the score times 1/√D, an
// optional causal mask (query i sees key j iff i >= j, both from 0); per K
// tile the running max m, a safe max (0 where m is −inf), corr = 0 when the
// previous max is −inf, p = 0 where the score is −inf, p rounded to bf16
// before P·V with f32 sums, acc = acc·corr + P·V and l = l·corr + Σp; at
// the end O = acc / l with l == 0 → 1.
//
// Design. The TPU kernel carries m, l and acc across the sequential K axis
// of its grid in VMEM scratch (:307-364). On Hopper blocks run in parallel
// and in no order, so the K loop is inside the block: one block per
// (batch·head, tile of 32 query rows), 4 warps of 8 rows each. m and l of a
// row live in registers (warp-uniform), the accumulator in registers with
// lanes over the head dimension (columns l, l+32, l+64, l+96). Each K tile
// of 64 keys and its V tile are loaded once into shared memory (bf16-rounded,
// odd row stride), lane l scores keys l and l+32 against the warp's 8 rows,
// the warp reduces the tile max and sum by shuffles, writes its p rows to a
// per-warp shared buffer, and accumulates P·V. Causal K tiles that start
// after the query tile's last row are skipped, as at :354; keys past Lk and
// query rows past Lq are masked by index, so any L works, not only
// multiples of the tile. Tile sizes are this card's choice: `_best_block`'s
// 1024 is a TPU VMEM choice (:271-282).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 tensor, about
// 3.9 TFLOP/s of exponentials): the scorer passes one tensor x as q, k and
// v, so at its [64, 1, 1024, 32] causal the function reads x once and
// writes o once, 16.8 MB → 5.0 µs, against 4.3 GFLOP of tensor work →
// 4.3 µs and 33.6 M exponentials → 8.6 µs: the exponentials bound it. This
// simple kernel runs its products as f32 FMAs fed from shared memory (about
// 2.1 G FMAs there), so shared-memory loads and the FMA pipe limit it well
// above that bound; wgmma with TMA-fed tiles and more rows per block are
// later work.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cmath>
#include <cstddef>
#include <climits>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarp * kWarps;
constexpr int kBlockQ = 32;  // query rows per block
constexpr int kBlockK = 64;  // keys per tile (two per lane)
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

template <int DC>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Lq,
                           int Lk, int D, int ld, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kBlockQ, ld]
  float* Ks = Qs + (size_t)kBlockQ * ld;     // [kBlockK, ld]
  float* Vs = Ks + (size_t)kBlockK * ld;     // [kBlockK, ld]
  float* Ps = Vs + (size_t)kBlockK * ld;     // [kBlockQ, kBlockK] p of each row

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
  // causal: K tiles starting after the last query row are fully masked
  const int kend = causal ? min(Lk, last_row + 1) : Lk;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    const int nk = min(kBlockK, Lk - k0);  // keys of this tile inside Lk
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, c = idx - j * D;
      const bool in = j < nk;
      Ks[j * ld + c] = in ? bf16r(kg[(size_t)(k0 + j) * D + c]) : 0.0f;
      Vs[j * ld + c] = in ? bf16r(vg[(size_t)(k0 + j) * D + c]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.0f;
    const float* ka = Ks + lane * ld;
    const float* kb = Ks + (lane + kWarp) * ld;
    for (int d = 0; d < D; ++d) {
      const float x0 = ka[d], x1 = kb[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = Qs[(warp * kRows + i) * ld + d];
        s[i][0] += qv * x0;
        s[i][1] += qv * x1;
      }
    }

    float* Pw = Ps + (size_t)warp * kRows * kBlockK;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row0 + warp * kRows + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + lane + c * kWarp;
        s[i][c] *= scale;
        if (j >= Lk || (causal && j > row)) s[i][c] = -INFINITY;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float safe = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = m[i] == -INFINITY ? 0.0f : expf(m[i] - safe);
      const float p0 = s[i][0] == -INFINITY ? 0.0f : expf(s[i][0] - safe);
      const float p1 = s[i][1] == -INFINITY ? 0.0f : expf(s[i][1] - safe);
      l[i] = l[i] * corr + warp_sum(p0 + p1);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      Pw[i * kBlockK + lane] = p0;
      Pw[i * kBlockK + lane + kWarp] = p1;
      m[i] = m_new;
    }
    __syncwarp();  // every lane reads p values other lanes wrote

    for (int jl = 0; jl < nk; ++jl) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + c * kWarp;
        vv[c] = d < D ? Vs[jl * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = bf16r(Pw[i * kBlockK + jl]);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + warp * kRows + i;
    if (row >= Lq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    float* og = o + (bh * (size_t)Lq + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + c * kWarp;
      if (d < D) og[d] = acc[i][c] / denom;
    }
  }
}

template <int DC>
cudaError_t launch(const AttentionArgs& a) {
  const int ld = a.D | 1;  // odd row stride: lanes reading down a column hit distinct banks
  const size_t smem =
      ((size_t)(kBlockQ + 2 * kBlockK) * ld + (size_t)kBlockQ * kBlockK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(a.D)));
  const dim3 grid((unsigned)((a.Lq - 1) / kBlockQ + 1), (unsigned)a.bh);  // Lq >= 1 here
  flash_attention_kernel<DC><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.Lq, a.Lk, a.D, ld, a.causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 0 -> query rows per block, 1 -> keys per tile
int pio_flash_tile(int which) { return which == 0 ? kBlockQ : kBlockK; }

// o = attention(q, k, v) for q, o [bh, Lq, D] and k, v [bh, Lk, D], all f32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
int pio_flash_attention(const float* q, const float* k, const float* v, float* o, int bh,
                        int Lq, int Lk, int D, int causal, void* stream) {
  const AttentionArgs a{q, k, v, o, bh, Lq, Lk, D, causal, static_cast<cudaStream_t>(stream)};
  return attention_entry(a, INT_MAX, [&](auto dc) { return launch<decltype(dc)::value>(a); });
}

}  // extern "C"
