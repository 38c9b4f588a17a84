// Single-block attention (kernel B2): O = softmax(Q Kᵀ / √D) V per batch·head
// with the exact row max, on Hopper's tensor cores.
//
// Replaces the TPU kernel `_fused_attention_pallas` in
// predictionio_tpu/ops/attention.py (:389, pallas_call at :427). It
// computes that function with the same numeric contract: q and k rounded
// to bf16 before Q·Kᵀ, sums in f32, the score times 1/√D, an optional
// causal mask (query i sees key j iff i >= j, both from 0, no −inf guard:
// a causal row always sees key 0), the exact row max subtracted,
// p = exp(s − max) in f32, p rounded to bf16 before P·V with f32 sums, and
// the divide by the f32 row sum of the unrounded p after P·V.
//
// Design. The Pallas kernel holds K, V and the whole [Lq, Lk] score tile
// of one batch·head in a TPU core's VMEM. A Hopper block has at most 227 KB
// of shared memory, so the score tile is never stored: one block per (tile
// of 64 query rows, batch·head), 4 warps of 16 rows each, and two passes
// over K in 64-key tiles with the fragments, copies and masks of B3
// (attention_common.cuh):
//   1. S = Q·Kᵀ by mma.sync m16n8k16, scale and mask, and the exact row
//      max in registers, its candidates summed again in the plain
//      version's column order (see B3 and attention_common.cuh);
//   2. S again (the same products on the same operands in the same order,
//      so bit-identical), p = exp(s − max), with a score whose p lies near
//      a bf16 rounding midpoint summed again in column order, Σp in f32
//      from the unrounded p, and O += bf16(P)·V by mma.sync with P's
//      accumulator as the A fragment and V's B fragments by ldmatrix.trans.
// Recomputing S doubles only the Q·Kᵀ tensor work (0.17 µs of bound at
// the scorer's shape). With no score buffer B2 takes any Lk, so
// ops/attention.py routes exactly as the JAX package does (:465). Causal
// K tiles past a warp's last row are skipped: those keys carry p = 0.
//
// Copies and the f32 -> bf16 point are B3's: q rounded into its A
// fragments once per block; K (pass 1) and K and V (pass 2) tiles by
// cp.async into f32 staging tiles, converted once per tile into bf16 tiles,
// the next tile's copy overlapping this tile's products. Why mma.sync and
// why expf: as in flash_attention.cu. Heads of 1 <= D <= 128 are padded to
// DP = 32·ceil(D/32) with zeros. A wider head runs attention_block_wide:
// each score summed over the head in slices of 128 columns (K's slice
// staged, q's slice loaded into fragments, one at a time, no overlap), a
// score that needs settling summed again in column order straight from
// device memory, and one unit per slice of 128 output columns, each
// computing the scores anew. The simplest layout that is right.
//
// Grid. Blocks loop over the units (query tile, batch·head, output slice)
// with the stride of the grid, so any number of batch·heads launches.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 tensor, about
// 3.9 T exponentials/s): the scorer passes one tensor x as q, k and v, so
// the function reads x once and writes o once, 8·B·H·L·D bytes in f32; it
// does 4·D tensor operations and one exponential per visible query-key
// pair. At the scorer's [64, 1, 200, 32] causal that is 3.3 MB → 0.98 µs
// by bytes, against 0.17 µs of tensor work and 0.33 µs of exponentials:
// bytes bound it. This kernel instead is latency-bound: 13 busy warps per
// batch·head, each walking its key tiles twice in sequence, with the
// settling checks on every score of the path.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cmath>
#include <cstddef>

#include "attention_common.cuh"

namespace {

// One unit: the 64 query rows from row0 of batch·head bh, head of at most
// DP columns.
template <int DP>
__device__ __forceinline__ void attend_block(const Tiles<DP>& tiles, const float* q,
                                             const float* k, const float* v, float* o, Unit u,
                                             int Lq, int Lk, int D, bool causal, bool vec,
                                             float scale) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row0 = u.row0;
  const int wrow0 = row0 + warp * kWarpRows;
  const bool active = wrow0 < Lq;
  const float* qg = q + u.bh * (size_t)Lq * D;
  const float* kg = k + u.bh * (size_t)Lk * D;
  const float* vg = v + u.bh * (size_t)Lk * D;
  // keys that some row of the block, and of the warp, sees
  const int kend = causal ? min(Lk, min(Lq, row0 + kBlockQ)) : Lk;
  const int wend = causal ? min(Lk, min(Lq, wrow0 + kWarpRows)) : Lk;

  float* qs = tiles.qs + warp * kWarpRows * DP;
  const WarpRows w{qs, wrow0, Lk, causal, scale, (D + 16) * 0x1p-24f * scale};
  uint32_t qa[DP / 16][4];
  load_q<DP>(qa, qs, qg, wrow0, Lq, D, D, lane);
  float s[kKeyTiles][4], e[kKeyTiles][4];
  auto resum = [&](int b) { return column_score_at<DP>(w, tiles.ks, b, lane); };

  // pass 1: the exact row max
  float m[2] = {-INFINITY, -INFINITY};
  stage_tile<DP>(tiles.stage_k, kg, 0, Lk, D, D, vec);
  cp_async_commit();
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    cp_async_wait_all();
    __syncthreads();  // the staged tile has landed; every warp is done with the bf16 tile
    convert_tile<DP>(tiles.stage_k, tiles.ks);
    __syncthreads();  // the bf16 tile is whole and the staging tile free
    if (k0 + kBlockK < kend) stage_tile<DP>(tiles.stage_k, kg, k0 + kBlockK, Lk, D, D, vec);
    cp_async_commit();
    if (!active || k0 >= wend) continue;  // warp-uniform: every lane skips or none
    float mx[2];
    tile_scores<DP>(s, e, qa, tiles.ks, w, k0, lane);
    settle_max(s, e, mx, m, w, resum);
    m[0] = fmaxf(m[0], mx[0]);
    m[1] = fmaxf(m[1], mx[1]);
  }

  // pass 2: p = exp(s - max), its f32 sum, and P·V
  float acc[DP / 8][4] = {};
  float sum[2] = {0.0f, 0.0f};
  stage_tile<DP>(tiles.stage_k, kg, 0, Lk, D, D, vec);
  stage_tile<DP>(tiles.stage_v, vg, 0, Lk, D, D, vec);
  cp_async_commit();
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    cp_async_wait_all();
    __syncthreads();
    convert_tile<DP>(tiles.stage_k, tiles.ks);
    convert_tile<DP>(tiles.stage_v, tiles.vs);
    __syncthreads();
    if (k0 + kBlockK < kend) {
      stage_tile<DP>(tiles.stage_k, kg, k0 + kBlockK, Lk, D, D, vec);
      stage_tile<DP>(tiles.stage_v, vg, k0 + kBlockK, Lk, D, D, vec);
    }
    cp_async_commit();
    if (!active || k0 >= wend) continue;
    tile_scores<DP>(s, e, qa, tiles.ks, w, k0, lane);  // bit for bit pass 1's
    tile_p(s, e, m, sum, w, resum);
    pv_tile<DP>(acc, s, tiles.vs, lane);
  }

  const float denom[2] = {quad_sum(sum[0]), quad_sum(sum[1])};
  if (!active) return;
  store_rows<DP>(o + u.bh * (size_t)Lq * D, acc, denom, wrow0, Lq, D, D, lane);
}

// at D <= 32 no more than 128 registers, so that four blocks share an SM
template <int DC>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 4 : 1)
    attention_block_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, long long n_bh,
                           int Lq, int Lk, int D, int causal, int vec, float scale,
                           long long units) {
  constexpr int DP = 32 * DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<DP> tiles(smem);
  for (long long blk = blockIdx.x; blk < units; blk += gridDim.x) {
    if (blk != blockIdx.x) __syncthreads();  // the last unit's reads of shared memory are done
    attend_block<DP>(tiles, q, k, v, o, unit_of(blk, n_bh, Lq, 1), Lq, Lk, D, causal != 0,
                     vec != 0, scale);
  }
}

// Heads wider than kChunk: one unit per (query tile, batch·head, output
// slice of kChunk columns). Both passes sum each score over the head in
// slices (wide_tile_scores); every output slice computes the scores anew.
__global__ void __launch_bounds__(kThreads, 1)
    attention_block_wide(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, long long n_bh,
                         int Lq, int Lk, int D, int causal, int vec, float scale,
                         long long units) {
  constexpr int DP = kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<DP> tiles(smem);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int chunks = (D + kChunk - 1) / kChunk;
  float* qs = tiles.qs + warp * kWarpRows * DP;
  for (long long blk = blockIdx.x; blk < units; blk += gridDim.x) {
    const Unit u = unit_of(blk, n_bh, Lq, chunks);
    const int wrow0 = u.row0 + warp * kWarpRows;
    const bool active = wrow0 < Lq;
    const float* qg = q + u.bh * (size_t)Lq * D;
    const float* kg = k + u.bh * (size_t)Lk * D;
    const int c0 = u.chunk * kChunk;
    const int width = min(kChunk, D - c0);
    const float* vg = v + u.bh * (size_t)Lk * D + c0;
    const int kend = causal ? min(Lk, min(Lq, u.row0 + kBlockQ)) : Lk;
    const int wend = causal ? min(Lk, min(Lq, wrow0 + kWarpRows)) : Lk;
    const WarpRows w{qs, wrow0, Lk, causal != 0, scale, (D + 16) * 0x1p-24f * scale};
    float s[kKeyTiles][4], e[kKeyTiles][4];

    float m[2] = {-INFINITY, -INFINITY};
    for (int k0 = 0; k0 < kend; k0 += kBlockK) {
      const bool busy = active && k0 < wend;
      wide_tile_scores(s, e, tiles, qs, qg, kg, nullptr, 0, w, busy, k0, Lq, D, vec != 0, lane);
      if (!busy) continue;
      float mx[2];
      settle_max(s, e, mx, m, w,
                 [&](int b) { return column_score_global(qg, kg, w, k0, b, lane, Lq, D); });
      m[0] = fmaxf(m[0], mx[0]);
      m[1] = fmaxf(m[1], mx[1]);
    }

    float acc[DP / 8][4] = {};
    float sum[2] = {0.0f, 0.0f};
    for (int k0 = 0; k0 < kend; k0 += kBlockK) {
      const bool busy = active && k0 < wend;
      wide_tile_scores(s, e, tiles, qs, qg, kg, vg, width, w, busy, k0, Lq, D, vec != 0, lane);
      if (!busy) continue;
      tile_p(s, e, m, sum, w,
             [&](int b) { return column_score_global(qg, kg, w, k0, b, lane, Lq, D); });
      pv_tile<DP>(acc, s, tiles.vs, lane);
    }
    const float denom[2] = {quad_sum(sum[0]), quad_sum(sum[1])};
    if (active) store_rows<DP>(o + u.bh * (size_t)Lq * D + c0, acc, denom, wrow0, Lq, D, width, lane);
  }
}

template <class Kernel>
cudaError_t launch_kernel(Kernel* kernel, size_t smem, std::atomic<unsigned long long>& smem_set,
                          const AttentionArgs& a) {
  const cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid(), kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.o, a.bh, a.Lq, a.Lk, a.D,
                                                 a.causal, a.vec(), a.scale(), a.tiles());
  return cudaGetLastError();
}

template <int DC>
cudaError_t launch(const AttentionArgs& a) {
  static std::atomic<unsigned long long> smem_set{0};
  return launch_kernel(attention_block_kernel<DC>, Tiles<32 * DC>::kBytes, smem_set, a);
}

cudaError_t launch_wide(const AttentionArgs& a) {
  static std::atomic<unsigned long long> smem_set{0};
  return launch_kernel(attention_block_wide, Tiles<kChunk>::kBytes, smem_set, a);
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for q, o [bh, Lq, D] and k, v [bh, Lk, D], all f32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
int pio_attention_block(const float* q, const float* k, const float* v, float* o, long long bh,
                        int Lq, int Lk, int D, int causal, void* stream) {
  const AttentionArgs a{q, k, v, o, bh, Lq, Lk, D, causal, static_cast<cudaStream_t>(stream)};
  return attention_entry(
      a, [&](auto dc) { return launch<decltype(dc)::value>(a); }, [&] { return launch_wide(a); });
}

}  // extern "C"
