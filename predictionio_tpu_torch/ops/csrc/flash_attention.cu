// Tiled flash attention (kernel B3): O = softmax(Q Kᵀ / √D) V per batch·head,
// with an online softmax over K tiles, on Hopper's tensor cores.
//
// Replaces the TPU kernel `_flash_attention_pallas` in
// predictionio_tpu/ops/attention.py (:285, pallas_call at :369). It
// computes that function with the same numeric contract and guards: q and
// k rounded to bf16 before Q·Kᵀ with f32 sums, the score times 1/√D, an
// optional causal mask (query i sees key j iff i >= j, both from 0); per K
// tile the running max m, a safe max (0 where m is −inf), corr = 0 when the
// previous max is −inf, p = 0 where the score is −inf, p rounded to bf16
// before P·V with f32 sums, acc = acc·corr + P·V and l = l·corr + Σp (p
// unrounded); at the end O = acc / l with l == 0 → 1.
//
// Design. The TPU kernel carries m, l and acc across the sequential K axis
// of its grid in VMEM scratch (:307-364). On Hopper blocks run in parallel
// and in no order, so the K loop is inside the block. One block per (tile
// of 64 query rows, batch·head), 4 warps of 16 rows each; blocks are
// numbered so that the last query tiles, which see the most keys under the
// causal mask, start first. Per K tile of 64 keys (the plain version's
// FLASH_BLOCK_K: the online softmax rounds p against each tile's running
// max, so the two agree only when their K tiles do):
//   1. S = Q·Kᵀ by mma.sync m16n8k16 (bf16 in, f32 sums): Q sits in
//      registers as A fragments for the whole K loop, K's B fragments come
//      from shared memory by ldmatrix; beside it |Q|·|K|ᵀ, each score's
//      bound on how far the tensor cores' sum can lie from the plain
//      version's column-order sum;
//   2. scale, the index mask (only on a ragged or diagonal tile), the tile
//      max and Σp by 4-lane shuffles inside each quad, the rescale of acc
//      and l, all in registers. A score within its bound of the row's max,
//      or whose p lies within its bound of a bf16 rounding midpoint, is
//      summed again in column order first (attention_common.cuh says why:
//      otherwise bf16(p) can round the other way and move an output by up
//      to 1e-3). About one score in a hundred at the scorer's shapes;
//   3. O += bf16(P)·V by mma.sync: the S accumulator, rounded to bf16 and
//      packed in pairs, is already the A fragment; V's B fragments come by
//      ldmatrix.trans.
// Causal K tiles past a warp's last row are skipped, as at :354 (at a
// warp's 16 rows, not the block's 64: a fully masked tile leaves m, l and
// acc bit-identical, so the result is the same).
//
// Copies and the f32 -> bf16 point. Inputs are f32 and the fragments bf16.
// q is rounded where its fragments are built, once per block, straight
// from global memory. K and V tiles come by cp.async (16-byte copies when
// D % 4 == 0, 4-byte otherwise, zero-filled past Lk and D) into one f32
// staging tile each; after the tile lands the block converts it once into
// bf16 tiles (round to nearest even, __floats2bfloat162_rn) and then starts
// the next tile's copy, which overlaps this tile's products. D is padded to
// DP = 32·ceil(D/32) with zeros; the kernel is instantiated per DP. A head
// wider than 128 runs flash_attention_wide, as B2's wide kernel does
// (attention_block.cu): scores summed over 128-column slices, settling from
// device memory, one unit per 128 output columns. Blocks loop over the
// units with the stride of the grid, so any number of batch·heads launches.
//
// Why mma.sync and not wgmma. At the scorer's [64, 1, 1024, 32] causal the
// card's bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16, about 3.9 T
// exponentials/s) is the exponentials, 33.6 M → 8.6 µs, against 4.3 µs of
// tensor work and 5.0 µs of bytes. With the tensor term half the
// exponentials' term, wgmma's rate buys nothing here, while its 64-row
// warpgroup tile and shared-memory descriptors would cost a layout of Q
// and P in shared memory; mma.sync keeps P in registers. This kernel takes
// about 13 times that bound on an H100: the instruction stream of expf, the
// mask and the per-score settling checks (about 40 % of its time) limit it.
//
// Why expf. The plain version's torch.exp and CUDA's expf give the same p
// for the same f32 argument. A faster exp2f of pre-scaled scores or
// __expf moves p by ulps, and where p lies near a bf16 rounding midpoint
// it then rounds the other way: one bf16 ulp of a large p moves an output
// by 1e-5 to 1e-3 at these shapes, past the 1e-5 limit against the plain
// version. Settling such p as the scores are settled would cost a second
// exponential wherever the two forms could disagree.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cmath>
#include <cstddef>

#include "attention_common.cuh"

namespace {

// The online-softmax step of one K tile for the thread's two rows: the
// tile's settled max mx, the rescale of acc and l, p and Σp, and P·V.
template <int DP, class Resum>
__device__ __forceinline__ void online_step(float (&s)[kKeyTiles][4], const float (&e)[kKeyTiles][4],
                                            float (&acc)[DP / 8][4], float (&m)[2], float (&l)[2],
                                            const __nv_bfloat16* vs, const WarpRows& w, int lane,
                                            Resum&& resum) {
  float mx[2];
  settle_max(s, e, mx, m, w, resum);
  float safe[2], corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r]);
    safe[r] = m_new == -INFINITY ? 0.0f : m_new;
    corr[r] = m[r] == -INFINITY ? 0.0f : expf(m[r] - safe[r]);
    m[r] = m_new;
  }
  tile_p(s, e, safe, sum, w, resum);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    acc[nt][0] *= corr[0];
    acc[nt][1] *= corr[0];
    acc[nt][2] *= corr[1];
    acc[nt][3] *= corr[1];
  }
  pv_tile<DP>(acc, s, vs, lane);
}

// One unit: the 64 query rows from row0 of batch·head bh, head of at most
// DP columns.
template <int DP>
__device__ __forceinline__ void attend_flash(const Tiles<DP>& tiles, const float* q,
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
  float acc[DP / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  auto resum = [&](int b) { return column_score_at<DP>(w, tiles.ks, b, lane); };

  stage_tile<DP>(tiles.stage_k, kg, 0, Lk, D, D, vec);
  stage_tile<DP>(tiles.stage_v, vg, 0, Lk, D, D, vec);
  cp_async_commit();
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    cp_async_wait_all();
    __syncthreads();  // the staged tile has landed; every warp is done with the bf16 tiles
    convert_tile<DP>(tiles.stage_k, tiles.ks);
    convert_tile<DP>(tiles.stage_v, tiles.vs);
    __syncthreads();  // the bf16 tiles are whole and the staging tiles free
    if (k0 + kBlockK < kend) {
      stage_tile<DP>(tiles.stage_k, kg, k0 + kBlockK, Lk, D, D, vec);
      stage_tile<DP>(tiles.stage_v, vg, k0 + kBlockK, Lk, D, D, vec);
    }
    cp_async_commit();
    if (!active || k0 >= wend) continue;  // warp-uniform: every lane skips or none

    float s[kKeyTiles][4], e[kKeyTiles][4];
    tile_scores<DP>(s, e, qa, tiles.ks, w, k0, lane);
    online_step<DP>(s, e, acc, m, l, tiles.vs, w, lane, resum);
  }

  if (!active) return;
  const float denom[2] = {l[0] == 0.0f ? 1.0f : l[0], l[1] == 0.0f ? 1.0f : l[1]};
  store_rows<DP>(o + u.bh * (size_t)Lq * D, acc, denom, wrow0, Lq, D, D, lane);
}

// at D <= 32 no more than 128 registers, so that four blocks share an SM
template <int DC>
__global__ void __launch_bounds__(kThreads, DC == 1 ? 4 : 1)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, long long n_bh,
                           int Lq, int Lk, int D, int causal, int vec, float scale,
                           long long units) {
  constexpr int DP = 32 * DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles<DP> tiles(smem);
  for (long long blk = blockIdx.x; blk < units; blk += gridDim.x) {
    if (blk != blockIdx.x) __syncthreads();  // the last unit's reads of shared memory are done
    attend_flash<DP>(tiles, q, k, v, o, unit_of(blk, n_bh, Lq, 1), Lq, Lk, D, causal != 0,
                     vec != 0, scale);
  }
}

// Heads wider than kChunk: one unit per (query tile, batch·head, output
// slice of kChunk columns); each score summed over the head in slices
// (wide_tile_scores), and every output slice computes the scores anew.
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wide(const float* __restrict__ q, const float* __restrict__ k,
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
    float acc[DP / 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    for (int k0 = 0; k0 < kend; k0 += kBlockK) {
      const bool busy = active && k0 < wend;
      float s[kKeyTiles][4], e[kKeyTiles][4];
      wide_tile_scores(s, e, tiles, qs, qg, kg, vg, width, w, busy, k0, Lq, D, vec != 0, lane);
      if (!busy) continue;
      online_step<DP>(s, e, acc, m, l, tiles.vs, w, lane,
                      [&](int b) { return column_score_global(qg, kg, w, k0, b, lane, Lq, D); });
    }
    if (!active) continue;
    const float denom[2] = {l[0] == 0.0f ? 1.0f : l[0], l[1] == 0.0f ? 1.0f : l[1]};
    store_rows<DP>(o + u.bh * (size_t)Lq * D + c0, acc, denom, wrow0, Lq, D, width, lane);
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
  return launch_kernel(flash_attention_kernel<DC>, Tiles<32 * DC>::kBytes, smem_set, a);
}

cudaError_t launch_wide(const AttentionArgs& a) {
  static std::atomic<unsigned long long> smem_set{0};
  return launch_kernel(flash_attention_wide, Tiles<kChunk>::kBytes, smem_set, a);
}

}  // namespace

extern "C" {

// 0 -> query rows per block, 1 -> keys per tile
int pio_flash_tile(int which) { return which == 0 ? kBlockQ : kBlockK; }

// o = attention(q, k, v) for q, o [bh, Lq, D] and k, v [bh, Lk, D], all f32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
int pio_flash_attention(const float* q, const float* k, const float* v, float* o, long long bh,
                        int Lq, int Lk, int D, int causal, void* stream) {
  const AttentionArgs a{q, k, v, o, bh, Lq, Lk, D, causal, static_cast<cudaStream_t>(stream)};
  return attention_entry(
      a, [&](auto dc) { return launch<decltype(dc)::value>(a); }, [&] { return launch_wide(a); });
}

}  // extern "C"
