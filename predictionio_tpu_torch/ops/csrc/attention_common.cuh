// What the two attention kernels (attention_block.cu, B2, and
// flash_attention.cu, B3) share: the tile shapes, the cp.async staging of
// K and V tiles and their f32 -> bf16 conversion, the tensor-core fragments
// (ldmatrix loads, bf16 packing, mma.sync) and quad reductions, the score
// masking and the settling of scores in the plain version's summation order,
// the argument checks and head-width dispatch of their C entries, and the C
// helpers that ops/attention.py reads. Each kernel source
// includes this file once and builds into its own library.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with bf16 inputs and f32 sums).
// A warp owns 16 query rows. Lane l is in quad g = l / 4 at position
// t = l % 4; it holds rows g and g + 8 of every accumulator tile, columns
// 2t and 2t + 1 of each 8-wide n-tile. So a row's max and sum need only a
// shuffle across the 4 lanes of its quad, and the score accumulator of
// Q·Kᵀ, rounded to bf16 and packed in pairs, is the A fragment of P·V
// without a pass through shared memory (FlashAttention-2's layout).

#pragma once

#include <cuda_bf16.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "cuda_common.cuh"

namespace {

constexpr int kWarps = 4;                    // warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kWarpRows = 16;                // query rows per warp: one mma row tile
constexpr int kBlockQ = kWarps * kWarpRows;  // query rows per block
constexpr int kBlockK = 64;                  // keys per K/V tile
constexpr int kKeyTiles = kBlockK / 8;       // 8-key n-tiles of one score tile
constexpr int kKeyChunks = kBlockK / 16;     // 16-key k-chunks of one P·V step
constexpr int kChunk = 128;  // head columns per slice past D = 128

// ---------------------------------------------------------------------------
// Shared memory: one f32 staging tile per operand, filled by cp.async while
// the warps compute on the bf16 tiles, which the block converts from it.
// DP is the head width padded to a multiple of 32 (narrow heads, D <= 128),
// or kChunk, the width of one slice of a wider head. The bf16 row stride is
// DP + 8 elements, 16 bytes past a multiple of 64, so the 8 rows that one
// ldmatrix phase reads land in 8 different 16-byte bank groups.
// ---------------------------------------------------------------------------

template <int DP>
struct Tiles {
  static constexpr int kLd = DP + 8;
  static constexpr size_t kBytes = (2 * kBlockK + kBlockQ) * DP * sizeof(float) +
                                   2 * kBlockK * kLd * sizeof(__nv_bfloat16);
  float* stage_k;      // [kBlockK, DP] f32
  float* stage_v;      // [kBlockK, DP] f32
  float* qs;           // [kBlockQ, DP] f32, the block's bf16-rounded q rows for column_score
  __nv_bfloat16* ks;   // [kBlockK, kLd] bf16
  __nv_bfloat16* vs;   // [kBlockK, kLd] bf16

  __device__ explicit Tiles(unsigned char* base)
      : stage_k(reinterpret_cast<float*>(base)),
        stage_v(stage_k + kBlockK * DP),
        qs(stage_v + kBlockK * DP),
        ks(reinterpret_cast<__nv_bfloat16*>(qs + kBlockQ * DP)),
        vs(ks + kBlockK * kLd) {}
};

// Starts copying keys [k0, k0 + kBlockK) of one batch·head's f32 rows (row
// stride ld) into a [kBlockK, DP] staging tile, columns [0, width) of g.
// Rows past Lk and columns past width are zero-filled (a copy of source
// size 0). vec: ld % 4 == 0 and the rows 16-byte aligned, so whole float4s
// move; else one float at a time.
template <int DP>
__device__ __forceinline__ void stage_tile(float* stage, const float* g, int k0, int Lk, int ld,
                                           int width, bool vec) {
  constexpr int kQuads = DP / 4;
#pragma unroll
  for (int i = 0; i < kBlockK * kQuads / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kQuads, c = (idx - r * kQuads) * 4;
    const int row = k0 + r;
    float* dst = stage + r * DP + c;
    const float* src = g + (size_t)row * ld + c;
    if (vec) {
      const bool in = row < Lk && c < width;
      cp_async16(dst, in ? src : g, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row < Lk && c + j < width;
        cp_async4(dst + j, in ? src + j : g, in);
      }
    }
  }
}

// two f32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The one f32 -> bf16 pass of K and V: staging tile -> bf16 tile, rounded
// to nearest even, four values per thread and step.
template <int DP>
__device__ __forceinline__ void convert_tile(const float* stage, __nv_bfloat16* dst) {
  constexpr int kQuads = DP / 4;
#pragma unroll
  for (int i = 0; i < kBlockK * kQuads / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kQuads, c = (idx - r * kQuads) * 4;
    const float4 f = *reinterpret_cast<const float4*>(stage + r * DP + c);
    *reinterpret_cast<uint2*>(dst + r * Tiles<DP>::kLd + c) =
        make_uint2(pack_bf16x2(f.x, f.y), pack_bf16x2(f.z, f.w));
  }
}

// ---------------------------------------------------------------------------
// Fragments and tensor-core products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a · b on the tensor cores: a 16x16 bf16, b 16x8 bf16, d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float load_or_zero(const float* g, int row, int col, int rows,
                                             int cols, int ld) {
  return row < rows && col < cols ? __ldg(g + (size_t)row * ld + col) : 0.0f;
}

// The warp's 16 query rows from row0 (row stride ld) as bf16 A fragments of
// Q·Kᵀ, one per 16 columns of the head dimension: rows past Lq and columns
// past width are 0. The f32 -> bf16 rounding of q happens here, once per
// block and head slice. The rounded values also go, as f32, to the warp's
// 16 rows of shared memory at qs (the fragments cover every element once);
// only this warp reads them.
template <int DP>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DP / 16][4], float* qs, const float* qg,
                                       int row0, int Lq, int ld, int width, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows g, g+8 at columns 2t.., then again at 2t+8..
      const int r = g + (i & 1) * 8;
      const int col = kc * 16 + (i >> 1) * 8 + 2 * t;
      qa[kc][i] = pack_bf16x2(load_or_zero(qg, row0 + r, col, Lq, width, ld),
                              load_or_zero(qg, row0 + r, col + 1, Lq, width, ld));
      *reinterpret_cast<float2*>(qs + r * DP + col) =
          make_float2(__uint_as_float(qa[kc][i] << 16), __uint_as_float(qa[kc][i] & 0xffff0000u));
    }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Scores, and the few that the tensor cores cannot settle alone
//
// The tensor cores sum a score's exact bf16 products in their own order and
// rounding; torch's f32 matrix product on the card, which the plain versions
// use, sums them one column after another with fused multiply-adds. The two
// sums differ by ulps. That is harmless except where it moves a row's max,
// which every p of the row is taken against, or where p lies so close to a
// bf16 rounding midpoint that bf16(p) rounds the other way: one bf16 ulp of
// p moves an output by up to 1e-3 at the scorer's shapes. So each score gets
// a bound on how far the two sums can lie apart, tol·Σ|q_d·k_d|, with
// Σ|q_d·k_d| from a second tensor-core product of the absolute values
// (sign bits cleared) and tol = (D + 16)·2⁻²⁴·scale: (D − 1)·2⁻²⁴ covers the
// column-order sum's worst case, the other 17·2⁻²⁴ the tensor cores' own
// rounding, with room (tests/test_torch_gpu.py). A score within its
// bound of its row's max over the tile, or whose p lies within its bound of
// a bf16 rounding midpoint, is summed again in column order
// (column_score). That is under one score in a hundred at the scorer's
// shapes, and it keeps kernel and plain version agreeing to f32 rounding.
// The scale multiply and the max subtraction are rounded one at a time
// (__fmul_rn, __fsub_rn), as the plain version's separate torch operations
// round them: nvcc would otherwise fuse them into one multiply-add, and a
// p near a midpoint could round the other way after all.
// ---------------------------------------------------------------------------

// What a warp's score code needs beside the fragments and the K tile.
struct WarpRows {
  const float* qs;  // the warp's 16 bf16-rounded q rows, f32, in shared memory
  int row0;         // the warp's first query row
  int Lk;
  bool causal;
  float scale;  // 1/√D in f32
  float tol;    // (D + 16)·2⁻²⁴·scale
};

// The plain version's score of a q row (bf16-rounded, f32) against a bf16
// K tile row, both in shared memory and zero past D: the products summed in
// f32 one column after another by fused multiply-adds from 0 (the zero
// columns add exact zeros), then scaled.
template <int DP>
__device__ __forceinline__ float column_score(const float* q, const __nv_bfloat16* k,
                                              float scale) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < DP; c += 8) {
    const float4 q0 = *reinterpret_cast<const float4*>(q + c);
    const float4 q1 = *reinterpret_cast<const float4*>(q + c + 4);
    const uint4 kv = *reinterpret_cast<const uint4*>(k + c);
    const float qf[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 pair, the lower column in the low half
      s = fmaf(qf[2 * j], __uint_as_float(kw[j] << 16), s);
      s = fmaf(qf[2 * j + 1], __uint_as_float(kw[j] & 0xffff0000u), s);
    }
  }
  return __fmul_rn(s, scale);
}

// column_score of the thread's score number b = nt·4 + i against the bf16
// K tile at ks
template <int DP>
__device__ __forceinline__ float column_score_at(const WarpRows& w, const __nv_bfloat16* ks, int b,
                                                 int lane) {
  const int r = (lane >> 2) + ((b >> 1) & 1) * 8;
  const int key = (b >> 2) * 8 + 2 * (lane & 3) + (b & 1);
  return column_score<DP>(w.qs + r * DP, ks + key * Tiles<DP>::kLd, w.scale);
}

// The same column-order score for a head wider than one slice, straight
// from device memory: q row and key of the thread's score number b against
// keys from k0, both rounded to bf16 as the slices round them, over all D
// columns. A row past Lq has q = 0 and scores 0, as in column_score.
__device__ __forceinline__ float column_score_global(const float* qg, const float* kg,
                                                     const WarpRows& w, int k0, int b, int lane,
                                                     int Lq, int D) {
  const int row = w.row0 + (lane >> 2) + ((b >> 1) & 1) * 8;
  const int key = k0 + (b >> 2) * 8 + 2 * (lane & 3) + (b & 1);
  if (row >= Lq) return 0.0f;
  const float* qr = qg + (size_t)row * D;
  const float* kr = kg + (size_t)key * D;
  float s = 0.0f;
  for (int c = 0; c < D; ++c)
    s = fmaf(__bfloat162float(__float2bfloat16_rn(__ldg(qr + c))),
             __bfloat162float(__float2bfloat16_rn(__ldg(kr + c))), s);
  return __fmul_rn(s, w.scale);
}

// v[b / 4][b % 4] = x for a b known only at run time, by selects: an index
// into a register array would move the array to local memory.
__device__ __forceinline__ void put(float (&v)[kKeyTiles][4], int b, float x) {
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (b == nt * 4 + i) v[nt][i] = x;
}

// Whether a K tile needs the index mask for a warp whose first row is row0:
// a ragged last tile, or a causal tile reaching past that row.
__device__ __forceinline__ bool tile_masked(int k0, int Lk, int row0, bool causal) {
  return k0 + kBlockK > Lk || (causal && k0 + kBlockK - 1 > row0);
}

// The warp's 16 rows against the 64 keys of the bf16 K tile: s += Q·Kᵀ by
// mma.sync with f32 sums, and e += Σ|q_d·k_d| (the score's bound is tol·e),
// over the DP columns of the fragments and the tile. The thread's rows are
// g (s[.][0..1]) and g + 8 (s[.][2..3]) of the warp's. ldmatrix (no
// transpose) of K's rows gives the B fragment of Kᵀ: matrix m of an x4
// load is keys (m / 2)·8.. at columns (m % 2)·8.., so one load feeds two
// n-tiles of one 16-column chunk.
template <int DP>
__device__ __forceinline__ void tile_products(float (&s)[kKeyTiles][4], float (&e)[kKeyTiles][4],
                                              const uint32_t (&qa)[DP / 16][4],
                                              const __nv_bfloat16* ks, int lane) {
  constexpr uint32_t kAbs = 0x7fff7fffu;  // clears the sign bits of two packed bf16
  const int m = lane >> 3, r = lane & 7;
  const __nv_bfloat16* base = ks + ((m >> 1) * 8 + r) * Tiles<DP>::kLd + (m & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const uint32_t qabs[4] = {qa[kc][0] & kAbs, qa[kc][1] & kAbs, qa[kc][2] & kAbs,
                              qa[kc][3] & kAbs};
#pragma unroll
    for (int np = 0; np < kKeyTiles / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, base + np * 16 * Tiles<DP>::kLd + kc * 16);
      mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
      mma_bf16(e[2 * np], qabs, b[0] & kAbs, b[1] & kAbs);
      mma_bf16(e[2 * np + 1], qabs, b[2] & kAbs, b[3] & kAbs);
    }
  }
}

__device__ __forceinline__ void zero_scores(float (&s)[kKeyTiles][4], float (&e)[kKeyTiles][4]) {
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = e[nt][i] = 0.0f;
}

// The summed products of the tile at key k0 become scores: s·scale, and −inf
// where key k0 + column is past Lk or, causal, past the row (query i sees
// key j iff i >= j, both from 0); e is −inf there too.
__device__ __forceinline__ void finish_scores(float (&s)[kKeyTiles][4], float (&e)[kKeyTiles][4],
                                              const WarpRows& w, int k0, int lane) {
  const bool masked = tile_masked(k0, w.Lk, w.row0, w.causal);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = __fmul_rn(s[nt][i], w.scale);
      if (masked) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        if (key >= w.Lk || (w.causal && key > w.row0 + g + (i >> 1) * 8)) {
          s[nt][i] = -INFINITY;
          e[nt][i] = -INFINITY;  // a NaN bound in tile_p: never flagged
        }
      }
    }
}

// The warp's 16 rows against the 64 keys of the bf16 K tile at key k0, for
// a head of at most DP columns: the scores and their bounds.
template <int DP>
__device__ __forceinline__ void tile_scores(float (&s)[kKeyTiles][4], float (&e)[kKeyTiles][4],
                                            const uint32_t (&qa)[DP / 16][4],
                                            const __nv_bfloat16* ks, const WarpRows& w, int k0,
                                            int lane) {
  zero_scores(s, e);
  tile_products<DP>(s, e, qa, ks, lane);
  finish_scores(s, e, w, k0, lane);
}

// The same for a head wider than kChunk: the products summed over the head
// in slices of kChunk columns, each slice of K staged, converted and
// multiplied in turn (q's slice from device memory into fragments each
// time). With vg set, V's columns [0, vwidth) of vg go to the block's bf16
// V tile along with the first slice. Every warp of the block calls it, as
// it holds the block's barriers; only a busy warp multiplies.
__device__ __forceinline__ void wide_tile_scores(float (&s)[kKeyTiles][4], float (&e)[kKeyTiles][4],
                                                 const Tiles<kChunk>& t, float* qs,
                                                 const float* qg, const float* kg,
                                                 const float* vg, int vwidth, const WarpRows& w,
                                                 bool busy, int k0, int Lq, int D, bool vec,
                                                 int lane) {
  zero_scores(s, e);
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int width = min(kChunk, D - c0);
    const bool with_v = vg != nullptr && c0 == 0;
    __syncthreads();  // every warp is done with the block's bf16 tiles
    stage_tile<kChunk>(t.stage_k, kg + c0, k0, w.Lk, D, width, vec);
    if (with_v) stage_tile<kChunk>(t.stage_v, vg, k0, w.Lk, D, vwidth, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the staged tiles have landed
    convert_tile<kChunk>(t.stage_k, t.ks);
    if (with_v) convert_tile<kChunk>(t.stage_v, t.vs);
    __syncthreads();  // the bf16 tiles are whole
    if (busy) {
      uint32_t qa[kChunk / 16][4];
      load_q<kChunk>(qa, qs, qg + c0, w.row0, Lq, D, width, lane);
      tile_products<kChunk>(s, e, qa, t.ks, lane);
    }
  }
  if (busy) finish_scores(s, e, w, k0, lane);
}

// mx = each row's max over the tile as the plain version has it, where the
// tile can raise the row's running max (the plain version's so far, −inf at
// the start); elsewhere the tensor cores' max, which stays below it. The
// true max lies within 2·etop (the row's largest bound) of the tensor
// cores' max, so the scores at least that high are summed again in column
// order, each lane looping only over its own. tile_p may test them once more
// against a rounding midpoint, which costs a second sum at worst. resum(b)
// is the column-order score of the thread's score number b.
template <class Resum>
__device__ __forceinline__ void settle_max(float (&s)[kKeyTiles][4], const float (&e)[kKeyTiles][4],
                                           float (&mx)[2], const float (&running)[2],
                                           const WarpRows& w, Resum&& resum) {
  float top[2] = {-INFINITY, -INFINITY}, etop[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      top[i >> 1] = fmaxf(top[i >> 1], s[nt][i]);
      etop[i >> 1] = fmaxf(etop[i >> 1], e[nt][i]);
    }
  float cut[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    top[h] = quad_max(top[h]);
    etop[h] = 2.0f * w.tol * quad_max(etop[h]);
    // below the running max: no score of the row is summed again
    cut[h] = top[h] + etop[h] < running[h] ? INFINITY : top[h] - etop[h];
  }
  if (__all_sync(kFull, cut[0] == INFINITY && cut[1] == INFINITY)) {
    mx[0] = top[0];
    mx[1] = top[1];
    return;
  }
  uint32_t need = 0;  // bit nt·4 + i
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s[nt][i] != -INFINITY && s[nt][i] >= cut[i >> 1]) need |= 1u << (nt * 4 + i);
  // the true max is among the candidates, so their column-order scores give it
  float best[2] = {-INFINITY, -INFINITY};
  while (need) {
    const int b = __ffs(static_cast<int>(need)) - 1;
    need &= need - 1;
    const float exact = resum(b);
    put(s, b, exact);
    best[(b >> 1) & 1] = fmaxf(best[(b >> 1) & 1], exact);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(best[h]);
    mx[h] = cut[h] == INFINITY ? top[h] : m;
  }
}

// Whether bf16(p) could round the other way for a p off by up to `ulps` f32
// ulps: the low 16 bits of p's f32 pattern against the midpoint 0x8000.
// (bits | 2²³'s exponent) is the float 2²³ + low16, exactly.
__device__ __forceinline__ bool near_bf16_midpoint(float p, float ulps) {
  const float low = __uint_as_float((__float_as_uint(p) & 0xffffu) | 0x4b000000u);
  return fabsf(low - (8388608.0f + 32768.0f)) <= ulps;
}

// p = exp(s − base) in place (0 where s is −inf, whose bound tile_scores
// made −inf, so that the midpoint test sees NaN), and the f32 row sums of the
// unrounded p added to sum; base[0] is row g's, base[1] row g + 8's, as the
// plain version has them. A p that lies within its bound of a bf16 rounding
// midpoint is taken from its score summed again in column order. The bound,
// relative to p, is e, the subtraction's rounding and expf's own (2 ulps
// each way); an f32 ulp of p is at least 2⁻²⁴ of p. resum as in settle_max.
template <class Resum>
__device__ __forceinline__ void tile_p(float (&s)[kKeyTiles][4], const float (&e)[kKeyTiles][4],
                                       const float (&base)[2], float (&sum)[2], const WarpRows& w,
                                       Resum&& resum) {
  const float tol24 = w.tol * 16777216.0f;  // the bound in f32 ulps of p per unit of e
  uint32_t part[4] = {0, 0, 0, 0};  // bit nt·4 + i, in four words for independent chains
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __fsub_rn(s[nt][i], base[i >> 1]);  // −inf where masked: p = 0
      const float p = expf(x);
      if (near_bf16_midpoint(p, fmaf(e[nt][i], tol24, fmaf(fabsf(x), 2.0f, 18.0f))))
        part[i] |= 1u << (nt * 4 + i);
      s[nt][i] = p;
    }
  uint32_t need = (part[0] | part[1]) | (part[2] | part[3]);
  while (need) {
    const int b = __ffs(static_cast<int>(need)) - 1;
    need &= need - 1;
    put(s, b, expf(__fsub_rn(resum(b), base[(b >> 1) & 1])));
  }
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i >> 1] += s[nt][i];
}

// o += bf16(p) · V for the 64 keys of the tile. The p accumulator layout
// is the A fragment layout, so p is rounded to bf16 and packed in
// registers; ldmatrix.trans of V's rows gives the B fragment: matrix m of
// an x4 load is keys (m % 2)·8.. at columns (m / 2)·8.., so one load feeds
// two 8-column n-tiles of one 16-key chunk.
template <int DP>
__device__ __forceinline__ void pv_tile(float (&acc)[DP / 8][4], const float (&p)[kKeyTiles][4],
                                        const __nv_bfloat16* vs, int lane) {
  const int m = lane >> 3, r = lane & 7;
  const __nv_bfloat16* base = vs + ((m & 1) * 8 + r) * Tiles<DP>::kLd + (m >> 1) * 8;
#pragma unroll
  for (int kc = 0; kc < kKeyChunks; ++kc) {
    const uint32_t a[4] = {pack_bf16x2(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16x2(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + kc * 16 * Tiles<DP>::kLd + dp * 16);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// o[row, col] = acc / denom for the warp's rows from row0 that are below Lq
// and the columns below width (row stride ld); denom[0] is row g's,
// denom[1] row g + 8's.
template <int DP>
__device__ __forceinline__ void store_rows(float* og, const float (&acc)[DP / 8][4],
                                           const float (&denom)[2], int row0, int Lq, int ld,
                                           int width, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i >> 1) * 8;
      const int col = nt * 8 + 2 * t + (i & 1);
      if (row < Lq && col < width) og[(size_t)row * ld + col] = acc[nt][i] / denom[i >> 1];
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// q, o [bh, Lq, D] and k, v [bh, Lk, D], all f32, contiguous, on the
// current device
struct AttentionArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long bh;
  int Lq, Lk, D, causal;
  cudaStream_t stream;

  // whole float4 copies of K and V rows
  bool vec() const {
    return D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(v) % 16 == 0;
  }
  // the score scale in f32, as torch rounds the Python float 1/√D
  float scale() const { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))); }
  // output slices of kChunk columns (one for a narrow head)
  int chunks() const { return D <= kChunk ? 1 : (D + kChunk - 1) / kChunk; }
  // one unit of work per (query tile, batch·head, output slice)
  long long tiles() const { return ((Lq - 1) / kBlockQ + 1) * bh * chunks(); }
  // the grid: one block per unit, or fewer blocks looping over the units
  // when there are more than a grid holds
  unsigned grid() const { return static_cast<unsigned>(std::min(tiles(), 0x7fffffffLL)); }
};

// Unit blk of the grid loop: its batch·head, first query row and output
// slice. The slice varies fastest, then the batch·head, and the query
// tiles run from the last (the longest under the causal mask) to the first.
struct Unit {
  size_t bh;
  int row0;
  int chunk;
};

__device__ __forceinline__ Unit unit_of(long long blk, long long n_bh, int Lq, int chunks) {
  const int nq = (Lq - 1) / kBlockQ + 1;
  const long long rest = blk / chunks;
  return {static_cast<size_t>(rest % n_bh), (nq - 1 - static_cast<int>(rest / n_bh)) * kBlockQ,
          static_cast<int>(blk % chunks)};
}

// Checks the arguments and calls narrow(std::integral_constant<int, DC>)
// with DC = ceil(D / 32) for a head of at most kChunk columns (padded to
// DP = 32·DC), else wide(). Returns a cudaError_t (0 = launched, or nothing
// to do).
template <class Narrow, class Wide>
int attention_entry(const AttentionArgs& a, Narrow&& narrow, Wide&& wide) {
  if (a.bh < 0 || a.Lq < 0 || a.Lk < 1 || a.D < 1) return cudaErrorInvalidValue;
  if (a.bh == 0 || a.Lq == 0) return cudaSuccess;
  switch ((a.D + kWarp - 1) / kWarp) {
    case 1: return narrow(std::integral_constant<int, 1>{});
    case 2: return narrow(std::integral_constant<int, 2>{});
    case 3: return narrow(std::integral_constant<int, 3>{});
    case 4: return narrow(std::integral_constant<int, 4>{});
    default: return wide();
  }
}

}  // namespace
