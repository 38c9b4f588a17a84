// Kernel B1: batched Jacobi-preconditioned CG for n independent f-by-f SPD
// systems, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `batched_spd_solve_fused` in
// predictionio_tpu/ops/spd_solve.py:76 (pallas body `_kernel` -> `_cg_body`).
// It computes what `_cg_body` computes: dinv = 1/diag(A), x0 = b*dinv,
// then exactly `iters` (= f+4) CG steps with the same update order and
// the same 1e-30 clamps on both denominators. Only the order of f32 sums
// differs.
//
// What bounds it. The function must read A and b and write x once,
// n*(f*f + 2f)*4 bytes, and does about (f+5)*2*f*f*n f32 operations plus
// the vector updates. At n = 138,001 and f = 32 on an H100 SXM (3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores) that is 0.60 GB -> 0.18 ms
// against 12.2 GFLOP -> 0.18 ms: bytes and operations meet. Each system's
// CG is a chain of matrix-vector products with one right-hand side, so
// nothing of A is reused the way an MMA tile would reuse it, and TF32 would
// break the f32 contract: the tensor cores do not help here.
//
// What bound the first version: one warp per system with A in shared
// memory, re-read at every step. Each FMA of the matvec came with two
// scalar shared loads (a row element and a p element), about 75 shared and
// shuffle instructions per step and system. It ran at 1.61 ms, about 11 %
// of the bound, limited by shared-memory load issue.
//
// This design (ranks 1..64):
//   - A is read from device memory once, by cp.async into a per-warp
//     staging tile (rows at an odd number of 16-byte chunks, so a
//     quarter-warp reading one chunk of 8 rows hits 8 bank groups), and
//     from there into registers. A group of G lanes owns a system; lane l
//     of the group holds rows l, l + G, ... (at f = 32 and G = 8, four
//     rows and 128 registers of A per lane).
//   - Warps are persistent: a warp loops over tiles of 32/G systems. It
//     issues the next tile's copy as soon as the current tile is in
//     registers, so loads overlap the current tile's CG steps.
//   - Each step's matvec reads p from a small per-group shared buffer as
//     16-byte loads that every lane of the group shares (a broadcast), and
//     reads nothing of A. p is written back once per step (two buffers in
//     turn, one __syncwarp). The two dot products per step take log2(G)
//     shuffle levels, and a warp runs 32/G systems' dots and divisions at
//     once.
//   - Each row sums in two to four partial sums (at least four
//     independent FMA chains per lane).
//   - f = 10 (the template default) and f = 32 (the ALS main paths) are
//     compiled for their exact width. Other ranks run on widths 8, 16, 32
//     and 64, with rows and columns past f zero-filled in the copy and
//     masked by index.
//   - G = 8 up to f = 32. In the SASS one step is then 224 instructions
//     for 4 systems, of which 8 LDS.128, 4 STS and 6 SHFL: 4.5 shared and
//     shuffle instructions per system against about 75 in the first
//     version. At G = 16 a step is 151 instructions for 2 systems, at
//     G = 32 114 for one; both ran slower at f = 32 and f = 10.
// Ranks 65..128 keep A in shared memory as the first version did: one
// warp's registers cannot hold 65 to 128 rows of up to 128 floats.
// Past rank 128 a whole block of kBlockThreads solves one system (blocks
// loop over systems), with A in dynamic shared memory while it fits beside
// the vectors (f <= 238 on an H100's 227 KB), else re-read from device
// memory (mostly L2) at every step. The simplest layout that is right: each
// warp takes rows w, w + 8, ... of the matvec with its lanes along the row
// (coalesced reads, and no bank conflicts at any f), summed by shuffles; the
// vectors live in shared memory, element i owned by thread i % 256; the two
// dots per step are block sums in a fixed order. Speed is later work.
// Past f = 11,619 the five vectors of one system outgrow a block's shared
// memory (A of one such system is 540 MB, so such calls solve a few
// systems at most). Then the whole grid solves each system in turn, one
// launch per phase of a CG step (matvec, x and r update, p update), with
// the vectors in a device scratch buffer the caller allocates and x
// written in place in the output. Per-block partial sums of the two dots
// go to the scratch too, and every block adds them up in one fixed order.
//
// Measured on an H100 SXM (80GB HBM3) at 700 W: 0.58 ms at n = 138,001,
// f = 32 (2.8x the first version), about 32 % of the bound. A solve with 0
// CG steps takes 0.22 ms, which is the loads at about 2.8 TB/s, and the
// full solve hides them under its steps. Each of the 36 steps costs about
// 0.015 ms, at about 0.5 issued instructions per cycle per scheduler.
// 8 warps per SM (this kernel) reach that rate and 12 run no faster; 4
// run 1.5x slower. A doubled matvec costs 42 % more and an approximate
// division saves 12 %. About half of the matvec's FFMAs read the A element
// and the accumulator from registers of one parity, which fits a
// register-bank limit (PERF.md).
//
// ptxas (sm_90a, -O3; chip_smoke.py prints it): registers<32, 8> 184
// registers, <10, 8> 112, <16, 8> 80 with 8 bytes spilled, <8, 8> 63,
// <64, 32> 196; shared<3> 56, shared<4> 64; no other spills.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing, makes no device query after the first launch of an
// instantiation on a device, and can be captured into a CUDA graph.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "cuda_common.cuh"

namespace {

constexpr int kMaxRegisterRank = 64;  // ranks whose A a warp holds in registers
constexpr int kMaxWarpRank = 128;     // ranks one warp solves (A in shared memory)
constexpr int kWarpsPerBlock = 2;
constexpr int kThreads = kWarpsPerBlock * kWarp;
constexpr int kMaxDevices = 64;
// past kMaxWarpRank: one block per system
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / kWarp;
constexpr size_t kSmemOptin = 232448;  // a block's dynamic shared memory on sm_90

// Shared memory of the block kernel at rank f: A (when held there), the
// five vectors x, r, p, Ap and 1/diag(A), and two rows of warp partial sums.
size_t block_smem(int f, bool shared_a) {
  return ((shared_a ? (size_t)f * f : 0) + 5 * (size_t)f + 2 * kBlockWarps) * sizeof(float);
}

// Floats of the grid plan's scratch at rank f over a grid of `blocks`:
// r, p, Ap and 1/diag(A), the blocks' partial sums of <p, Ap>, and two
// rows (steps in turn) of their partial sums of <r, z>.
size_t grid_scratch_floats(int f, long long blocks) {
  return 4 * (size_t)f + 3 * (size_t)blocks;
}

// The register kernel's layout for width F and G lanes per system.
template <int F, int G>
struct Layout {
  static constexpr int kRows = (F + G - 1) / G;  // rows per lane
  static constexpr int kSys = kWarp / G;         // systems per warp
  static constexpr int kFP = (F + 3) / 4 * 4;    // row width in whole 16-byte chunks
  // staging row stride: an odd number of 16-byte chunks
  static constexpr int kLd = (kFP / 4) % 2 ? kFP : kFP + 4;
  static constexpr int kStage = kSys * F * kLd;  // A of the warp's systems
  static constexpr int kB = kSys * kFP;          // b of the warp's systems
  // per group: p twice (two buffers in turn), groups 8 banks apart
  static constexpr int kPStride = (2 * kFP + 23) / 32 * 32 + 8;
  static constexpr int kWarpFloats = kStage + kB + kSys * kPStride;
  static constexpr size_t kSmem = (size_t)kWarpsPerBlock * kWarpFloats * sizeof(float);
  // partial sums per row: at least four independent FMA chains per lane
  static constexpr int kSplit = kRows >= 4 ? 1 : 4 / kRows;
};

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Starts copying the A and b of systems [sys0, sys0 + kSys) into a warp's
// staging tile: row i of system s at (s*F + i)*kLd, b of s at
// kStage + s*kFP. Rows and columns past f and systems past n are
// zero-filled. vec: f == F, F % 4 == 0 and A is 16-byte aligned, so whole
// rows go in 16-byte copies.
template <int F, int G>
__device__ __forceinline__ void stage_tile(float* st, const float* A, const float* b,
                                           long long sys0, long long n, int f, bool vec,
                                           int lane) {
  using L = Layout<F, G>;
  if (vec) {
    constexpr int kChunks = F / 4;
    for (int c = lane; c < L::kSys * F * kChunks; c += kWarp) {
      const int s = c / (F * kChunks), i = c / kChunks % F, k = c % kChunks;
      const bool ok = sys0 + s < n;
      const float* src = A + ((sys0 + s) * F + i) * F + 4 * k;
      cp_async16(st + (s * F + i) * L::kLd + 4 * k, ok ? src : A, ok);
    }
  } else {
    for (int e = lane; e < L::kSys * F * L::kFP; e += kWarp) {
      const int s = e / (F * L::kFP), i = e / L::kFP % F, j = e % L::kFP;
      const bool ok = sys0 + s < n && i < f && j < f;
      const float* src = A + ((sys0 + s) * f + i) * f + j;
      cp_async4(st + (s * F + i) * L::kLd + j, ok ? src : A, ok);
    }
  }
  for (int e = lane; e < L::kB; e += kWarp) {
    const int s = e / L::kFP, j = e % L::kFP;
    const bool ok = sys0 + s < n && j < f;
    cp_async4(st + L::kStage + e, ok ? b + (sys0 + s) * f + j : b, ok);
  }
  cp_async_commit();
}

// out[t] = row (l + t*G) of A times p, for the rows a lane holds.
template <int F, int G>
__device__ __forceinline__ void matvec(float (&out)[Layout<F, G>::kRows],
                                       const float (&a)[Layout<F, G>::kRows][Layout<F, G>::kFP],
                                       const float* p) {
  using L = Layout<F, G>;
  constexpr int R = L::kRows, S = L::kSplit;
  float acc[R][S];
#pragma unroll
  for (int t = 0; t < R; ++t)
#pragma unroll
    for (int q = 0; q < S; ++q) acc[t][q] = 0.0f;
#pragma unroll
  for (int k = 0; k < L::kFP / 4; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * k);
    const float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int t = 0; t < R; ++t)
        acc[t][(4 * k + c) % S] = fmaf(a[t][4 * k + c], pv[c], acc[t][(4 * k + c) % S]);
  }
#pragma unroll
  for (int t = 0; t < R; ++t) {
#pragma unroll
    for (int w = 1; w < S; w *= 2)
#pragma unroll
      for (int q = 0; q + w < S; q += 2 * w) acc[t][q] += acc[t][q + w];
    out[t] = acc[t][0];
  }
}

// Ranks 1..64: a group of G lanes per system, A in registers, persistent
// warps over tiles of kSys systems (kExact: f == F).
template <int F, int G, bool kExact>
__global__ void __launch_bounds__(kThreads)
    spd_cg_registers(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x_out, long long n, int f_arg, int iters, bool vec) {
  using L = Layout<F, G>;
  constexpr int R = L::kRows, FP = L::kFP;
  extern __shared__ __align__(16) float smem[];
  const int f = kExact ? F : f_arg;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int grp = lane / G, gl = lane % G;
  float* st = smem + warp * L::kWarpFloats;
  float* pbuf = st + L::kStage + L::kB + grp * L::kPStride;
  for (int j = gl; j < 2 * FP; j += G) pbuf[j] = 0.0f;  // columns [F, FP) stay 0

  const long long tiles = (n + L::kSys - 1) / L::kSys;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  long long tile = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= tiles) return;  // warp-uniform
  stage_tile<F, G>(st, A, b, tile * L::kSys, n, f, vec, lane);

  for (; tile < tiles; tile += stride) {
    const long long sys = tile * L::kSys + grp;
    const bool live = sys < n;
    cp_async_wait_all();
    __syncwarp();

    // A, b and 1/diag(A) of this lane's rows, from the staging tile
    const float* As = st + grp * F * L::kLd;
    float a[R][FP], br[R], dinv[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = gl + t * G;
      const bool row = F % G == 0 || i < F;
#pragma unroll
      for (int k = 0; k < FP / 4; ++k) {
        const float4 v = row ? *reinterpret_cast<const float4*>(As + i * L::kLd + 4 * k)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        a[t][4 * k] = v.x;
        a[t][4 * k + 1] = v.y;
        a[t][4 * k + 2] = v.z;
        a[t][4 * k + 3] = v.w;
      }
      const bool ok = live && i < f;
      br[t] = ok ? st[L::kStage + grp * FP + i] : 0.0f;
      dinv[t] = ok ? 1.0f / As[i * L::kLd + i] : 0.0f;
    }
    __syncwarp();  // every lane has read the staging tile
    if (tile + stride < tiles) stage_tile<F, G>(st, A, b, (tile + stride) * L::kSys, n, f, vec, lane);

    // x0 = b*dinv; r = b - A x0; z = r*dinv; p = z; rz = <r, z>
    float x[R], r[R], p[R], ap[R];
    float* cur = pbuf;
    float* nxt = pbuf + FP;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      x[t] = br[t] * dinv[t];
      if (F % G == 0 || gl + t * G < F) cur[gl + t * G] = x[t];
    }
    __syncwarp();
    matvec<F, G>(ap, a, cur);
    float part = 0.0f;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      r[t] = br[t] - ap[t];
      const float z = r[t] * dinv[t];
      p[t] = z;
      part += r[t] * z;
      if (F % G == 0 || gl + t * G < F) nxt[gl + t * G] = p[t];
    }
    float rz = group_sum<G>(part);
    __syncwarp();

    for (int it = 0; it < iters; ++it) {
      {
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
      matvec<F, G>(ap, a, cur);
      part = 0.0f;
#pragma unroll
      for (int t = 0; t < R; ++t) part += p[t] * ap[t];
      const float alpha = rz / fmaxf(group_sum<G>(part), 1e-30f);
      float z[R];
      part = 0.0f;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        x[t] = x[t] + alpha * p[t];
        r[t] = r[t] - alpha * ap[t];
        z[t] = r[t] * dinv[t];
        part += r[t] * z[t];
      }
      const float rz2 = group_sum<G>(part);
      const float beta = rz2 / fmaxf(rz, 1e-30f);
      // nxt was last read in the previous step's matvec, which every lane
      // finished before that step's __syncwarp
#pragma unroll
      for (int t = 0; t < R; ++t) {
        p[t] = z[t] + beta * p[t];
        if (F % G == 0 || gl + t * G < F) nxt[gl + t * G] = p[t];
      }
      __syncwarp();
      rz = rz2;
    }

    if (live) {
      float* xg = x_out + sys * f;
#pragma unroll
      for (int t = 0; t < R; ++t)
        if (gl + t * G < f) xg[gl + t * G] = x[t];
    }
  }
}

// Ranks 65..128 (R = ceil(f / 32) rows per lane): one warp per system, A in
// shared memory at an odd row stride, the matvec reading A and p from
// shared memory at every step; warps loop over systems.
template <int R>
__global__ void __launch_bounds__(kThreads)
    spd_cg_shared(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x_out, long long n, int f, int iters) {
  extern __shared__ __align__(16) float smem[];
  const int ld = f % 2 ? f : f + 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* As = smem + (size_t)warp * ((size_t)f * ld + f);
  float* ps = As + (size_t)f * ld;
  const size_t ff = (size_t)f * f;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;

  for (long long sys = (long long)blockIdx.x * kWarpsPerBlock + warp; sys < n; sys += stride) {
    __syncwarp();  // the previous system's reads of As and ps are done
    const float* Ag = A + (size_t)sys * ff;
    for (int idx = lane; idx < (int)ff; idx += kWarp) {
      const int row = idx / f;
      As[row * ld + (idx - row * f)] = Ag[idx];
    }
    const float* bg = b + (size_t)sys * f;
    float xr[R], rr[R], zr[R], pr[R], dinv[R], br[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + t * kWarp;
      br[t] = i < f ? bg[i] : 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + t * kWarp;
      dinv[t] = i < f ? 1.0f / As[i * ld + i] : 0.0f;
      xr[t] = br[t] * dinv[t];
      if (i < f) ps[i] = xr[t];
    }
    __syncwarp();

    float part = 0.0f;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + t * kWarp;
      float ax = 0.0f;
      if (i < f) {
        const float* row = As + i * ld;
        for (int j = 0; j < f; ++j) ax += row[j] * ps[j];
      }
      rr[t] = br[t] - ax;
      zr[t] = rr[t] * dinv[t];
      pr[t] = zr[t];
      part += rr[t] * zr[t];
    }
    float rz = group_sum<kWarp>(part);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + t * kWarp;
      if (i < f) ps[i] = pr[t];
    }
    __syncwarp();

    for (int it = 0; it < iters; ++it) {
      float ap[R];
      part = 0.0f;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        float acc = 0.0f;
        if (i < f) {
          const float* row = As + i * ld;
          for (int j = 0; j < f; ++j) acc += row[j] * ps[j];
        }
        ap[t] = acc;
        part += pr[t] * acc;
      }
      const float alpha = rz / fmaxf(group_sum<kWarp>(part), 1e-30f);
      part = 0.0f;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        xr[t] = xr[t] + alpha * pr[t];
        rr[t] = rr[t] - alpha * ap[t];
        zr[t] = rr[t] * dinv[t];
        part += rr[t] * zr[t];
      }
      const float rz2 = group_sum<kWarp>(part);
      const float beta = rz2 / fmaxf(rz, 1e-30f);
      __syncwarp();  // every lane has finished reading ps for this step
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int i = lane + t * kWarp;
        pr[t] = zr[t] + beta * pr[t];
        if (i < f) ps[i] = pr[t];
      }
      __syncwarp();
      rz = rz2;
    }

    float* xg = x_out + (size_t)sys * f;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + t * kWarp;
      if (i < f) xg[i] = xr[t];
    }
  }
}


// The sum of v over the block's threads, in the same order in every thread;
// red holds kBlockWarps floats and must not be read again before the next
// barrier of the caller (two sums in turn use two red rows).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = group_sum<kWarp>(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) s += red[w];
  return s;
}

// aps[i] = row i of A times ps, rows spread over the block's warps.
template <bool kSharedA>
__device__ __forceinline__ void block_matvec(float* aps, const float* Am, const float* ps, int f) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int i = warp; i < f; i += kBlockWarps) {
    const float* row = Am + (size_t)i * f;
    float acc = 0.0f;
    for (int j = lane; j < f; j += kWarp) acc = fmaf(kSharedA ? row[j] : __ldg(row + j), ps[j], acc);
    acc = group_sum<kWarp>(acc);
    if (lane == 0) aps[i] = acc;
  }
}

// Ranks past 128: one block per system, blocks loop over systems; A in
// shared memory (kSharedA) or read from device memory at every step.
template <bool kSharedA>
__global__ void __launch_bounds__(kBlockThreads)
    spd_cg_block(const float* __restrict__ A, const float* __restrict__ b,
                 float* __restrict__ x_out, long long n, int f, int iters) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* xs = smem + (kSharedA ? (size_t)f * f : 0);
  float* rs = xs + f;
  float* ps = rs + f;
  float* aps = ps + f;
  float* dinv = aps + f;
  float* red0 = dinv + f;
  float* red1 = red0 + kBlockWarps;
  const int tid = threadIdx.x;
  const size_t ff = (size_t)f * f;

  for (long long sys = blockIdx.x; sys < n; sys += gridDim.x) {
    const float* Ag = A + (size_t)sys * ff;
    const float* bg = b + (size_t)sys * f;
    const float* Am = kSharedA ? As : Ag;
    __syncthreads();  // the previous system's reads of shared memory are done
    if (kSharedA)
      for (size_t idx = tid; idx < ff; idx += kBlockThreads) As[idx] = Ag[idx];
    __syncthreads();
    // x0 = b*dinv; r = b - A x0; z = r*dinv; p = z; rz = <r, z>
    for (int i = tid; i < f; i += kBlockThreads) {
      const float d = 1.0f / Am[(size_t)i * f + i];
      dinv[i] = d;
      xs[i] = __ldg(bg + i) * d;
      ps[i] = xs[i];
    }
    __syncthreads();
    block_matvec<kSharedA>(aps, Am, ps, f);
    __syncthreads();
    float part = 0.0f;
    for (int i = tid; i < f; i += kBlockThreads) {
      const float r = __ldg(bg + i) - aps[i];
      const float z = r * dinv[i];
      rs[i] = r;
      ps[i] = z;
      part += r * z;
    }
    float rz = block_sum(part, red1);  // its barrier also publishes p

    for (int it = 0; it < iters; ++it) {
      block_matvec<kSharedA>(aps, Am, ps, f);
      __syncthreads();
      part = 0.0f;
      for (int i = tid; i < f; i += kBlockThreads) part += ps[i] * aps[i];
      const float alpha = rz / fmaxf(block_sum(part, red0), 1e-30f);
      part = 0.0f;
      for (int i = tid; i < f; i += kBlockThreads) {
        xs[i] = xs[i] + alpha * ps[i];
        const float r = rs[i] - alpha * aps[i];
        rs[i] = r;
        part += r * (r * dinv[i]);
      }
      const float rz2 = block_sum(part, red1);
      const float beta = rz2 / fmaxf(rz, 1e-30f);
      for (int i = tid; i < f; i += kBlockThreads) ps[i] = rs[i] * dinv[i] + beta * ps[i];
      __syncthreads();  // p is whole before the next matvec
      rz = rz2;
    }

    float* xg = x_out + (size_t)sys * f;
    for (int i = tid; i < f; i += kBlockThreads) xg[i] = xs[i];
  }
}

// The grid plan (past f = 11,619): every block of the grid works on one
// system at a time. Vectors in device memory: row i of the matvec goes to
// warp i mod (warps of the grid); element i of the vector updates to
// thread i mod (threads of the grid).
struct GridVectors {
  float* x;     // the system's row of the output
  float* r;
  float* p;
  float* ap;
  float* dinv;
  float* pap;   // [blocks] partial sums of <p, Ap>
  float* rz;    // [2][blocks] partial sums of <r, z>, steps in turn
};

__device__ __forceinline__ GridVectors grid_vectors(float* scratch, float* x, int f) {
  const size_t fs = (size_t)f;
  return GridVectors{x, scratch, scratch + fs, scratch + 2 * fs, scratch + 3 * fs,
                     scratch + 4 * fs, scratch + 4 * fs + gridDim.x};
}

// The sum of a row of the blocks' partials, the same in every block.
__device__ __forceinline__ float grid_sum(const float* part, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kBlockThreads) s += part[i];
  return block_sum(s, red);
}

// x0 = b*dinv, and p = x0 for the first matvec.
__global__ void __launch_bounds__(kBlockThreads)
    spd_cg_grid_init(const float* __restrict__ A, const float* __restrict__ b, float* scratch,
                     float* x, int f) {
  const GridVectors v = grid_vectors(scratch, x, f);
  for (int i = blockIdx.x * kBlockThreads + threadIdx.x; i < f; i += gridDim.x * kBlockThreads) {
    const float d = 1.0f / A[(size_t)i * f + i];
    v.dinv[i] = d;
    v.x[i] = b[i] * d;
    v.p[i] = v.x[i];
  }
}

// Ap = A p, a warp per row with its lanes along the row (four partial sums
// per lane); with kDot each block also writes its partial sum of <p, Ap>.
template <bool kDot>
__global__ void __launch_bounds__(kBlockThreads)
    spd_cg_grid_matvec(const float* __restrict__ A, float* scratch, float* x, int f) {
  __shared__ float red[kBlockWarps];
  const GridVectors v = grid_vectors(scratch, x, f);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long warps = (long long)gridDim.x * kBlockWarps;
  float part = 0.0f;
  for (long long i = (long long)blockIdx.x * kBlockWarps + warp; i < f; i += warps) {
    const float* row = A + (size_t)i * f;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int j = lane;
    for (; j + 3 * kWarp < f; j += 4 * kWarp) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(__ldg(row + j + u * kWarp), v.p[j + u * kWarp], acc[u]);
    }
    for (; j < f; j += kWarp) acc[0] = fmaf(__ldg(row + j), v.p[j], acc[0]);
    const float s = group_sum<kWarp>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (lane == 0) {
      v.ap[i] = s;
      part += v.p[i] * s;
    }
  }
  if (kDot) {
    part = block_sum(part, red);
    if (threadIdx.x == 0) v.pap[blockIdx.x] = part;
  }
}

// After the first matvec: r = b - A x0, z = r*dinv, p = z; partial sums of
// <r, z> into the row of step -1.
__global__ void __launch_bounds__(kBlockThreads)
    spd_cg_grid_residual(const float* __restrict__ b, float* scratch, float* x, int f) {
  __shared__ float red[kBlockWarps];
  const GridVectors v = grid_vectors(scratch, x, f);
  float part = 0.0f;
  for (int i = blockIdx.x * kBlockThreads + threadIdx.x; i < f; i += gridDim.x * kBlockThreads) {
    const float r = b[i] - v.ap[i];
    const float z = r * v.dinv[i];
    v.r[i] = r;
    v.p[i] = z;
    part += r * z;
  }
  part = block_sum(part, red);
  if (threadIdx.x == 0) v.rz[gridDim.x + blockIdx.x] = part;
}

// Step `it`: alpha = rz / max(<p, Ap>, 1e-30); x += alpha p; r -= alpha Ap;
// partial sums of the new <r, z> into row it % 2.
__global__ void __launch_bounds__(kBlockThreads)
    spd_cg_grid_update_xr(float* scratch, float* x, int f, int it) {
  __shared__ float red0[kBlockWarps], red1[kBlockWarps], red2[kBlockWarps];
  const GridVectors v = grid_vectors(scratch, x, f);
  const float rz = grid_sum(v.rz + (size_t)((it + 1) & 1) * gridDim.x, red0);
  const float alpha = rz / fmaxf(grid_sum(v.pap, red1), 1e-30f);
  float part = 0.0f;
  for (int i = blockIdx.x * kBlockThreads + threadIdx.x; i < f; i += gridDim.x * kBlockThreads) {
    v.x[i] = v.x[i] + alpha * v.p[i];
    const float r = v.r[i] - alpha * v.ap[i];
    v.r[i] = r;
    part += r * (r * v.dinv[i]);
  }
  part = block_sum(part, red2);
  if (threadIdx.x == 0) v.rz[(size_t)(it & 1) * gridDim.x + blockIdx.x] = part;
}

// Step `it`: beta = rz' / max(rz, 1e-30); p = r*dinv + beta p.
__global__ void __launch_bounds__(kBlockThreads)
    spd_cg_grid_update_p(float* scratch, float* x, int f, int it) {
  __shared__ float red0[kBlockWarps], red1[kBlockWarps];
  const GridVectors v = grid_vectors(scratch, x, f);
  const float rz2 = grid_sum(v.rz + (size_t)(it & 1) * gridDim.x, red0);
  const float rz = grid_sum(v.rz + (size_t)((it + 1) & 1) * gridDim.x, red1);
  const float beta = rz2 / fmaxf(rz, 1e-30f);
  for (int i = blockIdx.x * kBlockThreads + threadIdx.x; i < f; i += gridDim.x * kBlockThreads)
    v.p[i] = v.r[i] * v.dinv[i] + beta * v.p[i];
}

struct Args {
  const float* A;
  const float* b;
  float* x;
  long long n;
  int f;
  int iters;
  cudaStream_t stream;
  float* scratch;  // the grid plan's vectors (grid_scratch_floats), else unused
  size_t scratch_floats;
};

// What pio_spd_cg_plan reports; ops/spd_solve.py:launch_plan computes the
// same fields but the last two.
struct Report {
  // 0: A in registers, 1: A in a warp's shared memory, 2: one block per
  // system with A in shared memory, 3: the same with A in device memory,
  // 4: the whole grid per system, vectors in device memory
  int kind;
  int width;
  int exact;
  int group;  // threads per system
  int warps_per_block;
  int capacity;  // blocks the card keeps resident at once
  int blocks;    // the grid of this launch
};

// The grid of a launch: one warp per tile, capped at the blocks the whole
// card keeps resident (the warps then loop over tiles). The cap, and the
// kernel's shared-memory attributes, are set once per device and
// instantiation, so later launches, and launches captured into a CUDA
// graph, make no query.
template <class Kernel>
cudaError_t grid_for(Kernel* kernel, size_t max_smem, long long tiles,
                     std::atomic<int> (&cache)[kMaxDevices], Report& rep) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int cap = cache[dev].load(std::memory_order_relaxed);
  if (cap == 0) {
    if (max_smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)max_smem);
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, max_smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = per_sm * sms;
    cache[dev].store(cap, std::memory_order_relaxed);
  }
  const long long want = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rep.warps_per_block = kWarpsPerBlock;
  rep.capacity = cap;
  rep.blocks = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

// Launches (or, with plan_only, only plans) instantiation <F, G, kExact>.
template <int F, int G, bool kExact>
cudaError_t run_registers(const Args& a, Report& rep, bool plan_only) {
  using L = Layout<F, G>;
  static std::atomic<int> cache[kMaxDevices];
  rep.kind = 0;
  rep.width = F;
  rep.exact = kExact;
  rep.group = G;
  const cudaError_t err =
      grid_for(spd_cg_registers<F, G, kExact>, L::kSmem, (a.n + L::kSys - 1) / L::kSys, cache, rep);
  if (err != cudaSuccess || plan_only || rep.blocks == 0) return err;
  const bool vec = kExact && F % 4 == 0 && reinterpret_cast<uintptr_t>(a.A) % 16 == 0;
  spd_cg_registers<F, G, kExact><<<rep.blocks, kThreads, L::kSmem, a.stream>>>(
      a.A, a.b, a.x, a.n, a.f, a.iters, vec);
  return cudaGetLastError();
}

template <int R>
cudaError_t run_shared(const Args& a, Report& rep, bool plan_only) {
  constexpr int kMaxF = kWarp * R;
  constexpr size_t kMaxSmem = (size_t)kWarpsPerBlock * (kMaxF * (kMaxF + 1) + kMaxF) * sizeof(float);
  static std::atomic<int> cache[kMaxDevices];
  rep.kind = 1;
  rep.width = kMaxF;
  rep.exact = 0;
  rep.group = kWarp;
  const cudaError_t err = grid_for(spd_cg_shared<R>, kMaxSmem, a.n, cache, rep);
  if (err != cudaSuccess || plan_only || rep.blocks == 0) return err;
  const int ld = a.f % 2 ? a.f : a.f + 1;
  const size_t smem = (size_t)kWarpsPerBlock * ((size_t)a.f * ld + a.f) * sizeof(float);
  spd_cg_shared<R><<<rep.blocks, kThreads, smem, a.stream>>>(a.A, a.b, a.x, a.n, a.f, a.iters);
  return cudaGetLastError();
}

// One block per system, at most as many blocks as the card keeps resident
// (they then loop over systems). The residency depends on f through the
// shared memory, so the cache keeps the last shared-memory size with its
// cap: repeated launches at one rank, and launches captured into a CUDA
// graph after an eager one, make no query.
template <bool kSharedA>
cudaError_t run_block(const Args& a, Report& rep, bool plan_only) {
  static std::atomic<long long> cache[kMaxDevices];  // smem << 32 | cap
  rep.kind = kSharedA ? 2 : 3;
  rep.width = a.f;
  rep.exact = 1;
  rep.group = kBlockThreads;
  rep.warps_per_block = kBlockWarps;
  const size_t smem = block_smem(a.f, kSharedA);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long cached = cache[dev].load(std::memory_order_relaxed);
  if (cached == 0 || (unsigned long long)cached >> 32 != smem) {
    auto kernel = spd_cg_block<kSharedA>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemOptin);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached = (long long)(smem << 32) | (long long)(per_sm * sms);
    cache[dev].store(cached, std::memory_order_relaxed);
  }
  rep.capacity = (int)(cached & 0xffffffffLL);
  rep.blocks = (int)(a.n < rep.capacity ? a.n : rep.capacity);
  if (plan_only || rep.blocks == 0) return cudaSuccess;
  spd_cg_block<kSharedA><<<rep.blocks, kBlockThreads, smem, a.stream>>>(a.A, a.b, a.x, a.n, a.f,
                                                                        a.iters);
  return cudaGetLastError();
}

// The grid plan: a grid of as many blocks as the card keeps resident works
// on each system in turn, 3 launches per CG step and 3 to start. The
// caller's scratch holds the vectors (grid_scratch_floats(f, blocks)).
cudaError_t run_grid(const Args& a, Report& rep, bool plan_only) {
  static std::atomic<int> cache[kMaxDevices];
  rep.kind = 4;
  rep.width = a.f;
  rep.exact = 1;
  rep.group = kBlockThreads;
  rep.warps_per_block = kBlockWarps;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int cap = cache[dev].load(std::memory_order_relaxed);
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spd_cg_grid_matvec<true>,
                                                        kBlockThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cap = per_sm * sms;
    cache[dev].store(cap, std::memory_order_relaxed);
  }
  rep.capacity = cap;
  rep.blocks = a.n > 0 ? cap : 0;
  if (plan_only || rep.blocks == 0) return cudaSuccess;
  if (a.scratch == nullptr || a.scratch_floats < grid_scratch_floats(a.f, rep.blocks))
    return cudaErrorInvalidValue;
  const int g = rep.blocks;
  const size_t ff = (size_t)a.f * a.f;
  for (long long sys = 0; sys < a.n; ++sys) {
    const float* As = a.A + (size_t)sys * ff;
    const float* bs = a.b + (size_t)sys * a.f;
    float* xs = a.x + (size_t)sys * a.f;
    spd_cg_grid_init<<<g, kBlockThreads, 0, a.stream>>>(As, bs, a.scratch, xs, a.f);
    spd_cg_grid_matvec<false><<<g, kBlockThreads, 0, a.stream>>>(As, a.scratch, xs, a.f);
    spd_cg_grid_residual<<<g, kBlockThreads, 0, a.stream>>>(bs, a.scratch, xs, a.f);
    for (int it = 0; it < a.iters; ++it) {
      spd_cg_grid_matvec<true><<<g, kBlockThreads, 0, a.stream>>>(As, a.scratch, xs, a.f);
      spd_cg_grid_update_xr<<<g, kBlockThreads, 0, a.stream>>>(a.scratch, xs, a.f, it);
      spd_cg_grid_update_p<<<g, kBlockThreads, 0, a.stream>>>(a.scratch, xs, a.f, it);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The plan by rank; ops/spd_solve.py:launch_plan mirrors it.
cudaError_t run(const Args& a, Report& rep, bool plan_only) {
  const int f = a.f;
  if (f > kMaxWarpRank) {
    // past f = 11,619 the five CG vectors of one system outgrow a block's
    // shared memory (A of one such system is 540 MB): the whole grid
    if (block_smem(f, false) > kSmemOptin) return run_grid(a, rep, plan_only);
    return block_smem(f, true) <= kSmemOptin ? run_block<true>(a, rep, plan_only)
                                             : run_block<false>(a, rep, plan_only);
  }
  if (f > kMaxRegisterRank) {
    return f > 3 * kWarp ? run_shared<4>(a, rep, plan_only) : run_shared<3>(a, rep, plan_only);
  }
  if (f == 10) return run_registers<10, 8, true>(a, rep, plan_only);
  if (f == 32) return run_registers<32, 8, true>(a, rep, plan_only);
  if (f <= 8) return run_registers<8, 8, false>(a, rep, plan_only);
  if (f <= 16) return run_registers<16, 8, false>(a, rep, plan_only);
  if (f <= 32) return run_registers<32, 8, false>(a, rep, plan_only);
  return run_registers<64, 32, false>(a, rep, plan_only);
}

}  // namespace

extern "C" {

// Solve A[s] x[s] = b[s] for s < n; A [n, f, f], b and x [n, f], all f32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
// Ranks past 11,619 need the scratch entry below.
int pio_spd_cg_solve(const float* A, const float* b, float* x, long long n, int f, int iters,
                     void* stream) {
  if (n < 0 || f < 1 || iters < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Report rep{};
  return run(Args{A, b, x, n, f, iters, static_cast<cudaStream_t>(stream), nullptr, 0}, rep,
             false);
}

// The same with a device scratch buffer of `scratch_floats` floats for the
// grid plan's vectors: at least grid_scratch_floats(f, blocks) (4f + 3 per
// block) for the grid that pio_spd_cg_plan reports. Other plans ignore it.
int pio_spd_cg_solve_scratch(const float* A, const float* b, float* x, long long n, int f,
                             int iters, float* scratch, long long scratch_floats, void* stream) {
  if (n < 0 || f < 1 || iters < 0 || scratch_floats < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Report rep{};
  return run(Args{A, b, x, n, f, iters, static_cast<cudaStream_t>(stream), scratch,
                  (size_t)scratch_floats},
             rep, false);
}

// The launch plan for n systems of rank f on the current device, into
// out[7]: kind, width, exact, group, warps per block, capacity, blocks.
int pio_spd_cg_plan(long long n, int f, int* out) {
  if (n < 0 || f < 1) return cudaErrorInvalidValue;
  Report rep{};
  const cudaError_t err =
      run(Args{nullptr, nullptr, nullptr, n, f, f + 4, nullptr, nullptr, 0}, rep, true);
  const int fields[7] = {rep.kind,  rep.width,           rep.exact, rep.group,
                         rep.warps_per_block, rep.capacity, rep.blocks};
  for (int k = 0; k < 7; ++k) out[k] = fields[k];
  return err;
}

}  // extern "C"
