// Batched Jacobi-preconditioned CG for n independent f-by-f SPD systems.
//
// Replaces the TPU kernel `batched_spd_solve_fused` in
// predictionio_tpu/ops/spd_solve.py (pallas body `_kernel` -> `_cg_body`).
// It computes what `_cg_body` computes: dinv = 1/diag(A), x0 = b*dinv,
// then exactly `iters` (= f+4) CG steps with the same update order and
// the same 1e-30 clamps on both denominators.
//
// Design: one warp owns one system; a block holds `wpb` warps. The warp
// copies its A into shared memory once with coalesced loads (row stride
// `ld` = f rounded up to an odd number, so lanes reading down a column of
// rows hit distinct banks) and keeps x, r, z and its rows of p in
// registers; lane l owns rows l, l+32, l+64, l+96. The matvec Ap runs with
// lanes over rows against a shared copy of p, and every dot product is a
// __shfl_xor_sync butterfly. The ragged edge is masked by index: a warp
// whose system index is >= n returns at once, so no identity padding is
// needed. Ranks 1..128 (up to four rows per lane).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): the function must read A and b and write x once,
// n*(f*f + 2f)*4 bytes, and does about (f+5)*2*f*f*n f32 operations plus
// the vector updates. At n = 138,001 and f = 32 that is 0.60 GB -> 0.18 ms
// against 12.2 GFLOP -> 0.18 ms: the two bounds meet. This version is
// limited by shared-memory reads instead (each CG step re-reads A from
// shared memory, about f*f*4 bytes per system per step, one dependent FMA
// chain of length f per row), so it sits several times above the bound.
// Making it fast (wgmma on batches of systems, TMA loads, more systems in
// flight per SM, split accumulators) is later work.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRank = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// R = rows per lane = ceil(f / 32)
template <int R>
__global__ void spd_cg_kernel(const float* __restrict__ A,
                              const float* __restrict__ b,
                              float* __restrict__ x_out, long long n, int f,
                              int ld, int iters, int wpb) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long sys = (long long)blockIdx.x * wpb + warp;
  if (sys >= n) return;  // warp-uniform: masks the ragged edge

  // per-warp shared region: A [f, ld] then p [f]
  float* As = smem + (size_t)warp * ((size_t)f * ld + f);
  float* ps = As + (size_t)f * ld;

  const size_t ff = (size_t)f * f;
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
    if (i < f) ps[i] = xr[t];  // the matvec reads its operand from ps
  }
  __syncwarp();

  // r = b - A x0; z = r * dinv; p = z; rz = <r, z>
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
  float rz = warp_sum(part);
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
    const float pap = warp_sum(part);
    const float alpha = rz / fmaxf(pap, 1e-30f);
    part = 0.0f;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      xr[t] = xr[t] + alpha * pr[t];
      rr[t] = rr[t] - alpha * ap[t];
      zr[t] = rr[t] * dinv[t];
      part += rr[t] * zr[t];
    }
    const float rz2 = warp_sum(part);
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

template <int R>
cudaError_t launch(const float* A, const float* b, float* x, long long n,
                   int f, int iters, cudaStream_t stream) {
  const int ld = (f % 2 == 0) ? f + 1 : f;
  const size_t per_warp = ((size_t)f * ld + f) * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int wpb = 4;
  while (wpb > 1 && per_warp * wpb > (size_t)max_optin) wpb /= 2;
  const size_t smem = per_warp * wpb;
  if (smem > (size_t)max_optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(spd_cg_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;  // grid.x limit
  spd_cg_kernel<R><<<(unsigned)blocks, wpb * kWarp, smem, stream>>>(
      A, b, x, n, f, ld, iters, wpb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pio_spd_cg_max_rank() { return kMaxRank; }

// Solve A[s] x[s] = b[s] for s < n; A [n, f, f], b and x [n, f], all f32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
int pio_spd_cg_solve(const float* A, const float* b, float* x, long long n,
                     int f, int iters, void* stream) {
  if (n < 0 || f < 1 || f > kMaxRank || iters < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((f + kWarp - 1) / kWarp) {
    case 1: return launch<1>(A, b, x, n, f, iters, s);
    case 2: return launch<2>(A, b, x, n, f, iters, s);
    case 3: return launch<3>(A, b, x, n, f, iters, s);
    default: return launch<4>(A, b, x, n, f, iters, s);
  }
}

const char* pio_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
