// Batched Gauss-Jordan solve of small SPD systems, X = A^-1 B, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of predictionio_tpu/ops/pallas_solve.py:
//   - _build_solver_aug       (one right-hand side; entry point gj_aug)
//   - _build_solver_aug_multi (M right-hand sides; entry point gj_aug_multi)
// Both are the same row elimination on the augmented block [A | B]; here
// they are one kernel with two entry points. The register and block
// kernels of gj_reg.cu, gj_cta.cu and gj_multi_reg.cu took every rank a
// route reaches over; ops/spd_solve.py leaves this kernel gj_aug above
// K = 256 and gj_aug_multi above K = 128 with M > 1, where no route goes.
//
// Arithmetic, kept from the reference: K steps, no pivoting (A is SPD).
// Step p reads the pivot d = W[p][p], guards |d| < 1e-30 -> 1 (so an
// all-zero padding system solves to exactly 0), normalises the pivot row
// and subtracts col[i] * row[j] from every other row, where col is the
// pivot column read BEFORE the step changes any row, zeroed at row p.
// After K steps the B columns hold X.
//
// What bounds it on this card: one system moves (K^2 + 2*K*M)*4 bytes,
// and the least work that solves it (a Cholesky factorisation and two
// substitutions a right-hand side) is K^3/3 + 2K^2*M FP32 operations;
// this kernel's elimination does (2K-1)*K*(K+2M-1)/2, up to 3x that. At
// K = 64, M = 1 that is ~6 operations per byte, below the H100's FP32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B): at the main path's
// shapes the bound is HBM, reading A once. The ratio grows as ~K/12, so
// only K above ~240 (K = 255) is bound by the FP32 rate. So
// the kernel reads A from device memory exactly once and keeps the K
// steps on chip: one thread block owns one system, loads A and B straight (strided, so Schur sub-blocks
// need no copy) into a [K][K+M] working copy in shared memory and runs
// all K steps there, two barriers a step; only X goes back out. The
// reference's lane padding and HBM concatenation are not needed.
//
// Blocks larger than the 227 KB a block may hold in shared memory (K = 255
// with one RHS is 261 KB) run the same kernel with kShared = false: the
// working copy then lives in device scratch that the caller allocates,
// one slot per resident block, and the blocks stride over the systems.
//
// Built without --use_fast_math: the pivot division stays IEEE, which keeps
// the 1e-4 bars and the exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPivotEps = 1e-30f;
constexpr int kMaxThreads = 256;

template <bool kShared>
__global__ void gj_kernel(const float* __restrict__ a, int64_t sa0,
                          int64_t sa1, int64_t sa2,
                          const float* __restrict__ b, int64_t sb0,
                          int64_t sb1, int64_t sb2,
                          float* __restrict__ x, float* __restrict__ scratch,
                          int64_t r_total, int k, int m) {
  extern __shared__ float smem[];
  const int w = k + m;
  const int n = k * w;
  float* work = kShared ? smem : scratch + (int64_t)blockIdx.x * n;
  float* col = kShared ? smem + n : smem;  // [k] pivot column
  float* row = col + k;                    // [w] normalised pivot row
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // element e = i * w + j walked with stride nt: carry (i, j) instead of
  // dividing in the inner loop
  const int i0 = tid / w, j0 = tid % w;
  const int di = nt / w, dj = nt % w;

  for (int64_t r = blockIdx.x; r < r_total; r += gridDim.x) {
    const float* ar = a + r * sa0;
    const float* br = b + r * sb0;
    {
      int i = i0, j = j0;
      for (int e = tid; e < n; e += nt) {
        work[e] = j < k ? ar[i * sa1 + j * sa2] : br[i * sb1 + (j - k) * sb2];
        i += di;
        j += dj;
        if (j >= w) { j -= w; ++i; }
      }
    }
    __syncthreads();
    for (int p = 0; p < k; ++p) {
      float d = work[p * w + p];
      if (fabsf(d) < kPivotEps) d = 1.0f;
      for (int t = tid; t < w; t += nt) row[t] = work[p * w + t] / d;
      for (int t = tid; t < k; t += nt) col[t] = t == p ? 0.0f : work[t * w + p];
      __syncthreads();
      int i = i0, j = j0;
      for (int e = tid; e < n; e += nt) {
        work[e] = i == p ? row[j] : work[e] - col[i] * row[j];
        i += di;
        j += dj;
        if (j >= w) { j -= w; ++i; }
      }
      __syncthreads();
    }
    float* xr = x + r * (int64_t)k * m;
    for (int e = tid; e < k * m; e += nt) {
      const int i = e / m, c = e % m;
      xr[e] = work[i * w + k + c];
    }
    __syncthreads();  // the next system's load overwrites `work`
  }
}

int threads_for(int n) {
  int t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

int launch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
           const float* b, int64_t sb0, int64_t sb1, int64_t sb2, float* x,
           float* scratch, int64_t r, int k, int m, int grid,
           void* stream) {
  if (r <= 0) return 0;
  const int w = k + m;
  const int threads = threads_for(k * w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t bytes = ((size_t)k * w + k + w) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        gj_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gj_kernel<true><<<(unsigned)r, threads, bytes, s>>>(
        a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, nullptr, r, k, m);
  } else {
    const size_t bytes = ((size_t)k + w) * sizeof(float);
    gj_kernel<false><<<grid, threads, bytes, s>>>(
        a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, scratch, r, k, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block may opt into on `device`, in bytes.
int gj_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// x [r, k] = A^-1 b for A [r, k, k] (strides sa*) and b [r, k] (strides
// sb0, sb1). scratch == NULL runs the shared-memory kernel; otherwise
// scratch holds grid * k * (k + 1) floats. Returns cudaGetLastError().
int gj_aug(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
           const float* b, int64_t sb0, int64_t sb1, float* x,
           float* scratch, int64_t r, int k, int grid, void* stream) {
  return launch(a, sa0, sa1, sa2, b, sb0, sb1, 0, x, scratch, r, k, 1, grid,
                stream);
}

// X [r, k, m] = A^-1 B for A [r, k, k] and B [r, k, m] (strides sb*);
// scratch as for gj_aug, with grid * k * (k + m) floats.
int gj_aug_multi(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                 const float* b, int64_t sb0, int64_t sb1, int64_t sb2,
                 float* x, float* scratch, int64_t r, int k, int m, int grid,
                 void* stream) {
  return launch(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, scratch, r, k, m,
                grid, stream);
}

}  // extern "C"
