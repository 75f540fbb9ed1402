// The sessionrec template's scorer for Hopper (sm_90a): the causal
// self-attention encoder of a padded item history and its readout over the
// tied item embedding.
//
// Replaces no TPU kernel: the JAX package's scorer
// (predictionio_tpu/templates/sessionrec/engine.py, _encode :179 and
// _scorer :204) is einsums and matmuls that XLA compiles, with no
// pl.pallas_call. It was added for the template's contract: a history
// scores bitwise the same at every sequence tier that fits it and in every
// batch that carries it (predict is batch_predict at batch 1). A BLAS
// product picks its kernel by shape, and nothing promises that a row's sum
// keeps its order at another M; the reference's own run breaks the
// contract. Here every per-row result is a fixed sequence of float
// operations on that row's inputs alone:
//
//   - one thread block per history row; no value crosses rows;
//   - every contraction is summed with fmaf in ascending index;
//   - the causal softmax runs over keys j <= i only: the max, then
//     expf(s - m), then the denominator summed in ascending j, then each
//     weight divided by it. The reference's masked terms (score -1e30)
//     underflow to exact zeros, so skipping them is the same math;
//   - only positions i < n = clamp(length, 1, L) are computed, and the
//     readout takes position n - 1 (clip(length - 1, 0, L - 1), the
//     reference's last real position). Causality keeps every one of them
//     a function of positions < n, so the tier L does not enter.
//
// session_encode: h [B, D] from emb [V+1, D], pos [Lpos, D], the blocks'
// weights packed one block after another as wq, wk, wv, wo [D, D],
// w1 [D, 2D], b1 [2D], w2 [2D, D], b2 [D] (row-major, x @ W), seq [B, L]
// and lengths [B] (int32). A block's working rows (x, q, k, v, the
// attention output a, the scores [H, n, n]; the feed-forward hidden rows
// [n, 2D] reuse q and k) live in shared memory when 5·L·D + H·L² floats
// fit, else in a device workspace the caller allocates, one slot per
// resident block, with the blocks striding over the rows.
//
// session_readout: scores [B, V] = h @ items^T, one thread per (row, item),
// summed over D in ascending k.
//
// What bounds them on this card: at the template's shapes (D 16, L <= 32,
// V 8 192) the encoder's least time is its FP32 operations (~16·n·D² a
// block and history, some 5 MFLOP at B 64: under a microsecond), the
// readout's its bytes (the B·V scores written). Both are far from those
// bounds: a block walks its phases one barrier after another over a few
// hundred values, so a launch takes its latency, tens of microseconds.
// This first version reads the weights from device memory through the
// cache; speed waits for later work.
//
// Built without --use_fast_math: expf and the divisions stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 1024;  // resident blocks of the workspace variant

__device__ __forceinline__ int clamp_len(int len, int L) {
  return len < 1 ? 1 : (len > L ? L : len);
}

// Floats of one row's working set at n positions.
__host__ __device__ __forceinline__ int64_t work_floats(int n, int D, int H) {
  return 5 * (int64_t)n * D + (int64_t)H * n * n;
}

// sum_k a[k] * w[k * stride] in ascending k, fused multiply-adds.
__device__ __forceinline__ float dot(const float* a, const float* w,
                                     int stride, int n) {
  float acc = 0.f;
  for (int k = 0; k < n; ++k) acc = fmaf(a[k], __ldg(w + (int64_t)k * stride), acc);
  return acc;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ emb, const float* __restrict__ pos,
              const float* __restrict__ blocks, int n_blocks,
              const int* __restrict__ seq, const int* __restrict__ lengths,
              float* __restrict__ out, float* __restrict__ scratch,
              int64_t B, int L, int D, int H, float scale) {
  extern __shared__ float smem[];
  const int dh = D / H;
  const int64_t block_floats = 8 * (int64_t)D * D + 3 * D;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const int n = clamp_len(lengths[b], L);
    float* x = kShared ? smem
                       : scratch + (int64_t)blockIdx.x * work_floats(L, D, H);
    float* q = x + n * D;
    float* k = q + n * D;
    float* v = k + n * D;
    float* a = v + n * D;
    float* s = a + n * D;
    float* hid = q;  // [n, 2D] over q and k, once they are spent
    const int* row_seq = seq + b * L;
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
      const int i = e / D, c = e % D;
      x[e] = __ldg(emb + (int64_t)row_seq[i] * D + c) +
             __ldg(pos + (int64_t)i * D + c);
    }
    __syncthreads();
    for (int blk = 0; blk < n_blocks; ++blk) {
      const float* wq = blocks + blk * block_floats;
      const float* wk = wq + D * D;
      const float* wv = wk + D * D;
      const float* wo = wv + D * D;
      const float* w1 = wo + D * D;
      const float* b1 = w1 + 2 * D * D;
      const float* w2 = b1 + 2 * D;
      const float* b2 = w2 + 2 * D * D;
      // q, k, v = x @ wq, x @ wk, x @ wv
      for (int e = threadIdx.x; e < 3 * n * D; e += blockDim.x) {
        const int which = e / (n * D), r = e % (n * D);
        const int i = r / D, c = r % D;
        const float* w = which == 0 ? wq : (which == 1 ? wk : wv);
        q[which * n * D + r] = dot(x + i * D, w + c, D, D);
      }
      __syncthreads();
      // scores s[h][i][j] = (q_i . k_j over head h) / sqrt(dh), j <= i
      for (int e = threadIdx.x; e < H * n * n; e += blockDim.x) {
        const int h = e / (n * n), r = e % (n * n);
        const int i = r / n, j = r % n;
        if (j > i) continue;
        const float* qi = q + i * D + h * dh;
        const float* kj = k + j * D + h * dh;
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qi[d], kj[d], acc);
        s[e] = acc / scale;
      }
      __syncthreads();
      // causal softmax of each (head, query) row over j <= i
      for (int e = threadIdx.x; e < H * n; e += blockDim.x) {
        const int i = e % n;
        float* row = s + (int64_t)e * n;
        float m = row[0];
        for (int j = 1; j <= i; ++j) m = fmaxf(m, row[j]);
        float den = 0.f;
        for (int j = 0; j <= i; ++j) {
          const float ex = expf(row[j] - m);
          row[j] = ex;
          den += ex;
        }
        for (int j = 0; j <= i; ++j) row[j] = row[j] / den;
      }
      __syncthreads();
      // a_i = sum_{j <= i} p_ij v_j, head by head
      for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
        const int i = e / D, c = e % D;
        const float* p = s + ((int64_t)(c / dh) * n + i) * n;
        float acc = 0.f;
        for (int j = 0; j <= i; ++j) acc = fmaf(p[j], v[j * D + c], acc);
        a[e] = acc;
      }
      __syncthreads();
      // x = x + a @ wo
      for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
        const int i = e / D, c = e % D;
        x[e] = x[e] + dot(a + i * D, wo + c, D, D);
      }
      __syncthreads();
      // hid = relu(x @ w1 + b1)
      for (int e = threadIdx.x; e < 2 * n * D; e += blockDim.x) {
        const int i = e / (2 * D), c = e % (2 * D);
        hid[e] = fmaxf(dot(x + i * D, w1 + c, 2 * D, D) + __ldg(b1 + c), 0.f);
      }
      __syncthreads();
      // x = x + (hid @ w2 + b2)
      for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
        const int i = e / D, c = e % D;
        x[e] = x[e] + (dot(hid + i * 2 * D, w2 + c, D, 2 * D) + __ldg(b2 + c));
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < D; c += blockDim.x)
      out[b * D + c] = x[(n - 1) * D + c];
    __syncthreads();  // the next row overwrites the working set
  }
}

__global__ void __launch_bounds__(256)
readout_kernel(const float* __restrict__ h, const float* __restrict__ items,
               float* __restrict__ out, int64_t B, int64_t V, int D) {
  const int64_t item = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= V) return;
  const float* er = items + item * D;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const float* hr = h + b * D;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc = fmaf(__ldg(hr + k), __ldg(er + k), acc);
    out[b * V + item] = acc;
  }
}

}  // namespace

extern "C" {

// Shared memory one block may opt into on `device`, in bytes.
int session_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Floats of one workspace slot (one row's working set at tier L).
int64_t session_work_floats(int L, int D, int H) {
  return work_floats(L, D, H);
}

// h [B, D] for seq [B, L] and lengths [B]; see the file's head. scratch ==
// NULL runs the shared-memory kernel (5·L·D + H·L² floats a block);
// otherwise scratch holds grid · session_work_floats(L, D, H) floats and
// grid blocks stride over the rows. Returns cudaGetLastError().
int session_encode(const float* emb, const float* pos, const float* blocks,
                   int n_blocks, const int* seq, const int* lengths,
                   float* out, float* scratch, int64_t B, int L, int D,
                   int H, float scale, int grid, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t bytes = (size_t)work_floats(L, D, H) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        encode_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned g = (unsigned)(B < 0x7fffffff ? B : 0x7fffffff);
    encode_kernel<true><<<g, kThreads, bytes, st>>>(
        emb, pos, blocks, n_blocks, seq, lengths, out, nullptr, B, L, D, H,
        scale);
  } else {
    encode_kernel<false><<<grid, kThreads, 0, st>>>(
        emb, pos, blocks, n_blocks, seq, lengths, out, scratch, B, L, D, H,
        scale);
  }
  return (int)cudaGetLastError();
}

// scores [B, V] = h [B, D] @ items [V, D]^T (both contiguous).
int session_readout(const float* h, const float* items, float* out,
                    int64_t B, int64_t V, int D, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const unsigned gx = (unsigned)((V + 255) / 256);
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  readout_kernel<<<dim3(gx, gy), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      h, items, out, B, V, D);
  return (int)cudaGetLastError();
}

// Workspace slots the encoder's device-memory variant uses at most.
int session_slots() { return kSlots; }

}  // extern "C"
