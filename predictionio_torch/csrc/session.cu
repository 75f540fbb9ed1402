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
// operations on that row's inputs alone, the same in every body below, so
// every body gives the same bits:
//
//   - no value crosses history rows;
//   - every contraction is summed with fmaf in ascending index, from 0.f;
//   - the causal softmax runs over keys j <= i only: the max, then
//     expf(s - m), then the denominator summed in ascending j, then each
//     weight divided by it. The reference's masked terms (score -1e30)
//     underflow to exact zeros, so skipping them is the same math;
//   - only positions i < n = clamp(length, 1, L) are computed, and the
//     readout takes position n - 1 (clip(length - 1, 0, L - 1), the
//     reference's last real position). Causality keeps every one of them
//     a function of positions < n, so the tier L does not enter.
//
// The encoder, h [B, D] from emb [V+1, D], pos [Lpos, D], the blocks'
// weights packed one block after another as wq, wk, wv, wo [D, D],
// w1 [D, 2D], b1 [2D], w2 [2D, D], b2 [D] (row-major, x @ W), seq [B, L]
// and lengths [B] (int32), has two bodies, routed by shape in
// ops/session.py::launch_plan:
//
//   - the warp body (encode_warp_kernel<D, H>; L <= 32, (D, H) one of its
//     instantiations, its shared bytes within the card's): a warp a
//     history, lane i position i, several histories a block. The block's
//     weights (n_blocks * (8D^2 + 3D) floats, 8.4 KB a block at D 16) are
//     staged into shared memory once, by one cp.async.bulk completing on
//     an mbarrier, and every lane reads them there as broadcasts. A lane
//     keeps its x, q, attention output and feed-forward rows in
//     registers (D a template argument, every index a constant); k and v
//     go to shared memory for the other lanes, with the lane's row of
//     scores, and __syncwarp orders the two hand-overs a transformer
//     block. The causal loops run j <= i only;
//   - the block body (encode_block_kernel, the first version's): a
//     128-thread block a history, its working rows (x, q, k, v, the
//     attention output a, the scores [H, n, n]; the feed-forward hidden
//     rows [n, 2D] reuse q and k) in shared memory when 5·L·D + H·L²
//     floats fit, else in a device workspace the caller allocates, one
//     slot per resident block, the blocks striding over the rows.
//
// The readout, scores [B, V] = h @ items^T (readout_tile_kernel): a block
// owns a tile of 128 items, staged into shared memory once with 16-byte
// loads (rows padded to an odd stride, so a warp's 32 items hit 32
// banks), and walks groups of rows; a thread holds 2 rows × 4 items in
// registers, and a warp stores 128 consecutive bytes a row. Each item is
// read from device memory once per row group, not once per row.
//
// session_score launches the encoder, then the readout, on one stream:
// the readout goes out with programmatic stream serialization, the encoder
// lets it launch as soon as its own blocks run (griddepcontrol
// .launch_dependents), and the readout stages its item tile before it
// waits for the encoder's h (griddepcontrol.wait). Launched alone, the
// wait returns at once.
//
// The first version's readout (readout_v1_kernel, a thread a row and
// item) and its encoder (the block body at every shape) stay as
// session_readout_v1 / session_encode_v1, for the A/B on the card.
//
// What bounds them on this card: at the template's shapes (D 16, L <= 32,
// V 8 192) the encoder's least time is its FP32 operations (~16·n·D² a
// block and history, some 5 MFLOP at B 64: under a microsecond), the
// readout's its bytes (the B·V scores written). Neither comes near: the
// warp body is one warp's instruction stream a history (some 3 000 FMAs
// of the six products a lane, then n causal pairs a head, each an expf
// and two IEEE divisions), issued by one scheduler of an SM with nothing
// to hide its latencies, and the readout is a tile's staging and its
// stores behind a launch. Tensor cores are out: TF32, or 3×TF32 with its
// other order, would change the bits.
//
// Built without --use_fast_math: expf and the divisions stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

// -- the block body (the first version's encoder) ---------------------------

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
encode_block_kernel(const float* __restrict__ emb, const float* __restrict__ pos,
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

// -- the first version's readout --------------------------------------------

__global__ void __launch_bounds__(256)
readout_v1_kernel(const float* __restrict__ h, const float* __restrict__ items,
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

// -- Hopper's launch and copy primitives ------------------------------------

// Lets the grid launched after this one with programmatic stream
// serialization start (its blocks run up to their griddepcontrol.wait).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Waits until the grid this one depends on has finished and its writes are
// visible; returns at once in a grid launched without the dependency.
__device__ __forceinline__ void wait_dependency() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Starts copying `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global `src` to shared `dst`: thread 0 initialises the mbarrier at
// `bar` and issues one cp.async.bulk that completes on it. Every thread of
// the block must pass the __syncthreads after this before it waits.
__device__ __forceinline__ void start_bulk(float* dst, const float* src,
                                           uint32_t bytes, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes),
         "r"(b) : "memory");
}

// Returns once the copy `start_bulk` issued on `bar` has landed.
__device__ __forceinline__ void wait_bulk(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"((uint32_t)__cvta_generic_to_shared(bar)) : "memory");
}

// -- the warp body ------------------------------------------------------------

// dst = src[0, N) from shared memory, 16 bytes a load where N allows (src
// then 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int d = 0; d < N; d += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + d);
      dst[d] = t.x;
      dst[d + 1] = t.y;
      dst[d + 2] = t.z;
      dst[d + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < N; ++d) dst[d] = src[d];
  }
}

// Shared memory of the warp body: 16 bytes (the mbarrier), the weights
// rounded up to 4 floats, then per warp k and v [L, D + 4] and the lanes'
// score rows [32, (L + 1) | 1] (an odd stride: a warp's 32 lanes hit 32
// banks); ops/session.py::launch_plan counts the same bytes. A lane's first
// history gathers its x while the weights' copy is in flight.
template <int D, int H>
__global__ void __launch_bounds__(256)
encode_warp_kernel(const float* __restrict__ emb, const float* __restrict__ pos,
                   const float* __restrict__ blocks, int n_blocks,
                   const int* __restrict__ seq, const int* __restrict__ lengths,
                   float* __restrict__ out, int64_t B, int L, float scale) {
  constexpr int DH = D / H;
  constexpr int KS = D + 4;  // k, v row stride: 16-byte rows, spread banks
  constexpr int WB = 8 * D * D + 3 * D;  // floats of one block's weights
  extern __shared__ __align__(16) float smem[];
  launch_dependents();
  const int wfloats = n_blocks * WB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* w = smem + 4;
  start_bulk(w, blocks, (uint32_t)wfloats * 4u, bar);
  __syncthreads();  // the barrier is initialised before anyone waits on it
  bool staged = false;
  const int hpb = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int SR = (L + 1) | 1;
  float* kb = w + ((wfloats + 3) & ~3) + warp * (2 * L * KS + 32 * SR);
  float* vb = kb + L * KS;
  float* srow = vb + L * KS + lane * SR;
  for (int64_t b = (int64_t)blockIdx.x * hpb + warp; b < B;
       b += (int64_t)gridDim.x * hpb) {
    const int n = clamp_len(lengths[b], L);
    const bool live = lane < n;
    float x[D];
#pragma unroll
    for (int c = 0; c < D; ++c) x[c] = 0.f;
    if (live) {
      const float* e = emb + (int64_t)seq[b * L + lane] * D;
      const float* p = pos + (int64_t)lane * D;
#pragma unroll
      for (int c = 0; c < D; ++c) x[c] = __ldg(e + c) + __ldg(p + c);
    }
    if (!staged) {
      wait_bulk(bar);
      staged = true;
    }
    for (int blk = 0; blk < n_blocks; ++blk) {
      const float* wq = w + blk * WB;
      const float* wk = wq + D * D;
      const float* wv = wk + D * D;
      const float* wo = wv + D * D;
      const float* w1 = wo + D * D;
      const float* b1 = w1 + 2 * D * D;
      const float* w2 = b1 + 2 * D;
      const float* b2 = w2 + 2 * D * D;
      float q[D], a[D];
#pragma unroll
      for (int c = 0; c < D; ++c) q[c] = a[c] = 0.f;
      // q, k, v = x @ wq, x @ wk, x @ wv; k and v to the warp's rows
      if (live) {
        float kk[D], vv[D];
#pragma unroll
        for (int c = 0; c < D; ++c) kk[c] = vv[c] = 0.f;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          const float xr = x[r];
#pragma unroll
          for (int c = 0; c < D; c += 4) {
            const float4 fq = *reinterpret_cast<const float4*>(wq + r * D + c);
            const float4 fk = *reinterpret_cast<const float4*>(wk + r * D + c);
            const float4 fv = *reinterpret_cast<const float4*>(wv + r * D + c);
            q[c] = fmaf(xr, fq.x, q[c]);
            q[c + 1] = fmaf(xr, fq.y, q[c + 1]);
            q[c + 2] = fmaf(xr, fq.z, q[c + 2]);
            q[c + 3] = fmaf(xr, fq.w, q[c + 3]);
            kk[c] = fmaf(xr, fk.x, kk[c]);
            kk[c + 1] = fmaf(xr, fk.y, kk[c + 1]);
            kk[c + 2] = fmaf(xr, fk.z, kk[c + 2]);
            kk[c + 3] = fmaf(xr, fk.w, kk[c + 3]);
            vv[c] = fmaf(xr, fv.x, vv[c]);
            vv[c + 1] = fmaf(xr, fv.y, vv[c + 1]);
            vv[c + 2] = fmaf(xr, fv.z, vv[c + 2]);
            vv[c + 3] = fmaf(xr, fv.w, vv[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          *reinterpret_cast<float4*>(kb + lane * KS + c) =
              make_float4(kk[c], kk[c + 1], kk[c + 2], kk[c + 3]);
          *reinterpret_cast<float4*>(vb + lane * KS + c) =
              make_float4(vv[c], vv[c + 1], vv[c + 2], vv[c + 3]);
        }
      }
      __syncwarp();  // rows j < n of k and v are written
      // a_i = sum_{j <= i} softmax_j(q_i . k_j / scale) v_j, head by head
      if (live) {
#pragma unroll
        for (int hh = 0; hh < H; ++hh) {
          float m = 0.f, den = 0.f;
          for (int j = 0; j <= lane; ++j) {
            float kj[DH];
            load_row(kj, kb + j * KS + hh * DH);
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < DH; ++d) acc = fmaf(q[hh * DH + d], kj[d], acc);
            const float s = acc / scale;
            srow[j] = s;
            m = j == 0 ? s : fmaxf(m, s);
          }
          for (int j = 0; j <= lane; ++j) {
            const float ex = expf(srow[j] - m);
            srow[j] = ex;
            den += ex;
          }
          for (int j = 0; j <= lane; ++j) {
            const float p = srow[j] / den;
            float vj[DH];
            load_row(vj, vb + j * KS + hh * DH);
#pragma unroll
            for (int d = 0; d < DH; ++d)
              a[hh * DH + d] = fmaf(p, vj[d], a[hh * DH + d]);
          }
        }
      }
      __syncwarp();  // every lane is done with k and v
      if (live) {
        // x = x + a @ wo
        float o[D];
#pragma unroll
        for (int c = 0; c < D; ++c) o[c] = 0.f;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          const float ar = a[r];
#pragma unroll
          for (int c = 0; c < D; c += 4) {
            const float4 f = *reinterpret_cast<const float4*>(wo + r * D + c);
            o[c] = fmaf(ar, f.x, o[c]);
            o[c + 1] = fmaf(ar, f.y, o[c + 1]);
            o[c + 2] = fmaf(ar, f.z, o[c + 2]);
            o[c + 3] = fmaf(ar, f.w, o[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < D; ++c) x[c] = x[c] + o[c];
        // hid = relu(x @ w1 + b1), then x = x + (hid @ w2 + b2)
        float hid[2 * D];
#pragma unroll
        for (int c = 0; c < 2 * D; ++c) hid[c] = 0.f;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          const float xr = x[r];
#pragma unroll
          for (int c = 0; c < 2 * D; c += 4) {
            const float4 f =
                *reinterpret_cast<const float4*>(w1 + r * 2 * D + c);
            hid[c] = fmaf(xr, f.x, hid[c]);
            hid[c + 1] = fmaf(xr, f.y, hid[c + 1]);
            hid[c + 2] = fmaf(xr, f.z, hid[c + 2]);
            hid[c + 3] = fmaf(xr, f.w, hid[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < 2 * D; ++c) hid[c] = fmaxf(hid[c] + b1[c], 0.f);
        float f2[D];
#pragma unroll
        for (int c = 0; c < D; ++c) f2[c] = 0.f;
#pragma unroll
        for (int r = 0; r < 2 * D; ++r) {
          const float hr = hid[r];
#pragma unroll
          for (int c = 0; c < D; c += 4) {
            const float4 f = *reinterpret_cast<const float4*>(w2 + r * D + c);
            f2[c] = fmaf(hr, f.x, f2[c]);
            f2[c + 1] = fmaf(hr, f.y, f2[c + 1]);
            f2[c + 2] = fmaf(hr, f.z, f2[c + 2]);
            f2[c + 3] = fmaf(hr, f.w, f2[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < D; ++c) x[c] = x[c] + (f2[c] + b2[c]);
      }
    }
    if (lane == n - 1) {
#pragma unroll
      for (int c = 0; c < D; ++c) out[b * D + c] = x[c];
    }
  }
}

// -- the tiled readout --------------------------------------------------------

constexpr int kRdThreads = 256;  // 8 warps
constexpr int kRdTile = 128;     // items a block: lane + 32·u, u < 4

// Block (x, y): items [128x, 128x + 128), row groups g = y, y + gridDim.y,
// ... of `rows` rows each (a multiple of 16); in a group, warp w takes the
// row pairs (w + 16t, w + 16t + 8). Shared memory: the item tile
// [128, D | 1], then the group's rows [rows, D]. h is read only after
// wait_dependency, and without the read-only path: it is the encoder's
// output when the pair runs.
__global__ void __launch_bounds__(kRdThreads)
readout_tile_kernel(const float* h, const float* __restrict__ items,
                    float* __restrict__ out, int64_t B, int64_t V, int D,
                    int rows) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D | 1;
  float* et = smem;
  float* ht = smem + kRdTile * DP;
  const int64_t v0 = (int64_t)blockIdx.x * kRdTile;
  const int nv = (int)(V - v0 < kRdTile ? V - v0 : kRdTile);
  const float* src = items + v0 * D;
  const int tile = nv * D;
  if ((D & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int e = threadIdx.x; e < tile / 4; e += kRdThreads) {
      const float4 t = __ldg(s4 + e);
      const int v = 4 * e / D, k = 4 * e - v * D;
      float* d = et + v * DP + k;
      d[0] = t.x;
      d[1] = t.y;
      d[2] = t.z;
      d[3] = t.w;
    }
  } else {
    for (int e = threadIdx.x; e < tile; e += kRdThreads) {
      const int v = e / D;
      et[v * DP + e - v * D] = __ldg(src + e);
    }
  }
  wait_dependency();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t groups = (B + rows - 1) / rows;
  for (int64_t g = blockIdx.y; g < groups; g += gridDim.y) {
    const int64_t r0 = g * rows;
    const int nr = (int)(B - r0 < rows ? B - r0 : rows);
    __syncthreads();  // the item tile is staged; the last group's rows spent
    for (int e = threadIdx.x; e < nr * D; e += kRdThreads)
      ht[e] = h[r0 * D + e];
    __syncthreads();
    for (int rr = warp; rr < nr; rr += 16) {
      const bool second = rr + 8 < nr;
      const float* h0 = ht + rr * D;
      const float* h1 = second ? h0 + 8 * D : h0;
      float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < D; ++k) {
        const float a0 = h0[k], a1 = h1[k];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float e = et[(lane + 32 * u) * DP + k];
          acc0[u] = fmaf(a0, e, acc0[u]);
          acc1[u] = fmaf(a1, e, acc1[u]);
        }
      }
      float* o = out + (r0 + rr) * V + v0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = lane + 32 * u;
        if (v < nv) {
          o[v] = acc0[u];
          if (second) o[8 * V + v] = acc1[u];
        }
      }
    }
  }
}

// -- launches -----------------------------------------------------------------

// The launch plan's entries (ops/session.py::LaunchPlan.array writes them).
enum PlanEntry : int {
  kBody, kEncGrid, kEncThreads, kEncShared, kRdGridX, kRdGridY, kRdShared,
  kRdRows, kB, kL, kD, kH, kV, kBlocks,
};
enum Body : int64_t { kBodyNone, kBodyWarp, kBodyShared, kBodyWorkspace };

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, int H>
cudaError_t launch_warp(const int64_t* plan, const float* emb,
                        const float* pos, const float* blocks, const int* seq,
                        const int* lengths, float* out, float scale,
                        cudaStream_t st) {
  const int n_blocks = (int)plan[kBlocks];
  const int64_t bytes = plan[kEncShared];
  cudaError_t err = allow_shared(encode_warp_kernel<D, H>, bytes);
  if (err != cudaSuccess) return err;
  encode_warp_kernel<D, H><<<(unsigned)plan[kEncGrid],
                             (unsigned)plan[kEncThreads], (size_t)bytes, st>>>(
      emb, pos, blocks, n_blocks, seq, lengths, out, plan[kB], (int)plan[kL],
      scale);
  return cudaGetLastError();
}

cudaError_t launch_encode(const int64_t* plan, const float* emb,
                          const float* pos, const float* blocks,
                          const int* seq, const int* lengths, float* out,
                          float* scratch, float scale, cudaStream_t st) {
  const int D = (int)plan[kD], H = (int)plan[kH];
  switch (plan[kBody]) {
    case kBodyNone:
      return cudaSuccess;
    case kBodyWarp:
#define PIO_WARP_CASE(d, h)                                                  \
  if (D == d && H == h)                                                      \
    return launch_warp<d, h>(plan, emb, pos, blocks, seq, lengths, out,      \
                             scale, st);
      PIO_WARP_CASE(8, 1)
      PIO_WARP_CASE(8, 2)
      PIO_WARP_CASE(8, 4)
      PIO_WARP_CASE(16, 1)
      PIO_WARP_CASE(16, 2)
      PIO_WARP_CASE(16, 4)
#undef PIO_WARP_CASE
      return cudaErrorInvalidValue;
    case kBodyShared: {
      cudaError_t err = cudaFuncSetAttribute(
          encode_block_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan[kEncShared]);
      if (err != cudaSuccess) return err;
      encode_block_kernel<true><<<(unsigned)plan[kEncGrid], kThreads,
                                  (size_t)plan[kEncShared], st>>>(
          emb, pos, blocks, (int)plan[kBlocks], seq, lengths, out, nullptr,
          plan[kB], (int)plan[kL], D, H, scale);
      return cudaGetLastError();
    }
    case kBodyWorkspace:
      encode_block_kernel<false><<<(unsigned)plan[kEncGrid], kThreads, 0,
                                   st>>>(
          emb, pos, blocks, (int)plan[kBlocks], seq, lengths, out, scratch,
          plan[kB], (int)plan[kL], D, H, scale);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_readout(const int64_t* plan, const float* h,
                           const float* items, float* out, bool dependent,
                           cudaStream_t st) {
  if (plan[kRdGridX] <= 0 || plan[kRdGridY] <= 0) return cudaSuccess;
  cudaError_t err = allow_shared(readout_tile_kernel, plan[kRdShared]);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)plan[kRdGridX], (unsigned)plan[kRdGridY]);
  cfg.blockDim = dim3(kRdThreads);
  cfg.dynamicSmemBytes = (size_t)plan[kRdShared];
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, readout_tile_kernel, h, items, out,
                           (int64_t)plan[kB], (int64_t)plan[kV],
                           (int)plan[kD], (int)plan[kRdRows]);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the return code
    return err;
  }
  return cudaGetLastError();
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

// h [B, D] (`out`) for seq [B, L] and lengths [B]; see the file's head.
// `plan` is ops/session.py's launch plan (its encoder entries); `scratch`
// holds its workspace when the plan routes the workspace variant. Returns
// a CUDA error code, 0 on success.
int session_encode(const float* emb, const float* pos, const float* blocks,
                   const int* seq, const int* lengths, float* out,
                   float* scratch, const int64_t* plan, float scale,
                   void* stream) {
  return (int)launch_encode(plan, emb, pos, blocks, seq, lengths, out, scratch,
                            scale, static_cast<cudaStream_t>(stream));
}

// scores [B, V] = h [B, D] @ items [V, D]^T (both contiguous), by the
// plan's readout entries.
int session_readout(const float* h, const float* items, float* out,
                    const int64_t* plan, void* stream) {
  return (int)launch_readout(plan, h, items, out, false,
                             static_cast<cudaStream_t>(stream));
}

// The pair: scores [B, V] against items = the first V rows of emb. `out`
// holds the scores [B, V], then h [B, D], then the encoder's workspace,
// if any. The readout launches as a programmatic dependent of the encoder.
int session_score(const float* emb, const float* pos, const float* blocks,
                  const int* seq, const int* lengths, float* out,
                  const int64_t* plan, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h = out + plan[kB] * plan[kV];
  float* scratch = h + plan[kB] * plan[kD];
  cudaError_t err = launch_encode(plan, emb, pos, blocks, seq, lengths, h,
                                  scratch, scale, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_readout(plan, h, emb, out, true, st);
}

// The first version's encoder: the block body at every shape. scratch ==
// NULL runs the shared-memory variant (5·L·D + H·L² floats a block);
// otherwise scratch holds grid · (5·L·D + H·L²) floats (ops/session.py's
// work_floats a slot) and grid blocks stride over the rows. Returns
// cudaGetLastError().
int session_encode_v1(const float* emb, const float* pos, const float* blocks,
                      int n_blocks, const int* seq, const int* lengths,
                      float* out, float* scratch, int64_t B, int L, int D,
                      int H, float scale, int grid, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t bytes = (size_t)work_floats(L, D, H) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        encode_block_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned g = (unsigned)(B < 0x7fffffff ? B : 0x7fffffff);
    encode_block_kernel<true><<<g, kThreads, bytes, st>>>(
        emb, pos, blocks, n_blocks, seq, lengths, out, nullptr, B, L, D, H,
        scale);
  } else {
    encode_block_kernel<false><<<grid, kThreads, 0, st>>>(
        emb, pos, blocks, n_blocks, seq, lengths, out, scratch, B, L, D, H,
        scale);
  }
  return (int)cudaGetLastError();
}

// The first version's readout: a thread a row and item.
int session_readout_v1(const float* h, const float* items, float* out,
                       int64_t B, int64_t V, int D, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const unsigned gx = (unsigned)((V + 255) / 256);
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  readout_v1_kernel<<<dim3(gx, gy), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(h, items, out, B,
                                                           V, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
