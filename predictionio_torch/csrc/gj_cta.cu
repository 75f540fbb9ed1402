// Batched Gauss-Jordan solve of small SPD systems, x = A^-1 b,
// 64 < K <= 256, one thread block per system with a row per thread, for
// Hopper (sm_90a): at 64 < K <= 128 the rows lie in registers, at
// 128 < K <= 256 each row is split between shared memory and registers;
// and X = A^-1 B with M right-hand sides at 32 < K <= 128 (at the end of
// this note).
//
// Replaces four TPU kernels of predictionio_tpu/ops/pallas_solve.py:
//   - _build_solver_aug :249 at 64 < K <= 256 (entry points gj_aug_cta at
//     K <= 128, gj_aug_split above; any rank from 65 to 95 under `auto`,
//     every rank up to 256 under a forced layout, and the Schur
//     recursion's base calls with one right-hand side at K > 64);
//   - _build_solver_packed :101 (entry points gj_packed_cta,
//     gj_packed_split);
//   - _build_solver_blocked2 :177, pallas_call at :237 (entry points
//     gj_blocked2_cta, gj_blocked2_split; even K);
//   - _build_solver_aug_multi :296, pallas_call at :329, at 32 < K <= 128
//     with M > 1 (entry point gj_aug_multi_cta; the Schur base calls of
//     ranks such as 98, 150, 250 and 252).
// At K <= 64 gj_reg.cu runs the first three, and gj_multi_reg.cu the
// fourth at K <= 32; gj_solve.cu's gj_aug and gj_layouts.cu's gj_packed
// and gj_blocked2 keep only K > 256, and gj_solve.cu's gj_aug_multi only
// K > 128 with M > 1, where no route goes; ops/spd_solve.py routes. As
// in gj_reg.cu the packed layout (column Gauss-Jordan on [[A], [b^T]]) is
// the row elimination below applied to [A^T | b], so one body serves both
// and only the load differs (kLayout); for an A that is not bitwise
// symmetric the packed entry points solve A^T x = b, as the TPU kernel
// does. The blocked2 layout loads as aug does and takes two pivots a step
// (at the end of this note).
//
// What held the kernels this replaces back: gj_solve.cu and gj_layouts.cu
// keep the [K][K+1] copy in shared memory and make about four
// shared-memory accesses per element per step (element, pivot-column
// entry, pivot-row entry, write back), two block barriers a step, one IEEE
// division per pivot-column element, and the pivot column read with
// stride K (32-way bank conflicts at K = 64 and 128). What the card bounds
// this solve by: (K^2 + 2K)*4 bytes against the K^3/3 + 2K^2 FP32
// operations of the least work that solves an SPD system (a Cholesky
// factorisation and two substitutions), ~11 per byte at K = 128, under the
// H100's FP32 ridge of 20 (67 TFLOP/s over 3.35 TB/s): 0.28 ms for 13 850
// systems at K = 128 and 0.108 ms at K = 80, both set by bytes.
//
// Design: one thread block owns one system, KP threads, KP in {96, 128} a
// template parameter and K <= KP at run time. Thread i holds row i of A
// (of A^T when kPacked) in KP registers and b_i in one more. Rows and
// columns K..KP-1 are zero, steps p >= K are skipped by a branch uniform
// across the block, and the padding rows' threads skip their updates, so
// the padding changes no result. Step p:
//   - thread p, the owner of the pivot row, guards its pivot d
//     (|d| < 1e-30 -> 1, so an all-zero padding system solves to exactly
//     0), takes one IEEE reciprocal __frcp_rn(d), keeps it, and writes its
//     row right of the pivot, b_p and 1/d to the pivot-row buffer p mod 2
//     in shared memory with 16-byte stores. The row is not scaled: that
//     would be K - p multiplies in one thread while the block waits, and
//     made the kernel 8-11 % slower at K = 80, 96 and 128 (PERF.md);
//   - one __syncthreads;
//   - every other thread forms its multiplier m = c / d as c * (1/d), c
//     its own column-p value read before the step, reads the row back as
//     16-byte broadcast loads and updates its columns right of p and its
//     b entry with one fused multiply-add each. The pivot row stays as it
//     is; columns <= p are never read again.
// After K steps row i holds d_i x_i in its b entry, and x_i = b_i * (1/d_i)
// with the reciprocal thread i took at its own pivot.
//
// Why one barrier a step is enough: the pivot row is double-buffered.
// Buffer p mod 2 is written at step p before barrier p and read after it;
// its next write, at step p + 2, comes after barrier p + 1, which no
// thread passes before every thread has arrived there, i.e. has finished
// its reads of step p. The write of step p + 1 goes to the other buffer,
// so it cannot race with a slow reader of step p either. A thread's own
// update of step p - 1 precedes, in program order, its pivot work at
// step p, so the owner writes a row that is up to date.
//
// Registers and code: a register array can only be indexed by
// compile-time constants, yet the step loop, whose body names column p,
// must not be unrolled in full: at KP = 128 that is ~30 k instructions
// (~480 KB), far more than an SM's instruction cache; that version, which
// also scaled the pivot row in its owner, ran 1.4-1.7x slower than the
// form below (PERF.md). So the row is rotated:
// the steps run in groups of kGroup (4), each group's pivot columns in
// r[0..3], and after each group every register moves down four places;
// one rolled loop body serves every group. The rotation costs a move per
// column per group, and the body updates a fixed width W instead of the
// K - p columns right of the pivot, so the steps run in kPhases (4)
// phases of KP/4 steps whose widths KP, 3KP/4, KP/2, KP/4 still cover
// every live column: ~5/4 of the triangle's multiply-adds.
//
// What bounds the design: every step delivers the pivot row to every
// thread from shared memory, (W + 4) * 4 bytes a thread, and an SM's
// shared memory delivers at most 128 bytes a clock, however many threads
// read one address. At K = 128 that is ~5.5 MB, ~43 k clocks, a system:
// ~2.3 ms for 13 850 systems on 132 SMs at 1.98 GHz, above the card's
// 0.28 ms bound. That is the price of a row per thread; a thread holding
// a block of several rows would use each delivered value more than once.
//
// A is read from device memory once. The packed load needs no staging:
// thread i reads A[j][i] for each row j, so where A's rows are contiguous
// the block reads row j in one coalesced access. The aug load reads each
// warp's 32 rows in chunks of 32 columns, coalesced, all issued before
// the first is used, and transposes every chunk through a per-warp shared
// tile of stride 33 (odd, so lane i reading row i finds 32 different
// banks). Only x is written.
//
// Above K = 128 (gj_aug_split, gj_packed_split; 128 < K <= 256): a row of
// [A | b] is up to 257 floats, too many for one thread's registers, and
// the kernels this replaces kept the [K][K+1] copy in shared memory up to
// K ~ 239 and in device scratch above (261 KB a system at K = 255, more
// than a block's 227 KB): every step then read and wrote all of it through
// HBM, two barriers a step. The card's bound: at K = 192 (K^2 + 2K)*4
// bytes against K^3/3 + 2K^2 operations is ~16 per byte, set by bytes
// (0.62 ms for 13 850 systems); at K = 255 ~22 per byte, set by the FP32
// rate (0.087 ms for 1 024 systems).
//
// Design: still one thread block per system and a row per thread,
// round_up(K, 32) <= 256 threads, and one block an SM. Row i is split at
// L = K - 128 (1 to 128):
//   - columns 0 .. L-1 lie in dynamic shared memory, row i at i * S floats.
//     The stride S >= L is a multiple of 4 and S = 4 (mod 32), so a
//     quarter-warp's 16-byte accesses to its eight own rows at one column
//     cover all 32 banks; at K = 256, 256 rows * 132 floats = 135 KB;
//   - columns L .. K-1 and b_i lie in registers, r[0..127] and rb, as in
//     gj_cta_kernel<128>.
// Steps 0 .. L-1 pivot in the shared part (split_steps):
//   - the owner p guards d and takes __frcp_rn(d) as above, and writes
//     only its register part, b_p and 1/d to the pivot-row buffer. The
//     shared part of the pivot row is read in place from row p;
//   - every other thread forms m = c * (1/d) from its own column-p value,
//     and updates its shared columns from the quad holding p + 1 to L - 1
//     (16-byte loads of row p, broadcast, and of its own row, one FMA
//     each, a 16-byte store), its 128 register columns and rb. The
//     columns <= p it also touches in the first quad are dead: no later
//     step reads them. The owner skips its shared columns: it would write
//     the values it has, but the write would race with the readers of
//     row p.
// Steps L .. K-1 are gj_cta_kernel<128>'s phases with the row index
// shifted to i - L: rows i < L get a negative index, never pivot and go
// on updating; padding rows get i - L >= 128 and skip, as there. After
// step L - 1 every shared column is dead.
//
// Why one barrier a step is still enough: row p is read in place during
// step p, after barrier p. Its owner next writes it at step p + 1, after
// barrier p + 1, which no thread passes before it has finished its reads
// of step p; and every earlier write to row p (by thread p, at steps
// < p) came before barrier p. A row is written only by its own thread.
// The pivot-row buffers keep their parity across the hand-off: the
// shared steps use buffer (p + L) mod 2, so step L - 1 takes buffer 1 and
// step L, the first register step, buffer 0 (the phases' first), for
// every L, odd or even; with buffer p mod 2 instead, an odd L would have
// steps L - 1 and L share buffer 0. The load's writes to shared memory
// end in one more barrier before step 0.
//
// Loads: the shared part first, straight into shared memory with no
// transpose, staged in r with 32 loads in flight a thread (a block has
// no other block on its SM to hide a chain of loads behind): aug rows by
// warps, 32 consecutive columns a warp access; packed columns by threads
// (thread i reads A[c][i], coalesced across the block), stored four at
// a time. Then the register part as gj_cta_kernel loads it, at columns
// L .. K-1 (the aug load through eight per-warp tiles).
// Only x is written.
//
// What bounds it: shared-memory delivery, as at K <= 128 but with twice
// the threads. Every step of the shared part moves, for each thread, its
// own quads in and out and the pivot row's quads in, (3 (L - p) + 132) * 4
// bytes a thread a step with the 33 register-part quads; the register
// phases then move gj_cta_kernel<128>'s. That is ~50 MB a system at
// K = 255, ~0.4 M clocks at 128 bytes a clock: ~1.6 ms for 1 024 systems
// on 132 SMs in eight waves, ~20x the card's bound. Registers: the 129
// floats of the row and the hoisted broadcasts, under the 255 a thread
// that 256 threads and one block an SM allow; shared memory: 4 * K * S
// bytes dynamic (opted into above 48 KB at each launch) and 34 KB static
// (the aug load's tiles and the pivot-row buffers).
//
// blocked2 (kPair; gj_blocked2_cta, gj_blocked2_split): the kernel it
// replaces, gj_layouts.cu's gj_blocked2, kept the [K][K+1] copy in shared
// memory (in device scratch at K = 256, 263 KB), two barriers and about
// four shared accesses an element a pivot pair: 18.1 ms at
// [13 850, 128, 1], twice the library's Cholesky solve (PERF.md). The
// card's bound is the one above. The pair bodies are the single-step
// ones with each group of four steps run as two pair steps p, p + 1
// (p even, k even):
//   - owners p and p + 1 write their rows right of the pair, their b and
//     their two pivot-block entries to buffers prow[2t] and prow[2t + 1],
//     t = (p/2) mod 2; the split steps read the shared part of both rows
//     in place, and the owners skip their shared rows, as above;
//   - one __syncthreads a pair step: the argument above holds with pair
//     steps in place of steps. Across the hand-off the shared pair steps
//     take t = ((p + L)/2) mod 2, so step L - 2 takes t = 1 and the first
//     register pair step t = 0 (L = K - 128 is even);
//   - every thread guards det = p00 p11 - p01 p10 (|det| < 1e-30 -> 1),
//     takes rdet = 1/det alike, and forms [m0 m1] = [c0 c1] P^-1 from its
//     own columns p, p + 1; columns right of p + 1 and b take
//     w -= m0 row_p + m1 row_p+1, two FMAs. The owners keep their rows and
//     their row of P^-1, and x_p = (row of P^-1) . (b_p, b_p+1), the
//     partner's b one __shfl_xor_sync(.., 1) away.
// A pair step delivers two pivot rows for twice the FMAs, so the
// shared-memory floor above stays; the pair halves the barriers and the
// dependent pivot chains.
//
// Many right-hand sides (gj_aug_multi_cta; 32 < K <= 128, any M): the
// Schur recursion ends at every odd K, so every rank from 96 to 256 but
// the 25 whose halving stays even down to K <= 32 has base calls above
// K = 32: [R, K, 1] at odd ranks (the one-RHS kernels take those), and
// [R, K, K + 1], [R, K, 2K + 1], [R, K, 3K + 1] with odd K from 33 to 127
// at ranks 2K and 4K (M from 34 to 190). The kernel it replaces there,
// gj_solve.cu's gj_aug_multi, keeps the [K][K+M] copy in shared memory and
// rewrites every element of it, the dead columns at or left of the pivot
// too, in each of the K steps with two barriers a step and at most 256
// threads: 0.58 ms at [2 744, 49, 50], 2.5 % of its bound (PERF.md), and
// the copy grows as K (K + M), to 125 x 251 at rank 250. The card's bound
// is (K^2 + 2KM)*4 bytes against K^3/3 + 2K^2 M operations: set by bytes
// up to K ~ 100 (0.121 ms at [13 850, 49, 50]), by the FP32 rate above
// (0.188 ms at [2 744, 125, 126]).
//
// Design: gj_cta_kernel's body with B's columns beside the row. One
// thread block per (system, chunk of B's columns), KP in {64, 96, 128}
// threads; B's M columns are split into nq = ceil(M / Cmax) near-equal
// chunks, Cmax = 64 at KP = 64 and 32 above, and a chunk of w columns runs
// in C = 32 (w <= 32) or 64 column slots; KP and C are template
// parameters. Thread i holds row i of A in r[0..KP-1] and its w entries
// of the chunk in rb[0..C-1], zero past w, all in registers. Every step
// is the single-step body above with C more columns: the owner writes its
// C entries to the pivot-row buffer after its row, and 1/d in the quad
// after them; every other thread updates its C entries with one FMA each.
// At the end X_ij = B_ij * (1/d_i), written through the warp's load tile
// so that each row of X goes out in coalesced runs of 32 columns. Every
// chunk's block repeats A's elimination, as gj_multi_reg.cu's warps do: a
// column of X then depends on nothing but A and its own column of B, so X
// is bitwise the same whatever R, the chunking and the other systems of
// the launch are. A and B are loaded as the aug load loads A (B's rows
// contiguous for the recursion's torch.cat results and views).
//
// Registers set Cmax: ptxas takes 146 and 241 registers at KP = 64 with
// C = 32 and 64, 188 and 242 at KP = 96 and 128 with C = 32, and spills
// with C = 64 there (or C = 96, 128 at KP = 64), with or without fences
// that keep the step's loads of B from being hoisted (PERF.md).
//
// What bounds it: shared-memory delivery again, (W + C + 4)*4 bytes a
// thread a step for W + C FMAs, in each of nq chunks: 30 MB a system at
// [*, 125, 126] (four chunks of C = 32), a 2.46 ms floor for 2 744
// systems at 128 bytes a clock an SM, 13x the card's bound; 1.45 MB a
// system at [*, 49, 50] (one chunk of 64), 0.60 ms for 13 850. The kernel
// runs at 1.3-1.7x that floor. The other design, A's row in registers and
// B's rows in shared memory (3 shared accesses an element a step, no
// repeated elimination), ran slower at four of five shapes and faster at
// [13 850, 75, 76], where this one takes three chunks (PERF.md).
//
// Built without --use_fast_math: the reciprocals are __frcp_rn (IEEE,
// round to nearest), which keeps the 1e-4 bars and the exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kPivotEps = 1e-30f;
constexpr int kGroup = 4;   // steps between two rotations of the row
constexpr int kPhases = 4;  // phases of K/4 steps, each of its own width
constexpr int kTile = 33;          // the aug load's tile row stride
constexpr int kSplitCols = 128;     // columns of a split row in registers
constexpr int kSplitThreads = 256;  // the most threads a split block has
// the layouts the kernels serve (kLayout)
constexpr int kAug = 0;     // row Gauss-Jordan on [A | b]
constexpr int kPacked = 1;  // the same on [A^T | b]
constexpr int kPair = 2;    // blocked2: [A | b], two pivots a step

// Floats between two rows of the split kernels' shared part for L shared
// columns: the least S >= L with S = 4 (mod 32).
__host__ __device__ constexpr int split_stride(int l) {
  return (l + 27) / 32 * 32 + 4;
}

// Dynamic shared bytes of one split block at rank k.
constexpr size_t split_shared_bytes(int k) {
  return (size_t)k * split_stride(k - kSplitCols) * sizeof(float);
}

// The pivot row's owner at step p0 + u: its columns right of the pivot,
// quads (u + 1)/4 .. W/4 - 1 of r, to the pivot-row buffer.
template <int KP, int W>
__device__ __forceinline__ void put_row(float4* buf, const float (&r)[KP],
                                        int u) {
#pragma unroll
  for (int q = (u + 1) / 4; q < W / 4; ++q)
    buf[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// Every other thread at step p0 + u: r -= m * (pivot row) right of the
// pivot, one FMA a column.
template <int KP, int W>
__device__ __forceinline__ void sub_row(float (&r)[KP], const float4* buf,
                                        float m, int u) {
#pragma unroll
  for (int q = (u + 1) / 4; q < W / 4; ++q) {
    const float4 v = buf[q];
    const int j = 4 * q;
    if (j > u) r[j] = fmaf(-m, v.x, r[j]);
    if (j + 1 > u) r[j + 1] = fmaf(-m, v.y, r[j + 1]);
    if (j + 2 > u) r[j + 2] = fmaf(-m, v.z, r[j + 2]);
    if (j + 3 > u) r[j + 3] = fmaf(-m, v.w, r[j + 3]);
  }
}

// Steps p0 .. p0 + kGroup - 1 (stopping at k) on thread i's row r, which
// holds A's columns p0, p0 + 1, ... in r[0], r[1], ...; every live column
// lies in r[0..W-1]. rb is b_i; inv_own receives 1/d when i pivots.
template <int KP, int W>
__device__ __forceinline__ void steps(float (&r)[KP], float& rb,
                                      float& inv_own,
                                      float4 (*prow)[KP / 4 + 1], int i,
                                      int k, int p0) {
  constexpr int QB = KP / 4;  // the quad that carries (b_p, 1/d_p)
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int p = p0 + u;
    if (p >= k) return;  // uniform: k is the same for every thread
    float4* buf = prow[u & 1];  // p mod 2: p0 is a multiple of kGroup
    float c = r[u];
    if (i == p) {
      float d = r[u];
      if (fabsf(d) < kPivotEps) d = 1.0f;
      inv_own = __frcp_rn(d);
      put_row<KP, W>(buf, r, u);
      buf[QB] = make_float4(rb, inv_own, 0.0f, 0.0f);
      c = 0.0f;
    }
    __syncthreads();
    if (i >= k) continue;  // a padding row: zero, and never read
    const float4 t = buf[QB];
    const float m = c * t.y;
    sub_row<KP, W>(r, buf, m, u);
    rb = fmaf(-m, t.x, rb);
  }
}

// The same steps with C right-hand sides (gj_aug_multi_cta): rb holds
// thread i's C entries of its chunk of B. The owner's entries go to
// quads QB .. QB + C/4 - 1 of the pivot-row buffer and 1/d to the quad
// after them.
template <int KP, int W, int C>
__device__ __forceinline__ void steps(float (&r)[KP], float (&rb)[C],
                                      float& inv_own,
                                      float4 (*prow)[KP / 4 + C / 4 + 1],
                                      int i, int k, int p0) {
  constexpr int QB = KP / 4;      // the first quad of the owner's B entries
  constexpr int QI = QB + C / 4;  // the quad that carries 1/d_p
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int p = p0 + u;
    if (p >= k) return;  // uniform: k is the same for every thread
    float4* buf = prow[u & 1];  // p mod 2: p0 is a multiple of kGroup
    float c = r[u];
    if (i == p) {
      float d = r[u];
      if (fabsf(d) < kPivotEps) d = 1.0f;
      inv_own = __frcp_rn(d);
      put_row<KP, W>(buf, r, u);
#pragma unroll
      for (int q = 0; q < C / 4; ++q)
        buf[QB + q] = make_float4(rb[4 * q], rb[4 * q + 1], rb[4 * q + 2],
                                  rb[4 * q + 3]);
      buf[QI] = make_float4(inv_own, 0.0f, 0.0f, 0.0f);
      c = 0.0f;
    }
    __syncthreads();
    if (i >= k) continue;  // a padding row: zero, and never read
    const float m = c * buf[QI].x;
    sub_row<KP, W>(r, buf, m, u);
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 v = buf[QB + q];
      rb[4 * q] = fmaf(-m, v.x, rb[4 * q]);
      rb[4 * q + 1] = fmaf(-m, v.y, rb[4 * q + 1]);
      rb[4 * q + 2] = fmaf(-m, v.z, rb[4 * q + 2]);
      rb[4 * q + 3] = fmaf(-m, v.w, rb[4 * q + 3]);
    }
  }
}

// The pivot-block inverse of a pair step from the owners' quads
// t0 = (b_p0, p00, p01, .) and t1 = (b_p1, p10, p11, .): rdet = 1/det
// (|det| < 1e-30 -> 1, so an all-zero system solves to exactly 0); every
// thread computes it alike from the same values.
__device__ __forceinline__ float pair_rdet(float4 t0, float4 t1) {
  float det = t0.y * t1.z - t0.z * t1.y;
  if (fabsf(det) < kPivotEps) det = 1.0f;
  return __frcp_rn(det);
}

// Thread i's multipliers [m0 m1] = [c0 c1] P^-1 from its columns p0, p1;
// the owners of rows p0 (i == p) and p1 keep their row of P^-1 in inv and
// take m0 = m1 = 0, which leaves their rows as they are.
__device__ __forceinline__ void pair_multipliers(float c0, float c1,
                                                 float4 t0, float4 t1,
                                                 float rdet, int i, int p,
                                                 float& m0, float& m1,
                                                 float2& inv) {
  m0 = (c0 * t1.z - c1 * t1.y) * rdet;
  m1 = (c1 * t0.y - c0 * t0.z) * rdet;
  if (i == p) {
    inv = make_float2(t1.z * rdet, -t0.z * rdet);
    m0 = m1 = 0.0f;
  } else if (i == p + 1) {
    inv = make_float2(-t1.y * rdet, t0.y * rdet);
    m0 = m1 = 0.0f;
  }
}

// x_i = (row i of its pivot block's inverse) . (b_p0, b_p1): rows p0 (even)
// and p1 = p0 + 1 lie in threads i and i ^ 1 of one warp, and every
// thread of the warp takes part in the shuffle.
__device__ __forceinline__ float pair_x(float rb, float2 inv, int i) {
  const float other = __shfl_xor_sync(0xffffffffu, rb, 1);
  const bool first = (i & 1) == 0;
  return fmaf(inv.y, first ? other : rb, inv.x * (first ? rb : other));
}

// The blocked2 layout's steps p0 .. p0 + kGroup - 1 as two pair steps
// (p, p + 1 for p = p0, p0 + 2; k is even), on thread i's row r as in
// `steps` above. Pair step p/2 takes buffers prow[2t] (row p) and
// prow[2t + 1] (row p + 1), t = (p/2) mod 2 = u/2, each with its owner's
// b and pivot-block entries in quad QB; inv receives thread i's row of
// its pivot block's inverse.
template <int KP, int W>
__device__ __forceinline__ void steps(float (&r)[KP], float& rb, float2& inv,
                                      float4 (*prow)[KP / 4 + 1], int i,
                                      int k, int p0) {
  constexpr int QB = KP / 4;
#pragma unroll
  for (int u = 0; u < kGroup; u += 2) {
    const int p = p0 + u;
    if (p >= k) return;  // uniform: k is the same for every thread
    float4* buf0 = prow[u];  // p0 is a multiple of kGroup
    float4* buf1 = prow[u + 1];
    const float c0 = r[u], c1 = r[u + 1];
    if (i == p || i == p + 1) {
      float4* buf = i == p ? buf0 : buf1;
#pragma unroll
      for (int q = (u + 2) / 4; q < W / 4; ++q)
        buf[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                             r[4 * q + 3]);
      buf[QB] = make_float4(rb, c0, c1, 0.0f);
    }
    __syncthreads();
    if (i >= k) continue;  // a padding row: zero, and never read
    const float4 t0 = buf0[QB], t1 = buf1[QB];
    float m0, m1;
    pair_multipliers(c0, c1, t0, t1, pair_rdet(t0, t1), i, p, m0, m1, inv);
#pragma unroll
    for (int q = (u + 2) / 4; q < W / 4; ++q) {
      const float4 v = buf0[q], w = buf1[q];
      const int j = 4 * q;
      if (j > u + 1) r[j] = fmaf(-m1, w.x, fmaf(-m0, v.x, r[j]));
      if (j + 1 > u + 1) r[j + 1] = fmaf(-m1, w.y, fmaf(-m0, v.y, r[j + 1]));
      if (j + 2 > u + 1) r[j + 2] = fmaf(-m1, w.z, fmaf(-m0, v.z, r[j + 2]));
      if (j + 3 > u + 1) r[j + 3] = fmaf(-m1, w.w, fmaf(-m0, v.w, r[j + 3]));
    }
    rb = fmaf(-m1, t1.x, fmaf(-m0, t0.x, rb));
  }
}

// Phase PH: the groups from g up to the phase's last (or to step k), at
// width W, each followed by the rotation that brings the next group's
// pivot columns to r[0..kGroup-1]; then the next phase. Rb is float (b_i)
// or float[C] (thread i's entries of its chunk of B); Inv is float (1/d of
// the pivot thread i took) for single steps, float2 (its row of its pivot
// block's inverse) for pair steps; Buf is the pivot-row buffers' type.
template <int KP, int PH, typename Rb, typename Inv, typename Buf>
__device__ __forceinline__ void phase(float (&r)[KP], Rb& rb, Inv& inv,
                                      Buf prow, int i, int k, int g) {
  constexpr int W = KP - PH * (KP / kPhases);
  constexpr int g_end = (PH + 1) * (KP / kGroup / kPhases);
#pragma unroll 1
  for (; g < g_end && g * kGroup < k; ++g) {
    steps<KP, W>(r, rb, inv, prow, i, k, g * kGroup);
#pragma unroll
    for (int j = 0; j < W - kGroup; ++j) r[j] = r[j + kGroup];
#pragma unroll
    for (int j = W - kGroup; j < W; ++j) r[j] = 0.0f;
  }
  if constexpr (PH + 1 < kPhases)
    phase<KP, PH + 1>(r, rb, inv, prow, i, k, g);
}

// The aug load: the first KP columns of row i of A into r, zero past kc
// columns or k rows, as the note above says; `as` is A's system moved to
// the first column to load, strides sa1, sa2; `tile` is the warp's
// 32 * kTile floats. (The packed load is a plain loop in each kernel:
// through a helper like this one, gj_packed_cta ran slower than with the
// loop at K = 80, 96 and 128 in every A/B pair on the card, PERF.md.)
template <int KP>
__device__ __forceinline__ void load_row_aug(float (&r)[KP], float* tile,
                                             const float* as, int64_t sa1,
                                             int64_t sa2, int i, int k,
                                             int kc) {
  // lane reads column 32q + lane of the warp's rows row0 .. row0 + 31
  // into r[32q + rr]; the tile then hands thread i its row
  const int lane = i % 32;
  const int row0 = i - lane;
#pragma unroll
  for (int q = 0; q < KP / 32; ++q) {
    const int c = q * 32 + lane;
#pragma unroll
    for (int rr = 0; rr < 32; ++rr) {
      const int row = row0 + rr;
      r[q * 32 + rr] =
          row < k && c < kc ? __ldg(as + row * sa1 + c * sa2) : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < KP / 32; ++q) {
#pragma unroll
    for (int rr = 0; rr < 32; ++rr) tile[rr * kTile + lane] = r[q * 32 + rr];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) r[q * 32 + j] = tile[lane * kTile + j];
    __syncwarp();  // the next chunk overwrites the tile
  }
}

// X's rows from the registers: thread i's first kc entries of rb, times
// inv, to row i at xs + i * ldx (zero past k rows: nothing written). Each
// warp's 32 rows go through its load tile 32 columns at a time, so that
// each row goes out as one coalesced store of 32 columns.
template <int C>
__device__ __forceinline__ void store_rows(float* xs, int64_t ldx,
                                           const float (&rb)[C], float inv,
                                           float* tile, int i, int k,
                                           int kc) {
  const int lane = i % 32;
  const int row0 = i - lane;
#pragma unroll
  for (int q = 0; q < C / 32; ++q) {
#pragma unroll
    for (int j = 0; j < 32; ++j) tile[lane * kTile + j] = rb[q * 32 + j] * inv;
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < 32; ++rr) {
      const int row = row0 + rr;
      const int c = q * 32 + lane;
      if (row < k && c < kc) xs[row * ldx + c] = tile[rr * kTile + lane];
    }
    __syncwarp();  // the next chunk overwrites the tile
  }
}

template <int KP, int kLayout>
__global__ void __launch_bounds__(KP)
gj_cta_kernel(const float* __restrict__ a, int64_t sa0, int64_t sa1,
              int64_t sa2, const float* __restrict__ b, int64_t sb0,
              int64_t sb1, float* __restrict__ x, int k) {
  // the pivot row (pair steps: both pivot rows), double-buffered
  __shared__ float4 prow[kLayout == kPair ? 4 : 2][KP / 4 + 1];
  __shared__ float tile[kLayout == kPacked ? 1 : KP / 32][32 * kTile];

  const int i = threadIdx.x;
  const int64_t sys = blockIdx.x;
  const float* as = a + sys * sa0;
  float r[KP];  // row i of A, zero past K

  if constexpr (kLayout == kPacked) {  // row i of A^T: column i of A
    const bool live = i < k;
    const float* col = as + (live ? i : 0) * sa2;
#pragma unroll
    for (int j = 0; j < KP; ++j)
      r[j] = live && j < k ? __ldg(col + j * sa1) : 0.0f;
  } else {
    load_row_aug<KP>(r, tile[i / 32], as, sa1, sa2, i, k, k);
  }
  float rb = i < k ? b[sys * sb0 + i * sb1] : 0.0f;
  if constexpr (kLayout == kPair) {
    float2 inv = make_float2(0.0f, 0.0f);
    phase<KP, 0>(r, rb, inv, prow, i, k, 0);
    const float xi = pair_x(rb, inv, i);
    if (i < k) x[sys * k + i] = xi;
  } else {
    float inv_own = 1.0f;

    phase<KP, 0>(r, rb, inv_own, prow, i, k, 0);

    if (i < k) x[sys * k + i] = rb * inv_own;
  }
}

// X = A^-1 B for one (system, chunk of B's columns) a block: block
// sys * nq + q takes chunk q of nq near-equal chunks (the first m % nq one
// column wider), KP threads, k <= KP, a chunk of at most C columns.
template <int KP, int C>
__global__ void __launch_bounds__(KP)
gj_multi_cta_kernel(const float* __restrict__ a, int64_t sa0, int64_t sa1,
                    int64_t sa2, const float* __restrict__ b, int64_t sb0,
                    int64_t sb1, int64_t sb2, float* __restrict__ x, int k,
                    int m, int nq) {
  __shared__ float4 prow[2][KP / 4 + C / 4 + 1];  // double-buffered
  __shared__ float tile[KP / 32][32 * kTile];

  const int i = threadIdx.x;
  const int64_t g = blockIdx.x;
  const int64_t sys = g / nq;
  const int q = (int)(g - sys * nq);
  const int base = m / nq, extra = m % nq;
  const int width = base + (q < extra ? 1 : 0);
  const int c0 = q * base + (q < extra ? q : extra);
  float r[KP];   // row i of A, zero past K
  float rb[C];   // row i of the chunk of B, zero past its width
  load_row_aug<KP>(r, tile[i / 32], a + sys * sa0, sa1, sa2, i, k, k);
  load_row_aug<C>(rb, tile[i / 32], b + sys * sb0 + c0 * sb2, sb1, sb2, i,
                  k, width);
  float inv_own = 1.0f;

  phase<KP, 0>(r, rb, inv_own, prow, i, k, 0);

  store_rows<C>(x + sys * k * m + c0, m, rb, inv_own, tile[i / 32], i, k,
                width);
}

// Steps 0 .. l-1 of a split row: columns 0 .. l-1 in shared memory (own
// row at `own`, row p at rows + p * s), columns l .. l+127 in r. A
// padding row (i >= k) only keeps the barriers.
__device__ __forceinline__ void split_steps(
    float (&r)[kSplitCols], float& rb, float& inv_own,
    float4 (*prow)[kSplitCols / 4 + 1], float* rows, int s, int i, int k,
    int l) {
  constexpr int QB = kSplitCols / 4;  // the quad that carries (b_p, 1/d_p)
  const int q_end = (l + 3) / 4;       // quads of the shared part
  float4* own = reinterpret_cast<float4*>(rows + (i < k ? i : 0) * s);
#pragma unroll 1
  for (int p = 0; p < l; ++p) {
    // buffer (p + l) mod 2: step l - 1 takes buffer 1, so the first
    // register step (buffer 0) never shares a buffer with the step before
    float4* buf = prow[(p + l) & 1];
    float c = i < k ? rows[i * s + p] : 0.0f;
    if (i == p) {
      float d = c;
      if (fabsf(d) < kPivotEps) d = 1.0f;
      inv_own = __frcp_rn(d);
#pragma unroll
      for (int q = 0; q < QB; ++q)
        buf[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                             r[4 * q + 3]);
      buf[QB] = make_float4(rb, inv_own, 0.0f, 0.0f);
      c = 0.0f;
    }
    __syncthreads();
    if (i >= k) continue;
    const float4 t = buf[QB];
    const float m = c * t.y;
    if (i != p) {
      const float4* piv = reinterpret_cast<const float4*>(rows + p * s);
      for (int q = (p + 1) / 4; q < q_end; ++q) {
        const float4 v = piv[q];
        float4 w = own[q];
        w.x = fmaf(-m, v.x, w.x);
        w.y = fmaf(-m, v.y, w.y);
        w.z = fmaf(-m, v.z, w.z);
        w.w = fmaf(-m, v.w, w.w);
        own[q] = w;
      }
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const float4 v = buf[q];
      r[4 * q] = fmaf(-m, v.x, r[4 * q]);
      r[4 * q + 1] = fmaf(-m, v.y, r[4 * q + 1]);
      r[4 * q + 2] = fmaf(-m, v.z, r[4 * q + 2]);
      r[4 * q + 3] = fmaf(-m, v.w, r[4 * q + 3]);
    }
    rb = fmaf(-m, t.x, rb);
  }
}

// The blocked2 layout's steps 0 .. l-1 of a split row (l even), as pair
// steps p, p + 1: rows p and p + 1 are read in place from shared memory,
// their owners put only their register parts, b and pivot-block entries
// through the buffers, and skip their shared rows.
__device__ __forceinline__ void split_steps(
    float (&r)[kSplitCols], float& rb, float2& inv,
    float4 (*prow)[kSplitCols / 4 + 1], float* rows, int s, int i, int k,
    int l) {
  constexpr int QB = kSplitCols / 4;
  const int q_end = (l + 3) / 4;
  float4* own = reinterpret_cast<float4*>(rows + (i < k ? i : 0) * s);
#pragma unroll 1
  for (int p = 0; p < l; p += 2) {
    // buffers 2t, 2t + 1 with t = ((p + l) / 2) mod 2: the last shared
    // pair step (p = l - 2) takes t = 1, so the first register pair step
    // (t = 0) never shares buffers with the step before
    const int t = ((p + l) / 2) & 1;
    float4* buf0 = prow[2 * t];
    float4* buf1 = prow[2 * t + 1];
    const float c0 = i < k ? rows[i * s + p] : 0.0f;
    const float c1 = i < k ? rows[i * s + p + 1] : 0.0f;
    if (i == p || i == p + 1) {
      float4* buf = i == p ? buf0 : buf1;
#pragma unroll
      for (int q = 0; q < QB; ++q)
        buf[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                             r[4 * q + 3]);
      buf[QB] = make_float4(rb, c0, c1, 0.0f);
    }
    __syncthreads();
    if (i >= k) continue;
    const float4 t0 = buf0[QB], t1 = buf1[QB];
    float m0, m1;
    pair_multipliers(c0, c1, t0, t1, pair_rdet(t0, t1), i, p, m0, m1, inv);
    if (i != p && i != p + 1) {
      const float4* piv0 = reinterpret_cast<const float4*>(rows + p * s);
      const float4* piv1 = piv0 + s / 4;
      for (int q = (p + 2) / 4; q < q_end; ++q) {
        const float4 v = piv0[q], w = piv1[q];
        float4 o = own[q];
        o.x = fmaf(-m1, w.x, fmaf(-m0, v.x, o.x));
        o.y = fmaf(-m1, w.y, fmaf(-m0, v.y, o.y));
        o.z = fmaf(-m1, w.z, fmaf(-m0, v.z, o.z));
        o.w = fmaf(-m1, w.w, fmaf(-m0, v.w, o.w));
        own[q] = o;
      }
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const float4 v = buf0[q], w = buf1[q];
      r[4 * q] = fmaf(-m1, w.x, fmaf(-m0, v.x, r[4 * q]));
      r[4 * q + 1] = fmaf(-m1, w.y, fmaf(-m0, v.y, r[4 * q + 1]));
      r[4 * q + 2] = fmaf(-m1, w.z, fmaf(-m0, v.z, r[4 * q + 2]));
      r[4 * q + 3] = fmaf(-m1, w.w, fmaf(-m0, v.w, r[4 * q + 3]));
    }
    rb = fmaf(-m1, t1.x, fmaf(-m0, t0.x, rb));
  }
}

// One system a block, 128 < k <= 256, round_up(k, 32) threads; dynamic
// shared memory split_shared_bytes(k).
template <int kLayout>
__global__ void __launch_bounds__(kSplitThreads, 1)
gj_split_kernel(const float* __restrict__ a, int64_t sa0, int64_t sa1,
                int64_t sa2, const float* __restrict__ b, int64_t sb0,
                int64_t sb1, float* __restrict__ x, int k) {
  constexpr int KP = kSplitCols;
  extern __shared__ float4 shared_rows[];  // the shared part, row i at i * s
  // the pivot row (pair steps: both pivot rows), double-buffered
  __shared__ float4 prow[kLayout == kPair ? 4 : 2][KP / 4 + 1];
  __shared__ float tile[kLayout == kPacked ? 1 : kSplitThreads / 32]
                       [32 * kTile];

  const int i = threadIdx.x;
  const int lane = i % 32;
  const int l = k - KP;  // shared columns, 1 .. 128
  const int s = split_stride(l);
  const int l4 = (l + 3) / 4 * 4;  // the shared columns, padded to a quad
  float* rows = reinterpret_cast<float*>(shared_rows);
  const int64_t sys = blockIdx.x;
  const float* as = a + sys * sa0;
  float r[KP];  // row i's columns l .. k-1

  // The shared part first, while r is free to stage it: 32 loads in
  // flight a thread, zero past column l.
  if constexpr (kLayout == kPacked) {  // row i of A^T: column i of A
    const bool live = i < k;
    const float* col = as + (live ? i : 0) * sa2;
    if (live) {
      float4* own = reinterpret_cast<float4*>(rows + i * s);
      for (int c0 = 0; c0 < l4; c0 += 32) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          r[e] = c0 + e < l ? __ldg(col + (c0 + e) * sa1) : 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (c0 + 4 * q < l4)
            own[c0 / 4 + q] = make_float4(r[4 * q], r[4 * q + 1],
                                          r[4 * q + 2], r[4 * q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < KP; ++j)  // then the register part
      r[j] = live ? __ldg(col + (l + j) * sa1) : 0.0f;
  } else {
    // warp w loads rows w, w + warps, ..., eight rows at a time, 32
    // consecutive columns an access
    const int warps = blockDim.x / 32;
    for (int row0 = i / 32; row0 < k; row0 += 8 * warps) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int row = row0 + u * warps;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = q * 32 + lane;
          r[4 * u + q] =
              row < k && c < l ? __ldg(as + row * sa1 + c * sa2) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int row = row0 + u * warps;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (row < k && q * 32 + lane < l4)
            rows[row * s + q * 32 + lane] = r[4 * u + q];
      }
    }
    load_row_aug<KP>(r, tile[i / 32], as + l * sa2, sa1, sa2, i, k, KP);
  }
  float rb = i < k ? b[sys * sb0 + i * sb1] : 0.0f;
  if constexpr (kLayout == kPair) {
    float2 inv = make_float2(0.0f, 0.0f);
    __syncthreads();  // every shared row is loaded

    split_steps(r, rb, inv, prow, rows, s, i, k, l);
    phase<KP, 0>(r, rb, inv, prow, i - l, KP, 0);

    const float xi = pair_x(rb, inv, i);
    if (i < k) x[sys * k + i] = xi;
  } else {
    float inv_own = 1.0f;
    __syncthreads();  // every shared row is loaded

    split_steps(r, rb, inv_own, prow, rows, s, i, k, l);
    phase<KP, 0>(r, rb, inv_own, prow, i - l, KP, 0);

    if (i < k) x[sys * k + i] = rb * inv_own;
  }
}

template <int KP, int kLayout>
int launch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
           const float* b, int64_t sb0, int64_t sb1, float* x, int64_t r,
           int k, cudaStream_t stream) {
  gj_cta_kernel<KP, kLayout><<<(unsigned)r, KP, 0, stream>>>(
      a, sa0, sa1, sa2, b, sb0, sb1, x, k);
  return (int)cudaGetLastError();
}

template <int kLayout>
int dispatch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
             const float* b, int64_t sb0, int64_t sb1, float* x, int64_t r,
             int k, void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k >= 1 && k <= 96)
    return launch<96, kLayout>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  if (k > 96 && k <= 128)
    return launch<128, kLayout>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  return (int)cudaErrorInvalidValue;
}

template <int kLayout>
int launch_split(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                 const float* b, int64_t sb0, int64_t sb1, float* x,
                 int64_t r, int k, void* stream) {
  if (r <= 0) return 0;
  if (k <= kSplitCols || k > kSplitCols + 128)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = split_shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      gj_split_kernel<kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  gj_split_kernel<kLayout><<<(unsigned)r, (k + 31) / 32 * 32, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      a, sa0, sa1, sa2, b, sb0, sb1, x, k);
  return (int)cudaGetLastError();
}

// The widest chunk of B's columns a block of KP threads takes (Cmax in
// the note above): wider chunks spill.
constexpr int multi_cols(int kp) { return kp == 64 ? 64 : 32; }

// The chunk's C: the least multiple of 32 that holds `widest` columns.
template <int KP, int C>
int launch_chunks(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                  const float* b, int64_t sb0, int64_t sb1, int64_t sb2,
                  float* x, int64_t r, int k, int m, int nq, int widest,
                  cudaStream_t stream) {
  if constexpr (C < multi_cols(KP)) {
    if (widest > C)
      return launch_chunks<KP, C + 32>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x,
                                       r, k, m, nq, widest, stream);
  }
  gj_multi_cta_kernel<KP, C><<<(unsigned)(r * nq), KP, 0, stream>>>(
      a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, k, m, nq);
  return (int)cudaGetLastError();
}

template <int KP>
int launch_multi(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                 const float* b, int64_t sb0, int64_t sb1, int64_t sb2,
                 float* x, int64_t r, int k, int m, cudaStream_t stream) {
  const int nq = (m + multi_cols(KP) - 1) / multi_cols(KP);
  const int widest = (m + nq - 1) / nq;
  if (r * nq > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch_chunks<KP, 32>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k,
                               m, nq, widest, stream);
}

}  // namespace

extern "C" {

// x [r, k] = A^-1 b for A [r, k, k] (strides sa*) and b [r, k] (strides
// sb0, sb1), 1 <= k <= 128 (the routing sends it 64 < k); x contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a k out of
// range.
int gj_aug_cta(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
               const float* b, int64_t sb0, int64_t sb1, float* x,
               int64_t r, int k, void* stream) {
  return dispatch<kAug>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// x [r, k] = A^-T b (the packed layout's elimination; A^-1 b for a
// symmetric A), arguments as for gj_aug_cta.
int gj_packed_cta(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                  const float* b, int64_t sb0, int64_t sb1, float* x,
                  int64_t r, int k, void* stream) {
  return dispatch<kPacked>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// x [r, k] = A^-1 b, arguments as for gj_aug_cta, 128 < k <= 256: the row
// split between shared memory and registers.
int gj_aug_split(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                 const float* b, int64_t sb0, int64_t sb1, float* x,
                 int64_t r, int k, void* stream) {
  return launch_split<kAug>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k,
                             stream);
}

// x [r, k] = A^-T b, arguments as for gj_aug_split.
int gj_packed_split(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                    const float* b, int64_t sb0, int64_t sb1, float* x,
                    int64_t r, int k, void* stream) {
  return launch_split<kPacked>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// x [r, k] = A^-1 b by row elimination two pivots a step (the blocked2
// layout; any A whose pivot blocks are invertible), arguments as for
// gj_aug_cta, k even.
int gj_blocked2_cta(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                    const float* b, int64_t sb0, int64_t sb1, float* x,
                    int64_t r, int k, void* stream) {
  if (k % 2) return (int)cudaErrorInvalidValue;
  return dispatch<kPair>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// The blocked2 layout as gj_blocked2_cta, 128 < k <= 256: the row split
// between shared memory and registers.
int gj_blocked2_split(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                      const float* b, int64_t sb0, int64_t sb1, float* x,
                      int64_t r, int k, void* stream) {
  if (k % 2) return (int)cudaErrorInvalidValue;
  return launch_split<kPair>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// X [r, k, m] = A^-1 B for A [r, k, k] (strides sa*) and B [r, k, m]
// (strides sb*), 1 <= k <= 128 (the routing sends it 32 < k with m > 1),
// m >= 1; X contiguous. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a k or m out of range.
int gj_aug_multi_cta(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                     const float* b, int64_t sb0, int64_t sb1, int64_t sb2,
                     float* x, int64_t r, int k, int m, void* stream) {
  if (k < 1 || k > 128 || m < 1) return (int)cudaErrorInvalidValue;
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 64)
    return launch_multi<64>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, s);
  if (k <= 96)
    return launch_multi<96>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, s);
  return launch_multi<128>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, s);
}

// The split kernels' dynamic shared bytes a block at rank k, and in
// *blocks the blocks an SM holds at once on the current device, for
// layout 0 (gj_aug_split), 1 (gj_packed_split) or 2 (gj_blocked2_split).
// Returns a CUDA error code.
int gj_split_occupancy(int layout, int k, int* shared_bytes, int* blocks) {
  if (k <= kSplitCols || k > kSplitCols + 128 || layout < kAug ||
      layout > kPair)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = split_shared_bytes(k);
  const void* fn = layout == kPacked ? (const void*)gj_split_kernel<kPacked>
                   : layout == kPair ? (const void*)gj_split_kernel<kPair>
                                     : (const void*)gj_split_kernel<kAug>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn, (k + 31) / 32 * 32, bytes);
  *shared_bytes = (int)bytes;
  return (int)err;
}

}  // extern "C"
