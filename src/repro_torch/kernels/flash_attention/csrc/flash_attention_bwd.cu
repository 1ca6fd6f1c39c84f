// Hand-written CUDA kernels for the backward pass of flash attention (sm_90a).
//
// The TPU package has no backward kernel: its models differentiate the plain
// attention (_sdpa, src/repro/models/layers.py:156; attention_ref,
// src/repro/kernels/flash_attention/ref.py:8). This file is the backward of
// the forward kernel in flash_attention.cu, held to ref.py's
// attention_bwd_ref. With the forward's semantics (scale = Dh^-1/2, the
// optional tanh softcap, the causal mask i + (Sk - Sq) >= j and the sliding
// window i + (Sk - Sq) - j < window) and each row's log-sum-exp L_i of its
// (soft-capped) scores, which the forward wrote:
//
//   x_ij  = scale * q_i . k_j;   t_ij = tanh(x_ij / softcap), s_ij = softcap * t_ij
//                                (s_ij = x_ij without a softcap)
//   P_ij  = exp(s_ij - L_i) where i sees j, else 0
//   D_i   = sum_d dO_id O_id                                    (pass 1)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i) (1 - t_ij^2) * scale             ((1 - t^2) with a softcap only)
//   dV_j  = sum_i P_ij dO_i,  dK_j = sum_i dS_ij q_i,  dQ_i = sum_j dS_ij k_j
//
// Pass 2 runs a block per (tile of BK keys, KV row f = batch * hkv + KV
// head). The block keeps its K and V tile in shared memory, then walks the
// query tiles of every query head of f's group (grouped-query attention:
// query row bh = f * group + j, as the forward packs them) that see some key
// of the tile: only the rows between the causal diagonal and the window's
// far edge. dV and dK stay in registers over all those tiles and are written
// once, with no atomics, in the inputs' dtype. dQ of each tile (dS K) is
// added to a float32 scratch; pass 3 converts it to the inputs' dtype and
// layout.
//
// Bound: 10 * Dh flop a visible (query, key) pair (five products of 2 * Dh),
// at the tensor cores' 989 TFLOP/s in bf16; in float32 three TF32 products
// for each (3xTF32, below) at 494.7 TFLOP/s, or 10 * Dh FMA flop at the CUDA
// cores' 67 TFLOP/s; the bytes (each operand read once, each gradient written
// once) take less time at the models' shapes (a seventh of it at granite's).
// Two forms of pass 2:
//
// * bf16 -> flash_bwd_tma_kernel, the design FlashAttention-3 uses for its
//   backward, to feed the tensor cores as Hopper wants. Three warpgroups.
//   In warpgroup 2 (24 registers after setmaxnreg) one thread, the
//   producer, loads the block's K and V once by TMA, then keeps a ring of
//   two query steps in flight: the step's Q and dO tiles (64 rows; TMA over
//   the strided 4-D views, 128-byte swizzled as the wgmma descriptors
//   expect, zero-filled past Sq) and its rows' L * log2 e and D (bulk copies
//   from pass 1's padded planes; L is +inf past Sq, so those rows' P is 0
//   with no mask), on full/empty mbarriers, so the loads run under the
//   products. Warpgroups 0 and 1 (the consumers, 240 registers) each own 64
//   of the block's BK = 128 keys and compute, on wgmma with float32 sums:
//     S^T = K Q^T, then dP^T = V dO^T   (m64n64k16 from shared memory, two
//                                        groups: P^T is formed while dP^T
//                                        runs);
//     P^T = exp2(S^T c - L log2 e)      (c folds the scale and log2 e: one
//                                        multiply-add and one ex2 a score;
//                                        the mask only on tiles that the
//                                        causal diagonal, the window's edge or
//                                        the Sk edge cut);
//     dV += P^T dO                      (P^T rounded to bf16 in registers as
//                                        the A operand: the accumulator
//                                        layout of S^T is the A fragment
//                                        layout; dO read MN-major through the
//                                        transpose bit), issued before dP^T
//                                        has landed;
//     dS^T = P^T (dP^T - D) scale (1 - t^2), dK += dS^T Q  (likewise);
//     dQ = dS K                         (dS^T stored once to shared memory as
//                                        bf16, swizzled, double-buffered, read
//                                        MN-major as A, K MN-major as B; the
//                                        two consumers split dQ's columns
//                                        after a named barrier).
//   S and dP never touch shared memory; P and dS are rounded to bf16 at the
//   same places as in FlashAttention-2, for the three products that take
//   them. dQ leaves through the step's Q and dO tiles, which no product
//   reads any more: each consumer stages its 64 x Dh/2 there (float32, 128-
//   byte swizzled boxes of 32 columns) and another thread of warpgroup 2,
//   the reducer, adds them to the float32 scratch by TMA reduce-adds
//   (cp.reduce.async.bulk.tensor, in L2) and frees the stage once they are
//   read. Float4 atomics from the consumers' registers instead took 0.75 of
//   2.37 ms at granite's shape, the reduce-adds issued by a consumer 0.41 of
//   2.03, by the reducer 0.17 of 1.72 (H100 80GB HBM3, 700 W; PERF.md).
//   The softcap's tanh is one ex2 and a division (tanhf took a fifth of
//   gemma2's time). Dh 256 (gemma2): BK = 64 and both consumers compute
//   S^T and dP^T of the same 64 keys and split dK's, dV's and dQ's columns
//   (64 x 256 of dK and dV would be 256 registers a thread); 209 KB of
//   shared memory. Dh 96 runs as 128 (TMA fills the columns past Dh with
//   zeros), Dh 64 at BK = 128 with dQ in 32-column halves. Blocks go first
//   key tiles first across all KV rows: under a causal mask those see the
//   most query rows.
// * float32 -> flash_bwd_f32_kernel: the five products on the tensor cores
//   in split TF32 (3xTF32), mma.sync m16n8k8 with float32 sums. Each float32
//   operand x is split into big = tf32(x) and small = tf32(x - big), both
//   rounded to nearest with ties away from zero as cvt.rna.tf32.f32 rounds
//   (an add and a mask), when its fragment is loaded; a product is
//   a_small b_big + a_big b_small + a_big b_big (a_small b_small, 2^-22 of
//   it, left out): about 1.5e-6 of the plain float32 gradients at phase 17's
//   shape, where one TF32 product reads 4e-4 to 9e-4 (ref.py:
//   attention_bwd_tf32x3_ref). mma.sync and not wgmma: wgmma takes tf32
//   only K-major from shared memory, and dV = P^T dO, dK = dS^T Q, dQ = dS K
//   would each need a transposed copy of dO, Q or K; mma.sync's fragments
//   come from registers, loaded in whatever order a product needs. A block
//   of eight warps takes BK = 64 keys (Dh 256: 32) of one KV row and walks
//   query steps of BQ = 64 rows (Dh 256: 32). Warp (key group, query half,
//   column half) computes S^T = K Q^T and dP^T = V dO^T for its 16 keys by
//   BQ / 2 rows, P^T and dS^T in those registers, then dV += P^T dO and dK
//   += dS^T Q with P^T, dS^T as A fragments straight from the accumulators
//   (k positions t, t+4 read as query rows 2t, 2t+1: the B rows of dO and Q
//   are loaded to match), over its columns of dK, dV (Dh 256: half of them,
//   both halves computing the same S^T, dP^T). K and V stay in shared memory
//   (row stride Dh + 4 floats: every fragment load is conflict-free); the
//   next step's Q and dO tiles (and its rows' L, D) arrive by cp.async into
//   the other of two stages while this step computes. dS^T goes to shared
//   memory once; all eight warps then compute dQ = dS K (16 rows by Dh / 2
//   or Dh / 4 columns each), stage it over the step's spent Q tile (128-byte
//   swizzled boxes of 32 columns) and one thread adds it to the float32
//   scratch by TMA reduce-adds, as the bf16 form does. The two query halves'
//   dK, dV are summed in shared memory at the end and written once, with no
//   atomics. P = exp(x - L) and the softcap's tanh are the accurate expf and
//   tanhf. The tensor cores truncate as they accumulate, so every sum is
//   taken in short partials added by float32 adds (add_partial). Under a
//   softcap S^T alone is taken by float32 FMAs in Dh order, as the plain
//   version's float32 product rounds it (scores_fma). Operand rows must be
//   16-byte aligned (ops.py hands over aligned copies, zero-padded to a Dh
//   that is a multiple of 4).
//
// Times against the bound and against SDPA's backward are in PERF.md
// (chip_smoke.py phase 17, H100 80GB HBM3 at 700 W).
//
// Operands are read and written through strides: element (b, h, s, d) at
// ptr + b*sb + h*sh + s*ss + d (d dense), for q, k, v, o, dO, dq, dk, dv.
// The wrapper (ops.py, attention_bwd) hands over only the keys some row sees
// (visible_keys), as the forward does, and zeroes dk and dv before them.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Operand {  // element (b, h, s, d) at ptr + b*sb + h*sh + s*ss + d
  void* ptr;
  int64_t sb, sh, ss;
};

struct Params {
  Operand q, k, v, o, dout, dq, dk, dv;
  const float* lse;  // [bhq, sq]: the forward's log-sum-exp of each row
  float* delta;      // pass 1's output: two planes [bhq, sq_pad], L (bf16: L * log2 e; +inf
                     // past sq) then D = rowsum(dO * O) (0 past sq)
  float* dq_acc;     // [bhq, sq, DH] float32: dQ, summed over the key tiles
  int bhq;           // query rows: batch * hq
  int hq, hkv;       // heads per batch entry of q (and o, dO, dq) and of k (and v, dk, dv)
  int group;         // query heads per KV head
  int sq, sk, dh;
  int sq_pad;        // sq rounded up to 64, a multiple of every query step (TmaCfg::BQ, F32Cfg::BQ)
  float scale;
  float softcap;     // <= 0: none
  int causal;
  int window;        // row i sees keys j > i + sk - sq - window; >= sk + sq: no window
};

__device__ __forceinline__ int64_t row_base(const Operand& op, int row, int heads) {
  const int b = row / heads, h = row - b * heads;
  return static_cast<int64_t>(b) * op.sb + static_cast<int64_t>(h) * op.sh;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Pass 1, a warp a row: rows [0, sq_pad) of each bh into two planes, L (bf16:
// L * log2 e) and D = sum_d dO * O, +inf and 0 past sq: what pass 2's steps
// read whole (bulk copies in bf16, cp.async in float32).
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(Params p) {
  const int rows = p.sq_pad;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(p.bhq) * rows) return;
  const int bh = static_cast<int>(row / rows), i = static_cast<int>(row - static_cast<int64_t>(bh) * rows);
  float acc = 0.f;
  if (i < p.sq) {
    const T* o = static_cast<const T*>(p.o.ptr) + row_base(p.o, bh, p.hq) + i * p.o.ss;
    const T* g = static_cast<const T*>(p.dout.ptr) + row_base(p.dout, bh, p.hq) + i * p.dout.ss;
    for (int d = lane; d < p.dh; d += 32) acc = fmaf(load(o + d), load(g + d), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  const float lse = i < p.sq ? p.lse[static_cast<int64_t>(bh) * p.sq + i] : INFINITY;
  p.delta[row] = std::is_same<T, float>::value ? lse : lse * kLog2e;
  p.delta[static_cast<int64_t>(p.bhq) * p.sq_pad + row] = acc;
}

// ---------------------------------------------------------------------------
// float32: split TF32 (3xTF32) on mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x), "f"(y) : "memory");
}

constexpr size_t up1k(size_t bytes) { return (bytes + 1023) / 1024 * 1024; }

template <int DH>  // head width padded to 64, 128 or 256
struct F32Cfg {
  // Warps: KG key groups of 16 keys x QS query splits x CS column splits of
  // dK and dV (Dh 256: 16 keys x 256 columns of each would be 256 registers).
  static constexpr int KG = DH == 256 ? 2 : 4;
  static constexpr int QS = 2;
  static constexpr int CS = DH == 256 ? 2 : 1;
  static constexpr int BK = 16 * KG;                  // keys a block
  static constexpr int BQ = DH == 256 ? 32 : 64;      // query rows a step
  static constexpr int WQ = BQ / QS;                  // query rows of a warp's S^T, dP^T
  static constexpr int NT = WQ / 8;                   // ... as n8 tiles
  static constexpr int WC = DH / CS;                  // dK, dV columns a warp
  static constexpr int MT = BQ / 16;                  // dQ: m16 tiles of a step
  static constexpr int QC = DH * MT / 8;              // dQ columns a warp (8 / MT warps a tile)
  static constexpr int LD = DH + 4;  // row stride (floats) of K, V, Q, dO: each fragment load conflict-free
  static constexpr int LS = BQ + 4;  // row stride of dS^T
  static constexpr int kThreads = 256;
  static constexpr size_t KV_BYTES = up1k(static_cast<size_t>(BK) * LD * 4);
  static constexpr size_t TILE_BYTES = up1k(static_cast<size_t>(BQ) * LD * 4);  // a Q or dO tile
  static constexpr size_t DS_BYTES = up1k(static_cast<size_t>(BK) * LS * 4);
  static constexpr size_t PLANE_BYTES = 2 * 2 * BQ * 4;  // L and D of each of two steps
  // + 1024: the stages start on the 1024-byte period of dQ's 128-byte swizzle.
  static constexpr size_t kSmem = 2 * KV_BYTES + 4 * TILE_BYTES + DS_BYTES + PLANE_BYTES + 1024;
  static_assert(KG * QS * CS * 32 == kThreads && (8 / MT) * MT == 8, "eight warps");
  static_assert(kSmem <= 232448, "fits an SM");
  static_assert(TILE_BYTES >= static_cast<size_t>(BQ) * DH * 4, "dQ is staged in a spent Q tile");
};

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from zero:
// the bits cvt.rna.tf32.f32 gives, by an add and a mask.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both tf32: big = rna(x), small = rna(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c (16 x 8, float32) += a (16 x 8) b (8 x 8), all tf32: one mma.sync.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// An A fragment (rows g, g+8; k positions t, t+4) split into big and small.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};

// c += a_small b_big + a_big b_small: the split's two small terms.
__device__ __forceinline__ void mma_small(float (&c)[4], const FragA& a, uint32_t bh0,
                                          uint32_t bl0, uint32_t bh1, uint32_t bl1) {
  mma_tf32(c, a.lo[0], a.lo[1], a.lo[2], a.lo[3], bh0, bh1);
  mma_tf32(c, a.hi[0], a.hi[1], a.hi[2], a.hi[3], bl0, bl1);
}

// c += a b in split TF32: a_small b_big + a_big b_small + a_big b_big, the
// small terms first, float32 sums (a_small b_small, 2^-22 of the product, is
// left out).
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float x0, float x1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(x0, bh0, bl0);
  split_tf32(x1, bh1, bl1);
  mma_small(c, a, bh0, bl0, bh1, bl1);
  mma_tf32(c, a.hi[0], a.hi[1], a.hi[2], a.hi[3], bh0, bh1);
}

__device__ __forceinline__ float4 ld4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One tile of ``rows`` rows of a strided float32 operand into shared memory
// (row stride LD floats) by 16-byte cp.async, zero-filled past ``valid``
// rows and past dh. The caller commits the group.
template <int DH, int LD>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src, int64_t ss,
                                              int rows, int valid, int dh) {
  constexpr int kChunks = DH / 4;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < valid && 4 * c < dh;
    cp_async16(dst + (r * LD + 4 * c) * 4, ok ? src + r * ss + 4 * c : src, ok);
  }
}

// The tensor cores add each product into the float32 accumulator with
// truncation, not rounding to nearest: a sum carried through thousands of
// mma.sync (dK, dV over every query row of a KV head) drifts (3e-5 of the
// plain gradients at phase 17's float32 shape). So every sum is taken in
// partials of at most 12 mma.sync, each started from zero and added to its
// float32 total by an ordinary (rounded) add; S^T's big products in
// partials of one (with 32-column partials gemma2's float32 shape, q x 20
// and a softcap, read 1.3e-5).
template <int N>
__device__ __forceinline__ void add_partial(float (&acc)[N][4], const float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += c[j][e];
}

// S^T (or dP^T) of a warp: 16 keys (A: rows ``a`` and a + 8 LD of K or V) by
// the warp's WQ query rows (B: rows ``b`` + 8 j LD of Q or dO), over Dh in
// partials of 32 columns. FINE (S^T, whose error exp amplifies): each 8
// columns' a_big b_big is its own partial, the small terms the 32 columns'.
template <int DH, int LD, int NT, bool FINE>
__device__ __forceinline__ void scores_t(float (&s)[NT][4], const float* a, const float* b, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < DH; d0 += 32) {
    float c[NT][4] = {};
#pragma unroll
    for (int d = d0; d < d0 + 32; d += 8) {
      FragA fa;
      fa.set(a[d + t], a[8 * LD + d + t], a[d + t + 4], a[8 * LD + d + t + 4]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* bj = b + j * 8 * LD + d + t;
        if (FINE) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bj[0], bh0, bl0);
          split_tf32(bj[4], bh1, bl1);
          mma_small(c[j], fa, bh0, bl0, bh1, bl1);
          float hh[4] = {};
          mma_tf32(hh, fa.hi[0], fa.hi[1], fa.hi[2], fa.hi[3], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += hh[e];
        } else {
          mma3(c[j], fa, bj[0], bj[4]);
        }
      }
    }
    add_partial(s, c);
  }
}

// S^T of a warp by float32 FMAs over Dh in ascending order, each score one
// chain from zero, as the plain version's float32 product takes it. The
// softcap form uses it: there the scores reach the cap, where P = exp(s - L)
// carries a score's error into P whole. With 3xTF32 scores (the tensor cores
// truncate as they add) the gradients at Dh 256, q x 20, softcap 50 read up
// to 1.4e-5 from the plain version's (tolerance 1e-5), farther from float64
// gradients than the plain version's; with these, 1.5e-6 to 3.3e-6 (H100
// 80GB HBM3, PERF.md; tests/test_torch_gpu.py holds both to float64).
// krow: key g's row of K (key g + 8's 8 LD on); qrow: the warp's first query
// row of Q.
template <int DH, int LD, int NT>
__device__ __forceinline__ void scores_fma(float (&s)[NT][4], const float* krow,
                                           const float* qrow, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    const float4 k0 = ld4f(krow + d), k1 = ld4f(krow + 8 * LD + d);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 q0 = ld4f(qrow + (8 * j + 2 * t) * LD + d);
      const float4 q1 = ld4f(qrow + (8 * j + 2 * t + 1) * LD + d);
      s[j][0] = fmaf(k0.w, q0.w, fmaf(k0.z, q0.z, fmaf(k0.y, q0.y, fmaf(k0.x, q0.x, s[j][0]))));
      s[j][1] = fmaf(k0.w, q1.w, fmaf(k0.z, q1.z, fmaf(k0.y, q1.y, fmaf(k0.x, q1.x, s[j][1]))));
      s[j][2] = fmaf(k1.w, q0.w, fmaf(k1.z, q0.z, fmaf(k1.y, q0.y, fmaf(k1.x, q0.x, s[j][2]))));
      s[j][3] = fmaf(k1.w, q1.w, fmaf(k1.z, q1.z, fmaf(k1.y, q1.y, fmaf(k1.x, q1.x, s[j][3]))));
    }
  }
}

// acc (16 keys x WC columns) += X^T Y over the warp's WQ query rows: X^T's
// fragments are the accumulator tiles of S^T (P^T or dS^T), tile j being k
// step j with k positions t, t+4 read as query rows 8 j + 2 t, 8 j + 2 t + 1;
// Y's rows ``y`` + (8 j + 2 t) LD (dO or Q), columns from ``col``. Each
// 16 x 8 tile of the step is one partial (3 NT mma.sync).
template <int LD, int NT, int WC>
__device__ __forceinline__ void grad_kv(float (&acc)[WC / 8][4], const float (&x)[NT][4],
                                        const float* y, int t, int g) {
  FragA fa[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) fa[j].set(x[j][0], x[j][2], x[j][1], x[j][3]);
  const float* y0 = y + 2 * t * LD + g;
#pragma unroll
  for (int n = 0; n < WC / 8; ++n) {  // whole: acc must stay in registers
    float c[4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) mma3(c, fa[j], y0[8 * j * LD + 8 * n], y0[(8 * j + 1) * LD + 8 * n]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// Pass 2, float32: one block per (key tile, KV row f), the first key tiles
// (the most query rows under a causal mask) of every KV row first.
template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(F32Cfg<DH>::kThreads, 1)
flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap tdq, Params p) {
  using C = F32Cfg<DH>;
  constexpr int LD = C::LD, LS = C::LS, NT = C::NT, WC = C::WC, QN = C::QC / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* ks = reinterpret_cast<float*>(base);                      // K [BK][LD]
  float* vs = reinterpret_cast<float*>(base + C::KV_BYTES);        // V [BK][LD]
  unsigned char* stages = base + 2 * C::KV_BYTES;                  // step s: Q, dO at s * 2 TILE
  float* dst = reinterpret_cast<float*>(stages + 4 * C::TILE_BYTES);  // dS^T [BK][LS]
  float* planes = reinterpret_cast<float*>(stages + 4 * C::TILE_BYTES + C::DS_BYTES);  // [2][2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % C::KG, qh = (warp / C::KG) % C::QS, ch = warp / (C::KG * C::QS);
  const int kw = 16 * kg, qw = qh * C::WQ, cw = ch * WC;  // the warp's keys, rows, dK/dV columns
  const int mt = warp % C::MT, qc = (warp / C::MT) * C::QC;  // its dQ rows (16 mt) and columns

  const int nf = p.bhq / p.group;
  const int kt = blockIdx.x / nf, f = blockIdx.x - kt * nf;
  const int k0 = kt * C::BK, offset = p.sk - p.sq;
  // Query rows that see some key of the tile: from the causal diagonal of its
  // first key (rounded down to a step) to the window's far edge of its last.
  const int q_lo = p.causal ? max(0, k0 - offset) / C::BQ * C::BQ : 0;
  const int q_hi = static_cast<int>(min(static_cast<int64_t>(p.sq),
                                        static_cast<int64_t>(k0) + C::BK - 1 - offset + p.window));
  const int per_head = q_hi > q_lo ? (q_hi - q_lo + C::BQ - 1) / C::BQ : 0;
  const int n_steps = per_head * p.group;
  const int64_t plane = static_cast<int64_t>(p.bhq) * p.sq_pad;  // L, then D

  const auto load_step = [&](int n) {  // step n's Q, dO, L and D into stage n & 1
    const int j = n / per_head, q0 = q_lo + (n - j * per_head) * C::BQ;
    const int bh = f * p.group + j;
    const uint32_t q_t = smem_u32(stages + (n & 1) * 2 * C::TILE_BYTES);
    load_rows_f32<DH, LD>(q_t, static_cast<const float*>(p.q.ptr) + row_base(p.q, bh, p.hq) +
                                   q0 * p.q.ss, p.q.ss, C::BQ, p.sq - q0, p.dh);
    load_rows_f32<DH, LD>(q_t + C::TILE_BYTES, static_cast<const float*>(p.dout.ptr) +
                                                   row_base(p.dout, bh, p.hq) + q0 * p.dout.ss,
                          p.dout.ss, C::BQ, p.sq - q0, p.dh);
    if (tid < C::BQ / 2) {  // BQ / 4 chunks of L, then of D
      const int pl = tid / (C::BQ / 4), c = tid - pl * (C::BQ / 4);
      cp_async16(smem_u32(planes + ((n & 1) * 2 + pl) * C::BQ + 4 * c),
                 p.delta + pl * plane + static_cast<int64_t>(bh) * p.sq_pad + q0 + 4 * c, true);
    }
  };

  const float* kg_ptr = static_cast<const float*>(p.k.ptr) + row_base(p.k, f, p.hkv);
  const float* vg_ptr = static_cast<const float*>(p.v.ptr) + row_base(p.v, f, p.hkv);
  if (n_steps > 0) {
    load_rows_f32<DH, LD>(smem_u32(ks), kg_ptr + k0 * p.k.ss, p.k.ss, C::BK, p.sk - k0, p.dh);
    load_rows_f32<DH, LD>(smem_u32(vs), vg_ptr + k0 * p.v.ss, p.v.ss, C::BK, p.sk - k0, p.dh);
    load_step(0);
  }
  cp_async_commit();

  float dk[WC / 8][4], dv[WC / 8][4];
#pragma unroll
  for (int n = 0; n < WC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int ka = k0 + kw;  // the warp's first key
  for (int n = 0; n < n_steps; ++n) {
    const int j = n / per_head, q0 = q_lo + (n - j * per_head) * C::BQ;
    const int st = n & 1;
    const float* qs = reinterpret_cast<const float*>(stages + st * 2 * C::TILE_BYTES);
    const float* gs = reinterpret_cast<const float*>(stages + st * 2 * C::TILE_BYTES + C::TILE_BYTES);
    const float* lp = planes + st * 2 * C::BQ;  // L, then D, of the step's rows
    cp_async_wait<0>();                          // this step's tiles (and K, V) have landed
    if (tid == 0) bulk_wait_read<0>();           // the last step's dQ has left the other stage
    __syncthreads();
    if (n + 1 < n_steps) load_step(n + 1);       // the next step's tiles, under this one's products
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by its WQ rows.
    float s[NT][4], dp[NT][4];
    if (SOFTCAP) {
      scores_fma<DH, LD, NT>(s, ks + (kw + g) * LD, qs + qw * LD, t);
    } else {
      scores_t<DH, LD, NT, true>(s, ks + (kw + g) * LD, qs + (qw + g) * LD, t);
    }
    scores_t<DH, LD, NT, false>(dp, vs + (kw + g) * LD, gs + (qw + g) * LD, t);

    // P^T = exp(x - L), dS^T = P^T (dP^T - D) (1 - t^2) scale, in place of
    // S^T and dP^T; the mask only where the warp's tile is cut.
    const int qa = q0 + qw;
    const bool whole = ka + 16 <= p.sk && (!p.causal || qa + offset >= ka + 15) &&
                       qa + C::WQ - 1 + offset - ka < p.window;
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + 8 * jj + 2 * t + (e & 1), key = ka + g + 8 * (e >> 1);
        float x = s[jj][e] * p.scale, cap = 0.f;
        if (SOFTCAP) {
          cap = tanhf(x / p.softcap);
          x = p.softcap * cap;
        }
        float pr = expf(x - lp[r]);  // 0 past Sq: L is +inf there
        if (!whole) {
          const int ahead = q0 + r + offset - key;
          if (key >= p.sk || (p.causal && ahead < 0) || ahead >= p.window) pr = 0.f;
        }
        float ds = pr * (dp[jj][e] - lp[C::BQ + r]);
        if (SOFTCAP) ds *= 1.f - cap * cap;
        s[jj][e] = pr;
        dp[jj][e] = ds * p.scale;
      }

    // dV += P^T dO, dK += dS^T Q over the warp's rows; dS^T to shared memory.
    grad_kv<LD, NT, WC>(dv, s, gs + qw * LD + cw, t, g);
    grad_kv<LD, NT, WC>(dk, dp, qs + qw * LD + cw, t, g);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      float* at = dst + (kw + g) * LS + qw + 8 * jj + 2 * t;
      *reinterpret_cast<float2*>(at) = make_float2(dp[jj][0], dp[jj][1]);
      *reinterpret_cast<float2*>(at + 8 * LS) = make_float2(dp[jj][2], dp[jj][3]);
    }
    __syncthreads();  // dS^T whole; no product reads the step's Q or dO any more

    // dQ = dS K: the warp's 16 rows (16 mt) by QC columns (from qc), over the
    // block's keys; k positions t, t+4 read as keys 2 t, 2 t + 1 of each 8.
    float dq[QN][4];
#pragma unroll
    for (int nn = 0; nn < QN; ++nn) dq[nn][0] = dq[nn][1] = dq[nn][2] = dq[nn][3] = 0.f;
#pragma unroll 1
    for (int k0p = 0; k0p < C::BK; k0p += 32) {  // partials of 32 keys
      float c[QN][4] = {};
#pragma unroll
      for (int kk = k0p; kk < k0p + 32; kk += 8) {
        const float* a = dst + (kk + 2 * t) * LS + 16 * mt + g;
        FragA fa;
        fa.set(a[0], a[8], a[LS], a[LS + 8]);
        const float* b = ks + (kk + 2 * t) * LD + qc + g;
#pragma unroll
        for (int nn = 0; nn < QN; ++nn) mma3(c[nn], fa, b[8 * nn], b[LD + 8 * nn]);
      }
      add_partial(dq, c);
    }
    // dQ staged over the step's Q tile in boxes of 32 columns by BQ rows,
    // 128-byte swizzled, and added to the float32 scratch by TMA reduce-adds.
    const uint32_t stage = smem_u32(qs);
#pragma unroll
    for (int nn = 0; nn < QN; ++nn) {
      const int col = qc + 8 * nn;
      const uint32_t at = stage + (col >> 5) * (C::BQ * 128) + (16 * mt + g) * 128 +
                          ((((col & 31) >> 2) + (t >> 1)) ^ g) * 16 + 8 * (t & 1);
      st_shared_f2(at, dq[nn][0], dq[nn][1]);
      st_shared_f2(at + 8 * 128, dq[nn][2], dq[nn][3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      for (int b = 0; b < DH / 32; ++b)
        tma_reduce_add(&tdq, stage + b * (C::BQ * 128), 32 * b, q0, f * p.group + j);
      bulk_commit();
    }
  }

  // The QS warps of a key group hold dK, dV over their own rows: those of
  // query split 1 leave theirs in the stage no step used last, split 0's add
  // them and write.
  float* xs = reinterpret_cast<float*>(stages + (n_steps & 1) * 2 * C::TILE_BYTES);
  float* mine = xs + (kg + C::KG * ch) * (2 * 16 * WC);
  if (qh == 1) {
#pragma unroll
    for (int n = 0; n < WC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32 + lane] = dk[n][e];
        mine[16 * WC + (n * 4 + e) * 32 + lane] = dv[n][e];
      }
  }
  __syncthreads();
  if (qh == 0) {
    float* dkg = static_cast<float*>(p.dk.ptr) + row_base(p.dk, f, p.hkv);
    float* dvg = static_cast<float*>(p.dv.ptr) + row_base(p.dv, f, p.hkv);
#pragma unroll
    for (int n = 0; n < WC / 8; ++n) {
      float a[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = dk[n][e] + mine[(n * 4 + e) * 32 + lane];
        b[e] = dv[n][e] + mine[16 * WC + (n * 4 + e) * 32 + lane];
      }
      const int col = cw + 8 * n + 2 * t;
      if (col >= p.dh) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = ka + g + 8 * r;
        if (key >= p.sk) continue;
        *reinterpret_cast<float2*>(dkg + static_cast<int64_t>(key) * p.dk.ss + col) =
            make_float2(a[2 * r], a[2 * r + 1]);
        *reinterpret_cast<float2*>(dvg + static_cast<int64_t>(key) * p.dv.ss + col) =
            make_float2(b[2 * r], b[2 * r + 1]);
      }
    }
  }
  if (tid == 0) bulk_wait<0>();  // the last reduce-adds have read their stage
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

template <int DH>  // head width padded to 64, 128 or 256
struct TmaCfg {
  static constexpr int BQ = 64;                    // query rows a step
  static constexpr int BK = DH == 256 ? 64 : 128;  // keys a block
  static constexpr int CB = DH / 64;               // 128-byte column blocks of a row
  // Dh 256: both consumers take the block's 64 keys and split the columns of
  // dK and dV (64 keys x 256 columns of each would be 256 registers a thread).
  static constexpr bool SHARED_KEYS = DH == 256;
  // Q/dO steps in the ring: three ran granite's shape at 1.96 ms against two's 1.74 (PERF.md).
  static constexpr int STAGES = 2;
  static constexpr int NKV = SHARED_KEYS ? DH / 2 : DH;  // dK, dV columns a consumer
  static constexpr int NQ = DH / 2;                      // dQ columns a consumer
  static constexpr uint32_t TILE_BYTES = BQ * DH * 2;  // one Q or one dO tile
  static constexpr uint32_t KV_BYTES = BK * DH * 2;    // the K or the V tile
  static constexpr uint32_t DS_BYTES = BK * BQ * 2;    // dS^T: BK rows of 128 bytes
  static constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; 2: producer, reducer
  // + 1024: the tiles start on the 1024-byte period of the 128-byte swizzle.
  static constexpr size_t kSmem = 2 * KV_BYTES + STAGES * 2 * TILE_BYTES + 2 * DS_BYTES + 1024;
  static_assert(kSmem <= 232448 - 2048, "dynamic and static shared memory fit an SM");
};

// Barriers of the ring, in static shared memory.
template <int STAGES>
struct TmaBars {
  uint64_t kv_full;           // the block's K and V have landed
  uint64_t full[STAGES];      // a step's Q, dO, L and D have landed
  uint64_t ds_ready[STAGES];  // every consumer warp's rows of the step's dS^T are written
  uint64_t qdo_read[STAGES];  // every consumer warp's products on Q and dO have landed
  uint64_t dq_full[STAGES];   // every consumer warp has staged its dQ over them
  uint64_t empty[STAGES];     // the reducer has read the staged dQ: the stage is free
};

// P^T of one step from S^T: 64 keys (rows: key_a + 8 (i >> 1) for element
// 4j + i) by 64 query rows from q0 (column 8j + 2t + (i & 1)). l2: the
// rows' L * log2 e (+inf past Sq and for a row that sees no key). MASK: the
// tile is cut by the causal diagonal, the window's lower edge or the Sk edge.
// P^T goes to pa as bf16 A fragments (tiles 2kk, 2kk + 1 of the accumulator
// are k step kk's, as the forward packs P); s keeps P^T in float32, times
// (1 - t^2) under a softcap: dS^T's factor.
template <bool MASK, bool SOFTCAP>
__device__ __forceinline__ void probs(float (&s)[32], uint32_t (&pa)[4][4], const float* l2,
                                      const Params& p, int q0, int key_a, int t) {
  const float c = SOFTCAP ? kLog2e : p.scale * kLog2e;
  const float tc = 2.f * kLog2e * p.scale / p.softcap;  // tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1)
  const int offset = p.sk - p.sq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[4 * j + i], cap = 0.f;
      if (SOFTCAP) {  // tanh by one ex2 and a division: tanhf took a fifth of gemma2's time
        cap = 1.f - __fdividef(2.f, fast_exp2(fminf(x * tc, 64.f)) + 1.f);
        x = p.softcap * cap;
      }
      pr[i] = fast_exp2(fmaf(x, c, -((i & 1) ? l.y : l.x)));
      if (MASK) {
        const int key = key_a + 8 * (i >> 1);
        const int ahead = q0 + 8 * j + 2 * t + (i & 1) + offset - key;
        if (key >= p.sk || (p.causal && ahead < 0) || ahead >= p.window) pr[i] = 0.f;
      }
      s[4 * j + i] = SOFTCAP ? pr[i] * (1.f - cap * cap) : pr[i];
    }
    pa[j >> 1][2 * (j & 1)] = pack_bf16(pr[0], pr[1]);
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(pr[2], pr[3]);
  }
}

// dS^T = P^T (dP^T - D) scale (s: P^T, times (1 - t^2) under a softcap; dd:
// the rows' D) as bf16 A fragments, packed as in probs.
__device__ __forceinline__ void grads(const float (&s)[32], const float (&dp)[32],
                                      uint32_t (&da)[4][4], const float* dd, float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * t);
    float ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ds[i] = s[4 * j + i] * (dp[4 * j + i] - ((i & 1) ? d.y : d.x)) * scale;
    da[j >> 1][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
    da[j >> 1][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) {
    wgmma_ss_n32<1, 1>(d, da, db, acc);
  } else if constexpr (N == 64) {
    wgmma_ss_n64<1, 1>(d, da, db, acc);
  } else {
    wgmma_ss_n128<1, 1>(d, da, db, acc);
  }
}

// A consumer warpgroup over the block's steps: step n is query head
// f * group + n / per_head, rows q0 = q_lo + (n % per_head) * BQ.
template <int DH, bool SOFTCAP>
__device__ __forceinline__ void bwd_consumer(const Params& p, uint32_t ks, uint32_t vs, uint32_t qs0,
                                             uint32_t ds0, TmaBars<TmaCfg<DH>::STAGES>& bar,
                                             const float (*ld)[2][TmaCfg<DH>::BQ], int f, int k0,
                                             int q_lo, int per_head, int n_steps) {
  using C = TmaCfg<DH>;
  constexpr int NKV = C::NKV, NQ = C::NQ;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const int row0 = C::SHARED_KEYS ? 0 : 64 * wg;  // the consumer's first key row in the block
  const int ka = k0 + row0;
  const int key_a = ka + 16 * warp + g;  // the thread's keys: key_a and key_a + 8
  const int kv_col = C::SHARED_KEYS ? wg * NKV : 0;  // its first column of dK and dV
  const int q_col = wg * NQ;                          // and of dQ

  float dk[NKV / 2], dv[NKV / 2];
#pragma unroll
  for (int i = 0; i < NKV / 2; ++i) dk[i] = dv[i] = 0.f;

  // K-major A operands of S^T = K Q^T and dP^T = V dO^T: the consumer's
  // rows; a k16 step moves 32 bytes in a 128-byte column block, four steps
  // move to the next block.
  const uint64_t k_desc = gmma_desc(ks + row0 * 128, 16, 1024);
  const uint64_t v_desc = gmma_desc(vs + row0 * 128, 16, 1024);
  // K as the MN-major B operand of dQ = dS K: the consumer's NQ columns
  // (Dh 64: half a column block, 64 bytes into each swizzled row).
  const uint64_t kq_desc = gmma_desc(ks + (q_col / 64) * C::BK * 128 + (q_col % 64) * 2,
                                     C::BK * 128, 1024);
  if (n_steps > 0) mbar_wait(&bar.kv_full, 0);

  for (int n = 0; n < n_steps; ++n) {
    const int j = n / per_head, q0 = q_lo + (n - j * per_head) * C::BQ;
    const int st = n % C::STAGES;
    const uint32_t q_t = qs0 + st * 2 * C::TILE_BYTES, do_t = q_t + C::TILE_BYTES;
    const uint32_t ds_t = ds0 + (n & 1) * C::DS_BYTES;
    mbar_wait(&bar.full[st], (n / C::STAGES) & 1);

    // S^T = K Q^T, then dP^T = V dO^T (m64n64, K-major both), each its own
    // group: P^T is formed while dP^T runs.
    float s[32], dp[32];
    const uint64_t q_desc = gmma_desc(q_t, 16, 1024), do_desc = gmma_desc(do_t, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t oa = ((kk >> 2) * C::BK * 128 + (kk & 3) * 32) >> 4;
      const uint32_t ob = ((kk >> 2) * C::BQ * 128 + (kk & 3) * 32) >> 4;
      wgmma_ss_n64(s, k_desc + oa, q_desc + ob, kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t oa = ((kk >> 2) * C::BK * 128 + (kk & 3) * 32) >> 4;
      const uint32_t ob = ((kk >> 2) * C::BQ * 128 + (kk & 3) * 32) >> 4;
      wgmma_ss_n64(dp, v_desc + oa, do_desc + ob, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T in registers, the mask only where the tile is cut; then dV += P^T
    // dO (A from registers, dO MN-major), issued while dP^T may still run.
    uint32_t pa[4][4], da[4][4];
    const bool whole = (!p.causal || q0 + offset >= ka + 63) &&
                       q0 + C::BQ - 1 + offset - ka < p.window && ka + 64 <= p.sk;
    if (whole) {
      probs<false, SOFTCAP>(s, pa, ld[st][0], p, q0, key_a, t);
    } else {
      probs<true, SOFTCAP>(s, pa, ld[st][0], p, q0, key_a, t);
    }
    const uint32_t c_off = (kv_col / 64) * C::BQ * 128;
    const uint64_t dob_desc = gmma_desc(do_t + c_off, C::BQ * 128, 1024);
    const uint64_t qb_desc = gmma_desc(q_t + c_off, C::BQ * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<NKV>(dv, pa[kk], dob_desc + ((kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV may still run
    fence_regs(dp);

    // dS^T, then dK += dS^T Q (Q MN-major), and dS^T to shared memory (bf16,
    // 128-byte rows of 64 query rows, swizzled as TMA would): the A operand
    // of dQ. At Dh 256 both consumers hold the same dS^T and consumer 0
    // writes it.
    grads(s, dp, da, ld[st][1], p.scale, t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<NKV>(dk, da[kk], qb_desc + ((kk * 16 * 128) >> 4));
    wgmma_commit();
    if (!C::SHARED_KEYS || wg == 0) {
      const uint32_t ra = ds_t + (row0 + 16 * warp + g) * 128 + 4 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // tile j = 2kk + h: 16 bytes (chunk j ^ g) of the row
          const uint32_t at = ra + (((2 * kk + h) ^ g) << 4);
          st_shared_u32(at, da[kk][2 * h]);
          st_shared_u32(at + 8 * 128, da[kk][2 * h + 1]);
        }
      }
      fence_proxy_async();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.ds_ready[st]);
    wgmma_wait<0>();  // dV and dK: the step's Q and dO are read, P^T's and dS^T's registers free
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(&bar.qdo_read[st]);

    // dQ = dS K over the block's keys, the consumer's NQ columns: dS^T
    // MN-major (trans a), K MN-major (trans b).
    mbar_wait(&bar.ds_ready[st], (n / C::STAGES) & 1);  // the other consumer's dS^T rows too
    float dq[NQ / 2];
    const uint64_t ds_desc = gmma_desc(ds_t, C::DS_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      const uint32_t o = (kk * 16 * 128) >> 4;
      wgmma_ss_tt<NQ>(dq, ds_desc + o, kq_desc + o, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_wait(&bar.qdo_read[st], (n / C::STAGES) & 1);  // no product reads Q or dO any more

    // dQ staged for the reducer in the step's Q (consumer 0) or dO tile
    // (consumer 1), which no product reads any more: boxes of 32 columns
    // by 64 rows, 128-byte swizzled.
    const uint32_t dq_stage = q_t + wg * C::TILE_BYTES;
#pragma unroll
    for (int jj = 0; jj < NQ / 8; ++jj) {
      const uint32_t at = dq_stage + (jj >> 2) * (C::BQ * 128) + (16 * warp + g) * 128 +
                          (((2 * (jj & 3) + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
      st_shared_f2(at, dq[4 * jj], dq[4 * jj + 1]);
      st_shared_f2(at + 8 * 128, dq[4 * jj + 2], dq[4 * jj + 3]);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.dq_full[st]);
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk.ptr) + row_base(p.dk, f, p.hkv);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv.ptr) + row_base(p.dv, f, p.hkv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= p.sk) continue;
#pragma unroll
    for (int jj = 0; jj < NKV / 8; ++jj) {
      const int col = kv_col + 8 * jj + 2 * t;
      if (col < p.dh) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + static_cast<int64_t>(key) * p.dk.ss + col) =
            __floats2bfloat162_rn(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + static_cast<int64_t>(key) * p.dv.ss + col) =
            __floats2bfloat162_rn(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

// Pass 2, bf16: one block per (key tile, KV row f), the first key tiles (the
// most query rows under a causal mask) of every KV row first.
template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(TmaCfg<DH>::kThreads, 1)
flash_bwd_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdq, Params p) {
  using C = TmaCfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ TmaBars<C::STAGES> bar;
  __shared__ __align__(16) float ld[C::STAGES][2][C::BQ];  // each step's L * log2 e and D
  const uint32_t ks = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t vs = ks + C::KV_BYTES;
  const uint32_t qs0 = vs + C::KV_BYTES;  // stage st: Q at qs0 + 2 st TILE_BYTES, dO after it
  const uint32_t ds0 = qs0 + C::STAGES * 2 * C::TILE_BYTES;

  const int nf = p.bhq / p.group;
  const int kt = blockIdx.x / nf, f = blockIdx.x - kt * nf;
  const int k0 = kt * C::BK, offset = p.sk - p.sq;
  // Query rows that see some key of the tile: from the causal diagonal of its
  // first key (rounded down to a step) to the window's far edge of its last.
  const int q_lo = p.causal ? max(0, k0 - offset) / C::BQ * C::BQ : 0;
  const int q_hi = static_cast<int>(min(static_cast<int64_t>(p.sq),
                                        static_cast<int64_t>(k0) + C::BK - 1 - offset + p.window));
  const int per_head = q_hi > q_lo ? (q_hi - q_lo + C::BQ - 1) / C::BQ : 0;
  const int n_steps = per_head * p.group;

  if (threadIdx.x == 0) {
    mbar_init(&bar.kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.ds_ready[s], 8);  // one arrival per consumer warp
      mbar_init(&bar.qdo_read[s], 8);
      mbar_init(&bar.dq_full[s], 8);
      mbar_init(&bar.empty[s], 1);    // the reducer's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && n_steps > 0) {  // the producer
      const int kb = f / p.hkv, kh = f - kb * p.hkv;
      mbar_expect_tx(&bar.kv_full, 2 * C::KV_BYTES);
      for (int c = 0; c < C::CB; ++c) {
        tma_load(ks + c * C::BK * 128, &tk, &bar.kv_full, c * 64, k0, kh, kb);
        tma_load(vs + c * C::BK * 128, &tv, &bar.kv_full, c * 64, k0, kh, kb);
      }
      const int64_t plane = static_cast<int64_t>(p.bhq) * p.sq_pad;  // L, then D
      for (int n = 0; n < n_steps; ++n) {
        const int j = n / per_head, q0 = q_lo + (n - j * per_head) * C::BQ;
        const int bh = f * p.group + j, qb = bh / p.hq, qh = bh - qb * p.hq;
        const int st = n % C::STAGES;
        if (n >= C::STAGES) mbar_wait(&bar.empty[st], (n / C::STAGES - 1) & 1);
        mbar_expect_tx(&bar.full[st], 2 * C::TILE_BYTES + 2 * C::BQ * 4);
        const uint32_t q_t = qs0 + st * 2 * C::TILE_BYTES;
        for (int c = 0; c < C::CB; ++c) {
          tma_load(q_t + c * C::BQ * 128, &tq, &bar.full[st], c * 64, q0, qh, qb);
          tma_load(q_t + C::TILE_BYTES + c * C::BQ * 128, &tdo, &bar.full[st], c * 64, q0, qh,
                   qb);
        }
        const float* l2 = p.delta + static_cast<int64_t>(bh) * p.sq_pad + q0;
        bulk_load(smem_u32(ld[st][0]), l2, C::BQ * 4, &bar.full[st]);
        bulk_load(smem_u32(ld[st][1]), l2 + plane, C::BQ * 4, &bar.full[st]);
      }
    } else if (threadIdx.x == 320) {  // the reducer: each step's staged dQ into dq_acc
      for (int n = 0; n < n_steps; ++n) {
        const int j = n / per_head, q0 = q_lo + (n - j * per_head) * C::BQ;
        const int st = n % C::STAGES;
        const uint32_t q_t = qs0 + st * 2 * C::TILE_BYTES;
        mbar_wait(&bar.dq_full[st], (n / C::STAGES) & 1);
        for (int c = 0; c < 2; ++c)
          for (int b = 0; b < C::NQ / 32; ++b)
            tma_reduce_add(&tdq, q_t + c * C::TILE_BYTES + b * (C::BQ * 128), c * C::NQ + 32 * b,
                           q0, f * p.group + j);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(&bar.empty[st]);
      }
      bulk_wait<0>();
    }
  } else {
    setmaxnreg_inc<240>();
    bwd_consumer<DH, SOFTCAP>(p, ks, vs, qs0, ds0, bar, ld, f, k0, q_lo, per_head, n_steps);
  }
}

// Pass 3: dQ from the float32 scratch [bhq, sq, width] into dq's dtype and layout.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(Params p, int width) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= static_cast<int64_t>(p.bhq) * p.sq * p.dh) return;
  const int64_t row = idx / p.dh;
  const int c = static_cast<int>(idx - row * p.dh);
  const int bh = static_cast<int>(row / p.sq), i = static_cast<int>(row - static_cast<int64_t>(bh) * p.sq);
  store(static_cast<T*>(p.dq.ptr) + row_base(p.dq, bh, p.hq) + i * p.dq.ss + c,
        p.dq_acc[row * width + c]);
}

template <int DH, bool SOFTCAP>
cudaError_t launch_tma(const Params& p, cudaStream_t stream) {
  using C = TmaCfg<DH>;
  const int nf = p.bhq / p.group;
  // dK and dV are written as bf16 pairs: 4-byte aligned rows.
  for (const Operand* op : {&p.dk, &p.dv})
    if (reinterpret_cast<uintptr_t>(op->ptr) % 4 || op->sb % 2 || op->sh % 2 || op->ss % 2)
      return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!encode_f32_planes(&tdq, p.dq_acc, DH, p.sq, p.bhq, C::BQ) ||
      !encode_operand(&tq, p.q, p.dh, p.sq, p.hq, p.bhq / p.hq, C::BQ) ||
      !encode_operand(&tdo, p.dout, p.dh, p.sq, p.hq, p.bhq / p.hq, C::BQ) ||
      !encode_operand(&tk, p.k, p.dh, p.sk, p.hkv, nf / p.hkv, C::BK) ||
      !encode_operand(&tv, p.v, p.dh, p.sk, p.hkv, nf / p.hkv, C::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_bwd_tma_kernel<DH, SOFTCAP>, C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>((p.sk + C::BK - 1) / C::BK) * nf;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_tma_kernel<DH, SOFTCAP><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem,
                                      stream>>>(tq, tk, tv, tdo, tdq, p);
  return cudaGetLastError();
}

template <int DH, bool SOFTCAP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  using C = F32Cfg<DH>;
  const int nf = p.bhq / p.group;
  // dK and dV are written as float pairs: 8-byte aligned rows.
  for (const Operand* op : {&p.dk, &p.dv})
    if (reinterpret_cast<uintptr_t>(op->ptr) % 8 || op->sb % 2 || op->sh % 2 || op->ss % 2)
      return cudaErrorInvalidValue;
  CUtensorMap tdq;
  if (!encode_f32_planes(&tdq, p.dq_acc, DH, p.sq, p.bhq, C::BQ)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_bwd_f32_kernel<DH, SOFTCAP>, C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>((p.sk + C::BK - 1) / C::BK) * nf;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_bwd_f32_kernel<DH, SOFTCAP><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem,
                                      stream>>>(tdq, p);
  return cudaGetLastError();
}

template <typename T, int DH, bool SOFTCAP>
cudaError_t launch_main(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_tma<DH, SOFTCAP>(p, stream);
  } else {
    return launch_f32<DH, SOFTCAP>(p, stream);
  }
}

template <typename T, int DH>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.bhq) * p.sq;
  const int64_t d_rows = static_cast<int64_t>(p.bhq) * p.sq_pad;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((d_rows + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(p.dq_acc, 0, static_cast<size_t>(rows) * DH * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  err = p.softcap > 0.f ? launch_main<T, DH, true>(p, stream) : launch_main<T, DH, false>(p, stream);
  if (err != cudaSuccess) return err;
  const int64_t n = rows * p.dh;
  flash_bwd_dq_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(p, DH);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const Params& p, cudaStream_t stream) {
  if (p.dh <= 64) return launch_all<T, 64>(p, stream);
  if (p.dh <= 128) return launch_all<T, 128>(p, stream);
  return launch_all<T, 256>(p, stream);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: device pointers; strides: 24 host int64
// values, (sb, sh, ss) of each in that order, in elements. lse: the
// forward's float32 [bhq, sq]; delta: float32 scratch [2, bhq, sq_pad],
// sq_pad = sq rounded up to 64 (ops.py: bwd_delta_size); dq_acc: float32
// scratch [bhq, sq, width], width = Dh padded to 64, 128 or 256 (ops.py:
// bwd_width). window as the forward's. dtype: 0 float32, 1 bf16; both take q,
// k, v, dout at 16-byte aligned pointers and strides and dh a multiple of 16
// bytes (4 float32, 8 bf16 values: cp.async and TMA; ops.py hands over
// aligned copies), and dk, dv at 8-byte (float32) or 4-byte (bf16) aligned
// rows. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, const int64_t* strides, const void* lse,
                                          void* delta, void* dq_acc, int bhq, int hq, int hkv,
                                          int group, int sq, int sk, int dh, float scale,
                                          float softcap, int causal, int window, int dtype,
                                          void* stream) {
  Params p;
  void* ptrs[8] = {const_cast<void*>(q), const_cast<void*>(k), const_cast<void*>(v),
                   const_cast<void*>(o), const_cast<void*>(dout), dq, dk, dv};
  Operand* ops[8] = {&p.q, &p.k, &p.v, &p.o, &p.dout, &p.dq, &p.dk, &p.dv};
  for (int i = 0; i < 8; ++i)
    *ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.bhq = bhq;
  p.hq = hq;
  p.hkv = hkv;
  p.group = group;
  p.sq = sq;
  p.sk = sk;
  p.dh = dh;
  p.sq_pad = (sq + 63) / 64 * 64;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  if (dh < 1 || dh > 256 || window < 1 || sq < 1 || sk < 1 || group < 1 || bhq % group ||
      dh % (dtype == 1 ? 8 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_width<float>(p, st));
  if (dtype == 1) return static_cast<int>(launch_width<__nv_bfloat16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
