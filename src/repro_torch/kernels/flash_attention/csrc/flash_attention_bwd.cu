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
// at the tensor cores' 989 TFLOP/s in bf16 and the CUDA cores' 67 TFLOP/s
// in float32; the bytes (each operand read once, each gradient written once)
// take less time at the models' shapes (a seventh of it at granite's). Two
// forms of pass 2:
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
// * float32 -> flash_bwd_kernel: the CUDA cores in float32 FMA (the tensor
//   cores would round to tf32), register tiles over shared-memory tiles of
//   K, V, Q, dO, P and dS. A plain kernel.
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
  float* delta;      // pass 1's output. float32: D = rowsum(dO * O) [bhq, sq]; bf16: two
                     // planes [bhq, sq_pad], L * log2 e (+inf past sq) then D (0 past sq)
  float* dq_acc;     // [bhq, sq, DH] float32: dQ, summed over the key tiles
  int bhq;           // query rows: batch * hq
  int hq, hkv;       // heads per batch entry of q (and o, dO, dq) and of k (and v, dk, dv)
  int group;         // query heads per KV head
  int sq, sk, dh;
  int sq_pad;        // bf16: sq rounded up to a query step (TmaCfg::BQ); float32: 0
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

// Pass 1, a warp a row. float32: D[bh, i] = sum_d dO[bh, i, d] * O[bh, i, d].
// bf16: rows [0, sq_pad) of each bh into the two planes, L * log2 e and D,
// +inf and 0 past sq: what the bf16 kernel's steps read by bulk copies.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(Params p) {
  const int rows = p.sq_pad ? p.sq_pad : p.sq;
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
  if (p.sq_pad) {
    const float lse = i < p.sq ? p.lse[static_cast<int64_t>(bh) * p.sq + i] : INFINITY;
    p.delta[row] = lse * kLog2e;
    p.delta[static_cast<int64_t>(p.bhq) * p.sq_pad + row] = acc;
  } else {
    p.delta[row] = acc;
  }
}

template <int DH>  // head width padded to 64, 128 or 256
struct BwdCfg {
  static constexpr int BK = DH == 256 ? 32 : 64;  // keys a block
  static constexpr int BQ = DH == 256 ? 32 : 64;  // query rows a step
  static constexpr int kThreads = 256;
  static constexpr int LD = DH + 1;  // row stride (floats) of the K, V, Q and dO tiles: conflict-free
  static constexpr int LS = BK + 1;  // row stride of P and dS
  static constexpr int RI = BQ / 16, RJ = BK / 16;  // S and dP: rows ty + 16i, keys tx + 16j
  static constexpr int KR = BK / 8, QR = BQ / 8;    // dK, dV: keys ly + 8r; dQ: rows ly + 8r
  static constexpr int DC = DH / 32;                // ... and columns lx + 32c
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * BK * LD + 2 * BQ * LD + 2 * BQ * LS + 2 * BQ) * sizeof(float);
};

// Rows r of a tile of ``rows`` x DH from src(r) + c into dst[r * ld + c] as
// float32, zero where !ok(r) and past dh.
template <int DH, typename T, typename RowPtr, typename RowOk>
__device__ __forceinline__ void stage(float* dst, int ld, int rows, int dh, RowPtr src, RowOk ok) {
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH, c = i - r * DH;
    dst[r * ld + c] = ok(r) && c < dh ? load(static_cast<const T*>(src(r)) + c) : 0.f;
  }
}

// Pass 2: one block per (key tile, KV row f).
template <typename T, int DH, bool SOFTCAP>
__global__ void __launch_bounds__(BwdCfg<DH>::kThreads, 1) flash_bwd_kernel(Params p) {
  using C = BwdCfg<DH>;
  extern __shared__ float smem[];
  float* ks = smem;                   // K tile [BK][LD]
  float* vs = ks + C::BK * C::LD;     // V tile [BK][LD]
  float* qs = vs + C::BK * C::LD;     // Q tile [BQ][LD]
  float* gs = qs + C::BQ * C::LD;     // dO tile [BQ][LD]
  float* ps = gs + C::BQ * C::LD;     // P [BQ][LS]
  float* dss = ps + C::BQ * C::LS;    // dS * scale [BQ][LS]
  float* lse_s = dss + C::BQ * C::LS; // [BQ]
  float* del_s = lse_s + C::BQ;       // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // S and dP
  const int lx = tid & 31, ly = tid >> 5;  // dK, dV, dQ
  const int f = blockIdx.y, k0 = blockIdx.x * C::BK;
  const int offset = p.sk - p.sq;

  const T* kg = static_cast<const T*>(p.k.ptr) + row_base(p.k, f, p.hkv);
  const T* vg = static_cast<const T*>(p.v.ptr) + row_base(p.v, f, p.hkv);
  const auto key_ok = [&](int r) { return k0 + r < p.sk; };
  stage<DH, T>(ks, C::LD, C::BK, p.dh, [&](int r) { return kg + static_cast<int64_t>(k0 + r) * p.k.ss; }, key_ok);
  stage<DH, T>(vs, C::LD, C::BK, p.dh, [&](int r) { return vg + static_cast<int64_t>(k0 + r) * p.v.ss; }, key_ok);

  float dk[C::KR][C::DC], dv[C::KR][C::DC];
#pragma unroll
  for (int r = 0; r < C::KR; ++r)
#pragma unroll
    for (int c = 0; c < C::DC; ++c) dk[r][c] = dv[r][c] = 0.f;

  // Rows that see some key of the tile: from the causal diagonal of its first
  // key to the window's far edge of its last.
  const int q_lo = p.causal ? max(0, k0 - offset) : 0;
  const int q_hi = static_cast<int>(min(static_cast<int64_t>(p.sq),
                                        static_cast<int64_t>(k0) + C::BK - 1 - offset + p.window));

  for (int j = 0; j < p.group; ++j) {
    const int bh = f * p.group + j;
    const T* qg = static_cast<const T*>(p.q.ptr) + row_base(p.q, bh, p.hq);
    const T* gg = static_cast<const T*>(p.dout.ptr) + row_base(p.dout, bh, p.hq);
    float* dqa = p.dq_acc + static_cast<int64_t>(bh) * p.sq * DH;
    for (int q0 = q_lo; q0 < q_hi; q0 += C::BQ) {
      __syncthreads();  // every thread is done with the previous tile's Q, dO, P and dS
      const auto row_ok = [&](int r) { return q0 + r < p.sq; };
      stage<DH, T>(qs, C::LD, C::BQ, p.dh, [&](int r) { return qg + static_cast<int64_t>(q0 + r) * p.q.ss; }, row_ok);
      stage<DH, T>(gs, C::LD, C::BQ, p.dh, [&](int r) { return gg + static_cast<int64_t>(q0 + r) * p.dout.ss; }, row_ok);
      if (tid < C::BQ) {
        const bool on = q0 + tid < p.sq;
        const int64_t at = static_cast<int64_t>(bh) * p.sq + q0 + tid;
        lse_s[tid] = on ? p.lse[at] : INFINITY;
        del_s[tid] = on ? p.delta[at] : 0.f;
      }
      __syncthreads();

      float s[C::RI][C::RJ], dp[C::RI][C::RJ];
#pragma unroll
      for (int i = 0; i < C::RI; ++i)
#pragma unroll
        for (int jj = 0; jj < C::RJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float a[C::RI], g[C::RI], kk[C::RJ], vv[C::RJ];
#pragma unroll
        for (int i = 0; i < C::RI; ++i) {
          a[i] = qs[(ty + 16 * i) * C::LD + d];
          g[i] = gs[(ty + 16 * i) * C::LD + d];
        }
#pragma unroll
        for (int jj = 0; jj < C::RJ; ++jj) {
          kk[jj] = ks[(tx + 16 * jj) * C::LD + d];
          vv[jj] = vs[(tx + 16 * jj) * C::LD + d];
        }
#pragma unroll
        for (int i = 0; i < C::RI; ++i)
#pragma unroll
          for (int jj = 0; jj < C::RJ; ++jj) {
            s[i][jj] = fmaf(a[i], kk[jj], s[i][jj]);
            dp[i][jj] = fmaf(g[i], vv[jj], dp[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < C::RI; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
        for (int jj = 0; jj < C::RJ; ++jj) {
          const int c = tx + 16 * jj, key = k0 + c;
          float x = s[i][jj] * p.scale, cap = 0.f;
          if (SOFTCAP) {
            cap = tanhf(x / p.softcap);
            x = p.softcap * cap;
          }
          const int ahead = row + offset - key;
          const bool seen = row < p.sq && key < p.sk && (!p.causal || ahead >= 0) && ahead < p.window;
          const float pr = seen ? expf(x - lse_s[r]) : 0.f;
          float ds = pr * (dp[i][jj] - del_s[r]);
          if (SOFTCAP) ds *= 1.f - cap * cap;
          ps[r * C::LS + c] = pr;
          dss[r * C::LS + c] = ds * p.scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's rows.
#pragma unroll 2
      for (int r = 0; r < C::BQ; ++r) {
        float g[C::DC], a[C::DC];
#pragma unroll
        for (int c = 0; c < C::DC; ++c) {
          g[c] = gs[r * C::LD + lx + 32 * c];
          a[c] = qs[r * C::LD + lx + 32 * c];
        }
#pragma unroll
        for (int kr = 0; kr < C::KR; ++kr) {
          const float pv = ps[r * C::LS + ly + 8 * kr], dsv = dss[r * C::LS + ly + 8 * kr];
#pragma unroll
          for (int c = 0; c < C::DC; ++c) {
            dv[kr][c] = fmaf(pv, g[c], dv[kr][c]);
            dk[kr][c] = fmaf(dsv, a[c], dk[kr][c]);
          }
        }
      }
      // dQ of the tile = dS K, added to the float32 scratch.
      float dq[C::QR][C::DC];
#pragma unroll
      for (int r = 0; r < C::QR; ++r)
#pragma unroll
        for (int c = 0; c < C::DC; ++c) dq[r][c] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < C::BK; ++kk) {
        float kv[C::DC];
#pragma unroll
        for (int c = 0; c < C::DC; ++c) kv[c] = ks[kk * C::LD + lx + 32 * c];
#pragma unroll
        for (int r = 0; r < C::QR; ++r) {
          const float dsv = dss[(ly + 8 * r) * C::LS + kk];
#pragma unroll
          for (int c = 0; c < C::DC; ++c) dq[r][c] = fmaf(dsv, kv[c], dq[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < C::QR; ++r) {
        const int row = q0 + ly + 8 * r;
        if (row >= p.sq) continue;
#pragma unroll
        for (int c = 0; c < C::DC; ++c) {
          const int col = lx + 32 * c;
          if (col < p.dh) atomicAdd(dqa + static_cast<int64_t>(row) * DH + col, dq[r][c]);
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk.ptr) + row_base(p.dk, f, p.hkv);
  T* dvg = static_cast<T*>(p.dv.ptr) + row_base(p.dv, f, p.hkv);
#pragma unroll
  for (int kr = 0; kr < C::KR; ++kr) {
    const int key = k0 + ly + 8 * kr;
    if (key >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) {
      const int col = lx + 32 * c;
      if (col < p.dh) {
        store(dkg + static_cast<int64_t>(key) * p.dk.ss + col, dk[kr][c]);
        store(dvg + static_cast<int64_t>(key) * p.dv.ss + col, dv[kr][c]);
      }
    }
  }
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

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x), "f"(y) : "memory");
}

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

template <typename T, int DH, bool SOFTCAP>
cudaError_t launch_main(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_tma<DH, SOFTCAP>(p, stream);
  } else {
    using C = BwdCfg<DH>;
    if (p.bhq / p.group > 65535) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(flash_bwd_kernel<T, DH, SOFTCAP>, C::kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.sk + C::BK - 1) / C::BK, p.bhq / p.group);
    flash_bwd_kernel<T, DH, SOFTCAP><<<grid, C::kThreads, C::kSmem, stream>>>(p);
    return cudaGetLastError();
  }
}

template <typename T, int DH>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.bhq) * p.sq;
  const int64_t d_rows = static_cast<int64_t>(p.bhq) * (p.sq_pad ? p.sq_pad : p.sq);
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
// forward's float32 [bhq, sq]; delta: float32 scratch, [bhq, sq] for
// float32 and [2, bhq, sq_pad] for bf16, sq_pad = sq rounded up to 64
// (ops.py: bwd_delta_size); dq_acc: float32 scratch [bhq, sq, width], width =
// Dh padded to 64, 128 or 256 (ops.py: bwd_width). window as the forward's.
// dtype: 0 float32, 1 bf16; bf16 takes dh % 8 == 0 and q, k, v, dout at
// 16-byte aligned pointers and strides (TMA; ops.py hands over aligned
// copies). Returns a cudaError_t (0 on success).
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
  p.sq_pad = dtype == 1 ? (sq + TmaCfg<64>::BQ - 1) / TmaCfg<64>::BQ * TmaCfg<64>::BQ : 0;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  if (dh < 1 || dh > 256 || window < 1 || sq < 1 || sk < 1 || group < 1 || bhq % group ||
      (dtype == 1 && dh % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_width<float>(p, st));
  if (dtype == 1) return static_cast<int>(launch_width<__nv_bfloat16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
