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
// head). The block stages its K and V tile in shared memory once, then walks
// the query tiles of every query head of f's group (grouped-query attention:
// query row bh = f * group + j, as the forward packs them) that see some key
// of the tile: only the rows between the causal diagonal and the window's
// far edge. For each query tile it stages Q and dO, computes S and dP,
// forms P and dS in shared memory, and accumulates dV and dK in registers
// over all the tiles: they are written once, with no atomics, in the inputs'
// dtype. dQ of the tile (dS K) goes to a float32 scratch by atomic adds;
// pass 3 converts it to the inputs' dtype and layout.
//
// Two forms of pass 2. bf16 (flash_bwd_tc_kernel): the five products on the
// tensor cores through WMMA (m16n16k16, bf16 in, float32 sums), the tiles
// kept in shared memory as bf16; S and dP land in shared memory as float32,
// P and dS are rounded to bf16 there for the three products that take them
// (dV, dK, dQ), as FlashAttention-2 does; dK and dV stay in WMMA
// accumulators over all the query tiles, and each warp adds its dQ
// fragments to the scratch through a 16 x 16 staging tile. float32
// (flash_bwd_kernel): the CUDA cores in float32 FMA (the tensor cores would
// round to tf32), register tiles over the same shared-memory tiles. Bound:
// 10 * Dh flop a visible (query, key) pair (five products of 2 * Dh), at the
// tensor cores' 989 TFLOP/s for bf16 and the CUDA cores' 67 TFLOP/s for
// float32. A plain kernel (no wgmma, no TMA, one block of 8 warps an SM at
// Dh 128); its times against that bound and against SDPA's backward are in
// PERF.md.
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
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Operand {  // element (b, h, s, d) at ptr + b*sb + h*sh + s*ss + d
  void* ptr;
  int64_t sb, sh, ss;
};

struct Params {
  Operand q, k, v, o, dout, dq, dk, dv;
  const float* lse;  // [bhq, sq]: the forward's log-sum-exp of each row
  float* delta;      // [bhq, sq]: D = rowsum(dO * O), pass 1's output
  float* dq_acc;     // [bhq, sq, DH] float32: dQ, summed over the key tiles
  int bhq;           // query rows: batch * hq
  int hq, hkv;       // heads per batch entry of q (and o, dO, dq) and of k (and v, dk, dv)
  int group;         // query heads per KV head
  int sq, sk, dh;
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

// Pass 1: D[bh, i] = sum_d dO[bh, i, d] * O[bh, i, d] in float32, a warp a row.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(Params p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(p.bhq) * p.sq) return;
  const int bh = static_cast<int>(row / p.sq), i = static_cast<int>(row - static_cast<int64_t>(bh) * p.sq);
  const T* o = static_cast<const T*>(p.o.ptr) + row_base(p.o, bh, p.hq) + i * p.o.ss;
  const T* g = static_cast<const T*>(p.dout.ptr) + row_base(p.dout, bh, p.hq) + i * p.dout.ss;
  float acc = 0.f;
  for (int d = lane; d < p.dh; d += 32) acc = fmaf(load(o + d), load(g + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
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
// bf16: the products on the tensor cores (WMMA)
// ---------------------------------------------------------------------------

template <int DH>  // head width padded to 64, 128 or 256
struct TcCfg {
  static constexpr int BK = DH == 256 ? 32 : 64;  // keys a block
  static constexpr int BQ = 64;                   // query rows a step
  static constexpr int kThreads = 256;            // 8 warps
  static constexpr int LDT = DH + 8;              // bf16 row stride of the K, V, Q, dO tiles
  static constexpr int LDF = BK + 4;              // float row stride of S and dP
  static constexpr int LDP = BK + 8;              // bf16 row stride of P and dS
  static constexpr int NS = (BQ / 16) * (BK / 16) / 8;   // S (and dP) fragments a warp
  static constexpr int NKV = (BK / 16) * (DH / 16) / 8;  // dK (and dV) fragments a warp
  static constexpr int NQ = (BQ / 16) * (DH / 16) / 8;   // dQ fragments a warp
  static constexpr size_t up(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = up(K_OFF + BK * LDT * 2);
  static constexpr size_t Q_OFF = up(V_OFF + BK * LDT * 2);
  static constexpr size_t G_OFF = up(Q_OFF + BQ * LDT * 2);
  static constexpr size_t S_OFF = up(G_OFF + BQ * LDT * 2);
  static constexpr size_t DP_OFF = up(S_OFF + BQ * LDF * 4);
  static constexpr size_t P_OFF = up(DP_OFF + BQ * LDF * 4);
  static constexpr size_t DS_OFF = up(P_OFF + BQ * LDP * 2);
  static constexpr size_t L_OFF = up(DS_OFF + BQ * LDP * 2);
  static constexpr size_t kSmem = L_OFF + 2 * BQ * 4;
  static_assert(NS * 8 == (BQ / 16) * (BK / 16) && NKV * 8 == (BK / 16) * (DH / 16) &&
                NQ * 8 == (BQ / 16) * (DH / 16), "fragments split evenly over 8 warps");
  static_assert(BQ * LDF >= 8 * 256, "S holds the warps' 16 x 16 staging tiles");
};

// Rows [0, rows) of a bf16 tile from base + (row0 + r) * ss into dst[r * LD
// + c], zero past ``valid`` rows and past dh; 16-byte copies where ``vec``
// (dh % 8 == 0 and every row 16-byte aligned), else 2-byte ones.
template <int DH, int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int rows, int valid, int dh,
                                           const __nv_bfloat16* base, int64_t ss, int row0,
                                           bool vec) {
  if (vec) {
    constexpr int CH = DH / 8;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i - r * CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < dh)
        x = *reinterpret_cast<const uint4*>(base + static_cast<int64_t>(row0 + r) * ss + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
      const int r = i / DH, c = i - r * DH;
      dst[r * LD + c] = r < valid && c < dh ? base[static_cast<int64_t>(row0 + r) * ss + c]
                                            : __float2bfloat16_rn(0.f);
    }
  }
}

// A warp's 16 x 16 float tile ``tile`` (row-major, staged in shared memory)
// into rows row0.. and columns col0.. of a bf16 [rows, dh] matrix at base
// (row stride ss), where row < rows and col < dh.
__device__ __forceinline__ void write_tile(const float* tile, __nv_bfloat16* base, int64_t ss,
                                           int row0, int rows, int col0, int dh) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 256; e += 32) {
    const int row = row0 + e / 16, col = col0 + (e & 15);
    if (row < rows && col < dh) base[static_cast<int64_t>(row) * ss + col] = __float2bfloat16_rn(tile[e]);
  }
}

// Pass 2, bf16: one block per (key tile, KV row f).
template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(TcCfg<DH>::kThreads, 1) flash_bwd_tc_kernel(Params p, bool vec) {
  using C = TcCfg<DH>;
  using namespace nvcuda;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K_OFF);  // [BK][LDT]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V_OFF);  // [BK][LDT]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q_OFF);  // [BQ][LDT]
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::G_OFF);  // dO [BQ][LDT]
  float* sf = reinterpret_cast<float*>(smem_raw + C::S_OFF);                  // S [BQ][LDF]
  float* dpf = reinterpret_cast<float*>(smem_raw + C::DP_OFF);                // dP [BQ][LDF]
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::P_OFF);  // P [BQ][LDP]
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DS_OFF);  // dS*scale
  float* lse_s = reinterpret_cast<float*>(smem_raw + C::L_OFF);               // [BQ]
  float* del_s = lse_s + C::BQ;                                               // [BQ]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int f = blockIdx.y, k0 = blockIdx.x * C::BK;
  const int offset = p.sk - p.sq;
  float* stage = sf + warp * 256;  // the warp's 16 x 16 tile, over S once S is read

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k.ptr) + row_base(p.k, f, p.hkv);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v.ptr) + row_base(p.v, f, p.hkv);
  stage_bf16<DH, C::LDT>(ks, C::BK, p.sk - k0, p.dh, kg, p.k.ss, k0, vec);
  stage_bf16<DH, C::LDT>(vs, C::BK, p.sk - k0, p.dh, vg, p.v.ss, k0, vec);

  Acc dk[C::NKV], dv[C::NKV];
#pragma unroll
  for (int n = 0; n < C::NKV; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  const int q_lo = p.causal ? max(0, k0 - offset) : 0;
  const int q_hi = static_cast<int>(min(static_cast<int64_t>(p.sq),
                                        static_cast<int64_t>(k0) + C::BK - 1 - offset + p.window));

  for (int j = 0; j < p.group; ++j) {
    const int bh = f * p.group + j;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q.ptr) + row_base(p.q, bh, p.hq);
    const __nv_bfloat16* gg =
        static_cast<const __nv_bfloat16*>(p.dout.ptr) + row_base(p.dout, bh, p.hq);
    float* dqa = p.dq_acc + static_cast<int64_t>(bh) * p.sq * DH;
    for (int q0 = q_lo; q0 < q_hi; q0 += C::BQ) {
      __syncthreads();  // every warp is done with the previous tile
      stage_bf16<DH, C::LDT>(qs, C::BQ, p.sq - q0, p.dh, qg, p.q.ss, q0, vec);
      stage_bf16<DH, C::LDT>(gs, C::BQ, p.sq - q0, p.dh, gg, p.dout.ss, q0, vec);
      if (tid < C::BQ) {
        const bool on = q0 + tid < p.sq;
        const int64_t at = static_cast<int64_t>(bh) * p.sq + q0 + tid;
        lse_s[tid] = on ? p.lse[at] : INFINITY;
        del_s[tid] = on ? p.delta[at] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T, NS 16 x 16 tiles of each a warp.
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        const int idx = warp + 8 * n, fi = idx / (C::BK / 16), fj = idx % (C::BK / 16);
        Acc s, dp;
        wmma::fill_fragment(s, 0.f);
        wmma::fill_fragment(dp, 0.f);
#pragma unroll 4
        for (int kk = 0; kk < DH; kk += 16) {
          FragA a;
          FragBt b;
          wmma::load_matrix_sync(a, qs + fi * 16 * C::LDT + kk, C::LDT);
          wmma::load_matrix_sync(b, ks + fj * 16 * C::LDT + kk, C::LDT);
          wmma::mma_sync(s, a, b, s);
          wmma::load_matrix_sync(a, gs + fi * 16 * C::LDT + kk, C::LDT);
          wmma::load_matrix_sync(b, vs + fj * 16 * C::LDT + kk, C::LDT);
          wmma::mma_sync(dp, a, b, dp);
        }
        wmma::store_matrix_sync(sf + fi * 16 * C::LDF + fj * 16, s, C::LDF, wmma::mem_row_major);
        wmma::store_matrix_sync(dpf + fi * 16 * C::LDF + fj * 16, dp, C::LDF, wmma::mem_row_major);
      }
      __syncthreads();

      // P and dS * scale, rounded to bf16.
      for (int i = tid; i < C::BQ * C::BK; i += C::kThreads) {
        const int r = i / C::BK, c = i - r * C::BK, row = q0 + r, key = k0 + c;
        float x = sf[r * C::LDF + c] * p.scale, cap = 0.f;
        if (SOFTCAP) {
          cap = tanhf(x / p.softcap);
          x = p.softcap * cap;
        }
        const int ahead = row + offset - key;
        const bool seen = row < p.sq && key < p.sk && (!p.causal || ahead >= 0) && ahead < p.window;
        const float pr = seen ? expf(x - lse_s[r]) : 0.f;
        float ds = pr * (dpf[r * C::LDF + c] - del_s[r]);
        if (SOFTCAP) ds *= 1.f - cap * cap;
        pb[r * C::LDP + c] = __float2bfloat16_rn(pr);
        dsb[r * C::LDP + c] = __float2bfloat16_rn(ds * p.scale);
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: the warp's NKV tiles of each.
#pragma unroll
      for (int n = 0; n < C::NKV; ++n) {
        const int idx = warp + 8 * n, fi = idx / (DH / 16), fj = idx % (DH / 16);
#pragma unroll
        for (int kk = 0; kk < C::BQ; kk += 16) {
          FragAt a;
          FragB b;
          wmma::load_matrix_sync(a, pb + kk * C::LDP + fi * 16, C::LDP);
          wmma::load_matrix_sync(b, gs + kk * C::LDT + fj * 16, C::LDT);
          wmma::mma_sync(dv[n], a, b, dv[n]);
          wmma::load_matrix_sync(a, dsb + kk * C::LDP + fi * 16, C::LDP);
          wmma::load_matrix_sync(b, qs + kk * C::LDT + fj * 16, C::LDT);
          wmma::mma_sync(dk[n], a, b, dk[n]);
        }
      }
      // dQ of the tile = dS K, each warp's NQ tiles added to the scratch.
#pragma unroll
      for (int n = 0; n < C::NQ; ++n) {
        const int idx = warp + 8 * n, fi = idx / (DH / 16), fj = idx % (DH / 16);
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < C::BK; kk += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, dsb + fi * 16 * C::LDP + kk, C::LDP);
          wmma::load_matrix_sync(b, ks + kk * C::LDT + fj * 16, C::LDT);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = tid & 31; e < 256; e += 32) {
          const int row = q0 + fi * 16 + e / 16, col = fj * 16 + (e & 15);
          if (row < p.sq && col < p.dh) atomicAdd(dqa + static_cast<int64_t>(row) * DH + col, stage[e]);
        }
        __syncwarp();
      }
    }
  }

  __syncthreads();  // S is free: the warps' staging tiles
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk.ptr) + row_base(p.dk, f, p.hkv);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv.ptr) + row_base(p.dv, f, p.hkv);
#pragma unroll
  for (int n = 0; n < C::NKV; ++n) {
    const int idx = warp + 8 * n, fi = idx / (DH / 16), fj = idx % (DH / 16);
    wmma::store_matrix_sync(stage, dk[n], 16, wmma::mem_row_major);
    __syncwarp();
    write_tile(stage, dkg, p.dk.ss, k0 + fi * 16, p.sk, fj * 16, p.dh);
    __syncwarp();
    wmma::store_matrix_sync(stage, dv[n], 16, wmma::mem_row_major);
    __syncwarp();
    write_tile(stage, dvg, p.dv.ss, k0 + fi * 16, p.sk, fj * 16, p.dh);
    __syncwarp();
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

template <typename T, int DH, bool SOFTCAP>
cudaError_t launch_main(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using C = TcCfg<DH>;
    // 16-byte copies where every operand row allows them; else 2-byte copies.
    bool vec = p.dh % 8 == 0;
    for (const Operand* op : {&p.q, &p.k, &p.v, &p.dout})
      vec = vec && reinterpret_cast<uintptr_t>(op->ptr) % 16 == 0 && op->sb % 8 == 0 &&
            op->sh % 8 == 0 && op->ss % 8 == 0;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_kernel<DH, SOFTCAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.sk + C::BK - 1) / C::BK, p.bhq / p.group);
    flash_bwd_tc_kernel<DH, SOFTCAP><<<grid, C::kThreads, C::kSmem, stream>>>(p, vec);
  } else {
    using C = BwdCfg<DH>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, DH, SOFTCAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.sk + C::BK - 1) / C::BK, p.bhq / p.group);
    flash_bwd_kernel<T, DH, SOFTCAP><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.bhq) * p.sq;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(p);
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
// forward's float32 [bhq, sq]; delta: float32 scratch [bhq, sq]; dq_acc:
// float32 scratch [bhq, sq, width], width = Dh padded to 64, 128 or 256
// (ops.py: bwd_width). window as the forward's. dtype: 0 float32, 1 bf16.
// Returns a cudaError_t (0 on success).
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
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  if (dh < 1 || dh > 256 || window < 1 || sq < 1 || sk < 1 || group < 1 || bhq % group ||
      bhq / group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_width<float>(p, st));
  if (dtype == 1) return static_cast<int>(launch_width<__nv_bfloat16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
