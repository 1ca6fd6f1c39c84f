// Hand-written CUDA kernels for causal online-softmax (flash) attention (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_kernel of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py:89, body _kernel at
// l.32). For each query row i of each batch*head bh:
//
//   s_j   = (q_i . k_j) * scale                      scale = Dh^-1/2, float32
//   s_j   = softcap * tanh(s_j / softcap)            if softcap > 0
//   mask  : i + (Sk - Sq) >= j                       if causal
//           i + (Sk - Sq) - j < window                 always (window >= Sk + Sq: none)
//   out_i = sum_j p_j v_j / sum_j p_j,  p = exp(s - running max), masked p = 0
//
// The window is gemma2's sliding window, the mask q_pos - k_pos < window of
// the JAX model's _sdpa (src/repro/models/layers.py); the TPU kernel has
// none. The wrapper hands every form only the keys from the first one that
// row 0 sees (ops.py, visible_keys), so the decode and f32 forms' splits
// cover visible keys only; each form masks a row's lower edge beside its
// causal one, and the prefill form starts each block at the first tile its
// rows see, so a window of W keys costs about W keys a row, not Sk.
//
// with the running max initialised to -1e30 and a row that sees no key
// giving 0 (acc / max(l, 1e-30)), as the TPU kernel does. The output is in
// the inputs' dtype. Unlike the TPU kernel, any Sq, Sk >= 1 is taken (decode
// has Sq = 1), and any Dh <= 256.
//
// Operands are read through strides: element (b, h, s, d) of q, k, v and out
// lies at ptr + b*sb + h*sh + s*ss + d (d dense). Query row bh = b*hq + h
// reads KV row f = bh / group, i.e. (f / hkv, f % hkv): grouped-query
// attention with (batch, head) flattened batch-major.
//
// Three forms. The wrapper (ops.py, kernel_form) picks one from the dtype and
// the shape alone and passes it in; nothing here falls back to another. The
// bf16 forms read with TMA and 16-byte copies, so they take Dh % 8 == 0 and
// pointers and strides that are multiples of 16 bytes; the wrapper hands them
// an aligned copy of any other operand, padded with zeros to a Dh that is a
// multiple of 8 (the scale stays that of the true Dh).
//
// * prefill: bf16, Sq * group > 64 -> flash_fwd_kernel. Bound by the tensor
//   cores: 4*Dh flop per visible (query, key) pair at 989 TFLOP/s. The
//   design feeds them as Hopper wants. A block of three warpgroups takes 128
//   query rows of one bh. Warpgroups 0 and 1 (the consumers, 64 rows each)
//   run wgmma: S = Q K^T m64nBKk16 with Q and K read from shared memory
//   (K-major); the softcap, the causal mask and the online softmax on S in
//   registers; P rounded to bf16 in registers (the accumulator layout of S
//   is the A-operand layout of P V); O += P V m64nDHk16 with V read from
//   shared memory as an MN-major B operand (the descriptor's transpose bit;
//   no ldmatrix.trans). Each consumer issues tile n's S = Q K^T beside tile
//   n-1's O += P V and runs tile n's softmax while that product runs, and
//   the two consumers' products interleave on the tensor cores. One thread
//   of warpgroup 2 (the producer) keeps a ring of two K/V stages in flight
//   with TMA (tensor maps over the strided 4-D views, encoded by the
//   launcher on every call, 128-byte swizzled as the descriptors expect) and
//   mbarriers; each consumer warp frees a stage's K once S is computed and
//   its V once P V has landed. setmaxnreg moves registers from the producer
//   (40) to the consumers (232). Tiles that every row of a warpgroup sees
//   whole skip the mask; only tiles on the diagonal, at the window's lower
//   edge or at the Sk edge compute it, and a warpgroup skips tiles none of
//   its rows sees. A block's tiles start at the first its rows' window
//   reaches and end at its last row's diagonal. The
//   softmax spends one multiply-add and one ex2.approx per score (the scale
//   and log2 e folded together), and the softcap's tanh is compiled only
//   into the kernels that need it: with exp2f and a per-score softcap test
//   it ran 2.2x slower at granite's forward shape (H100 80GB HBM3 at 700 W;
//   PERF.md). Blocks go longest causal row range first, across all bh, and
//   stop at their last visible key tile. BK = 128 keys at Dh <= 128 and 64
//   at Dh = 256: 160 KB and 192 KB of shared memory.
// * decode: bf16, Sq * group <= 64 -> flash_decode_kernel, then
//   flash_merge_kernel when the keys are split. Bound by the bytes of K and
//   V, read once at 3.35 TB/s. One block per (KV row, key split): the group's
//   query heads and their Sq rows are packed into the rows of one tile, so a
//   KV head's keys are staged once (cp.async, 16 bytes a thread, zero-filled
//   past the split), not once per query head; the causal diagonal and the
//   window's lower edge are per row.
//   The wrapper sizes the splits so that about four blocks run on each SM.
//   Each block writes float32 partials (m, l, acc) per row to scratch that
//   the wrapper allocates; the merge kernel combines them by log-sum-exp (a
//   split a row sees nothing of has m = -1e30 and l = 0 and weighs nothing; a
//   row that sees no key at all still gives 0). A single split writes the
//   output itself. The rows are few, so mma.sync m16n8k16 serves.
// * f32: float32 -> flash_f32_kernel, on the CUDA cores in float32 FMA (the
//   tensor cores would round float32 to tf32, about 3 digits, against the
//   2e-5 tolerance). Bound by those operations: 4*Dh per visible (query, key)
//   pair at 67 TFLOP/s. A block takes 64 packed query rows of one KV head
//   (query head f*group + r/Sq, row r % Sq, as in the decode form), so a KV
//   head's keys are staged once for its whole group, and walks 32-key tiles
//   (64 at Dh = 256) of K and V in shared memory, each refilled by cp.async
//   as soon as its last reader is past a barrier, so one tile's loads run
//   under the other's products. A thread holds a 4 x 4 tile of S = Q K^T
//   (float4 reads of Q and K, Q stored in an order that puts a warp's rows
//   in distinct banks) and a 4 x (Dh/8) tile of O; the online softmax runs
//   in base 2 with the row max over the threads that share a row taken by
//   shuffles; P goes through shared memory. Tiles that every row sees whole
//   skip the mask; tiles no row sees are never loaded. When those blocks
//   alone would leave SMs idle (decode), the keys are split as in the decode
//   form and flash_merge_kernel<float> merges the splits. Times against
//   SDPA float32 at the model's shapes are in PERF.md (H100 80GB HBM3, 700 W).
//
// Times, bounds and the library's times at the model's shapes are in
// PERF.md (chip_smoke.py phase 9, H100 80GB HBM3 at 700 W).
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. cuTensorMapEncodeTiled
// is reached through cudaGetDriverEntryPoint, so nothing links libcuda. The
// launcher launches on the given stream, allocates nothing, and returns a
// cudaError_t.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Operand {  // element (b, h, s, d) at ptr + b*sb + h*sh + s*ss + d
  const void* ptr;
  int64_t sb, sh, ss;
};

struct Params {
  Operand q, k, v, o;
  int bhq;           // query rows: batch * hq
  int hq, hkv;       // heads per batch entry of q/out and of k/v
  int group;         // query heads per KV head
  int sq, sk, dh;
  float scale;
  float softcap;     // <= 0: none
  int causal;
  int window;        // row i sees keys j > i + sk - sq - window; >= sk + sq: no window
  float* lse;        // [bhq, sq]: each row's log-sum-exp of its scores, or nullptr
};

// A row's natural-log log-sum-exp from its running max m (base-2 units: the
// scores times log2 e) and its sum l of exp2(score - m); +inf for a row that
// sees no key, so that exp(s - lse) is 0 there (the backward's P).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : INFINITY;
}

// Writes row ``row`` of query row bh's log-sum-exp when the caller asked for it.
__device__ __forceinline__ void store_lse(const Params& p, int bh, int row, float m, float l) {
  if (p.lse != nullptr) p.lse[static_cast<int64_t>(bh) * p.sq + row] = row_lse(m, l);
}

__device__ __forceinline__ int64_t q_base(const Operand& op, int bh, int hq) {
  const int b = bh / hq, h = bh - b * hq;
  return static_cast<int64_t>(b) * op.sb + static_cast<int64_t>(h) * op.sh;
}

// KV row f = bh / group of a query row bh.
__device__ __forceinline__ int64_t kv_row_base(const Operand& op, int f, int hkv) {
  const int b = f / hkv, h = f - b * hkv;
  return static_cast<int64_t>(b) * op.sb + static_cast<int64_t>(h) * op.sh;
}

__device__ __forceinline__ uint32_t ld_smem32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b, mma.sync m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2, float& c3, uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// B fragment (k16 x n8) of V stored row-major [key][d] in shared memory:
// lanes 0-15 give the addresses of the 16 key rows, .trans hands each thread
// {V[2t][g], V[2t+1][g]} and {V[2t+8][g], V[2t+9][g]}.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(p)));
}

// Max over the 4 threads (a quad) that hold one row of an mma accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// prefill: warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

template <int DH>  // head width padded to 64, 128 or 256
struct FwdCfg {
  static constexpr int BQ = 128;                   // query rows a block: two consumer warpgroups
  static constexpr int BK = DH <= 128 ? 128 : 64;  // keys a tile
  static constexpr int STAGES = 2;                 // K/V tiles in the ring
  static constexpr int CB = DH / 64;               // 128-byte column blocks of a row
  static constexpr uint32_t Q_BYTES = BQ * DH * 2;
  static constexpr uint32_t KV_BYTES = BK * DH * 2;  // one K or one V tile
  static constexpr int kThreads = 384;             // warpgroups 0, 1: consumers; 2: producer
  // + 1024: the tiles start on the 1024-byte period of the 128-byte swizzle.
  static constexpr size_t kSmem = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};


// Softcap and (MASK) mask one tile of raw scores q.k in registers, update
// the rows' running max m and sum l, and leave P = exp2(x * c - m) in s,
// where x is the (soft-capped) score before the scale and c folds the scale
// and log2 e into one multiply-add; m is kept in those base-2 units. Element
// 4j + i of s is row a (+8 for i >= 2), key k0 + 8j + 2t + (i & 1); keys at
// or past lim_a / lim_b, and below lo_a / lo_b, are masked. alpha: the
// factor the rows' O must be scaled by.
template <bool MASK, bool SOFTCAP, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const Params& p, int k0,
                                               int t, int lo_a, int lim_a, int lo_b,
                                               int lim_b) {
  const float c = SOFTCAP ? kLog2e : p.scale * kLog2e;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[4 * j + i];
      if (SOFTCAP) x = p.softcap * tanhf(x * p.scale / p.softcap);
      const int key = k0 + 8 * j + 2 * t + (i & 1);
      if (MASK && (key >= (i < 2 ? lim_a : lim_b) || key < (i < 2 ? lo_a : lo_b))) x = -INFINITY;
      s[4 * j + i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
  // m starts at -1e30, so it stays finite and a masked score's exp2 is 0.
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * c);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = fast_exp2(fmaf(s[4 * j + i], c, neg_m[i >> 1]));
      s[4 * j + i] = e;
      sum[i >> 1] += e;
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// Barriers of the prefill form's ring, in static shared memory.
template <int STAGES>
struct FwdBars {
  uint64_t q_full;
  uint64_t k_full[STAGES], v_full[STAGES];    // a stage's K / V has landed
  uint64_t k_empty[STAGES], v_empty[STAGES];  // every consumer warp is done with it
};

// A consumer warpgroup: 64 query rows from row_lo, over the block's n_tiles
// K/V tiles (key tiles t0 .. t0 + n_tiles - 1; the ring counts them from 0)
// as the producer delivers them. Tile n's S = Q K^T is issued together with
// tile n-1's O += P V, and tile n's softmax runs while that product is in
// flight.
template <int DH, bool SOFTCAP>
__device__ __forceinline__ void fwd_consumer(const Params& p, uint32_t qs, uint32_t ks,
                                             uint32_t vs, FwdBars<FwdCfg<DH>::STAGES>& bar,
                                             int bh, int q0, int t0, int n_tiles) {
  using C = FwdCfg<DH>;
  constexpr int NS = C::BK / 2;  // S accumulators a thread: BK/8 n8 tiles x 4
  constexpr int NO = DH / 2;     // O accumulators a thread
  constexpr int KS = C::BK / 16;  // key steps of P V
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const int row_lo = q0 + 64 * wg;             // the warpgroup's first row
  const int row_a = row_lo + 16 * warp + g;    // the thread's rows: row_a and row_a + 8
  // Row r sees keys [lo(r), lim(r)). Global key tiles [plain_lo, plain_hi)
  // are seen whole by every row of the warpgroup; of the block's tiles the
  // warpgroup sees some key of [n_first, n_seen) only (block-relative).
  const int lim_a = p.causal ? min(p.sk, row_a + offset + 1) : p.sk;
  const int lim_b = p.causal ? min(p.sk, row_a + 8 + offset + 1) : p.sk;
  const int lo_a = row_a + offset - p.window + 1, lo_b = lo_a + 8;
  int plain_lo = 0, plain_hi = 0, n_first = 0, n_seen = 0;
  if (row_lo < p.sq) {
    const int row_hi = min(row_lo + 63, p.sq - 1);
    const int first = p.causal ? min(p.sk, row_lo + offset + 1) : p.sk;
    const int last = p.causal ? min(p.sk, row_hi + offset + 1) : p.sk;
    plain_lo = (max(0, row_hi + offset - p.window + 1) + C::BK - 1) / C::BK;
    plain_hi = max(first, 0) / C::BK;
    n_first = max(0, row_lo + offset - p.window + 1) / C::BK - t0;
    n_seen = min(n_tiles, (max(last, 0) + C::BK - 1) / C::BK - t0);
    if (n_seen <= n_first) n_first = n_seen = 0;
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // Q's rows of this warpgroup, K-major; a k16 step moves 32 bytes within a
  // 128-byte column block, four steps move to the next block.
  const uint64_t q_desc = gmma_desc(qs + wg * 64 * 128, 16, 1024);

  // Issue S = Q K^T of tile n (committed, not waited for).
  auto issue_qk = [&](int n, float (&s)[NS]) {
    const int st = n % C::STAGES;
    mbar_wait(&bar.k_full[st], (n / C::STAGES) & 1);
    const uint64_t k_desc = gmma_desc(ks + st * C::KV_BYTES, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t da = q_desc + (((kk >> 2) * C::BQ * 128 + (kk & 3) * 32) >> 4);
      const uint64_t db = k_desc + (((kk >> 2) * C::BK * 128 + (kk & 3) * 32) >> 4);
      if constexpr (C::BK == 128) {
        wgmma_ss_n128(s, da, db, kk > 0);
      } else {
        wgmma_ss_n64(s, da, db, kk > 0);
      }
    }
    wgmma_commit();
  };
  // Issue O += P V of tile n. V [key][d] lies in 64-column blocks of BK rows:
  // an MN-major B operand; a k16 step moves 16 rows; LBO: from one column
  // block to the next; SBO: 8 keys.
  auto issue_pv = [&](int n, uint32_t (&pa)[KS][4]) {
    const int st = n % C::STAGES;
    mbar_wait(&bar.v_full[st], (n / C::STAGES) & 1);
    const uint64_t v_desc = gmma_desc(vs + st * C::KV_BYTES, C::BK * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t db = v_desc + ((kk * 16 * 128) >> 4);
      if constexpr (DH == 64) {
        wgmma_rs_n64(o, pa[kk], db);
      } else if constexpr (DH == 128) {
        wgmma_rs_n128(o, pa[kk], db);
      } else {
        wgmma_rs_n256(o, pa[kk], db);
      }
    }
    wgmma_commit();
  };
  // Softmax of tile n's S in place (S becomes P in float32); only tiles at
  // the window's or the diagonal's edge compute the mask.
  auto softmax = [&](int n, float (&s)[NS], float (&alpha)[2]) {
    const int tile = t0 + n;
    if (tile < plain_lo || tile >= plain_hi) {
      online_softmax<true, SOFTCAP>(s, m, l, alpha, p, tile * C::BK, t, lo_a, lim_a, lo_b,
                                    lim_b);
    } else {
      online_softmax<false, SOFTCAP>(s, m, l, alpha, p, tile * C::BK, t, lo_a, lim_a, lo_b,
                                     lim_b);
    }
  };
  // A tile none of the warpgroup's rows sees: only released.
  auto release = [&](int n) {
    const int st = n % C::STAGES;
    const uint32_t parity = (n / C::STAGES) & 1;
    mbar_wait(&bar.k_full[st], parity);
    mbar_wait(&bar.v_full[st], parity);
    if (lane == 0) {
      mbar_arrive(&bar.k_empty[st]);
      mbar_arrive(&bar.v_empty[st]);
    }
  };
  // P in bf16: the accumulators of S tiles 2kk, 2kk+1 are the A fragment of
  // key step kk.
  auto pack = [&](const float (&s)[NS], uint32_t (&pa)[KS][4]) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  };

  // No register that an issued wgmma reads or writes is written by other
  // instructions before the wait that completes it: P is packed and O
  // rescaled only once the P V product that uses them has landed.
  mbar_wait(&bar.q_full, 0);
  for (int n = 0; n < n_first; ++n) release(n);
  if (n_seen > n_first) {
    float s[NS], alpha[2];
    uint32_t pa[KS][4];
    issue_qk(n_first, s);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&bar.k_empty[n_first % C::STAGES]);
    softmax(n_first, s, alpha);  // O is still 0: rescaling it by alpha changes nothing
    pack(s, pa);
    for (int n = n_first + 1; n < n_seen; ++n) {
      issue_qk(n, s);
      rescale(alpha);  // O of tiles < n-1, to tile n-1's running max
      issue_pv(n - 1, pa);
      wgmma_wait<1>();  // S of tile n has landed; P V of tile n-1 may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(&bar.k_empty[n % C::STAGES]);
      softmax(n, s, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      if (lane == 0) mbar_arrive(&bar.v_empty[(n - 1) % C::STAGES]);
      pack(s, pa);
    }
    rescale(alpha);
    issue_pv(n_seen - 1, pa);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&bar.v_empty[(n_seen - 1) % C::STAGES]);
  }
  for (int n = n_seen; n < n_tiles; ++n) release(n);

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(const_cast<void*>(p.o.ptr)) +
                      q_base(p.o, bh, p.hq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    const int row = row_a + 8 * r;
    if (row >= p.sq) continue;
    if (t == 0) store_lse(p, bh, row, m[r], lsum);
    __nv_bfloat16* orow = og + static_cast<int64_t>(row) * p.o.ss;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < p.dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// One block per (128 query rows, bh): all bh of the longest causal row
// range first, then the next (a KV row's query heads side by side).
template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(FwdCfg<DH>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Params p) {
  using C = FwdCfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ FwdBars<C::STAGES> bar;
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + C::Q_BYTES;
  const uint32_t vs = ks + C::STAGES * C::KV_BYTES;

  const int n_qblk = (p.sq + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x % p.bhq, qblk = blockIdx.x / p.bhq;
  const int q0 = (n_qblk - 1 - qblk) * C::BQ;  // the longest causal rows start first
  // Key tiles t0 .. t0 + n_tiles - 1: from the window's edge for row q0 to
  // the causal diagonal of the block's last row.
  int kv_end = p.sk;
  if (p.causal) kv_end = min(kv_end, min(q0 + C::BQ, p.sq) + p.sk - p.sq);
  const int t0 = max(0, q0 + p.sk - p.sq - p.window + 1) / C::BK;
  const int n_tiles = kv_end > 0 ? (kv_end + C::BK - 1) / C::BK - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(&bar.q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&bar.k_full[s], 1);
      mbar_init(&bar.v_full[s], 1);
      mbar_init(&bar.k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&bar.v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int qb = bh / p.hq, qh = bh - qb * p.hq;
      const int f = bh / p.group, kb = f / p.hkv, kh = f - kb * p.hkv;
      mbar_expect_tx(&bar.q_full, C::Q_BYTES);
      for (int c = 0; c < C::CB; ++c)
        tma_load(qs + c * C::BQ * 128, &tq, &bar.q_full, c * 64, q0, qh, qb);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % C::STAGES;
        const uint32_t parity = (n / C::STAGES - 1) & 1;  // tile n - STAGES released
        if (n >= C::STAGES) mbar_wait(&bar.k_empty[st], parity);
        mbar_expect_tx(&bar.k_full[st], C::KV_BYTES);
        for (int c = 0; c < C::CB; ++c)
          tma_load(ks + st * C::KV_BYTES + c * C::BK * 128, &tk, &bar.k_full[st], c * 64,
                   (t0 + n) * C::BK, kh, kb);
        if (n >= C::STAGES) mbar_wait(&bar.v_empty[st], parity);
        mbar_expect_tx(&bar.v_full[st], C::KV_BYTES);
        for (int c = 0; c < C::CB; ++c)
          tma_load(vs + st * C::KV_BYTES + c * C::BK * 128, &tv, &bar.v_full[st], c * 64,
                   (t0 + n) * C::BK, kh, kb);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    fwd_consumer<DH, SOFTCAP>(p, qs, ks, vs, bar, bh, q0, t0, n_tiles);
  }
}

// ---------------------------------------------------------------------------
// decode: split-KV kernel and its merge
// ---------------------------------------------------------------------------

template <int DH>  // head width padded to 64, 128 or 256
struct DecCfg {
  static constexpr int BK = DH <= 128 ? 64 : 32;  // keys a tile (ops.py: DECODE_TILE)
  static constexpr int LD = DH + 8;  // shared row stride in elements: conflict-free fragments
  static constexpr int kThreads = 128;  // warp w owns packed rows 16w..16w+15
  static constexpr size_t smem(int rows16, int stages) {
    return static_cast<size_t>(rows16 + 2 * stages * BK) * LD * sizeof(__nv_bfloat16);
  }
};

// n_valid of ``rows`` rows of a K or V tile into shared memory by cp.async,
// zero-filled past n_valid and past dh.
template <int DH>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int64_t ss, int rows, int n_valid, int dh) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < n_valid && c < dh;
    cp_async16(smem_u32(dst + r * LD + c), ok ? src + r * ss + c : src, ok);
  }
}

// One block per (split, KV row f): packed row r = (query head f*group + r/sq,
// query row r % sq), keys [split*split_keys, +split_keys). part_acc == null:
// one split, the block writes the output.
template <int DH>
__global__ void __launch_bounds__(DecCfg<DH>::kThreads)
flash_decode_kernel(Params p, int rows, int split_keys, int stages, float* part_acc,
                    float2* part_ml) {
  using C = DecCfg<DH>;
  constexpr int NT = C::BK / 8, ND = DH / 8, CH = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows16 = (rows + 15) & ~15;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv = qs + rows16 * C::LD;  // stage st: K at kv + 2*st*BK*LD, V after it
  const int split = blockIdx.x, f = blockIdx.y, nf = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const int k_lo = split * split_keys, k_hi = min(p.sk, k_lo + split_keys);
  const int n_tiles = (k_hi - k_lo + C::BK - 1) / C::BK;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q.ptr);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k.ptr) + kv_row_base(p.k, f, p.hkv);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v.ptr) + kv_row_base(p.v, f, p.hkv);
  for (int i = threadIdx.x; i < rows16 * CH; i += blockDim.x) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < rows && c < p.dh;
    const __nv_bfloat16* src = qg;
    if (ok) src += q_base(p.q, f * p.group + r / p.sq, p.hq) + (r % p.sq) * p.q.ss + c;
    cp_async16(smem_u32(qs + r * C::LD + c), src, ok);
  }
  auto issue = [&](int n, int st) {
    const int k0 = k_lo + n * C::BK, valid = min(C::BK, k_hi - k0);
    __nv_bfloat16* dst = kv + 2 * st * C::BK * C::LD;
    stage_async<DH>(dst, kg + k0 * p.k.ss, p.k.ss, C::BK, valid, p.dh);
    stage_async<DH>(dst + C::BK * C::LD, vg + k0 * p.v.ss, p.v.ss, C::BK, valid, p.dh);
  };
  issue(0, 0);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool live = warp * 16 < rows;
  const int ra = warp * 16 + g;  // the thread's packed rows: ra and ra + 8
  const int lim_a = p.causal ? min(k_hi, ra % p.sq + offset + 1) : k_hi;
  const int lim_b = p.causal ? min(k_hi, (ra + 8) % p.sq + offset + 1) : k_hi;
  const int lo_a = ra % p.sq + offset - p.window + 1;
  const int lo_b = (ra + 8) % p.sq + offset - p.window + 1;

  for (int n = 0; n < n_tiles; ++n) {
    const int st = stages == 2 ? (n & 1) : 0;
    if (stages == 2 && n + 1 < n_tiles) {
      issue(n + 1, (n + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const __nv_bfloat16* ks = kv + 2 * st * C::BK * C::LD;
      const __nv_bfloat16* vs = ks + C::BK * C::LD;
      float s[NT * 4];
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* qa = qs + (warp * 16 + g) * C::LD + kk * 16 + 2 * t;
        const uint32_t a0 = ld_smem32(qa), a1 = ld_smem32(qa + 8 * C::LD);
        const uint32_t a2 = ld_smem32(qa + 8), a3 = ld_smem32(qa + 8 * C::LD + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* kb = ks + (nt * 8 + g) * C::LD + kk * 16 + 2 * t;
          mma_bf16(s[4 * nt], s[4 * nt + 1], s[4 * nt + 2], s[4 * nt + 3], a0, a1, a2, a3,
                   ld_smem32(kb), ld_smem32(kb + 8));
        }
      }
      float alpha[2];
      if (p.softcap > 0.f) {
        online_softmax<true, true>(s, m, l, alpha, p, k_lo + n * C::BK, t, lo_a, lim_a, lo_b,
                                   lim_b);
      } else {
        online_softmax<true, false>(s, m, l, alpha, p, k_lo + n * C::BK, t, lo_a, lim_a, lo_b,
                                    lim_b);
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        const uint32_t a0 = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        const uint32_t a1 = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        const uint32_t a2 = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        const uint32_t a3 = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * C::LD;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + nd * 8);
          mma_bf16(o[nd][0], o[nd][1], o[nd][2], o[nd][3], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
    if (stages == 1 && n + 1 < n_tiles) {
      issue(n + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no tile

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int row = ra + 8 * r;
    if (row >= rows) continue;
    if (part_acc != nullptr) {
      const int64_t slot = (static_cast<int64_t>(split) * nf + f) * rows + row;
      float* dst = part_acc + slot * p.dh;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int c = nd * 8 + 2 * t;
        if (c < p.dh) *reinterpret_cast<float2*>(dst + c) = make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
      }
      if (t == 0) part_ml[slot] = make_float2(m[r], lsum);
    } else {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      if (t == 0) store_lse(p, f * p.group + row / p.sq, row % p.sq, m[r], lsum);
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(const_cast<void*>(p.o.ptr)) +
                            q_base(p.o, f * p.group + row / p.sq, p.hq) + (row % p.sq) * p.o.ss;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int c = nd * 8 + 2 * t;
        if (c < p.dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
      }
    }
  }
}

// One warp per (KV row, packed row): the splits' partials merged by
// log-sum-exp (base 2, as the partials' m), into an output of type T (the
// bf16 forms' or the float32 form's).
template <typename T>
__global__ void __launch_bounds__(128)
flash_merge_kernel(Params p, int rows, int splits, const float* part_acc, const float2* part_ml) {
  const int nf = p.bhq / p.group;
  const int idx = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (idx >= nf * rows) return;
  const int f = idx / rows, row = idx - f * rows;
  const int64_t first = static_cast<int64_t>(f) * rows + row, step = static_cast<int64_t>(nf) * rows;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[first + s * step].x);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[first + s * step];
    den += exp2f(ml.x - mx) * ml.y;
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  if (lane == 0) store_lse(p, f * p.group + row / p.sq, row % p.sq, mx, den);
  T* orow = static_cast<T*>(const_cast<void*>(p.o.ptr)) +
            q_base(p.o, f * p.group + row / p.sq, p.hq) + (row % p.sq) * p.o.ss;
  if constexpr (std::is_same<T, float>::value) {  // any Dh: one column a lane
    for (int c = lane; c < p.dh; c += 32) {
      float a = 0.f;
      for (int s = 0; s < splits; ++s) {
        const int64_t slot = first + s * step;
        a += exp2f(part_ml[slot].x - mx) * part_acc[slot * p.dh + c];
      }
      orow[c] = a * inv;
    }
  } else {  // Dh % 8 == 0: two columns a lane
    for (int c = 2 * lane; c < p.dh; c += 64) {
      float a0 = 0.f, a1 = 0.f;
      for (int s = 0; s < splits; ++s) {
        const int64_t slot = first + s * step;
        const float w = exp2f(part_ml[slot].x - mx);
        const float2 a = *reinterpret_cast<const float2*>(part_acc + slot * p.dh + c);
        a0 += w * a.x;
        a1 += w * a.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(a0 * inv, a1 * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, K/V tiles in shared memory, register micro-tiles
// ---------------------------------------------------------------------------

template <int DH>  // head width padded to 32, 64, 128 or 256
struct F32Cfg {
  static constexpr int BQ = 64;                   // packed query rows a block
  static constexpr int BK = DH == 256 ? 64 : 32;  // keys a tile (ops.py: f32_tile)
  static constexpr int KG = BK / 4;               // threads sharing a row, 4 keys of a tile each
  static constexpr int kThreads = BQ / 4 * KG;    // 16 row groups of 4 rows: 128 (256 at Dh 256)
  static constexpr int NC = DH / BK;              // float4 columns of O a thread holds
  static constexpr int LQ = DH + 4;               // Q and K row strides (floats): conflict-free
  static constexpr int LP = BQ + 4;               // P^T row stride
  static constexpr int kMinBlocks = DH == 256 ? 1 : 3;  // blocks an SM holds (shared memory)
  static constexpr size_t kSmem = static_cast<size_t>(BQ * LQ + BK * LQ + BK * DH + BK * LP) *
                                  sizeof(float);
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Element (r, c) of a tile of ``rows`` x DH floats into dst[r * ld + c] by
// cp.async, from row(r) + c; zero-filled where !ok(r) and past dh. ``vec``:
// 16-byte copies (dh % 4 == 0 and every row 16-byte aligned), else 4 bytes.
template <int DH, typename RowPtr, typename RowOk>
__device__ __forceinline__ void stage_f32(float* dst, int ld, int rows, int dh, bool vec,
                                          RowPtr row, RowOk ok) {
  const float* any = row(0);  // a valid address for the zero-filling copies
  if (vec) {
    constexpr int CH = DH / 4;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i - r * CH) * 4;
      const bool on = ok(r) && c < dh;
      cp_async16(smem_u32(dst + r * ld + c), on ? row(r) + c : any, on);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
      const int r = i / DH, c = i - r * DH;
      const bool on = ok(r) && c < dh;
      cp_async4(smem_u32(dst + r * ld + c), on ? row(r) + c : any, on);
    }
  }
}

// One block per (64 packed rows of KV row f, key split): packed row r = (query
// head f*group + r / sq, query row r % sq), as in the decode form, so a KV
// head's keys are staged once for its whole group. The thread (rg, kg) owns
// rows 4rg..4rg+3 and keys kg + KG*j (j < 4) of each tile: a 4 x 4 block of
// S = Q K^T in registers, from float4 reads of Q (stored in row order
// (r % 4) * 16 + r / 4, so the four row groups of a warp hit four banks) and
// of K; its rows' max and sum over the KG threads that share them by
// shuffles; P through shared memory as P^T; and a 4 x 4*NC block of O
// (columns 4kg + BK*c). K and V have one buffer each, refilled by cp.async
// as soon as the previous tile's last reader is past a barrier: tile n+1's K
// loads during tile n's softmax and P V, tile n+1's V during tile n+1's
// Q K^T. Tiles every row sees whole skip the mask, tiles no row sees (past
// the diagonal or before the window) are never loaded. part_acc == null:
// one split, the block writes the output; else float32 partials (acc; m, l)
// per row for flash_merge_kernel<float>.
template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(F32Cfg<DH>::kThreads, F32Cfg<DH>::kMinBlocks)
flash_f32_kernel(Params p, int rows, int split_keys, int vec, float* part_acc, float2* part_ml) {
  using C = F32Cfg<DH>;
  constexpr int KG = C::KG, NC = C::NC, BK = C::BK, LQ = C::LQ, LP = C::LP;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;                // [BQ][LQ]
  float* ks = qs + C::BQ * LQ;    // [BK][LQ]
  float* vs = ks + BK * LQ;       // [BK][DH]
  float* pt = vs + BK * DH;       // P^T: [BK][LP]

  const int nf = p.bhq / p.group, split = blockIdx.y;
  const int row_tiles = (rows + C::BQ - 1) / C::BQ;
  const int idx = blockIdx.x / nf, f = blockIdx.x - idx * nf;
  int tile = row_tiles - 1 - idx;  // the longest causal row ranges first
  if (p.sq % C::BQ == 0) {         // tiles lie within a head: its last tile first, every head
    const int per_head = p.sq / C::BQ;
    tile = (idx % p.group) * per_head + per_head - 1 - idx / p.group;
  }
  const int r0 = tile * C::BQ, r1 = min(rows, r0 + C::BQ);
  const int kg = threadIdx.x % KG, rg = threadIdx.x / KG;
  const int offset = p.sk - p.sq;
  const int k_lo = split * split_keys, k_hi = min(p.sk, k_lo + split_keys);

  // Keys [low[i], lim[i]) of the split are seen by the thread's row i. Of
  // the block's rows, the earliest (in its head) sees keys from ``from`` up
  // to ``lo``, the latest from ``whole`` up to ``hi``: tiles [n0, n_tiles)
  // hold every key some row sees, and tiles [n_whole, n_plain) are seen
  // whole by every row.
  int lim[4], low[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * rg + i;
    lim[i] = r >= rows ? k_lo : p.causal ? min(k_hi, r % p.sq + offset + 1) : k_hi;
    low[i] = r % p.sq + offset - p.window + 1;
  }
  const bool wraps = r0 / p.sq != (r1 - 1) / p.sq;
  const int first_row = wraps ? 0 : r0 % p.sq, last_row = wraps ? p.sq - 1 : (r1 - 1) % p.sq;
  int hi = k_hi, lo = k_hi;
  if (p.causal) {
    hi = min(k_hi, last_row + offset + 1);
    lo = min(k_hi, first_row + offset + 1);
  }
  const int from = max(k_lo, first_row + offset - p.window + 1);
  const int whole = max(k_lo, last_row + offset - p.window + 1);
  const int n_tiles = hi > k_lo ? (hi - k_lo + BK - 1) / BK : 0;
  const int n0 = min(n_tiles, (from - k_lo) / BK);
  const int n_whole = (whole - k_lo + BK - 1) / BK;
  const int n_plain = lo > k_lo ? (lo - k_lo) / BK : 0;

  const float* qg = static_cast<const float*>(p.q.ptr);
  const float* kg0 = static_cast<const float*>(p.k.ptr) + kv_row_base(p.k, f, p.hkv);
  const float* vg0 = static_cast<const float*>(p.v.ptr) + kv_row_base(p.v, f, p.hkv);
  stage_f32<DH>(
      qs, LQ, C::BQ, p.dh, vec,
      [&](int r) {  // stored row r -> packed row r0 + 4 * (r % 16) + r / 16
        const int pr = min(rows - 1, r0 + 4 * (r & 15) + (r >> 4));
        return qg + q_base(p.q, f * p.group + pr / p.sq, p.hq) + (pr % p.sq) * p.q.ss;
      },
      [&](int r) { return r0 + 4 * (r & 15) + (r >> 4) < rows; });
  auto issue = [&](float* dst, int ld, const float* base, int64_t ss, int n) {
    const int k0 = k_lo + n * BK, valid = min(BK, k_hi - k0);
    stage_f32<DH>(dst, ld, BK, p.dh, vec, [&](int r) { return base + (k0 + r) * ss; },
                  [&](int r) { return r < valid; });
  };
  if (n_tiles > n0) issue(ks, LQ, kg0, p.k.ss, n0);
  cp_async_commit();  // Q and K_n0
  if (n_tiles > n0) issue(vs, DH, vg0, p.v.ss, n0);
  cp_async_commit();  // V_n0

  float o[4][NC][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  }
  // A score in base 2: the scale and log2 e folded into one multiply.
  const float to_log2 = SOFTCAP ? kLog2e : p.scale * kLog2e;

  for (int n = n0; n < n_tiles; ++n) {
    cp_async_wait<1>();  // K_n has landed (V_n may still be in flight)
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (16 * i + rg) * LQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (kg + KG * j) * LQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with K_n: refill it with K_{n+1}
    if (n + 1 < n_tiles) issue(ks, LQ, kg0, p.k.ss, n + 1);
    cp_async_commit();

    const int k0 = k_lo + n * BK;
    const bool masked = n < n_whole || n >= n_plain;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (SOFTCAP) x = p.softcap * tanhf(x * p.scale / p.softcap);
        x *= to_log2;
        const int key = k0 + kg + KG * j;
        if (masked && (key >= lim[i] || key < low[i])) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < KG; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + kg + KG * j;
        const bool seen = !masked || (key < lim[i] && key >= low[i]);
        s[i][j] = seen ? exp2f(s[i][j] - mx) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[i][c][0] *= alpha;
        o[i][c][1] *= alpha;
        o[i][c][2] *= alpha;
        o[i][c][3] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (kg + KG * j) * LP + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    cp_async_wait<1>();  // V_n has landed (K_{n+1} may still be in flight)
    __syncthreads();     // and P^T is written
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(pt + j * LP + 4 * rg);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * DH + 4 * kg + BK * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c][0] = fmaf(pr[i], vv.x, o[i][c][0]);
          o[i][c][1] = fmaf(pr[i], vv.y, o[i][c][1]);
          o[i][c][2] = fmaf(pr[i], vv.z, o[i][c][2]);
          o[i][c][3] = fmaf(pr[i], vv.w, o[i][c][3]);
        }
      }
    }
    __syncthreads();  // every thread is done with V_n and P^T: refill V with V_{n+1}
    if (n + 1 < n_tiles) issue(vs, DH, vg0, p.v.ss, n + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no tile

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lsum = l[i];
#pragma unroll
    for (int off = 1; off < KG; off <<= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    const int r = r0 + 4 * rg + i;
    if (r >= rows) continue;
    float* dst;
    float scale = 1.f;
    if (part_acc != nullptr) {
      const int64_t slot = (static_cast<int64_t>(split) * nf + f) * rows + r;
      dst = part_acc + slot * p.dh;
      if (kg == 0) part_ml[slot] = make_float2(m[i], lsum);
    } else {
      dst = static_cast<float*>(const_cast<void*>(p.o.ptr)) +
            q_base(p.o, f * p.group + r / p.sq, p.hq) + (r % p.sq) * p.o.ss;
      scale = 1.f / fmaxf(lsum, 1e-30f);
      if (kg == 0) store_lse(p, f * p.group + r / p.sq, r % p.sq, m[i], lsum);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * kg + BK * c + e;
        if (col < p.dh) dst[col] = o[i][c][e] * scale;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DH, bool SOFTCAP>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  using C = FwdCfg<DH>;
  const int nf = p.bhq / p.group;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, p.q, p.dh, p.sq, p.hq, p.bhq / p.hq, C::BQ) ||
      !encode_operand(&tk, p.k, p.dh, p.sk, p.hkv, nf / p.hkv, C::BK) ||
      !encode_operand(&tv, p.v, p.dh, p.sk, p.hkv, nf / p.hkv, C::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_fwd_kernel<DH, SOFTCAP>, C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(p.bhq) * ((p.sq + C::BQ - 1) / C::BQ);
  flash_fwd_kernel<DH, SOFTCAP><<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_prefill(const Params& p, cudaStream_t stream) {
  return p.softcap > 0.f ? launch_fwd<DH, true>(p, stream) : launch_fwd<DH, false>(p, stream);
}

template <int DH>
cudaError_t launch_decode(const Params& p, int splits, int split_keys, float* part_acc,
                          float2* part_ml, cudaStream_t stream) {
  using C = DecCfg<DH>;
  const int rows = p.sq * p.group, nf = p.bhq / p.group;
  if (rows > 64 || splits < 1 || split_keys < 1 ||
      static_cast<int64_t>(splits) * split_keys < p.sk || (splits > 1 && part_acc == nullptr))
    return cudaErrorInvalidValue;
  const int stages = split_keys > C::BK ? 2 : 1;
  cudaError_t err = allow_smem(flash_decode_kernel<DH>, C::smem(64, 2));
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, nf);
  flash_decode_kernel<DH><<<grid, C::kThreads, C::smem((rows + 15) & ~15, stages), stream>>>(
      p, rows, split_keys, stages, splits > 1 ? part_acc : nullptr, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_merge_kernel<__nv_bfloat16><<<(nf * rows + 3) / 4, 128, 0, stream>>>(p, rows, splits,
                                                                             part_acc, part_ml);
  return cudaGetLastError();
}

template <int DH, bool SOFTCAP>
cudaError_t launch_f32_form(const Params& p, int splits, int split_keys, float* part_acc,
                            float2* part_ml, cudaStream_t stream) {
  using C = F32Cfg<DH>;
  const int rows = p.sq * p.group, nf = p.bhq / p.group;
  const int64_t blocks = static_cast<int64_t>(nf) * ((rows + C::BQ - 1) / C::BQ);
  if (splits < 1 || splits > 65535 || split_keys < 1 || blocks > 0x7fffffff ||
      static_cast<int64_t>(splits) * split_keys < p.sk || (splits > 1 && part_acc == nullptr))
    return cudaErrorInvalidValue;
  // 16-byte copies where every operand row allows them; else 4-byte copies.
  bool vec = p.dh % 4 == 0;
  for (const Operand* op : {&p.q, &p.k, &p.v})
    vec = vec && reinterpret_cast<uintptr_t>(op->ptr) % 16 == 0 && op->sb % 4 == 0 &&
          op->sh % 4 == 0 && op->ss % 4 == 0;
  cudaError_t err = allow_smem(flash_f32_kernel<DH, SOFTCAP>, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), splits);
  flash_f32_kernel<DH, SOFTCAP><<<grid, C::kThreads, C::kSmem, stream>>>(
      p, rows, split_keys, vec, splits > 1 ? part_acc : nullptr, part_ml);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_merge_kernel<float><<<(nf * rows + 3) / 4, 128, 0, stream>>>(p, rows, splits, part_acc,
                                                                     part_ml);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Params& p, int splits, int split_keys, float* part_acc,
                       float2* part_ml, cudaStream_t stream) {
  return p.softcap > 0.f
             ? launch_f32_form<DH, true>(p, splits, split_keys, part_acc, part_ml, stream)
             : launch_f32_form<DH, false>(p, splits, split_keys, part_acc, part_ml, stream);
}

enum Form { kFormF32 = 0, kFormPrefill = 1, kFormDecode = 2 };  // ops.py: FORMS

}  // namespace

// q, k, v, o: device pointers; strides: 12 host int64 values, (sb, sh, ss)
// of q, k, v and o in elements. window: row i sees keys j > i + sk - sq -
// window (sk + sq or more: no window). form: one of Form (ops.py picks it). Decode
// only: ``splits`` key splits of ``split_keys`` keys and, when splits > 1,
// float32 scratch part_acc [splits, BHq/group, Sq*group, Dh] and part_ml
// [splits, BHq/group, Sq*group, 2]. lse: nullptr, or float32 [BHq, Sq] that
// every form (the merge where the keys are split) fills with each query
// row's natural-log log-sum-exp of its scores, the backward's input.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const int64_t* strides, int bhq, int hq, int hkv,
                                      int group, int sq, int sk, int dh, float scale,
                                      float softcap, int causal, int window, int form,
                                      int splits,
                                      int split_keys, void* part_acc, void* part_ml,
                                      void* lse, void* stream) {
  Params p;
  const void* ptrs[4] = {q, k, v, o};
  Operand* ops[4] = {&p.q, &p.k, &p.v, &p.o};
  for (int i = 0; i < 4; ++i)
    *ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
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
  p.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dh > 256 || window < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case kFormPrefill:
      if (dh % 8) break;
      if (dh <= 64) return launch_prefill<64>(p, st);
      if (dh <= 128) return launch_prefill<128>(p, st);
      return launch_prefill<256>(p, st);
    case kFormDecode: {
      if (dh % 8) break;
      float* acc = static_cast<float*>(part_acc);
      float2* ml = static_cast<float2*>(part_ml);
      if (dh <= 64) return launch_decode<64>(p, splits, split_keys, acc, ml, st);
      if (dh <= 128) return launch_decode<128>(p, splits, split_keys, acc, ml, st);
      return launch_decode<256>(p, splits, split_keys, acc, ml, st);
    }
    case kFormF32: {
      float* acc = static_cast<float*>(part_acc);
      float2* ml = static_cast<float2*>(part_ml);
      if (dh <= 32) return launch_f32<32>(p, splits, split_keys, acc, ml, st);
      if (dh <= 64) return launch_f32<64>(p, splits, split_keys, acc, ml, st);
      if (dh <= 128) return launch_f32<128>(p, splits, split_keys, acc, ml, st);
      return launch_f32<256>(p, splits, split_keys, acc, ml, st);
    }
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
