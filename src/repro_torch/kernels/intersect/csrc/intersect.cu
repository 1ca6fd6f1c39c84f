// Hand-written CUDA kernels for the enumeration hot path (sm_90a).
//
// Four kernels replace the Pallas TPU kernels of the JAX package's
// src/repro/kernels/intersect/intersect.py:
//
//   fused_extend_kernel         <- fused_extend_kernel        (intersect.py:181)
//   fused_verify_kernel         <- fused_verify_kernel        (intersect.py:239)
//   lex_bounds_kernel           <- lex_bounds_kernel          (intersect.py:304)
//   multiway_membership_kernel  <- multiway_membership_kernel (intersect.py:84)
//
// Each computes what its TPU kernel computes, bit for bit equal to the plain
// PyTorch version in ../ref.py on the inputs the engine gives it. The TPU
// tiling (TILE_B=8 rows, 128-lane compare-any and compare-count grids) is not
// carried over: on this card a sorted row is searched, which is O(log D)
// loads instead of O(D) compares.
//
// Contract shared with ref.py: adjacency rows and the cache slabs copied
// from them are sorted ascending and padded with INVALID (int32 max), so a
// row is its valid prefix followed by INVALID only; all tensors are int32 and
// contiguous; masks are written as bytes (torch.bool). Slab addressing of the
// fused kernels, for row b and extension e:
//   slab[b, e] = tab0[idx[0, b, e]] if sel[b, e] == 1 else tab1[idx[1, b, e]],
//   and all INVALID where ok[b, e] != 1.
// fused_extend relies on the sorted, INVALID-padded rows (it reads only each
// slab's valid prefix) and lex_bounds on a lexicographically sorted key table
// (operators.join_prepare sorts it, INVALID rows last); on such inputs they
// equal ref.py exactly. The engine and the card tests feed only such inputs.
//
// What bounds them on an H100. None of them does arithmetic worth counting
// (no matmul, only compares), so bytes or the latency of dependent loads.
//
// fused_extend (blocks of 256 threads that walk the rows b): its byte bound
// is almost all the cands (B*D int32) and mask (B*D bytes) it must write;
// what it reads is the slabs' valid prefixes (average degree ~10 against
// D = 4608). So a block first writes its rows whole as if slab 0 were
// empty (INVALID and 0, 16-byte stores that wait on no load), then, row by
// row: loads the addressing once (its four loads issued together), finds
// each slab's valid length (a warp a slab: one 512-byte probe of the row's
// head, where most rows end, then 32-way splits of the rest), stages the
// valid prefixes of slabs 1..E-1 in shared memory (up to kStage int32
// together, in slab order; a slab that does not fit is searched in device
// memory, bounded by its length), and runs the candidates of slab 0's
// prefix, one a thread: the row filters from shared memory, then a binary
// search of each staged prefix. Their cands and mask bytes go out through
// shared memory in 16-byte stores over the first ones (the barriers between
// order the two writes). The stores that make the bound thus drain while
// the addressing and the searches wait on their loads. At most 32
// registers a thread, so 8 blocks fit an SM and the grid (what fits on the
// card at once, 1,056 blocks on an H100) holds a batch of 1,024 rows in one
// pass; the tail of a row past its prefix is never read.
//
// lex_bounds (a warp a query, 8 queries a block so the grid covers the
// SMs): a binary search is a chain of dependent loads (bit_length(CAP) = 21
// at CAP = 2^20, twice), so it is latency, not bytes, that bounds it. The
// warp narrows the range by 32-way splits instead, 32 lanes probing 32
// positions a round (2^20 keys take 4 rounds), and finds both bounds in the
// same rounds: each probe answers key < q and key <= q; once the two ranges
// part, 16 lanes follow each. It returns the true bounds, with one
// correction to match ref.py's fixed-count halving: a bound equal to CAP
// reads what that halving gives when every step goes right (CAP + 1 where it
// reaches CAP in fewer than bit_length(CAP) steps, e.g. CAP = 2, 4, 77,
// 1024, 2^20; CAP where it does not, e.g. 1, 3, 1023), computed once a
// launch on the host side of the launcher.
//
// fused_verify and multiway_membership are the first, simple designs: one
// thread per output with dependent global loads in each binary search.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Each launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kExtWarps = kThreads / 32;
constexpr int kTile = 1024;   // slab-0 candidates a pass of fused_extend
constexpr int kStage = 4096;  // int32 of shared memory for the other slabs' prefixes
constexpr int kExtBlocksPerSm = 8;  // fused_extend blocks an SM holds at once
constexpr int kLexWarps = 8;  // queries a block of lex_bounds

// First position p in row[0, d) with row[p] >= x (row sorted ascending).
template <typename I>
__device__ __forceinline__ I lower_bound(const int32_t* __restrict__ row, I d, int32_t x) {
  I lo = 0, hi = d;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// x present in the sorted row? (The shared membership routine; I is the
// index type: int64_t, or int where a row is known to be shorter than 2^31.)
template <typename I>
__device__ __forceinline__ bool member(const int32_t* __restrict__ row, I d, int32_t x) {
  const I p = lower_bound(row, d, x);
  return p < d && row[p] == x;
}

// Start of slab (b, e), or nullptr when the slab is forced to INVALID.
__device__ __forceinline__ const int32_t* slab_ptr(
    const int32_t* __restrict__ tab0, const int32_t* __restrict__ tab1,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ok, int64_t n_be, int64_t d, int64_t be) {
  if (ok[be] != 1) return nullptr;
  if (sel[be] == 1) return tab0 + static_cast<int64_t>(idx[be]) * d;
  return tab1 + static_cast<int64_t>(idx[n_be + be]) * d;
}

// ---------------------------------------------------------------------------
// Warp-wide many-way search. A range [lo, hi] holds a bound; the positions
// before it satisfy a monotone predicate ("before"), the rest do not. A round
// probes m positions of [lo, hi): every one if there are no more than m, else
// the multiples of step = n / (m + 1) past lo. The count c of probes that are
// before the bound (on sorted data the first c) narrows the range to a gap
// between two probes. Positions are 32-bit: D and CAP are below 2^30.
// ---------------------------------------------------------------------------

// step of a round over n > m positions: n / (m + 1), m = 32 or 16.
__device__ __forceinline__ int probe_step(int n, int m) {
  return m == 32 ? n / 33 : n / 17;
}

// Position of probe i of m over [lo, lo + n), n > 0.
__device__ __forceinline__ int probe_pos(int lo, int n, int step, int i, int m) {
  return n <= m ? lo + i : lo + (i + 1) * step;
}

__device__ __forceinline__ void narrow(int& lo, int& hi, int step, int c, int m) {
  if (hi - lo <= m) {  // every position was probed
    lo += c;
    hi = lo;
    return;
  }
  const int new_lo = c > 0 ? lo + c * step + 1 : lo;
  hi = c < m ? lo + (c + 1) * step : hi;
  lo = new_lo;
}

// First p in [lo, hi) with row[p] >= x, or hi (row sorted). A warp's call.
__device__ int warp_lower_bound(const int32_t* __restrict__ row, int lo, int hi,
                                int32_t x, int lane) {
  while (lo < hi) {
    const int n = hi - lo, step = probe_step(n, 32);
    const bool before = lane < n && row[probe_pos(lo, n, step, lane, 32)] < x;
    narrow(lo, hi, step, __popc(__ballot_sync(kFull, before)), 32);
  }
  return lo;
}

// Length of a slab's valid prefix (the position of its first INVALID, or d;
// 0 for a forced-INVALID slab). A warp's call; every lane gets the answer.
__device__ int valid_length(const int32_t* __restrict__ row, int d, int lane) {
  if (row == nullptr) return 0;
  // The row's first 512 bytes, 4 loads a lane in flight together: most rows
  // end there.
  int32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = i * 32 + lane;
    v[i] = p < d ? row[p] : kInvalid;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned m = __ballot_sync(kFull, v[i] == kInvalid);
    if (m != 0) return i * 32 + __ffs(m) - 1;
  }
  return warp_lower_bound(row, 128, d, kInvalid, lane);
}

// out[j] = val(j) for j in [0, n): 16-byte stores from the first 16-byte
// boundary on, single elements before it and after the last whole vector.
template <typename T, typename F>
__device__ __forceinline__ void store_range(T* __restrict__ out, int n, F val) {
  constexpr int kV = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int misaligned = static_cast<int>(reinterpret_cast<uintptr_t>(out) & 15);
  const int head = min(n, ((16 - misaligned) & 15) / static_cast<int>(sizeof(T)));
  const int n_vec = (n - head) / kV;
  for (int j = tid; j < head; j += kThreads) out[j] = val(j);
  for (int v = tid; v < n_vec; v += kThreads) {
    const int j = head + v * kV;
    union {
      T e[kV];
      int4 v4;
    } u;
#pragma unroll
    for (int i = 0; i < kV; ++i) u.e[i] = val(j + i);
    *reinterpret_cast<int4*>(out + j) = u.v4;
  }
  for (int j = head + n_vec * kV + tid; j < n; j += kThreads) out[j] = val(j);
}

struct Slab {
  const int32_t* row;  // nullptr: forced to INVALID
  int32_t len;         // valid prefix
  int32_t at;          // offset of the staged prefix in s_stage, or -1: searched in place
};

// Blocks walk the rows b (see the note at the top); the grid is what fits
// on the card at once.
__global__ void __launch_bounds__(kThreads, kExtBlocksPerSm) fused_extend_kernel(
    const int32_t* __restrict__ tab0, const int32_t* __restrict__ tab1,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ok, const int32_t* __restrict__ rows,
    int32_t* __restrict__ cands, uint8_t* __restrict__ mask, int64_t n_rows,
    int n_ext, int k, int64_t d, uint32_t lt_mask, uint32_t gt_mask) {
  extern __shared__ Slab s_slab[];  // [n_ext]
  __shared__ int32_t s_stage[kStage];
  __shared__ int32_t s_cand[kTile];
  __shared__ uint8_t s_mask[kTile];
  __shared__ int32_t s_rows[32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n_be = n_rows * n_ext;

  // 0. the block's rows as if slab 0 were empty, INVALID and 0: stores that
  // wait on no load, issued first; slab 0's valid prefix is written over
  // them in 5, by the same block
  const int width = static_cast<int>(d);
  for (int64_t b = blockIdx.x; b < n_rows; b += gridDim.x) {
    store_range(cands + b * d, width, [](int) { return kInvalid; });
    store_range(mask + b * d, width, [](int) { return static_cast<uint8_t>(0); });
  }

  for (int64_t b = blockIdx.x; b < n_rows; b += gridDim.x) {
    // 1. the row's addressing (its loads issued together) and partial match
    for (int e = tid; e < n_ext; e += kThreads) {
      const int64_t be = b * n_ext + e;
      const int32_t o = ok[be], s = sel[be], i0 = idx[be], i1 = idx[n_be + be];
      s_slab[e].row = o != 1 ? nullptr : s == 1 ? tab0 + i0 * d : tab1 + i1 * d;
    }
    if (tid < k) s_rows[tid] = rows[b * k + tid];
    __syncthreads();

    // 2. valid lengths, a warp a slab
    for (int e = warp; e < n_ext; e += kExtWarps) {
      const int len = valid_length(s_slab[e].row, width, lane);
      if (lane == 0) s_slab[e].len = len;
    }
    __syncthreads();

    // 3. places in the stage, in slab order (n_ext is small)
    if (tid == 0) {
      int used = 0;
      for (int e = 1; e < n_ext; ++e) {
        const int len = s_slab[e].len;
        const bool fits = len <= kStage - used;
        s_slab[e].at = fits ? used : -1;
        used += fits ? len : 0;
      }
    }
    __syncthreads();

    // 4. stage the prefixes
    for (int e = 1; e < n_ext; ++e) {
      const Slab s = s_slab[e];
      if (s.at < 0) continue;
      for (int j = tid; j < s.len; j += kThreads) s_stage[s.at + j] = s.row[j];
    }
    const Slab s0 = s_slab[0];
    const int n0 = s0.len;
    __syncthreads();

    // 5. slab 0's valid prefix, kTile candidates a pass
    int32_t* crow = cands + b * d;
    uint8_t* mrow = mask + b * d;
    for (int t0 = 0; t0 < n0; t0 += kTile) {
      const int tn = n0 - t0 < kTile ? n0 - t0 : kTile;
      for (int j = tid; j < tn; j += kThreads) {
        const int32_t c = s0.row[t0 + j];  // valid: j < n0
        bool m = true;
        for (int col = 0; m && col < k; ++col) {
          const int32_t v = s_rows[col];
          m = c != v;  // injectivity
          if (m && ((lt_mask >> col) & 1u)) m = c < v;  // symmetry orders
          if (m && ((gt_mask >> col) & 1u)) m = c > v;
        }
        for (int e = 1; m && e < n_ext; ++e) {
          const Slab s = s_slab[e];
          m = member(s.at >= 0 ? s_stage + s.at : s.row, s.len, c);
        }
        s_cand[j] = c;
        s_mask[j] = m ? 1 : 0;
      }
      __syncthreads();
      store_range(crow + t0, tn, [&](int j) { return s_cand[j]; });
      store_range(mrow + t0, tn, [&](int j) { return s_mask[j]; });
      __syncthreads();
    }
  }
}

// One thread per row: rows[b, vpos] is valid and a member of every slab.
__global__ void fused_verify_kernel(
    const int32_t* __restrict__ tab0, const int32_t* __restrict__ tab1,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ok, const int32_t* __restrict__ rows,
    uint8_t* __restrict__ out, int64_t n_rows, int n_ext, int k, int64_t d,
    int vpos) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n_rows) return;
  const int64_t n_be = n_rows * n_ext;
  const int32_t t = rows[b * k + vpos];
  bool m = t != kInvalid;
  for (int e = 0; m && e < n_ext; ++e) {
    const int32_t* s = slab_ptr(tab0, tab1, idx, sel, ok, n_be, d, b * n_ext + e);
    m = s != nullptr && member(s, d, t);
  }
  out[b] = m ? 1 : 0;
}

// -1, 0, 1 as key <lex q, ==, >.
__device__ __forceinline__ int lex_cmp(const int32_t* __restrict__ key,
                                       const int32_t* __restrict__ q, int kk) {
  for (int c = 0; c < kk; ++c) {
    if (key[c] != q[c]) return key[c] < q[c] ? -1 : 1;
  }
  return 0;
}

// A warp a query: lo = #(keys <lex q), hi = lo + #(keys ==lex q), by 32-way
// splits, both bounds in the same rounds (see the note at the top). A bound
// equal to cap reads at_cap. KK > 0: that many key columns, held in
// registers; 0: kk columns, compared in place.
template <int KK>
__global__ void __launch_bounds__(kThreads) lex_bounds_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ queries,
    int32_t* __restrict__ lo_out, int32_t* __restrict__ hi_out, int32_t cap, int kk,
    int64_t n_queries, int32_t at_cap) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLexWarps + (threadIdx.x >> 5);
  if (b >= n_queries) return;  // the whole warp
  const int cols = KK > 0 ? KK : kk;
  const int32_t* q = queries + b * cols;
  int32_t qv[KK > 0 ? KK : 1];
#pragma unroll
  for (int c = 0; c < KK; ++c) qv[c] = q[c];
  int a0 = 0, a1 = cap;  // the lower bound's range
  int b0 = 0, b1 = cap;  // the upper bound's
  while (a0 < a1 || b0 < b1) {
    // Which range this lane probes (upper or not), as probe i of m.
    const bool joint = a0 == b0 && a1 == b1;
    const bool split = !joint && a0 < a1 && b0 < b1;
    const bool upper = split ? lane >= 16 : (!joint && a0 == a1);
    const int i = split ? lane & 15 : lane;
    const int m = split ? 16 : 32;
    const int lo = upper ? b0 : a0;
    const int n = (upper ? b1 : a1) - lo;
    const int step = probe_step(n, m);
    bool lt = false, le = false;
    if (i < n) {
      const int32_t* key = keys + static_cast<int64_t>(probe_pos(lo, n, step, i, m)) * cols;
      int cmp = 0;
      if constexpr (KK > 0) {
        int32_t kv[KK];
#pragma unroll
        for (int c = 0; c < KK; ++c) kv[c] = key[c];
#pragma unroll
        for (int c = KK - 1; c >= 0; --c) {  // the first column that differs decides
          if (kv[c] != qv[c]) cmp = kv[c] < qv[c] ? -1 : 1;
        }
      } else {
        cmp = lex_cmp(key, q, kk);
      }
      lt = cmp < 0;
      le = cmp <= 0;
    }
    const unsigned m_lt = __ballot_sync(kFull, lt), m_le = __ballot_sync(kFull, le);
    // Each range's own step (the ranges are equal when joint).
    const int step_a = probe_step(a1 - a0, m), step_b = probe_step(b1 - b0, m);
    if (split) {
      narrow(a0, a1, step_a, __popc(m_lt & 0xffffu), 16);
      narrow(b0, b1, step_b, __popc(m_le >> 16), 16);
    } else {
      if (!upper) narrow(a0, a1, step_a, __popc(m_lt), 32);
      if (upper || joint) narrow(b0, b1, step_b, __popc(m_le), 32);
    }
  }
  if (lane == 0) {
    lo_out[b] = a0 == cap ? at_cap : a0;
    hi_out[b] = b0 == cap ? at_cap : b0;
  }
}

// Grid (B, ceil(D / kThreads)): cands[b, j] valid and in every others[b, e].
__global__ void multiway_membership_kernel(const int32_t* __restrict__ cands,
                                           const int32_t* __restrict__ others,
                                           uint8_t* __restrict__ out, int n_other,
                                           int64_t d) {
  const int64_t b = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (j >= d) return;
  const int32_t c = cands[b * d + j];
  bool m = c != kInvalid;
  for (int e = 0; m && e < n_other; ++e) {
    m = member(others + (b * n_other + e) * d, d, c);
  }
  out[b * d + j] = m ? 1 : 0;
}

unsigned int blocks(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int fused_extend_launch(const int32_t* tab0, const int32_t* tab1, const int32_t* idx,
                        const int32_t* sel, const int32_t* ok, const int32_t* rows,
                        int32_t* cands, uint8_t* mask, int64_t n_rows, int n_ext,
                        int k, int64_t d, uint32_t lt_mask, uint32_t gt_mask,
                        void* stream) {
  const size_t slabs = sizeof(Slab) * static_cast<size_t>(n_ext);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t fit = static_cast<int64_t>(sms > 0 ? sms : 1) * kExtBlocksPerSm;
  const unsigned int grid = static_cast<unsigned int>(n_rows < fit ? n_rows : fit);
  fused_extend_kernel<<<grid, kThreads, slabs, static_cast<cudaStream_t>(stream)>>>(
      tab0, tab1, idx, sel, ok, rows, cands, mask, n_rows, n_ext, k, d, lt_mask,
      gt_mask);
  return static_cast<int>(cudaGetLastError());
}

int fused_verify_launch(const int32_t* tab0, const int32_t* tab1, const int32_t* idx,
                        const int32_t* sel, const int32_t* ok, const int32_t* rows,
                        uint8_t* out, int64_t n_rows, int n_ext, int k, int64_t d,
                        int vpos, void* stream) {
  fused_verify_kernel<<<blocks(n_rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tab0, tab1, idx, sel, ok, rows, out, n_rows, n_ext, k, d, vpos);
  return static_cast<int>(cudaGetLastError());
}

int lex_bounds_launch(const int32_t* keys, const int32_t* queries, int32_t* lo,
                      int32_t* hi, int32_t cap, int kk, int64_t n_queries, int iters,
                      void* stream) {
  // What ref.py's halving of `iters` steps returns when every step goes right.
  int64_t at_cap = 0, top = cap;
  for (int it = 0; it < iters; ++it) at_cap = (at_cap + top) / 2 + 1;
  const unsigned int grid =
      static_cast<unsigned int>((n_queries + kLexWarps - 1) / kLexWarps);
  auto kernel = kk == 1 ? lex_bounds_kernel<1>
              : kk == 2 ? lex_bounds_kernel<2>
              : kk == 3 ? lex_bounds_kernel<3>
                        : lex_bounds_kernel<0>;
  kernel<<<grid, kLexWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, queries, lo, hi, cap, kk, n_queries, static_cast<int32_t>(at_cap));
  return static_cast<int>(cudaGetLastError());
}

int multiway_membership_launch(const int32_t* cands, const int32_t* others,
                               uint8_t* out, int64_t n_rows, int n_other, int64_t d,
                               void* stream) {
  const dim3 grid(static_cast<unsigned int>(n_rows), blocks(d));
  multiway_membership_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cands, others, out, n_other, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
