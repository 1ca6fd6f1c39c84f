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
// PyTorch version in ../ref.py. The TPU tiling (TILE_B=8 rows, 128-lane
// compare-any and compare-count grids) is not carried over: on this card a
// thread binary-searches a sorted row, which is O(log D) loads instead of
// O(D) compares.
//
// Contract shared with ref.py: adjacency rows and the cache slabs copied
// from them are sorted ascending and padded with INVALID (int32 max); all
// tensors are int32 and contiguous; masks are written as bytes (torch.bool).
// Slab addressing of the fused kernels, for row b and extension e:
//   slab[b, e] = tab0[idx[0, b, e]] if sel[b, e] == 1 else tab1[idx[1, b, e]],
//   and all INVALID where ok[b, e] != 1.
//
// What bounds them on an H100: bytes. None of them does arithmetic worth
// counting (no matmul, only compares). The fused extend must read each
// addressed slab (B*E rows of D int32) and write cands (B*D int32) and mask
// (B*D bytes); verify and lex_bounds read a few cache lines per search. The
// simple design here is one thread per output element with dependent global
// loads in each binary search, so it runs well below the byte bound: it is
// latency-bound on those loads. Staging slabs in shared memory, merging
// instead of searching, and skipping the INVALID tail of padded rows are the
// work of later changes.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Each launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalid = 0x7fffffff;
constexpr int kThreads = 256;

// First position p in row[0, d) with row[p] >= x (row sorted ascending).
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ row,
                                               int64_t d, int32_t x) {
  int64_t lo = 0, hi = d;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// x present in the sorted row? (The shared membership routine.)
__device__ __forceinline__ bool member(const int32_t* __restrict__ row, int64_t d,
                                       int32_t x) {
  const int64_t p = lower_bound(row, d, x);
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

// Grid (B, ceil(D / kThreads)): one thread per candidate slot (b, j).
__global__ void fused_extend_kernel(
    const int32_t* __restrict__ tab0, const int32_t* __restrict__ tab1,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ok, const int32_t* __restrict__ rows,
    int32_t* __restrict__ cands, uint8_t* __restrict__ mask, int64_t n_rows,
    int n_ext, int k, int64_t d, uint32_t lt_mask, uint32_t gt_mask) {
  const int64_t b = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (j >= d) return;
  const int64_t n_be = n_rows * n_ext;
  const int64_t out = b * d + j;

  const int32_t* s0 = slab_ptr(tab0, tab1, idx, sel, ok, n_be, d, b * n_ext);
  const int32_t c = s0 != nullptr ? s0[j] : kInvalid;
  cands[out] = c;
  bool m = c != kInvalid;  // an INVALID slot is done here
  for (int e = 1; m && e < n_ext; ++e) {
    const int32_t* s = slab_ptr(tab0, tab1, idx, sel, ok, n_be, d, b * n_ext + e);
    m = s != nullptr && member(s, d, c);
  }
  const int32_t* r = rows + b * k;
  for (int col = 0; m && col < k; ++col) {
    const int32_t v = r[col];
    m = c != v;  // injectivity
    if (m && ((lt_mask >> col) & 1u)) m = c < v;  // symmetry orders
    if (m && ((gt_mask >> col) & 1u)) m = c > v;
  }
  mask[out] = m ? 1 : 0;
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

// The search of ref.py's lex_bounds_ref, step for step: a fixed number of
// halvings (bit length of cap) with the probe row clamped into the table,
// so the result equals the plain version on every input, sorted or not.
__device__ __forceinline__ int32_t lex_search(const int32_t* __restrict__ keys,
                                              const int32_t* __restrict__ q,
                                              int32_t cap, int kk, int iters,
                                              bool upper) {
  int32_t lo = 0, hi = cap;
  for (int it = 0; it < iters; ++it) {
    const int32_t mid = (lo + hi) / 2;
    const int32_t row = mid < 0 ? 0 : (mid > cap - 1 ? cap - 1 : mid);
    const int cmp = lex_cmp(keys + static_cast<int64_t>(row) * kk, q, kk);
    const bool go_right = upper ? cmp <= 0 : cmp < 0;
    if (go_right) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One thread per query: lo = #(keys <lex q), hi = lo + #(keys ==lex q).
__global__ void lex_bounds_kernel(const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ queries,
                                  int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                                  int32_t cap, int kk, int64_t n_queries,
                                  int iters) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n_queries) return;
  const int32_t* q = queries + b * kk;
  lo[b] = lex_search(keys, q, cap, kk, iters, false);
  hi[b] = lex_search(keys, q, cap, kk, iters, true);
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
  const dim3 grid(static_cast<unsigned int>(n_rows), blocks(d));
  fused_extend_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  lex_bounds_kernel<<<blocks(n_queries), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(keys, queries, lo, hi, cap,
                                                           kk, n_queries, iters);
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
