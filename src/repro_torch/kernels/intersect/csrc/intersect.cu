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
// fused_extend, fused_verify and multiway_membership rely on the sorted,
// INVALID-padded slab and other rows (they read only each row's valid
// prefix, or stop a search where the row passes the target); the cands of
// multiway_membership may be in any order. lex_bounds relies on a
// lexicographically sorted key table (operators.join_prepare sorts it,
// INVALID rows last). On such inputs they equal ref.py exactly. The engine
// and the card tests feed only such inputs.
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
// fused_verify (a warp a row, 4 rows a block, so B = 1,024 rows are 256
// blocks over the 132 SMs): it reads a few hundred bytes a row, so no byte
// count bounds it; the chain of dependent loads does, each at L2's latency.
// A search of the whole padded row is 13 such loads a slab. The warp instead
// loads the target and every slab's addressing in one round (lane e slab e),
// then the first 128 entries of up to 4 slabs in the next (4 loads a lane,
// all in flight together) and ballots them against the target: a slab whose
// head holds it, or whose 128th entry is not below it (the row is sorted and
// INVALID-padded, so it lies nowhere after), is decided there. That is every
// slab of degree below 128 and all but a few of the rest. Only a slab whose
// 128th entry is still below the target goes on, by 32-way splits of
// [128, D) that also ballot each probe against the target (a probe equal to
// it ends the search; a range split to nothing means absent, with no last
// load): at most 3 more rounds at D = 4,608. A row stops at its first slab
// that lacks the target. What is left above that floor is not the search:
// 96 probes a round (2 rounds past the head instead of 3), and 8 or 16
// warps a block, measured no faster.
//
// multiway_membership (blocks of 256 threads that walk the rows b, 8 an SM,
// so a batch of 1,024 rows runs in one pass): its bound is the cands it must
// read (B*D int32) and the mask it must write (B*D bytes); the other rows
// it searches are read only through their valid prefixes. With one row a
// block and every block in flight at once, the kernel takes as long as one
// block's chain of dependent rounds, so a block first puts every load of
// its row in flight: the heads of the other rows (valid_length's first
// round, a warp a row) and the row's cands, copied 16 bytes at a time into
// shared memory by cp.async, a group of copies for each of a thread's (up
// to 5) vectors, so no register holds them while they land. A thread takes
// each of its own vectors as its group lands: 4 INVALID candidates (nearly
// all of a row: average degree ~10 against D = 4,608) are written 0 at
// once, as one 32-bit store of their 4 mask bytes (byte stores where a view
// of cands off 16 bytes puts them across a word); a vector holding a valid
// candidate waits. Then the block finds the valid lengths, stages each
// prefix that ends within its head from the registers that loaded it, the
// longer ones after them in order (whole, or as every 8th entry where the
// 2,048 int32 run short, then searched down to 8 entries in shared memory
// and those 8 read in one round; else in place), and searches the waiting
// vectors, the 4 candidates of a vector in 4 independent chains. The
// elements before the row's first 16-byte boundary and after its last one
// are read and written alone; a row longer than 1,152 vectors goes on in
// passes. It must fit 32 registers a thread (8 blocks an SM, one pass over
// 1,024 rows) without spilling; moving the staging ahead of the stream, or
// a branch that skips it, spilled and ran slower. cands need not be sorted
// or INVALID-padded; the other rows must be both, as the engine's adjacency
// rows are.
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
constexpr int kExtBlocksPerSm = 8;  // fused_extend and multiway_membership blocks an SM holds at once
constexpr int kLexWarps = 8;  // queries a block of lex_bounds
constexpr int kVerWarps = 4;  // rows a block of fused_verify
constexpr int kVerGroup = 4;  // slabs whose heads fused_verify loads in one round
constexpr int kHead = 128;    // entries of a row's head: 4 loads a lane of a warp
// multiway_membership: 16-byte vectors of cands a pass holds in shared memory
// (a row of D = 4,608), the int32 of shared memory that stage the other
// rows' prefixes, the vectors of a pass a thread, and the stride of the
// sample staged of a prefix too long for the stage. 18 + 8 KB a block.
constexpr int kCandVec = 1152;
constexpr int kMemStage = 2048;
constexpr int kPerThread = (kCandVec + kThreads - 1) / kThreads;
constexpr int kSample = 8;
static_assert(kPerThread <= 5, "copies_landed_but waits on at most 5 groups");

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

// x in row[lo, hi) (row sorted, x not INVALID)? A warp's call: the splits of
// warp_lower_bound, each probe also compared with x. If x is in the range,
// the first position holding it is the bound; a round either probes it (an
// equal probe ends the search) or keeps it inside the narrowed range, whose
// upper end is a probe already seen to differ. So a range split to nothing
// means x is absent, and no load after the last round is needed.
__device__ bool warp_find(const int32_t* __restrict__ row, int lo, int hi, int32_t x,
                          int lane) {
  while (lo < hi) {
    const int n = hi - lo, step = probe_step(n, 32);
    const int32_t v = lane < n ? row[probe_pos(lo, n, step, lane, 32)] : kInvalid;
    if (__any_sync(kFull, v == x)) return true;
    narrow(lo, hi, step, __popc(__ballot_sync(kFull, v < x)), 32);
  }
  return false;
}

// The first kHead entries of a row, 4 loads a lane in flight together
// (INVALID past d, and everywhere for a forced-INVALID row, nullptr).
__device__ __forceinline__ void load_head(const int32_t* __restrict__ row, int d, int lane,
                                          int32_t (&v)[kHead / 32]) {
#pragma unroll
  for (int i = 0; i < kHead / 32; ++i) {
    const int p = i * 32 + lane;
    v[i] = row != nullptr && p < d ? row[p] : kInvalid;
  }
}

// Length of a row's valid prefix (the position of its first INVALID, or d;
// 0 for a forced-INVALID row), given its head v from load_head: most rows
// end there; the rest by 32-way splits. A warp's call; every lane gets the
// answer.
__device__ int head_length(const int32_t* __restrict__ row, int d, int lane,
                           const int32_t (&v)[kHead / 32]) {
  if (row == nullptr) return 0;
#pragma unroll
  for (int i = 0; i < kHead / 32; ++i) {
    const unsigned m = __ballot_sync(kFull, v[i] == kInvalid);
    if (m != 0) return i * 32 + __ffs(m) - 1;
  }
  return warp_lower_bound(row, kHead, d, kInvalid, lane);
}

__device__ int valid_length(const int32_t* __restrict__ row, int d, int lane) {
  int32_t v[kHead / 32];
  load_head(row, d, lane, v);
  return head_length(row, d, lane, v);
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

// A warp a row: rows[b, vpos] is valid and a member of every slab (see the
// note at the top).
__global__ void __launch_bounds__(kVerWarps * 32) fused_verify_kernel(
    const int32_t* __restrict__ tab0, const int32_t* __restrict__ tab1,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ ok, const int32_t* __restrict__ rows,
    uint8_t* __restrict__ out, int64_t n_rows, int n_ext, int k, int64_t d,
    int vpos) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kVerWarps + (threadIdx.x >> 5);
  if (b >= n_rows) return;  // the whole warp
  const int64_t n_be = n_rows * n_ext;
  const int width = static_cast<int>(d);
  const int32_t t = rows[b * k + vpos];
  bool m = true;
  for (int e0 = 0; m && e0 < n_ext; e0 += 32) {
    // 1. the addressing of slab e0 + lane, its loads issued with the target's
    const int64_t be = b * n_ext + e0 + lane;
    const int32_t* row = nullptr;
    if (e0 + lane < n_ext) {
      const int32_t o = ok[be], s = sel[be], i0 = idx[be], i1 = idx[n_be + be];
      row = o != 1 ? nullptr : s == 1 ? tab0 + i0 * d : tab1 + i1 * d;
    }
    m = t != kInvalid;  // compared only here, so the loads above need not wait on it
    const int n = min(32, n_ext - e0);
    for (int g = 0; m && g < n; g += kVerGroup) {
      // 2. the heads of kVerGroup slabs, every load in flight together
      const int32_t* r[kVerGroup];
      int32_t v[kVerGroup][kHead / 32];
#pragma unroll
      for (int j = 0; j < kVerGroup; ++j) {
        r[j] = reinterpret_cast<const int32_t*>(__shfl_sync(
            kFull, reinterpret_cast<unsigned long long>(row), (g + j) & 31));
        if (g + j >= n) r[j] = nullptr;
        load_head(r[j], width, lane, v[j]);
      }
      // 3. each slab decided by its head, or searched past it
#pragma unroll
      for (int j = 0; j < kVerGroup; ++j) {
        if (!m || g + j >= n) break;
        if (r[j] == nullptr) {
          m = false;  // forced to INVALID
          break;
        }
        bool hit = false;
#pragma unroll
        for (int i = 0; i < kHead / 32; ++i) hit |= v[j][i] == t;
        if (__any_sync(kFull, hit)) continue;
        // the 128th entry below the target: it may lie further on
        const bool below = __shfl_sync(kFull, v[j][kHead / 32 - 1] < t, 31);
        m = below && width > kHead && warp_find(r[j], kHead, width, t, lane);
      }
    }
  }
  if (lane == 0) out[b] = m ? 1 : 0;
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

struct Other {
  int32_t len;   // valid prefix
  int32_t at;    // offset of the staged prefix (or of its sample) in s_stage, or -1: in place
  int32_t step;  // 1: the prefix is staged; kSample: every kSample-th entry is
};

// x in other row `row` of valid length o.len (x not INVALID), staged as `o`
// says: a staged prefix is searched in shared memory; a sampled one there
// down to kSample entries, which are then read from device memory in one
// round of independent loads; any other in place.
__device__ __forceinline__ bool member_of(const Other& o, const int32_t* __restrict__ stage,
                                          const int32_t* __restrict__ row, int32_t x) {
  if (o.at < 0) return member(row, o.len, x);
  const int32_t* s = stage + o.at;
  if (o.step == 1) return member(s, o.len, x);
  const int i = lower_bound(s, (o.len + kSample - 1) / kSample, x + 1) - 1;  // last sample <= x
  if (i < 0) return false;
  if (s[i] == x) return true;
  const int lo = i * kSample + 1, hi = min(lo + kSample - 1, o.len);
  bool hit = false;
#pragma unroll
  for (int q = 0; q < kSample - 1; ++q) hit |= lo + q < hi && row[lo + q] == x;
  return hit;
}

// 16 bytes from device memory into shared memory, asynchronously (cp.async;
// both addresses 16-byte aligned); the copies a thread issues between two
// commits form a group, and a thread waits only for its own copies.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void copies_landed() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n of this thread's latest groups of copies are in
// flight (n a constant once the caller's loop is unrolled).
__device__ __forceinline__ void copies_landed_but(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// m[u] &= x[u] in other row `row`, for the 4 candidates of a vector. A
// staged prefix is searched for all 4 at once, branch-free (4 independent
// chains of shared-memory loads): base ends at the last entry <= x, or at 0.
__device__ __forceinline__ void members4(const Other& o, const int32_t* __restrict__ stage,
                                         const int32_t* __restrict__ row, const int32_t (&x)[4],
                                         bool (&m)[4]) {
  if (o.at < 0 || o.step != 1 || o.len == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) m[u] = m[u] && o.len > 0 && member_of(o, stage, row, x[u]);
    return;
  }
  const int32_t* s = stage + o.at;
  int base[4] = {0, 0, 0, 0};
  for (int n = o.len; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int u = 0; u < 4; ++u) base[u] = s[base[u] + half] <= x[u] ? base[u] + half : base[u];
    n -= half;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) m[u] = m[u] && s[base[u]] == x[u];
}

// Blocks walk the rows b: out[b, j] = cands[b, j] valid and in every
// others[b, e] (see the note at the top); the grid is what fits on the card.
__global__ void __launch_bounds__(kThreads, kExtBlocksPerSm) multiway_membership_kernel(
    const int32_t* __restrict__ cands, const int32_t* __restrict__ others,
    uint8_t* __restrict__ out, int64_t n_rows, int n_other, int64_t d) {
  extern __shared__ int4 s_dyn[];  // [kCandVec] vectors of cands, then Other[n_other]
  __shared__ int32_t s_stage[kMemStage];
  int4* s_cand = s_dyn;
  Other* s_other = reinterpret_cast<Other*>(s_dyn + kCandVec);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = static_cast<int>(d);
  const int n_slots = min(n_other, kExtWarps);  // other rows whose heads have a slot in s_stage
  for (int64_t b = blockIdx.x; b < n_rows; b += gridDim.x) {
    const int32_t* crow = cands + b * d;
    const int32_t* orow = others + b * n_other * d;
    uint8_t* mrow = out + b * d;
    // The row as 16-byte vectors: `head` elements before its first 16-byte
    // boundary, n_vec vectors, then the tail; the elements outside vectors
    // (at most 6) go one to a thread. `words`: every 4 mask bytes of a
    // vector are one aligned 32-bit word (so for every vector, or for none).
    const int head =
        min(width, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(crow) & 15)) & 15) / 4));
    const int n_vec = (width - head) / 4;
    const int tail = head + 4 * n_vec;
    const bool words = (reinterpret_cast<uintptr_t>(mrow + head) & 3) == 0;
    const int edge = tid < head ? tid : tail + tid - head;  // this thread's element outside vectors
    const bool has_edge = tid < head + width - tail;
    const int4* cvec = reinterpret_cast<const int4*>(crow + head);
    // A pass copies up to kCandVec vectors, vector j by thread j % kThreads.
    auto copy_pass = [&](int t0, int tn) {
      for (int j = tid; j < tn; j += kThreads) copy16_async(s_cand + j, cvec + t0 + j);
    };
    auto put = [&](int t0, int j, bool m0, bool m1, bool m2, bool m3) {  // mask bytes of vector t0 + j
      uint8_t* mq = mrow + head + 4 * (t0 + j);
      if (words) {
        *reinterpret_cast<uint32_t*>(mq) = static_cast<uint32_t>(m0) |
            static_cast<uint32_t>(m1) << 8 | static_cast<uint32_t>(m2) << 16 |
            static_cast<uint32_t>(m3) << 24;
      } else {
        mq[0] = m0;
        mq[1] = m1;
        mq[2] = m2;
        mq[3] = m3;
      }
    };

    // 1. every load that waits on nothing, issued together: the head of
    // other row `warp` (valid_length's first round), this thread's element
    // outside vectors, and its vectors of the row's first pass into s_cand,
    // each its own group of copies
    const int32_t* hrow = warp < n_other ? orow + warp * d : nullptr;
    int32_t hv[kHead / 32];
    load_head(hrow, width, lane, hv);
    const int32_t c_edge = has_edge ? crow[edge] : kInvalid;
    const int tn0 = min(n_vec, kCandVec);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = tid + i * kThreads;
      if (j < tn0) copy16_async(s_cand + j, cvec + j);
      commit_copies();
    }
    // 2. each of this thread's vectors as it lands: 4 INVALID candidates
    // are 0 at once; a vector holding a valid one waits (bit i) for the
    // staged prefixes
    unsigned waiting = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = tid + i * kThreads;
      copies_landed_but(kPerThread - 1 - i);
      if (j < tn0) {
        const int4 c = s_cand[j];
        if (c.x == kInvalid && c.y == kInvalid && c.z == kInvalid && c.w == kInvalid) {
          put(0, j, false, false, false, false);
        } else {
          waiting |= 1u << i;
        }
      }
    }

    // 3. valid lengths of the other rows, a warp a row; a prefix within its
    // head is staged from the registers that hold it, in the warp's slot
    if (hrow != nullptr) {
      const int len = head_length(hrow, width, lane, hv);
      if (lane == 0) s_other[warp].len = len;
      if (len <= kHead) {
#pragma unroll
        for (int i = 0; i < kHead / 32; ++i) s_stage[warp * kHead + i * 32 + lane] = hv[i];
      }
    }
    for (int e = warp + kExtWarps; e < n_other; e += kExtWarps) {
      const int len = valid_length(orow + e * d, width, lane);
      if (lane == 0) s_other[e].len = len;
    }
    __syncthreads();

    // 4. the longer valid prefixes staged in order after the slots, whole
    // where they fit, else as a sample of every kSample-th entry where that
    // fits (every thread places them alike)
    int used = n_slots * kHead;
    for (int e = 0; e < n_other; ++e) {
      const int len = s_other[e].len;
      int at = e * kHead, step = 1;
      if (e >= n_slots || len > kHead) {
        step = len <= kMemStage - used ? 1 : kSample;
        const int n = (len + step - 1) / step;
        at = n <= kMemStage - used ? used : -1;
        if (at >= 0) {
          for (int j = tid; j < n; j += kThreads) s_stage[at + j] = orow[e * d + j * step];
          used += n;
        }
      }
      if (tid == 0) {
        s_other[e].at = at;
        s_other[e].step = step;
      }
    }

    // 5. the waiting vectors, the 4 candidates of each searched together in
    // every prefix, their 4 mask bytes written together
    auto keep = [&](int32_t c) -> bool {
      if (c == kInvalid) return false;
      for (int e = 0; e < n_other; ++e) {
        if (!member_of(s_other[e], s_stage, orow + e * d, c)) return false;
      }
      return true;
    };
    auto search = [&](int t0, int j) {  // vector t0 + j, in s_cand[j]
      const int4 c = s_cand[j];
      const int32_t x[4] = {c.x, c.y, c.z, c.w};
      bool m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) m[u] = x[u] != kInvalid;
      for (int e = 0; (m[0] || m[1] || m[2] || m[3]) && e < n_other; ++e) {
        members4(s_other[e], s_stage, orow + e * d, x, m);
      }
      put(t0, j, m[0], m[1], m[2], m[3]);
    };
    __syncthreads();  // s_stage and s_other[].at complete
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if ((waiting >> i) & 1u) search(0, tid + i * kThreads);
    }
    // Rows longer than kCandVec vectors: the rest in passes, each thread
    // reusing its own slots.
    for (int t0 = kCandVec; t0 < n_vec; t0 += kCandVec) {
      const int tn = min(kCandVec, n_vec - t0);
      copy_pass(t0, tn);
      copies_landed();
      for (int j = tid; j < tn; j += kThreads) search(t0, j);
    }
    if (has_edge) mrow[edge] = keep(c_edge) ? 1 : 0;
    __syncthreads();  // s_cand, s_other and s_stage are rewritten for the next row
  }
}

// Grid of the kernels whose blocks walk the rows: one block a row, at most
// what fits on the card at once (kExtBlocksPerSm an SM).
unsigned int row_walk_grid(int64_t n_rows) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t fit = static_cast<int64_t>(sms > 0 ? sms : 1) * kExtBlocksPerSm;
  return static_cast<unsigned int>(n_rows < fit ? n_rows : fit);
}

}  // namespace

extern "C" {

int fused_extend_launch(const int32_t* tab0, const int32_t* tab1, const int32_t* idx,
                        const int32_t* sel, const int32_t* ok, const int32_t* rows,
                        int32_t* cands, uint8_t* mask, int64_t n_rows, int n_ext,
                        int k, int64_t d, uint32_t lt_mask, uint32_t gt_mask,
                        void* stream) {
  const size_t slabs = sizeof(Slab) * static_cast<size_t>(n_ext);
  const unsigned int grid = row_walk_grid(n_rows);
  fused_extend_kernel<<<grid, kThreads, slabs, static_cast<cudaStream_t>(stream)>>>(
      tab0, tab1, idx, sel, ok, rows, cands, mask, n_rows, n_ext, k, d, lt_mask,
      gt_mask);
  return static_cast<int>(cudaGetLastError());
}

int fused_verify_launch(const int32_t* tab0, const int32_t* tab1, const int32_t* idx,
                        const int32_t* sel, const int32_t* ok, const int32_t* rows,
                        uint8_t* out, int64_t n_rows, int n_ext, int k, int64_t d,
                        int vpos, void* stream) {
  const unsigned int grid = static_cast<unsigned int>((n_rows + kVerWarps - 1) / kVerWarps);
  fused_verify_kernel<<<grid, kVerWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
  // All of an SM's L1 as shared memory, so kExtBlocksPerSm blocks fit (once).
  static const cudaError_t carved = cudaFuncSetAttribute(
      multiway_membership_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carved != cudaSuccess) return static_cast<int>(carved);
  const size_t smem = sizeof(int4) * kCandVec + sizeof(Other) * static_cast<size_t>(n_other);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(multiway_membership_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  multiway_membership_kernel<<<row_walk_grid(n_rows), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      cands, others, out, n_rows, n_other, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
