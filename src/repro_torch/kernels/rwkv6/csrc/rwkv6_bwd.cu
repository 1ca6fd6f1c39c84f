// Hand-written CUDA kernels for the gradient of the RWKV6 recurrence (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain chunked
// scan (src/repro/kernels/rwkv6/ops.py:15 rwkv6_chunked, reached from
// src/repro/models/ssm.py:202) with jax.grad. rwkv6.cu is the forward. With
// S_t the state before step t (S_0 = 0), S_{t+1} = diag(w_t) S_t + k_t v_t^T,
// out_t = S_t^T r_t + (r_t.(u k_t)) v_t and G_t = dL/dS_t (G_T = dS_T, zero
// unless the final state was used), for every step t:
//
//   dr_t = S_t do_t + (u k_t)(v_t.do_t)
//   dk_t = G_{t+1} v_t + (u r_t)(v_t.do_t)
//   dv_t = G_{t+1}^T k_t + (r_t.(u k_t)) do_t
//   dw_t = sum_j G_{t+1}[:, j] S_t[:, j]       (0 where w_t < kWMin: the clamp)
//   du   = sum_t (r_t k_t)(v_t.do_t)
//   G_t  = diag(w_t) G_{t+1} + r_t do_t^T
//
// ../ref.py::rwkv6_bwd_split_ref is this design's arithmetic in plain
// PyTorch (rwkv6_bwd_ref the same function, walked straight).
//
// Layout: r, k, w [BH, T, K] and v [BH, T, V], all float32 or all bfloat16,
// contiguous; u [BH, K] float32; dout [BH, T, V] float32; dS_T [BH, K, V]
// float32 or null; out: dr, dk, dw [BH, T, K] and dv [BH, T, V] of the
// inputs' dtype, du [BH, K] float32; scratch [2, BH, NC, 64, 64] and du_part
// [BH, NC, 64] float32, NC = ceil(T / kChunk). K and V are at most 64; T is
// any length >= 1. Decays are clamped at kWMin, as the forward clamps them.
//
// What bounds it on an H100: the float32 operations, about 14 BH*T*K*V of
// them at 67 TFLOP/s outside the tensor cores, above the bytes (each input
// read once, each gradient written once, at 3.35 TB/s).
//
// Design: T is split into chunks of kChunk = 32 steps, so that the work
// spreads over BH * NC blocks (16,384 at rwkv6-7b's BH = 128, T = 4,096)
// rather than one long walk a bh.
// 1. Boundary states (rwkv6_bwd_bounds_kernel). S at the start of every
//    chunk and G at the end of every chunk, both elementwise recurrences in
//    (i, j), chunk by chunk in matrix form: S_{c1} = D_c S_{c0} + sum_t
//    (k_t prod_{t<u<c1} w_u) v_t^T and G_{c0} = D_c G_{c1} + sum_t (r_t
//    prod_{c0<=u<t} w_u) do_t^T, D_c = prod_t w_t, every decay product
//    anchored at the chunk's end or start (none exceeds 1; nothing divides
//    by w). A block of 64 threads a (S or G, bh, 16 rows of the state), a
//    4 x 4 tile a thread: 16 FMAs per step per thread. 537 MB of scratch at
//    BH = 128, T = 4,096.
// 2. Chunk gradients (rwkv6_bwd_chunk_kernel), a block of 256 threads per
//    (bh, chunk), each thread a 4 x 4 tile of S and G: the per-step float32
//    arithmetic above from the chunk's S_{c0} and G_{c1}. The chunk goes as
//    two halves of 16 steps, the second first (its S from a walk over the
//    first), each as sub-chunks of kSub = 4 steps, last first: S is walked
//    from the half's start to the sub-chunk, its S_t kept in shared memory
//    (64 KB), dr's row sums taken for the four steps at once; then the
//    steps backwards with G, the row sums of two steps at once. Row sums by
//    a 16-lane reduce-scatter of shuffles (16 values, none wasted); column
//    sums over the warps in shared memory. At most 128 registers and 96 KB
//    of shared memory: two blocks (16 warps) an SM.
// 3. du (rwkv6_bwd_du_kernel): each block's partial sum of its chunk, then
//    their sum over the chunks in order: no atomics, the same bits every run.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 64;                 // K and V at most
constexpr int kTileDim = 4;                 // a thread's tile of S and G is 4 x 4
constexpr int kTiles = kMaxDim / kTileDim;  // row (and column) tiles
constexpr int kThreads = kTiles * kTiles;   // 256
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                  // steps a chunk (ops.py: BWD_CHUNK)
constexpr int kHalf = 16;                   // steps staged at a time by pass 2
constexpr int kSub = 4;                     // steps whose S_t pass 2 keeps at once
constexpr int kSlab = 16;                   // state rows a pass-1 block
constexpr int kBoundThreads = kSlab / kTileDim * kTiles;  // 64
constexpr float kWMin = 1e-12f;             // rwkv6.cu: kWMin
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPassBounds = 1, kPassChunks = 2, kPassDu = 4;  // the launcher's passes bits

static_assert(2 * kWarps == kHalf, "warp s sums steps 2s and 2s + 1's dot products");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Element (t, i) of a [BH, T, n] input as float32: 0 past T and n, or
// ``pad`` (w's 1: a padded step leaves S and G as they were).
template <typename T>
__device__ __forceinline__ float input(const T* __restrict__ x, int64_t bh, int64_t t,
                                       int64_t n_steps, int i, int n, float pad = 0.f) {
  return t < n_steps && i < n ? to_f32(x[(bh * n_steps + t) * n + i]) : pad;
}

// The scratch slot of (S or G, bh, chunk c): 64 x 64 float32, row-major.
__device__ __forceinline__ float* slot(float* scratch, int which, int64_t bh, int64_t bhs,
                                       int64_t chunks, int64_t c) {
  return scratch + ((which * bhs + bh) * chunks + c) * (kMaxDim * kMaxDim);
}

// ---------------------------------------------------------------------------
// Pass 1: boundary states
// ---------------------------------------------------------------------------

struct BoundSmem {
  float a[kChunk][kSlab];    // k_t (S) or r_t (G) times its decay product
  float b[kChunk][kMaxDim];  // v_t (S) or do_t (G)
  float w[kChunk][kSlab];    // clamped decays
  float decay[kSlab];        // the chunk's product of decays
};

// Block (which, bh, slab): which 0 walks S forward and writes S_{c0} of every
// chunk; which 1 walks G backward from dS_T and writes G_{c1} of every chunk.
template <typename T>
__global__ void __launch_bounds__(kBoundThreads) rwkv6_bwd_bounds_kernel(
    const T* __restrict__ r_g, const T* __restrict__ k_g, const T* __restrict__ v_g,
    const T* __restrict__ w_g, const float* __restrict__ do_g, const float* __restrict__ ds_g,
    float* __restrict__ scratch, int64_t bhs, int64_t n_steps, int kd, int vd) {
  __shared__ __align__(16) BoundSmem sm;
  const int tid = threadIdx.x;
  const int slab = blockIdx.x % (kMaxDim / kSlab);
  const int64_t bh = (blockIdx.x / (kMaxDim / kSlab)) % bhs;
  const int which = static_cast<int>(blockIdx.x / (kMaxDim / kSlab) / bhs);
  const int ra = tid / kTiles * kTileDim;        // the thread's first row in the slab
  const int i0 = slab * kSlab + ra, j0 = tid % kTiles * kTileDim;
  const int64_t chunks = (n_steps + kChunk - 1) / kChunk;
  const T* a_g = which == 0 ? k_g : r_g;

  float X[kTileDim][kTileDim];
#pragma unroll
  for (int a = 0; a < kTileDim; ++a)
#pragma unroll
    for (int b = 0; b < kTileDim; ++b) {
      const int i = i0 + a, j = j0 + b;
      X[a][b] = which == 1 && ds_g != nullptr && i < kd && j < vd ? ds_g[(bh * kd + i) * vd + j]
                                                                  : 0.f;
    }
  for (int64_t n = 0; n < chunks; ++n) {
    const int64_t c = which == 0 ? n : chunks - 1 - n, t0 = c * kChunk;
    float* out = slot(scratch, which, bh, bhs, chunks, c);
#pragma unroll
    for (int a = 0; a < kTileDim; ++a)
      *reinterpret_cast<float4*>(out + (i0 + a) * kMaxDim + j0) =
          make_float4(X[a][0], X[a][1], X[a][2], X[a][3]);
    for (int e = tid; e < kChunk * kSlab; e += kBoundThreads) {
      const int s = e / kSlab, i = e % kSlab;
      sm.a[s][i] = input(a_g, bh, t0 + s, n_steps, slab * kSlab + i, kd);
      sm.w[s][i] = fmaxf(input(w_g, bh, t0 + s, n_steps, slab * kSlab + i, kd, 1.f), kWMin);
    }
    for (int e = tid; e < kChunk * kMaxDim; e += kBoundThreads) {
      const int s = e / kMaxDim, j = e % kMaxDim;
      const int64_t t = t0 + s;
      sm.b[s][j] = which == 0 ? input(v_g, bh, t, n_steps, j, vd)
                              : (t < n_steps && j < vd ? do_g[(bh * n_steps + t) * vd + j] : 0.f);
    }
    __syncthreads();
    if (tid < kSlab) {  // each row's decay products, anchored at the chunk's end (S) or start (G)
      float run = 1.f;
      if (which == 0) {
        for (int s = kChunk - 1; s >= 0; --s) {
          sm.a[s][tid] *= run;
          run *= sm.w[s][tid];
        }
      } else {
        for (int s = 0; s < kChunk; ++s) {
          sm.a[s][tid] *= run;
          run *= sm.w[s][tid];
        }
      }
      sm.decay[tid] = run;
    }
    __syncthreads();
    const float4 d4 = ld4(&sm.decay[ra]);
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
    float acc[kTileDim][kTileDim] = {};
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) {
      const float4 a4 = ld4(&sm.a[s][ra]), b4 = ld4(&sm.b[s][j0]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < kTileDim; ++a)
#pragma unroll
        for (int b = 0; b < kTileDim; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kTileDim; ++a)
#pragma unroll
      for (int b = 0; b < kTileDim; ++b) X[a][b] = fmaf(d[a], X[a][b], acc[a][b]);
    __syncthreads();  // before the next chunk's stores overwrite the stage
  }
}

// ---------------------------------------------------------------------------
// Pass 2: each chunk's gradients
// ---------------------------------------------------------------------------

struct ChunkSmem {
  float r[kHalf][kMaxDim];
  float k[kHalf][kMaxDim];
  float w[kHalf][kMaxDim];       // clamped; 1 past T
  float v[kHalf][kMaxDim];
  float dout[kHalf][kMaxDim];
  float4 P[kSub][kTileDim][kThreads];  // S_t of the sub-chunk's steps, a thread's rows
  float rows[3][kSub][kMaxDim];  // each step's S do, G v and sum_j G S of each row
  float dv[kSub][kWarps][kMaxDim];  // each step's G^T k of each column, per warp
  float vdo[kHalf];              // v_t . do_t
  float ruk[kHalf];              // r_t . (u k_t)
  float u[kMaxDim];
};

// Sums v[0..15] over the 16 lanes whose ids differ only in bits 0..3,
// keeping half at each level: afterwards v[0] of the lane whose low bits
// read e holds the sum of entry e.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) {
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = up ? v[i] : v[i + m];
      const float keep = up ? v[i + m] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, m);
    }
  }
  return v[0];
}

// S <- diag(w) S + k v^T over the thread's tile at staged step s.
__device__ __forceinline__ void advance(float (&S)[kTileDim][kTileDim], const ChunkSmem& sm,
                                        int s, int i0, int j0) {
  const float4 w4 = ld4(&sm.w[s][i0]), k4 = ld4(&sm.k[s][i0]), v4 = ld4(&sm.v[s][j0]);
  const float w[4] = {w4.x, w4.y, w4.z, w4.w}, k[4] = {k4.x, k4.y, k4.z, k4.w};
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int a = 0; a < kTileDim; ++a)
#pragma unroll
    for (int b = 0; b < kTileDim; ++b) S[a][b] = fmaf(w[a], S[a][b], k[a] * v[b]);
}

__device__ __forceinline__ void load_tile(float (&X)[kTileDim][kTileDim], const float* src,
                                          int i0, int j0) {
#pragma unroll
  for (int a = 0; a < kTileDim; ++a) {
    const float4 x = ld4(src + (i0 + a) * kMaxDim + j0);
    X[a][0] = x.x;
    X[a][1] = x.y;
    X[a][2] = x.z;
    X[a][3] = x.w;
  }
}

// Steps [t0, t0 + kHalf) into shared memory (past T: zeros, w = 1), and
// each step's v.do and r.(u k), warp s taking steps 2s and 2s + 1.
template <typename T>
__device__ __forceinline__ void stage_half(ChunkSmem& sm, const T* __restrict__ r_g,
                                           const T* __restrict__ k_g, const T* __restrict__ v_g,
                                           const T* __restrict__ w_g,
                                           const float* __restrict__ do_g, int64_t bh, int64_t t0,
                                           int64_t n_steps, int kd, int vd) {
  __syncthreads();  // every thread is done with the last half's stage
  for (int e = threadIdx.x; e < kHalf * kMaxDim; e += kThreads) {
    const int s = e / kMaxDim, i = e % kMaxDim;
    const int64_t t = t0 + s;
    sm.r[s][i] = input(r_g, bh, t, n_steps, i, kd);
    sm.k[s][i] = input(k_g, bh, t, n_steps, i, kd);
    sm.w[s][i] = fmaxf(input(w_g, bh, t, n_steps, i, kd, 1.f), kWMin);
    sm.v[s][i] = input(v_g, bh, t, n_steps, i, vd);
    sm.dout[s][i] = t < n_steps && i < vd ? do_g[(bh * n_steps + t) * vd + i] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = 2 * warp + h;
    float vdo = sm.v[s][wl] * sm.dout[s][wl] + sm.v[s][wl + 32] * sm.dout[s][wl + 32];
    float ruk = sm.r[s][wl] * sm.u[wl] * sm.k[s][wl] +
                sm.r[s][wl + 32] * sm.u[wl + 32] * sm.k[s][wl + 32];
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      vdo += __shfl_xor_sync(kFull, vdo, m);
      ruk += __shfl_xor_sync(kFull, ruk, m);
    }
    if (wl == 0) {
      sm.vdo[s] = vdo;
      sm.ruk[s] = ruk;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) rwkv6_bwd_chunk_kernel(
    const T* __restrict__ r_g, const T* __restrict__ k_g, const T* __restrict__ v_g,
    const T* __restrict__ w_g, const float* __restrict__ u_g, const float* __restrict__ do_g,
    T* __restrict__ dr_g, T* __restrict__ dk_g, T* __restrict__ dv_g, T* __restrict__ dw_g,
    float* __restrict__ scratch, float* __restrict__ du_part, int64_t bhs, int64_t n_steps,
    int kd, int vd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int tid = threadIdx.x, wl = tid % 32, warp = tid / 32;
  const int ct = wl % kTiles;             // column tile
  const int rt = warp * 2 + wl / kTiles;  // row tile
  const int i0 = rt * kTileDim, j0 = ct * kTileDim;
  const int64_t chunks = (n_steps + kChunk - 1) / kChunk;
  const int64_t bh = blockIdx.x / chunks, c = blockIdx.x % chunks, c0 = c * kChunk;
  const int halves = (min(static_cast<int64_t>(kChunk), n_steps - c0) + kHalf - 1) / kHalf;

  if (tid < kMaxDim) sm.u[tid] = tid < kd ? u_g[bh * kd + tid] : 0.f;
  float G[kTileDim][kTileDim], S0[kTileDim][kTileDim];
  load_tile(G, slot(scratch, 1, bh, bhs, chunks, c), i0, j0);  // G_{c1}
  float du = 0.f;

  for (int h = halves - 1; h >= 0; --h) {
    const int64_t th = c0 + h * kHalf;
    load_tile(S0, slot(scratch, 0, bh, bhs, chunks, c), i0, j0);  // S_{c0}
    if (h == 1) {  // the second half's S: walk the first
      stage_half(sm, r_g, k_g, v_g, w_g, do_g, bh, c0, n_steps, kd, vd);
#pragma unroll 4
      for (int s = 0; s < kHalf; ++s) advance(S0, sm, s, i0, j0);
    }
    stage_half(sm, r_g, k_g, v_g, w_g, do_g, bh, th, n_steps, kd, vd);
    for (int q = kHalf / kSub - 1; q >= 0; --q) {
      const int sb = q * kSub;  // the sub-chunk's first staged step
      if (th + sb >= n_steps) continue;  // padded steps change nothing
      // S from the half's start to the sub-chunk, then its S_t into shared
      // memory, with dr's row sums S_t do_t of the four steps.
      float S[kTileDim][kTileDim];
#pragma unroll
      for (int a = 0; a < kTileDim; ++a)
#pragma unroll
        for (int b = 0; b < kTileDim; ++b) S[a][b] = S0[a][b];
      for (int s = 0; s < sb; ++s) advance(S, sm, s, i0, j0);
      float sums[16];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const float4 d4 = ld4(&sm.dout[sb + s][j0]);
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int a = 0; a < kTileDim; ++a) {
          sm.P[s][a][tid] = make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
          float x = 0.f;
#pragma unroll
          for (int b = 0; b < kTileDim; ++b) x = fmaf(S[a][b], dd[b], x);
          sums[4 * s + a] = x;
        }
        if (s + 1 < kSub) advance(S, sm, sb + s, i0, j0);
      }
      {
        const float x = reduce_scatter16(sums, wl);  // entry ct: step ct / 4, row ct % 4
        sm.rows[0][ct / 4][i0 + ct % 4] = x;
      }
      // The four steps backwards with G, two at a time: G v and sum_j G S_t
      // of each row, G^T k of each column, then G_t = diag(w) G + r do^T.
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const int e = s % 2 ? 0 : 8;  // the pair's later step fills entries 0-7
        const float4 w4 = ld4(&sm.w[sb + s][i0]), k4 = ld4(&sm.k[sb + s][i0]);
        const float4 r4 = ld4(&sm.r[sb + s][i0]);
        const float4 v4 = ld4(&sm.v[sb + s][j0]), d4 = ld4(&sm.dout[sb + s][j0]);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w}, k[4] = {k4.x, k4.y, k4.z, k4.w};
        const float r[4] = {r4.x, r4.y, r4.z, r4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        float col[kTileDim] = {};
#pragma unroll
        for (int a = 0; a < kTileDim; ++a) {
          const float4 p4 = sm.P[s][a][tid];
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          float gv = 0.f, gp = 0.f;
#pragma unroll
          for (int b = 0; b < kTileDim; ++b) {
            gv = fmaf(G[a][b], v[b], gv);
            gp = fmaf(G[a][b], pv[b], gp);
            col[b] = fmaf(G[a][b], k[a], col[b]);
            G[a][b] = fmaf(w[a], G[a][b], r[a] * dd[b]);
          }
          sums[e + a] = gv;
          sums[e + 4 + a] = gp;
        }
        // Over the warp's two row tiles (lane bit 4): each lane keeps two columns.
        const bool hi = wl & kTiles;
        float c0v = hi ? col[2] : col[0], c1v = hi ? col[3] : col[1];
        c0v += __shfl_xor_sync(kFull, hi ? col[0] : col[2], kTiles);
        c1v += __shfl_xor_sync(kFull, hi ? col[1] : col[3], kTiles);
        sm.dv[s][warp][j0 + (hi ? 2 : 0)] = c0v;
        sm.dv[s][warp][j0 + (hi ? 3 : 1)] = c1v;
        if (s % 2 == 0) {  // entry ct: step s + 1 - ct / 8; G v (ct % 8 < 4) or G.S; row ct % 4
          const float x = reduce_scatter16(sums, wl);
          sm.rows[1 + (ct / 4) % 2][s + 1 - ct / 8][i0 + ct % 4] = x;
        }
      }
      __syncthreads();
      // The sub-chunk's gradients, with the u terms: thread (step, channel).
      {
        const int s = tid / kMaxDim, i = tid % kMaxDim;
        const int64_t t = th + sb + s;
        const float vdo = sm.vdo[sb + s];
        if (t < n_steps) {
          if (i < kd) {
            const int64_t o = (bh * n_steps + t) * kd + i;
            dr_g[o] = from_f32<T>(sm.rows[0][s][i] + sm.u[i] * sm.k[sb + s][i] * vdo);
            dk_g[o] = from_f32<T>(sm.rows[1][s][i] + sm.u[i] * sm.r[sb + s][i] * vdo);
            dw_g[o] = from_f32<T>(to_f32(w_g[o]) >= kWMin ? sm.rows[2][s][i] : 0.f);
          }
          if (i < vd) {
            float sum = sm.ruk[sb + s] * sm.dout[sb + s][i];
#pragma unroll
            for (int q2 = 0; q2 < kWarps; ++q2) sum += sm.dv[s][q2][i];
            dv_g[(bh * n_steps + t) * vd + i] = from_f32<T>(sum);
          }
        }
      }
      if (tid < kMaxDim) {
#pragma unroll
        for (int s = 0; s < kSub; ++s)
          du = fmaf(sm.r[sb + s][tid] * sm.k[sb + s][tid], sm.vdo[sb + s], du);
      }
      __syncthreads();  // before the next sub-chunk's sums overwrite rows and dv
    }
  }
  if (tid < kMaxDim) du_part[(bh * chunks + c) * kMaxDim + tid] = du;
}

// Pass 3: du[bh, i] = sum over the chunks of their partial sums, in order.
__global__ void __launch_bounds__(256) rwkv6_bwd_du_kernel(const float* __restrict__ du_part,
                                                           float* __restrict__ du, int64_t bhs,
                                                           int64_t chunks, int kd) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= bhs * kd) return;
  const int64_t bh = e / kd;
  const int i = static_cast<int>(e % kd);
  float sum = 0.f;
  for (int64_t c = 0; c < chunks; ++c) sum += du_part[(bh * chunks + c) * kMaxDim + i];
  du[e] = sum;
}

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* dout, const float* ds, void* dr, void* dk,
                         void* dv, void* dw, float* du, float* scratch, float* du_part,
                         int64_t bh, int64_t n_steps, int kd, int vd, int passes,
                         cudaStream_t stream) {
  const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *wt = static_cast<const T*>(w);
  const int64_t chunks = (n_steps + kChunk - 1) / kChunk;
  const int64_t bound_blocks = 2 * bh * (kMaxDim / kSlab), chunk_blocks = bh * chunks;
  if (bound_blocks > 0x7fffffff || chunk_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (passes & kPassBounds) {
    rwkv6_bwd_bounds_kernel<T><<<static_cast<unsigned>(bound_blocks), kBoundThreads, 0,
                                 stream>>>(rt, kt, vt, wt, dout, ds, scratch, bh, n_steps, kd, vd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & kPassChunks) {
    constexpr size_t kSmem = sizeof(ChunkSmem);
    err = cudaFuncSetAttribute(rwkv6_bwd_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    rwkv6_bwd_chunk_kernel<T><<<static_cast<unsigned>(chunk_blocks), kThreads, kSmem, stream>>>(
        rt, kt, vt, wt, u, dout, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<T*>(dw), scratch, du_part, bh, n_steps, kd, vd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (passes & kPassDu) {
    rwkv6_bwd_du_kernel<<<static_cast<unsigned>((bh * kd + 255) / 256), 256, 0, stream>>>(
        du_part, du, bh, chunks, kd);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 r, k, v, w and their gradients; 1 = bfloat16. ds may be
// null (a zero dS_T). scratch: float32 [2, bh, ceil(T / 32), 64, 64];
// du_part: float32 [bh, ceil(T / 32), 64] (ops.py sizes both). passes: the
// passes to launch, bits 1 (boundary states), 2 (chunk gradients) and 4 (du);
// 7 computes the gradients, one bit alone times that pass on what the
// buffers hold. Returns a cudaError_t (0 = launched).
int rwkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                     const float* dout, const float* ds, void* dr, void* dk, void* dv, void* dw,
                     float* du, float* scratch, float* du_part, int64_t bh, int64_t n_steps,
                     int kd, int vd, int dtype, int passes, void* stream) {
  if (bh < 1 || bh > 0x7fffffff || n_steps < 1 || kd < 1 || kd > kMaxDim || vd < 1 ||
      vd > kMaxDim || (dtype != 0 && dtype != 1) || passes < 0 || passes > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(r, k, v, w, u, dout, ds, dr, dk, dv, dw, du, scratch,
                                       du_part, bh, n_steps, kd, vd, passes, st)
                 : launch_typed<__nv_bfloat16>(r, k, v, w, u, dout, ds, dr, dk, dv, dw, du,
                                               scratch, du_part, bh, n_steps, kd, vd, passes, st);
  return static_cast<int>(err);
}

}  // extern "C"
