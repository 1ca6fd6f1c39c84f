// Hand-written CUDA kernel for the gradient of the RWKV6 recurrence (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain chunked
// scan (src/repro/kernels/rwkv6/ops.py:15 rwkv6_chunked, reached from
// src/repro/models/ssm.py:202) with jax.grad. rwkv6.cu is the forward. With
// S_t = diag(w_t) S_{t-1} + k_t v_t^T, out_t = S_{t-1}^T r_t + (r_t.(u k_t)) v_t
// and G_t = dL/dS_t (G_T = dS_T, zero unless the final state was used),
// walking t from T down to 1:
//
//   dr_t = S_{t-1} do_t + (u k_t)(v_t.do_t)
//   dk_t = G_t v_t + (u r_t)(v_t.do_t)
//   dv_t = G_t^T k_t + (r_t.(u k_t)) do_t
//   dw_t = sum_j G_t[:, j] S_{t-1}[:, j]       (0 where w_t < kWMin: the clamp)
//   du   = sum_t (r_t k_t)(v_t.do_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T
//
// ../ref.py::rwkv6_bwd_ref is the same function in plain PyTorch.
//
// Layout: r, k, w [BH, T, K] and v [BH, T, V], all float32 or all bfloat16,
// contiguous; u [BH, K] float32; dout [BH, T, V] float32; dS_T [BH, K, V]
// float32 or null; out: dr, dk, dw [BH, T, K] and dv [BH, T, V] of the
// inputs' dtype, du [BH, K] float32; scratch [BH, ceil(T / kChunk) - 1, 64,
// 64] float32. K and V are at most 64; T is any length >= 1.
//
// What bounds it on an H100: the float32 operations, about 12 BH*T*K*V of
// them (the recompute of S included) at 67 TFLOP/s outside the tensor
// cores, above the bytes (each input read once, each gradient written once,
// at 3.35 TB/s).
//
// Design: a block of 256 threads per bh, each thread a 4 x 4 tile of the
// 64 x 64 state S and adjoint G in registers; both recurrences are
// elementwise in (i, j), so a step needs no exchange between threads, only
// the sums of its gradients.
// 1. A forward walk over T writes S at the start of every chunk of kChunk
//    steps but the first to the scratch (S is never run backwards by
//    dividing by w: at the model's clamp w is 0.036 a step).
// 2. A backward walk over the chunks, last first: S is recomputed over the
//    chunk from its saved start, every S_{t-1} kept in registers (8 x 16 a
//    thread), then the chunk's steps are walked backwards with G.
// The chunk's r, k, w, v, dout are staged in shared memory, the next
// chunk's loaded into registers meanwhile. Each step's row sums (dr, dk, dw)
// over a row's 16 column tiles are taken by shuffles that leave one of the
// 12 sums on each of 12 lanes; its column sums (dv) over the 16 row tiles by
// a shuffle within the warp and, at the end of the chunk, over the 8 warps
// in shared memory, where the u terms are added and every gradient is
// written. Float32 throughout (the forward's note: tf32 would round S past
// the 1e-4 tolerance); the decays are clamped at kWMin as the forward does.
// A simple first design: one block per bh, so BH = 128 (rwkv6-7b at B = 2)
// fills 128 of the 132 SMs with 8 warps each, and a step's few hundred
// instructions a thread are issued by 2 warps per scheduler.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 64;                 // K and V at most
constexpr int kTileDim = 4;                 // a thread's tile of S and G is 4 x 4
constexpr int kTiles = kMaxDim / kTileDim;  // row (and column) tiles
constexpr int kThreads = kTiles * kTiles;   // 256
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                   // steps between saved states (ops.py: BWD_CHUNK)
constexpr int kLoads = kChunk * kMaxDim / kThreads;  // values of each input a thread a chunk
constexpr float kWMin = 1e-12f;             // rwkv6.cu: kWMin
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps == kChunk, "warp s sums step s's dot products");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Smem {
  float r[kChunk][kMaxDim];
  float k[kChunk][kMaxDim];
  float w[kChunk][kMaxDim];        // as given (clamped where used)
  float v[kChunk][kMaxDim];
  float dout[kChunk][kMaxDim];
  float rows[3][kChunk][kMaxDim];  // each step's S do, G v and sum_j G S of each row
  float dv[kChunk][kWarps][kMaxDim];  // each step's G^T k of each column, per warp
  float vdo[kChunk];               // v_t . do_t
  float ruk[kChunk];               // r_t . (u k_t)
  float u[kMaxDim];
};

// One chunk's inputs, loaded into registers: past T, K and V zeros, and
// w = 1, so that a padded step leaves S and G as they were.
template <typename T, bool kAll>
struct ChunkRegs {
  float r[kLoads], k[kLoads], w[kLoads], v[kLoads], d[kLoads];

  __device__ __forceinline__ void load(const T* __restrict__ r_g, const T* __restrict__ k_g,
                                       const T* __restrict__ w_g, const T* __restrict__ v_g,
                                       const float* __restrict__ do_g, int64_t bh, int64_t t0,
                                       int64_t n_steps, int kd, int vd) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int64_t t = t0 + e / kMaxDim;
      const int i = e % kMaxDim;
      const bool in_t = t < n_steps;
      const int64_t ok_ = (bh * n_steps + t) * kd + i, ov = (bh * n_steps + t) * vd + i;
      const bool ok_k = in_t && i < kd, ok_v = in_t && i < vd;
      k[j] = ok_k ? to_f32(k_g[ok_]) : 0.f;
      w[j] = ok_k ? to_f32(w_g[ok_]) : 1.f;
      v[j] = ok_v ? to_f32(v_g[ov]) : 0.f;
      if (kAll) {
        r[j] = ok_k ? to_f32(r_g[ok_]) : 0.f;
        d[j] = ok_v ? do_g[ov] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(Smem& sm) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int s = e / kMaxDim, i = e % kMaxDim;
      sm.k[s][i] = k[j];
      sm.w[s][i] = w[j];
      sm.v[s][i] = v[j];
      if (kAll) {
        sm.r[s][i] = r[j];
        sm.dout[s][i] = d[j];
      }
    }
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// S <- diag(max(w, kWMin)) S + k v^T over the thread's tile at step s.
__device__ __forceinline__ void advance(float (&S)[kTileDim][kTileDim], const Smem& sm, int s,
                                        int i0, int j0) {
  const float4 w4 = ld4(&sm.w[s][i0]), k4 = ld4(&sm.k[s][i0]), v4 = ld4(&sm.v[s][j0]);
  const float w[4] = {fmaxf(w4.x, kWMin), fmaxf(w4.y, kWMin), fmaxf(w4.z, kWMin),
                      fmaxf(w4.w, kWMin)};
  const float k[4] = {k4.x, k4.y, k4.z, k4.w}, v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int a = 0; a < kTileDim; ++a) {
#pragma unroll
    for (int b = 0; b < kTileDim; ++b) S[a][b] = fmaf(w[a], S[a][b], k[a] * v[b]);
  }
}

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

// The scratch slot of chunk c's starting state (c >= 1), a thread's row a.
__device__ __forceinline__ float4* saved(float* scratch, int64_t bh, int64_t chunks, int64_t c,
                                         int a) {
  return reinterpret_cast<float4*>(scratch) +
         ((bh * (chunks - 1) + (c - 1)) * kTileDim + a) * kThreads + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) rwkv6_bwd_kernel(
    const T* __restrict__ r_g, const T* __restrict__ k_g, const T* __restrict__ v_g,
    const T* __restrict__ w_g, const float* __restrict__ u_g, const float* __restrict__ do_g,
    const float* __restrict__ ds_g, T* __restrict__ dr_g, T* __restrict__ dk_g,
    T* __restrict__ dv_g, T* __restrict__ dw_g, float* __restrict__ du_g,
    float* __restrict__ scratch, int64_t n_steps, int kd, int vd) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, wl = tid % 32, warp = tid / 32;
  const int ct = wl % kTiles;                        // column tile
  const int rt = warp * 2 + wl / kTiles;             // row tile
  const int i0 = rt * kTileDim, j0 = ct * kTileDim;
  const int64_t bh = blockIdx.x;
  const int64_t chunks = (n_steps + kChunk - 1) / kChunk;

  // 1. Forward: the state at the start of chunks 1 .. chunks-1.
  {
    float S[kTileDim][kTileDim] = {};
    ChunkRegs<T, false> pre;
    pre.load(r_g, k_g, w_g, v_g, do_g, bh, 0, n_steps, kd, vd);
    for (int64_t c = 0; c < chunks; ++c) {
      pre.store(sm);
      __syncthreads();
      if (c + 1 < chunks) pre.load(r_g, k_g, w_g, v_g, do_g, bh, (c + 1) * kChunk, n_steps, kd, vd);
      if (c > 0) {
#pragma unroll
        for (int a = 0; a < kTileDim; ++a) {
          *saved(scratch, bh, chunks, c, a) = make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
        }
      }
#pragma unroll
      for (int s = 0; s < kChunk; ++s) advance(S, sm, s, i0, j0);
      __syncthreads();
    }
  }

  // 2. Backward over the chunks, last first.
  float G[kTileDim][kTileDim];
#pragma unroll
  for (int a = 0; a < kTileDim; ++a) {
#pragma unroll
    for (int b = 0; b < kTileDim; ++b) {
      const int i = i0 + a, j = j0 + b;
      G[a][b] = ds_g != nullptr && i < kd && j < vd ? ds_g[(bh * kd + i) * vd + j] : 0.f;
    }
  }
  if (tid < kMaxDim) sm.u[tid] = tid < kd ? u_g[bh * kd + tid] : 0.f;
  float du = 0.f;
  ChunkRegs<T, true> pre;
  pre.load(r_g, k_g, w_g, v_g, do_g, bh, (chunks - 1) * kChunk, n_steps, kd, vd);
  for (int64_t c = chunks - 1; c >= 0; --c) {
    const int64_t t0 = c * kChunk;
    pre.store(sm);
    __syncthreads();
    if (c > 0) pre.load(r_g, k_g, w_g, v_g, do_g, bh, t0 - kChunk, n_steps, kd, vd);
    {  // warp s: step s's v.do and r.(u k)
      const int s = warp;
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
    // S_{t-1} of each step of the chunk, from the chunk's saved start.
    float P[kChunk][kTileDim][kTileDim];
    {
      float S[kTileDim][kTileDim];
#pragma unroll
      for (int a = 0; a < kTileDim; ++a) {
        const float4 s4 = c > 0 ? *saved(scratch, bh, chunks, c, a) : make_float4(0, 0, 0, 0);
        S[a][0] = s4.x;
        S[a][1] = s4.y;
        S[a][2] = s4.z;
        S[a][3] = s4.w;
      }
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
#pragma unroll
        for (int a = 0; a < kTileDim; ++a) {
#pragma unroll
          for (int b = 0; b < kTileDim; ++b) P[s][a][b] = S[a][b];
        }
        advance(S, sm, s, i0, j0);
      }
    }
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      const float4 w4 = ld4(&sm.w[s][i0]), k4 = ld4(&sm.k[s][i0]), r4 = ld4(&sm.r[s][i0]);
      const float4 v4 = ld4(&sm.v[s][j0]), d4 = ld4(&sm.dout[s][j0]);
      const float w[4] = {fmaxf(w4.x, kWMin), fmaxf(w4.y, kWMin), fmaxf(w4.z, kWMin),
                          fmaxf(w4.w, kWMin)};
      const float k[4] = {k4.x, k4.y, k4.z, k4.w}, r[4] = {r4.x, r4.y, r4.z, r4.w};
      const float v[4] = {v4.x, v4.y, v4.z, v4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
      float sums[16] = {}, col[kTileDim] = {};  // sums: S do (0-3), G v (4-7), G.S (8-11)
#pragma unroll
      for (int a = 0; a < kTileDim; ++a) {
#pragma unroll
        for (int b = 0; b < kTileDim; ++b) {
          sums[a] = fmaf(P[s][a][b], dd[b], sums[a]);
          sums[4 + a] = fmaf(G[a][b], v[b], sums[4 + a]);
          sums[8 + a] = fmaf(G[a][b], P[s][a][b], sums[8 + a]);
          col[b] = fmaf(G[a][b], k[a], col[b]);
          G[a][b] = fmaf(w[a], G[a][b], r[a] * dd[b]);
        }
      }
      const float row_sum = reduce_scatter16(sums, wl);
      if (ct < 12) sm.rows[ct / 4][s][i0 + ct % 4] = row_sum;
      // Over the warp's two row tiles (lane bit 4): each lane keeps two columns.
      const bool hi = wl & kTiles;
      float c0 = hi ? col[2] : col[0], c1 = hi ? col[3] : col[1];
      c0 += __shfl_xor_sync(kFull, hi ? col[0] : col[2], kTiles);
      c1 += __shfl_xor_sync(kFull, hi ? col[1] : col[3], kTiles);
      sm.dv[s][warp][j0 + (hi ? 2 : 0)] = c0;
      sm.dv[s][warp][j0 + (hi ? 3 : 1)] = c1;
    }
    __syncthreads();
    // The chunk's gradients, with the u terms.
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = tid + j * kThreads;
      const int s = e / kMaxDim, i = e % kMaxDim;
      const int64_t t = t0 + s;
      if (t >= n_steps) continue;
      const float vdo = sm.vdo[s];
      if (i < kd) {
        const int64_t o = (bh * n_steps + t) * kd + i;
        dr_g[o] = from_f32<T>(sm.rows[0][s][i] + sm.u[i] * sm.k[s][i] * vdo);
        dk_g[o] = from_f32<T>(sm.rows[1][s][i] + sm.u[i] * sm.r[s][i] * vdo);
        dw_g[o] = from_f32<T>(sm.w[s][i] >= kWMin ? sm.rows[2][s][i] : 0.f);
      }
      if (i < vd) {
        float sum = sm.ruk[s] * sm.dout[s][i];
#pragma unroll
        for (int q = 0; q < kWarps; ++q) sum += sm.dv[s][q][i];
        dv_g[(bh * n_steps + t) * vd + i] = from_f32<T>(sum);
      }
    }
    if (tid < kMaxDim) {
#pragma unroll
      for (int s = 0; s < kChunk; ++s) du = fmaf(sm.r[s][tid] * sm.k[s][tid], sm.vdo[s], du);
    }
    __syncthreads();  // before the next chunk's stores overwrite the stage
  }
  if (tid < kd) du_g[bh * kd + tid] = du;
}

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* dout, const float* ds, void* dr, void* dk,
                         void* dv, void* dw, float* du, float* scratch, int64_t bh,
                         int64_t n_steps, int kd, int vd, cudaStream_t stream) {
  rwkv6_bwd_kernel<T><<<static_cast<unsigned int>(bh), kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, dout, ds, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<T*>(dw), du, scratch, n_steps, kd, vd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 r, k, v, w and their gradients; 1 = bfloat16. ds may be
// null (a zero dS_T). Returns a cudaError_t (0 = launched).
int rwkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                     const float* dout, const float* ds, void* dr, void* dk, void* dv, void* dw,
                     float* du, float* scratch, int64_t bh, int64_t n_steps, int kd, int vd,
                     int dtype, void* stream) {
  if (bh < 1 || bh > 0x7fffffff || n_steps < 1 || kd < 1 || kd > kMaxDim || vd < 1 ||
      vd > kMaxDim || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(r, k, v, w, u, dout, ds, dr, dk, dv, dw, du, scratch, bh,
                                       n_steps, kd, vd, st)
                 : launch_typed<__nv_bfloat16>(r, k, v, w, u, dout, ds, dr, dk, dv, dw, du,
                                               scratch, bh, n_steps, kd, vd, st);
  return static_cast<int>(err);
}

}  // extern "C"
