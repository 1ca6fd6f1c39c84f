// Hand-written CUDA kernel for the RWKV6 (Finch) recurrence (sm_90a).
//
// Replaces the Pallas TPU kernel rwkv6_kernel of the JAX package
// (src/repro/kernels/rwkv6/rwkv6.py:74, body _kernel at l.32). Per batch*head
// bh, with key width K and value width V, for t = 0 .. T-1:
//
//   out[t]  = r[t]^T (S + diag(u) k[t] v[t]^T)          (V values)
//   S      <- diag(w[t]) S + k[t] v[t]^T                  (S is K x V, S_0 = 0)
//
// and, when asked, the final S. This is the exact, sequential form of the
// plain version (../ref.py::rwkv6_ref): no log-decay, no cumulative sums, so
// nothing can overflow whatever the decay. The TPU kernel's chunked,
// pairwise log-decay form existed to feed the TPU's matrix unit; here the
// recurrence is walked step by step, which needs no assumption on w.
//
// Layout: r, k, w [BH, T, K] and v [BH, T, V], all float32 or all bfloat16,
// contiguous; u [BH, K] float32; out [BH, T, V] float32; state [BH, K, V]
// float32 (may be null). K and V are at most 64; T is any length >= 1.
// Offsets are int64.
//
// Design (tensor cores, TMA and a chunked matrix form are later work). One
// block per bh with kSplit = 4 warp groups: group s keeps rows
// [s*K/4, (s+1)*K/4) of the K x V state, one value column j per thread, in
// registers. Time is walked in chunks of kChunk steps:
//   1. the block stages the chunk's r, k, w, v in shared memory as float32
//      (coalesced loads), and computes a[t] = sum_i r[t,i] u[i] k[t,i] with
//      8 threads a step and a shuffle sum;
//   2. every thread walks the chunk's steps: out_s[t, j] = sum over its rows
//      of r[t,i] S[i,j] (into shared memory), then S[i,j] = w[t,i] S[i,j] +
//      k[t,i] v[t,j] -- three float operations per state entry a step. All
//      32 threads of a warp share their rows, so r, k and w are read as
//      float4 broadcasts of one address;
//   3. the block writes out[t, j] = sum_s out_s[t, j] + a[t] v[t, j].
//
// What bounds it on an H100: the float32 operations, 4*BH*T*K*V of them
// against the card's 67 TFLOP/s outside the tensor cores, slightly above the
// bytes (each input read once, out written once, at 3.35 TB/s) at the model's
// shapes. This design stays well above that bound: each step is a dependent
// update of S, a block has 8 warps, and the steps of a chunk wait for its
// staging. (Loading the next chunk into registers during the current one
// was measured slower on an H100: the extra registers cost more than the
// hidden latency gained.)
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;   // warp groups, each holding K/4 rows of S
constexpr int kChunk = 16;  // time steps staged in shared memory at once
constexpr int kMaxDim = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// KP: K rounded up to 16, 32 or 64; SL = KP / 4 rows of S per thread. The
// block has kSplit * VP threads, VP = V rounded up to a multiple of 32.
template <typename T, int KP>
__global__ void __launch_bounds__(kMaxDim * kSplit)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const float* __restrict__ u,
             float* __restrict__ out, float* __restrict__ state,
             int64_t n_steps, int kd, int vd) {
  constexpr int SL = KP / kSplit;
  __shared__ __align__(16) float sr[kChunk * KP];
  __shared__ __align__(16) float sk[kChunk * KP];
  __shared__ __align__(16) float sw[kChunk * KP];
  __shared__ float sv[kChunk * kMaxDim];
  __shared__ float so[kSplit * kChunk * kMaxDim];  // per-group partial outputs
  __shared__ float su[KP];
  __shared__ float sa[kChunk];

  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int vp = nthreads / kSplit;
  const int s = tid / vp;  // row group: rows [s*SL, (s+1)*SL)
  const int j = tid % vp;  // value column

  // Rows i >= K stay zero in the staging buffers, so their S stays zero.
  for (int e = tid; e < kChunk * KP; e += nthreads) {
    sr[e] = 0.f;
    sk[e] = 0.f;
    sw[e] = 0.f;
  }
  for (int e = tid; e < kChunk * kMaxDim; e += nthreads) sv[e] = 0.f;
  for (int i = tid; i < KP; i += nthreads) su[i] = i < kd ? u[bh * kd + i] : 0.f;

  const T* rb = r + bh * n_steps * kd;
  const T* kb = k + bh * n_steps * kd;
  const T* wb = w + bh * n_steps * kd;
  const T* vb = v + bh * n_steps * vd;
  float* ob = out + bh * n_steps * vd;

  float S[SL];
#pragma unroll
  for (int m = 0; m < SL; ++m) S[m] = 0.f;

  for (int64_t t0 = 0; t0 < n_steps; t0 += kChunk) {
    const int ch = static_cast<int>(n_steps - t0 < kChunk ? n_steps - t0 : kChunk);
    __syncthreads();  // the previous chunk's buffers are no longer read
    for (int e = tid; e < ch * kd; e += nthreads) {
      const int tl = e / kd;
      const int at = tl * KP + (e - tl * kd);
      const int64_t g = t0 * kd + e;
      sr[at] = to_f32(rb[g]);
      sk[at] = to_f32(kb[g]);
      sw[at] = to_f32(wb[g]);
    }
    for (int e = tid; e < ch * vd; e += nthreads) {
      const int tl = e / vd;
      sv[tl * kMaxDim + (e - tl * vd)] = to_f32(vb[t0 * vd + e]);
    }
    __syncthreads();
    // a[t] for the chunk: 8 adjacent threads a step, KP/8 rows each.
    if (tid < kChunk * 8) {
      const int tl = tid / 8, part = tid % 8;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < KP / 8; ++q) {
        const int i = part * (KP / 8) + q;
        a = fmaf(sr[tl * KP + i] * su[i], sk[tl * KP + i], a);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      if (part == 0) sa[tl] = a;
    }

    for (int tl = 0; tl < ch; ++tl) {
      const float vj = sv[tl * kMaxDim + j];
      const float4* r4 = reinterpret_cast<const float4*>(sr + tl * KP + s * SL);
      const float4* k4 = reinterpret_cast<const float4*>(sk + tl * KP + s * SL);
      const float4* w4 = reinterpret_cast<const float4*>(sw + tl * KP + s * SL);
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int q = 0; q < SL / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        acc0 = fmaf(rr.x, S[4 * q + 0], acc0);
        acc1 = fmaf(rr.y, S[4 * q + 1], acc1);
        acc2 = fmaf(rr.z, S[4 * q + 2], acc2);
        acc3 = fmaf(rr.w, S[4 * q + 3], acc3);
        S[4 * q + 0] = fmaf(ww.x, S[4 * q + 0], kk.x * vj);
        S[4 * q + 1] = fmaf(ww.y, S[4 * q + 1], kk.y * vj);
        S[4 * q + 2] = fmaf(ww.z, S[4 * q + 2], kk.z * vj);
        S[4 * q + 3] = fmaf(ww.w, S[4 * q + 3], kk.w * vj);
      }
      so[(s * kChunk + tl) * kMaxDim + j] = (acc0 + acc1) + (acc2 + acc3);
    }
    __syncthreads();
    for (int e = tid; e < ch * vd; e += nthreads) {
      const int tl = e / vd;
      const int jj = e - tl * vd;
      float o = sa[tl] * sv[tl * kMaxDim + jj];
#pragma unroll
      for (int g = 0; g < kSplit; ++g) o += so[(g * kChunk + tl) * kMaxDim + jj];
      ob[t0 * vd + e] = o;
    }
  }

  if (state != nullptr && j < vd) {
    float* sb = state + bh * kd * vd;
#pragma unroll
    for (int m = 0; m < SL; ++m) {
      const int i = s * SL + m;
      if (i < kd) sb[static_cast<int64_t>(i) * vd + j] = S[m];
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v, const void* w,
                         const float* u, float* out, float* state, int64_t bh,
                         int64_t n_steps, int kd, int vd, cudaStream_t stream) {
  const int vp = (vd + 31) / 32 * 32;  // columns rounded up so row groups are whole warps
  const dim3 grid(static_cast<unsigned int>(bh));
  const dim3 block(vp * kSplit);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  if (kd <= 16) {
    rwkv6_kernel<T, 16><<<grid, block, 0, stream>>>(rt, kt, vt, wt, u, out, state, n_steps, kd, vd);
  } else if (kd <= 32) {
    rwkv6_kernel<T, 32><<<grid, block, 0, stream>>>(rt, kt, vt, wt, u, out, state, n_steps, kd, vd);
  } else {
    rwkv6_kernel<T, 64><<<grid, block, 0, stream>>>(rt, kt, vt, wt, u, out, state, n_steps, kd, vd);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs (r, k, v, w alike).
// state may be null. Returns a cudaError_t (0 = launched).
int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                 const float* u, float* out, float* state, int64_t bh,
                 int64_t n_steps, int kd, int vd, int dtype, void* stream) {
  if (bh < 1 || bh > 0x7fffffff || n_steps < 1 || kd < 1 || kd > kMaxDim || vd < 1 ||
      vd > kMaxDim || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(r, k, v, w, u, out, state, bh, n_steps, kd, vd, st)
                 : launch_typed<__nv_bfloat16>(r, k, v, w, u, out, state, bh, n_steps, kd, vd, st);
  return static_cast<int>(err);
}

}  // extern "C"
