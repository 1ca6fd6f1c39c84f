// Hand-written CUDA kernel for Mamba's selective scan (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this recurrence in plain
// JAX (src/repro/models/ssm.py:54 _ssm_scan_chunked, a lax.scan of
// lax.scans, fed by mamba_block at l. 101-107). With no single PyTorch call
// for it, the plain form is a Python loop over time that launches a few
// kernels a step and materialises decay and dt*x*B as [B, T, Di, N] float32
// (4.3 GB each for jamba at B=2 x 4,096 tokens); this kernel forms both in
// registers and never writes them. Per batch row b, channel d and state n,
// for t = 0 .. T-1:
//
//   h[n]  <- exp(dt[t,d] * a[d,n]) * h[n] + dt[t,d] * x[t,d] * B[t,n]
//   y[t,d] = sum_n h[n] * C[t,n]
//
// from h = h0[b,d,:], and the final h. ../ref.py::ssm_scan_ref is the same
// function in plain PyTorch. T = 1 is the decode step (the JAX package's
// s == 1 fast path computes the same one step).
//
// Layout: dt [B, T, Di] float32 and x [B, T, Di] (float32 or bfloat16),
// contiguous; a [Di, N] float32 contiguous; B and C [B, T, N] of x's dtype,
// addressed through their batch and time strides (the model hands over
// slices of x_proj's output) with unit stride along N; h0 [B, Di, N] float32
// contiguous; y [B, T, Di] float32 and h_T [B, Di, N] float32, contiguous.
// N is at most 16; offsets are int64.
//
// What bounds it on an H100: the exponentials, B*T*Di*N of them on the
// special-function units (16 a clock an SM), slightly above the bytes (dt,
// x and y once per (b, t, d); B, C, h0 and h_T once) at 3.35 TB/s.
//
// Design: a thread per (b, d, pair of states), holding its two h in
// registers: 8 lanes a channel, 32 channels a block of 256 threads, so that
// B=2 x Di=8,192 gives 131,072 threads (one per (b, d, n) would need four
// shuffles a step to sum y; two states a lane need three). Each block walks
// T in tiles of kTile steps: the tile's dt and x (coalesced along Di) and
// its B and C rows (shared by all 32 channels) are staged in shared memory,
// the next tile's loaded into registers while this one is computed; y of
// the tile is summed over a channel's 8 lanes by shuffles, staged in shared
// memory and written coalesced. The exponent uses expf (not __expf): with
// decay near 1 over thousands of steps a biased approximation would
// accumulate. Registers are held to 64 a thread (four blocks an SM, a few
// bytes spilled), so that B=2's 512 blocks run in one wave: 1.26 ms at the
// forward shape against 1.49 ms at 80 registers (PERF.md). A simple first
// design: no split of T across blocks, and it runs at about 5x its bound.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxState = 16;                  // N at most
constexpr int kPer = 2;                        // states a lane
constexpr int kLanes = kMaxState / kPer;       // lanes a channel
constexpr int kThreads = 256;
// Blocks an SM must hold (64 registers a thread): at B=2 x Di=8,192 the
// 512 blocks then run in one wave on 132 SMs (at 3 an SM, two).
constexpr int kBlocksPerSm = 4;
constexpr int kChannels = kThreads / kLanes;   // channels a block
constexpr int kTile = 32;                      // steps a tile
constexpr int kSeqLoads = kTile * kChannels / kThreads;   // dt, x values a thread a tile
constexpr int kRowLoads = kTile * kMaxState / kThreads;   // B, C values a thread a tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Smem {
  float dt[kTile][kChannels];
  float x[kTile][kChannels];
  float b[kTile][kMaxState];
  float c[kTile][kMaxState];
  float y[kTile][kChannels];
};

// One tile's inputs, loaded into registers: zeros past T, Di and N.
template <typename T>
struct TileRegs {
  float dt[kSeqLoads], x[kSeqLoads], b[kRowLoads], c[kRowLoads];

  __device__ __forceinline__ void load(const float* __restrict__ dt_g, const T* __restrict__ x_g,
                                       const T* __restrict__ b_g, const T* __restrict__ c_g,
                                       int64_t bi, int64_t t0, int64_t n_steps, int64_t di,
                                       int64_t d0, int n_state, int64_t b_sb, int64_t b_st,
                                       int64_t c_sb, int64_t c_st) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kSeqLoads; ++j) {
      const int i = tid + j * kThreads;
      const int64_t t = t0 + i / kChannels, d = d0 + i % kChannels;
      const bool ok = t < n_steps && d < di;
      const int64_t off = (bi * n_steps + t) * di + d;
      dt[j] = ok ? dt_g[off] : 0.f;
      x[j] = ok ? to_f32(x_g[off]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int i = tid + j * kThreads;
      const int64_t t = t0 + i / kMaxState;
      const int n = i % kMaxState;
      const bool ok = t < n_steps && n < n_state;
      b[j] = ok ? to_f32(b_g[bi * b_sb + t * b_st + n]) : 0.f;
      c[j] = ok ? to_f32(c_g[bi * c_sb + t * c_st + n]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(Smem& sm) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kSeqLoads; ++j) {
      const int i = tid + j * kThreads;
      sm.dt[i / kChannels][i % kChannels] = dt[j];
      sm.x[i / kChannels][i % kChannels] = x[j];
    }
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      const int i = tid + j * kThreads;
      sm.b[i / kMaxState][i % kMaxState] = b[j];
      sm.c[i / kMaxState][i % kMaxState] = c[j];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) ssm_scan_kernel(
    const float* __restrict__ dt_g, const T* __restrict__ x_g, const float* __restrict__ a_g,
    const T* __restrict__ b_g, const T* __restrict__ c_g, const float* __restrict__ h0_g,
    float* __restrict__ y_g, float* __restrict__ ht_g, int64_t n_steps, int64_t di,
    int n_state, int64_t groups, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, ch = tid / kLanes;
  const int64_t bi = blockIdx.x / groups;
  const int64_t d0 = (blockIdx.x % groups) * kChannels;
  const int64_t d = d0 + ch;
  const int n0 = lane * kPer;

  float a[kPer], h[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool ok = d < di && n0 + k < n_state;
    // a = 0, h = 0, B = C = 0 past N: the lane's h stays 0 and adds nothing to y.
    a[k] = ok ? a_g[d * n_state + n0 + k] : 0.f;
    h[k] = ok ? h0_g[(bi * di + d) * n_state + n0 + k] : 0.f;
  }

  TileRegs<T> regs;
  regs.load(dt_g, x_g, b_g, c_g, bi, 0, n_steps, di, d0, n_state, b_sb, b_st, c_sb, c_st);
  for (int64_t t0 = 0; t0 < n_steps; t0 += kTile) {
    regs.store(sm);
    __syncthreads();
    if (t0 + kTile < n_steps) {  // the next tile's loads fly while this one is computed
      regs.load(dt_g, x_g, b_g, c_g, bi, t0 + kTile, n_steps, di, d0, n_state, b_sb, b_st,
                c_sb, c_st);
    }
    const int steps = static_cast<int>(n_steps - t0 < kTile ? n_steps - t0 : kTile);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dtv = sm.dt[s][ch];
      const float dtx = dtv * sm.x[s][ch];
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float decay = expf(dtv * a[k]);
        h[k] = fmaf(decay, h[k], dtx * sm.b[s][n0 + k]);
        p = fmaf(h[k], sm.c[s][n0 + k], p);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (lane == 0) sm.y[s][ch] = p;
    }
    __syncthreads();
    // The tile's y, coalesced along Di. The next tile's stores touch other
    // arrays, and its first barrier orders them before sm.y is written again.
#pragma unroll
    for (int j = 0; j < kSeqLoads; ++j) {
      const int i = tid + j * kThreads;
      const int64_t t = t0 + i / kChannels, dd = d0 + i % kChannels;
      if (t < n_steps && dd < di) {
        y_g[(bi * n_steps + t) * di + dd] = sm.y[i / kChannels][i % kChannels];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (d < di && n0 + k < n_state) ht_g[(bi * di + d) * n_state + n0 + k] = h[k];
  }
}

template <typename T>
cudaError_t launch_typed(const float* dt, const void* x, const float* a, const void* bm,
                         const void* cm, const float* h0, float* y, float* ht, int64_t batch,
                         int64_t n_steps, int64_t di, int n_state, int64_t b_sb, int64_t b_st,
                         int64_t c_sb, int64_t c_st, cudaStream_t stream) {
  const int64_t groups = (di + kChannels - 1) / kChannels;
  const int64_t blocks = batch * groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssm_scan_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      dt, static_cast<const T*>(x), a, static_cast<const T*>(bm), static_cast<const T*>(cm), h0,
      y, ht, n_steps, di, n_state, groups, b_sb, b_st, c_sb, c_st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 x, B, C; 1 = bfloat16. Strides are in elements.
// Returns a cudaError_t (0 = launched).
int ssm_scan_launch(const float* dt, const void* x, const float* a, const void* bm,
                    const void* cm, const float* h0, float* y, float* ht, int64_t batch,
                    int64_t n_steps, int64_t di, int n_state, int64_t b_sb, int64_t b_st,
                    int64_t c_sb, int64_t c_st, int dtype, void* stream) {
  if (batch < 1 || n_steps < 1 || di < 1 || n_state < 1 || n_state > kMaxState ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(dt, x, a, bm, cm, h0, y, ht, batch, n_steps, di, n_state,
                                       b_sb, b_st, c_sb, c_st, st)
                 : launch_typed<__nv_bfloat16>(dt, x, a, bm, cm, h0, y, ht, batch, n_steps, di,
                                               n_state, b_sb, b_st, c_sb, c_st, st);
  return static_cast<int>(err);
}

}  // extern "C"
