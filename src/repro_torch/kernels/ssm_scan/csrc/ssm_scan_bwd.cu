// Hand-written CUDA kernel for the gradient of Mamba's selective scan (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain lax.scan
// (src/repro/models/ssm.py:54 _ssm_scan_chunked, fed by decay and bx formed
// at l. 106-107) with jax.grad, and the plain PyTorch version of that
// gradient materialises decay and dt*x*B as [B, T, Di, N] float32 (4.3 GB
// each for jamba at B=2 x 4,096 tokens). With decay_t = exp(dt_t * a) and
// g_t = dL/dh_t = dy_t[d] C_t + decay_{t+1} g_{t+1} (g's carry into the last
// step is dh_T), per batch row b, channel d and state n:
//
//   dC_t[n]  = sum_d dy_t[d] h_t[d,n]
//   dB_t[n]  = sum_d g_t[d,n] dt_t[d] x_t[d]
//   dx_t[d]  = dt_t[d] sum_n g_t[d,n] B_t[n]
//   ddt_t[d] = sum_n g_t[d,n] (a[d,n] decay_t[d,n] h_{t-1}[d,n] + x_t[d] B_t[n])
//   da[d,n]  = sum_{b,t} g_t[d,n] dt_t[d] decay_t[d,n] h_{t-1}[d,n]
//   dh0      = decay_1 g_1
//
// ../ref.py::ssm_scan_bwd_ref is the same function in plain PyTorch.
//
// Layout: as ssm_scan.cu's inputs (dt, x, a, B, C with B and C addressed by
// batch and time strides), hb [B, ceil(T / kTile), Di, N] float32 (h at the
// start of each tile, written by ssm_scan.cu's forward), dy [B, T, Di] and
// dh_T [B, Di, N] float32 contiguous; out: ddt [B, T, Di] float32, dx [B, T,
// Di] of x's dtype, dh0 [B, Di, N] float32, and da [Di, N], dB, dC [B, T, N]
// float32, zeroed by the caller and summed here by atomic adds.
//
// What bounds it on an H100: the bytes of dt, x, dy read and ddt, dx written
// once per (b, t, d) at 3.35 TB/s, and the exponentials, B*T*Di*N of them on
// the special-function units (16 a clock an SM), about even (PERF.md).
//
// Design: ssm_scan.cu's, walked backwards. A thread per (b, d, pair of
// states), 8 lanes a channel, 32 channels a block of 256 threads; the
// block walks its tiles of kTile steps from the last to the first, the
// tile's dt, x, dy, B and C staged in shared memory while the previous
// tile's are loaded into registers. Each tile starts from h at its start
// (hb): a forward walk over the tile keeps every h_{t-1} in registers (h is
// never run backwards: that would divide by decays that underflow to 0),
// then the backward walk carries g and decay_{t+1} in registers. So each
// decay is computed twice in the backward (once a walk), with expf as in
// the forward so that the recomputed h are the forward's own bits.
// Reductions: dx and ddt over a channel's 8 lanes by shuffles (each lane
// sends one of the two sums); dB and dC over the warp's 4 channels by
// shuffles, over the block's 8 warps through shared memory at the end of
// the tile, and over the Di / 32 blocks of a batch row by float32 atomic
// adds (so their summation order varies from run to run); da is kept in
// registers over the steps and added once a block.
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
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;                // 128 registers a thread at most
constexpr int kChannels = kThreads / kLanes;   // channels a block
constexpr int kTile = 32;                      // steps a tile (ssm_scan.cu: kTile)
constexpr int kSeqLoads = kTile * kChannels / kThreads;   // dt, x, dy values a thread a tile
constexpr int kRowLoads = kTile * kMaxState / kThreads;   // B, C values a thread a tile
constexpr int kSumLoads = kTile * 2 * kMaxState / kThreads;  // dB, dC sums a thread a tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Smem {
  float dt[kTile][kChannels];
  float x[kTile][kChannels];
  float dy[kTile][kChannels];
  float b[kTile][kMaxState];
  float c[kTile][kMaxState];
  float dx[kTile][kChannels];
  float ddt[kTile][kChannels];
  float part[kTile][kWarps][2 * kMaxState];  // each warp's dB (n) and dC (16 + n) of a step
};

// One tile's inputs, loaded into registers: zeros past T, Di and N (a
// padded step has dt = 0, so decay 1, and leaves h and g as they were).
template <typename T>
struct TileRegs {
  float dt[kSeqLoads], x[kSeqLoads], dy[kSeqLoads], b[kRowLoads], c[kRowLoads];

  __device__ __forceinline__ void load(const float* __restrict__ dt_g, const T* __restrict__ x_g,
                                       const float* __restrict__ dy_g, const T* __restrict__ b_g,
                                       const T* __restrict__ c_g, int64_t bi, int64_t t0,
                                       int64_t n_steps, int64_t di, int64_t d0, int n_state,
                                       int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < kSeqLoads; ++j) {
      const int i = tid + j * kThreads;
      const int64_t t = t0 + i / kChannels, d = d0 + i % kChannels;
      const bool ok = t < n_steps && d < di;
      const int64_t off = (bi * n_steps + t) * di + d;
      dt[j] = ok ? dt_g[off] : 0.f;
      x[j] = ok ? to_f32(x_g[off]) : 0.f;
      dy[j] = ok ? dy_g[off] : 0.f;
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
      sm.dy[i / kChannels][i % kChannels] = dy[j];
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
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) ssm_scan_bwd_kernel(
    const float* __restrict__ dt_g, const T* __restrict__ x_g, const float* __restrict__ a_g,
    const T* __restrict__ b_g, const T* __restrict__ c_g, const float* __restrict__ hb_g,
    const float* __restrict__ dy_g, const float* __restrict__ dht_g, float* __restrict__ ddt_g,
    T* __restrict__ dx_g, float* __restrict__ da_g, float* __restrict__ db_g,
    float* __restrict__ dc_g, float* __restrict__ dh0_g, int64_t n_steps, int64_t di,
    int n_state, int64_t groups, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, ch = tid / kLanes;
  const int wl = tid % 32, warp = tid / 32;
  const int64_t bi = blockIdx.x / groups;
  const int64_t d0 = (blockIdx.x % groups) * kChannels;
  const int64_t d = d0 + ch;
  const int n0 = lane * kPer;
  const int64_t tiles = (n_steps + kTile - 1) / kTile;

  float a[kPer], g[kPer], dnext[kPer], da[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool ok = d < di && n0 + k < n_state;
    // a = 0 and g = 0 past N and Di: such a lane adds nothing anywhere.
    a[k] = ok ? a_g[d * n_state + n0 + k] : 0.f;
    g[k] = ok ? dht_g[(bi * di + d) * n_state + n0 + k] : 0.f;
    dnext[k] = 1.f;  // decay_{T+1}: g_T = dy_T C_T + dh_T
    da[k] = 0.f;
  }

  TileRegs<T> regs;
  regs.load(dt_g, x_g, dy_g, b_g, c_g, bi, (tiles - 1) * kTile, n_steps, di, d0, n_state, b_sb,
            b_st, c_sb, c_st);
  for (int64_t tile = tiles - 1; tile >= 0; --tile) {
    const int64_t t0 = tile * kTile;
    regs.store(sm);
    __syncthreads();
    if (tile > 0) {  // the previous tile's loads fly while this one is computed
      regs.load(dt_g, x_g, dy_g, b_g, c_g, bi, t0 - kTile, n_steps, di, d0, n_state, b_sb,
                b_st, c_sb, c_st);
    }
    // Forward over the tile from its first h, keeping every h_{t-1}.
    float hs[kTile][kPer];
    {
      float h[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool ok = d < di && n0 + k < n_state;
        h[k] = ok ? hb_g[((bi * tiles + tile) * di + d) * n_state + n0 + k] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const float dtv = sm.dt[s][ch];
        const float dtx = dtv * sm.x[s][ch];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          hs[s][k] = h[k];
          h[k] = fmaf(expf(dtv * a[k]), h[k], dtx * sm.b[s][n0 + k]);
        }
      }
    }
    // Backward over the tile.
#pragma unroll
    for (int s = kTile - 1; s >= 0; --s) {
      const float dtv = sm.dt[s][ch], xv = sm.x[s][ch], dyv = sm.dy[s][ch];
      const float dtx = dtv * xv;
      float pdx = 0.f, pddt = 0.f, v[2 * kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float bv = sm.b[s][n0 + k], cv = sm.c[s][n0 + k];
        const float decay = expf(dtv * a[k]);
        g[k] = fmaf(dnext[k], g[k], dyv * cv);
        dnext[k] = decay;
        const float dh = decay * hs[s][k];                        // decay_t h_{t-1}
        v[k] = g[k] * dtx;                                        // dB's term
        v[kPer + k] = dyv * fmaf(decay, hs[s][k], dtx * bv);      // dC's term: dy_t h_t
        pdx = fmaf(g[k], bv, pdx);
        pddt = fmaf(g[k], fmaf(a[k], dh, xv * bv), pddt);
        da[k] = fmaf(g[k] * dtv, dh, da[k]);
      }
      // dx and ddt over the channel's 8 lanes: even lanes keep dx, odd ddt.
      {
        const bool odd = lane & 1;
        float keep = odd ? pddt : pdx;
        keep += __shfl_xor_sync(kFull, odd ? pdx : pddt, 1);
        keep += __shfl_xor_sync(kFull, keep, 2);
        keep += __shfl_xor_sync(kFull, keep, 4);
        if (lane == 0) sm.dx[s][ch] = dtv * keep;
        if (lane == 1) sm.ddt[s][ch] = keep;
      }
      // dB and dC over the warp's 4 channels (lane bits 3 and 4): lanes with
      // bit 3 clear keep dB, set dC; then bit 4 picks the state of the pair.
      {
        const bool hi3 = wl & 8, hi4 = wl & 16;
        float k0 = hi3 ? v[2] : v[0], k1 = hi3 ? v[3] : v[1];
        k0 += __shfl_xor_sync(kFull, hi3 ? v[0] : v[2], 8);
        k1 += __shfl_xor_sync(kFull, hi3 ? v[1] : v[3], 8);
        float kk = hi4 ? k1 : k0;
        kk += __shfl_xor_sync(kFull, hi4 ? k0 : k1, 16);
        sm.part[s][warp][(hi3 ? kMaxState : 0) + n0 + (hi4 ? 1 : 0)] = kk;
      }
    }
    __syncthreads();
    // The tile's dx and ddt, coalesced along Di.
#pragma unroll
    for (int j = 0; j < kSeqLoads; ++j) {
      const int i = tid + j * kThreads;
      const int64_t t = t0 + i / kChannels, dd = d0 + i % kChannels;
      if (t < n_steps && dd < di) {
        const int64_t off = (bi * n_steps + t) * di + dd;
        ddt_g[off] = sm.ddt[i / kChannels][i % kChannels];
        dx_g[off] = from_f32<T>(sm.dx[i / kChannels][i % kChannels]);
      }
    }
    // The tile's dB and dC: the block's sum over its warps, added to the row's.
#pragma unroll
    for (int j = 0; j < kSumLoads; ++j) {
      const int i = tid + j * kThreads;
      const int s = i / (2 * kMaxState), q = i % (2 * kMaxState);
      const int n = q % kMaxState;
      const int64_t t = t0 + s;
      if (t < n_steps && n < n_state) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sm.part[s][w][q];
        atomicAdd((q < kMaxState ? db_g : dc_g) + (bi * n_steps + t) * n_state + n, sum);
      }
    }
    __syncthreads();  // before the next tile's stores overwrite the stage
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (d < di && n0 + k < n_state) {
      dh0_g[(bi * di + d) * n_state + n0 + k] = dnext[k] * g[k];
      atomicAdd(da_g + d * n_state + n0 + k, da[k]);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const float* dt, const void* x, const float* a, const void* bm,
                         const void* cm, const float* hb, const float* dy, const float* dht,
                         float* ddt, void* dx, float* da, float* db, float* dc, float* dh0,
                         int64_t batch, int64_t n_steps, int64_t di, int n_state, int64_t b_sb,
                         int64_t b_st, int64_t c_sb, int64_t c_st, cudaStream_t stream) {
  const int64_t groups = (di + kChannels - 1) / kChannels;
  const int64_t blocks = batch * groups;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (attr != cudaSuccess) return attr;
  ssm_scan_bwd_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, sizeof(Smem), stream>>>(
      dt, static_cast<const T*>(x), a, static_cast<const T*>(bm), static_cast<const T*>(cm), hb,
      dy, dht, ddt, static_cast<T*>(dx), da, db, dc, dh0, n_steps, di, n_state, groups, b_sb,
      b_st, c_sb, c_st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 x, B, C, dx; 1 = bfloat16. Strides are in elements.
// Returns a cudaError_t (0 = launched).
int ssm_scan_bwd_launch(const float* dt, const void* x, const float* a, const void* bm,
                        const void* cm, const float* hb, const float* dy, const float* dht,
                        float* ddt, void* dx, float* da, float* db, float* dc, float* dh0,
                        int64_t batch, int64_t n_steps, int64_t di, int n_state, int64_t b_sb,
                        int64_t b_st, int64_t c_sb, int64_t c_st, int dtype, void* stream) {
  if (batch < 1 || n_steps < 1 || di < 1 || n_state < 1 || n_state > kMaxState ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_typed<float>(dt, x, a, bm, cm, hb, dy, dht, ddt, dx, da, db, dc, dh0, batch,
                                n_steps, di, n_state, b_sb, b_st, c_sb, c_st, st)
          : launch_typed<__nv_bfloat16>(dt, x, a, bm, cm, hb, dy, dht, ddt, dx, da, db, dc, dh0,
                                        batch, n_steps, di, n_state, b_sb, b_st, c_sb, c_st, st);
  return static_cast<int>(err);
}

}  // extern "C"
