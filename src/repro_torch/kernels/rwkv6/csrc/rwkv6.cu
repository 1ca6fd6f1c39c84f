// Hand-written CUDA kernel for the RWKV6 (Finch) recurrence (sm_90a).
//
// Replaces the Pallas TPU kernel rwkv6_kernel of the JAX package
// (src/repro/kernels/rwkv6/rwkv6.py:74, body _kernel at l.32). Per batch*head
// bh, with key width K and value width V, for t = 0 .. T-1:
//
//   out[t]  = r[t]^T (S + diag(u) k[t] v[t]^T)          (V values)
//   S      <- diag(w[t]) S + k[t] v[t]^T                  (S is K x V, S_0 = 0)
//
// and, when asked, the final S. ../ref.py::rwkv6_chunk_ref is this kernel's
// arithmetic in plain PyTorch; ../ref.py::rwkv6_ref the sequential form.
//
// Layout: r, k, w [BH, T, K] and v [BH, T, V], all float32 or all bfloat16,
// contiguous; u [BH, K] float32; out [BH, T, V] float32; state [BH, K, V]
// float32 (may be null). K and V are at most 64; T is any length >= 1.
// Offsets are int64.
//
// What bounds it on an H100: the float32 operations, 4*BH*T*K*V of them
// against the card's 67 TFLOP/s outside the tensor cores (the tensor cores'
// tf32 would round S to 10 bits against the 1e-4 tolerance), slightly above
// the bytes (each input read once, out written once, at 3.35 TB/s). The
// sequential form walks T dependent steps, and one step of a block costs
// far more in latency and barriers than in arithmetic.
//
// Design: the TPU kernel's chunked matrix form, so that only the chunk-to-
// chunk update of S is sequential, on the CUDA cores in float32 FMA.
// * Per chunk of C = kChunk steps, with W(a, b) = prod_{a <= s < b} w_s:
//     out = (r_t . W(0, t)) S + A v
//     S  <- W(0, C) . S + (k_j . W(j+1, C))^T v
//     A[t, j] = sum_i r[t,i] k[j,i] W(j+1, t)[i]  (j < t),  A[t, t] = r_t . (u k_t)
//   The TPU kernel takes these factors as exponentials of differences of
//   cumulative log-decays; here they are products of decays, taken from an
//   anchor that lies between the two steps: below A's diagonal 4 x 4 blocks
//   (sub-chunks of kSub steps) A = (r_t . W(a, t)) . (k_j . W(j+1, a)), a
//   the start of t's sub-chunk; inside them, pairwise. No factor exceeds 1
//   for any w <= 1, nothing overflows, and the chunk spends no exp or log
//   (the special-function unit runs at 1/8 of the FMA rate). Decays are
//   clamped at kWMin (the TPU kernel clamps log w at log 1e-12); the steps
//   past T of the last chunk carry w = 1 and r = k = v = 0.
// * Column split. Column j of S and of out needs only column j of v, so the
//   value columns go in groups of kCols = 32, each group (4 warps) with its
//   own K x 32 state in registers, a 4 x 4 tile a thread. The groups of one
//   bh share a block, and so the chunk's decay factors and A, which do not
//   depend on v: a first design with a block per (bh, group) computed them
//   once per block and ran slower (PERF.md).
// * Three phases a chunk, 256 threads, between barriers:
//   1. decay factors, a thread a channel and anchor set: r_t . W(0, t) (into
//      the operand X^T), r_t . W(a, t), k_j . W(j+1, a) for a = 4, 8, 12, 16
//      and W(0, C); each group's state and v into its operand Y = [S; v];
//   2. A: ten 4 x 4 blocks, 16 lanes each over 4 channels, summed by
//      shuffles, into X^T below the decay rows; meanwhile every thread
//      updates its tile of S from the k factors of anchor 16 and v;
//   3. out = X Y, X = [r . W(0, t) | A] (80 deep), per group: each thread a
//      4 x 4 tile of out over a quarter of the depth, summed by shuffles.
//   The next chunk's inputs are copied by cp.async (zero-filled past K, V
//   and T) while phase 3 runs. About 1.2x the sequential form's operations.
// What still bounds it: the state products are fed from shared memory into
// 4 x 4 register tiles and issue at well under the FMA pipe's rate, and the
// factor and A phases add instructions of their own; it runs at about 3.5x
// the operation bound (PERF.md). The tensor cores at full float32 accuracy
// (3xTF32) are the next step.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // steps a chunk (ref.py: CHUNK)
constexpr int kSub = 4;      // steps a sub-chunk (ref.py: SUB)
constexpr int kCols = 32;    // value columns a block (ref.py: COLS)
constexpr int kMaxDim = 64;  // K and V at most; the channel tiles are 64 wide
constexpr int kGroups = kMaxDim / kCols;         // column groups of a block
constexpr int kGroupThreads = 128;                // 4 warps a column group
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kXS = kChunk + 4;          // X^T row stride (floats): conflict-free float4 reads
constexpr int kXRows = kMaxDim + kChunk; // X^T: W(0,t)-decayed r rows, then A^T rows
constexpr int kKqRows = 40;              // k factors: anchor 16 (16 rows), 4 (4), 8 (8), 12 (12)
constexpr float kWMin = 1e-12f;          // ref.py: W_MIN

// First k-factor row of anchor a = 4*sub, sub = 1..3 (anchor 16 starts at 0).
__host__ __device__ constexpr int kq_base(int sub) { return kChunk + 2 * sub * (sub - 1); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 b = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sums 16 values over the 2^LEVELS lanes whose lane ids differ only in the
// bits first, 2*first, .., keeping half at each level: afterwards the lane
// whose bits read e (the highest first) holds the sums of entries
// e * (16 >> LEVELS) .. in x[0 ..].
template <int LEVELS>
__device__ __forceinline__ void reduce_scatter16(float (&x)[16], int lane, int first) {
  int half = 8;
#pragma unroll
  for (int lv = 0; lv < LEVELS; ++lv) {
    const int mask = first << (LEVELS - 1 - lv);
    const bool hi = lane & mask;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (m < half) {
        const float send = hi ? x[m] : x[m + half];
        const float keep = hi ? x[m + half] : x[m];
        x[m] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
    }
    half >>= 1;
  }
}

template <typename T>
struct Smem {
  T raw_r[kChunk * kMaxDim], raw_k[kChunk * kMaxDim], raw_w[kChunk * kMaxDim];
  T raw_v[kChunk * kMaxDim];
  float xt[kXRows * kXS];              // X^T: rows i < 64: r_t W(0,t) [i][t]; rows 64 + j: A[t][j]
  float y[kGroups][kXRows * kCols];    // Y per column group: rows i < 64: S [i][c]; 64 + j: v [j][c]
  float rsub[kChunk * kMaxDim];        // r_t . W(a_t, t), a_t the start of t's sub-chunk
  float kq[kKqRows * kMaxDim];         // k_j . W(j+1, a) by anchor a (rows: kq_base)
  float wdec[kMaxDim];                 // W(0, C)
  float uu[kMaxDim];
};

// A chunk's copy of one operand, [C][64] in shared memory from rows of
// ``width`` elements in device memory: 16-byte pieces where ``vec``, else
// single elements (4 a thread); zero past ``valid`` columns and past T. A
// thread's pieces are fixed: piece or element tid + m * kThreads.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int64_t width, int valid,
                                           int64_t t0, int ch, bool vec) {
  constexpr int E = 16 / sizeof(T), kPieces = kChunk * kMaxDim / E;
  if (vec) {
#pragma unroll
    for (int m = 0; m < (kPieces + kThreads - 1) / kThreads; ++m) {
      const int e = threadIdx.x + m * kThreads;
      const int row = e / (kMaxDim / E), col = e % (kMaxDim / E) * E;
      const bool ok = e < kPieces && row < ch && col < valid;
      if (e < kPieces)
        cp_async16(dst + row * kMaxDim + col, ok ? src + (t0 + row) * width + col : src, ok);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kChunk * kMaxDim / kThreads; ++m) {
      const int e = threadIdx.x + m * kThreads, row = e / kMaxDim, col = e % kMaxDim;
      dst[e] = row < ch && col < valid ? src[(t0 + row) * width + col] : T(0.f);
    }
  }
}

// One block per bh, kThreads threads: column group g = warp / 4 takes value
// columns 32g .. 32g+31 in phases 2 and 3; phases 1 and 2's factors and A are
// shared by both groups.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const float* __restrict__ u, float* __restrict__ out,
             float* __restrict__ state, int64_t n_steps, int kd, int vd, int vec_rkw,
             int vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, gtid = tid & (kGroupThreads - 1);
  const int c0 = grp * kCols, nc = min(kCols, vd - c0);  // the group's value columns
  float* yg = sm.y[grp];

  const T* rb = r + bh * n_steps * kd;
  const T* kb = k + bh * n_steps * kd;
  const T* wb = w + bh * n_steps * kd;
  const T* vb = v + bh * n_steps * vd;
  float* ob = out + bh * n_steps * vd + c0;

  for (int i = tid; i < kMaxDim; i += kThreads) sm.uu[i] = i < kd ? u[bh * kd + i] : 0.f;
  for (int e = tid; e < kChunk * kXS; e += kThreads) sm.xt[kMaxDim * kXS + e] = 0.f;  // A^T

  auto issue = [&](int64_t t0) {  // the chunk's r, k, w [C][64] and v [C][64]
    const int ch = static_cast<int>(n_steps - t0 < kChunk ? n_steps - t0 : kChunk);
    copy_chunk(sm.raw_r, rb, kd, kd, t0, ch, vec_rkw);
    copy_chunk(sm.raw_k, kb, kd, kd, t0, ch, vec_rkw);
    copy_chunk(sm.raw_w, wb, kd, kd, t0, ch, vec_rkw);
    copy_chunk(sm.raw_v, vb, vd, vd, t0, ch, vec_v);
    cp_async_commit();
  };

  // The thread's 4 x 4 tile of its group's S (rows 4ig.., columns 4cs..), kept
  // across chunks.
  const int ig = gtid >> 3, cs = gtid & 7;
  float S[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) S[m][0] = S[m][1] = S[m][2] = S[m][3] = 0.f;

  issue(0);
  for (int64_t t0 = 0; t0 < n_steps; t0 += kChunk) {
    const int ch = static_cast<int>(n_steps - t0 < kChunk ? n_steps - t0 : kChunk);
    cp_async_wait_all();
    __syncthreads();  // the chunk's inputs have landed; the last chunk's phase 3 is done

    // -- phase 1: decay factors; Y = [S; v] ------------------------------------
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<float4*>(yg + (4 * ig + m) * kCols + 4 * cs) =
          make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
    {
      const int t = tid >> 4, c = (tid & 15) * 4;  // v [t][c..c+3] into its group's Y
      *reinterpret_cast<float4*>(sm.y[c / kCols] + (kMaxDim + t) * kCols + c % kCols) =
          load4(sm.raw_v + t * kMaxDim + c);
    }
    const int fi = tid & (kMaxDim - 1);  // the channel of phase 1's factor threads
    const auto decay = [&](int t) {      // w_t, clamped; 1 past T
      return t < ch ? fmaxf(to_f32(sm.raw_w[t * kMaxDim + fi]), kWMin) : 1.f;
    };
    if (tid < kMaxDim) {  // r-side factors, forward through the chunk
      float p0 = 1.f, pa = 1.f;  // W(0, t), W(a_t, t)
      float xr[4];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t % kSub == 0) pa = 1.f;
        const float rv = to_f32(sm.raw_r[t * kMaxDim + fi]), wv = decay(t);
        xr[t % 4] = rv * p0;
        sm.rsub[t * kMaxDim + fi] = rv * pa;
        p0 *= wv;
        pa *= wv;
        if (t % 4 == 3)
          *reinterpret_cast<float4*>(sm.xt + fi * kXS + t - 3) =
              make_float4(xr[0], xr[1], xr[2], xr[3]);
      }
      sm.wdec[fi] = p0;
    } else if (tid < 2 * kMaxDim) {  // k-side factors of anchors 16 and 4, backward
      float q16 = 1.f, q4 = 1.f;     // W(j+1, a)
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) {
        const float kv = to_f32(sm.raw_k[j * kMaxDim + fi]), wv = decay(j);
        sm.kq[j * kMaxDim + fi] = kv * q16;
        q16 *= wv;
        if (j < 4) {
          sm.kq[(kq_base(1) + j) * kMaxDim + fi] = kv * q4;
          q4 *= wv;
        }
      }
    } else if (tid < 3 * kMaxDim) {  // k-side factors of anchors 12 and 8, backward
      float q12 = 1.f, q8 = 1.f;
#pragma unroll
      for (int j = 11; j >= 0; --j) {
        const float kv = to_f32(sm.raw_k[j * kMaxDim + fi]), wv = decay(j);
        sm.kq[(kq_base(3) + j) * kMaxDim + fi] = kv * q12;
        q12 *= wv;
        if (j < 8) {
          sm.kq[(kq_base(2) + j) * kMaxDim + fi] = kv * q8;
          q8 *= wv;
        }
      }
    }
    __syncthreads();

    // -- phase 2: A, one 4 x 4 block per 16 lanes, 4 channels a lane; and each
    // group's S <- W(0, C) . S + (k . W(j+1, C))^T v in registers --------------
    if (warp < 5) {
      const int i = 4 * (lane & 15);  // channels i .. i+3
      const int task = tid >> 4;      // 0-3: diagonal blocks, 4-9: below them
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = 0.f;
      int tb, jb;  // the block's first row t and column j
      if (task < 4) {  // diagonal block: pairwise factors
        tb = jb = kSub * task;
        float rf[4][4], kf[4][4], uf[4], w1f[4], w2f[4];  // [step][channel i + q]
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const float4 a = load4(sm.raw_r + (tb + l) * kMaxDim + i);
          const float4 b = load4(sm.raw_k + (tb + l) * kMaxDim + i);
          rf[l][0] = a.x, rf[l][1] = a.y, rf[l][2] = a.z, rf[l][3] = a.w;
          kf[l][0] = b.x, kf[l][1] = b.y, kf[l][2] = b.z, kf[l][3] = b.w;
        }
        const float4 w1 = load4(sm.raw_w + (tb + 1) * kMaxDim + i);
        const float4 w2 = load4(sm.raw_w + (tb + 2) * kMaxDim + i);
        const float4 uv = load4(sm.uu + i);
        uf[0] = uv.x, uf[1] = uv.y, uf[2] = uv.z, uf[3] = uv.w;
        w1f[0] = w1.x, w1f[1] = w1.y, w1f[2] = w1.z, w1f[3] = w1.w;
        w2f[0] = w2.x, w2f[1] = w2.y, w2f[2] = w2.z, w2f[3] = w2.w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // x[4 t + j] = A[tb + t][tb + j]
          const float r0 = rf[0][q], r1 = rf[1][q], r2 = rf[2][q], r3 = rf[3][q];
          const float k0 = kf[0][q], k1 = kf[1][q], k2 = kf[2][q], k3 = kf[3][q];
          x[0] = fmaf(r0, uf[q] * k0, x[0]);
          x[5] = fmaf(r1, uf[q] * k1, x[5]);
          x[10] = fmaf(r2, uf[q] * k2, x[10]);
          x[15] = fmaf(r3, uf[q] * k3, x[15]);
          x[4] = fmaf(r1, k0, x[4]);
          x[9] = fmaf(r2, k1, x[9]);
          x[14] = fmaf(r3, k2, x[14]);
          const float k0w = fmaxf(w1f[q], kWMin) * k0, k1w = fmaxf(w2f[q], kWMin) * k1;
          x[8] = fmaf(r2, k0w, x[8]);
          x[13] = fmaf(r3, k1w, x[13]);
          x[12] = fmaf(r3, fmaxf(w2f[q], kWMin) * k0w, x[12]);
        }
      } else {  // below the diagonal: (r_t W(a, t)) . (k_j W(j+1, a))
        const int o = task - 4;  // (sub-chunk of t, of j) = (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
        const int sub = o < 1 ? 1 : o < 3 ? 2 : 3;
        tb = kSub * sub;
        jb = kSub * (o - sub * (sub - 1) / 2);
        const float* kqa = sm.kq + (kq_base(sub) + jb) * kMaxDim;
        float4 rr[4], kk[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          rr[l] = load4(sm.rsub + (tb + l) * kMaxDim + i);
          kk[l] = load4(kqa + l * kMaxDim + i);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float s = fmaf(rr[a].x, kk[b].x, 0.f);
            s = fmaf(rr[a].y, kk[b].y, s);
            s = fmaf(rr[a].z, kk[b].z, s);
            x[4 * a + b] = fmaf(rr[a].w, kk[b].w, s);
          }
      }
      reduce_scatter16<4>(x, lane, 1);  // lane l of the 16 holds block entry l
      const int e = lane & 15;
      sm.xt[(kMaxDim + jb + e % 4) * kXS + tb + e / 4] = x[0];
    }
    {
      const float4 wd = *reinterpret_cast<const float4*>(sm.wdec + 4 * ig);
      const float wf[4] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) S[m][q] *= wf[m];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(sm.kq + j * kMaxDim + 4 * ig);
        const float4 b = *reinterpret_cast<const float4*>(yg + (kMaxDim + j) * kCols + 4 * cs);
        const float af[4] = {a.x, a.y, a.z, a.w}, bf[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) S[m][q] = fmaf(af[m], bf[q], S[m][q]);
      }
    }
    __syncthreads();
    if (t0 + kChunk < n_steps) issue(t0 + kChunk);  // lands while phase 3 runs

    // -- phase 3: out = X Y, each group its columns -----------------------------
    {
      const int tg = warp & 3, kq4 = lane >> 3, cg = lane & 7;  // rows kq4 + 4m; columns 4cg..
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = 0.f;
#pragma unroll
      for (int m = 0; m < kXRows / 4; ++m) {
        const int row = kq4 + 4 * m;
        const float4 a = *reinterpret_cast<const float4*>(sm.xt + row * kXS + 4 * tg);
        const float4 b = *reinterpret_cast<const float4*>(yg + row * kCols + 4 * cg);
        const float af[4] = {a.x, a.y, a.z, a.w}, bf[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) x[4 * p + q] = fmaf(af[p], bf[q], x[4 * p + q]);
      }
      reduce_scatter16<2>(x, lane, 8);  // lane holds row t = 4 tg + kq4, columns 4cg..
      const int t = 4 * tg + kq4;
      if (t < ch) {
        float* orow = ob + (t0 + t) * vd;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * cg + q < nc) orow[4 * cg + q] = x[q];
      }
    }
  }

  if (state != nullptr) {
    float* sb = state + bh * kd * vd + c0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * ig + m;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i < kd && 4 * cs + q < nc) sb[static_cast<int64_t>(i) * vd + 4 * cs + q] = S[m][q];
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v, const void* w,
                         const float* u, float* out, float* state, int64_t bh,
                         int64_t n_steps, int kd, int vd, cudaStream_t stream) {
  // 16-byte copies where every row of the operand starts on 16 bytes.
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_rkw = (kd * sizeof(T)) % 16 == 0 && aligned(r) && aligned(k) && aligned(w);
  const int vec_v = (vd * sizeof(T)) % 16 == 0 && aligned(v);
  constexpr size_t smem = sizeof(Smem<T>);
  // The shared-memory opt-in holds per device: set it on every launch (a cheap host call).
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rwkv6_kernel<T><<<static_cast<unsigned int>(bh), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, out, state, n_steps, kd, vd, vec_rkw, vec_v);
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
