// Hand-written CUDA kernels for causal online-softmax (flash) attention (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_kernel of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py:89, body _kernel at
// l.32). For each query row i of each batch*head bh:
//
//   s_j   = (q_i . k_j) * scale                      scale = Dh^-1/2, float32
//   s_j   = softcap * tanh(s_j / softcap)            if softcap > 0
//   mask  : i + (Sk - Sq) >= j                       if causal
//   out_i = sum_j p_j v_j / sum_j p_j,  p = exp(s - running max), masked p = 0
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
// Two kernels, chosen by dtype:
//
// * bfloat16 -> flash_mma_kernel, on the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulate). One block of 4 warps per (64 query
//   rows, bh); each warp owns 16 rows. The Q tile and one K and one V tile of
//   BK keys are staged in shared memory (rows padded by 16 bytes, so the
//   fragment loads hit 32 distinct banks), zero-filled past Sk and past Dh
//   (Dh is padded to 64, 128 or 256). S = Q K^T comes out of the mma in
//   registers; scale, softcap and mask are applied there, the running max
//   and sum are kept per row (the sum per thread, reduced over the row's 4
//   threads at the end), and P is rounded to bf16 in registers, where the
//   accumulator layout of S is exactly the A-operand layout of P V. V's
//   B fragments come from row-major shared memory through ldmatrix.trans.
//   Causal blocks stop at their last visible key; a warp skips a tile that
//   none of its rows sees.
// * float32 -> flash_f32_kernel, on the CUDA cores (the tensor cores would
//   round float32 to tf32). One warp per query row; each lane holds Dh/32
//   of q and of the accumulator; a key's score is a warp-wide sum.
//
// What bounds it on an H100: at the model's prefill and forward shapes the
// tensor-core operations, 4*BHq*Sq*Sk_eff*Dh of them (Sk_eff: the keys a
// query sees) at 989 TFLOP/s bf16; at decode (Sq = 1) the bytes of K and V,
// read once at 3.35 TB/s. This first design stays well above both: one
// staging buffer (loads are not overlapped with the mma but by other blocks
// on the SM), mma.sync rather than wgmma, no TMA, and at decode 63 of 64
// query rows of a block are padding and each KV row is staged by each of its
// query heads. Those are the redesign's work.
//
// Built by src/repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. The launcher launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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
};

__device__ __forceinline__ int64_t q_base(const Operand& op, int bh, int hq) {
  const int b = bh / hq, h = bh - b * hq;
  return static_cast<int64_t>(b) * op.sb + static_cast<int64_t>(h) * op.sh;
}

__device__ __forceinline__ int64_t kv_base(const Operand& op, int bh, const Params& p) {
  const int f = bh / p.group;
  const int b = f / p.hkv, h = f - b * p.hkv;
  return static_cast<int64_t>(b) * op.sb + static_cast<int64_t>(h) * op.sh;
}

__device__ __forceinline__ float score(float dot, const Params& p) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

template <int DH>
struct MmaCfg {
  static constexpr int kWarps = 4;
  static constexpr int BQ = 16 * kWarps;            // query rows a block
  static constexpr int BK = DH <= 128 ? 64 : 32;    // keys a tile (registers bound DH = 256)
  static constexpr int LD = DH + 8;                 // shared row stride in elements
  static constexpr int kThreads = 32 * kWarps;
  static constexpr size_t kSmem = static_cast<size_t>(BQ + 2 * BK) * LD * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t ld_smem32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// B fragment (k16 x n8) of V stored row-major [key][d] in shared memory:
// lanes 0-15 give the addresses of the 16 key rows, .trans hands each thread
// {V[2t][g], V[2t+1][g]} and {V[2t+8][g], V[2t+9][g]}.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// rows x DH tile of a bf16 operand into shared memory (row stride DH + 8),
// zero past valid_rows and past dh. ``vec``: 16-byte loads are aligned.
template <int DH>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t ss,
                                      int rows, int valid_rows, int dh, bool vec) {
  constexpr int LD = DH + 8;
  constexpr int CH = DH / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows && c < dh) {
      const __nv_bfloat16* s = src + r * ss + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(s);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = c + 2 * j < dh ? __bfloat16_as_ushort(s[2 * j]) : 0u;
          const uint32_t hi = c + 2 * j + 1 < dh ? __bfloat16_as_ushort(s[2 * j + 1]) : 0u;
          w[j] = lo | (hi << 16);
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(MmaCfg<DH>::kThreads)
flash_mma_kernel(Params p, int vec) {
  using C = MmaCfg<DH>;
  constexpr int NT = C::BK / 8;   // n8 tiles of S a warp
  constexpr int ND = DH / 8;      // n8 tiles of O a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + C::BQ * C::LD;
  __nv_bfloat16* vs = ks + C::BK * C::LD;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;  // the longest causal rows start first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = p.sk - p.sq;
  const int row0 = q0 + warp * 16;  // this warp's first row; the thread holds row0+g, row0+g+8
  const bool warp_live = row0 < p.sq;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q.ptr) + q_base(p.q, bh, p.hq);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k.ptr) + kv_base(p.k, bh, p);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v.ptr) + kv_base(p.v, bh, p);
  stage<DH>(qs, qg + q0 * p.q.ss, p.q.ss, C::BQ, min(C::BQ, p.sq - q0), p.dh, vec);

  int kv_end = p.sk;
  if (p.causal) kv_end = min(kv_end, min(q0 + C::BQ, p.sq) + offset);
  const int n_tiles = kv_end > 0 ? (kv_end + C::BK - 1) / C::BK : 0;

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * C::BK;
    __syncthreads();  // every warp is done with the previous tile
    const int valid = min(C::BK, p.sk - k0);
    stage<DH>(ks, kg + k0 * p.k.ss, p.k.ss, C::BK, valid, p.dh, vec);
    stage<DH>(vs, vg + k0 * p.v.ss, p.v.ss, C::BK, valid, p.dh, vec);
    __syncthreads();
    // A tile that none of the warp's rows sees leaves m, l and o as they are.
    if (!warp_live || (p.causal && row0 + 15 + offset < k0)) continue;

    // S = Q K^T for the warp's 16 rows x BK keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const __nv_bfloat16* qa = qs + (warp * 16 + g) * C::LD + kk * 16 + 2 * t;
      const uint32_t a0 = ld_smem32(qa), a1 = ld_smem32(qa + 8 * C::LD);
      const uint32_t a2 = ld_smem32(qa + 8), a3 = ld_smem32(qa + 8 * C::LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kb = ks + (nt * 8 + g) * C::LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], a0, a1, a2, a3, ld_smem32(kb), ld_smem32(kb + 8));
      }
    }

    // Scale, softcap, mask; the rows' maxima over the tile. Element i of
    // tile nt is row row0 + g (+8 for i >= 2), key k0 + 8 nt + 2t + (i & 1).
    uint32_t live = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + g + (i >= 2 ? 8 : 0);
        const int c = k0 + nt * 8 + 2 * t + (i & 1);
        const bool ok = c < p.sk && (!p.causal || r + offset >= c);
        const float x = ok ? score(s[nt][i], p) : kNegInf;
        s[nt][i] = x;
        live |= static_cast<uint32_t>(ok) << (nt * 4 + i);
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A fully masked row keeps m at -1e30, where exp would give 1: zero it.
        const float pr = (live >> (nt * 4 + i)) & 1u ? expf(s[nt][i] - m[i >> 1]) : 0.f;
        s[nt][i] = pr;
        rowsum[i >> 1] += pr;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P V: the accumulators of S tiles 2kk, 2kk+1 are P's A fragment.
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * C::LD;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + nd * 8);
        mma_bf16(o[nd], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  if (!warp_live) return;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(const_cast<void*>(p.o.ptr)) +
                      q_base(p.o, bh, p.hq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + row * p.o.ss;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + 2 * t;
      const float x0 = o[nd][2 * r] / den, x1 = o[nd][2 * r + 1] / den;
      if (vec) {
        if (c < p.dh) *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < p.dh) orow[c] = __float2bfloat16(x0);
        if (c + 1 < p.dh) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, one warp per query row
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

template <int NPL>  // values a lane holds: Dh <= 32 * NPL
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(Params p) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kF32Threads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(p.bhq) * p.sq) return;
  const int bh = static_cast<int>(row / p.sq);
  const int qi = static_cast<int>(row - static_cast<int64_t>(bh) * p.sq);
  const float* qr = static_cast<const float*>(p.q.ptr) + q_base(p.q, bh, p.hq) + qi * p.q.ss;
  const float* kg = static_cast<const float*>(p.k.ptr) + kv_base(p.k, bh, p);
  const float* vg = static_cast<const float*>(p.v.ptr) + kv_base(p.v, bh, p);

  float qv[NPL], acc[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < p.dh ? qr[d] : 0.f;
    acc[j] = 0.f;
  }
  // Keys past the row's diagonal are masked: their p is 0 and they leave the
  // running max alone, so the walk stops there.
  const int n_keys = p.causal ? min(p.sk, qi + (p.sk - p.sq) + 1) : p.sk;
  float m = kNegInf, l = 0.f;
  for (int key = 0; key < n_keys; ++key) {
    const float* kr = kg + key * p.k.ss;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int d = lane + 32 * j;
      if (d < p.dh) part = fmaf(qv[j], kr[d], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float s = score(part, p);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new), pr = expf(s - m_new);
    l = l * alpha + pr;
    const float* vr = vg + key * p.v.ss;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int d = lane + 32 * j;
      if (d < p.dh) acc[j] = fmaf(pr, vr[d], acc[j] * alpha);
    }
    m = m_new;
  }
  float* orow = static_cast<float*>(const_cast<void*>(p.o.ptr)) + q_base(p.o, bh, p.hq) +
                qi * p.o.ss;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int d = lane + 32 * j;
    if (d < p.dh) orow[d] = acc[j] / den;
  }
}

template <int DH>
cudaError_t launch_mma(const Params& p, bool vec, cudaStream_t stream) {
  using C = MmaCfg<DH>;
  // The shared-memory opt-in holds per device, so it is set on every launch
  // (a cheap host call): any card and any thread gets it before it launches.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + C::BQ - 1) / C::BQ, p.bhq);
  flash_mma_kernel<DH><<<grid, C::kThreads, C::kSmem, stream>>>(p, vec ? 1 : 0);
  return cudaGetLastError();
}

template <int NPL>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(p.bhq) * p.sq * 32;
  const unsigned blocks = static_cast<unsigned>((threads + kF32Threads - 1) / kF32Threads);
  flash_f32_kernel<NPL><<<blocks, kF32Threads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// q, k, v, o: device pointers; strides: 12 host int64 values, (sb, sh, ss)
// of q, k, v and o in elements. dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const int64_t* strides, int bhq, int hq, int hkv,
                                      int group, int sq, int sk, int dh, float scale,
                                      float softcap, int causal, int dtype, void* stream) {
  Params p;
  const void* ptrs[4] = {q, k, v, o};
  Operand* ops[4] = {&p.q, &p.k, &p.v, &p.o};
  bool vec = dh % 8 == 0;
  for (int i = 0; i < 4; ++i) {
    *ops[i] = Operand{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    vec = vec && aligned16(ptrs[i]) && strides[3 * i] % 8 == 0 && strides[3 * i + 1] % 8 == 0 &&
          strides[3 * i + 2] % 8 == 0;
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (dh <= 64) return launch_mma<64>(p, vec, st);
    if (dh <= 128) return launch_mma<128>(p, vec, st);
    if (dh <= 256) return launch_mma<256>(p, vec, st);
  } else if (dtype == 0) {
    if (dh <= 32) return launch_f32<1>(p, st);
    if (dh <= 64) return launch_f32<2>(p, st);
    if (dh <= 128) return launch_f32<4>(p, st);
    if (dh <= 256) return launch_f32<8>(p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
