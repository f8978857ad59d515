// Attention kernels: softmax(Q K^T / sqrt(Dh) + mask or bias) V.
//
// Two kernels of one structure. Each block owns 64 query rows of one
// (batch * head) slice; K and V stream through shared memory in tiles of
// 64 keys, and a running row max and row sum (online softmax, float32)
// rescale the output accumulator, so the (S, T) score matrix never leaves
// the chip. On bf16 and f16 inputs each of the 4 warps computes its 16
// rows with mma.sync m16n8k16 (float32 accumulation); float32 inputs take
// a plain FFMA path of the same kernel (one thread per query row).
//
// flash (mlis_flash_attention) replaces two TPU kernels of one function:
//   mlis_tpu/ops/flash_attention.py:31 _flash_kernel        (launched :161)
//   mlis_tpu/ops/flash_attention.py:80 _single_block_kernel (launched :134)
// Keys at positions >= kv_len[bh] are masked; a row with kv_len = 0
// returns zeros. Q K^T and P V take their operands in the input dtype: P
// is cast to V's dtype before the P V product, as the TPU kernels do.
// The key loop stops at kv_len, so masked tiles cost nothing.
//
// dense (mlis_dense_attention) replaces
//   mlis_tpu/ops/attention.py:25 _attention_kernel      (launched :91)
//   mlis_tpu/ops/attention.py:38 _attention_bias_kernel (launched :97)
// with an optional additive float32 bias indexed as
//   bias[(bh / heads) * sb + (bh % heads) * sh + s * ss + t]
// so that a (B, 1|H, S, T) bias is read in place, never broadcast. The
// TPU kernels read q, k and v as float32 and keep scores, softmax and P V
// in float32. Here Q K^T runs on bf16/f16 tensor cores: the products of
// two bf16 (or f16) values are exact in float32 and the sums are float32.
// P stays float32: for the P V product it is split into three terms of
// V's dtype, p = p_hi + p_mid + p_lo (each the rounding of what the
// earlier terms left), which carry p to float32 precision; the three
// products with V are exact and summed in float32. A fully masked row
// (every bias -inf) gives 0/0 = NaN, as the TPU kernel's softmax does.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// flash at LightGlue's fullres shape (BH = 2048, S = T = 2048, Dh = 64,
// bf16) does 4 S T Dh BH = 2.2 TFLOP and moves 2.1 GB: 2.2 ms of tensor
// work against 0.64 ms of bytes, so it is bound by operations, and then
// by the exp of every score (one MUFU op per score, 8.6 G a launch). The
// design keeps every score in registers, runs both products on tensor
// cores and skips key tiles past kv_len. dense at the ViT-B shape
// (BH = 768, S = T = 530, Dh = 64) does 55 GFLOP and moves 208 MB:
// bound by bytes (62 us). Each block reads its K and V slice once per 64
// query rows, so K and V are read ceil(S / 64) times, mostly from L2.
// This is the simple form: synchronous tile loads, no cp.async, TMA,
// wgmma or warp specialisation yet.
//
// Layouts: q (BH, S, Dh), k and v (BH, T, Dh), out (BH, S, Dh), all
// contiguous and 16-byte aligned; Dh in {16, 32, 64}, every head width of
// the repository's models. Built with -fmad=false: fmaf is written where a
// fused multiply-add is meant.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block (16 per warp)
constexpr int kBK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;           // elements of padding per shared row (bank spread)

constexpr int kF32Rows = 64;  // FFMA path: query rows (threads) per block
constexpr int kF32BK = 32;    // FFMA path: keys per tile

// -- element types -----------------------------------------------------------

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  }
  static __device__ __forceinline__ float rounded(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  }
  static __device__ __forceinline__ float rounded(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// -- tensor-core path (bf16, f16) --------------------------------------------
//
// mma.sync m16n8k16 fragments (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): reg0 (g, 2c..2c+1), reg1 (g+8, 2c..), reg2 (g, 2c+8..), reg3 (g+8, 2c+8..)
//   B (16 x 8, "col"):      reg0 (k = 2c..2c+1, n = g), reg1 (k = 2c+8.., n = g)
//   C (16 x 8, float32):    c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1)
// The C fragments of two neighbouring 8-key score tiles are exactly the A
// fragment of a 16-key step of P V, so P never leaves registers. K sits
// in shared memory row-major (a B fragment of K^T is two 32-bit reads of
// one key row); V is stored transposed so that a B fragment of V is two
// 32-bit reads as well.

template <typename T, int D, bool kDense>
__global__ void __launch_bounds__(kThreads)
attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ kv_len, const float* __restrict__ bias,
                     int heads, long long sb, long long sh, long long ss,
                     int S, int T_keys, float scale) {
  constexpr int kRowK = D + kPad;     // shared row length of K (elements)
  constexpr int kRowV = kBK + kPad;   // shared row length of V^T (elements)
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) unsigned char smem[(kBK * kRowK + D * kRowV) * sizeof(T)];
  T* sK = reinterpret_cast<T*>(smem);
  T* sVt = sK + kBK * kRowK;

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)bh * T_keys * D;
  const T* vb = v + (size_t)bh * T_keys * D;
  const float* biasb = nullptr;
  if (kDense && bias != nullptr) biasb = bias + (bh / heads) * sb + (bh % heads) * sh;
  const int n_keys = kDense ? T_keys : min(max(kv_len[bh], 0), T_keys);

  const int r0 = blockIdx.x * kBQ + warp * 16 + g;  // this thread's two rows
  const int rows[2] = {r0, r0 + 8};

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int col = kk * 16 + 2 * c;
    qf[kk][0] = rows[0] < S ? ld32(qb + (size_t)rows[0] * D + col) : 0u;
    qf[kk][1] = rows[1] < S ? ld32(qb + (size_t)rows[1] * D + col) : 0u;
    qf[kk][2] = rows[0] < S ? ld32(qb + (size_t)rows[0] * D + col + 8) : 0u;
    qf[kk][3] = rows[1] < S ? ld32(qb + (size_t)rows[1] * D + col + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t0 = 0; t0 < n_keys; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * (D / kVec); idx += kThreads) {
      const int row = idx / (D / kVec);
      const int col = (idx % (D / kVec)) * kVec;
      const int key = t0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < n_keys) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)key * D + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)key * D + col);
      }
      *reinterpret_cast<uint4*>(sK + row * kRowK + col) = kv4;
      T vals[kVec];
      memcpy(vals, &vv4, 16);
#pragma unroll
      for (int i = 0; i < kVec; ++i) sVt[(col + i) * kRowV + row] = vals[i];
    }
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* kp = sK + (nt * 8 + g) * kRowK + 2 * c;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Elem<T>::mma(s[nt], qf[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int key = t0 + nt * 8 + 2 * c + (e & 1);
        float x = s[nt][e] * scale;
        if (kDense && biasb != nullptr && row < S && key < n_keys)
          x = x + biasb[(long long)row * ss + key];
        s[nt][e] = key < n_keys ? x : -INFINITY;
      }
    }

    // online softmax, float32, rows held by the 4 lanes of a group
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m_run[h]) ? __expf(m_run[h] - m_safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[nt][2 * h + j];
          const float p = isfinite(x) ? __expf(x - m_safe) : 0.f;
          s[nt][2 * h + j] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[h] = alpha * l_run[h] + rs;
      m_run[h] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }

    // O += P V, 16 keys per step
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      constexpr int kTerms = kDense ? 3 : 1;
      uint32_t a[kTerms][4];
      if (kDense) {
        float rest[8] = {s[2 * kc][0], s[2 * kc][1], s[2 * kc][2], s[2 * kc][3],
                         s[2 * kc + 1][0], s[2 * kc + 1][1], s[2 * kc + 1][2],
                         s[2 * kc + 1][3]};
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          float part[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            part[i] = Elem<T>::rounded(rest[i]);
            rest[i] = rest[i] - part[i];
          }
          a[term][0] = Elem<T>::pack(part[0], part[1]);
          a[term][1] = Elem<T>::pack(part[2], part[3]);
          a[term][2] = Elem<T>::pack(part[4], part[5]);
          a[term][3] = Elem<T>::pack(part[6], part[7]);
        }
      } else {
        a[0][0] = Elem<T>::pack(s[2 * kc][0], s[2 * kc][1]);
        a[0][1] = Elem<T>::pack(s[2 * kc][2], s[2 * kc][3]);
        a[0][2] = Elem<T>::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        a[0][3] = Elem<T>::pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* vp = sVt + (dt * 8 + g) * kRowV + kc * 16 + 2 * c;
        const uint32_t b0 = ld32(vp), b1 = ld32(vp + 8);
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term) Elem<T>::mma(o[dt], a[term], b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= S) continue;
    // flash: acc / max(l, 1e-20) (zeros for kv_len = 0); dense: acc / l
    const float l = kDense ? l_run[h] : fmaxf(l_run[h], 1e-20f);
    T* orow = out + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const uint32_t packed = Elem<T>::pack(o[dt][2 * h] / l, o[dt][2 * h + 1] / l);
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * c) = packed;
    }
  }
}

// -- FFMA path (float32) -------------------------------------------------------

template <int D, bool kDense>
__global__ void __launch_bounds__(kF32Rows)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     const int* __restrict__ kv_len, const float* __restrict__ bias,
                     int heads, long long sb, long long sh, long long ss,
                     int S, int T_keys, float scale) {
  __shared__ float sK[kF32BK][D];
  __shared__ float sV[kF32BK][D];
  __shared__ float sP[kF32BK][kF32Rows];  // column threadIdx.x: this row's scores
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kF32Rows + tid;
  const float* kb = k + (size_t)bh * T_keys * D;
  const float* vb = v + (size_t)bh * T_keys * D;
  const float* biasb = nullptr;
  if (kDense && bias != nullptr) biasb = bias + (bh / heads) * sb + (bh % heads) * sh;
  const int n_keys = kDense ? T_keys : min(max(kv_len[bh], 0), T_keys);

  float qr[D], o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < S ? q[((size_t)bh * S + row) * D + d] : 0.f;
    o[d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int t0 = 0; t0 < n_keys; t0 += kF32BK) {
    __syncthreads();
    for (int idx = tid; idx < kF32BK * D; idx += kF32Rows) {
      const int r = idx / D, d = idx % D;
      const bool ok = t0 + r < n_keys;
      sK[r][d] = ok ? kb[(size_t)(t0 + r) * D + d] : 0.f;
      sV[r][d] = ok ? vb[(size_t)(t0 + r) * D + d] : 0.f;
    }
    __syncthreads();
    float mx = -INFINITY;
#pragma unroll 1
    for (int j = 0; j < kF32BK; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], sK[j][d], acc);
      float x = acc * scale;
      const int key = t0 + j;
      if (kDense && biasb != nullptr && row < S && key < n_keys)
        x = x + biasb[(long long)row * ss + key];
      x = key < n_keys ? x : -INFINITY;
      sP[j][tid] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(m_run) ? expf(m_run - m_safe) : 0.f;
    float rs = 0.f;
#pragma unroll 1
    for (int j = 0; j < kF32BK; ++j) {
      const float x = sP[j][tid];
      const float p = isfinite(x) ? expf(x - m_safe) : 0.f;
      sP[j][tid] = p;
      rs += p;
    }
    l_run = alpha * l_run + rs;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll 1
    for (int j = 0; j < kF32BK; ++j) {
      const float p = sP[j][tid];
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(p, sV[j][d], o[d]);
    }
  }
  if (row < S) {
    const float l = kDense ? l_run : fmaxf(l_run, 1e-20f);
    float* orow = out + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = o[d] / l;
  }
}

// -- launch --------------------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int D, bool kDense>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* out,
                     const int* kv_len, const float* bias, int heads, long long sb,
                     long long sh, long long ss, int BH, int S, int T, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));  // the reference's 1 / Dh**0.5
  if (dtype == kF32) {
    dim3 grid((S + kF32Rows - 1) / kF32Rows, BH);
    attention_f32_kernel<D, kDense><<<grid, kF32Rows, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, kv_len, bias, heads,
        sb, sh, ss, S, T, scale);
  } else if (dtype == kBF16) {
    dim3 grid((S + kBQ - 1) / kBQ, BH);
    attention_mma_kernel<__nv_bfloat16, D, kDense><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)out, kv_len, bias, heads, sb, sh, ss, S, T, scale);
  } else if (dtype == kF16) {
    dim3 grid((S + kBQ - 1) / kBQ, BH);
    attention_mma_kernel<__half, D, kDense><<<grid, kThreads, 0, stream>>>(
        (const __half*)q, (const __half*)k, (const __half*)v, (__half*)out, kv_len, bias,
        heads, sb, sh, ss, S, T, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kDense>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           const int* kv_len, const float* bias, int heads, long long sb, long long sh,
           long long ss, int BH, int S, int T, int D, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (D) {
    case 16: err = launch_d<16, kDense>(dtype, q, k, v, out, kv_len, bias, heads, sb, sh, ss, BH, S, T, st); break;
    case 32: err = launch_d<32, kDense>(dtype, q, k, v, out, kv_len, bias, heads, sb, sh, ss, BH, S, T, st); break;
    case 64: err = launch_d<64, kDense>(dtype, q, k, v, out, kv_len, bias, heads, sb, sh, ss, BH, S, T, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// Flash attention with per-row key counts kv_len (BH,) int32. dtype: 0 =
// float32, 1 = bf16, 2 = f16. Returns cudaGetLastError() after the launch.
extern "C" int mlis_flash_attention(const void* q, const void* k, const void* v,
                                    const int* kv_len, void* out, int dtype, int BH, int S,
                                    int T, int D, void* stream) {
  return launch<false>(dtype, q, k, v, out, kv_len, nullptr, 1, 0, 0, 0, BH, S, T, D, stream);
}

// Dense attention over all T keys with an optional float32 bias (nullptr
// for none) at element strides (sb, sh, ss) over (bh / heads, bh % heads,
// s); the key axis is contiguous.
extern "C" int mlis_dense_attention(const void* q, const void* k, const void* v,
                                    const float* bias, int heads, long long sb, long long sh,
                                    long long ss, void* out, int dtype, int BH, int S, int T,
                                    int D, void* stream) {
  return launch<true>(dtype, q, k, v, out, nullptr, bias, heads, sb, sh, ss, BH, S, T, D,
                      stream);
}
