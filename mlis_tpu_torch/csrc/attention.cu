// Attention kernels: softmax(Q K^T / sqrt(Dh) + mask or bias) V.
//
// flash (mlis_flash_attention) replaces two TPU kernels of one function:
//   mlis_tpu/ops/flash_attention.py:31 _flash_kernel        (launched :161)
//   mlis_tpu/ops/flash_attention.py:80 _single_block_kernel (launched :134)
// Keys at positions >= kv_len[bh] are masked; a row with kv_len = 0
// returns zeros (acc / max(l, 1e-20)), or, with mean_empty set, the mean
// of V over all T keys: the softmax of T equal logits, which is what a
// dense softmax over a fully masked row gives (LightGlue's attention at
// Kx * Ks <= 1024^2). Such a row takes its Q as zero and runs over every
// key, so Q K^T is exactly 0 everywhere. Q K^T and P V take their operands
// in the input dtype: P is cast to V's dtype before the P V product, as
// the TPU kernels do. The key loop stops at kv_len.
//
// dense (mlis_dense_attention) replaces
//   mlis_tpu/ops/attention.py:25 _attention_kernel      (launched :91)
//   mlis_tpu/ops/attention.py:38 _attention_bias_kernel (launched :97)
// with an optional additive float32 bias read in place as
//   bias[b * sb + h * sh + s * ss + t]
// so that a (B, 1|H, S, T) bias is never broadcast. The TPU kernels keep
// scores, softmax and P V in float32. Here Q K^T runs on bf16/f16 tensor
// cores (the products are exact in float32, the sums float32); P stays
// float32 and enters P V as two terms of V's dtype, p = p_hi + p_lo (p_hi
// p cut to bf16, or rounded to f16; p_lo the rounding of the exact
// remainder), which carry p to 2^-16 relative, far below the output's ulp. A fully masked row (every bias -inf) gives
// 0/0 = NaN, as the TPU kernel's softmax does.
//
// Design (bf16 and f16, Dh in {16, 32, 64}): one block owns 128 query
// rows of one (b, h): two consumer warpgroups of 64 rows each. Q is loaded
// once, then K and V tiles of 64 keys run through a ring of kStages
// stages, all by TMA through 4-D tensor maps over the (B, L, H, Dh) views
// (Dh, H, L, B order, any element strides that TMA takes), so the ragged L
// edge is zero-filled per (b, h). Each stage has a full mbarrier (the
// TMA's byte count) and an empty one (one arrival per consumer warp). The
// flash kernel has a producer warp that issues the copies; the dense
// kernel's thread 0 refills a stage once every warp has released it (see
// Roles). Tiles land with the swizzle whose span is one row (128 B at
// Dh 64, 64 B at 32, 32 B at 16), which is the layout wgmma reads:
//   S = Q K^T is wgmma m64n64k16, A = Q and B = the K tile in shared
//     memory, both K-major as stored;
//   O += P V is wgmma m64nDhk16, A = P in registers, B = the V tile in
//     shared memory with B's transpose bit set (V is stored key-major).
// S's float32 accumulator fragment is, per 16 keys, exactly the A
// fragment of P V, so P is converted in place and never touches shared
// memory. The online softmax is float32 in the log2 domain: one fmaf of
// scale * log2(e) before exp2; only the tile that crosses n_keys is
// masked. A warpgroup whose rows all lie past S computes nothing. The
// output is normalised, written into the warpgroup's Q tile with the same
// swizzle, and stored by TMA, which clips rows past S. float32 inputs
// take a plain FFMA kernel (one thread per query row) over the same
// strided views.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
// flash at LightGlue's fullres shape (BH = 2048, S = T = 2048, Dh = 64,
// bf16) does 4 S Dh sum(kv_len) flops, about 1.7 TFLOP for path B's
// draws, against 1.1 GB of bytes: bound by operations (then by the exp of
// every score, one MUFU op each). dense at the ViT-B shape (BH = 768,
// S = T = 530, Dh = 64) moves 208 MB for 55 GFLOP: bound by bytes (62 us);
// each block reads its (b, h)'s K and V once per 128 query rows, mostly
// from L2. Built with -fmad=false: fmaf is written where an FMA is meant.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 query rows
constexpr int kBQ = 64 * kConsumers;             // query rows per block
constexpr int kBK = 64;                          // keys per K/V tile
constexpr int kStages = 4;                       // depth of the K/V ring
// The flash kernel has a producer warp that issues every copy; the dense
// kernel has none (thread 0 refills the ring as tiles are released), which
// keeps it at 256 threads and lets two blocks an SM hold 128 registers a
// thread instead of 96: its two P V terms spill at 96.
template <bool kDense> struct Roles {
  static constexpr bool kProducerWarp = !kDense;
  static constexpr int kThreads = 128 * kConsumers + (kProducerWarp ? 32 : 0);
};
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kF32Rows = 64;  // FFMA path: query rows (threads) per block
constexpr int kF32BK = 32;    // FFMA path: keys per tile

// element strides of a (B, L, H, Dh) view; Dh's stride is 1
struct Strides {
  long long b, l, h;
};
struct QKVO {
  Strides q, k, v, o;
};

// shared memory of the wgmma kernel, in bytes from a 1024-aligned base
template <int D> struct Smem {
  static constexpr int kTile = 64 * D * 2;  // 64 rows of Dh bf16/f16: a Q half or a K/V tile
  static constexpr int kQ = 0;              // kConsumers Q tiles (then the output)
  static constexpr int kK = kQ + kConsumers * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // full[kStages], empty[kStages], q
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
};

// the swizzle whose span is one row of Dh elements: wgmma's layout code
// (1 = 128 B, 2 = 64 B, 3 = 32 B) and the mask of the 16-byte chunk index
// that the row bits (address bits 7..9) are XORed into
template <int D> struct Swizzle {
  static_assert(D == 16 || D == 32 || D == 64, "head width");
  static constexpr int kLayout = D == 64 ? 1 : D == 32 ? 2 : 3;
  static constexpr uint32_t kMask = D == 64 ? 7 : D == 32 ? 3 : 1;
  static __device__ __forceinline__ uint32_t offset(uint32_t o) {
    return o ^ (((o >> 7) & kMask) << 4);
  }
};

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// returns once the phase of the given parity has completed; traps (a
// launch error, not a hung card) if that takes over 10 seconds
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}
// TMA: one box of the 4-D map at coordinates (dh, h, l, b) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int l, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(l), "r"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int h, int l,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(0), "r"(h), "r"(l), "r"(b), "r"(src)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ float exp2_approx(float x) {  // ex2.approx(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (static_cast<uint64_t>(layout) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep registers that an asynchronous wgmma reads or writes in place
// until its wait: the compiler sees them used here
template <int N> __device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N> __device__ __forceinline__ void hold(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// explicit register lists of the wgmma shapes used here: S (m64n64k16,
// A and B from shared memory) and O (m64nDhk16, A from registers, B
// transposed)
#define MLIS_WGMMA_SS_N64(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                              \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                                         \
               : "l"(da), "l"(db), "r"(scale_d))

#define MLIS_WGMMA_RS_N16(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "         \
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                                 \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define MLIS_WGMMA_RS_N32(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "         \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                 \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define MLIS_WGMMA_RS_N64(TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                 \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))


// -- element types -----------------------------------------------------------

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  }
  // p = p_hi + p_lo for two values at once, both terms bf16: p_hi is p cut
  // to bf16 (its upper 16 bits), p_lo the rounding of the exact remainder,
  // which carries p to 2^-16 relative; integer and float32 ops only
  static __device__ __forceinline__ void split(float lo, float hi, uint32_t& a_hi,
                                               uint32_t& a_lo) {
    const uint32_t ul = __float_as_uint(lo) & 0xffff0000u, uh = __float_as_uint(hi) & 0xffff0000u;
    a_hi = __byte_perm(ul, uh, 0x7632);
    a_lo = pack(lo - __uint_as_float(ul), hi - __uint_as_float(uh));
  }
  static __device__ __forceinline__ void qk(float (&d)[32], uint64_t da, uint64_t db) {
    const int scale_d = 1;
    MLIS_WGMMA_SS_N64("bf16");
  }
  template <int N>
  static __device__ __forceinline__ void pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
    if constexpr (N == 16) {
      MLIS_WGMMA_RS_N16("bf16");
    } else if constexpr (N == 32) {
      MLIS_WGMMA_RS_N32("bf16");
    } else {
      MLIS_WGMMA_RS_N64("bf16");
    }
  }
};

template <> struct Elem<__half> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
  }
  // p = p_hi + p_lo for two values at once, both terms f16: p_hi the
  // rounding of p, p_lo the rounding of the remainder
  static __device__ __forceinline__ void split(float lo, float hi, uint32_t& a_hi,
                                               uint32_t& a_lo) {
    const __half2 h = __floats2half2_rn(lo, hi);
    memcpy(&a_hi, &h, 4);
    a_lo = pack(lo - __low2float(h), hi - __high2float(h));
  }
  static __device__ __forceinline__ void qk(float (&d)[32], uint64_t da, uint64_t db) {
    const int scale_d = 1;
    MLIS_WGMMA_SS_N64("f16");
  }
  template <int N>
  static __device__ __forceinline__ void pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
    if constexpr (N == 16) {
      MLIS_WGMMA_RS_N16("f16");
    } else if constexpr (N == 32) {
      MLIS_WGMMA_RS_N32("f16");
    } else {
      MLIS_WGMMA_RS_N64("f16");
    }
  }
};

// -- tensor-core path (bf16, f16): TMA ring + wgmma -----------------------------
//
// Fragments (warp w of a consumer warpgroup, lane = 4 g + c): the float32
// accumulator of m64nN holds, per 8 columns j, d[4j], d[4j+1] at row
// 16 w + g, columns 8 j + 2 c, +1, and d[4j+2], d[4j+3] at row 16 w + g + 8.
// The A register fragment of m64nNk16 is mma.sync's m16n8k16 A fragment
// per warp, so the accumulator's columns 16 kc .. 16 kc + 15 pack into the
// A fragment of P V's k-step kc without moving between lanes.

template <typename T, int D, bool kDense>
__global__ void __launch_bounds__(Roles<kDense>::kThreads, 2)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, const int* __restrict__ kv_len,
                       const float* __restrict__ bias, long long sb, long long sh, long long ss,
                       int H, int S, int T_keys, float scale_log2, int mean_empty) {
  using L = Smem<D>;
  using Sw = Swizzle<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + L::kBar;             // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 s
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int n_valid = kDense ? T_keys : min(max(kv_len[bh], 0), T_keys);
  const bool uniform = !kDense && mean_empty && n_valid == 0;  // every key, Q taken as zero
  const int n_keys = uniform ? T_keys : n_valid;
  const int n_tiles = (n_keys + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_q = [&]() {
    mbar_expect_tx(bar_q, kConsumers * L::kTile);
    for (int w = 0; w < kConsumers; ++w)
      tma_load(base + L::kQ + w * L::kTile, &tm_q, bar_q, h, q0 + 64 * w, b);
  };
  auto load_tile = [&](int i) {  // K and V of keys i kBK .. into stage i % kStages
    const int s = i % kStages;
    mbar_expect_tx(bar_full + 8 * s, 2 * L::kTile);
    tma_load(base + L::kK + s * L::kTile, &tm_k, bar_full + 8 * s, h, i * kBK, b);
    tma_load(base + L::kV + s * L::kTile, &tm_v, bar_full + 8 * s, h, i * kBK, b);
  };
  if constexpr (Roles<kDense>::kProducerWarp) {
    if (warp == 4 * kConsumers) {  // the producer warp: one thread issues every copy
      if (lane == 0) {
        load_q();
        for (int i = 0; i < n_tiles; ++i) {
          if (i >= kStages) mbar_wait(bar_empty + 8 * (i % kStages), (i / kStages - 1) & 1);
          load_tile(i);
        }
      }
      return;
    }
  } else if (threadIdx.x == 0) {  // thread 0 fills the ring, and refills it in release()
    load_q();
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_tile(i);
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread's two
  // rows are r0 and r0 + 8
  const int wg = warp / 4, g = lane >> 2, c = lane & 3;
  const int r_local = 16 * (warp % 4) + g;
  const int r0 = q0 + 64 * wg + r_local;
  const uint32_t sq = base + L::kQ + wg * L::kTile;
  const float* biasb = nullptr;
  if (kDense && bias != nullptr) biasb = bias + b * sb + h * sh;
  // the bias path holds x = s scale log2(e) + bias log2(e) in the scores;
  // otherwise the raw s, scaled inside the exp2's fmaf
  const float mul = biasb != nullptr ? 1.f : scale_log2;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  constexpr int kSteps = kBK / 16;              // k-steps of P V per tile
  constexpr int kTerms = kDense ? 2 : 1;         // P V terms: p_hi (and p - p_hi)
  uint32_t a[kTerms * kSteps][4];                // P as A fragments

  // S = Q K^T of the tile in stage st: Dh / 16 k-steps of 32 bytes along
  // each K-major row; issued, not waited for
  auto issue_qk = [&](float (&sc)[32], int st) {
    const uint32_t sk = base + L::kK + st * L::kTile;
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Elem<T>::qk(sc, wgmma_desc(sq + 32 * kk, 1, D, Sw::kLayout),
                  wgmma_desc(sk + 32 * kk, 1, D, Sw::kLayout));
    wgmma_commit();
  };
  // O += P V of the tile in stage st (16 keys are 16 rows of 2 Dh bytes)
  auto issue_pv = [&](int st) {
    const uint32_t sv = base + L::kV + st * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kTerms * kSteps; ++t)
      Elem<T>::template pv<D>(o, a[t], wgmma_desc(sv + (t % kSteps) * 32 * D, 1, D, Sw::kLayout));
    wgmma_commit();
  };
  // scores -> probabilities of tile i in place: the bias or the mask of the
  // tile that crosses n_keys, then the online softmax in the log2 domain,
  // float32 (a row is held by 4 lanes); returns O's rescale factors
  auto softmax = [&](float (&sc)[32], int i, float (&alpha)[2]) {
    const int t0 = i * kBK;
    if (biasb != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * c + (e & 1);
          const int row = r0 + 8 * (e >> 1);
          const float bv = (row < S && key < n_keys) ? biasb[row * ss + key] : 0.f;
          sc[4 * j + e] = key < n_keys ? fmaf(sc[4 * j + e], scale_log2, bv * kLog2e) : -INFINITY;
        }
      }
    } else if (t0 + kBK > n_keys) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + 8 * j + 2 * c + (e & 1) >= n_keys) sc[4 * j + e] = -INFINITY;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx * mul);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // a row with no finite score
      alpha[hh] = exp2_approx(m_run[hh] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(fmaf(sc[4 * j + 2 * hh + e], mul, -m_safe));
          sc[4 * j + 2 * hh + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[hh] = alpha[hh] * l_run[hh] + rs;
      m_run[hh] = m_new;
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * dt + e] *= alpha[e >> 1];
    }
  };
  // P in place into A fragments of V's dtype; the dense kernel adds the
  // remainder term p - p_hi
  auto pack = [&](const float (&sc)[32]) {
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lo = sc[8 * kc + 2 * r], hi = sc[8 * kc + 2 * r + 1];
        if constexpr (kDense)
          Elem<T>::split(lo, hi, a[kc][r], a[kSteps + kc][r]);
        else
          a[kc][r] = Elem<T>::pack(lo, hi);
      }
    }
  };
  // this warp is done with tile j; without a producer warp, thread 0 then
  // refills the stage of tile j - 1 (released by every warp a tile ago)
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
    if constexpr (!Roles<kDense>::kProducerWarp) {
      const int t = j - 1 + kStages;
      if (threadIdx.x == 0 && j >= 1 && t < n_tiles) {
        mbar_wait(bar_empty + 8 * ((j - 1) % kStages), ((j - 1) / kStages) & 1);
        load_tile(t);
      }
      __syncwarp();
    }
  };
  auto wait_tile = [&](int i) { mbar_wait(bar_full + 8 * (i % kStages), (i / kStages) & 1); };

  if (q0 + 64 * wg >= S) {
    // every row of this warpgroup lies past S: keep the ring turning only
    for (int i = 0; i < n_tiles; ++i) {
      wait_tile(i);
      release(i);
    }
    return;
  }
  mbar_wait(bar_q, 0);
  if (uniform) {  // zero this warpgroup's Q tile, then make it visible to wgmma
    uint4* qt = reinterpret_cast<uint4*>(smem + (sq - base));
    for (int i = threadIdx.x % 128; i < L::kTile / 16; i += 128) qt[i] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + wg, 128);
  }
  for (int i = 0; i < n_tiles; ++i) {
    float sc[32], alpha[2];
    wait_tile(i);
    issue_qk(sc, i % kStages);
    wgmma_wait_all();
    hold(sc);
    softmax(sc, i, alpha);
    rescale(alpha);
    pack(sc);
    issue_pv(i % kStages);
    wgmma_wait_all();
    hold(o);
    hold(a);
    release(i);
  }

  // normalise (flash: acc / max(l, 1e-20), zeros for kv_len = 0; dense:
  // acc / l), stage in this warpgroup's Q tile with the TMA's swizzle, and
  // store 64 rows by TMA, which clips rows past S
  named_sync(1 + wg, 128);  // every warp's last Q K^T has read the Q tile
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = kDense ? l_run[hh] : fmaxf(l_run[hh], 1e-20f);
    const uint32_t row_off = (r_local + 8 * hh) * (2 * D);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const uint32_t v = Elem<T>::pack(o[4 * dt + 2 * hh] / l, o[4 * dt + 2 * hh + 1] / l);
      const uint32_t off = Sw::offset(row_off + 16 * dt + 4 * c);
      *reinterpret_cast<uint32_t*>(smem + (sq - base) + off) = v;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) tma_store(&tm_o, sq, h, q0 + 64 * wg, b);
}

// -- FFMA path (float32) -------------------------------------------------------

template <int D, bool kDense>
__global__ void __launch_bounds__(kF32Rows)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, QKVO st,
                     const int* __restrict__ kv_len, const float* __restrict__ bias,
                     long long sb, long long sh, long long ss, int H, int S, int T_keys,
                     float scale, int mean_empty) {
  __shared__ float sK[kF32BK][D];
  __shared__ float sV[kF32BK][D];
  __shared__ float sP[kF32BK][kF32Rows];  // column threadIdx.x: this row's scores
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kF32Rows + tid;
  const float* qb = q + b * st.q.b + h * st.q.h;
  const float* kb = k + b * st.k.b + h * st.k.h;
  const float* vb = v + b * st.v.b + h * st.v.h;
  const float* biasb = nullptr;
  if (kDense && bias != nullptr) biasb = bias + b * sb + h * sh;
  const int n_valid = kDense ? T_keys : min(max(kv_len[bh], 0), T_keys);
  const bool uniform = !kDense && mean_empty && n_valid == 0;  // as in the wgmma kernel
  const int n_keys = uniform ? T_keys : n_valid;

  float qr[D], o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < S && !uniform ? qb[row * st.q.l + d] : 0.f;
    o[d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int t0 = 0; t0 < n_keys; t0 += kF32BK) {
    __syncthreads();
    for (int idx = tid; idx < kF32BK * D; idx += kF32Rows) {
      const int r = idx / D, d = idx % D;
      const bool ok = t0 + r < n_keys;
      sK[r][d] = ok ? kb[(t0 + r) * st.k.l + d] : 0.f;
      sV[r][d] = ok ? vb[(t0 + r) * st.v.l + d] : 0.f;
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
    float* orow = out + b * st.o.b + h * st.o.h + row * st.o.l;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = o[d] / l;
  }
}

// -- launch --------------------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// status codes above every cudaError_t: a tensor map that could not be built
constexpr int kNoEncoder = 20000;
constexpr int kEncodeFailed = 10000;  // + the CUresult

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint*, so that the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the 4-D map (Dh, H, L, B) of a (B, L, H, Dh) view, boxes of 64 rows of
// one (b, h), swizzled over one row
template <typename T, int D>
int encode_map(CUtensorMap* map, const void* ptr, int B, int H, int L, Strides st) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * sizeof(T), (cuuint64_t)st.l * sizeof(T),
                                 (cuuint64_t)st.b * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, Elem<T>::kMapType, 4, const_cast<void*>(ptr), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <typename T, int D, bool kDense>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const QKVO& st,
                 const int* kv_len, int mean_empty, const float* bias, long long sb,
                 long long sh, long long ss, int B, int H, int S, int T_keys,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int rc;
  if ((rc = encode_map<T, D>(&tq, q, B, H, S, st.q)) != 0) return rc;
  if ((rc = encode_map<T, D>(&tk, k, B, H, T_keys, st.k)) != 0) return rc;
  if ((rc = encode_map<T, D>(&tv, v, B, H, T_keys, st.v)) != 0) return rc;
  if ((rc = encode_map<T, D>(&to, out, B, H, S, st.o)) != 0) return rc;
  auto kernel = attention_wgmma_kernel<T, D, kDense>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D>::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));  // the reference's 1 / Dh**0.5
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, Roles<kDense>::kThreads, Smem<D>::kAlloc, stream>>>(tq, tk, tv, to, kv_len, bias, sb, sh, ss,
                                                       H, S, T_keys, scale_log2, mean_empty);
  return (int)cudaGetLastError();
}

template <int D, bool kDense>
int launch_d(int dtype, const void* q, const void* k, const void* v, void* out,
             const QKVO& st, const int* kv_len, int mean_empty, const float* bias, long long sb,
             long long sh, long long ss, int B, int H, int S, int T, cudaStream_t stream) {
  if (dtype == kF32) {
    const float scale = (float)(1.0 / sqrt((double)D));
    dim3 grid((S + kF32Rows - 1) / kF32Rows, B * H);
    attention_f32_kernel<D, kDense><<<grid, kF32Rows, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, st, kv_len, bias, sb,
        sh, ss, H, S, T, scale, mean_empty);
    return (int)cudaGetLastError();
  }
  if (dtype == kBF16)
    return launch_wgmma<__nv_bfloat16, D, kDense>(q, k, v, out, st, kv_len, mean_empty, bias, sb,
                                                  sh, ss, B, H, S, T, stream);
  if (dtype == kF16)
    return launch_wgmma<__half, D, kDense>(q, k, v, out, st, kv_len, mean_empty, bias, sb, sh,
                                           ss, B, H, S, T, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kDense>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           const long long* strides, const int* kv_len, int mean_empty, const float* bias,
           long long sb, long long sh, long long ss, int B, int H, int S, int T, int D,
           void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const QKVO st = {{strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                   {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<16, kDense>(dtype, q, k, v, out, st, kv_len, mean_empty, bias, sb, sh, ss, B, H, S, T, s);
    case 32: return launch_d<32, kDense>(dtype, q, k, v, out, st, kv_len, mean_empty, bias, sb, sh, ss, B, H, S, T, s);
    case 64: return launch_d<64, kDense>(dtype, q, k, v, out, st, kv_len, mean_empty, bias, sb, sh, ss, B, H, S, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points take q (B, S, H, Dh), k and v (B, T, H, Dh) and out
// (B, S, H, Dh) as views: ``strides`` holds 12 element strides, (b, l, h)
// of q, k, v and out in that order; Dh's stride is 1. On bf16/f16 every
// base address is 16-byte aligned and every stride a multiple of 16
// bytes (TMA's rules; the Python wrappers check them). dtype: 0 =
// float32, 1 = bf16, 2 = f16. They return cudaGetLastError() after the
// launch, or kEncodeFailed + the CUresult (kNoEncoder without
// cuTensorMapEncodeTiled) when a tensor map could not be built.

// Flash attention with per-(b, h) key counts kv_len (B * H,) int32; a
// row with kv_len = 0 gives zeros, or V's mean over all T keys when
// mean_empty is not 0.
extern "C" int mlis_flash_attention(const void* q, const void* k, const void* v,
                                    const int* kv_len, int mean_empty, void* out,
                                    const long long* strides, int dtype, int B, int H, int S,
                                    int T, int D, void* stream) {
  return launch<false>(dtype, q, k, v, out, strides, kv_len, mean_empty, nullptr, 0, 0, 0, B, H,
                       S, T, D, stream);
}

// Dense attention over all T keys with an optional float32 bias (nullptr
// for none) at element strides (sb, sh, ss) over (b, h, s); the key axis
// is contiguous.
extern "C" int mlis_dense_attention(const void* q, const void* k, const void* v,
                                    const float* bias, long long sb, long long sh, long long ss,
                                    void* out, const long long* strides, int dtype, int B, int H,
                                    int S, int T, int D, void* stream) {
  return launch<true>(dtype, q, k, v, out, strides, nullptr, 0, bias, sb, sh, ss, B, H, S, T, D,
                      stream);
}
