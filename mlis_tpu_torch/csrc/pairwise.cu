// Loop-closure candidate sweep: exact float64 pair counts with floor split.
//
// Replaces the TPU kernel mlis_tpu/ops/pairwise.py::_tri_count_kernel
// (launched by _run_tri_count_kernel from candidate_counts). That kernel
// walks a list of upper-triangle 512x512 (ti, tj) tiles and builds d^2
// from hi/lo float32 splits, flagging a "band" around the radius that the
// host recounts in float64. Hopper has native FP64, so this kernel forms
// d^2 in float64 directly and the band path is gone: the counts equal the
// float64 host sweep exactly.
//
// Exactness: d2 = dx*dx + dy*dy + dz*dz in the x, y, z order of the host
// sweep (mlis_tpu/ops/pairwise.py::_host_tile_counts), with every
// operation written as a correctly rounded intrinsic (__dsub_rn, __dmul_rn,
// __dadd_rn) so that no multiply-add is contracted into an FMA. The
// library is also built with -fmad=false.
//
// Bound: per index-valid pair (j - i >= min_gap, i, j < n) the kernel does
// 3 subtractions, 3 multiplications, 2 additions and 1 comparison, about
// 9 FP64 operations. At n = 19,163 and min_gap = 100 that is
// (n - min_gap)(n - min_gap + 1)/2 = 181.7 M pairs, 1.64 GFLOP, or about
// 48 us at the H100 SXM's 34 TFLOP/s FP64 outside the tensor cores. It
// reads (24 + 4) bytes per pose (0.5 MB), which is negligible, so the bound
// is the FP64 rate. The design follows from that: each block stages its
// tile's rows and columns in shared memory once, each thread keeps its row
// in registers and walks the columns from shared memory (a broadcast read),
// and the loop bounds skip pairs that fail the index test instead of
// masking them.
//
// Counting: per-thread 32-bit counts (at most 2 * 512 per thread), a warp
// shuffle reduction, per-warp partial sums in shared memory, and one
// atomicAdd per block on each of two unsigned 64-bit counters
// (total, same_floor). cross = total - same is formed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;    // rows and columns per tile, as in the TPU kernel
constexpr int kThreads = 256; // 8 warps; each thread owns kTile / kThreads rows

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
tri_count_kernel(const double* __restrict__ pos,   // (n, 3) float64
                 const int* __restrict__ floors,   // (n,) int32
                 const int* __restrict__ tile_i,   // (n_tiles,) row-tile index
                 const int* __restrict__ tile_j,   // (n_tiles,) col-tile index
                 int n, int min_gap, double r2,
                 unsigned long long* __restrict__ out) {  // [total, same]
  __shared__ double cx[kTile], cy[kTile], cz[kTile];
  __shared__ int cf[kTile];
  __shared__ unsigned warp_tot[kThreads / 32], warp_same[kThreads / 32];

  const int i0 = tile_i[blockIdx.x] * kTile;
  const int j0 = tile_j[blockIdx.x] * kTile;
  const int tid = threadIdx.x;

  for (int c = tid; c < kTile; c += kThreads) {
    const int j = j0 + c;
    if (j < n) {
      cx[c] = pos[3 * (size_t)j + 0];
      cy[c] = pos[3 * (size_t)j + 1];
      cz[c] = pos[3 * (size_t)j + 2];
      cf[c] = floors[j];
    }
  }
  __syncthreads();

  unsigned tot = 0, same = 0;
  const int j_end = min(kTile, n - j0);  // columns past n are never read
  for (int r = tid; r < kTile; r += kThreads) {
    const int i = i0 + r;
    if (i >= n) break;
    const double xi = pos[3 * (size_t)i + 0];
    const double yi = pos[3 * (size_t)i + 1];
    const double zi = pos[3 * (size_t)i + 2];
    const int fi = floors[i];
    // first column with j - i >= min_gap (64-bit to stay clear of overflow)
    const long long first = (long long)i + min_gap - j0;
    const int c0 = first < 0 ? 0 : (first > kTile ? kTile : (int)first);
    for (int c = c0; c < j_end; ++c) {
      const double dx = __dsub_rn(xi, cx[c]);
      const double dy = __dsub_rn(yi, cy[c]);
      const double dz = __dsub_rn(zi, cz[c]);
      const double d2 =
          __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
      const unsigned hit = d2 <= r2;
      tot += hit;
      same += hit & (unsigned)(fi == cf[c]);
    }
  }

  tot = warp_sum(tot);
  same = warp_sum(same);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    warp_tot[warp] = tot;
    warp_same[warp] = same;
  }
  __syncthreads();
  if (warp == 0) {
    tot = lane < kThreads / 32 ? warp_tot[lane] : 0u;
    same = lane < kThreads / 32 ? warp_same[lane] : 0u;
    tot = warp_sum(tot);
    same = warp_sum(same);
    if (lane == 0) {
      if (tot) atomicAdd(&out[0], (unsigned long long)tot);
      if (same) atomicAdd(&out[1], (unsigned long long)same);
    }
  }
}

}  // namespace

// One block per listed tile on the given stream. `out` holds two zeroed
// 64-bit counters. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int mlis_tri_count(const double* pos, const int* floors, const int* tile_i,
                              const int* tile_j, int n_tiles, int n, int min_gap,
                              double r2, unsigned long long* out, void* stream) {
  if (n_tiles > 0) {
    tri_count_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        pos, floors, tile_i, tile_j, n, min_gap, r2, out);
  }
  return (int)cudaGetLastError();
}
