// Loop-closure candidate sweep: exact float64 pair counts with floor split.
//
// Replaces two TPU kernels of mlis_tpu/ops/pairwise.py: K1
// _tri_count_kernel (launched by _run_tri_count_kernel from
// candidate_counts), which walks a list of upper-triangle 512x512 (ti, tj)
// tiles, and K6 _count_kernel, the same tile body over the full grid (the
// caller passes every tile). Both build d^2 from hi/lo float32 splits and
// flag a "band" around the radius that the host recounts in float64.
// Hopper has native FP64, so this kernel forms d^2 in float64 directly and
// the band path is gone: the counts equal the float64 host sweep exactly.
//
// Exactness: d2 = dx*dx + dy*dy + dz*dz in the x, y, z order of the host
// sweep (mlis_tpu/ops/pairwise.py::_host_tile_counts), with every
// operation written as a correctly rounded intrinsic (__dsub_rn, __dmul_rn,
// __dadd_rn) so that no multiply-add is contracted into an FMA. The
// library is also built with -fmad=false.
//
// Bound. Per index-valid pair (j - i >= min_gap, i, j < n) the kernel
// issues 3 subtractions, 3 multiplications, 2 additions and 1 comparison:
// 9 FP64 instructions, none of which may fuse. At n = 19,163 and
// min_gap = 100 that is 181.7 M pairs; on the H100's 132 SMs x 64 FP64
// lanes it is about 0.1 ms, and the 0.5 MB of poses are negligible, so at
// large n the bound is FP64 issue: an SM issues one instruction a cycle
// on each of its 4 schedulers while its FP64 lanes take 2 cycles a warp
// instruction, so the other instructions of a pair must stay well under 9.
// At the published trajectory sizes (1,926 to 4,000 poses: 10 to 64
// tiles) the pairs take a few microseconds of FP64, and the time is
// launch latency plus how well the blocks fill the card.
//
// Design, for each of the two:
// - Fill. A listed tile is cut into 2^log_split blocks (the caller picks
//   log_split from the tile count and the SM count): 2^(log_split/2) row
//   strips times 2^((log_split+1)/2) column strips. Block b works on tile
//   b >> log_split, part b & (2^log_split - 1), row strip part / column
//   strips, column strip part % column strips. A block that holds no
//   index-valid pair (wholly below the diagonal, or past n) exits at once.
//   At small n the cut gives every SM blocks; at large n small blocks
//   keep the last wave short.
// - Issue. 128 threads a block; each thread keeps kRows = 4 consecutive rows
//   in registers and walks every (row strips)-th column of its strip, so
//   one read of a column from shared memory (x, y as one 16-byte load;
//   z and the floor's bits as another) serves 4 pairs. The threads of one
//   row group walk neighbouring columns, the row groups of a warp read the
//   same ones (a broadcast), with no bank conflict. The column stride is a
//   template constant (one instance per row-strip count), so the unrolled
//   loop addresses shared memory with immediate offsets. A pair counts
//   with one integer compare and two predicated adds (inline PTX: left to
//   itself the compiler spends an add and a select on each count). Rows
//   past n hold NaN, which fails d2 <= r2, so the inner loop has no bounds
//   test; the first columns of a thread (where its 4 rows' j - i >= min_gap
//   starts) are a short head loop that tests each row.

// Counting: per-thread 32-bit counts (at most 4 * 512 per thread), a warp
// shuffle reduction, per-warp partial sums in shared memory, and one
// atomicAdd per block on each of two unsigned 64-bit counters
// (total, same_floor). cross = total - same is formed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;    // rows and columns per tile, as in the TPU kernel
constexpr int kThreads = 128; // 4 warps
constexpr int kRows = 4;      // rows a thread keeps in registers
constexpr int kMaxLogSplit = 8;  // row strips 2^0 .. 2^4: one kernel instance each

// an uncut tile's rows are one row group a thread, so a cut into 2^r row
// strips spreads each row group over 2^r threads
static_assert(kThreads * kRows == kTile, "the threads of a block hold a tile's rows");

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One pair: the float64 arithmetic of the TPU kernel's host recount.
__device__ __forceinline__ void count_pair(double xi, double yi, double zi, int fi, double2 xy,
                                           double2 zf, double r2, unsigned& tot,
                                           unsigned& same) {
  const double dx = __dsub_rn(xi, xy.x);
  const double dy = __dsub_rn(yi, xy.y);
  const double dz = __dsub_rn(zi, zf.x);
  const double d2 =
      __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
  // hit = d2 <= r2 (ordered: NaN fails); tot += hit; same += hit && fi == fj,
  // as two predicated adds (left to itself the compiler spends two
  // instructions on each count)
  asm("{\n\t.reg .pred hit, both;\n\t"
      "setp.le.f64 hit, %2, %3;\n\t"
      "setp.eq.and.s32 both, %4, %5, hit;\n\t"
      "@hit add.u32 %0, %0, 1;\n\t"
      "@both add.u32 %1, %1, 1;\n\t}"
      : "+r"(tot), "+r"(same)
      : "d"(d2), "d"(r2), "r"(fi), "r"(__double2loint(zf.y)));
}

// kLogRs: log2 of the row strips a tile is cut into (log_split / 2), fixed
// at compile time so that the column stride of the inner loop is a constant
template <int kLogRs>
__global__ void __launch_bounds__(kThreads)
tri_count_kernel(const double* __restrict__ pos,   // (n, 3) float64
                 const int* __restrict__ floors,   // (n,) int32
                 const int* __restrict__ tile_i,   // (n_tiles,) row-tile index
                 const int* __restrict__ tile_j,   // (n_tiles,) col-tile index
                 int n, int min_gap, double r2, int log_split,
                 unsigned long long* __restrict__ out) {  // [total, same]
  __shared__ double2 sxy[kTile];  // (x, y) of each column
  __shared__ double2 szf[kTile];  // (z, floor bits in the low word)
  __shared__ unsigned warp_tot[kThreads / 32], warp_same[kThreads / 32];

  constexpr int log_rs = kLogRs;            // row strips 2^log_rs
  const int log_cs = log_split - log_rs;    // column strips 2^log_cs
  const int part = blockIdx.x & ((1 << log_split) - 1);
  const int tile = blockIdx.x >> log_split;
  const int strip_rows = kTile >> log_rs, strip_cols = kTile >> log_cs;
  const int i0 = tile_i[tile] * kTile + (part >> log_cs) * strip_rows;
  const int j0 = tile_j[tile] * kTile + (part & ((1 << log_cs) - 1)) * strip_cols;
  const int n_cols = min(strip_cols, n - j0);  // columns past n are never read
  // the whole block leaves if it holds no index-valid pair
  if (i0 >= n || n_cols <= 0 || (long long)j0 + n_cols - 1 - i0 < min_gap) return;

  const int tid = threadIdx.x;
  for (int c = tid; c < n_cols; c += kThreads) {
    const int j = j0 + c;
    sxy[c] = make_double2(pos[3 * (size_t)j + 0], pos[3 * (size_t)j + 1]);
    szf[c] = make_double2(pos[3 * (size_t)j + 2], __hiloint2double(0, floors[j]));
  }

  // thread layout: row groups of kRows rows, each spread over `lanes`
  // threads that walk every lanes-th column
  constexpr int lanes = 1 << log_rs;
  const int lane = tid & (lanes - 1);
  const int ib = i0 + (tid >> log_rs) * kRows;
  double xi[kRows], yi[kRows], zi[kRows];
  int fi[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = ib + k;
    if (i < n) {
      xi[k] = pos[3 * (size_t)i + 0];
      yi[k] = pos[3 * (size_t)i + 1];
      zi[k] = pos[3 * (size_t)i + 2];
      fi[k] = floors[i];
    } else {  // NaN fails d2 <= r2: a row past n counts nothing
      xi[k] = yi[k] = zi[k] = __longlong_as_double(0x7ff8000000000000LL);
      fi[k] = 0;
    }
  }
  __syncthreads();

  // row ib + k pairs with local column c iff c >= first + k
  const long long first = (long long)ib + min_gap - j0;
  const int head = (int)max(0LL, min(first, (long long)n_cols));
  const int body = (int)max(0LL, min(first + kRows - 1, (long long)n_cols));
  int c = head + ((lane - head) & (lanes - 1));  // first column of this thread >= head
  unsigned tot = 0, same = 0;
  for (; c < body; c += lanes) {  // at most kRows - 1 columns: test each row
    const double2 xy = sxy[c], zf = szf[c];
    const int d = (int)(c - first);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (d >= k) count_pair(xi[k], yi[k], zi[k], fi[k], xy, zf, r2, tot, same);
  }
#pragma unroll 8
  for (; c < n_cols; c += lanes) {
    const double2 xy = sxy[c], zf = szf[c];
#pragma unroll
    for (int k = 0; k < kRows; ++k) count_pair(xi[k], yi[k], zi[k], fi[k], xy, zf, r2, tot, same);
  }

  tot = warp_sum(tot);
  same = warp_sum(same);
  const int warp = tid >> 5, wl = tid & 31;
  if (wl == 0) {
    warp_tot[warp] = tot;
    warp_same[warp] = same;
  }
  __syncthreads();
  if (warp == 0) {
    tot = wl < kThreads / 32 ? warp_tot[wl] : 0u;
    same = wl < kThreads / 32 ? warp_same[wl] : 0u;
    tot = warp_sum(tot);
    same = warp_sum(same);
    if (wl == 0) {
      if (tot) atomicAdd(&out[0], (unsigned long long)tot);
      if (same) atomicAdd(&out[1], (unsigned long long)same);
    }
  }
}

}  // namespace

// 2^log_split blocks per listed tile on the given stream. `out` holds two
// zeroed 64-bit counters. Returns cudaGetLastError() after the launch
// (0 = ok), or cudaErrorInvalidValue for a log_split outside [0, 8] or a
// grid past 2^31 - 1 blocks.
extern "C" int mlis_tri_count(const double* pos, const int* floors, const int* tile_i,
                              const int* tile_j, int n_tiles, int n, int min_gap,
                              double r2, int log_split, unsigned long long* out,
                              void* stream) {
  if (log_split < 0 || log_split > kMaxLogSplit ||
      (long long)n_tiles << log_split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const dim3 grid(n_tiles << log_split);
    cudaStream_t s = (cudaStream_t)stream;
    switch (log_split >> 1) {
#define MLIS_TRI_COUNT_CASE(R)                                                           \
  case R:                                                                                \
    tri_count_kernel<R><<<grid, kThreads, 0, s>>>(pos, floors, tile_i, tile_j, n,       \
                                                  min_gap, r2, log_split, out);         \
    break;
      MLIS_TRI_COUNT_CASE(0)
      MLIS_TRI_COUNT_CASE(1)
      MLIS_TRI_COUNT_CASE(2)
      MLIS_TRI_COUNT_CASE(3)
      MLIS_TRI_COUNT_CASE(4)
#undef MLIS_TRI_COUNT_CASE
    }
  }
  return (int)cudaGetLastError();
}
