// Dense multi-channel histogram kernel K2 for Hopper (sm_90a):
//
//   out[f, b, c] = sum_r gh[r, c] * (bins[f, r] == b)
//
// over bins [F, N] u8 and gh [N, C] f32 (C a multiple of kCh = 32), in f32.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py _hist_kernel /
// hist_pallas_channels (and the single-leaf form hist_pallas_fm).  The
// Pallas kernel multiplies a one-hot [rows, B] factor built in VMEM with
// the [rows, 128] channel block on the MXU at HIGHEST precision.  On
// Hopper that product would cost 2*F*B*N*C operations (1.8 TFLOP at 1M x
// 28 x 256 x 128, ~5 ms in three bf16 passes); a scatter does F*N*C adds.
//
// One owner per cell.  A work item is (row chunk, channel group of 32, 4
// features); a block walks items in a fixed order and keeps the item's
// [4][B][32] f32 histogram in shared memory (128 KB at B = 256).  Warp w
// owns feature w % 4 of the group and the bins of range w / 4 (8 ranges of
// B / 8 bins), lane l channel l: every cell has one owning thread, which
// adds with plain loads and stores, never an atomic.  Per tile of 256 rows
// the block stages the rows' 32 channels (cp.async, double-buffered, so
// the next tile's copy runs under this tile's adds) and their 4 bins; a
// warp takes 64 rows at a time, finds with two ballots the rows whose bin
// falls in its range, and adds them kBatch at a time (add_batch): rows of
// one bin are summed in registers first, and the batch's cells are all
// read before any is written.  The item's histogram goes to its row
// chunk's slice of the workspace [chunks][F][B][C] with plain stores;
// hist_channels_reduce sums the chunks in order.  Every sum is taken in
// an order fixed by the inputs and the launch geometry, so two launches
// with the same inputs are bit-equal.
//
// What bounds it.  The byte bound is F*N bin bytes and 4*N*C bytes of gh
// read once and 4*F*B*C bytes written.  This design reads gh once per
// group of 4 features (the 7 blocks of a row chunk and channel group run
// side by side, so L2 serves the repeats), and each add of 32 channels
// takes four shared-memory transactions (the bin, the staged value, the
// cell read and written) and about a dozen instructions: the SMs' issue
// and shared-memory rates bound it, then the staging of gh (PERF.md has
// the breakdown, from lightgbm_tpu_torch/tools/k1_variants.py).  A batch
// of 8 rows was slower than 4 (its merging compares grow as the square);
// 4 ran within 5% of one row at a time on spread bins and a third faster
// on bins that put most rows in one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;                       // channels of a work item
constexpr int kFeat = 4;                      // features of a work item
constexpr int kRanges = 8;                    // bin ranges, a warp each
constexpr int kThreads = 32 * kFeat * kRanges;
constexpr int kTile = 256;                    // rows staged at once
constexpr int kBatch = 4;                     // rows a warp adds per step
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies rows [rs, rs + n) of channels [c0, c0 + kCh) of gh into a tile.
__device__ __forceinline__ void stage_gh(float* tile, const float* gh,
                                         int C, int c0, int rs, int n) {
  for (int j = threadIdx.x; j < kTile * (kCh / 4); j += blockDim.x) {
    const int row = j / (kCh / 4);
    const int part = j % (kCh / 4);
    if (row < n) {
      cp_async16(tile + row * kCh + 4 * part,
                 gh + static_cast<size_t>(rs + row) * C + c0 + 4 * part);
    }
  }
}

// Bin of this thread's (feature, row) of the tile at rs (0 past the rows).
__device__ __forceinline__ uint8_t tile_bin(const uint8_t* bins, int N,
                                            int f0, int nf, int rs, int n) {
  const int f = threadIdx.x / kTile;
  const int row = threadIdx.x % kTile;
  return f < nf && row < n
             ? bins[static_cast<size_t>(f0 + f) * N + rs + row]
             : static_cast<uint8_t>(0);
}

// Adds a batch of kBatch rows into this lane's channel of ``own``: row u
// has bin bj[u] (-1: no row) and value v[u].  Rows of one bin are summed
// into the first of them (in row order), then every cell of the batch is
// read before any is written, so the batch's reads run in parallel.  The
// bins are the same in every lane of the warp.
__device__ __forceinline__ void add_batch(float* own, int lane,
                                          const int (&bj)[kBatch],
                                          float (&v)[kBatch]) {
  bool ok[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) ok[u] = bj[u] >= 0;
#pragma unroll
  for (int u = 1; u < kBatch; ++u) {
#pragma unroll
    for (int w = 0; w < u; ++w) {
      if (ok[u] && ok[w] && bj[w] == bj[u]) {
        v[w] += v[u];
        ok[u] = false;
      }
    }
  }
  float cell[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (ok[u]) cell[u] = own[bj[u] * kCh + lane];
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (ok[u]) own[bj[u] * kCh + lane] = cell[u] + v[u];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
hist_channels_rows(const uint8_t* __restrict__ bins,
                   const float* __restrict__ gh, int F, int N, int B, int C,
                   int chunks, float* __restrict__ ws) {
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                                   // [kFeat][B][kCh]
  float* tiles = hist + kFeat * B * kCh;                // [2][kTile][kCh]
  // [2][kFeat][kTile]
  uint8_t* tbins = reinterpret_cast<uint8_t*>(tiles + 2 * kTile * kCh);
  const int groups = (F + kFeat - 1) / kFeat;
  const int cgroups = C / kCh;
  const int items = chunks * cgroups * groups;
  const int rows_per_chunk = (N + chunks - 1) / chunks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fl = warp % kFeat;                    // the warp's feature
  const int width = (B + kRanges - 1) / kRanges;
  const int lo = warp / kFeat * width;            // its bins [lo, hi)
  const int hi = min(B, lo + width);
  float* own = hist + fl * B * kCh;

  // items in the order (chunk, channel group, feature group): the blocks
  // running at once share row chunks and channel groups, so each staged
  // slice of gh is read from the card's memory once and from L2 after
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int fg = item % groups;
    const int cg = item / groups % cgroups;
    const int chunk = item / (groups * cgroups);
    const int f0 = fg * kFeat;
    const int nf = min(kFeat, F - f0);
    const int r0 = min(N, chunk * rows_per_chunk);
    const int r1 = min(N, r0 + rows_per_chunk);
    const int ntiles = (r1 - r0 + kTile - 1) / kTile;
    for (int i = threadIdx.x; i < kFeat * B * kCh; i += blockDim.x) {
      hist[i] = 0.0f;
    }
    if (ntiles > 0) {
      stage_gh(tiles, gh, C, cg * kCh, r0, min(kTile, r1 - r0));
      tbins[threadIdx.x] = tile_bin(bins, N, f0, nf, r0, r1 - r0);
    }
    cp_async_commit();
    __syncthreads();

    for (int t = 0; t < ntiles; ++t) {
      const int p = t & 1;
      const int rs = r0 + t * kTile;
      const int n = min(kTile, r1 - rs);
      const bool next = t + 1 < ntiles;
      uint8_t nb = 0;
      if (next) {
        const int rn = rs + kTile;
        stage_gh(tiles + (p ^ 1) * kTile * kCh, gh, C, cg * kCh, rn,
                 min(kTile, r1 - rn));
        nb = tile_bin(bins, N, f0, nf, rn, r1 - rn);
      }
      cp_async_commit();
      cp_async_wait_one();            // this tile's copy has landed
      __syncthreads();
      if (fl < nf) {
        const uint8_t* tb = tbins + p * kFeat * kTile + fl * kTile;
        const float* tg = tiles + p * kTile * kCh + lane;
        for (int g0 = 0; g0 < n; g0 += 64) {
          // the rows of these 64 whose bin is in this warp's range
          const int b0 = g0 + lane < n ? tb[g0 + lane] : -1;
          const int b1 = g0 + 32 + lane < n ? tb[g0 + 32 + lane] : -1;
          unsigned long long mine =
              __ballot_sync(kFullWarp, b0 >= lo && b0 < hi) |
              static_cast<unsigned long long>(
                  __ballot_sync(kFullWarp, b1 >= lo && b1 < hi))
                  << 32;
          while (mine != 0) {
            int bj[kBatch];
            float v[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int j = __ffsll(mine) - 1;      // -1: none left
              mine &= mine - 1;
              bj[u] = j >= 0 ? tb[g0 + j] : -1;
              v[u] = j >= 0 ? tg[(g0 + j) * kCh] : 0.0f;
            }
            add_batch(own, lane, bj, v);
          }
        }
      }
      if (next) tbins[(p ^ 1) * kFeat * kTile + threadIdx.x] = nb;
      __syncthreads();
    }
    __syncthreads();

    float* out = ws + (static_cast<size_t>(chunk) * F + f0) * B * C +
                 cg * kCh;
    for (int i = threadIdx.x; i < nf * B * kCh; i += blockDim.x) {
      out[static_cast<size_t>(i / kCh) * C + i % kCh] = hist[i];
    }
    __syncthreads();
  }
}

__global__ void hist_channels_reduce(const float* __restrict__ ws,
                                     int chunks, long long total,
                                     float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k) acc += ws[k * total + idx];
  out[idx] = acc;
}

}  // namespace

extern "C" int lgbm_hist_channels_smem_bytes(int B) {
  return (kFeat * B * kCh + 2 * kTile * kCh) *
             static_cast<int>(sizeof(float)) +
         2 * kFeat * kTile;
}

// Launches both passes on ``stream``: ``grid`` blocks over the work items
// of ``chunks`` row chunks; ``ws`` is f32 [chunks, F, B, C].  Returns
// cudaGetLastError() after the launches (0 = ok).
extern "C" int lgbm_hist_channels(const uint8_t* bins, const float* gh,
                                  int F, int N, int B, int C, int chunks,
                                  int grid, float* ws, float* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = lgbm_hist_channels_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      hist_channels_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F > 0 && C > 0) {
    hist_channels_rows<<<grid, kThreads, smem, st>>>(bins, gh, F, N, B, C,
                                                      chunks, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(F) * B * C;
  if (total > 0) {
    hist_channels_reduce<<<static_cast<unsigned>((total + 255) / 256), 256,
                           0, st>>>(ws, chunks, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}
