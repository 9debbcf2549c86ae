// Wave histogram kernel K1 for Hopper (sm_90a): one wave's per-leaf
// (g, h, count) histograms, in the packed lane-pair layout or the triple
// layout, optionally with the fused sibling = parent - child.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py _hist_wave_kernel /
// hist_pallas_wave.  The Pallas kernel turns accumulation into one-hot
// MXU matmuls because a TPU has no fast scatter; Hopper scatters instead,
// with one design for the float modes and another for the integer ones.
//
// Float modes (highest, bf16, 2xbf16): one pass over the rows into an f32
// accumulator [F][B][S][4] of 16-byte cells (g, h, count, 0) in device
// memory, zeroed by the wrapper (28 x 256 x 63 x 16 B = 7.2 MB at the main
// shape, resident in the 50 MB L2), then an epilogue.  Every row is
// loaded, mapped leaf -> slot (a table in shared memory) and rounded once,
// and features are an inner loop (a warp of consecutive rows reads 32
// contiguous bytes of bins[f]; kRun loads are issued before their adds).
// For each feature the lanes of a warp that hit the same cell are grouped
// with __match_any_sync and summed with shuffles (group_sum), so one lane
// a group adds: on a feature with few bins, or a wave with one slot, a
// whole warp would otherwise add into one cell.  The pass has two forms:
//
//   hist_wave_float_rows: a grid-stride loop, one thread a row; each
//     group's sum is one L2 vector reduction, atomicAdd(float4*), which
//     compiles to REDG.E.ADD.F32x4 (the thread does not wait on it).  The
//     L2 applies a 16-byte reduction at about the rate of a 4-byte one
//     (lightgbm_tpu_torch/tools/l2_reduction_rate.cu), so one reduction
//     per (row in a slot, feature) is this form's limit.
//   hist_wave_float_private: for a wave whose whole [F][B][S][3] histogram
//     fits in a block's shared memory (kPrivCap: the root and the next
//     waves, S <= 2 at F = 28, B = 256).  Each block stages 1,024 rows
//     (rounded values and slot) in shared memory, then warp w takes
//     features w, w + 32, ...: one warp alone writes a feature's cells, so
//     it adds with plain loads and stores, no atomics (add_private).  Its
//     lanes settle who adds into a cell with one round of tags in shared
//     memory (each lane writes its id to the cell's tag, the lane whose id
//     stays adds) and group_sum for the lanes left; a warp whose last
//     grouping merged many lanes (a feature with few bins) groups at once.
//     __match_any_sync is the costly step on Hopper, and on spread bins
//     the tag round leaves few lanes for it.  At the end the block reduces
//     its nonzero cells into the accumulator.  These waves hold most rows
//     (the root wave holds all of them) and concentrate them on few cells,
//     where the L2 form is slowest.
//
//   epilogue (hist_wave_epilogue): reads the accumulator once, writes the
//     output layout and, when fused, sibling = parent - child.
//
// No float form adds into shared memory with atomics: f32 shared adds are
// compare-and-swap loops on Hopper (ATOMS.CAST.SPIN), and a [B][S][3]
// histogram per feature block leaves one block per SM at 63 slots.
//
// Integer modes (int16, int8): the row vectors travel as [N, 4] int16 (8
// bytes a row) and accumulate in int32, whose shared-memory atomics are
// single instructions (ATOMS.ADD) and order-free: the result is exact and
// deterministic.
//
//   rows (hist_wave_int_rows): block (f, chunk) takes feature f and one
//     chunk of rows, adds (g, h, count) into a privatized [B][S][3] int32
//     histogram in shared memory, and stores it to its own slice of the
//     workspace [chunks][F][B][S][3].  |q| <= 32767, so one cell of one
//     block takes at most 65,535 rows before an int32 sum could wrap; the
//     wrapper caps the rows of a chunk there.
//   epilogue: sums the chunk partials in int64 in chunk order and converts
//     to f32 once, so the output holds the integer totals, exact below
//     2^24.  (The Pallas kernel accumulates the same integers in f32:
//     exact while every cell stays below 2^24; above that the two differ
//     only by the f32 rounding of the same integer total.)
//
// The integer modes keep this design: their int32 shared adds are native
// and exact.  The accumulator design would need 64-bit reductions for them
// (an int32 cell can wrap past 65,535 rows) at twice the bytes a cell.
//
// Layouts (``stride`` = lanes per slot): packed (2) puts slot s's g, h in
// lanes 2s, 2s+1 of one [F, B, 128] output and its count in lane s of a
// second; triple (3) puts g, h, count in lanes 3s, 3s+1, 3s+2 of one.
//
// Rounding.  Float modes round g/h as the MXU passes do (2xbf16: hi =
// bf16(x), lo = bf16(x - hi), value hi + lo, exact in f32; bf16: hi;
// highest: x).  The packed count goes through bf16 in every mode, as the
// Pallas count pass does; the triple count lane takes the mode's rounding
// like g and h.  The f32 reductions add in an order that changes from run
// to run.  Dequantization of the int modes stays out of the kernel (the
// wave grower scales at split-scan time), and the build passes -fmad=false
// so no multiply-add is ever contracted.
//
// What bounds it.  The byte bound per launch is the [F, N] u8 bins read
// once (F*N bytes), the row vectors (16*N bytes, 8*N quantized) and the
// [F, B, 128] f32 histograms (one or two outputs, plus parent in / sibling
// out when fused).  The float pass reads each of those once; the L2's
// reduction rate (one per row in a slot and feature) bounds the L2 form,
// the per-warp settling of cells (tags, shuffles, __match_any_sync) and
// its shared-memory adds the private form.  The int
// pass rereads the row vectors once per feature (from L2) and is limited
// by its shared atomics, one block per SM at 63 slots.
//
// Preconditions (the wave grower meets them): the ``stride`` lanes of each
// slot s < S map to one leaf, lanes from stride*S on are unused (-1), no
// leaf appears in two slots, S <= 63 packed / 42 triple and B <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;      // channel lanes of an output
constexpr int kMaxSlots = 64;
constexpr int kTable = 4096;     // leaf ids with a direct slot lookup
constexpr int kIntThreads = 512;
constexpr int kFloatThreads = 256;
constexpr int kPrivThreads = 1024;
constexpr int kPrivCap = 200 * 1024;   // privatized histogram + tags, bytes
constexpr int kRun = 4;          // bin loads in flight per thread
constexpr int kCrowded = 8;      // lanes a grouping merges when crowded
constexpr unsigned kFullWarp = 0xffffffffu;

enum Mode { kHighest = 0, kTwoBf16 = 1, kBf16 = 2, kInt16 = 3, kInt8 = 4 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_mode(float x, int mode) {
  if (mode == kHighest) return x;
  const float hi = bf16_round(x);
  if (mode == kBf16) return hi;
  return hi + bf16_round(x - hi);
}

// The slot lookup of a block: slot_of[s] = the leaf of slot s, and
// table[leaf] = its slot for leaf ids below kTable (-1: in no slot).
__device__ void load_slots(const int* slot_leaf, int S, int stride,
                           int* slot_of, signed char* table) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) table[i] = -1;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    slot_of[i] = slot_leaf[stride * i];
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int leaf = slot_of[i];
    if (leaf >= 0 && leaf < kTable) table[leaf] = static_cast<signed char>(i);
  }
  __syncthreads();
}

__device__ __forceinline__ int find_slot(int leaf, int S, const int* slot_of,
                                         const signed char* table) {
  if (leaf >= 0 && leaf < kTable) return table[leaf];
  if (leaf >= kTable) {
    for (int j = 0; j < S; ++j) {
      if (slot_of[j] == leaf) return j;
    }
  }
  return -1;
}

// Sums (g, h, c) over ``peers`` (this lane's group: the lanes of the warp
// with the same cell) into the group's lowest lane, in ceil(log2(group
// size)) rounds: each round every lane adds the running sum of its next
// remaining peer, then the lanes of odd rank drop out.  Every lane of the
// warp calls it; a lane alone in its group passes its own bit.
__device__ __forceinline__ void sum_peers(unsigned peers, int lane, float& g,
                                          float& h, float& c) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & ~((2u << lane) - 1u);   // peers above this lane
  while (__any_sync(kFullWarp, rest != 0)) {
    const int next = __ffs(rest) - 1;              // -1: none left
    const float tg = __shfl_sync(kFullWarp, g, next & 31);
    const float th = __shfl_sync(kFullWarp, h, next & 31);
    const float tc = __shfl_sync(kFullWarp, c, next & 31);
    if (next >= 0) {
      g += tg;
      h += th;
      c += tc;
    }
    rest &= ~__ballot_sync(kFullWarp, rank & 1u);
    rank >>= 1;
  }
}

__device__ __forceinline__ void reduce_cell(float* cell, float g, float h,
                                            float c) {
  atomicAdd(reinterpret_cast<float4*>(cell), make_float4(g, h, c, 0.0f));
}

// Groups the lanes of the warp by ``key`` (the cell; -1: none) and sums
// each group's (g, h, c) into its lowest lane, which gets true back.
// Every lane of the warp calls it.
__device__ __forceinline__ bool group_sum(int key, int lane, float& g,
                                          float& h, float& c) {
  unsigned peers = __match_any_sync(kFullWarp, key);
  if (key < 0) peers = 1u << lane;
  sum_peers(peers, lane, g, h, c);
  return key >= 0 && lane == __ffs(peers) - 1;
}

// Adds each lane's (g, h, c) into cell ``key`` (-1: none) of ``hist``
// ([cells][3] f32 in shared memory that this warp alone writes) with
// plain loads and stores.  Not ``crowded``: first one round of tags, in
// which each lane writes its id to tags[key] and the lane whose id stays
// adds; the lanes left (cells that two or more lanes hit) then group with
// group_sum.  ``crowded``: every lane groups at once, since a round of
// tags would settle few.  Sets ``crowded`` when grouping merged more than
// kCrowded lanes, as it does on a feature with few bins.  Every lane of
// the warp calls it; the caller orders consecutive calls with __syncwarp.
__device__ __forceinline__ void add_private(float* hist, uint8_t* tags,
                                            int key, int lane, float g,
                                            float h, float c, bool& crowded) {
  bool todo = key >= 0;
  float* cell = hist + 3 * key;
  unsigned left = __ballot_sync(kFullWarp, todo);
  if (!crowded && left != 0) {
    if (todo) tags[key] = static_cast<uint8_t>(lane);
    __syncwarp();
    if (todo && tags[key] == lane) {
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
      todo = false;
    }
    __syncwarp();    // orders the winners' adds before the groups'
    left = __ballot_sync(kFullWarp, todo);
  }
  if (left != 0) {
    const bool lead = group_sum(todo ? key : -1, lane, g, h, c);
    if (lead) {
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
    }
    crowded = __popc(left) - __popc(__ballot_sync(kFullWarp, lead)) >
              kCrowded;
  }
}

// The row pass into ``acc``: each group's sum is one L2 vector reduction.
__global__ void __launch_bounds__(kFloatThreads)
hist_wave_float_rows(const uint8_t* __restrict__ bins,
                     const float4* __restrict__ vecs,
                     const int* __restrict__ slot_leaf, int F, int N, int B,
                     int S, int stride, int mode, float* __restrict__ acc) {
  __shared__ int slot_of[kMaxSlots];
  __shared__ signed char table[kTable];
  load_slots(slot_leaf, S, stride, slot_of, table);

  const int lane = threadIdx.x & 31;
  const size_t rows = static_cast<size_t>(N);
  const size_t feature_cells = static_cast<size_t>(B) * S;
  // a warp's lanes run the same iterations (the shuffles need all 32)
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < N;
       base += gridDim.x * blockDim.x) {
    const int r = base + lane;
    int s = -1;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < N) {
      v = __ldcs(vecs + r);
      s = find_slot(static_cast<int>(v.w), S, slot_of, table);
    }
    const bool live = s >= 0;
    if (__ballot_sync(kFullWarp, live) == 0) continue;
    const float g = round_mode(v.x, mode);
    const float h = round_mode(v.y, mode);
    const float c = stride == 2 ? bf16_round(v.z) : round_mode(v.z, mode);
    const uint8_t* col = bins + r;
    for (int f0 = 0; f0 < F; f0 += kRun) {
      int b[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        const int f = f0 + u;
        b[u] = live && f < F ? __ldcs(col + f * rows) : B;
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        const int f = f0 + u;
        if (f >= F) break;
        // the Pallas one-hot has no lane for a bin >= B either
        const int key = b[u] < B ? b[u] * S + s : -1;   // the cell in f
        float gs = g, hs = h, cs = c;
        if (group_sum(key, lane, gs, hs, cs)) {
          reduce_cell(acc + 4 * (f * feature_cells + key), gs, hs, cs);
        }
      }
    }
  }
}

// The row pass of a wave whose whole histogram fits in shared memory:
// each block keeps a private [F][B][S][3] f32 copy, adds into it without
// atomics, and reduces its nonzero cells into ``acc`` once at the end.
// Per step the block stages kPrivThreads rows (rounded g, h, count and
// slot) in shared memory; then warp w takes features w, w + 32, ..., so
// one warp alone writes a feature's cells, and add_private settles which
// lane adds into which cell.  Each (step, feature) starts not crowded.
__global__ void __launch_bounds__(kPrivThreads)
hist_wave_float_private(const uint8_t* __restrict__ bins,
                        const float4* __restrict__ vecs,
                        const int* __restrict__ slot_leaf, int F, int N,
                        int B, int S, int stride, int mode,
                        float* __restrict__ acc) {
  __shared__ int slot_of[kMaxSlots];
  __shared__ signed char table[kTable];
  __shared__ float4 stage[kPrivThreads];     // (g, h, count, slot or -1)
  extern __shared__ float priv[];            // [F][B][S][3], then tags
  const int feature_cells = B * S;
  const int cells = F * feature_cells;
  uint8_t* tags = reinterpret_cast<uint8_t*>(priv + 3 * cells);  // [F][B][S]
  for (int i = threadIdx.x; i < 3 * cells; i += blockDim.x) priv[i] = 0.0f;
  load_slots(slot_leaf, S, stride, slot_of, table);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int base = blockIdx.x * kPrivThreads; base < N;
       base += gridDim.x * kPrivThreads) {
    const int r = base + threadIdx.x;
    float4 row = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
    if (r < N) {
      const float4 v = __ldcs(vecs + r);
      const int s = find_slot(static_cast<int>(v.w), S, slot_of, table);
      if (s >= 0) {
        row = make_float4(round_mode(v.x, mode), round_mode(v.y, mode),
                          stride == 2 ? bf16_round(v.z)
                                      : round_mode(v.z, mode),
                          static_cast<float>(s));
      }
    }
    stage[threadIdx.x] = row;
    __syncthreads();
    for (int f = warp; f < F; f += warps) {
      const uint8_t* col = bins + static_cast<size_t>(f) * N + base;
      float* hist = priv + 3 * f * feature_cells;
      uint8_t* ftags = tags + f * feature_cells;
      bool crowded = false;
      for (int j0 = 0; j0 < kPrivThreads; j0 += 32 * kRun) {
        int b[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int j = j0 + 32 * u + lane;
          b[u] = stage[j].w >= 0.0f ? __ldcs(col + j) : B;
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const float4 x = stage[j0 + 32 * u + lane];
          const int key = b[u] < B ? b[u] * S + static_cast<int>(x.w) : -1;
          add_private(hist, ftags, key, lane, x.x, x.y, x.z, crowded);
          __syncwarp();    // orders this step's writes before the next's
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float* p = priv + 3 * i;
    if (p[0] != 0.0f || p[1] != 0.0f || p[2] != 0.0f) {
      reduce_cell(acc + 4 * static_cast<size_t>(i), p[0], p[1], p[2]);
    }
  }
}

__global__ void __launch_bounds__(kIntThreads)
hist_wave_int_rows(const uint8_t* __restrict__ bins,
                   const short4* __restrict__ vecs,
                   const int* __restrict__ slot_leaf, int F, int N, int B,
                   int S, int stride, int rows_per_chunk,
                   int* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = B * S * 3;
  int* hist = reinterpret_cast<int*>(smem);                // [B][S][3]
  int* slot_of = hist + cells;                             // [kMaxSlots]
  signed char* table =
      reinterpret_cast<signed char*>(slot_of + kMaxSlots); // [kTable]

  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  load_slots(slot_leaf, S, stride, slot_of, table);

  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(N, r0 + rows_per_chunk);
  const uint8_t* col = bins + static_cast<size_t>(f) * N;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const short4 v = vecs[r];
    const int s = find_slot(v.w, S, slot_of, table);
    if (s < 0) continue;
    const int b = col[r];
    if (b >= B) continue;   // the Pallas one-hot has no lane for it either
    int* cell = hist + (b * S + s) * 3;
    atomicAdd(cell, static_cast<int>(v.x));
    atomicAdd(cell + 1, static_cast<int>(v.y));
    atomicAdd(cell + 2, static_cast<int>(v.z));
  }
  __syncthreads();

  int* out = ws + (static_cast<size_t>(chunk) * F + f) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = hist[i];
}

// Sum of one (bin, slot, k) cell over the chunk partials, in chunk order:
// f32 for the float accumulator (one chunk), int64 converted to f32 once
// for the int workspace.
__device__ __forceinline__ float chunk_sum(const float* ws, size_t at,
                                           size_t chunk_stride, int chunks) {
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k) acc += ws[k * chunk_stride + at];
  return acc;
}

__device__ __forceinline__ float chunk_sum(const int* ws, size_t at,
                                           size_t chunk_stride, int chunks) {
  long long acc = 0;
  for (int k = 0; k < chunks; ++k) acc += ws[k * chunk_stride + at];
  return __ll2float_rn(acc);
}

// ``width``: values per (bin, slot) cell of ``ws`` (3 int, 4 float).
template <typename Acc>
__global__ void hist_wave_epilogue(const Acc* ws, int F, int B, int S,
                                   int stride, int width, int chunks,
                                   const float* par0, const float* par1,
                                   float* out0, float* out1, float* sib0,
                                   float* sib1) {
  const int total = F * B * kLanes;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = idx % kLanes;
  const int fb = idx / kLanes;                 // f * B + b
  const size_t chunk_stride = static_cast<size_t>(F) * B * S * width;
  const size_t cell = static_cast<size_t>(fb) * S * width;
  if (stride == 2) {
    const int s = c >> 1;
    const float gh = s < S ? chunk_sum(ws, cell + s * width + (c & 1),
                                       chunk_stride, chunks) : 0.0f;
    const float ct = c < S ? chunk_sum(ws, cell + c * width + 2,
                                       chunk_stride, chunks) : 0.0f;
    out0[idx] = gh;
    out1[idx] = ct;
    if (sib0 != nullptr) {
      sib0[idx] = par0[idx] - gh;
      sib1[idx] = par1[idx] - ct;
    }
  } else {
    const int s = c / 3;
    const float v = s < S ? chunk_sum(ws, cell + s * width + c % 3,
                                      chunk_stride, chunks) : 0.0f;
    out0[idx] = v;
    if (sib0 != nullptr) sib0[idx] = par0[idx] - v;
  }
}

// Blocks of a float row-pass kernel the card holds at once with ``smem``
// bytes of dynamic shared memory.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * per_sm;
}

// The float row pass.  A wave whose whole histogram and its tags fit
// kPrivCap takes the privatized pass when each block gets at least twice as many rows as
// a feature has cells (its final flush then costs less than its rows);
// every other wave reduces straight into ``acc``.  The grid is the blocks
// the card holds at once (more would run as a second, partial wave), or
// fewer for few rows.
int launch_float_rows(const uint8_t* bins, const float4* vecs,
                      const int* slot_leaf, int F, int N, int B, int S,
                      int stride, int mode, float* acc, cudaStream_t st) {
  // f32 (g, h, count) and a one-byte tag per cell
  const long long priv = (3LL * sizeof(float) + 1) * F * B * S;
  if (priv <= kPrivCap) {
    const int smem = static_cast<int>(priv);
    const cudaError_t err = cudaFuncSetAttribute(
        hist_wave_float_private, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = min((N + kPrivThreads - 1) / kPrivThreads,
                         resident_blocks(hist_wave_float_private,
                                         kPrivThreads, smem));
    if (grid > 0 && N / grid >= 2 * B * S) {
      hist_wave_float_private<<<grid, kPrivThreads, smem, st>>>(
          bins, vecs, slot_leaf, F, N, B, S, stride, mode, acc);
      return static_cast<int>(cudaGetLastError());
    }
  }
  static int resident = 0;
  if (resident == 0) {
    resident = resident_blocks(hist_wave_float_rows, kFloatThreads, 0);
  }
  const int grid = min((N + kFloatThreads - 1) / kFloatThreads,
                       max(resident, 1));
  hist_wave_float_rows<<<grid, kFloatThreads, 0, st>>>(
      bins, vecs, slot_leaf, F, N, B, S, stride, mode, acc);
  return static_cast<int>(cudaGetLastError());
}

template <typename Acc>
int launch_epilogue(const Acc* ws, int F, int B, int S, int stride,
                    int width, int chunks, const float* par0,
                    const float* par1, float* out0, float* out1, float* sib0,
                    float* sib1, cudaStream_t st) {
  const int total = F * B * kLanes;
  if (total > 0) {
    hist_wave_epilogue<Acc><<<(total + 255) / 256, 256, 0, st>>>(
        ws, F, B, S, stride, width, chunks, par0, par1, out0, out1, sib0,
        sib1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lgbm_hist_wave_smem_bytes(int B, int S) {
  return B * S * 3 * 4 + kMaxSlots * static_cast<int>(sizeof(int)) + kTable;
}

// Launches the row pass and the epilogue on ``stream``.  Float modes:
// ``vecs`` is [N, 4] f32, ``ws`` the f32 accumulator [F, B, S, 4], zeroed,
// and ``chunks`` unused.  Int modes: ``vecs`` is [N, 4] int16, ``ws`` the
// int32 workspace [chunks, F, B, S, 3] of ``chunks`` row chunks per
// feature.  ``*1`` pointers are null in the triple layout,
// ``par*``/``sib*`` for the unfused call.  Returns cudaGetLastError()
// after the launches (0 = ok).
extern "C" int lgbm_hist_wave(const uint8_t* bins, const void* vecs,
                              const int* slot_leaf, int F, int N, int B,
                              int S, int stride, int mode, int chunks,
                              void* ws, const float* par0, const float* par1,
                              float* out0, float* out1, float* sib0,
                              float* sib1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rows = F > 0 && N > 0 && S > 0;
  if (mode == kInt16 || mode == kInt8) {
    int* acc = static_cast<int*>(ws);
    const int smem = lgbm_hist_wave_smem_bytes(B, S);
    cudaError_t err = cudaFuncSetAttribute(
        hist_wave_int_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rows) {
      hist_wave_int_rows<<<dim3(F, chunks), kIntThreads, smem, st>>>(
          bins, static_cast<const short4*>(vecs), slot_leaf, F, N, B, S,
          stride, (N + chunks - 1) / chunks, acc);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return launch_epilogue<int>(acc, F, B, S, stride, 3, rows ? chunks : 0,
                                par0, par1, out0, out1, sib0, sib1, st);
  }
  float* acc = static_cast<float*>(ws);
  if (rows) {
    const int err = launch_float_rows(bins, static_cast<const float4*>(vecs),
                                      slot_leaf, F, N, B, S, stride, mode,
                                      acc, st);
    if (err != 0) return err;
  }
  return launch_epilogue<float>(acc, F, B, S, stride, 4, rows ? 1 : 0, par0,
                                par1, out0, out1, sib0, sib1, st);
}
