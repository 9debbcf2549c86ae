// Wave histogram kernel K1 for Hopper (sm_90a): one wave's per-leaf
// (g, h, count) histograms, in the packed lane-pair layout or the triple
// layout, optionally with the fused sibling = parent - child.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py _hist_wave_kernel /
// hist_pallas_wave.  The Pallas kernel turns accumulation into one-hot
// MXU matmuls because a TPU has no fast scatter; Hopper scatters instead,
// in one pass over the rows for every mode: f32 sums in the float modes,
// exact integer sums in the int ones.
//
// Float modes (highest, bf16, 2xbf16): one pass over the rows, then an
// epilogue.  The g and h sums are fixed point, so they do not depend on
// the order of the adds: each launch takes a power-of-two scale 2^k per
// channel from max |g| and max |h| of the row stream (``amax``, one small
// reduction on the device that the wrapper runs; no host read), with k
// chosen so that N values of up to twice that maximum sum below 2^62.
// Each rounded value is converted once, v * 2^k rounded to the nearest
// int64 (exact for every value at or above 2^-k), and the sums are int64
// adds.  The count channel stays f32: its addends are 0/1 (the wave
// grower's count weights), whose f32 sums are exact, and so order-free,
// below 2^24 rows a cell.  The accumulator, zeroed by the wrapper, is
// [F][B][S][2] int64 (g, h) beside [F][B][S] f32 (count): 28 x 256 x 63 x
// 20 B = 9 MB at the main shape, resident in the 50 MB L2.  Every row is
// loaded, mapped leaf -> slot (a table in shared memory), rounded and
// converted once, and features are an inner loop (a warp of consecutive
// rows reads 32 contiguous bytes of bins[f]; kRun loads are issued before
// their adds).  For each feature the lanes of a warp that hit the same
// cell are grouped with __match_any_sync and summed with shuffles
// (group_sum), so one lane a group adds: on a feature with few bins, or a
// wave with one slot, a whole warp would otherwise add into one cell.
// The pass has two forms:
//
//   hist_wave_float_rows: a grid-stride loop, one thread a row; each
//     group's sum is two 64-bit L2 reductions and one f32 one
//     (RED.E.ADD.64 x 2, RED.E.ADD.F32; the thread does not wait on
//     them), so three reductions per (row in a slot, feature) bound this
//     form (lightgbm_tpu_torch/tools/l2_reduction_rate.cu measures the
//     L2's rates).
//   hist_wave_float_private: for a wave whose whole [F][B][S] histogram
//     (16 + 4 bytes a cell and a one-byte tag) fits in a block's shared
//     memory (kFloatPrivCap: the root wave, S = 1 at F = 28, B = 256).  Each
//     block stages 1,024 rows (converted g, h, count and slot) in shared
//     memory, then warp w takes features w, w + 32, ...: one warp alone
//     writes a feature's cells, so it adds with plain loads and stores,
//     no atomics (add_private).  Its lanes settle who adds into a cell
//     with one round of tags in shared memory (each lane writes its id to
//     the cell's tag, the lane whose id stays adds) and group_sum for the
//     lanes left; a warp whose last grouping merged many lanes (a feature
//     with few bins) groups at once.  Which lane wins a tag depends on
//     timing, but every add is an integer add (or an exact 0/1 count), so
//     the sums do not.  At the end the block reduces its nonzero cells
//     into the accumulator.  The root wave holds every row and
//     concentrates them on few cells, where the L2 form is slowest.
//
//   epilogue (hist_wave_epilogue): reads the accumulator once, converts
//     each fixed-point sum back through f64 (sum * 2^-k, rounded to f32
//     once), writes the output layout and, when fused, sibling = parent -
//     child.  One launch's sums are bit-equal from launch to launch.
//
// No float form adds into shared memory with atomics: f32 shared adds are
// compare-and-swap loops on Hopper (ATOMS.CAST.SPIN), and a [B][S][3]
// histogram per feature block leaves one block per SM at 63 slots.
//
// Integer modes (int16, int8): the same row pass with integer sums.  The
// kernel reads g, h and the count weights as f32 and leaf ids as int32, and
// casts each value to int16 as the reference's f32 -> int16 cast does.
// Every sum is an integer sum, exact and independent of the order of the
// adds, for any number of rows: the output holds the integer totals
// converted to f32 once.  (The Pallas kernel accumulates the same integers
// in f32: exact while every cell stays below 2^24; above that the two
// differ only by the f32 rounding of the same integer total.)
//
//   hist_wave_int_rows: one thread a row, features an inner loop, as
//     hist_wave_float_rows, and a warp's lanes on one cell summed first in
//     the same way (a 32-lane group sums to at most 2^20 in magnitude).
//     The accumulator
//     [F][B][S][4] int64 packs a cell's three sums into one 64-bit word
//     (21/21/22-bit fields, see add_packed) plus three correction words, so
//     a group adds all three with one 64-bit atomic (ATOMG.E.ADD.64) where
//     three 64-bit reductions would take 2.2x as long
//     (lightgbm_tpu_torch/tools/l2_reduction_rate.cu).  The thread reads
//     the word's old value back and adds the rare carries of a field that
//     wraps into the correction words; it issues a run of features'
//     atomics before it reads any old value, or it would wait on the L2
//     once per feature.
//   hist_wave_int_private: int32 histograms in shared memory for a tile of
//     features (every feature when the whole [F][B][S][3] histogram fits,
//     S <= 2 at F = 28, B = 256; at least two up to S = 33 there), added
//     with int32 shared atomics (ATOMS.ADD, single instructions), at most
//     65,535 rows a block so that no int32 cell can wrap; each block then
//     adds its nonzero cells into the packed accumulator.  A wave takes it
//     when a block's rows outnumber a feature's cells: the training waves
//     past the root hold ~100-400k rows, where one L2 atomic per (row,
//     feature) is the L2 form's limit.
//   epilogue: as for the float modes; each sum is field + correction, in
//     int64, converted to f32 once.
//
// Layouts (``stride`` = lanes per slot): packed (2) puts slot s's g, h in
// lanes 2s, 2s+1 of one [F, B, 128] output and its count in lane s of a
// second; triple (3) puts g, h, count in lanes 3s, 3s+1, 3s+2 of one.
//
// Rounding.  Float modes round g/h as the MXU passes do (2xbf16: hi =
// bf16(x), lo = bf16(x - hi), value hi + lo, exact in f32; bf16: hi;
// highest: x).  The packed count goes through bf16 in every mode, as the
// Pallas count pass does; the triple count lane takes the mode's rounding
// like g and h.  Dequantization of the int modes stays out of the kernel (the
// wave grower scales at split-scan time), and the build passes -fmad=false
// so no multiply-add is ever contracted.
//
// What bounds it.  The byte bound per launch is the [F, N] u8 bins read
// once (F*N bytes), the row vectors (16*N bytes) and the [F, B, 128] f32
// histograms (one or two outputs, plus parent in / sibling out when
// fused).  Both row passes read each of those once; the L2's rate for one
// reduction or atomic per (group, feature) bounds the L2 forms, the
// settling of cells inside a warp (float) or the shared atomics (int) the
// shared-memory forms.
//
// Preconditions (the wave grower meets them): the ``stride`` lanes of each
// slot s < S map to one leaf, lanes from stride*S on are unused (-1), no
// leaf appears in two slots, S <= 63 packed / 42 triple and B <= 256; in
// the float modes the count weights are 0 or 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;      // channel lanes of an output
constexpr int kMaxSlots = 64;
constexpr int kTable = 4096;     // leaf ids with a direct slot lookup
constexpr int kIntThreads = 256;
constexpr int kIntBlockRows = 65535;   // rows of a shared-form int block
constexpr int kFloatThreads = 256;
constexpr int kPrivThreads = 1024;
constexpr int kPrivCap = 200 * 1024;   // int shared-form tile, bytes
constexpr int kFloatPrivCap = 192 * 1024;  // float private form + tags; its
                                           // staging takes 24 KB more
constexpr int kFixedBits = 61;   // N values of up to 2 * amax sum below 2^62
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

// The scale exponent k of a float launch's fixed-point channel: with m <
// 2^e (frexpf) the rounded values stay below 2^(e+1), so the sum of n of
// them, times 2^k, stays below 2^62.
__device__ __forceinline__ int fixed_shift(float m, int n) {
  int e = 0;
  frexpf(m, &e);
  const int lg = n <= 1 ? 0 : 32 - __clz(n - 1);   // ceil(log2 n)
  return kFixedBits - lg - e;
}

// A rounded value as a fixed-point integer: v * 2^k to the nearest int64
// (the multiply by a power of two is exact).
__device__ __forceinline__ long long to_fixed(float v, int k) {
  return __float2ll_rn(ldexpf(v, k));
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
template <typename T, typename U>
__device__ __forceinline__ void sum_peers(unsigned peers, int lane, T& g,
                                          T& h, U& c) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & ~((2u << lane) - 1u);   // peers above this lane
  while (__any_sync(kFullWarp, rest != 0)) {
    const int next = __ffs(rest) - 1;              // -1: none left
    const T tg = __shfl_sync(kFullWarp, g, next & 31);
    const T th = __shfl_sync(kFullWarp, h, next & 31);
    const U tc = __shfl_sync(kFullWarp, c, next & 31);
    if (next >= 0) {
      g += tg;
      h += th;
      c += tc;
    }
    rest &= ~__ballot_sync(kFullWarp, rank & 1u);
    rank >>= 1;
  }
}

// Reduces a group's fixed-point (g, h) and f32 count into cell ``cell``
// of the accumulator: two 64-bit reductions and one f32 one.
__device__ __forceinline__ void reduce_cell(unsigned long long* acc_gh,
                                            float* acc_c, size_t cell,
                                            long long g, long long h,
                                            float c) {
  atomicAdd(acc_gh + 2 * cell, static_cast<unsigned long long>(g));
  atomicAdd(acc_gh + 2 * cell + 1, static_cast<unsigned long long>(h));
  atomicAdd(acc_c + cell, c);
}

// Groups the lanes of the warp by ``key`` (the cell; -1: none) and sums
// each group's (g, h, c) into its lowest lane, which gets true back.
// Every lane of the warp calls it.
template <typename T, typename U>
__device__ __forceinline__ bool group_sum(int key, int lane, T& g, T& h,
                                          U& c) {
  unsigned peers = __match_any_sync(kFullWarp, key);
  if (key < 0) peers = 1u << lane;
  sum_peers(peers, lane, g, h, c);
  return key >= 0 && lane == __ffs(peers) - 1;
}

// Adds each lane's (g, h, c) into cell ``key`` (-1: none) of ``hist``
// ([cells][2] int64) and ``cnt`` ([cells] f32), in shared memory that
// this warp alone writes, with plain loads and stores.  Not ``crowded``: first one round of tags, in
// which each lane writes its id to tags[key] and the lane whose id stays
// adds; the lanes left (cells that two or more lanes hit) then group with
// group_sum.  ``crowded``: every lane groups at once, since a round of
// tags would settle few.  Sets ``crowded`` when grouping merged more than
// kCrowded lanes, as it does on a feature with few bins.  Every lane of
// the warp calls it; the caller orders consecutive calls with __syncwarp.
__device__ __forceinline__ void add_private(long long* hist, float* cnt,
                                            uint8_t* tags, int key, int lane,
                                            long long g, long long h, float c,
                                            bool& crowded) {
  bool todo = key >= 0;
  long long* cell = hist + 2 * key;
  unsigned left = __ballot_sync(kFullWarp, todo);
  if (!crowded && left != 0) {
    if (todo) tags[key] = static_cast<uint8_t>(lane);
    __syncwarp();
    if (todo && tags[key] == lane) {
      cell[0] += g;
      cell[1] += h;
      cnt[key] += c;
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
      cnt[key] += c;
    }
    crowded = __popc(left) - __popc(__ballot_sync(kFullWarp, lead)) >
              kCrowded;
  }
}

// The row pass into the accumulator: each group's sum is two 64-bit L2
// reductions and one f32 one.
__global__ void __launch_bounds__(kFloatThreads)
hist_wave_float_rows(const uint8_t* __restrict__ bins,
                     const float4* __restrict__ vecs,
                     const float* __restrict__ amax,
                     const int* __restrict__ slot_leaf, int F, int N, int B,
                     int S, int stride, int mode,
                     unsigned long long* __restrict__ acc_gh,
                     float* __restrict__ acc_c) {
  __shared__ int slot_of[kMaxSlots];
  __shared__ signed char table[kTable];
  load_slots(slot_leaf, S, stride, slot_of, table);
  const int kg = fixed_shift(amax[0], N);
  const int kh = fixed_shift(amax[1], N);

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
    const long long g = to_fixed(round_mode(v.x, mode), kg);
    const long long h = to_fixed(round_mode(v.y, mode), kh);
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
        long long gs = g, hs = h;
        float cs = c;
        if (group_sum(key, lane, gs, hs, cs)) {
          reduce_cell(acc_gh, acc_c, f * feature_cells + key, gs, hs, cs);
        }
      }
    }
  }
}

// The row pass of a wave whose whole histogram fits in shared memory:
// each block keeps a private copy ([F][B][S][2] int64 and [F][B][S] f32),
// adds into it without atomics, and reduces its nonzero cells into the
// accumulator once at the end.  Per step the block stages kPrivThreads
// rows (fixed-point g, h, the count and the slot) in shared memory; then warp w takes features w, w + 32, ..., so
// one warp alone writes a feature's cells, and add_private settles which
// lane adds into which cell.  Each (step, feature) starts not crowded.
__global__ void __launch_bounds__(kPrivThreads)
hist_wave_float_private(const uint8_t* __restrict__ bins,
                        const float4* __restrict__ vecs,
                        const float* __restrict__ amax,
                        const int* __restrict__ slot_leaf, int F, int N,
                        int B, int S, int stride, int mode,
                        unsigned long long* __restrict__ acc_gh,
                        float* __restrict__ acc_c) {
  __shared__ int slot_of[kMaxSlots];
  __shared__ signed char table[kTable];
  __shared__ longlong2 stage_gh[kPrivThreads];  // fixed-point (g, h)
  __shared__ float2 stage_cs[kPrivThreads];     // (count, slot or -1)
  extern __shared__ long long priv[];        // [F][B][S][2], counts, tags
  const int feature_cells = B * S;
  const int cells = F * feature_cells;
  float* pcnt = reinterpret_cast<float*>(priv + 2 * cells);      // [F][B][S]
  uint8_t* tags = reinterpret_cast<uint8_t*>(pcnt + cells);      // [F][B][S]
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) priv[i] = 0;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) pcnt[i] = 0.0f;
  load_slots(slot_leaf, S, stride, slot_of, table);
  const int kg = fixed_shift(amax[0], N);
  const int kh = fixed_shift(amax[1], N);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int base = blockIdx.x * kPrivThreads; base < N;
       base += gridDim.x * kPrivThreads) {
    const int r = base + threadIdx.x;
    longlong2 gh = make_longlong2(0, 0);
    float2 cs = make_float2(0.0f, -1.0f);
    if (r < N) {
      const float4 v = __ldcs(vecs + r);
      const int s = find_slot(static_cast<int>(v.w), S, slot_of, table);
      if (s >= 0) {
        gh = make_longlong2(to_fixed(round_mode(v.x, mode), kg),
                            to_fixed(round_mode(v.y, mode), kh));
        cs = make_float2(stride == 2 ? bf16_round(v.z)
                                     : round_mode(v.z, mode),
                         static_cast<float>(s));
      }
    }
    stage_gh[threadIdx.x] = gh;
    stage_cs[threadIdx.x] = cs;
    __syncthreads();
    for (int f = warp; f < F; f += warps) {
      const uint8_t* col = bins + static_cast<size_t>(f) * N + base;
      long long* hist = priv + 2 * f * feature_cells;
      float* cnt = pcnt + f * feature_cells;
      uint8_t* ftags = tags + f * feature_cells;
      bool crowded = false;
      for (int j0 = 0; j0 < kPrivThreads; j0 += 32 * kRun) {
        int b[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int j = j0 + 32 * u + lane;
          b[u] = stage_cs[j].y >= 0.0f ? __ldcs(col + j) : B;
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int j = j0 + 32 * u + lane;
          const longlong2 x = stage_gh[j];
          const float2 y = stage_cs[j];
          const int key = b[u] < B ? b[u] * S + static_cast<int>(y.y) : -1;
          add_private(hist, cnt, ftags, key, lane, x.x, x.y, y.x, crowded);
          __syncwarp();    // orders this step's writes before the next's
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const long long g = priv[2 * i], h = priv[2 * i + 1];
    const float c = pcnt[i];
    if (g != 0 || h != 0 || c != 0.0f) {
      reduce_cell(acc_gh, acc_c, i, g, h, c);
    }
  }
}

// ---- integer modes: the packed int64 accumulator -----------------------
//
// Cell i of ``acc`` is four 64-bit words [W, E0, E1, E2].  W holds three
// signed fields, g in bits [0, 21), h in [21, 42) and count in [42, 64);
// the sum k of the cell is field k of W plus E_k.  One 64-bit atomic on W
// adds all three values of a group; the thread reads W's old value back,
// and when a field wraps (leaves its range, carrying into the field above
// or out of the word) it adds the carry's exact correction into E.  Every
// add is an integer add, so the result is exact and does not depend on
// the order of the adds, for any number of rows.

constexpr int kField0 = 21;      // bits of g
constexpr int kField1 = 21;      // bits of h; count takes the other 22

__device__ __forceinline__ long long sext(unsigned long long x, int bits) {
  return static_cast<long long>(x << (64 - bits)) >> (64 - bits);
}

// The three signed fields of W.
__device__ __forceinline__ void unpack(unsigned long long w, long long& d0,
                                       long long& d1, long long& d2) {
  d0 = sext(w, kField0);
  w = (w - static_cast<unsigned long long>(d0)) >> kField0;
  d1 = sext(w, kField1);
  w = (w - static_cast<unsigned long long>(d1)) >> kField1;
  d2 = sext(w, 64 - kField0 - kField1);
}

// The packed word of (v0, v1, v2): one 64-bit add adds each value to its
// field (a field's carry runs into the field above).
__device__ __forceinline__ unsigned long long pack(int v0, int v1, int v2) {
  return static_cast<unsigned long long>(static_cast<long long>(v0)) +
         (static_cast<unsigned long long>(static_cast<long long>(v1))
          << kField0) +
         (static_cast<unsigned long long>(static_cast<long long>(v2))
          << (kField0 + kField1));
}

// After W of ``cell`` went from ``old`` to old + pack(v0, v1, v2) (any int32
// values): adds the carries of the fields that wrapped into E.  The carry
// out of field k is (u + half) >> bits for u = the field's old value + its
// value + the carry into it; it leaves field k c * 2^bits short and adds c
// to field k+1 (or drops it off the word), which E puts right.
__device__ __forceinline__ void add_carries(unsigned long long* cell,
                                            unsigned long long old, int v0,
                                            int v1, int v2) {
  constexpr long long kOne1 = 1LL << kField0;
  constexpr long long kOne2 = 1LL << kField1;
  constexpr long long kOne3 = 1LL << (64 - kField0 - kField1);
  long long d0, d1, d2;
  unpack(old, d0, d1, d2);
  const long long c1 = (d0 + v0 + kOne1 / 2) >> kField0;
  const long long c2 = (d1 + v1 + c1 + kOne2 / 2) >> kField1;
  const long long c3 = (d2 + v2 + c2 + kOne3 / 2) >> (64 - kField0 - kField1);
  if ((c1 | c2 | c3) == 0) return;
  const long long e[3] = {c1 * kOne1, c2 * kOne2 - c1, c3 * kOne3 - c2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (e[k] != 0) {
      atomicAdd(cell + 1 + k, static_cast<unsigned long long>(e[k]));
    }
  }
}

// Adds (v0, v1, v2) into packed cell ``cell``: one 64-bit atomic on W,
// whose old value the thread reads back for the carries.
__device__ __forceinline__ void add_packed(unsigned long long* cell, int v0,
                                           int v1, int v2) {
  add_carries(cell, atomicAdd(cell, pack(v0, v1, v2)), v0, v1, v2);
}

// A row's int16 values as the reference's f32 -> int16 cast gives them:
// NaN to 0, saturated to [-32768, 32767], truncated toward zero.
__device__ __forceinline__ int to_int16(float x) {
  if (x != x) return 0;
  return static_cast<int>(fminf(fmaxf(x, -32768.0f), 32767.0f));
}

// Row r's (g, h, count) and slot (-1: none, or all three values are 0).
__device__ __forceinline__ int int_row(const float* gv, const float* hv,
                                       const float* cv, const int* leaf,
                                       int r, int S, const int* slot_of,
                                       const signed char* table, int& g,
                                       int& h, int& c) {
  g = to_int16(__ldcs(gv + r));
  h = to_int16(__ldcs(hv + r));
  c = to_int16(__ldcs(cv + r));
  if ((g | h | c) == 0) return -1;
  const int id = min(max(__ldcs(leaf + r), -32768), 32767);
  return find_slot(id, S, slot_of, table);
}

// The int row pass into the packed accumulator: one thread a row, the
// row's values and slot found once, features an inner loop; the lanes of a
// warp on one cell are summed into the group's lowest lane as in the float
// pass (group_sum), which adds the sums with one 64-bit atomic.  The kRun
// features' atomics are all issued before any old value is read, so a
// thread waits once per kRun features for the L2's answers.
__global__ void __launch_bounds__(kIntThreads)
hist_wave_int_rows(const uint8_t* __restrict__ bins,
                   const float* __restrict__ gv, const float* __restrict__ hv,
                   const float* __restrict__ cv, const int* __restrict__ leaf,
                   const int* __restrict__ slot_leaf, int F, int N, int B,
                   int S, int stride, unsigned long long* __restrict__ acc) {
  __shared__ int slot_of[kMaxSlots];
  __shared__ signed char table[kTable];
  load_slots(slot_leaf, S, stride, slot_of, table);

  const int lane = threadIdx.x & 31;
  const size_t rows = static_cast<size_t>(N);
  const size_t feature_cells = static_cast<size_t>(B) * S;
  // a warp's lanes run the same iterations (the warp steps need all 32)
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < N;
       base += gridDim.x * blockDim.x) {
    const int r = base + lane;
    int g = 0, h = 0, c = 0, s = -1;
    if (r < N) s = int_row(gv, hv, cv, leaf, r, S, slot_of, table, g, h, c);
    const bool live = s >= 0;
    if (__ballot_sync(kFullWarp, live) == 0) continue;
    const uint8_t* col = bins + r;
    for (int f0 = 0; f0 < F; f0 += kRun) {
      int b[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        const int f = f0 + u;
        b[u] = live && f < F ? __ldcs(col + f * rows) : B;
      }
      int gs[kRun], hs[kRun], cs[kRun];
      unsigned long long* cell[kRun];
      unsigned long long old[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        const int f = f0 + u;
        cell[u] = nullptr;
        // the Pallas one-hot has no lane for a bin >= B either
        const int key = b[u] < B ? b[u] * S + s : -1;   // the cell in f
        gs[u] = g;
        hs[u] = h;
        cs[u] = c;
        if (f < F && group_sum(key, lane, gs[u], hs[u], cs[u])) {
          cell[u] = acc + 4 * (f * feature_cells + key);
          old[u] = atomicAdd(cell[u], pack(gs[u], hs[u], cs[u]));
        }
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (cell[u] != nullptr) {
          add_carries(cell[u], old[u], gs[u], hs[u], cs[u]);
        }
      }
    }
  }
}

// The int row pass with the histogram in shared memory: block (chunk,
// tile) takes the features of one tile ([f0, f0 + ``tile``), every feature
// when the whole [F][B][S][3] int32 histogram fits) and one chunk of rows
// (at most kIntBlockRows, so that no cell can wrap: 65,535 x 32,768 <
// 2^31).  It adds with int32 shared atomics (ATOMS.ADD, native on this
// card), then adds its nonzero cells into the packed accumulator.  The
// blocks of one chunk are launched side by side, so they read its row
// vectors from L2 after the first.
__global__ void __launch_bounds__(kPrivThreads)
hist_wave_int_private(const uint8_t* __restrict__ bins,
                      const float* __restrict__ gv,
                      const float* __restrict__ hv,
                      const float* __restrict__ cv,
                      const int* __restrict__ leaf,
                      const int* __restrict__ slot_leaf, int F, int N, int B,
                      int S, int stride, int tile, int rows_per_block,
                      unsigned long long* __restrict__ acc) {
  __shared__ int slot_of[kMaxSlots];
  __shared__ signed char table[kTable];
  extern __shared__ int ipriv[];             // [tile][B][S][3]
  const int tiles = (F + tile - 1) / tile;
  const int f0 = blockIdx.x % tiles * tile;
  const int nf = min(tile, F - f0);
  const int feature_cells = B * S;
  const int cells = nf * feature_cells;
  for (int i = threadIdx.x; i < 3 * cells; i += blockDim.x) ipriv[i] = 0;
  load_slots(slot_leaf, S, stride, slot_of, table);

  const size_t rows = static_cast<size_t>(N);
  const int r0 = blockIdx.x / tiles * rows_per_block;
  const int r1 = min(N, r0 + rows_per_block);
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int g, h, c;
    const int s = int_row(gv, hv, cv, leaf, r, S, slot_of, table, g, h, c);
    if (s < 0) continue;
    const uint8_t* col = bins + f0 * rows + r;
    for (int u0 = 0; u0 < nf; u0 += kRun) {
      int b[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        b[u] = u0 + u < nf ? __ldcs(col + (u0 + u) * rows) : B;
      }
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (b[u] < B) {
          int* cell = ipriv + 3 * ((u0 + u) * feature_cells + b[u] * S + s);
          atomicAdd(cell, g);
          atomicAdd(cell + 1, h);
          atomicAdd(cell + 2, c);
        }
      }
    }
  }
  __syncthreads();
  unsigned long long* out = acc + 4 * static_cast<size_t>(f0) * feature_cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int* p = ipriv + 3 * i;
    if ((p[0] | p[1] | p[2]) != 0) add_packed(out + 4 * i, p[0], p[1], p[2]);
  }
}

// The float modes' accumulator: sum k of a cell is its fixed-point g or h
// sum times 2^-k (through f64, rounded to f32 once), or its f32 count.
struct FixedAcc {
  const unsigned long long* gh;
  const float* c;
  const float* amax;
  int n;
  __device__ float operator()(size_t cell, int k) const {
    if (k == 2) return c[cell];
    const long long v = static_cast<long long>(gh[2 * cell + k]);
    return __double2float_rn(
        ldexp(static_cast<double>(v), -fixed_shift(amax[k], n)));
  }
};

// The int modes' packed accumulator: sum k of a cell is field k of W plus
// E_k, converted to f32 once.
struct PackedAcc {
  const unsigned long long* acc;
  __device__ float operator()(size_t cell, int k) const {
    long long d[3];
    unpack(acc[4 * cell], d[0], d[1], d[2]);
    return __ll2float_rn(d[k] +
                         static_cast<long long>(acc[4 * cell + 1 + k]));
  }
};

// Reads the accumulator once and writes the output layout and, when
// fused, sibling = parent - child.
template <typename Acc>
__global__ void hist_wave_epilogue(Acc cell_sum, int F, int B, int S,
                                   int stride, const float* par0,
                                   const float* par1, float* out0,
                                   float* out1, float* sib0, float* sib1) {
  const int total = F * B * kLanes;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = idx % kLanes;
  const size_t cell = static_cast<size_t>(idx / kLanes) * S;  // (f, b, 0)
  if (stride == 2) {
    const int s = c >> 1;
    const float gh = s < S ? cell_sum(cell + s, c & 1) : 0.0f;
    const float ct = c < S ? cell_sum(cell + c, 2) : 0.0f;
    out0[idx] = gh;
    out1[idx] = ct;
    if (sib0 != nullptr) {
      sib0[idx] = par0[idx] - gh;
      sib1[idx] = par1[idx] - ct;
    }
  } else {
    const int s = c / 3;
    const float v = s < S ? cell_sum(cell + s, c % 3) : 0.0f;
    out0[idx] = v;
    if (sib0 != nullptr) sib0[idx] = par0[idx] - v;
  }
}

// Blocks of a row-pass kernel the card holds at once with ``smem`` bytes
// of dynamic shared memory.
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
// kFloatPrivCap takes the privatized pass when each block gets at least
// twice as many rows as a feature has cells (its final flush then costs
// less than its rows); every other wave reduces straight into the
// accumulator.  The grid is the blocks
// the card holds at once (more would run as a second, partial wave), or
// fewer for few rows.
int launch_float_rows(const uint8_t* bins, const float4* vecs,
                      const float* amax, const int* slot_leaf, int F, int N,
                      int B, int S, int stride, int mode,
                      unsigned long long* acc_gh, float* acc_c,
                      cudaStream_t st) {
  // int64 (g, h), f32 count and a one-byte tag per cell
  const long long priv =
      (2LL * sizeof(long long) + sizeof(float) + 1) * F * B * S;
  if (priv <= kFloatPrivCap) {
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
          bins, vecs, amax, slot_leaf, F, N, B, S, stride, mode, acc_gh,
          acc_c);
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
      bins, vecs, amax, slot_leaf, F, N, B, S, stride, mode, acc_gh, acc_c);
  return static_cast<int>(cudaGetLastError());
}

// The int row pass.  The shared-memory form takes a tile of features
// whose int32 histograms fit kPrivCap together: every feature for a small
// wave, at least two (or the only one), so that no block reads the row
// vectors for a single feature of several.  Its blocks are tiles x chunks,
// the chunks as many as fill the card (more if a chunk would pass
// kIntBlockRows rows).  It is taken when each block gets at least as many
// rows as a feature has cells: its flush (an atomic per nonzero cell of a
// block) then costs no more than the L2 form's atomic per (row, feature).
// Every other wave takes the L2 form.
int launch_int_rows(const uint8_t* bins, const float* gv, const float* hv,
                    const float* cv, const int* leaf, const int* slot_leaf,
                    int F, int N, int B, int S, int stride,
                    unsigned long long* acc, cudaStream_t st) {
  const long long feature_bytes = 3LL * sizeof(int) * B * S;
  const int tile = static_cast<int>(min(static_cast<long long>(F),
                                        kPrivCap / feature_bytes));
  if (tile >= min(F, 2)) {
    const int smem = static_cast<int>(tile * feature_bytes);
    const cudaError_t err = cudaFuncSetAttribute(
        hist_wave_int_private, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n = N;
    const long long tiles = (F + tile - 1) / tile;
    const long long resident =
        resident_blocks(hist_wave_int_private, kPrivThreads, smem);
    const long long chunks = max(
        min((n + kPrivThreads - 1) / kPrivThreads,
            max((resident + tiles - 1) / tiles, 1LL)),
        (n + kIntBlockRows - 1) / kIntBlockRows);
    const long long rows_per_block = (n + chunks - 1) / chunks;
    if (rows_per_block >= static_cast<long long>(B) * S) {
      hist_wave_int_private<<<static_cast<unsigned>(tiles * chunks),
                              kPrivThreads, smem, st>>>(
          bins, gv, hv, cv, leaf, slot_leaf, F, N, B, S, stride, tile,
          static_cast<int>(rows_per_block), acc);
      return static_cast<int>(cudaGetLastError());
    }
  }
  static int resident = 0;
  if (resident == 0) {
    resident = resident_blocks(hist_wave_int_rows, kIntThreads, 0);
  }
  const int grid = min((N + kIntThreads - 1) / kIntThreads, max(resident, 1));
  hist_wave_int_rows<<<grid, kIntThreads, 0, st>>>(
      bins, gv, hv, cv, leaf, slot_leaf, F, N, B, S, stride, acc);
  return static_cast<int>(cudaGetLastError());
}

template <typename Acc>
int launch_epilogue(Acc acc, int F, int B, int S, int stride,
                    const float* par0, const float* par1, float* out0,
                    float* out1, float* sib0, float* sib1, cudaStream_t st) {
  const int total = F * B * kLanes;
  if (total > 0) {
    hist_wave_epilogue<Acc><<<(total + 255) / 256, 256, 0, st>>>(
        acc, F, B, S, stride, par0, par1, out0, out1, sib0, sib1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Float modes: launches the row pass and the epilogue on ``stream``.
// ``vecs`` is [N, 4] f32 (g, h, count, leaf id), ``amax`` [2] f32 the
// largest |g| and |h| of ``vecs`` (it sets the fixed-point scales),
// ``acc_gh`` the [F, B, S, 2] int64 and ``acc_c`` the [F, B, S] f32
// accumulator, both zeroed.  ``*1`` pointers are null in the triple
// layout, ``par*``/``sib*`` for the unfused call.  Returns
// cudaGetLastError() after the launches (0 = ok).
extern "C" int lgbm_hist_wave(const uint8_t* bins, const float* vecs,
                              const float* amax, const int* slot_leaf, int F,
                              int N, int B, int S, int stride, int mode,
                              void* acc_gh, float* acc_c, const float* par0,
                              const float* par1, float* out0, float* out1,
                              float* sib0, float* sib1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* gh = static_cast<unsigned long long*>(acc_gh);
  if (F > 0 && N > 0 && S > 0) {
    const int err = launch_float_rows(
        bins, reinterpret_cast<const float4*>(vecs), amax, slot_leaf, F, N,
        B, S, stride, mode, gh, acc_c, st);
    if (err != 0) return err;
  }
  return launch_epilogue(FixedAcc{gh, acc_c, amax, N}, F, B, S, stride,
                         par0, par1, out0, out1, sib0, sib1, st);
}

// Int modes (int16, int8): the same for f32 g, h and count weights [N]
// (integer-valued; cast as the reference casts to int16), leaf ids [N]
// int32 and ``acc`` the packed accumulator [F, B, S, 4] int64, zeroed.
extern "C" int lgbm_hist_wave_int(const uint8_t* bins, const float* gv,
                                  const float* hv, const float* cv,
                                  const int* leaf, const int* slot_leaf,
                                  int F, int N, int B, int S, int stride,
                                  void* acc, const float* par0,
                                  const float* par1, float* out0,
                                  float* out1, float* sib0, float* sib1,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* packed = static_cast<unsigned long long*>(acc);
  if (F > 0 && N > 0 && S > 0) {
    const int err = launch_int_rows(bins, gv, hv, cv, leaf, slot_leaf, F, N,
                                    B, S, stride, packed, st);
    if (err != 0) return err;
  }
  return launch_epilogue(PackedAcc{packed}, F, B, S, stride, par0, par1,
                         out0, out1, sib0, sib1, st);
}
