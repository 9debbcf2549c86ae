// Wave histogram kernel K1 for Hopper (sm_90a): one wave's per-leaf
// (g, h, count) histograms, in the packed lane-pair layout or the triple
// layout, optionally with the fused sibling = parent - child.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py _hist_wave_kernel /
// hist_pallas_wave.  The Pallas kernel turns accumulation into one-hot
// MXU matmuls because a TPU has no fast scatter; Hopper has fast shared-
// memory atomics, so this kernel scatters instead:
//
//   pass 1 (hist_wave_rows): block (f, chunk) takes feature f and one
//     chunk of rows.  It maps each row's leaf to its slot through a table
//     in shared memory and adds (g, h, count) into a privatized [B][S][3]
//     histogram with shared atomics, then stores that histogram to its
//     own slice of the workspace [chunks][F][B][S][3].
//   pass 2 (hist_wave_epilogue): sums the chunk slices in chunk order
//     (blocks run in no order, so the Pallas grid's "last row step" has no
//     counterpart: the sum waits for a second launch), writes the output
//     layout and, when fused, sibling = parent - child.
//
// Layouts (``stride`` = lanes per slot): packed (2) puts slot s's g, h in
// lanes 2s, 2s+1 of one [F, B, 128] output and its count in lane s of a
// second; triple (3) puts g, h, count in lanes 3s, 3s+1, 3s+2 of one.
//
// Modes.  Float modes read the [N, 4] f32 row vectors (g, h, count weight,
// leaf) and round g/h as the MXU passes do (2xbf16: hi = bf16(x), lo =
// bf16(x - hi), value hi + lo, exact in f32; bf16: hi; highest: x).  The
// packed count goes through bf16 in every mode, as the Pallas count pass
// does; the triple count lane takes the mode's rounding like g and h.
// They accumulate in f32 with shared atomics, whose order changes from run
// to run.  Quantized modes (int16, int8) read the row vectors as [N, 4]
// int16 (8 bytes a row, half the float stream) and accumulate in int32
// with integer atomics, which are order-free: the result is exact and
// deterministic.  |q| <= 32767, so one cell of one block takes at most
// 65,535 rows before an int32 sum could wrap; the wrapper caps the rows of
// a chunk there.  The epilogue sums the chunk partials in int64 and
// converts to f32 once, so the output holds the integer totals, exact
// below 2^24.  (The Pallas kernel accumulates the same integers in f32:
// exact while every cell stays below 2^24; above that the two differ only
// by the f32 rounding of the same integer total.)  Dequantization stays
// out of the kernel (the wave grower scales at split-scan time), and the
// build passes -fmad=false so no multiply-add is ever contracted.
//
// What bounds it: bytes.  Per launch it must read the [F, N] u8 bins once
// (F*N bytes), the row vectors (16*N bytes, 8*N quantized; the kernel
// rereads them once per feature, mostly from the 50 MB L2), and move the
// [F, B, 128] f32 histograms (one or two outputs, plus parent in / sibling
// out when fused).  In practice the shared atomics (3 per row and
// feature) are the limit.  The design keeps every accumulation on chip,
// writes each block's partial once with plain stores (no global atomics),
// and sizes shared memory by the slots in use (S), so early waves with few
// leaves run many blocks per SM.
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
constexpr int kThreads = 512;

enum Mode { kHighest = 0, kTwoBf16 = 1, kBf16 = 2, kInt16 = 3, kInt8 = 4 };

template <bool kInt> struct Stream;
template <> struct Stream<false> { using Vec = float4; using Acc = float; };
template <> struct Stream<true> { using Vec = short4; using Acc = int; };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_mode(float x, int mode) {
  if (mode == kHighest) return x;
  const float hi = bf16_round(x);
  if (mode == kBf16) return hi;
  return hi + bf16_round(x - hi);
}

template <bool kInt>
__global__ void __launch_bounds__(kThreads)
hist_wave_rows(const uint8_t* __restrict__ bins,
               const typename Stream<kInt>::Vec* __restrict__ vecs,
               const int* __restrict__ slot_leaf, int F, int N, int B,
               int S, int stride, int mode, int rows_per_chunk,
               typename Stream<kInt>::Acc* __restrict__ ws) {
  using Acc = typename Stream<kInt>::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = B * S * 3;
  Acc* hist = reinterpret_cast<Acc*>(smem);                // [B][S][3]
  int* slot_of = reinterpret_cast<int*>(hist + cells);     // [kMaxSlots]
  signed char* table =
      reinterpret_cast<signed char*>(slot_of + kMaxSlots); // [kTable]

  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = Acc(0);
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) table[i] = -1;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    slot_of[i] = slot_leaf[stride * i];
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int leaf = slot_of[i];
    if (leaf >= 0 && leaf < kTable) table[leaf] = static_cast<signed char>(i);
  }
  __syncthreads();

  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(N, r0 + rows_per_chunk);
  const uint8_t* col = bins + static_cast<size_t>(f) * N;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const auto v = vecs[r];
    const int leaf = static_cast<int>(v.w);
    int s = -1;
    if (leaf >= 0 && leaf < kTable) {
      s = table[leaf];
    } else if (leaf >= kTable) {
      for (int j = 0; j < S; ++j) {
        if (slot_of[j] == leaf) { s = j; break; }
      }
    }
    if (s < 0) continue;
    const int b = col[r];
    if (b >= B) continue;   // the Pallas one-hot has no lane for it either
    Acc* cell = hist + (b * S + s) * 3;
    if constexpr (kInt) {
      atomicAdd(cell, static_cast<int>(v.x));
      atomicAdd(cell + 1, static_cast<int>(v.y));
      atomicAdd(cell + 2, static_cast<int>(v.z));
    } else {
      atomicAdd(cell, round_mode(v.x, mode));
      atomicAdd(cell + 1, round_mode(v.y, mode));
      atomicAdd(cell + 2,
                stride == 2 ? bf16_round(v.z) : round_mode(v.z, mode));
    }
  }
  __syncthreads();

  Acc* out = ws + (static_cast<size_t>(chunk) * F + f) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = hist[i];
}

// Sum of one (bin, slot, k) cell over the chunk partials, in chunk order:
// f32 for the float modes, int64 converted to f32 once for the int ones.
template <bool kInt>
__device__ __forceinline__ float chunk_sum(
    const typename Stream<kInt>::Acc* ws, size_t at, size_t chunk_stride,
    int chunks) {
  if constexpr (kInt) {
    long long acc = 0;
    for (int k = 0; k < chunks; ++k) acc += ws[k * chunk_stride + at];
    return __ll2float_rn(acc);
  } else {
    float acc = 0.0f;
    for (int k = 0; k < chunks; ++k) acc += ws[k * chunk_stride + at];
    return acc;
  }
}

template <bool kInt>
__global__ void hist_wave_epilogue(const typename Stream<kInt>::Acc* ws,
                                   int F, int B, int S, int stride,
                                   int chunks, const float* par0,
                                   const float* par1, float* out0,
                                   float* out1, float* sib0, float* sib1) {
  const int total = F * B * kLanes;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = idx % kLanes;
  const int fb = idx / kLanes;                 // f * B + b
  const size_t chunk_stride = static_cast<size_t>(F) * B * S * 3;
  const size_t cell = static_cast<size_t>(fb) * S * 3;
  if (stride == 2) {
    const int s = c >> 1;
    const float gh = s < S ? chunk_sum<kInt>(ws, cell + s * 3 + (c & 1),
                                             chunk_stride, chunks) : 0.0f;
    const float ct = c < S ? chunk_sum<kInt>(ws, cell + c * 3 + 2,
                                             chunk_stride, chunks) : 0.0f;
    out0[idx] = gh;
    out1[idx] = ct;
    if (sib0 != nullptr) {
      sib0[idx] = par0[idx] - gh;
      sib1[idx] = par1[idx] - ct;
    }
  } else {
    const int s = c / 3;
    const float v = s < S ? chunk_sum<kInt>(ws, cell + s * 3 + c % 3,
                                            chunk_stride, chunks) : 0.0f;
    out0[idx] = v;
    if (sib0 != nullptr) sib0[idx] = par0[idx] - v;
  }
}

template <bool kInt>
int launch(const uint8_t* bins, const void* vecs, const int* slot_leaf,
           int F, int N, int B, int S, int stride, int mode, int chunks,
           void* ws_raw, const float* par0, const float* par1, float* out0,
           float* out1, float* sib0, float* sib1, int smem,
           cudaStream_t st) {
  using Vec = typename Stream<kInt>::Vec;
  using Acc = typename Stream<kInt>::Acc;
  Acc* ws = static_cast<Acc*>(ws_raw);
  cudaError_t err = cudaFuncSetAttribute(
      hist_wave_rows<kInt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_chunk = (N + chunks - 1) / chunks;
  const bool rows = F > 0 && N > 0;
  if (rows) {
    hist_wave_rows<kInt><<<dim3(F, chunks), kThreads, smem, st>>>(
        bins, static_cast<const Vec*>(vecs), slot_leaf, F, N, B, S, stride,
        mode, rows_per_chunk, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int total = F * B * kLanes;
  if (total > 0) {
    hist_wave_epilogue<kInt><<<(total + 255) / 256, 256, 0, st>>>(
        ws, F, B, S, stride, rows ? chunks : 0, par0, par1, out0, out1,
        sib0, sib1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lgbm_hist_wave_smem_bytes(int B, int S) {
  return B * S * 3 * 4 + kMaxSlots * static_cast<int>(sizeof(int)) + kTable;
}

// Launches both passes on ``stream``.  ``vecs`` is [N, 4] f32 in the float
// modes and [N, 4] int16 in the int modes; ``ws`` is f32 or int32
// [chunks, F, B, S, 3] to match.  ``*1`` pointers are null in the triple
// layout, ``par*``/``sib*`` for the unfused call.  Returns
// cudaGetLastError() after the launches (0 = ok).
extern "C" int lgbm_hist_wave(const uint8_t* bins, const void* vecs,
                              const int* slot_leaf, int F, int N, int B,
                              int S, int stride, int mode, int chunks,
                              void* ws, const float* par0, const float* par1,
                              float* out0, float* out1, float* sib0,
                              float* sib1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = lgbm_hist_wave_smem_bytes(B, S);
  if (mode == kInt16 || mode == kInt8) {
    return launch<true>(bins, vecs, slot_leaf, F, N, B, S, stride, mode,
                        chunks, ws, par0, par1, out0, out1, sib0, sib1, smem,
                        st);
  }
  return launch<false>(bins, vecs, slot_leaf, F, N, B, S, stride, mode,
                       chunks, ws, par0, par1, out0, out1, sib0, sib1, smem,
                       st);
}
