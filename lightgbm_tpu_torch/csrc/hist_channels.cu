// Dense multi-channel histogram kernel K2 for Hopper (sm_90a):
//
//   out[f, b, c] = sum_r gh[r, c] * (bins[f, r] == b)
//
// over bins [F, N] u8 and gh [N, C] f32 (C a multiple of 128), in f32.
//
// Replaces lightgbm_tpu/ops/pallas_hist.py _hist_kernel /
// hist_pallas_channels (and the single-leaf form hist_pallas_fm).  The
// Pallas kernel multiplies a one-hot [rows, B] factor built in VMEM with
// the [rows, 128] channel block on the MXU at HIGHEST precision; Hopper
// scatters into shared memory instead:
//
//   pass 1 (hist_channels_rows): block (f, group, channel group) keeps a
//     [B][128] f32 histogram in shared memory (128 KB at B = 256, one
//     block per SM).  One warp takes one row: its 32 lanes load gh[r, 4l ..
//     4l+3] as one 16-byte load each (the row's 512 bytes in one coalesced
//     transaction) and add into 4 distinct shared addresses, so lanes
//     never collide; only warps on the same bin contend.  Channel 4l + j
//     is kept at shared position 32j + l, which puts the 32 lanes of each
//     add on 32 banks.  The block walks the row chunks group, group + G,
//     ..., and stores its histogram once to its slice of the workspace
//     [G][F][B][C].
//   pass 2 (hist_channels_reduce): sums the G slices in order.  No global
//     atomics.
//
// What bounds it: bytes.  The function reads F*N bin bytes and the 4*N*C
// bytes of gh once and writes 4*F*B*C bytes; the F*N*C f32 adds are ~3x
// less time at 67 TFLOP/s.  This kernel reads gh once per feature, so the
// feature blocks of a row chunk are launched next to each other
// (blockIdx.x = feature) and walk the chunks in step, keeping a chunk's gh
// in the 50 MB L2 for the other features.  Shared atomics are the
// practical limit, as in K1.  The adds run in an order that changes from
// run to run: sums agree with the plain version to f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;       // channels of one block
constexpr int kThreads = 512;     // 16 warps

__global__ void __launch_bounds__(kThreads)
hist_channels_rows(const uint8_t* __restrict__ bins,
                   const float* __restrict__ gh, int F, int N, int B, int C,
                   int rows_per_chunk, int chunks,
                   float* __restrict__ ws) {
  extern __shared__ __align__(16) float hist[];   // [B][128], permuted
  const int f = blockIdx.x;
  const int group = blockIdx.y;
  const int groups = gridDim.y;
  const int cg = blockIdx.z;
  const int cells = B * kGroup;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const uint8_t* col = bins + static_cast<size_t>(f) * N;
  const float* base = gh + cg * kGroup + 4 * lane;
  for (int chunk = group; chunk < chunks; chunk += groups) {
    const int r0 = chunk * rows_per_chunk;
    const int r1 = min(N, r0 + rows_per_chunk);
    for (int r = r0 + warp; r < r1; r += warps) {
      const int b = col[r];
      if (b >= B) continue;  // the Pallas one-hot has no lane for it either
      const float4 v = *reinterpret_cast<const float4*>(
          base + static_cast<size_t>(r) * C);
      float* h = hist + b * kGroup + lane;
      atomicAdd(h, v.x);
      atomicAdd(h + 32, v.y);
      atomicAdd(h + 64, v.z);
      atomicAdd(h + 96, v.w);
    }
  }
  __syncthreads();

  float* out = ws + (static_cast<size_t>(group) * F + f) * B * C +
               cg * kGroup;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i / kGroup;
    const int c = i % kGroup;                      // natural channel 4l + j
    out[static_cast<size_t>(b) * C + c] = hist[b * kGroup + (c & 3) * 32 +
                                               (c >> 2)];
  }
}

__global__ void hist_channels_reduce(const float* __restrict__ ws,
                                     int groups, long long total,
                                     float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  for (int g = 0; g < groups; ++g) acc += ws[g * total + idx];
  out[idx] = acc;
}

}  // namespace

extern "C" int lgbm_hist_channels_smem_bytes(int B) {
  return B * kGroup * static_cast<int>(sizeof(float));
}

// Launches both passes on ``stream``: ``groups`` blocks per (feature,
// channel group), each over the row chunks group, group + groups, ...;
// ``ws`` is f32 [groups, F, B, C].  Returns cudaGetLastError() after the
// launches (0 = ok).
extern "C" int lgbm_hist_channels(const uint8_t* bins, const float* gh,
                                  int F, int N, int B, int C, int groups,
                                  int rows_per_chunk, float* ws, float* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = lgbm_hist_channels_smem_bytes(B);
  cudaError_t err = cudaFuncSetAttribute(
      hist_channels_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool rows = F > 0 && N > 0;
  if (rows) {
    const int chunks = (N + rows_per_chunk - 1) / rows_per_chunk;
    hist_channels_rows<<<dim3(F, groups, C / kGroup), kThreads, smem, st>>>(
        bins, gh, F, N, B, C, rows_per_chunk, chunks, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(F) * B * C;
  if (total > 0) {
    hist_channels_reduce<<<static_cast<unsigned>((total + 255) / 256), 256,
                           0, st>>>(ws, rows ? groups : 0, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}
