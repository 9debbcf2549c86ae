// L2 reduction rate of the card: n fire-and-forget f32 reductions into
// `cells` 16-byte cells at scattered addresses, as one float4 reduction
// (the form K1's float row pass issues, lightgbm_tpu_torch/csrc/hist_wave.cu),
// a float2 + a float, three floats, one float, and one plain float4 store
// for comparison.  Prints milliseconds (best of 10) and millions of
// operations per second for each, at 451,584 cells (K1's accumulator at
// F=28, B=256, S=63), 7,168 (one slot) and 64 (a hot spot).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/l2_reduction_rate \
//        lightgbm_tpu_torch/tools/l2_reduction_rate.cu && build/l2_reduction_rate
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned cell_of(unsigned i, unsigned cells) {
  return (i * 2654435761u) % cells;   // scattered, every cell hit
}

__global__ void red_f32x4(float* acc, unsigned n, unsigned cells) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    atomicAdd(reinterpret_cast<float4*>(acc + 4 * cell_of(i, cells)),
              make_float4(1.0f, 2.0f, 1.0f, 0.0f));
  }
}

__global__ void red_f32x2_f32(float* acc, unsigned n, unsigned cells) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float* p = acc + 4 * cell_of(i, cells);
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(1.0f, 2.0f));
    atomicAdd(p + 2, 1.0f);
  }
}

__global__ void red_3_f32(float* acc, unsigned n, unsigned cells) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float* p = acc + 4 * cell_of(i, cells);
    atomicAdd(p, 1.0f);
    atomicAdd(p + 1, 2.0f);
    atomicAdd(p + 2, 1.0f);
  }
}

__global__ void red_f32(float* acc, unsigned n, unsigned cells) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    atomicAdd(acc + 4 * cell_of(i, cells), 1.0f);
  }
}

__global__ void store_f32x4(float* acc, unsigned n, unsigned cells) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    reinterpret_cast<float4*>(acc)[cell_of(i, cells)] =
        make_float4(1.0f, 2.0f, 1.0f, 0.0f);
  }
}

template <typename Kernel>
void run(const char* name, Kernel kernel, float* acc, unsigned n,
         unsigned cells, int grid) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kernel<<<grid, 256>>>(acc, n, cells);
  cudaDeviceSynchronize();
  float best = 1e30f;
  for (int r = 0; r < 10; ++r) {
    cudaEventRecord(a);
    kernel<<<grid, 256>>>(acc, n, cells);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, a, b);
    best = ms < best ? ms : best;
  }
  std::printf("%-14s cells %7u: %.4f ms, %.1f M ops/s\n", name, cells, best,
              n / best / 1e3);
}

int main() {
  const unsigned n = 14000000;   // K1's reductions at the main check shape
  float* acc = nullptr;
  if (cudaMalloc(&acc, 16u * 451584u) != cudaSuccess) return 1;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int grid = 8 * sms;
  for (unsigned cells : {451584u, 7168u, 64u}) {
    run("red f32x4", red_f32x4, acc, n, cells, grid);
    run("red f32x2+f32", red_f32x2_f32, acc, n, cells, grid);
    run("red 3 x f32", red_3_f32, acc, n, cells, grid);
    run("red f32", red_f32, acc, n, cells, grid);
    run("store f32x4", store_f32x4, acc, n, cells, grid);
  }
  const cudaError_t err = cudaGetLastError();
  std::printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
