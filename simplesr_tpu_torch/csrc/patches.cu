// Overlapping-window patch extraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel extract_overlapping_patches_pallas
// (simplesr_tpu/ops/pallas/tiling_kernel.py). From a pre-padded (hp, wp, c)
// image it writes a row-major grid of (win_h, win_w, c) windows whose
// origins step by (ph, pw): window (gi, gj) starts at row gi*ph, column gj*pw.
//
// Bound on the H100: bytes. It is pure data movement, and a window row of
// win_w*c elements is contiguous in the image and in the output. So one warp
// copies one window row: the row's source and destination are computed once
// per warp, and where both ends and the row length are 16-byte multiples
// (the tiled route's case: 3,648-float image rows, 384-float window steps,
// 576-float window rows) the lanes move float4s; otherwise 4-byte floats.
// The tiled route's images are float32, the one type it takes; a copy is
// exact. Any c and any patch width are taken: the TPU kernel's 128-lane
// alignment rule has no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each
constexpr int kThreads = 32 * kRowsPerBlock;

__global__ void __launch_bounds__(kThreads)
extract_patch_rows_kernel(const float* __restrict__ src, float* __restrict__ dst, int rows,
                          int wp, int c, int ph, int pw, int win_h, int row_len, int grid_w) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int r = row % win_h;
  const int patch = row / win_h;
  const int gi = patch / grid_w;
  const int gj = patch % grid_w;
  const float* s = src + (static_cast<long long>(gi * ph + r) * wp +
                          static_cast<long long>(gj) * pw) * c;
  float* d = dst + static_cast<long long>(row) * row_len;
  const bool vector =
      ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0 &&
      (row_len & 3) == 0;
  if (vector) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* d4 = reinterpret_cast<float4*>(d);
#pragma unroll 4
    for (int i = lane; i < row_len / 4; i += 32) d4[i] = __ldg(s4 + i);
  } else {
#pragma unroll 4
    for (int i = lane; i < row_len; i += 32) d[i] = __ldg(s + i);
  }
}

}  // namespace

// src: (hp, wp, c) float32, contiguous. dst: (grid_h * grid_w, win_h, win_w, c)
// float32, contiguous. Returns a CUDA error, or 0.
extern "C" int ssr_extract_patches(const float* src, float* dst, int wp, int c, int ph,
                                   int pw, int win_h, int win_w, int grid_h, int grid_w,
                                   void* stream) {
  const long long rows = static_cast<long long>(grid_h) * grid_w * win_h;
  if (rows == 0 || win_w == 0 || c == 0) return cudaSuccess;
  if (rows > 0x7FFFFFFFLL || static_cast<long long>(win_w) * c > 0x7FFFFFFFLL) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  extract_patch_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      src, dst, static_cast<int>(rows), wp, c, ph, pw, win_h, win_w * c, grid_w);
  return cudaGetLastError();
}

// The patch kernel's resources, from cudaFuncGetAttributes: out = {registers
// per thread, local (spill) bytes per thread, static shared bytes, dynamic
// shared bytes per launch, threads per block}. Returns a CUDA error, or 0.
extern "C" int ssr_patches_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, extract_patch_rows_kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = 0;
  out[4] = kThreads;
  return 0;
}
