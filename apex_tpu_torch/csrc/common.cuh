// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function (bound with ctypes from
// csrc/build.py): pointers and the stream arrive as void*, the element type
// as an int (kF32 / kBF16), and the function returns cudaGetLastError() so
// that a refused launch (too many threads, too much shared memory) is seen
// by the Python wrapper, which raises.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex_torch {

// The masked-score value of the reference kernels
// (apex_tpu/ops/flash_attention.py _NEG_INF): finite, so a fully-masked row
// keeps m == kNegInf and the kernels zero its probabilities explicitly.
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum over the whole block; `red` holds at least 33 floats of shared memory.
// Safe to call repeatedly: the leading barrier keeps a call's writes from
// racing the previous call's readers.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < nwarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// Opt `Kernel` in to `bytes` of dynamic shared memory (above 48 KB this is
// required). Done once per kernel and size, on its first launch -- never
// again, so later launches (and CUDA-graph captures) skip the call.
template <auto Kernel>
inline int set_max_smem(size_t bytes) {
  static size_t done = 0;  // one per kernel instantiation
  if (bytes <= done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  done = bytes;
  return 0;
}

}  // namespace apex_torch

extern "C" const char* apex_torch_error_string(int err);
