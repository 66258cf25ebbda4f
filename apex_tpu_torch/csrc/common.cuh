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

// ---------------------------------------------------------------------------
// bf16 tensor-core fragments (mma.sync m16n8k16, fp32 accumulate), shared by
// the flash-attention forward and backward. Lane l of a warp is (g, tig) =
// (l / 4, l % 4). A (16x16, row-major M x K): a0 = (g, 2tig..+1),
// a1 = (g+8, 2tig..), a2 = (g, 2tig+8..), a3 = (g+8, 2tig+8..). B (16x8,
// stored N x K with K contiguous): b0 = (n g, k 2tig..+1), b1 = (n g,
// k 2tig+8..). C (16x8): c0,c1 = (g, 2tig..+1), c2,c3 = (g+8, 2tig..+1). The
// C layout of two neighbouring n-tiles is the A layout of one k-chunk, so a
// product's fp32 result feeds the next product without shared memory.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;         // rows of every q/k tile
constexpr int kMmaThreads = 128;  // 4 warps, 16 tile rows each

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// kTile x DP tile from src[r * stride + c] into dst[r * ld + c], zero past
// `rows_valid` and d; VEC: 16-byte loads (d % 8 == 0, strides and base
// 16-byte aligned). All kMmaThreads threads take part.
template <int DP, bool VEC>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows_valid,
                                          int d) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  if (VEC) {
    constexpr int C8 = DP / 8;
    for (int e = threadIdx.x; e < kTile * C8; e += kMmaThreads) {
      const int r = e / C8, c = (e - r * C8) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows_valid && c < d)
        val = *reinterpret_cast<const uint4*>(src + r * stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < kTile * DP; e += kMmaThreads) {
      const int r = e / DP, c = e - r * DP;
      dst[r * ld + c] = (r < rows_valid && c < d) ? src[r * stride + c] : zero;
    }
  }
}

// Element strides (batch, head, seq) of a (b, h, s, d) tensor whose head_dim
// stride is 1: the fused-QKV views go in without a copy.
struct Strides {
  long long b, h, s;
};

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
