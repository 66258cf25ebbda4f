// Fused scale + mask + softmax, forward and backward, for Hopper.
//
// Forward. Replaces: apex_tpu/ops/softmax.py _softmax_fwd_kernel (def :40,
// pallas_call in _fwd, softmax.py:100). Per row (b, h, q) of scores x
// (b, h, sq, sk):
//   v_k = scale * x_k, then -10000 where mask[b, 0|h, q, k] is set or, with
//         causal, where k > q (top-left)
//   y_k = exp(v_k - max v) / sum_k exp(v_k - max v)            (fp32)
// written in x's dtype (fp32, bf16 or fp16). Masked positions take
// exp(-10000 - m) / sum like any other, so a fully masked row is uniform at
// 1 / sk. Causal positions above the diagonal are -10000 whatever x holds,
// so x (and the mask) is not read there.
//
// Backward. Replaces: _softmax_bwd_kernel (def :55, pallas_call in _bwd,
// softmax.py:123). From the upstream grad g and the saved y, both in y's
// dtype:  dx = scale * y * (g - sum_k g_k y_k), in y's dtype. No mask: the
// reference VJP works from y alone.
//
// Bound on this card: bytes. A few operations per element (a multiply, a
// max, an exp, an add, a divide) against 4-6 bytes moved per element in
// bf16. Design: 16-byte loads (4 fp32 or 8 bf16/fp16 elements a thread)
// where the row starts 16-byte aligned (sk * element size % 16 == 0),
// scalar loads otherwise, so any sq, sk and any row count run with no
// padding. Three routes, chosen by the caller from sk and the alignment
// (softmax_route in ops/softmax.py):
//   warp (the forward, aligned rows of sk <= WARP_MAX_COLS): one warp per
//     row, the row held in registers (sk / 32 values a lane), several rows
//     a CTA; no shared memory, no block barrier, shuffles for the max and
//     the sum; x is not read where a whole 16-byte vector is masked or
//     above the diagonal;
//   resident (the other rows up to RESIDENT_MAX_COLS; every backward row
//     up to it), one CTA per row, threads striding over it: the row is
//     staged once in shared memory as fp32 (the forward the masked scores,
//     the backward g and y), so device memory is read once and written
//     once; each thread only touches the elements it loaded;
//   two-pass (longer rows, up to any length), one CTA per row: the forward
//     keeps a per-thread online (max, sum of exp) merged over the block,
//     then reads the row again to write y; the backward sums g * y, then
//     reads g and y again to write dx. The second read comes mostly from
//     L2.
// On the CTA routes the row max, sum and dot product are merged over the
// block with warp shuffles and one shared-memory exchange.

#include <cuda_fp16.h>
#include <float.h>

#include "common.cuh"

namespace apex_torch {
namespace {

constexpr float kFill = -10000.f;  // the reference's _MASK_FILL
constexpr int kResidentThreads = 256;
constexpr int kTwoPassThreads = 1024;
constexpr int kWarpRows = 4;         // rows (warps) a CTA of the warp route
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kF16 = 2;  // DType code of fp16, this kernel pair's own
enum Route : int { kResident = 0, kTwoPass = 1, kWarp = 2 };
constexpr size_t kMaxSmem = 232448;  // 227 KB a block on an H100

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f32(__half* p, float v) {
  *p = __float2half_rn(v);
}

// 16 bytes of T as fp32 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[N]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[N]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float (&v)[N]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__half* p, const float (&v)[N]) {
    uint4 q;
    __half2* h = reinterpret_cast<__half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// N mask bytes (N = 4 or 8, N-byte aligned): nonzero = masked
template <int N>
__device__ __forceinline__ void load_mask(const uint8_t* p, bool (&m)[N]) {
  if constexpr (N == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) m[i] = (w >> (8 * i)) & 0xffu;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i)
      m[i] = ((i < 4 ? w.x : w.y) >> (8 * (i & 3))) & 0xffu;
  }
}

// N fp32 values to and from shared memory as 16-byte accesses (p 16-byte
// aligned), so the neighbouring threads of a warp hit no bank twice.
template <int N>
__device__ __forceinline__ void smem_store(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int N>
__device__ __forceinline__ void smem_load(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

// Max over the whole block; `red` holds at least 33 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < nwarps ? red[lane] : -FLT_MAX;
    t = warp_max(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// Merge the online pair (m, s) with (m2, s2): the sum of exp(v - m) over both.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// The (max, sum) pair merged over the whole block; red_m/red_s: 32 floats.
__device__ __forceinline__ void block_merge(float& m, float& s, float* red_m,
                                            float* red_s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) {
    red_m[wid] = m;
    red_s[wid] = s;
  }
  __syncthreads();
  m = lane < nwarps ? red_m[lane] : -FLT_MAX;
  s = lane < nwarps ? red_s[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
}

// Where one row lives: its scores, its mask row (or null) and the number of
// leading columns that can be visible (q + 1 under causal, else sk).
template <typename T>
struct Row {
  const T* x;
  const uint8_t* mask;
  int lim;
};

template <typename T>
__device__ __forceinline__ Row<T> row_of(const T* x, const uint8_t* mask,
                                         long long row, int h, int sq, int sk,
                                         long long mask_b, long long mask_h,
                                         int causal) {
  const int q = (int)(row % sq);
  const long long bh = row / sq;
  Row<T> r;
  r.x = x + row * (long long)sk;
  r.mask = mask ? mask + (bh / h) * mask_b + (bh % h) * mask_h +
                      (long long)q * sk
                : nullptr;
  r.lim = causal ? min(q + 1, sk) : sk;
  return r;
}

// The masked, scaled scores of the 16-byte vector at column k0 (all fill
// past the visible limit, with no read).
template <typename T>
__device__ __forceinline__ void scores_vec(const Row<T>& r, int k0,
                                           float scale,
                                           float (&v)[Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  if (k0 >= r.lim) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = kFill;
    return;
  }
  Vec<T>::load(r.x + k0, v);
  bool m[N];
  if (r.mask) {
    load_mask<N>(r.mask + k0, m);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) m[j] = false;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] *= scale;
    if (m[j] || k0 + j >= r.lim) v[j] = kFill;
  }
}

template <typename T>
__device__ __forceinline__ float score(const Row<T>& r, int k, float scale) {
  if (k >= r.lim || (r.mask && r.mask[k])) return kFill;
  return load_f32(r.x + k) * scale;
}

// The warp route: one warp per row, the row in registers (V 16-byte
// vectors a lane, vector i * 32 + lane; rows of at most 32 V N elements,
// sk % N == 0, 16-byte aligned), kWarpRows rows a CTA. No shared memory and
// no block barrier: the max and the sum are warp shuffles. The mask words
// of all the lane's vectors are loaded first, then x only where some
// element of a vector can change y (visible and not masked); y is written
// with 16-byte stores. exp(v - m) is exp2((v - m) log2 e): a fully masked
// row has v - m = 0 everywhere, so it stays uniform at 1 / sk.
template <typename T, int V>
__global__ void __launch_bounds__(kWarpRows * 32)
    softmax_fwd_warp(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                     T* __restrict__ y, long long rows, int h, int sq, int sk,
                     long long mask_b, long long mask_h, float scale,
                     int causal) {
  constexpr int N = Vec<T>::N;
  const long long row =
      (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const Row<T> r = row_of(x, mask, row, h, sq, sk, mask_b, mask_h, causal);
  bool mk[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k0 = (i * 32 + lane) * N;
    if (r.mask && k0 < r.lim) {
      load_mask<N>(r.mask + k0, mk[i]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) mk[i][j] = false;
    }
  }
  float v[V][N];
  float m = -FLT_MAX;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k0 = (i * 32 + lane) * N;
    bool live = k0 < r.lim;
#pragma unroll
    for (int j = 0; j < N; ++j) live = live && mk[i][j];
    live = k0 < r.lim && !live;  // some element visible and unmasked
    if (live) Vec<T>::load(r.x + k0, v[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[i][j] = live && !mk[i][j] && k0 + j < r.lim ? v[i][j] * scale : kFill;
      if (k0 < sk) m = fmaxf(m, v[i][j]);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if ((i * 32 + lane) * N >= sk) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[i][j] = exp2f((v[i][j] - m) * kLog2e);
      sum += v[i][j];
    }
  }
  const float inv = 1.f / warp_sum(sum);
  T* yr = y + row * sk;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k0 = (i * 32 + lane) * N;
    if (k0 >= sk) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] *= inv;
    Vec<T>::store(yr + k0, v[i]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kResidentThreads)
    softmax_fwd_resident(const T* __restrict__ x,
                         const uint8_t* __restrict__ mask, T* __restrict__ y,
                         int h, int sq, int sk, long long mask_b,
                         long long mask_h, float scale, int causal) {
  extern __shared__ float buf[];  // the row's masked scores, then exp
  __shared__ float red[33];
  const Row<T> r =
      row_of(x, mask, blockIdx.x, h, sq, sk, mask_b, mask_h, causal);
  T* yr = y + (long long)blockIdx.x * sk;
  float m = -FLT_MAX;
  constexpr int N = Vec<T>::N;
  const int n = VEC ? sk / N : sk;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float v[N];
      scores_vec(r, i * N, scale, v);
      smem_store<N>(buf + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaxf(m, v[j]);
    } else {
      const float v = score(r, i, scale);
      buf[i] = v;
      m = fmaxf(m, v);
    }
  }
  m = block_max(m, red);
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float v[N];
      smem_load<N>(buf + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = expf(v[j] - m);
        s += v[j];
      }
      smem_store<N>(buf + i * N, v);
    } else {
      const float e = expf(buf[i] - m);
      buf[i] = e;
      s += e;
    }
  }
  s = block_sum(s, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float v[N];
      smem_load<N>(buf + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] /= s;
      Vec<T>::store(yr + i * N, v);
    } else {
      store_f32(yr + i, buf[i] / s);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kTwoPassThreads)
    softmax_fwd_two_pass(const T* __restrict__ x,
                         const uint8_t* __restrict__ mask, T* __restrict__ y,
                         int h, int sq, int sk, long long mask_b,
                         long long mask_h, float scale, int causal) {
  __shared__ float red_m[32], red_s[32];
  const Row<T> r =
      row_of(x, mask, blockIdx.x, h, sq, sk, mask_b, mask_h, causal);
  T* yr = y + (long long)blockIdx.x * sk;
  constexpr int N = Vec<T>::N;
  const int n = VEC ? sk / N : sk;
  float m = -FLT_MAX, s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float v[N];
      scores_vec(r, i * N, scale, v);
      float vm = v[0];
#pragma unroll
      for (int j = 1; j < N; ++j) vm = fmaxf(vm, v[j]);
      if (vm > m) {
        s *= expf(m - vm);
        m = vm;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) s += expf(v[j] - m);
    } else {
      const float v = score(r, i, scale);
      if (v > m) {
        s *= expf(m - v);
        m = v;
      }
      s += expf(v - m);
    }
  }
  block_merge(m, s, red_m, red_s);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float v[N];
      scores_vec(r, i * N, scale, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = expf(v[j] - m) / s;
      Vec<T>::store(yr + i * N, v);
    } else {
      store_f32(yr + i, expf(score(r, i, scale) - m) / s);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kResidentThreads)
    softmax_bwd_resident(const T* __restrict__ g, const T* __restrict__ y,
                         T* __restrict__ dx, int sk, float scale) {
  extern __shared__ float buf[];  // g in [0, sk), y in [sk, 2 sk)
  __shared__ float red[33];
  const long long off = (long long)blockIdx.x * sk;
  constexpr int N = Vec<T>::N;
  const int n = VEC ? sk / N : sk;
  float dot = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float gv[N], yv[N];
      Vec<T>::load(g + off + i * N, gv);
      Vec<T>::load(y + off + i * N, yv);
      smem_store<N>(buf + i * N, gv);
      smem_store<N>(buf + sk + i * N, yv);
#pragma unroll
      for (int j = 0; j < N; ++j) dot += gv[j] * yv[j];
    } else {
      const float gv = load_f32(g + off + i), yv = load_f32(y + off + i);
      buf[i] = gv;
      buf[sk + i] = yv;
      dot += gv * yv;
    }
  }
  dot = block_sum(dot, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float gv[N], yv[N];
      smem_load<N>(buf + i * N, gv);
      smem_load<N>(buf + sk + i * N, yv);
#pragma unroll
      for (int j = 0; j < N; ++j) gv[j] = scale * yv[j] * (gv[j] - dot);
      Vec<T>::store(dx + off + i * N, gv);
    } else {
      store_f32(dx + off + i, scale * buf[sk + i] * (buf[i] - dot));
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kTwoPassThreads)
    softmax_bwd_two_pass(const T* __restrict__ g, const T* __restrict__ y,
                         T* __restrict__ dx, int sk, float scale) {
  __shared__ float red[33];
  const long long off = (long long)blockIdx.x * sk;
  constexpr int N = Vec<T>::N;
  const int n = VEC ? sk / N : sk;
  float dot = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float gv[N], yv[N];
      Vec<T>::load(g + off + i * N, gv);
      Vec<T>::load(y + off + i * N, yv);
#pragma unroll
      for (int j = 0; j < N; ++j) dot += gv[j] * yv[j];
    } else {
      dot += load_f32(g + off + i) * load_f32(y + off + i);
    }
  }
  dot = block_sum(dot, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (VEC) {
      float gv[N], yv[N];
      Vec<T>::load(g + off + i * N, gv);
      Vec<T>::load(y + off + i * N, yv);
#pragma unroll
      for (int j = 0; j < N; ++j) gv[j] = scale * yv[j] * (gv[j] - dot);
      Vec<T>::store(dx + off + i * N, gv);
    } else {
      const float gv = load_f32(g + off + i), yv = load_f32(y + off + i);
      store_f32(dx + off + i, scale * yv * (gv - dot));
    }
  }
}

// Threads of a resident row's CTA: one per 16-byte vector (or element), in
// whole warps, at most kResidentThreads.
inline int resident_threads(int units) {
  int t = ((units + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kResidentThreads ? kResidentThreads : t);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The warp route's kernel for rows of sk elements: the fewest 16-byte
// vectors a lane (a power of two, at most kWarpMaxVecs) that hold the row.
template <typename T>
int launch_fwd_warp(const T* x, const uint8_t* mask, T* y, long long rows,
                    int h, int sq, int sk, long long mask_b, long long mask_h,
                    float scale, int causal, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
  const dim3 grid((unsigned)blocks), block(kWarpRows * 32);
  int vecs = 1;
  while (vecs * 32 * N < sk) vecs *= 2;
#define APEX_SOFTMAX_WARP(VV)                                            \
  case VV:                                                               \
    softmax_fwd_warp<T, VV><<<grid, block, 0, s>>>(                      \
        x, mask, y, rows, h, sq, sk, mask_b, mask_h, scale, causal);     \
    break;
  switch (vecs) {
    APEX_SOFTMAX_WARP(1)
    APEX_SOFTMAX_WARP(2)
    APEX_SOFTMAX_WARP(4)
    APEX_SOFTMAX_WARP(8)
    APEX_SOFTMAX_WARP(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef APEX_SOFTMAX_WARP
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* mask, void* y, long long rows, int h,
               int sq, int sk, int mask_heads, float scale, int causal,
               int route, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const bool vec = (sk * (int)sizeof(T)) % 16 == 0 && aligned16(x) &&
                   aligned16(y) && (!mask || aligned16(mask));
  const long long plane = (long long)sq * sk;
  const long long mask_h = mask_heads > 1 ? plane : 0;
  const long long mask_b = (long long)mask_heads * plane;
  const uint8_t* mk = (const uint8_t*)mask;
  const dim3 grid((unsigned)rows);
  if (route == kWarp) {
    if (!vec) return (int)cudaErrorInvalidValue;
    return launch_fwd_warp<T>((const T*)x, mk, (T*)y, rows, h, sq, sk,
                              mask_b, mask_h, scale, causal, s);
  }
  if (route == kTwoPass) {
    if (vec)
      softmax_fwd_two_pass<T, true><<<grid, kTwoPassThreads, 0, s>>>(
          (const T*)x, mk, (T*)y, h, sq, sk, mask_b, mask_h, scale, causal);
    else
      softmax_fwd_two_pass<T, false><<<grid, kTwoPassThreads, 0, s>>>(
          (const T*)x, mk, (T*)y, h, sq, sk, mask_b, mask_h, scale, causal);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)sk * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int threads = resident_threads(vec ? sk / N : sk);
  int err;
  if (vec) {
    if ((err = set_max_smem<softmax_fwd_resident<T, true>>(smem))) return err;
    softmax_fwd_resident<T, true><<<grid, threads, smem, s>>>(
        (const T*)x, mk, (T*)y, h, sq, sk, mask_b, mask_h, scale, causal);
  } else {
    if ((err = set_max_smem<softmax_fwd_resident<T, false>>(smem))) return err;
    softmax_fwd_resident<T, false><<<grid, threads, smem, s>>>(
        (const T*)x, mk, (T*)y, h, sq, sk, mask_b, mask_h, scale, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* y, void* dx, long long rows, int sk,
               float scale, int two_pass, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const bool vec = (sk * (int)sizeof(T)) % 16 == 0 && aligned16(g) &&
                   aligned16(y) && aligned16(dx);
  const dim3 grid((unsigned)rows);
  if (two_pass) {
    if (vec)
      softmax_bwd_two_pass<T, true><<<grid, kTwoPassThreads, 0, s>>>(
          (const T*)g, (const T*)y, (T*)dx, sk, scale);
    else
      softmax_bwd_two_pass<T, false><<<grid, kTwoPassThreads, 0, s>>>(
          (const T*)g, (const T*)y, (T*)dx, sk, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * (size_t)sk * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int threads = resident_threads(vec ? sk / N : sk);
  int err;
  if (vec) {
    if ((err = set_max_smem<softmax_bwd_resident<T, true>>(smem))) return err;
    softmax_bwd_resident<T, true><<<grid, threads, smem, s>>>(
        (const T*)g, (const T*)y, (T*)dx, sk, scale);
  } else {
    if ((err = set_max_smem<softmax_bwd_resident<T, false>>(smem))) return err;
    softmax_bwd_resident<T, false><<<grid, threads, smem, s>>>(
        (const T*)g, (const T*)y, (T*)dx, sk, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace apex_torch

using namespace apex_torch;

// x, y: contiguous (b, h, sq, sk) of one dtype, rows = b * h * sq; mask:
// null (mask_heads 0) or contiguous bool (b, mask_heads, sq, sk) with
// mask_heads 1 or h; route: 0 resident (sk * 4 bytes of shared memory a
// CTA), 1 two-pass, 2 warp (16-byte aligned rows of at most 16 vectors a
// lane: 2048 fp32 or 4096 bf16/fp16 elements).
extern "C" int apex_softmax_fwd(const void* x, const void* mask, void* y,
                                long long rows, int h, int sq, int sk,
                                int mask_heads, float scale, int causal,
                                int route, int dtype, void* stream) {
  if (rows <= 0 || h <= 0 || sq <= 0 || sk <= 0 || rows > 0x7fffffffLL ||
      route < kResident || route > kWarp ||
      (mask != nullptr) != (mask_heads > 0) ||
      (mask && mask_heads != 1 && mask_heads != h))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_fwd<float>(x, mask, y, rows, h, sq, sk, mask_heads, scale,
                             causal, route, s);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(x, mask, y, rows, h, sq, sk, mask_heads,
                                     scale, causal, route, s);
  if (dtype == kF16)
    return launch_fwd<__half>(x, mask, y, rows, h, sq, sk, mask_heads, scale,
                              causal, route, s);
  return (int)cudaErrorInvalidValue;
}

// g, y, dx: contiguous (rows, sk) of one dtype; two_pass as above (the
// resident route stages g and y: 2 * sk * 4 bytes of shared memory).
extern "C" int apex_softmax_bwd(const void* g, const void* y, void* dx,
                                long long rows, int sk, float scale,
                                int two_pass, int dtype, void* stream) {
  if (rows <= 0 || sk <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_bwd<float>(g, y, dx, rows, sk, scale, two_pass, s);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(g, y, dx, rows, sk, scale, two_pass, s);
  if (dtype == kF16)
    return launch_bwd<__half>(g, y, dx, rows, sk, scale, two_pass, s);
  return (int)cudaErrorInvalidValue;
}
