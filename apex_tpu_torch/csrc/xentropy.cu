// Softmax cross-entropy with label smoothing, forward and backward, for
// Hopper.
//
// Forward. Replaces: apex_tpu/ops/xentropy.py _xent_fwd_kernel (pallas_call
// in _fwd, xentropy.py:75). Per row of logits x (vocab V) with label y:
//   lse  = log sum exp x                                   (fp32)
//   loss = (1 - e) (lse - x_y) + e (lse - mean x)   (e > 0; lse - x_y at e = 0)
// and loss = 0 where y == ignore_index. A label outside [0, V) other than
// ignore_index takes x_y = 0, as the reference kernel does. Writes loss and
// lse, both fp32.
//
// Backward. Replaces: _xent_bwd_kernel (pallas_call in _bwd,
// xentropy.py:108). From the row's upstream grad g and the forward's lse:
//   dx = (exp(x - lse) - (1 - e) onehot(y) - e / V) * g
// in x's dtype, exactly 0 on rows whose label is ignore_index.
//
// Bound on this card: bytes. The forward reads the row once and does a few
// operations per element (one exp2, a max, two adds); the backward reads it
// once and writes dx once. Design: one CTA per row, threads striding over
// the row with 16-byte loads (4 fp32 or 8 bf16 a thread) where the row
// starts 16-byte aligned (V * element size % 16 == 0), scalar loads
// otherwise, so any rows and any V run with no padding. The forward keeps a
// per-thread online (max, sum of exp) -- each 16-byte vector rescales the
// sum once -- and the row sum of x, then merges them over the block with
// warp shuffles and one shared-memory exchange; one thread reads x_y from
// the row directly (one element, already in L1/L2). The backward skips the
// read of an ignored row and writes its zeros. Labels are taken as int64,
// torch's default, with no device-side cast.

#include <float.h>

#include "common.cuh"

namespace apex_torch {

constexpr int kXentThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of T as fp32 values
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
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
struct Vec16<__nv_bfloat16> {
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
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// Merge the online pair (m, s) with (m2, s2): the sum of exp(x - m) over both.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  s = s * exp2f((m - mn) * kLog2e) + s2 * exp2f((m2 - mn) * kLog2e);
  m = mn;
}

__device__ __forceinline__ void lse_add(float& m, float& s, float v) {
  if (v > m) {
    s *= exp2f((m - v) * kLog2e);
    m = v;
  }
  s += exp2f((v - m) * kLog2e);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kXentThreads)
    xent_fwd_kernel(const T* __restrict__ x,
                    const long long* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    int vocab, float smoothing, long long ignore_index) {
  __shared__ float red_m[32], red_s[32], red_x[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)vocab;
  float m = -FLT_MAX, s = 0.f, sx = 0.f;
  if (VEC) {
    constexpr int N = Vec16<T>::N;
    const int nvec = vocab / N;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float v[N];
      Vec16<T>::load(xr + (size_t)i * N, v);
      float vm = v[0];
#pragma unroll
      for (int k = 1; k < N; ++k) vm = fmaxf(vm, v[k]);
      if (vm > m) {
        s *= exp2f((m - vm) * kLog2e);
        m = vm;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s += exp2f((v[k] - m) * kLog2e);
        sx += v[k];
      }
    }
  } else {
    for (int i = threadIdx.x; i < vocab; i += blockDim.x) {
      const float v = to_f32(xr[i]);
      lse_add(m, s, v);
      sx += v;
    }
  }
  // warp, then block: (m, s) merge and the plain sum of x
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    red_m[wid] = m;
    red_s[wid] = s;
    red_x[wid] = sx;
  }
  __syncthreads();
  if (wid == 0) {
    m = lane < nwarps ? red_m[lane] : -FLT_MAX;
    s = lane < nwarps ? red_s[lane] : 0.f;
    sx = lane < nwarps ? red_x[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      lse_merge(m, s, m2, s2);
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
    }
    if (lane == 0) {
      const long long y = labels[row];
      const float lse = m + logf(s);
      const float xy = (y >= 0 && y < vocab) ? to_f32(xr[y]) : 0.f;
      const float nll = lse - xy;
      float l = nll;
      if (smoothing > 0.f)
        l = (1.f - smoothing) * nll + smoothing * (lse - sx / (float)vocab);
      loss[row] = y != ignore_index ? l : 0.f;
      lse_out[row] = lse;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kXentThreads)
    xent_bwd_kernel(const float* __restrict__ g, const T* __restrict__ x,
                    const long long* __restrict__ labels,
                    const float* __restrict__ lse, T* __restrict__ dx,
                    int vocab, float smoothing, long long ignore_index) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)vocab;
  T* dr = dx + row * (size_t)vocab;
  const long long y = labels[row];
  const bool ignored = y == ignore_index;
  const float gr = g[row], l = lse[row];
  const float on = 1.f - smoothing, off = smoothing / (float)vocab;
  if (VEC) {
    constexpr int N = Vec16<T>::N;
    const int nvec = vocab / N;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float v[N];
      if (ignored) {
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = 0.f;
      } else {
        Vec16<T>::load(xr + (size_t)i * N, v);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float p = exp2f((v[k] - l) * kLog2e);
          const float hit = (long long)(i * N + k) == y ? on : 0.f;
          v[k] = (p - hit - off) * gr;
        }
      }
      Vec16<T>::store(dr + (size_t)i * N, v);
    }
  } else {
    for (int i = threadIdx.x; i < vocab; i += blockDim.x) {
      float d = 0.f;
      if (!ignored) {
        const float p = exp2f((to_f32(xr[i]) - l) * kLog2e);
        const float hit = (long long)i == y ? on : 0.f;
        d = (p - hit - off) * gr;
      }
      dr[i] = from_f32<T>(d);
    }
  }
}

// Threads of a row's CTA: one per 16-byte vector (or element), in whole
// warps, at most kXentThreads.
inline int xent_threads(int units) {
  int t = ((units + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kXentThreads ? kXentThreads : t);
}

inline bool xent_vec_ok(int vocab, int elem_bytes, const void* a,
                        const void* b) {
  return (vocab * elem_bytes) % 16 == 0 && ((uintptr_t)a & 15) == 0 &&
         ((uintptr_t)b & 15) == 0;
}

template <typename T>
int launch_fwd(const void* x, const void* labels, void* loss, void* lse,
               long long rows, int vocab, float smoothing,
               long long ignore_index, cudaStream_t s) {
  const bool vec = xent_vec_ok(vocab, sizeof(T), x, x);
  const int threads = xent_threads(vec ? vocab / Vec16<T>::N : vocab);
  const dim3 grid((unsigned)rows);
  if (vec)
    xent_fwd_kernel<T, true><<<grid, threads, 0, s>>>(
        (const T*)x, (const long long*)labels, (float*)loss, (float*)lse,
        vocab, smoothing, ignore_index);
  else
    xent_fwd_kernel<T, false><<<grid, threads, 0, s>>>(
        (const T*)x, (const long long*)labels, (float*)loss, (float*)lse,
        vocab, smoothing, ignore_index);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* labels,
               const void* lse, void* dx, long long rows, int vocab,
               float smoothing, long long ignore_index, cudaStream_t s) {
  const bool vec = xent_vec_ok(vocab, sizeof(T), x, dx);
  const int threads = xent_threads(vec ? vocab / Vec16<T>::N : vocab);
  const dim3 grid((unsigned)rows);
  if (vec)
    xent_bwd_kernel<T, true><<<grid, threads, 0, s>>>(
        (const float*)g, (const T*)x, (const long long*)labels,
        (const float*)lse, (T*)dx, vocab, smoothing, ignore_index);
  else
    xent_bwd_kernel<T, false><<<grid, threads, 0, s>>>(
        (const float*)g, (const T*)x, (const long long*)labels,
        (const float*)lse, (T*)dx, vocab, smoothing, ignore_index);
  return (int)cudaGetLastError();
}

}  // namespace apex_torch

using namespace apex_torch;

// x: contiguous (rows, vocab) fp32/bf16; labels: int64 (rows,); loss, lse:
// fp32 (rows,).
extern "C" int apex_xent_fwd(const void* x, const void* labels, void* loss,
                             void* lse, long long rows, int vocab,
                             float smoothing, long long ignore_index,
                             int dtype, void* stream) {
  if (rows <= 0 || vocab <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_fwd<float>(x, labels, loss, lse, rows, vocab, smoothing,
                             ignore_index, s);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(x, labels, loss, lse, rows, vocab,
                                     smoothing, ignore_index, s);
  return (int)cudaErrorInvalidValue;
}

// g, lse: fp32 (rows,); x, dx: contiguous (rows, vocab) in one dtype;
// labels: int64 (rows,).
extern "C" int apex_xent_bwd(const void* g, const void* x, const void* labels,
                             const void* lse, void* dx, long long rows,
                             int vocab, float smoothing,
                             long long ignore_index, int dtype, void* stream) {
  if (rows <= 0 || vocab <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_bwd<float>(g, x, labels, lse, dx, rows, vocab, smoothing,
                             ignore_index, s);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(g, x, labels, lse, dx, rows, vocab,
                                     smoothing, ignore_index, s);
  return (int)cudaErrorInvalidValue;
}
