// LayerNorm / RMSNorm forward and backward for Hopper.
//
// Forward. Replaces: apex_tpu/ops/layer_norm.py _ln_fwd_kernel (pallas_call
// in _fwd_pallas, layer_norm.py:154). Per row: fp32 mean and variance (two passes, as the
// reference's mean((x - mu)^2)), rstd = rsqrt(var + eps), then
// y = (x - mu) * rstd * gamma + beta in x's dtype; mean and rstd are written
// in fp32 for the training slice's backward. The `rms` flag drops the mean
// term (mean is written as 0). gamma and beta are fp32 and each optional.
//
// Bound on this card: bytes. One read of x and one write of y dominate
// (a few fp32 operations per element against 2-4 bytes). Design: one CTA per
// row, threads striding over the row, so any hidden size works; the second
// and third passes over the row hit L1/L2 (a 1024-wide bf16 row is 2 KB), so
// device memory sees x once and y once. Block reductions are warp shuffles
// plus one shared-memory exchange.
//
// Backward. Replaces: apex_tpu/ops/layer_norm.py _ln_bwd_kernel (pallas_call
// in _bwd_pallas, layer_norm.py:216). From dy = g, x and the forward's fp32
// mean/rstd: x^ = (x - mean) * rstd, wg = g * gamma,
//   dx = rstd * (wg - mean(wg) - x^ * mean(wg * x^))  (RMS: no mean(wg)),
// in x's dtype, plus per-CTA fp32 partial rows of dgamma = sum g * x^ and
// dbeta = sum g over the CTA's rows; the wrapper sums the partials
// (torch.sum), as _bwd_pallas sums its per-block partials outside the
// kernel (layer_norm.py:228-231).
//
// Bound on this card: bytes (g and x read, dx written, a few fp32
// operations per element). Design: one CTA of 256 threads per block of
// kLnBwdRows rows. Pass 1 gives each row's two means with one warp per row
// (shuffles only, no block barrier per row). Pass 2 strides the threads
// over the hidden columns and walks the CTA's rows: it writes dx and keeps
// that column's dgamma/dbeta sums in registers across the rows, then
// writes them once as the CTA's partial row. Any hidden size works; the
// second read of the rows' g and x hits L2 (32 rows x 1024 bf16 x 2 tensors
// is 128 KB a CTA).

#include "common.cuh"

namespace apex_torch {

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ b, T* __restrict__ y,
                              float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int hidden, float eps,
                              int rms) {
  __shared__ float red[33];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)hidden;
  T* yr = y + row * (size_t)hidden;
  const float inv_n = 1.f / (float)hidden;

  float mu = 0.f;
  if (!rms) {
    float s = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) s += to_f32(xr[i]);
    mu = block_sum(s, red) * inv_n;
  }
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float dv = to_f32(xr[i]) - mu;
    ss += dv * dv;
  }
  const float var = block_sum(ss, red) * inv_n;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    float v = (to_f32(xr[i]) - mu) * rstd;
    if (w != nullptr) v *= w[i];
    if (b != nullptr) v += b[i];
    yr[i] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

constexpr int kLnBwdRows = 32;
constexpr int kLnBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kLnBwdThreads)
    ln_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float* __restrict__ w, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part,
                  long long rows, int hidden, int rms) {
  __shared__ float mu_s[kLnBwdRows], rs_s[kLnBwdRows];
  __shared__ float c1_s[kLnBwdRows], c2_s[kLnBwdRows];
  const long long r0 = (long long)blockIdx.x * kLnBwdRows;
  const int nrows = (int)min((long long)kLnBwdRows, rows - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float inv_n = 1.f / (float)hidden;

  // pass 1, one warp per row: c1 = mean(wg * x^), c2 = mean(wg)
  for (int rr = warp; rr < nrows; rr += nwarps) {
    const size_t row = (size_t)(r0 + rr);
    const T* gr = g + row * hidden;
    const T* xr = x + row * hidden;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < hidden; i += 32) {
      const float xh = (to_f32(xr[i]) - mu) * rs;
      const float wg = w != nullptr ? to_f32(gr[i]) * w[i] : to_f32(gr[i]);
      s1 += wg * xh;
      s2 += wg;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      mu_s[rr] = mu;
      rs_s[rr] = rs;
      c1_s[rr] = s1 * inv_n;
      c2_s[rr] = rms ? 0.f : s2 * inv_n;
    }
  }
  __syncthreads();

  // pass 2, threads over columns: dx, and the column's partial sums
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float wi = w != nullptr ? w[i] : 1.f;
    float dwi = 0.f, dbi = 0.f;
    for (int rr = 0; rr < nrows; ++rr) {
      const size_t at = (size_t)(r0 + rr) * hidden + i;
      const float gv = to_f32(g[at]);
      const float xh = (to_f32(x[at]) - mu_s[rr]) * rs_s[rr];
      dx[at] = from_f32<T>(rs_s[rr] * (gv * wi - c2_s[rr] - xh * c1_s[rr]));
      dwi += gv * xh;
      dbi += gv;
    }
    const size_t part = (size_t)blockIdx.x * hidden + i;
    if (dw_part != nullptr) dw_part[part] = dwi;
    if (db_part != nullptr) db_part[part] = dbi;
  }
}

}  // namespace apex_torch

using namespace apex_torch;

extern "C" const char* apex_torch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b, void* y,
                           void* mean, void* rstd, long long rows, int hidden,
                           float eps, int rms, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  int threads = 128;
  if (hidden >= 4096) threads = 512;
  else if (hidden >= 1024) threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)rows);
  if (dtype == kF32) {
    ln_fwd_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)y,
        (float*)mean, (float*)rstd, hidden, eps, rms);
  } else if (dtype == kBF16) {
    ln_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)b,
        (__nv_bfloat16*)y, (float*)mean, (float*)rstd, hidden, eps, rms);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Rows per CTA of apex_ln_bwd: the partial rows number ceil(rows / this).
extern "C" int apex_ln_bwd_rows_per_block() { return kLnBwdRows; }

// g, x, dx: contiguous (rows, hidden) in one dtype; mean/rstd fp32 (rows,);
// w fp32 (hidden,) or null; dw_part/db_part fp32 (ceil(rows / 32), hidden)
// or null (no dgamma / no dbeta wanted).
extern "C" int apex_ln_bwd(const void* g, const void* x, const void* mean,
                           const void* rstd, const void* w, void* dx,
                           void* dw_part, void* db_part, long long rows,
                           int hidden, int rms, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((rows + kLnBwdRows - 1) / kLnBwdRows));
  if (dtype == kF32) {
    ln_bwd_kernel<float><<<grid, kLnBwdThreads, 0, s>>>(
        (const float*)g, (const float*)x, (const float*)mean,
        (const float*)rstd, (const float*)w, (float*)dx, (float*)dw_part,
        (float*)db_part, rows, hidden, rms);
  } else if (dtype == kBF16) {
    ln_bwd_kernel<__nv_bfloat16><<<grid, kLnBwdThreads, 0, s>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)x, (const float*)mean,
        (const float*)rstd, (const float*)w, (__nv_bfloat16*)dx,
        (float*)dw_part, (float*)db_part, rows, hidden, rms);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
