// LayerNorm / RMSNorm forward for Hopper.
//
// Replaces: apex_tpu/ops/layer_norm.py _ln_fwd_kernel (pallas_call in
// _fwd_pallas). Per row: fp32 mean and variance (two passes, as the
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
