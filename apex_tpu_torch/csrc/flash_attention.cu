// Flash-attention forward for Hopper.
//
// Replaces: apex_tpu/ops/flash_attention.py _fwd_kernel (pallas_call in
// _flash_fwd). Computes O = softmax(scale * Q K^T [causal mask]) V and the
// per-row lse = m + log(l) (fp32), with the online-softmax recurrence: a
// running max m, a running sum l and an fp32 accumulator per query row.
// Causal masking is top-left aligned (key k is visible to query q iff
// k <= q, _apply_pos_masks), K/V tiles past the causal diagonal are never
// loaded, and a row whose every key is masked outputs exactly 0 (l == 0).
//
// Bound on this card: operations at long sequence (4 * sq * sk * d / 2
// causal FLOPs against 4 * s * d elements moved), bytes at short. Design
// (simple first; wgmma/TMA are later work), two kernels behind one entry:
// - bf16 (the serving path): both products on the tensor cores with
//   mma.sync (flash_fwd_mma_kernel below), one CTA of 4 warps per
//   (64-row q tile, head, batch);
// - fp32: plain FMA (flash_fwd_kernel), one CTA of 256 threads per q tile,
//   Q, K, V and P tiles in shared memory as fp32 (rows padded by one word
//   against bank conflicts), 4 neighbouring lanes per query row so the row
//   max and sum are two shuffles and the accumulator stays in registers.
// Any sq, sk and d <= 128; ragged edges are masked in-kernel. Inputs are
// (b, h, s, d) with the last dim contiguous and the other strides given, so
// the fused-QKV views need no copy.

#include "common.cuh"

namespace apex_torch {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kFaThreads = 256;  // 4 lanes per query row
constexpr int kMaxD = 128;

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int h, int sq, int sk, int d,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* Qs = smem;            // kBQ x dp
  float* Ks = Qs + kBQ * dp;   // kBK x dp
  float* Vs = Ks + kBK * dp;   // kBK x d
  float* Ps = Vs + kBK * d;    // kBQ x (kBK + 1)
  constexpr int pp = kBK + 1;

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row within the tile
  const int c4 = tid & 3;  // this lane's column phase
  const int qrow = q0 + r;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;

  for (int e = tid; e < kBQ * d; e += kFaThreads) {
    const int rr = e / d, cc = e - rr * d;
    const int qi = q0 + rr;
    Qs[rr * dp + cc] = qi < sq ? to_f32(qb[qi * qs.s + cc]) * scale : 0.f;
  }

  float acc[kMaxD / 4];
#pragma unroll
  for (int j = 0; j < kMaxD / 4; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  int nk = (sk + kBK - 1) / kBK;
  if (causal) {
    // tiles at or left of the diagonal of this q tile's last row
    const int lim = (q0 + kBQ + kBK - 1) / kBK;
    nk = min(nk, lim);
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * d; e += kFaThreads) {
      const int rr = e / d, cc = e - rr * d;
      const int ki = k0 + rr;
      const bool in = ki < sk;
      Ks[rr * dp + cc] = in ? to_f32(kb[ki * ks.s + cc]) : 0.f;
      Vs[rr * d + cc] = in ? to_f32(vb[ki * vs.s + cc]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) s[jj] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float qv = Qs[r * dp + kk];
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj)
        s[jj] = fmaf(qv, Ks[(c4 + 4 * jj) * dp + kk], s[jj]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const int kpos = k0 + c4 + 4 * jj;
      const bool valid = kpos < sk && (!causal || kpos <= qrow);
      s[jj] = valid ? s[jj] : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    // fully masked so far: exp(s - m) would be exp(0); keep p at 0 so l
    // stays 0 and the row outputs 0 (the reference kernel's guard)
    const bool dead = m_new <= kNegInf * 0.5f;
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const float p = dead ? 0.f : expf(s[jj] - m_new);
      Ps[r * pp + c4 + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same 4 lanes

#pragma unroll
    for (int jj = 0; jj < kMaxD / 4; ++jj) acc[jj] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = Ps[r * pp + c];
#pragma unroll
      for (int jj = 0; jj < kMaxD / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) acc[jj] = fmaf(p, Vs[c * d + col], acc[jj]);
      }
    }
  }

  if (qrow < sq) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    const size_t row_off = ((size_t)(bi * h + hi) * sq + qrow);
    T* orow = o + row_off * d;
#pragma unroll
    for (int jj = 0; jj < kMaxD / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) orow[col] = from_f32<T>(acc[jj] * inv);
    }
    if (c4 == 0) lse[row_off] = m + logf(l_safe);
  }
}

template <typename T>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, int b, int h, int sq, int sk, int d,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                       (size_t)kBK * d + (size_t)kBQ * (kBK + 1));
  const int err = set_max_smem<flash_fwd_kernel<T>>(smem);
  if (err) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_kernel<T><<<grid, kFaThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, h, sq, sk,
      d, qs, ks, vs, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (mma.sync m16n8k16, fp32 sums)
// ---------------------------------------------------------------------------
//
// One CTA of 4 warps per (64-row q tile, head, batch); each warp owns 16
// query rows. Q, K and V^T tiles sit in shared memory as bf16 (rows padded
// by 8 halves so the fragment loads hit 32 distinct banks). S = Q K^T lands
// in mma accumulator fragments; the online softmax runs on them in fp32
// (row max/sum over the 4 lanes that share a row); P is rounded to bf16 and
// fed straight back as the A operand of O += P V (the accumulator layout of
// m16n8 equals the A layout of m16n8k16 -- no shared-memory round trip).
// P is rounded to bf16 as the A operand. The reference kernel does not do
// this (_fwd_kernel casts V to fp32, so its p.astype(v.dtype) stays fp32);
// mha_reference does (p.astype(v.dtype) with bf16 V). The rounding is what
// the bf16 tolerance of the kernel against its plain version covers.

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int h, int sq, int sk,
                         int d, Strides qs, Strides ks, Strides vs,
                         float scale, int causal) {
  constexpr int LD = DP + 8;    // Q and K rows, in halves
  constexpr int LDV = kBK + 8;  // V^T rows
  constexpr int NT = kBK / 8;   // key n-tiles of S per warp
  constexpr int DT = DP / 8;    // dim n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vt = Ks + kBK * LD;

  const int qt = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the tile
  const int rowA = q0 + wr + g, rowB = rowA + 8;

  const __nv_bfloat16* qb = q + bi * qs.b + hi * qs.h + (long long)q0 * qs.s;
  const __nv_bfloat16* kb = k + bi * ks.b + hi * ks.h;
  const __nv_bfloat16* vb = v + bi * vs.b + hi * vs.h;
  load_rows<DP, VEC>(Qs, LD, qb, qs.s, sq - q0, d);

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ + kBK - 1) / kBK);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    load_rows<DP, VEC>(Ks, LD, kb + (long long)k0 * ks.s, ks.s, sk - k0, d);
    load_rows_t<DP, VEC>(Vt, LDV, vb + (long long)k0 * vs.s, vs.s, sk - k0,
                         d);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = Qs + (wr + g) * LD + kk + tig * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kbp = Ks + (nt * 8 + g) * LD + kk + tig * 2;
        mma_bf16(s[nt], a0, a1, a2, a3, ld32(kbp), ld32(kbp + 8));
      }
    }

    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + tig * 2 + (i & 1);
        const int row = i < 2 ? rowA : rowB;
        const bool valid = col < sk && (!causal || col <= row);
        s[nt][i] = valid ? s[nt][i] * scale : kNegInf;
      }
      mxA = fmaxf(mxA, fmaxf(s[nt][0], s[nt][1]));
      mxB = fmaxf(mxB, fmaxf(s[nt][2], s[nt][3]));
    }
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    const bool deadA = mnA <= kNegInf * 0.5f, deadB = mnB <= kNegInf * 0.5f;
    const float alA = expf(mA - mnA), alB = expf(mB - mnB);
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = deadA ? 0.f : expf(s[nt][0] - mnA);
      s[nt][1] = deadA ? 0.f : expf(s[nt][1] - mnA);
      s[nt][2] = deadB ? 0.f : expf(s[nt][2] - mnB);
      s[nt][3] = deadB ? 0.f : expf(s[nt][3] - mnB);
      sumA += s[nt][0] + s[nt][1];
      sumB += s[nt][2] + s[nt][3];
    }
    sumA += __shfl_xor_sync(0xffffffffu, sumA, 1);
    sumA += __shfl_xor_sync(0xffffffffu, sumA, 2);
    sumB += __shfl_xor_sync(0xffffffffu, sumB, 1);
    sumB += __shfl_xor_sync(0xffffffffu, sumB, 2);
    lA = lA * alA + sumA;
    lB = lB * alB + sumB;
    mA = mnA;
    mB = mnB;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= alA;
      oacc[dt][1] *= alA;
      oacc[dt][2] *= alB;
      oacc[dt][3] *= alB;
    }
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      const uint32_t a0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vp = Vt + (dt * 8 + g) * LDV + kt * 16 + tig * 2;
        mma_bf16(oacc[dt], a0, a1, a2, a3, ld32(vp), ld32(vp + 8));
      }
    }
  }

  const float invA = 1.f / (lA == 0.f ? 1.f : lA);
  const float invB = 1.f / (lB == 0.f ? 1.f : lB);
  const size_t head = (size_t)(bi * h + hi) * sq;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int row = i < 2 ? rowA : rowB;
      if (row < sq && col < d)
        o[(head + row) * d + col] =
            __float2bfloat16_rn(oacc[dt][i] * (i < 2 ? invA : invB));
    }
  }
  if (tig == 0) {
    if (rowA < sq) lse[head + rowA] = mA + logf(lA == 0.f ? 1.f : lA);
    if (rowB < sq) lse[head + rowB] = mB + logf(lB == 0.f ? 1.f : lB);
  }
}

template <int DP, bool VEC>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o,
                     void* lse, int b, int h, int sq, int sk, int d,
                     Strides qs, Strides ks, Strides vs, float scale,
                     int causal, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(kBQ + kBK) * (DP + 8) + (size_t)DP * (kBK + 8));
  const int err = set_max_smem<flash_fwd_mma_kernel<DP, VEC>>(smem);
  if (err) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_mma_kernel<DP, VEC><<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, h, sq, sk, d,
      qs, ks, vs, scale, causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_flash_mma_dp(bool vec, const void* q, const void* k,
                        const void* v, void* o, void* lse, int b, int h,
                        int sq, int sk, int d, Strides qs, Strides ks,
                        Strides vs, float scale, int causal,
                        cudaStream_t stream) {
  if (vec)
    return launch_flash_mma<DP, true>(q, k, v, o, lse, b, h, sq, sk, d, qs,
                                      ks, vs, scale, causal, stream);
  return launch_flash_mma<DP, false>(q, k, v, o, lse, b, h, sq, sk, d, qs, ks,
                                     vs, scale, causal, stream);
}

}  // namespace apex_torch

using namespace apex_torch;

// q/k/v strides in elements: (batch, head, seq); the head_dim stride is 1.
// o is contiguous (b, h, sq, d) in q's dtype; lse contiguous (b, h, sq) fp32.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int sq, int sk,
                              int d, long long qsb, long long qsh,
                              long long qss, long long ksb, long long ksh,
                              long long kss, long long vsb, long long vsh,
                              long long vss, float scale, int causal,
                              int dtype, void* stream) {
  if (d < 1 || d > kMaxD || b < 1 || h < 1 || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_flash_fwd<float>(q, k, v, o, lse, b, h, sq, sk, d, qs, ks,
                                   vs, scale, causal, s);
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  const bool vec = vec_ok(d, q, qs) && vec_ok(d, k, ks) && vec_ok(d, v, vs);
  if (d <= 32)
    return launch_flash_mma_dp<32>(vec, q, k, v, o, lse, b, h, sq, sk, d, qs,
                                   ks, vs, scale, causal, s);
  if (d <= 64)
    return launch_flash_mma_dp<64>(vec, q, k, v, o, lse, b, h, sq, sk, d, qs,
                                   ks, vs, scale, causal, s);
  return launch_flash_mma_dp<128>(vec, q, k, v, o, lse, b, h, sq, sk, d, qs,
                                  ks, vs, scale, causal, s);
}
