// Paged flash-decode for Hopper: single-query attention over a paged KV pool.
//
// Replaces: apex_tpu/ops/flash_decode.py _decode_kernel (pallas_call in
// flash_decode). For each slot b and kv head: the H/KH query heads of the
// group attend the first lengths[b] positions of the slot's sequence, whose
// keys live in pages block_tables[b, p // block] at offset p % block. The
// online softmax runs in fp32; a slot with length 0 outputs exactly 0.
//
// Bound on this card: bytes. Each live K/V element is read once and used for
// 2 * G multiply-adds. Design: one CTA (128 threads) per (kv head, slot),
// which reads its page ids from the block table itself and walks only the
// ceil(length / block) live pages -- the TPU grid has to visit all
// max_blocks pages and mask the dead ones. A tile of up to 64 keys (several
// pages) is staged in shared memory as fp32 per step; one page of one kv
// head is block * head_dim contiguous elements, so the loads are 16 bytes a
// thread where the shapes allow. Each warp computes whole scores (lanes split
// head_dim, one shuffle reduction), each warp owns whole query heads for the
// row max/sum, and the PV update splits the tile's keys over all threads
// before a shared-memory sum. Splitting one slot's pages over several CTAs
// with a combine pass is later work.

#include "common.cuh"

namespace apex_torch {

constexpr int kDecThreads = 128;
constexpr int kDecTileKeys = 64;

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw, float* out) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& raw,
                                                        float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int h, int kh, int blk, int d, int max_blocks,
                        int pages_per_tile, float scale) {
  extern __shared__ float sm[];
  const int g = h / kh;
  const int gd = g * d;
  const int tk = pages_per_tile * blk;  // keys per tile
  const int dp = d + 1;
  float* Qs = sm;             // g x d
  float* Ks = Qs + gd;        // tk x dp
  float* Vs = Ks + tk * dp;   // tk x d
  float* Ss = Vs + tk * d;    // g x tk
  float* acc = Ss + g * tk;   // g x d
  float* part = acc + gd;     // kDecThreads partial PV sums
  float* mrow = part + kDecThreads;  // g
  float* lrow = mrow + g;     // g
  float* arow = lrow + g;     // g (this tile's rescale factor)

  const int khi = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kDecThreads / 32;
  const int nsplit = gd >= kDecThreads ? 1 : kDecThreads / gd;

  int len = lengths[bi];
  len = max(0, min(len, max_blocks * blk));
  const int* trow = tables + (size_t)bi * max_blocks;
  const T* qb = q + ((size_t)bi * h + (size_t)khi * g) * d;

  for (int e = tid; e < gd; e += kDecThreads) {
    Qs[e] = to_f32(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int e = tid; e < g; e += kDecThreads) {
    mrow[e] = kNegInf;
    lrow[e] = 0.f;
  }

  const int npages = (len + blk - 1) / blk;
  const size_t page_elems = (size_t)blk * d;
  for (int p0 = 0; p0 < npages; p0 += pages_per_tile) {
    const int key0 = p0 * blk;
    __syncthreads();  // previous tile's readers are done (and init visible)
    if (VEC) {
      constexpr int E = 16 / sizeof(T);
      const int per_page = blk * d / E;
      for (int e = tid; e < pages_per_tile * per_page; e += kDecThreads) {
        const int pp = e / per_page, w = (e - pp * per_page) * E;
        const int t = pp * blk + w / d, c = w % d;
        float kv[E], vv[E];
        if (p0 + pp < npages) {
          const size_t base =
              ((size_t)trow[p0 + pp] * kh + khi) * page_elems + w;
          unpack16<T>(*reinterpret_cast<const uint4*>(kp + base), kv);
          unpack16<T>(*reinterpret_cast<const uint4*>(vp + base), vv);
        } else {
#pragma unroll
          for (int i = 0; i < E; ++i) kv[i] = vv[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < E; ++i) {
          Ks[t * dp + c + i] = kv[i];
          Vs[t * d + c + i] = vv[i];
        }
      }
    } else {
      for (int e = tid; e < tk * d; e += kDecThreads) {
        const int t = e / d, c = e - t * d;
        const int pg = p0 + t / blk;
        float kv = 0.f, vv = 0.f;
        if (pg < npages) {
          const size_t off = ((size_t)trow[pg] * kh + khi) * page_elems +
                             (size_t)(t % blk) * d + c;
          kv = to_f32(kp[off]);
          vv = to_f32(vp[off]);
        }
        Ks[t * dp + c] = kv;
        Vs[t * d + c] = vv;
      }
    }
    __syncthreads();
    // scores: one warp per (query head, key), lanes split head_dim
    for (int e = warp; e < g * tk; e += nwarps) {
      const int gi = e / tk, t = e - gi * tk;
      float s = 0.f;
      for (int c = lane; c < d; c += 32)
        s = fmaf(Qs[gi * d + c], Ks[t * dp + c], s);
      s = warp_sum(s);
      if (lane == 0) Ss[e] = key0 + t < len ? s : kNegInf;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < tk; t += 32) mx = fmaxf(mx, Ss[gi * tk + t]);
      mx = warp_max(mx);
      const float m_prev = mrow[gi];
      const float m_new = fmaxf(m_prev, mx);
      // fully masked so far: keep p at 0 so l stays 0 (output exactly 0)
      const bool dead = m_new <= kNegInf * 0.5f;
      float ps = 0.f;
      for (int t = lane; t < tk; t += 32) {
        const float p = dead ? 0.f : expf(Ss[gi * tk + t] - m_new);
        Ss[gi * tk + t] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        lrow[gi] = lrow[gi] * alpha + ps;
        mrow[gi] = m_new;
        arow[gi] = alpha;
      }
    }
    __syncthreads();
    if (nsplit == 1) {
      for (int e = tid; e < gd; e += kDecThreads) {
        const int gi = e / d, c = e - gi * d;
        float a = acc[e] * arow[gi];
        const float* prow = Ss + gi * tk;
        for (int t = 0; t < tk; ++t) a = fmaf(prow[t], Vs[t * d + c], a);
        acc[e] = a;
      }
    } else {
      // the tile's keys split nsplit ways over the otherwise idle threads
      if (tid < nsplit * gd) {
        const int e = tid % gd, sp = tid / gd;
        const int gi = e / d, c = e - gi * d;
        const float* prow = Ss + gi * tk;
        float a = 0.f;
        for (int t = sp; t < tk; t += nsplit)
          a = fmaf(prow[t], Vs[t * d + c], a);
        part[tid] = a;
      }
      __syncthreads();
      for (int e = tid; e < gd; e += kDecThreads) {
        float a = acc[e] * arow[e / d];
        for (int sp = 0; sp < nsplit; ++sp) a += part[sp * gd + e];
        acc[e] = a;
      }
    }
  }
  __syncthreads();
  T* ob = o + ((size_t)bi * h + (size_t)khi * g) * d;
  for (int e = tid; e < gd; e += kDecThreads) {
    const float l = lrow[e / d];
    ob[e] = from_f32<T>(acc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, bool VEC>
int launch_decode_kernel(const void* q, const void* kp, const void* vp,
                         const void* tables, const void* lengths, void* o,
                         int b, int h, int kh, int blk, int d, int max_blocks,
                         float scale, cudaStream_t stream) {
  const int g = h / kh;
  const int ppt = blk >= kDecTileKeys ? 1 : kDecTileKeys / blk;
  const int tk = ppt * blk;
  const size_t smem =
      sizeof(float) * ((size_t)g * d + (size_t)tk * (d + 1) + (size_t)tk * d +
                       (size_t)g * tk + (size_t)g * d + kDecThreads +
                       3 * (size_t)g);
  const int err = set_max_smem<flash_decode_kernel<T, VEC>>(smem);
  if (err) return err;
  const dim3 grid(kh, b);
  flash_decode_kernel<T, VEC><<<grid, kDecThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)tables,
      (const int*)lengths, (T*)o, h, kh, blk, d, max_blocks, ppt, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flash_decode(const void* q, const void* kp, const void* vp,
                        const void* tables, const void* lengths, void* o,
                        int b, int h, int kh, int blk, int d, int max_blocks,
                        float scale, cudaStream_t stream) {
  // 16-byte page loads: whole 16-byte chunks per row, aligned pools
  constexpr int E = 16 / sizeof(T);
  const bool vec = d % E == 0 && ((uintptr_t)kp & 15) == 0 &&
                   ((uintptr_t)vp & 15) == 0;
  if (vec)
    return launch_decode_kernel<T, true>(q, kp, vp, tables, lengths, o, b, h,
                                         kh, blk, d, max_blocks, scale,
                                         stream);
  return launch_decode_kernel<T, false>(q, kp, vp, tables, lengths, o, b, h,
                                        kh, blk, d, max_blocks, scale, stream);
}

}  // namespace apex_torch

using namespace apex_torch;

// q: contiguous (b, h, d); pages: contiguous (num_blocks, kh, blk, d);
// tables: int32 (b, max_blocks); lengths: int32 (b,); o: (b, h, d) in q's
// dtype. h % kh == 0.
extern "C" int apex_flash_decode(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* lengths,
                                 void* o, int b, int h, int kh, int blk, int d,
                                 int max_blocks, float scale, int dtype,
                                 void* stream) {
  if (b < 1 || kh < 1 || h % kh || blk < 1 || d < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_flash_decode<float>(q, kp, vp, tables, lengths, o, b, h, kh,
                                      blk, d, max_blocks, scale, s);
  if (dtype == kBF16)
    return launch_flash_decode<__nv_bfloat16>(q, kp, vp, tables, lengths, o, b,
                                              h, kh, blk, d, max_blocks, scale,
                                              s);
  return (int)cudaErrorInvalidValue;
}
