// Paged flash-decode for Hopper: attention over a paged KV pool.
//
// Three kernels behind two entry points, all with the optional sliding window
// (keys [length - window, length) of each query) and an fp32 online softmax;
// a query with no visible key outputs exactly 0.
//
// apex_flash_decode replaces apex_tpu/ops/flash_decode.py _decode_kernel
// (pallas_call in flash_decode): ONE query per slot. For each slot b and kv
// head, the H/KH query heads of the group attend the first lengths[b]
// positions of the slot's sequence, whose keys live in pages
// block_tables[b, p // block] at offset p % block; a slot with length 0
// outputs exactly 0. Bound on this card: bytes. Each live K/V element is read
// once and used for 2 * G multiply-adds. Design: one CTA (128 threads) per
// (kv head, slot), which reads its page ids from the block table itself and
// walks only the live pages (from the window's first page to
// ceil(length / block)) -- the TPU grid has to visit all max_blocks pages and
// mask the dead ones. A tile of up to 64 keys (several pages) is staged in
// shared memory as fp32 per step; one page of one kv head is
// block * head_dim contiguous elements, so the loads are 16 bytes a thread
// where the shapes allow. Each warp computes whole scores (lanes split
// head_dim, one shuffle reduction), each warp owns whole query heads for the
// row max/sum, and the PV update splits the tile's keys over all threads
// before a shared-memory sum. Splitting one slot's pages over several CTAs
// with a combine pass is later work.
//
// apex_flash_decode_multi replaces _decode_multi_kernel (pallas_call in
// flash_decode_multi): K TRAILING queries per slot. The rows of one
// (slot, kv head) are (query head of the group, query) with the query index
// minor, as in the reference; row r's query j = r % K sees the keys below
// lengths[b] - (K - 1 - j). Chunked prefill runs it with one slot and K = the
// chunk (256 rows per kv head), speculative verify with every slot and
// K = drafts + 1 (5 rows). Bound on this card: bytes at both (a key's K and
// V rows, 4 * d bytes in bf16, feed 4 * d flops per query row, so operations
// bound only past about 295 rows per kv head). The TPU kernel keeps all G*K
// rows' accumulators resident in VMEM and walks every page; here the rows
// are tiled: one CTA of 4 warps per (64-row tile, kv head, slot), each warp
// 16 rows, so any K works and nothing of a row lives in shared memory but
// its Q. Each CTA walks only the keys its tile
// can see: from the smallest first visible position of its rows (the
// window) to the largest visible length (its last row's). Keys are masked by
// POSITION against each row's own range, never by "page is allocated":
// rejected speculative positions leave stale k/v past the committed length.
// - bf16: both products on the tensor cores with mma.sync m16n8k16 (the
//   fragment helpers of common.cuh), 64-key tiles gathered from the pages
//   into shared memory with 16-byte loads (K row-major, V transposed). A
//   tile of fewer than 64 live rows (verify: 5) runs only its live warps'
//   products; the idle warps help stage the pages. P is rounded to bf16 as
//   the A operand of P.V, which the reference kernel does not do (it keeps P
//   fp32); the bf16 tolerance against the plain version covers it (0.02, as
//   for the flash forward).
// - fp32: plain FMA, one CTA of 256 threads per 64-row tile, 4 lanes a row,
//   as the fp32 flash forward.

#include <climits>

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
                        int pages_per_tile, float scale, int window) {
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

  const int raw_len = lengths[bi];
  const int len = max(0, min(raw_len, max_blocks * blk));
  // the window's first visible position (0 without a window)
  const int lo = window > 0 ? max(0, raw_len - window) : 0;
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
  for (int p0 = lo / blk; p0 < npages; p0 += pages_per_tile) {
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
      const int pos = key0 + t;
      if (lane == 0) Ss[e] = pos < len && pos >= lo ? s : kNegInf;
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
                         float scale, int window, cudaStream_t stream) {
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
      (const int*)lengths, (T*)o, h, kh, blk, d, max_blocks, ppt, scale,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flash_decode(const void* q, const void* kp, const void* vp,
                        const void* tables, const void* lengths, void* o,
                        int b, int h, int kh, int blk, int d, int max_blocks,
                        float scale, int window, cudaStream_t stream) {
  // 16-byte page loads: whole 16-byte chunks per row, aligned pools
  constexpr int E = 16 / sizeof(T);
  const bool vec = d % E == 0 && ((uintptr_t)kp & 15) == 0 &&
                   ((uintptr_t)vp & 15) == 0;
  if (vec)
    return launch_decode_kernel<T, true>(q, kp, vp, tables, lengths, o, b, h,
                                         kh, blk, d, max_blocks, scale,
                                         window, stream);
  return launch_decode_kernel<T, false>(q, kp, vp, tables, lengths, o, b, h,
                                        kh, blk, d, max_blocks, scale, window,
                                        stream);
}

// ---------------------------------------------------------------------------
// K trailing queries per slot (apex_flash_decode_multi)
// ---------------------------------------------------------------------------

// Visible key positions [lo, hi) of row r (query j = r % kq): the query's
// own trailing length, cut to the table's s_max positions, and its window.
struct RowRange {
  int lo, hi;
};

__device__ __forceinline__ RowRange row_range(int len, int r, int kq,
                                              int window, int s_max) {
  const int qlen = len - (kq - 1 - r % kq);
  RowRange rr;
  rr.hi = min(qlen, s_max);
  rr.lo = window > 0 ? max(qlen - window, 0) : 0;
  return rr;
}

// The keys a 64-row tile [r0, r0 + 64) of R rows can see: [lo, hi) over the
// rows that see any key (hi == 0 when none does).
__device__ __forceinline__ RowRange tile_range(int len, int r0, int R, int kq,
                                               int window, int s_max) {
  RowRange t{INT_MAX, 0};
  for (int r = r0; r < min(r0 + kTile, R); ++r) {
    const RowRange rr = row_range(len, r, kq, window, s_max);
    if (rr.hi > rr.lo) {
      t.lo = min(t.lo, rr.lo);
      t.hi = max(t.hi, rr.hi);
    }
  }
  if (t.hi == 0) t.lo = 0;
  return t;
}

// Offset of position `pos` of kv head `khi` in a page pool.
__device__ __forceinline__ size_t page_offset(const int* trow, int pos, int kh,
                                              int khi, int blk, int d) {
  return (((size_t)trow[pos / blk] * kh + khi) * blk + pos % blk) * (size_t)d;
}

// The 64 positions [k0, k0 + 64) of one kv head, gathered from the pages:
// K row-major into Ks (row t = position k0 + t), V transposed into Vt.
// Positions at or past `hi` and columns past d are zero (never loaded), so
// no stale shared memory meets a zero probability. VEC: 16-byte loads
// (d % 8 == 0, 16-byte aligned pools). All kMmaThreads threads take part.
template <int DP, bool VEC>
__device__ __forceinline__ void load_page_tile(
    __nv_bfloat16* Ks, __nv_bfloat16* Vt, const __nv_bfloat16* kp,
    const __nv_bfloat16* vp, const int* trow, int kh, int khi, int blk, int d,
    int k0, int hi) {
  constexpr int LD = DP + 8, LDV = kTile + 8;
  if (VEC) {
    constexpr int C8 = DP / 8;
    for (int e = threadIdx.x; e < kTile * C8; e += kMmaThreads) {
      const int t = e / C8, c = (e - t * C8) * 8;
      const int pos = k0 + t;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (pos < hi && c < d) {
        const size_t off = page_offset(trow, pos, kh, khi, blk, d) + c;
        kv = *reinterpret_cast<const uint4*>(kp + off);
        vv = *reinterpret_cast<const uint4*>(vp + off);
      }
      *reinterpret_cast<uint4*>(Ks + t * LD + c) = kv;
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LDV + t] = hv[i];
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < kTile * DP; e += kMmaThreads) {
      const int t = e / DP, c = e - t * DP;
      const int pos = k0 + t;
      __nv_bfloat16 kv = zero, vv = zero;
      if (pos < hi && c < d) {
        const size_t off = page_offset(trow, pos, kh, khi, blk, d) + c;
        kv = kp[off];
        vv = vp[off];
      }
      Ks[t * LD + c] = kv;
      Vt[c * LDV + t] = vv;
    }
  }
}

// bf16: one CTA of 4 warps per (64-row tile, kv head, slot), 16 rows a warp.
// S = Q K^T and O += P V on the tensor cores as in flash_fwd_mma_kernel
// (flash_attention.cu), with per-row position ranges for the mask.
template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
    decode_multi_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ kp,
                            const __nv_bfloat16* __restrict__ vp,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ o, int h, int kh,
                            int kq, int blk, int d, int max_blocks,
                            float scale, int window) {
  constexpr int LD = DP + 8;     // Q and K rows, in halves
  constexpr int LDV = kTile + 8;  // V^T rows
  constexpr int NT = kTile / 8;  // key n-tiles of S per warp
  constexpr int DT = DP / 8;     // dim n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTile * LD;
  __nv_bfloat16* Vt = Ks + kTile * LD;

  const int khi = blockIdx.y, bi = blockIdx.z;
  const int g = h / kh, R = g * kq, r0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the tile
  const int rowA = r0 + wr + gq, rowB = rowA + 8;
  const bool warp_live = r0 + wr < R;
  const int s_max = max_blocks * blk;
  const int len = lengths[bi];
  const int* trow = tables + (size_t)bi * max_blocks;
  const RowRange tr = tile_range(len, r0, R, kq, window, s_max);
  const RowRange ra = row_range(len, rowA, kq, window, s_max);
  const RowRange rb = row_range(len, rowB, kq, window, s_max);
  const bool liveA = rowA < R, liveB = rowB < R;
  // the first row of this (slot, kv head): rows are contiguous in q and o
  const size_t head0 = ((size_t)bi * h + (size_t)khi * g) * kq;
  load_rows<DP, VEC>(Qs, LD, q + (head0 + r0) * d, d, R - r0, d);

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  for (int k0 = (tr.lo / kTile) * kTile; k0 < tr.hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_page_tile<DP, VEC>(Ks, Vt, kp, vp, trow, kh, khi, blk, d, k0, tr.hi);
    __syncthreads();
    if (!warp_live) continue;  // padding rows only: stage, skip the math

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = Qs + (wr + gq) * LD + kk + tig * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kbp = Ks + (nt * 8 + gq) * LD + kk + tig * 2;
        mma_bf16(s[nt], a0, a1, a2, a3, ld32(kbp), ld32(kbp + 8));
      }
    }

    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pos = k0 + nt * 8 + tig * 2 + (i & 1);
        const bool valid = i < 2 ? (liveA && pos >= ra.lo && pos < ra.hi)
                                 : (liveB && pos >= rb.lo && pos < rb.hi);
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
    // fully masked so far: keep p at 0 so l stays 0 (output exactly 0)
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
    for (int kt = 0; kt < kTile / 16; ++kt) {
      const uint32_t a0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vt = Vt + (dt * 8 + gq) * LDV + kt * 16 + tig * 2;
        mma_bf16(oacc[dt], a0, a1, a2, a3, ld32(vt), ld32(vt + 8));
      }
    }
  }

  const float invA = 1.f / (lA == 0.f ? 1.f : lA);
  const float invB = 1.f / (lB == 0.f ? 1.f : lB);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int row = i < 2 ? rowA : rowB;
      if (row < R && col < d)
        o[(head0 + row) * d + col] =
            __float2bfloat16_rn(oacc[dt][i] * (i < 2 ? invA : invB));
    }
  }
}

// fp32: plain FMA, one CTA of 256 threads per (64-row tile, kv head, slot),
// 4 neighbouring lanes per row (row max and sum are two shuffles, the
// accumulator stays in registers), tiles in shared memory as fp32 with rows
// padded by one word against bank conflicts.
constexpr int kMqThreads = 256;
constexpr int kMqMaxD = 128;

__global__ void __launch_bounds__(kMqThreads)
    decode_multi_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ kp,
                            const float* __restrict__ vp,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths,
                            float* __restrict__ o, int h, int kh, int kq,
                            int blk, int d, int max_blocks, float scale,
                            int window) {
  extern __shared__ float smem[];
  constexpr int pp = kTile + 1;
  const int dp = d + 1;
  float* Qs = smem;              // kTile x dp
  float* Ks = Qs + kTile * dp;   // kTile x dp
  float* Vs = Ks + kTile * dp;   // kTile x d
  float* Ps = Vs + kTile * d;    // kTile x pp

  const int khi = blockIdx.y, bi = blockIdx.z;
  const int g = h / kh, R = g * kq, r0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // row within the tile
  const int c4 = tid & 3;  // this lane's column phase
  const int row = r0 + r;
  const int s_max = max_blocks * blk;
  const int len = lengths[bi];
  const int* trow = tables + (size_t)bi * max_blocks;
  const RowRange tr = tile_range(len, r0, R, kq, window, s_max);
  const RowRange rr = row_range(len, row, kq, window, s_max);
  const bool live = row < R;
  const size_t head0 = ((size_t)bi * h + (size_t)khi * g) * kq;

  for (int e = tid; e < kTile * d; e += kMqThreads) {
    const int ri = e / d, ci = e - ri * d;
    Qs[ri * dp + ci] =
        r0 + ri < R ? q[(head0 + r0 + ri) * d + ci] * scale : 0.f;
  }

  float acc[kMqMaxD / 4];
#pragma unroll
  for (int j = 0; j < kMqMaxD / 4; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = (tr.lo / kTile) * kTile; k0 < tr.hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kTile * d; e += kMqThreads) {
      const int t = e / d, c = e - t * d;
      const int pos = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (pos < tr.hi) {
        const size_t off = page_offset(trow, pos, kh, khi, blk, d) + c;
        kv = kp[off];
        vv = vp[off];
      }
      Ks[t * dp + c] = kv;
      Vs[t * d + c] = vv;
    }
    __syncthreads();

    float s[kTile / 4];
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) s[jj] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float qv = Qs[r * dp + kk];
#pragma unroll
      for (int jj = 0; jj < kTile / 4; ++jj)
        s[jj] = fmaf(qv, Ks[(c4 + 4 * jj) * dp + kk], s[jj]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int pos = k0 + c4 + 4 * jj;
      const bool valid = live && pos >= rr.lo && pos < rr.hi;
      s[jj] = valid ? s[jj] : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const bool dead = m_new <= kNegInf * 0.5f;
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) {
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
    for (int jj = 0; jj < kMqMaxD / 4; ++jj) acc[jj] *= alpha;
    for (int c = 0; c < kTile; ++c) {
      const float p = Ps[r * pp + c];
#pragma unroll
      for (int jj = 0; jj < kMqMaxD / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) acc[jj] = fmaf(p, Vs[c * d + col], acc[jj]);
      }
    }
  }

  if (live) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* orow = o + (head0 + row) * d;
#pragma unroll
    for (int jj = 0; jj < kMqMaxD / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) orow[col] = acc[jj] * inv;
    }
  }
}

template <int DP, bool VEC>
int launch_multi_mma(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* lengths, void* o, int b,
                     int h, int kh, int kq, int blk, int d, int max_blocks,
                     float scale, int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)2 * kTile * (DP + 8) + (size_t)DP * (kTile + 8));
  const int err = set_max_smem<decode_multi_mma_kernel<DP, VEC>>(smem);
  if (err) return err;
  const dim3 grid((h / kh * kq + kTile - 1) / kTile, kh, b);
  decode_multi_mma_kernel<DP, VEC><<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, (const int*)tables, (const int*)lengths,
      (__nv_bfloat16*)o, h, kh, kq, blk, d, max_blocks, scale, window);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_multi_mma_dp(bool vec, const void* q, const void* kp,
                        const void* vp, const void* tables,
                        const void* lengths, void* o, int b, int h, int kh,
                        int kq, int blk, int d, int max_blocks, float scale,
                        int window, cudaStream_t stream) {
  if (vec)
    return launch_multi_mma<DP, true>(q, kp, vp, tables, lengths, o, b, h, kh,
                                      kq, blk, d, max_blocks, scale, window,
                                      stream);
  return launch_multi_mma<DP, false>(q, kp, vp, tables, lengths, o, b, h, kh,
                                     kq, blk, d, max_blocks, scale, window,
                                     stream);
}

int launch_multi_f32(const void* q, const void* kp, const void* vp,
                     const void* tables, const void* lengths, void* o, int b,
                     int h, int kh, int kq, int blk, int d, int max_blocks,
                     float scale, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * kTile * (d + 1) + (size_t)kTile * d +
                       (size_t)kTile * (kTile + 1));
  const int err = set_max_smem<decode_multi_f32_kernel>(smem);
  if (err) return err;
  const dim3 grid((h / kh * kq + kTile - 1) / kTile, kh, b);
  decode_multi_f32_kernel<<<grid, kMqThreads, smem, stream>>>(
      (const float*)q, (const float*)kp, (const float*)vp, (const int*)tables,
      (const int*)lengths, (float*)o, h, kh, kq, blk, d, max_blocks, scale,
      window);
  return (int)cudaGetLastError();
}

}  // namespace apex_torch

using namespace apex_torch;

// q: contiguous (b, h, d); pages: contiguous (num_blocks, kh, blk, d);
// tables: int32 (b, max_blocks); lengths: int32 (b,); o: (b, h, d) in q's
// dtype. h % kh == 0.
extern "C" int apex_flash_decode(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* lengths,
                                 void* o, int b, int h, int kh, int blk, int d,
                                 int max_blocks, float scale, int window,
                                 int dtype, void* stream) {
  if (b < 1 || kh < 1 || h % kh || blk < 1 || d < 1 || max_blocks < 1 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_flash_decode<float>(q, kp, vp, tables, lengths, o, b, h, kh,
                                      blk, d, max_blocks, scale, window, s);
  if (dtype == kBF16)
    return launch_flash_decode<__nv_bfloat16>(q, kp, vp, tables, lengths, o, b,
                                              h, kh, blk, d, max_blocks, scale,
                                              window, s);
  return (int)cudaErrorInvalidValue;
}

// q: contiguous (b, h, kq, d); pages, tables, lengths as above (lengths[b]:
// the keys of the LAST query); o: (b, h, kq, d) in q's dtype. h % kh == 0,
// d <= 128; window 0 = none.
extern "C" int apex_flash_decode_multi(const void* q, const void* kp,
                                       const void* vp, const void* tables,
                                       const void* lengths, void* o, int b,
                                       int h, int kh, int kq, int blk, int d,
                                       int max_blocks, float scale,
                                       int window, int dtype, void* stream) {
  if (b < 1 || kh < 1 || h % kh || kq < 1 || blk < 1 || d < 1 ||
      d > kMqMaxD || max_blocks < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_multi_f32(q, kp, vp, tables, lengths, o, b, h, kh, kq, blk,
                            d, max_blocks, scale, window, s);
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  // 16-byte page and q loads: whole 16-byte chunks per row, aligned bases
  const bool vec = d % 8 == 0 && ((uintptr_t)q & 15) == 0 &&
                   ((uintptr_t)kp & 15) == 0 && ((uintptr_t)vp & 15) == 0;
  if (d <= 32)
    return launch_multi_mma_dp<32>(vec, q, kp, vp, tables, lengths, o, b, h,
                                   kh, kq, blk, d, max_blocks, scale, window,
                                   s);
  if (d <= 64)
    return launch_multi_mma_dp<64>(vec, q, kp, vp, tables, lengths, o, b, h,
                                   kh, kq, blk, d, max_blocks, scale, window,
                                   s);
  return launch_multi_mma_dp<128>(vec, q, kp, vp, tables, lengths, o, b, h,
                                  kh, kq, blk, d, max_blocks, scale, window,
                                  s);
}
