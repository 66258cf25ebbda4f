// Paged flash-decode for Hopper: attention over a paged KV pool.
//
// Two entry points, each with the optional sliding window (keys
// [length - window, length) of each query) and an fp32 online softmax; a
// query with no visible key outputs exactly 0.
//
// apex_flash_decode replaces apex_tpu/ops/flash_decode.py _decode_kernel
// (def :141, pallas_call in flash_decode :271): ONE query per slot. For each
// slot b and kv head, the H/KH query heads of the group attend the first
// lengths[b] positions of the slot's sequence, whose keys live in pages
// block_tables[b, p // block] at offset p % block. apex_flash_decode_multi
// replaces _decode_multi_kernel (def :281, pallas_call in flash_decode_multi
// :412): K TRAILING queries per slot. The rows of one (slot, kv head) are
// (query head of the group, query) with the query index minor, as in the
// reference; row r's query j = r % K sees the keys below
// lengths[b] - (K - 1 - j). Chunked prefill runs it with one slot and K =
// the chunk (256 rows per kv head), speculative verify with every slot and
// K = drafts + 1 (5 rows); the single-query decode is K = 1. Keys are masked
// by POSITION against each row's own range, never by "page is allocated":
// rejected speculative positions leave stale k/v past the committed length.
//
// Bound on this card: bytes in bf16. A bf16 key's K and V rows (4 d bytes)
// feed 4 d operations per query row, so compute binds only past about 295
// rows per kv head; the decode (1 row per kv head in GPT-2), the verify (5)
// and the chunk (256) all sit below. What holds a kernel back is how many
// bytes are in flight on how many SMs, and the longest slot. In fp32 (8 d
// bytes a key, FMA at 67 TFLOP/s) the line sits near 16 rows: the decode
// and the verify are bound by bytes, the chunk by operations.
//
// bf16 "split" route (flash_decode_split / decode_multi_split, one
// template decode_split<NCH>; d % 8 == 0, d <= 128, block % 8 == 0,
// 16-byte-aligned q, o and pools):
// - Split. The rows of a (slot, kv head) go in tiles of 16 (one m16 tile:
//   the decode's g rows, the verify's 5 g, the chunk's 256 in 16 tiles).
//   Each tile's visible keys -- from the window's first page to its rows'
//   largest length, in whole pages -- are cut into `splits` nearly equal
//   runs of pages, one CTA each (split s takes pages
//   [p0 + s n / S, p0 + (s + 1) n / S)). The split count comes from static
//   shapes only (ops/flash_decode.py decode_splits: about 32 pages a split,
//   at most two CTAs an SM, never more than the pages), and each CTA derives
//   its range on the device from lengths[b]: a long slot spreads over S
//   CTAs instead of setting the time alone, and nothing is read back to
//   the host, so the call can be captured in a CUDA graph.
// - Ring. One producer warp reads the page ids from the block table and
//   keeps up to kDecRing stages of 64 keys in flight: each stage is 64 /
//   box_rows TMA boxes of K and as many of V from a 2-D tensor map over the
//   pool's (num_blocks * kh * block, d) rows (a page of one kv head is
//   block * d contiguous elements), 128-byte swizzle, completing on
//   mbarriers. The pages stay bf16 in shared memory (no fp32 staging).
// - Math. Four consumer warps each take 16 keys of every stage for the 16
//   rows: S = Q K^T and O += P V with mma.sync m16n8k16 (fp32 sums), K and V
//   read with ldmatrix (V with .trans from the row-major page: no
//   transposed copy), P kept in registers. The warps merge their (m, l,
//   acc) in warp order through shared memory. P is rounded to bf16 as the
//   A operand of P V, which the reference kernel keeps fp32 (the bf16
//   tolerance covers it, as for the flash forward).
// - Combine. A tile whose keys fit one split writes o directly. Otherwise
//   each live split writes its fp32 (m, l, acc) rows to a workspace and adds
//   one to the tile's counter; the CTA that brings it to the live count
//   merges the partials in split order (so two calls give the same bits,
//   and no atomic touches o) and resets the counter to 0 for the next call.
//   A split with no page returns at once; a tile that sees no key writes 0.
//
// fp32 "f32_split" route (flash_decode_f32 / decode_multi_f32, one body
// decode_f32_rows<DP, NR>; d <= 128, any block size, any alignment):
// - Split. As the bf16 route: the rows of a (slot, kv head) in tiles of
//   16, each tile's visible pages cut into `splits` runs from static shapes
//   (ops/flash_decode.py decode_splits with the fp32 constants), each
//   CTA's range derived on the device.
// - Ring. The threads of the CTA copy the K and V rows of a stage (64 keys)
//   row by row through the block table into fp32 tiles at pitch DP + 4,
//   completing on the stage's mbarrier: one bulk copy (cp.async.bulk, no
//   tensor map) a row where d % 4 == 0 and q and the pools lie on 16 bytes,
//   4-byte cp.async copies else (16-byte cp.async copies a thread measured
//   slower). Stage t + S - 1 lands while stage t computes (S = 3 stages at
//   DP = 64, 2 at 128). Positions outside the keys some row of the tile
//   sees are not loaded; columns past d stay zero. Each row masks its own
//   range, so a position outside it meets only a zero probability, and
//   every value in the ring is a key of the pool or zero (the ring is
//   zeroed first).
// - Rows. An instance keeps NR of a tile's 16 rows (1, 4, 8 or 16: the
//   live rows, rounded up), so a GPT-2 decode computes its one row and not
//   16. Four warps each take 16 keys of every stage: lane (key, half) sums
//   its half of the columns for every row with Q read as a broadcast, the
//   halves added by one shuffle; the online softmax (expf, natural units,
//   as the plain version) keeps each row's max over the warp's keys; P goes
//   through the warp's own shared tile and each lane accumulates its DP / 32
//   columns of P V, fp32 throughout. The warps merge their (m, l, acc) in
//   warp order at the end. The chunk's 256 rows a kv head take 16 tiles
//   too: 64-row tiles on the register-blocked micro-tiles of
//   flash_f32_blocked.cuh (K/V read once per 64 rows, not per 16) were 9%
//   faster over 756 keys but 1.45-1.7x slower over the 128-317 keys of the
//   generate's chunks, and the shapes do not tell the two apart (PERF.md).
// - Combine. As the bf16 route, in fp32: a tile of one live split writes o;
//   else each live split writes its (m, l, acc) rows to the workspace, and
//   the CTA that completes the group's counter merges them in split order
//   (two calls give the same bits; no atomic touches o) and resets it.
//
// "gather" route (bf16 with d % 8 != 0, block % 8 != 0 or unaligned
// pools; fp32 with d > 128 on the single-query entry point): the kernels
// of the first port. flash_decode_kernel: one CTA per (kv head, slot)
// walking its pages with tiles staged as fp32; decode_multi_mma_kernel
// (bf16): one CTA per (64-row tile, kv head, slot), pages gathered into
// shared memory (V transposed), mma.sync.

#include <climits>
#include <mutex>

#include "common.cuh"
#include "flash_f32_blocked.cuh"
#include "hopper.cuh"

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

// The keys rows [r0, r1) can see: [lo, hi) over the rows that see any key
// (hi == 0 when none does).
__device__ __forceinline__ RowRange tile_range(int len, int r0, int r1, int kq,
                                               int window, int s_max) {
  RowRange t{INT_MAX, 0};
  for (int r = r0; r < r1; ++r) {
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
  const RowRange tr = tile_range(len, r0, min(r0 + kTile, R), kq, window,
                                    s_max);
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

// ---------------------------------------------------------------------------
// bf16 "split" route: split keys, a TMA ring of pages, a fixed-order combine
// ---------------------------------------------------------------------------

constexpr int kDecKeys = 64;      // keys of a ring stage
constexpr int kDecRing = 4;       // stages in flight at most
constexpr int kDecWarps = 4;      // consumer warps; then the producer's
constexpr int kDecRows = 16;      // rows a CTA: one m16 tile
constexpr int kDecSplitThreads = (kDecWarps + 1) * 32;
constexpr int kDecWarpKeys = kDecKeys / kDecWarps;  // a warp's keys a stage
constexpr int kDecRowBytes = 128;  // a swizzled row: 64 bf16 columns
constexpr int kDecChunk = kDecKeys * kDecRowBytes;  // 64 keys x 64 columns
constexpr int kDecMaxSplits = 256;  // splits a group at most
constexpr int kMapCache = 128;      // page-pool tensor maps kept

struct DecodeMaps {
  CUtensorMap k, v;  // pages_map: boxes of {64 columns, box_rows rows}
};

struct DecodeArgs {
  const __nv_bfloat16* q;  // (b, h, kq, d) contiguous
  const int* tables;       // (b, max_blocks)
  const int* lengths;      // (b,)
  __nv_bfloat16* o;        // as q
  float* acc;              // (groups, splits, kDecRows, DP) partial sums
  float2* ml;              // (groups, splits, kDecRows): max and sum, base 2
  int* counters;           // (groups,): live splits done; the last resets it
  int h, kh, kq, blk, d, max_blocks, window;
  int rows;       // g * kq rows a (slot, kv head)
  int row_tiles;  // ceil(rows / kDecRows)
  int splits, ring, box_rows;
  float c;  // scale * log2(e): scores in base 2
};

// Shared memory: the ring (`ring` stages of K then V, each NCH chunks of 64
// keys x 128 bytes), then its mbarriers and one flag. Once the keys are
// done, the key warps hand their partials over through the ring's first
// stage (kMerge bytes).
template <int NCH>
struct DecodeShape {
  static constexpr int kDP = 64 * NCH;  // padded head_dim
  static constexpr int kHalf = NCH * kDecChunk;
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kLane = kDP / 2 + 4;  // o, then m and l per row half
  static constexpr int kMerge = (kDecWarps - 1) * 32 * kLane * 4;
  static_assert(kMerge <= kStage && kDecWarps * kDecMaxSplits * 4 <= kStage,
                "the hand-over and the merge's weights fit one stage");
  static size_t bytes(int ring) {
    return 1024 + (size_t)ring * kStage + 2 * kDecRing * 8 + 16;
  }
};

__device__ __forceinline__ unsigned char* dec_align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// First page of split `s` of `splits` over the n pages from p0 (the next
// split's first page ends it): nearly equal runs, none empty while
// splits <= n.
__device__ __forceinline__ int split_page(int p0, int n, int s, int splits) {
  return p0 + (int)((long long)s * n / splits);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x,
                                             float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// One CTA: split blockIdx.x % splits of the 16-row tile blockIdx.x / splits
// of kv head blockIdx.y of slot blockIdx.z. Warps 0-3 each take 16 keys of
// every stage for all 16 rows; warp 4 is the producer.
template <int NCH>
__device__ __forceinline__ void decode_split(const DecodeMaps& maps,
                                             const DecodeArgs& a) {
  using Sh = DecodeShape<NCH>;
  constexpr int DP = Sh::kDP, DT = DP / 8, KS = DP / 16;
  constexpr int NT = kDecWarpKeys / 8;  // n8 tiles of a warp's scores
  constexpr int kConsumers = kDecWarps * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = dec_align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + a.ring * Sh::kStage);
  uint64_t* empty = full + kDecRing;
  int* last = reinterpret_cast<int*>(empty + kDecRing);

  const int tile = blockIdx.x / a.splits;
  const int split = blockIdx.x - tile * a.splits;
  const int khi = blockIdx.y, bi = blockIdx.z;
  const int r0 = tile * kDecRows, r1 = min(r0 + kDecRows, a.rows);
  const int s_max = a.max_blocks * a.blk;
  const int len = a.lengths[bi];
  const size_t head0 =
      ((size_t)bi * a.h + (size_t)khi * (a.h / a.kh)) * a.kq;
  // the pages some row of the tile sees, and this split's run of them
  const RowRange tr = tile_range(len, r0, r1, a.kq, a.window, s_max);
  const int p0 = tr.lo / a.blk;
  const int npg = tr.hi > tr.lo ? (tr.hi + a.blk - 1) / a.blk - p0 : 0;
  const int live = min(npg, a.splits);
  if (live == 0) {  // no row of the tile sees a key: exactly 0
    if (split == 0) {
      uint32_t* out =
          reinterpret_cast<uint32_t*>(a.o + (head0 + r0) * (size_t)a.d);
      for (int e = threadIdx.x; e < (r1 - r0) * a.d / 2; e += blockDim.x)
        out[e] = 0u;
    }
    return;
  }
  const int pa = split_page(p0, npg, split, a.splits);
  const int pb = split_page(p0, npg, split + 1, a.splits);
  if (pa == pb) return;  // a split with no page: not counted
  const int ka = pa * a.blk, kb = pb * a.blk;
  const int nst = (kb - ka + kDecKeys - 1) / kDecKeys;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ring; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kDecWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kDecWarps) {  // the producer: lane i loads box i of a stage
    const int nbox = kDecKeys / a.box_rows;
    const int* trow = a.tables + (size_t)bi * a.max_blocks;
    for (int t = 0; t < nst; ++t) {
      const int s = t % a.ring;
      int row = 0;
      if (lane < nbox) {
        int pos = ka + t * kDecKeys + lane * a.box_rows;
        if (pos >= kb) pos = kb - a.box_rows;  // past the split: masked
        row = (trow[pos / a.blk] * a.kh + khi) * a.blk + pos % a.blk;
      }
      if (lane == 0) {
        hopper::mbar_wait(&empty[s], ((t / a.ring) & 1) ^ 1);
        hopper::mbar_arrive_tx(&full[s], Sh::kStage);
      }
      __syncwarp();
      if (lane < nbox) {
        unsigned char* dst =
            base + s * Sh::kStage + lane * a.box_rows * kDecRowBytes;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          hopper::tma_load_2d(dst + c * kDecChunk, &maps.k, &full[s], 64 * c,
                              row);
          hopper::tma_load_2d(dst + Sh::kHalf + c * kDecChunk, &maps.v,
                              &full[s], 64 * c, row);
        }
      }
    }
    return;
  }

  const int gq = lane >> 2, tig = lane & 3;
  const int rA = r0 + gq, rB = rA + 8;
  // Q as A fragments, zero past the rows and d
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? rB : rA;
      const int col = ks * 16 + 2 * tig + (i >> 1) * 8;
      qa[ks][i] = row < a.rows && col < a.d
                      ? *reinterpret_cast<const uint32_t*>(
                            a.q + (head0 + row) * a.d + col)
                      : 0u;
    }
  // each row's visible keys inside this split
  RowRange rr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? rB : rA;
    rr[hf] = row_range(len, row, a.kq, a.window, s_max);
    rr[hf].lo = max(rr[hf].lo, ka);
    rr[hf].hi = row < a.rows ? min(rr[hf].hi, kb) : 0;
  }

  const float ninf = __int_as_float(0xff800000);
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {ninf, ninf}, l[2] = {0.f, 0.f};
  const uint32_t ring = hopper::smem_u32(base);
  const int kw = warp * kDecWarpKeys;  // this warp's first key of a stage
  for (int t = 0; t < nst; ++t) {
    const int s = t % a.ring;
    const uint32_t kst = ring + s * Sh::kStage, vst = kst + Sh::kHalf;
    const int key0 = ka + t * kDecKeys + kw;  // position of key kw
    hopper::mbar_wait(&full[s], (t / a.ring) & 1);

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < KS / 2; ++k2)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int key = kw + nt * 8 + (lane & 7);
        const int c = k2 * 4 + (lane >> 3);  // 16-byte chunk of the row
        uint32_t b[4];
        hopper::ldsm_x4(b, kst + (c >> 3) * kDecChunk + key * kDecRowBytes +
                               (((c & 7) ^ (key & 7)) << 4));
        mma_bf16(sc[nt], qa[2 * k2][0], qa[2 * k2][1], qa[2 * k2][2],
                 qa[2 * k2][3], b[0], b[1]);
        mma_bf16(sc[nt], qa[2 * k2 + 1][0], qa[2 * k2 + 1][1],
                 qa[2 * k2 + 1][2], qa[2 * k2 + 1][3], b[2], b[3]);
      }

    // online softmax in base 2; a row with nothing visible yet keeps
    // m = -inf and subtracts 0, so its p and alpha are 0, not NaN
    float mx[2] = {ninf, ninf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hf = i >> 1;
        const int pos = key0 + nt * 8 + 2 * tig + (i & 1);
        sc[nt][i] = pos >= rr[hf].lo && pos < rr[hf].hi ? sc[nt][i] * a.c
                                                        : ninf;
        mx[hf] = fmaxf(mx[hf], sc[nt][i]);
      }
    float sub[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      sub[hf] = m_new == ninf ? 0.f : m_new;
      alpha[hf] = hopper::fast_exp2(m[hf] - sub[hf]);
      m[hf] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = hopper::fast_exp2(sc[nt][i] - sub[i >> 1]);
        sum[i >> 1] += sc[nt][i];
      }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V over the warp's 16 keys: P from the score registers, V by
    // ldmatrix.trans from the row-major page
    const uint32_t a0 = pack_bf16(sc[0][0], sc[0][1]);
    const uint32_t a1 = pack_bf16(sc[0][2], sc[0][3]);
    const uint32_t a2 = pack_bf16(sc[1][0], sc[1][1]);
    const uint32_t a3 = pack_bf16(sc[1][2], sc[1][3]);
#pragma unroll
    for (int d2 = 0; d2 < DT / 2; ++d2) {
      const int key = kw + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = d2 * 2 + (lane >> 4);
      uint32_t b[4];
      hopper::ldsm_x4_t(b, vst + (c >> 3) * kDecChunk + key * kDecRowBytes +
                               (((c & 7) ^ (key & 7)) << 4));
      mma_bf16(o[2 * d2], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(o[2 * d2 + 1], a0, a1, a2, a3, b[2], b[3]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }

  // warps 1-3 hand their partials to warp 0 through the ring once every
  // warp is done with it; warp 0 merges them in warp order
  hopper::named_sync(1, kConsumers);
  float* hand = reinterpret_cast<float*>(base) + lane;
  if (warp > 0) {
    float* dst = hand + (warp - 1) * 32 * Sh::kLane;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(dt * 4 + j) * 32] = o[dt][j];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dst[(DP / 2 + hf) * 32] = m[hf];
      dst[(DP / 2 + 2 + hf) * 32] = l[hf];
    }
  }
  hopper::named_sync(1, kConsumers);
  if (warp == 0) {
#pragma unroll
    for (int k = 1; k < kDecWarps; ++k) {
      const float* src = hand + (k - 1) * 32 * Sh::kLane;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m2 = src[(DP / 2 + hf) * 32];
        const float l2 = src[(DP / 2 + 2 + hf) * 32];
        const float mn = fmaxf(m[hf], m2);
        const float sb = mn == ninf ? 0.f : mn;
        const float w1 = hopper::fast_exp2(m[hf] - sb);
        const float w2 = hopper::fast_exp2(m2 - sb);
        l[hf] = l[hf] * w1 + l2 * w2;
        m[hf] = mn;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            o[dt][2 * hf + j] = o[dt][2 * hf + j] * w1 +
                                src[(dt * 4 + 2 * hf + j) * 32] * w2;
      }
    }
  }

  if (live == 1) {  // the only split with keys: o directly
    if (warp == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = hf ? rB : rA;
        if (row >= a.rows) continue;
        const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
        __nv_bfloat16* orow = a.o + (head0 + row) * a.d;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int col = dt * 8 + 2 * tig;
          if (col < a.d)
            store_bf16x2(orow + col, o[dt][2 * hf] * inv,
                         o[dt][2 * hf + 1] * inv);
        }
      }
    }
    return;
  }

  // this split's fp32 partial rows, then the group's counter
  const size_t gid = ((size_t)bi * a.kh + khi) * a.row_tiles + tile;
  const size_t g0 = gid * a.splits * kDecRows;  // the group's first row
  if (warp == 0) {
    const size_t p_row = g0 + (size_t)split * kDecRows;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rl = gq + 8 * hf;
      if (r0 + rl >= a.rows) continue;
      float* dst = a.acc + (p_row + rl) * DP;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8 + 2 * tig) =
            make_float2(o[dt][2 * hf], o[dt][2 * hf + 1]);
      if (tig == 0) a.ml[p_row + rl] = make_float2(m[hf], l[hf]);
    }
  }
  __threadfence();
  hopper::named_sync(1, kConsumers);
  if (threadIdx.x == 0)
    *last = atomicAdd(a.counters + gid, 1) == live - 1 ? 1 : 0;
  hopper::named_sync(1, kConsumers);
  if (!*last) return;

  // the last split of the group merges every live split's rows in split
  // order (the same bits whichever CTA comes last), a warp a row: its
  // lanes read the splits' (m, l) at once and leave each split's weight in
  // shared memory (the ring's first bytes); then each lane sums two columns
  // over the splits, every split's load in flight at once (a split with no
  // page wrote nothing: its weight is 0 and its load is never used)
  __threadfence();
  float* wts = reinterpret_cast<float*>(base) + warp * kDecMaxSplits;
  for (int rl = warp; rl < r1 - r0; rl += kDecWarps) {
    const float2* mlr = a.ml + g0 + rl;
    float mx = ninf;
    for (int s = lane; s < a.splits; s += 32) {
      const bool on = split_page(p0, npg, s, a.splits) !=
                      split_page(p0, npg, s + 1, a.splits);
      const float2 v = __ldcg(mlr + (size_t)s * kDecRows);
      wts[s] = on && v.y > 0.f ? v.x : ninf;  // -inf: nothing to add
      mx = fmaxf(mx, wts[s]);
    }
    mx = warp_max(mx);
    float sl = 0.f;
    for (int s = lane; s < a.splits; s += 32) {
      const float w = wts[s] == ninf ? 0.f : hopper::fast_exp2(wts[s] - mx);
      if (w > 0.f) sl += __ldcg(mlr + (size_t)s * kDecRows).y * w;
      wts[s] = w;
    }
    sl = warp_sum(sl);  // the same butterfly on every lane and call
    __syncwarp();
    const float inv = sl > 0.f ? 1.f / sl : 0.f;
    const float* accr = a.acc + (g0 + rl) * DP;
#pragma unroll
    for (int c0 = 0; c0 < DP; c0 += 64) {
      const int col = c0 + 2 * lane;
      if (col >= a.d) continue;
      float x = 0.f, y = 0.f;
#pragma unroll 8
      for (int s = 0; s < a.splits; ++s) {
        const float2 u = __ldcg(reinterpret_cast<const float2*>(
            accr + (size_t)s * kDecRows * DP + col));
        const float w = wts[s];
        x += w > 0.f ? u.x * w : 0.f;
        y += w > 0.f ? u.y * w : 0.f;
      }
      store_bf16x2(a.o + (head0 + r0 + rl) * a.d + col, x * inv, y * inv);
    }
    __syncwarp();
  }
  if (threadIdx.x == 0) a.counters[gid] = 0;  // ready for the next call
}

// #9 and #10 on the one template, under their own names for the profiler
template <int NCH>
__global__ void __launch_bounds__(kDecSplitThreads)
    flash_decode_split(const __grid_constant__ DecodeMaps maps,
                       const DecodeArgs a) {
  decode_split<NCH>(maps, a);
}

template <int NCH>
__global__ void __launch_bounds__(kDecSplitThreads)
    decode_multi_split(const __grid_constant__ DecodeMaps maps,
                       const DecodeArgs a) {
  decode_split<NCH>(maps, a);
}

// A page pool (num_blocks, kh, blk, d) bf16 as a 2-D tensor map over its
// rows (num_blocks * kh * blk, d): boxes of {64 columns, box_rows rows}
// with the 128-byte swizzle, zeros past d. The pools are the same from tick
// to tick (one per layer), so maps are kept by (pointer, rows, d, box_rows)
// and encoded once; a map depends on nothing else.
int pages_map(CUtensorMap* out, const void* pool, long long rows, int d,
              int box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    long long rows;
    int d, box;
  };
  static Entry cache[kMapCache];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == pool && e.rows == rows && e.d == d && e.box == box_rows) {
      *out = e.map;
      return 0;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  if ((uintptr_t)pool % 16 || d % 8 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cuuint64_t gdim[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  cuuint64_t gstride[1] = {(cuuint64_t)d * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, estride[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(pool),
      gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cache[next] = Entry{map, pool, rows, d, box_rows};
  next = (next + 1) % kMapCache;
  used = used < kMapCache ? used + 1 : used;
  *out = map;
  return 0;
}

template <int NCH>
int launch_decode_split(const DecodeMaps& maps, const DecodeArgs& a, int b,
                        bool multi, cudaStream_t stream) {
  const size_t smem = DecodeShape<NCH>::bytes(a.ring);
  const dim3 grid(a.row_tiles * a.splits, a.kh, b);
  if (multi) {
    const int err = set_max_smem<decode_multi_split<NCH>>(smem);
    if (err) return err;
    decode_multi_split<NCH><<<grid, kDecSplitThreads, smem, stream>>>(maps,
                                                                      a);
  } else {
    const int err = set_max_smem<flash_decode_split<NCH>>(smem);
    if (err) return err;
    flash_decode_split<NCH><<<grid, kDecSplitThreads, smem, stream>>>(maps,
                                                                      a);
  }
  return (int)cudaGetLastError();
}

// The split route's checks, tensor maps and arguments: `splits` CTAs a
// 16-row tile; ws holds the fp32 partials (groups * splits * 16 * (DP + 2)
// floats, DP = 64 or 128), counters one zeroed int a group (groups = b * kh
// * ceil(h / kh * kq / 16)).
int launch_decode_split_bf16(const void* q, const void* kp, const void* vp,
                             const void* tables, const void* lengths, void* o,
                             void* ws, void* counters, int b, int h, int kh,
                             int kq, int blk, int d, int max_blocks,
                             int num_blocks, float scale, int window,
                             int splits, bool multi, cudaStream_t stream) {
  const long long pool_rows = (long long)num_blocks * kh * blk;
  if (d % 8 || d > 128 || blk % 8 || splits < 1 || splits > kDecMaxSplits ||
      num_blocks < 1 || pool_rows > INT_MAX || !ws || !counters ||
      ((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  int box = kDecKeys;  // gcd(blk, 64) >= 8: no box crosses a page
  while (blk % box) box /= 2;
  DecodeMaps maps;
  int err = pages_map(&maps.k, kp, pool_rows, d, box);
  if (!err) err = pages_map(&maps.v, vp, pool_rows, d, box);
  if (err) return err;
  DecodeArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.h = h;
  a.kh = kh;
  a.kq = kq;
  a.blk = blk;
  a.d = d;
  a.max_blocks = max_blocks;
  a.window = window;
  a.rows = h / kh * kq;
  a.row_tiles = (a.rows + kDecRows - 1) / kDecRows;
  a.splits = splits;
  a.box_rows = box;
  a.c = scale * 1.4426950408889634f;
  if ((long long)a.row_tiles * splits > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int dp = d > 64 ? 128 : 64;
  const size_t groups = (size_t)b * kh * a.row_tiles;
  a.acc = static_cast<float*>(ws);
  a.ml = reinterpret_cast<float2*>(a.acc + groups * splits * kDecRows * dp);
  a.counters = static_cast<int*>(counters);
  // ring depth: the stages of the longest split (a window bounds the pages
  // a tile sees), at most kDecRing
  const int span = window > 0
                       ? min(max_blocks, (window + kq - 2 + blk) / blk + 1)
                       : max_blocks;
  const long long pages = (span + splits - 1) / splits;
  const long long stages = (pages * blk + kDecKeys - 1) / kDecKeys;
  a.ring = (int)(stages < kDecRing ? (stages > 0 ? stages : 1) : kDecRing);
  return d > 64 ? launch_decode_split<2>(maps, a, b, multi, stream)
                : launch_decode_split<1>(maps, a, b, multi, stream);
}

// ---------------------------------------------------------------------------
// fp32 "f32_split" route: split keys, a bulk-copy ring of pages, FMA rows,
// a fixed-order combine
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;      // keys of a stage
constexpr int kF32Warps = 4;      // warps, 16 keys of a stage each
constexpr int kF32WarpKeys = kF32Keys / kF32Warps;
constexpr int kF32Threads = kF32Warps * 32;

struct DecodeF32Args {
  const float* q;   // (b, h, kq, d) contiguous
  const float* kp;  // (num_blocks, kh, blk, d) contiguous
  const float* vp;
  const int* tables;   // (b, max_blocks)
  const int* lengths;  // (b,)
  float* o;            // as q
  float* acc;    // (groups, splits, 16, d): partial sums
  float2* ml;    // (groups, splits, 16): row max and sum
  int* counters;  // (groups,): live splits done; the last resets it
  int h, kh, kq, blk, d, max_blocks, window;
  int rows;       // g * kq rows a (slot, kv head)
  int row_tiles;  // ceil(rows / 16)
  int splits;
  int vec;  // d % 4 == 0, q and the pools on 16 bytes: 16-byte copies
  float scale;
};

// A CTA's place: split blockIdx.x % splits of row tile blockIdx.x / splits
// of kv head blockIdx.y of slot blockIdx.z, the keys some row of its tile
// sees (tr), the tile's pages from p0, its live splits, and this split's
// keys [ka, kb) (ka == kb: a split with no page).
struct F32Place {
  int tile, split, khi, bi, r0, nrows, len, s_max;
  size_t head0;  // the (slot, kv head)'s first row in q and o
  size_t gid;    // the group: (slot, kv head, row tile)
  RowRange tr;
  int p0, npg, live, ka, kb;
};

__device__ __forceinline__ F32Place f32_place(const DecodeF32Args& a) {
  F32Place c;
  c.tile = blockIdx.x / a.splits;
  c.split = blockIdx.x - c.tile * a.splits;
  c.khi = blockIdx.y;
  c.bi = blockIdx.z;
  c.r0 = c.tile * kDecRows;
  c.nrows = min(kDecRows, a.rows - c.r0);
  c.s_max = a.max_blocks * a.blk;
  c.len = a.lengths[c.bi];
  c.head0 = ((size_t)c.bi * a.h + (size_t)c.khi * (a.h / a.kh)) * a.kq;
  c.gid = ((size_t)c.bi * a.kh + c.khi) * a.row_tiles + c.tile;
  c.tr = tile_range(c.len, c.r0, c.r0 + c.nrows, a.kq, a.window, c.s_max);
  c.p0 = c.tr.lo / a.blk;
  c.npg = c.tr.hi > c.tr.lo ? (c.tr.hi + a.blk - 1) / a.blk - c.p0 : 0;
  c.live = min(c.npg, a.splits);
  c.ka = split_page(c.p0, c.npg, c.split, a.splits) * a.blk;
  c.kb = split_page(c.p0, c.npg, c.split + 1, a.splits) * a.blk;
  return c;
}

// A tile no row of which sees a key writes exactly 0 (its split 0); a
// split with no page has nothing to do. True: the CTA returns.
__device__ __forceinline__ bool f32_idle(const DecodeF32Args& a,
                                         const F32Place& c) {
  if (c.live == 0) {
    if (c.split == 0) {
      float* out = a.o + (c.head0 + c.r0) * (size_t)a.d;
      for (int e = threadIdx.x; e < c.nrows * a.d; e += kF32Threads)
        out[e] = 0.f;
    }
    return true;
  }
  return c.ka == c.kb;
}

// `bytes` (a multiple of 16; both addresses on 16 bytes) from global to
// shared memory by the bulk copy engine, completing on bar's transaction
// count: no tensor map, any row pitch.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// The 64 key rows [k0, k0 + 64) of kv head khi, K and V, into tiles of 64
// rows at pitch DP + 4, each row from its page through the block table row
// trow, completing on the stage's mbarrier `bar` (every thread arrives once
// a use). vec (d % 4 == 0, pools on 16 bytes): thread t copies row t % 64
// of K (t < 64) or V by one bulk copy of d floats; a position outside [lo,
// hi) is not copied, so its row keeps an earlier stage's pool values or
// the ring's zeros (columns past d stay 0). Else 4-byte cp.async copies
// with zeros outside [lo, hi) and past d, the thread's arrival made when
// they land.
template <int DP>
__device__ __forceinline__ void load_keys(float* ks, float* vs, uint64_t* bar,
                                          const DecodeF32Args& a,
                                          const int* trow, int khi, int k0,
                                          int lo, int hi) {
  constexpr int kP = DP + 4;
  static_assert(kF32Threads == 2 * kF32Keys, "a row of K or V a thread");
  if (a.vec) {
    const int r = threadIdx.x % kF32Keys, pos = k0 + r;
    const bool in = pos >= lo && pos < hi;
    hopper::mbar_arrive_tx(bar, in ? 4 * a.d : 0);
    if (in) {
      const bool v = threadIdx.x >= kF32Keys;
      bulk_load((v ? vs : ks) + r * kP,
                (v ? a.vp : a.kp) +
                    page_offset(trow, pos, a.kh, khi, a.blk, a.d),
                4 * a.d, bar);
    }
  } else {
    for (int e = threadIdx.x; e < kF32Keys * DP; e += kF32Threads) {
      const int r = e / DP, c = e % DP, pos = k0 + r;
      const bool in = pos >= lo && pos < hi && c < a.d;
      const size_t off =
          in ? page_offset(trow, pos, a.kh, khi, a.blk, a.d) + c : 0;
      hopper::cp_async_4(ks + r * kP + c, a.kp + off, in);
      hopper::cp_async_4(vs + r * kP + c, a.vp + off, in);
    }
    hopper::mbar_arrive_cp_async(bar);
  }
}

// The ring's start: its S stage barriers (an arrival a thread) and its
// floats zeroed (rows a bulk copy skips, columns past d), ordered before
// the bulk copies that write it
template <int S>
__device__ __forceinline__ void ring_init(float* ring, int floats,
                                          uint64_t* full) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], kF32Threads);
    hopper::fence_barrier_init();
  }
  float4* r4 = reinterpret_cast<float4*>(ring);
  for (int e = threadIdx.x; e < floats / 4; e += kF32Threads)
    r4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  hopper::fence_async_shared();
  __syncthreads();
}

// After every thread has written this split's partial rows (acc at pitch d,
// ml) to the workspace: the group's counter. The CTA that brings it to the
// live count merges every live split's rows in split order into o -- per
// row the splits' weights exp(m_s - max m) and 1 / sum l_s w_s first, into
// shared memory at wts (nrows x (splits + 1) floats), then each element's
// sum over the splits in order: the same bits whichever CTA comes last --
// and resets the counter for the next call.
__device__ __forceinline__ void f32_combine(const DecodeF32Args& a,
                                            const F32Place& c, float* wts) {
  __shared__ int last;
  const size_t g0 = c.gid * a.splits * kDecRows;  // the group's row 0
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.counters + c.gid, 1) == c.live - 1 ? 1 : 0;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int ns = a.splits;
  float* inv = wts + c.nrows * ns;
  for (int r = threadIdx.x; r < c.nrows; r += kF32Threads) {
    float mx = kNegInf;
    for (int s = 0; s < ns; ++s) {
      const bool on = split_page(c.p0, c.npg, s, ns) !=
                      split_page(c.p0, c.npg, s + 1, ns);
      const float2 v = on ? __ldcg(a.ml + g0 + (size_t)s * kDecRows + r)
                          : make_float2(kNegInf, 0.f);
      wts[r * ns + s] = v.y > 0.f ? v.x : kNegInf;
      if (v.y > 0.f) mx = fmaxf(mx, v.x);
    }
    float sl = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float m = wts[r * ns + s];
      const float w = m > kNegInf ? expf(m - mx) : 0.f;
      if (w > 0.f)
        sl = fmaf(__ldcg(a.ml + g0 + (size_t)s * kDecRows + r).y, w, sl);
      wts[r * ns + s] = w;
    }
    inv[r] = sl > 0.f ? 1.f / sl : 0.f;
  }
  __syncthreads();
  float* out = a.o + (c.head0 + c.r0) * (size_t)a.d;
  for (int e = threadIdx.x; e < c.nrows * a.d; e += kF32Threads) {
    const int r = e / a.d, col = e - r * a.d;
    float x = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = wts[r * ns + s];
      if (w > 0.f)
        x = fmaf(__ldcg(a.acc + (g0 + (size_t)s * kDecRows + r) * a.d +
                        col),
                 w, x);
    }
    out[e] = x * inv[r];
  }
  if (threadIdx.x == 0) a.counters[c.gid] = 0;  // ready for the next call
}

// The fp32 route's shared memory (floats): the ring (S stages of K then V,
// 64 rows at pitch DP + 4 each), Q (NR rows at DP + 4), each warp's P (NR
// rows of its 16 keys), then the S stage barriers. After the keys the ring
// holds the warps' partial rows, then the combine's weights (16 x (256 + 1)
// at most).
template <int DP, int NR>
struct F32DecodeLayout {
  static constexpr int kP = DP + 4;
  static constexpr int kRing = DP > 64 ? 2 : 3;
  static constexpr int kStage = 2 * kF32Keys * kP;
  static constexpr int kQ = kRing * kStage;
  static constexpr int kPw = kQ + NR * kP;
  static constexpr int kHand = NR * (DP + 2);  // a warp's partial rows
  static constexpr int kBar = kPw + kF32Warps * NR * kF32WarpKeys;
  static constexpr size_t kBytes = sizeof(float) * kBar + 8 * kRing;
  static_assert(kF32Warps * kHand <= kQ &&
                    kDecRows * (kDecMaxSplits + 1) <= kQ,
                "the hand-over and the combine's weights fit the ring");
};

// The fp32 route's body: up to NR of the 16 rows of a tile, four warps
// each taking 16 keys of every stage. Lane (key = lane % 16, half =
// lane / 16) sums, for each row, its key's products over the float4
// chunks 2 j + half of the columns (Q broadcast from shared memory; the
// two halves' chunks on other banks), then adds the other half's sum: one
// fmaf chain a half. s = scale S, kNegInf outside the row's own range; the
// row max over the warp's 16 keys (four shuffles), alpha = exp(m_old - m),
// p = exp(s - m) (0 while the row has seen nothing), the lane's share of
// l; P through the warp's tile, and O += P V with the lane's DP / 32
// columns, one fmaf chain a column over the keys in order.
template <int DP, int NR>
__device__ __forceinline__ void decode_f32_rows(const DecodeF32Args& a) {
  using L = F32DecodeLayout<DP, NR>;
  constexpr int kP = L::kP, S = L::kRing, NT = kF32Threads;
  constexpr int CW = DP / 32;  // P V columns of a lane
  extern __shared__ __align__(16) float dsm[];
  const F32Place c = f32_place(a);
  if (f32_idle(a, c)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = lane & 15, half = lane >> 4;
  float* ring = dsm;
  float* qs = dsm + L::kQ;
  float* pw = dsm + L::kPw + warp * NR * kF32WarpKeys;
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm + L::kBar);
  const int* trow = a.tables + (size_t)c.bi * a.max_blocks;
  // the keys this split loads: its run, cut to what some row sees
  const int lo = max(c.ka, c.tr.lo), hi = min(c.kb, c.tr.hi);
  const int nst = (hi - c.ka + kF32Keys - 1) / kF32Keys;
  auto load_stage = [&](int t) {
    float* to = ring + (t % S) * L::kStage;
    load_keys<DP>(to, to + kF32Keys * kP, &full[t % S], a, trow, c.khi,
                  c.ka + t * kF32Keys, lo, hi);
  };
  ring_init<S>(ring, L::kQ, full);
  ring_rows<DP, NR, NT>(qs, a.q + c.head0 * a.d, a.d, c.r0,
                        min(a.rows, c.r0 + c.nrows), a.d, a.vec);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < S - 1; ++t)
    if (t < nst) load_stage(t);

  // each row's visible keys inside [lo, hi); none past the tile's rows
  int rlo[NR], rhi[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const RowRange rr = row_range(c.len, c.r0 + r, a.kq, a.window, c.s_max);
    rlo[r] = max(rr.lo, lo);
    rhi[r] = r < c.nrows ? min(rr.hi, hi) : 0;
  }
  float m[NR], l[NR], acc[NR][CW];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[r][e] = 0.f;
  }
  cp_async_wait<0>();  // Q (the 4-byte stage copies arrive on their barrier)
  __syncthreads();

  const int kw = warp * kF32WarpKeys;  // the warp's first key of a stage
  for (int t = 0; t < nst; ++t) {
    if (t + S - 1 < nst) load_stage(t + S - 1);
    hopper::mbar_wait(&full[t % S], (t / S) & 1);
    const float* ks = ring + (t % S) * L::kStage;
    const float* vs = ks + kF32Keys * kP;
    const int pos = c.ka + t * kF32Keys + kw + key;

    float s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] = 0.f;
    const float* kr = ks + (kw + key) * kP + 4 * half;
#pragma unroll 4
    for (int j = 0; j < DP / 8; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + 8 * j);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + r * kP + 8 * j + 4 * half);
        float v = fmaf(qv.x, kv.x, s[r]);
        v = fmaf(qv.y, kv.y, v);
        v = fmaf(qv.z, kv.z, v);
        s[r] = fmaf(qv.w, kv.w, v);
      }
    }
    float mx[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 16);
      s[r] = pos >= rlo[r] && pos < rhi[r] ? s[r] * a.scale : kNegInf;
      mx[r] = s[r];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      const float p = m_new <= kNegInf * 0.5f ? 0.f : expf(s[r] - m_new);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[r][e] *= alpha;
      if (half == 0) pw[r * kF32WarpKeys + key] = p;
    }
    __syncwarp();  // the warp's P is written and read by the warp alone
#pragma unroll
    for (int k4 = 0; k4 < kF32WarpKeys; k4 += 4) {
      float pr[NR][4];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pw + r * kF32WarpKeys + k4);
        pr[r][0] = p4.x;
        pr[r][1] = p4.y;
        pr[r][2] = p4.z;
        pr[r][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = vs + (kw + k4 + u) * kP + CW * lane;
        float vv[CW];
        if constexpr (CW == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr);
          vv[0] = v4.x;
          vv[1] = v4.y;
          vv[2] = v4.z;
          vv[3] = v4.w;
        } else {
          const float2 v2 = *reinterpret_cast<const float2*>(vr);
          vv[0] = v2.x;
          vv[1] = v2.y;
        }
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int e = 0; e < CW; ++e)
            acc[r][e] = fmaf(pr[r][u], vv[e], acc[r][e]);
      }
    }
    __syncthreads();  // this stage and the P tiles are free
  }

  // the warps' partial rows through the ring, merged in warp order, a
  // thread an element
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  __syncthreads();
  float* hw = dsm + warp * L::kHand;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int e = 0; e < CW; ++e) hw[r * DP + CW * lane + e] = acc[r][e];
    if (lane == 0) {
      hw[NR * DP + r] = m[r];
      hw[NR * DP + NR + r] = l[r];
    }
  }
  __syncthreads();
  const size_t p_row =
      (c.gid * a.splits + c.split) * (size_t)kDecRows;  // workspace row
  for (int e = threadIdx.x; e < c.nrows * a.d; e += NT) {
    const int r = e / a.d, col = e - r * a.d;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w)
      mw = fmaxf(mw, dsm[w * L::kHand + NR * DP + r]);
    float sl = 0.f, x = 0.f;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      const float* h = dsm + w * L::kHand;
      const float wt = expf(h[NR * DP + r] - mw);
      sl = fmaf(h[NR * DP + NR + r], wt, sl);
      x = fmaf(h[r * DP + col], wt, x);
    }
    if (c.live == 1) {
      a.o[(c.head0 + c.r0) * a.d + e] = sl > 0.f ? x / sl : 0.f;
    } else {
      a.acc[(p_row + r) * a.d + col] = x;
      if (col == 0)
        a.ml[p_row + r] = make_float2(sl > 0.f ? mw : kNegInf, sl);
    }
  }
  if (c.live > 1) f32_combine(a, c, dsm);
}

// #9 and #10 on the one body, under their own names for the profiler
template <int DP, int NR>
__global__ void __launch_bounds__(kF32Threads)
    flash_decode_f32(const DecodeF32Args a) {
  decode_f32_rows<DP, NR>(a);
}

template <int DP, int NR>
__global__ void __launch_bounds__(kF32Threads)
    decode_multi_f32(const DecodeF32Args a) {
  decode_f32_rows<DP, NR>(a);
}

// #9's or #10's instance of NR rows at the padded head_dim DP
template <int DP, int NR>
int launch_f32_rows(const DecodeF32Args& a, int b, bool multi,
                    cudaStream_t stream) {
  constexpr size_t kSmem = F32DecodeLayout<DP, NR>::kBytes;
  const auto kernel = multi ? decode_multi_f32<DP, NR>
                            : flash_decode_f32<DP, NR>;
  const int err = multi ? set_max_smem<decode_multi_f32<DP, NR>>(kSmem)
                        : set_max_smem<flash_decode_f32<DP, NR>>(kSmem);
  if (err) return err;
  const dim3 grid(a.row_tiles * a.splits, a.kh, b);
  kernel<<<grid, kF32Threads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance of a tile's live rows (1, 4, 8, 16) at the padded head_dim
// DP
template <int DP>
int launch_f32_dp(const DecodeF32Args& a, int b, bool multi,
                  cudaStream_t stream) {
  const int nr = min(a.rows, kDecRows);
  if (nr <= 1) return launch_f32_rows<DP, 1>(a, b, multi, stream);
  if (nr <= 4) return launch_f32_rows<DP, 4>(a, b, multi, stream);
  if (nr <= 8) return launch_f32_rows<DP, 8>(a, b, multi, stream);
  return launch_f32_rows<DP, 16>(a, b, multi, stream);
}

// The fp32 split route's checks and arguments: `splits` CTAs a 16-row
// tile; ws holds the partials (groups * splits * 16 * (DP + 2) floats, DP =
// 64 or 128), counters one zeroed int a group (groups = b * kh * ceil(h /
// kh * kq / 16)).
int launch_decode_f32(const void* q, const void* kp, const void* vp,
                      const void* tables, const void* lengths, void* o,
                      void* ws, void* counters, int b, int h, int kh, int kq,
                      int blk, int d, int max_blocks, float scale, int window,
                      int splits, bool multi, cudaStream_t stream) {
  if (d > 128 || splits < 1 || splits > kDecMaxSplits || !ws || !counters)
    return (int)cudaErrorInvalidValue;
  DecodeF32Args a{};
  a.q = static_cast<const float*>(q);
  a.kp = static_cast<const float*>(kp);
  a.vp = static_cast<const float*>(vp);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<float*>(o);
  a.h = h;
  a.kh = kh;
  a.kq = kq;
  a.blk = blk;
  a.d = d;
  a.max_blocks = max_blocks;
  a.window = window;
  a.rows = h / kh * kq;
  a.row_tiles = (a.rows + kDecRows - 1) / kDecRows;
  a.splits = splits;
  a.vec = d % 4 == 0 &&
          ((uintptr_t)q | (uintptr_t)kp | (uintptr_t)vp) % 16 == 0;
  a.scale = scale;
  if ((long long)a.row_tiles * splits > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int dp = d > 64 ? 128 : 64;
  const size_t groups = (size_t)b * kh * a.row_tiles;
  a.acc = static_cast<float*>(ws);
  a.ml = reinterpret_cast<float2*>(a.acc + groups * splits * kDecRows * dp);
  a.counters = static_cast<int*>(counters);
  return d > 64 ? launch_f32_dp<128>(a, b, multi, stream)
                : launch_f32_dp<64>(a, b, multi, stream);
}

}  // namespace apex_torch

using namespace apex_torch;

// q: contiguous (b, h, d); pages: contiguous (num_blocks, kh, blk, d);
// tables: int32 (b, max_blocks); lengths: int32 (b,); o: (b, h, d) in q's
// dtype. h % kh == 0. splits > 0 takes the split route of the dtype: bf16
// (ws and counters as launch_decode_split_bf16 says) or fp32 (d <= 128; as
// launch_decode_f32 says); 0 the gather route (bf16, or fp32 with d > 128).
extern "C" int apex_flash_decode(const void* q, const void* kp, const void* vp,
                                 const void* tables, const void* lengths,
                                 void* o, void* ws, void* counters, int b,
                                 int h, int kh, int blk, int d,
                                 int max_blocks, int num_blocks, float scale,
                                 int window, int splits, int dtype,
                                 void* stream) {
  if (b < 1 || kh < 1 || h % kh || blk < 1 || d < 1 || max_blocks < 1 ||
      window < 0 || splits < 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    if (splits > 0)
      return launch_decode_f32(q, kp, vp, tables, lengths, o, ws, counters, b,
                               h, kh, 1, blk, d, max_blocks, scale, window,
                               splits, false, s);
    if (d <= 128) return (int)cudaErrorInvalidValue;  // the split route's
    return launch_flash_decode<float>(q, kp, vp, tables, lengths, o, b, h, kh,
                                      blk, d, max_blocks, scale, window, s);
  }
  if (splits > 0)
    return launch_decode_split_bf16(q, kp, vp, tables, lengths, o, ws,
                                    counters, b, h, kh, 1, blk, d, max_blocks,
                                    num_blocks, scale, window, splits, false,
                                    s);
  return launch_flash_decode<__nv_bfloat16>(q, kp, vp, tables, lengths, o, b,
                                            h, kh, blk, d, max_blocks, scale,
                                            window, s);
}

// q: contiguous (b, h, kq, d); pages, tables, lengths as above (lengths[b]:
// the keys of the LAST query); o: (b, h, kq, d) in q's dtype. h % kh == 0,
// d <= 128; window 0 = none; splits, ws and counters as above (fp32:
// splits > 0).
extern "C" int apex_flash_decode_multi(const void* q, const void* kp,
                                       const void* vp, const void* tables,
                                       const void* lengths, void* o, void* ws,
                                       void* counters, int b, int h, int kh,
                                       int kq, int blk, int d, int max_blocks,
                                       int num_blocks, float scale,
                                       int window, int splits, int dtype,
                                       void* stream) {
  if (b < 1 || kh < 1 || h % kh || kq < 1 || blk < 1 || d < 1 || d > 128 ||
      max_blocks < 1 || window < 0 || splits < 0 ||
      (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_decode_f32(q, kp, vp, tables, lengths, o, ws, counters, b,
                             h, kh, kq, blk, d, max_blocks, scale, window,
                             splits, true, s);
  if (splits > 0)
    return launch_decode_split_bf16(q, kp, vp, tables, lengths, o, ws,
                                    counters, b, h, kh, kq, blk, d,
                                    max_blocks, num_blocks, scale, window,
                                    splits, true, s);
  // the gather route; 16-byte page and q loads where d % 8 == 0 and the
  // bases are aligned
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
