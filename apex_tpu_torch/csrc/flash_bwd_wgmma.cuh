// Device pieces of the bf16 flash-attention backward on wgmma fed by a TMA
// ring, shared by the streamed pair (dq_wgmma / dkv_wgmma,
// flash_attention_stream.cu) and the resident pair (dq_resident_wgmma /
// dkv_resident_wgmma, flash_attention_bwd.cu): the bands of tiles a CTA
// visits, the shared-memory layout of a ring, the TMA row loads, the
// staging and TMA stores of bf16 results, the wgmma descriptors and
// products, P / dS from the score registers, and the consumer loop. The
// forwards (flash_fwd_wgmma.cuh) take the bands, loads, stores,
// descriptors and products too.
//
// Layout of a CTA (kBwdThreads): warpgroups 0 and 1 are the consumers, 64
// rows each of the outer tile they keep (kOuter rows); warp 8 is the
// producer, which starts the TMA loads of the streamed inner tiles into a
// kStages-deep ring and hands its registers to the consumers (setmaxnreg).

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace apex_torch {
namespace {

constexpr int kOuter = 128;   // rows a CTA keeps: queries (dQ), keys (dK/dV)
constexpr int kInner = 64;    // rows of a streamed tile
constexpr int kStages = 3;    // depth of the ring
constexpr int kWg = 128;      // threads of a warpgroup
constexpr int kBwdThreads = 3 * kWg;  // two consumers, then the producer's
constexpr int kRowBytes = 128;        // a swizzled row: 64 bf16
constexpr int kKStep = 16 * kRowBytes;  // 16 rows: one k16 step of MN-major B
constexpr float kLog2e = 1.4426950408889634f;

// floor(a / b) for b > 0
__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return (a >= 0 ? a : a - b + 1) / b;
}

struct Band {
  int lo, hi;  // [lo, hi) of tiles
};

// key tiles (bk rows) that query tile qt (bq rows) sees: the causal limit,
// then the window (_window_k_range). shift: the global position of the
// queries' row 0 minus the keys' (a ring step's q_off - k_off, 0 unsharded);
// the masks take query row r at r + shift. A band may come out empty, with
// hi < lo where the window starts past the last tile: the kernels that take
// a shift clip it (seg_band).
__device__ __forceinline__ Band k_tiles(int qt, int nk, int causal,
                                        int window, int bq = kTile,
                                        int bk = kTile, int shift = 0) {
  Band r{0, nk};
  if (causal)
    r.hi = min(r.hi, max(0, floordiv(shift + (qt + 1) * bq + bk - 1, bk)));
  if (window > 0) {
    r.lo = max(r.lo, floordiv(shift + qt * bq - window + 1, bk));
    if (!causal)
      r.hi = max(0, min(r.hi, floordiv(shift + (qt + 1) * bq + window - 2,
                                       bk) + 1));
  }
  return r;
}

// query tiles (bq rows) that see key tile kt (bk rows) (_window_q_range),
// shift as in k_tiles
__device__ __forceinline__ Band q_tiles(int kt, int nq, int causal,
                                        int window, int bq = kTile,
                                        int bk = kTile, int shift = 0) {
  Band r{0, nq};
  if (causal) r.lo = min(max(0, floordiv(kt * bk - shift, bq)), nq);
  if (window > 0) {
    r.hi = max(0, min(r.hi, floordiv((kt + 1) * bk - shift + window - 2,
                                     bq) + 1));
    if (!causal)
      r.lo = max(r.lo, floordiv(kt * bk - shift - window + 1, bq));
  }
  return r;
}

// The splits of a band of split_tiles tiles at most: ceil(n / split_tiles)
// for its n tiles, 0 for an empty band
__device__ __forceinline__ int n_splits(Band r, int split_tiles) {
  const int n = r.hi - r.lo;
  return n > 0 ? (n + split_tiles - 1) / split_tiles : 0;
}

// Split s of the band: n_splits pieces of equal length (the last may be
// shorter). False when the band has no split s.
__device__ __forceinline__ bool split_of(Band r, int s, int split_tiles,
                                         int& t0, int& t1) {
  const int n = r.hi - r.lo;
  if (n <= 0) return false;
  const int ns = (n + split_tiles - 1) / split_tiles;
  if (s >= ns) return false;
  const int per = (n + ns - 1) / ns;
  t0 = r.lo + s * per;
  t1 = min(r.hi, t0 + per);
  return t0 < t1;
}

// Whether query position row sees key col (a local column, tested against
// sk): the causal and window tests on positions, where a ring step passes
// its query row plus the shift (k_tiles)
__device__ __forceinline__ bool visible(int row, int col, int sk, int causal,
                                        int window) {
  return col < sk && (!causal || col <= row) &&
         (window <= 0 || (row - col < window && (causal || col - row < window)));
}

// The segment ids of a launch (packed varlen attention: the reference's
// segment_ids, pad_id and contiguous_segments, _seg_mask_if_needed and
// _seg_metadata). q / k: the per-token int32 ids, contiguous (b, sq) /
// (b, sk); a query sees a key only where their ids are equal and the id is
// not `pad` (has_pad). q == nullptr: no segment mask. The metadata the
// wrapper computes at this launch's own tiles, (b, 2, n) int32 each:
// `bounds` the [lo, hi) of the inner tiles that outer tile t can share an
// id with (nullptr: mask only, the whole static band is visited), `omm` /
// `imm` each outer / inner tile's (min, max) id. With contiguous ids,
// `ranges` (b, 2, own rows): the [lo, hi) of the other side's rows that
// share each own row's id (empty for the pad id); the equality test is
// then two compares, as the causal one is. Without them (ids in any
// order, mask only) an edge block loads the other side's ids. All read
// from global memory (a few ints an item, L2-resident), never by the
// host: a launch stays capturable in a CUDA graph.
struct SegArgs {
  const int* q;
  const int* k;
  const int* bounds;
  const int* omm;
  const int* imm;
  const int* ranges;
  int n_outer, n_inner;  // tiles of the outer and the inner side
  int pad, has_pad;
};

// A band [lo, hi) narrowed to outer tile t's segment bounds (batch row bi),
// never with hi below lo
__device__ __forceinline__ Band seg_band(const SegArgs& g, Band r, int bi,
                                         int t) {
  if (g.bounds != nullptr) {
    const int* b = g.bounds + (size_t)bi * 2 * g.n_outer;
    r.lo = max(r.lo, __ldg(b + t));
    r.hi = min(r.hi, __ldg(b + g.n_outer + t));
  }
  r.hi = max(r.lo, r.hi);
  return r;
}

// The segment arguments of an entry point: none at all (q null), or the
// ids of both sides with their (min, max) tables, and the bounds and the
// ranges together or neither
inline bool seg_ok(const void* q, const void* k, const void* bounds,
                   const void* omm, const void* imm, const void* ranges) {
  if (q == nullptr)
    return k == nullptr && bounds == nullptr && omm == nullptr &&
           imm == nullptr && ranges == nullptr;
  return k != nullptr && omm != nullptr && imm != nullptr &&
         (bounds == nullptr) == (ranges == nullptr);
}

// SegArgs of a launch whose outer side has outer_len rows in tiles of
// outer_tile, its inner side inner_len in tiles of inner_tile
inline SegArgs make_seg(const void* q, const void* k, const void* bounds,
                        const void* omm, const void* imm, const void* ranges,
                        int pad, int has_pad, int outer_len, int inner_len,
                        int outer_tile, int inner_tile) {
  return SegArgs{static_cast<const int*>(q), static_cast<const int*>(k),
                 static_cast<const int*>(bounds),
                 static_cast<const int*>(omm), static_cast<const int*>(imm),
                 static_cast<const int*>(ranges),
                 (outer_len + outer_tile - 1) / outer_tile,
                 (inner_len + inner_tile - 1) / inner_tile, pad, has_pad};
}

// Whether outer tile t and inner tile i (batch row bi) hold one id between
// them, not the pad: every pair of the block shares its segment, so the
// block needs no segment test (the reference's uniform_ok). True without
// segment ids.
__device__ __forceinline__ bool seg_uniform(const SegArgs& g, int bi, int t,
                                            int i) {
  if (g.q == nullptr) return true;
  const int* o = g.omm + (size_t)bi * 2 * g.n_outer;
  const int* n = g.imm + (size_t)bi * 2 * g.n_inner;
  const int id = __ldg(o + t);
  return id == __ldg(o + g.n_outer + t) && id == __ldg(n + i) &&
         id == __ldg(n + g.n_inner + i) && !(g.has_pad && id == g.pad);
}

// The segment test of a thread's scores: its two own rows (queries; keys
// in the dK/dV pass), row and row + 8, see the other side's rows [lo, hi)
// -- their id's range with contiguous ids, everything without segment ids
// -- and, where the ids are in any order (`ranged` false), only those of
// their own id, loaded from `other`. An own row past its sequence or with
// the pad id sees nothing. The wgmma kernels apply it to an edge block's
// scores as a step of its own (seg_mask), only in the instances that take
// the general masks (kGen), so that the code without them is what it was.
struct SegRows {
  const int* other;  // the batch row's ids of the other side, or nullptr
  int lo[2], hi[2];
  int id[2];
  // own row hf may see row pos of the other side
  __device__ __forceinline__ bool sees(int hf, int pos) const {
    const bool in = pos >= lo[hf] && pos < hi[hf];
    return other == nullptr ? in : in && __ldg(other + pos) == id[hf];
  }
};

// The SegRows of own rows row and row + 8 of batch row bi (queries, or in
// the dK/dV pass keys, where dkv)
__device__ __forceinline__ SegRows seg_rows(const SegArgs& g, bool dkv,
                                            int bi, int row, int sq,
                                            int sk) {
  const int own_n = dkv ? sk : sq, n = dkv ? sq : sk;
  SegRows s{nullptr, {0, 0}, {n, n}, {0, 0}};
  if (g.q == nullptr) return s;
  const int* own = (dkv ? g.k : g.q) + (size_t)bi * own_n;
  const int* rng =
      g.ranges != nullptr ? g.ranges + (size_t)bi * 2 * own_n : nullptr;
  if (rng == nullptr) s.other = (dkv ? g.q : g.k) + (size_t)bi * n;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    if (r >= own_n) {
      s.hi[hf] = 0;
    } else if (rng != nullptr) {
      s.lo[hf] = __ldg(rng + r);
      s.hi[hf] = __ldg(rng + own_n + r);
    } else {
      s.id[hf] = __ldg(own + r);
      if (g.has_pad && s.id[hf] == g.pad) s.hi[hf] = 0;
    }
  }
  return s;
}

// Whether every row of the calling warp sees the other side's rows
// [p0, p0 + n): with contiguous ids (ranges) from the rows' ranges, every
// warp on its own and with no load; with ids in any order from the tiles'
// (min, max) ids (seg_uniform, outer tile t and inner tile i). Called by
// whole warps.
__device__ __forceinline__ bool seg_interior(const SegArgs& g,
                                             const SegRows& sg, int bi,
                                             int t, int i, int p0, int n) {
  if (g.ranges != nullptr)
    return __all_sync(0xffffffffu, sg.lo[0] <= p0 && sg.hi[0] >= p0 + n &&
                                       sg.lo[1] <= p0 && sg.hi[1] >= p0 + n);
  return seg_uniform(g, bi, t, i);
}

// -inf on the scores of a 64 x N block (element i: own row (i/2)%2, other
// row col + 8 (i/4) + i%2, the layout of every block here) that the rows
// may not see: the segment step of an edge block, before its causal and
// window test; exp2 then makes their P exactly 0.
template <int N>
__device__ __forceinline__ void seg_mask(float (&st)[N / 2],
                                         const SegRows& sg, int col) {
  const float ninf = __int_as_float(0xff800000);
  if (sg.other == nullptr) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int hf = (i >> 1) & 1, pos = col + 8 * (i >> 2) + (i & 1);
      if (pos < sg.lo[hf] || pos >= sg.hi[hf]) st[i] = ninf;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int hf = (i >> 1) & 1;
      if (!sg.sees(hf, col + 8 * (i >> 2) + (i & 1))) st[i] = ninf;
    }
  }
}

// The additive fp32 bias of the resident kernels, (b|1, h|1, sq, sk) read
// in place through element strides (0 on a broadcast dim: BERT's padding
// bias is (b, 1, 1, sk) with the query stride 0); p == nullptr: none.
struct BiasArgs {
  const float* p;
  long long sb, sh, sq, sk;
};

// Two bias lines a thread reads and the stride along them: the rows of
// its queries row and row + 8 (stride: the key's), or, in the dK/dV pass,
// the columns of its keys key0 and key0 + 8 (stride: the query's). nullptr
// for a row past sq or a key past sk: those take no bias, so their scores
// stay finite (they are never stored).
struct BiasLines {
  const float* r[2];
  long long s;
};

// The bias rows of queries row and row + 8 of head (bi, hi)
__device__ __forceinline__ BiasLines bias_rows(const BiasArgs& b, int bi,
                                               int hi, int row, int sq) {
  const float* head = b.p + bi * b.sb + hi * b.sh;
  return {{row < sq ? head + row * b.sq : nullptr,
           row + 8 < sq ? head + (row + 8) * b.sq : nullptr},
          b.sk};
}

// The bias columns of keys key and key + 8 of head (bi, hi)
__device__ __forceinline__ BiasLines bias_cols(const BiasArgs& b, int bi,
                                               int hi, int key, int sk) {
  const float* head = b.p + bi * b.sb + hi * b.sh;
  return {{key < sk ? head + key * b.sk : nullptr,
           key + 8 < sk ? head + (key + 8) * b.sk : nullptr},
          b.sq};
}

// A 64 x N score block in base 2 with the bias added: st * c + bias
// log2(e), element i at row half (i/2)%2 (bias rows `rows`) and key col +
// 8 (i/4) + i%2 (the layout of dq_probs / online_softmax). Keys past sk
// take none; the masks zero them after. kShare: where both rows are one
// (a bias broadcast over queries, BERT's padding bias), each value is
// loaded once for both (the dQ pass: faster on the card; the forward
// without it: PERF.md, PR 13).
template <int N, bool kShare = true>
__device__ __forceinline__ void add_bias(float (&st)[N / 2],
                                         const BiasLines& rows, float c,
                                         int col, int sk) {
  if (kShare && rows.r[0] == rows.r[1]) {
    const float* r = rows.r[0];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = col + 8 * j + e;
        const float b =
            r != nullptr && key < sk ? __ldg(r + key * rows.s) * kLog2e
                                     : 0.f;
        st[4 * j + e] = fmaf(st[4 * j + e], c, b);
        st[4 * j + 2 + e] = fmaf(st[4 * j + 2 + e], c, b);
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float* r = rows.r[(i >> 1) & 1];
    const int key = col + 8 * (i >> 2) + (i & 1);
    const float b = r != nullptr && key < sk ? __ldg(r + key * rows.s) : 0.f;
    st[i] = fmaf(st[i], c, b * kLog2e);
  }
}

// The same on a transposed 64-key x N-query block (dkv_probs' layout:
// element i is key (i/2)%2 of `keys` and query q + 8 (i/4) + i%2);
// queries past sq take none. A bias broadcast over queries (stride 0)
// gives each key one value: two loads a tile.
template <int N>
__device__ __forceinline__ void add_bias_t(float (&st)[N / 2],
                                           const BiasLines& keys, float c,
                                           int q, int sq) {
  if (keys.s == 0) {
    float bk[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      bk[hf] = keys.r[hf] != nullptr ? __ldg(keys.r[hf]) * kLog2e : 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int query = q + 8 * (i >> 2) + (i & 1);
      st[i] = fmaf(st[i], c, query < sq ? bk[(i >> 1) & 1] : 0.f);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float* kc = keys.r[(i >> 1) & 1];
    const int query = q + 8 * (i >> 2) + (i & 1);
    const float b =
        kc != nullptr && query < sq ? __ldg(kc + query * keys.s) : 0.f;
    st[i] = fmaf(st[i], c, b * kLog2e);
  }
}

// dS of a 64 x N block (dq_probs' layout) into dbias rows: `rows` are the
// thread's two rows of the (b, h, sq, sk) fp32 workspace (nullptr past sq);
// keys past sk are not written.
template <int N>
__device__ __forceinline__ void store_dbias(float* const (&rows)[2],
                                            const float (&ds)[N / 2], int col,
                                            int sk) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float* r = rows[(i >> 1) & 1];
    const int key = col + 8 * (i >> 2) + (i & 1);
    if (r != nullptr && key < sk) r[key] = ds[i];
  }
}

struct BwdMaps {
  CUtensorMap q, k, v, dout;  // encode_rows_map: 64 x 64 boxes
};

struct BwdArgs {
  const float* lse;    // (b*h, sq) contiguous
  const float* delta;  // (b*h, sq) contiguous
  float* acc;          // streamed: dQ, or dK
  float* dv;           // streamed: dV
  int h, sq, sk, d;
  uint32_t qpos, kpos, vpos, opos;  // coordinate placement of each map
  float scale;
  int causal, window, split_tiles;
  int shift;  // q_off - k_off (k_tiles); read by the kGen instances only
};

// Byte offsets in dynamic shared memory (after aligning it to 1024): the two
// resident operands (K, V or Q, dO; kOuter rows each), the ring of streamed
// pairs (Q, dO or K, V; kInner rows each), fp32 row statistics, mbarriers.
template <int DP>
struct BwdLayout {
  static constexpr int kChunks = DP / 64;
  static constexpr int kOuterBytes = kChunks * kOuter * kRowBytes;
  static constexpr int kInnerBytes = kChunks * kInner * kRowBytes;
  static constexpr int kRing = 2 * kOuterBytes;
  static constexpr int kStats = kRing + kStages * 2 * kInnerBytes;
  static constexpr int kStatFloats = 2 * kStages * kInner;  // >= 2 kOuter
  static constexpr int kBars = kStats + kStatFloats * 4;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
};

// The map coordinate x_i (i = 1..3) of sequence row `row`, head hi and
// batch bi, as encode_rows_map placed the three outer dimensions in `pos`.
__device__ __forceinline__ int map_coord(uint32_t pos, int i, int row, int hi,
                                         int bi) {
  const int ps = pos & 3, ph = (pos >> 2) & 3;
  return ps == i ? row : ph == i ? hi : bi;
}

// TMA of rows [r0, r0 + R) x all DP columns of one head into a tile of R
// rows: 64-column chunks one after another, 64-row boxes.
template <int DP, int R>
__device__ __forceinline__ void tma_rows(unsigned char* dst,
                                         const CUtensorMap* map, uint32_t pos,
                                         uint64_t* bar, int r0, int hi,
                                         int bi) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int rb = 0; rb < R / 64; ++rb) {
      const int row = r0 + rb * 64;
      hopper::tma_load_4d(dst + (c * R + rb * 64) * kRowBytes, map, bar,
                          c * 64, map_coord(pos, 1, row, hi, bi),
                          map_coord(pos, 2, row, hi, bi),
                          map_coord(pos, 3, row, hi, bi));
    }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A warpgroup's 64 x DP accumulator, each row half times its multiplier
// (mul_lo for the thread's rows r, mul_hi for r + 8), as bf16, into its
// rows of a staging tile of R rows (`tile` points at the warpgroup's first
// row): 64-column chunks R rows apart, each row 128 bytes with 16-byte
// chunk c at c ^ (row % 8) -- the layout a {64, 64} TMA box with the
// 128-byte swizzle reads. Thread (warp, lane) holds rows 16 warp + lane / 4
// (+ 8) at columns 8 j + 2 (lane % 4): one 4-byte word each, no bank
// conflict.
template <int DP, int R = kOuter>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const float (&acc)[DP / 2],
                                           float mul_lo, float mul_hi) {
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, sw = lane / 4;  // r % 8 == sw
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    unsigned char* chunk = tile + (j / 8) * R * kRowBytes;
    const int col = ((j % 8) ^ sw) * 16 + (lane % 4) * 4;
    *reinterpret_cast<uint32_t*>(chunk + r * kRowBytes + col) =
        pack_bf16(acc[4 * j] * mul_lo, acc[4 * j + 1] * mul_lo);
    *reinterpret_cast<uint32_t*>(chunk + (r + 8) * kRowBytes + col) =
        pack_bf16(acc[4 * j + 2] * mul_hi, acc[4 * j + 3] * mul_hi);
  }
}

// TMA stores of a warpgroup's staged 64 rows (in a staging tile of R rows)
// to rows [row0, row0 + 64) of head (bi, hi) of `map`: one {64, 64} box a
// 64-column chunk. TMA writes no row past the tensor's s and no column past
// its d.
template <int DP, int R = kOuter>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           uint32_t pos,
                                           const unsigned char* tile,
                                           int row0, int hi, int bi) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    hopper::tma_store_4d(map, tile + c * R * kRowBytes, c * 64,
                         map_coord(pos, 1, row0, hi, bi),
                         map_coord(pos, 2, row0, hi, bi),
                         map_coord(pos, 3, row0, hi, bi));
}

// The staging protocol of a warpgroup: its store thread waits until the
// previous item's stores have read the staging tiles, the warpgroup syncs,
// writes (stage_rows), fences its writes for TMA and syncs again, then the
// store thread starts the stores.
__device__ __forceinline__ void staging_free(int wg) {
  if (threadIdx.x % kWg == 0) hopper::bulk_wait_read<0>();
  hopper::named_sync(1 + wg, kWg);
}

__device__ __forceinline__ void staging_ready(int wg) {
  hopper::fence_async_shared();
  hopper::named_sync(1 + wg, kWg);
}

// Descriptor of the k16 step kk of a K-major operand: rows from `row` of a
// tile of R rows at shared address `tile`.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row, int kk) {
  return hopper::sw128_desc(
      tile + (kk >> 2) * R * kRowBytes + row * kRowBytes + (kk & 3) * 32, 16,
      1024);
}

// Descriptor of the k16 step kk (rows 16kk..) of an MN-major B: a streamed
// tile of R rows, whose 64-column chunks lie R rows apart.
template <int R = kInner>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return hopper::sw128_desc(tile + kk * kKStep, R * kRowBytes, 1024);
}

// Whether every pair of a BQ-query x BK-key block is visible: an interior
// block, whose scores need no test. Edge blocks (the diagonal, a window
// edge, the ragged end) test each score. Queries past sq need no test:
// their Q and dO rows are TMA's zero fill, so they add 0 (the backward),
// and their o and lse are never stored (the forward). qa: the queries'
// first position for the masks (a ring step's row plus its shift,
// k_tiles); ka: the keys' first local row.
template <int BK = 64, int BQ = 64>
__device__ __forceinline__ bool interior(int qa, int ka, int sk, int causal,
                                         int window) {
  const int qb = qa + BQ - 1, kb = ka + BK - 1;
  return kb < sk && (!causal || kb <= qa) &&
         (window <= 0 || (qb - ka < window && (causal || kb - qa < window)));
}

// lse in base 2, +inf on a row with no visible key: there exp2(s - lse) is
// exactly 0, with no test on the fast path. Rows past sq arrive as lse 0
// with zero Q and dO rows, so they add 0 as well.
__device__ __forceinline__ float lse2_of(float lse) {
  return lse > kNegInf * 0.5f ? lse * kLog2e : __int_as_float(0x7f800000);
}

// The producer's lanes copy rows [r0, r0 + n) of a head's lse and delta into
// shared memory (zeros past sq) and arrive on `bar` when they land.
__device__ __forceinline__ void copy_stats(float* dst, const float* lse,
                                           const float* delta, int r0, int n,
                                           int sq, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  for (int r = lane; r < n; r += 32) {
    const bool in = r0 + r < sq;
    hopper::cp_async_4(dst + r, in ? lse + r0 + r : lse, in);
    hopper::cp_async_4(dst + n + r, in ? delta + r0 + r : delta, in);
  }
  hopper::mbar_arrive_cp_async(bar);
}

template <int DP>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[DP / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  hopper::wgmma_rs_n64_tb(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  hopper::wgmma_rs_n128_tb(d, a, db);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  hopper::wgmma_ss_n64(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  hopper::wgmma_ss_n128(d, da, db, accumulate);
}

// 64 x RB scores of a warpgroup's 64 rows against a tile's RB rows:
// S = A B^T over DP columns, both operands K-major in shared memory
template <int DP, int RA, int RB = kInner>
__device__ __forceinline__ void scores(float (&s)[RB / 2], uint32_t a_tile,
                                       int a_row, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(s, kmajor<RA>(a_tile, a_row, kk), kmajor<RB>(b_tile, 0, kk),
             kk > 0);
}

// P^T and dS^T of a 64-key x N-query block, in place of S^T and dP^T:
// element i of the accumulators is key key0 + 8 ((i/2)%2), query
// q + 8 (i/4) + i%2; lse and delta of the tile's N queries in `stats`
// (lse, then delta). kMask: the block is an edge block (the diagonal, a
// window edge, the ragged end), so each pair is tested; interior blocks
// skip the test. A segment edge is masked before (seg_mask). shift: added
// to the queries' rows for the test (k_tiles).
template <bool kMask, int N = 64>
__device__ __forceinline__ void dkv_probs(float (&st)[N / 2],
                                          float (&dp)[N / 2],
                                          const float* stats, float c, int q,
                                          int key0, const BwdArgs& a,
                                          int shift = 0) {
  const int qc = q % N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 lj = *reinterpret_cast<const float2*>(stats + 8 * j + qc);
    const float2 dj =
        *reinterpret_cast<const float2*>(stats + N + 8 * j + qc);
    const float l[2] = {lse2_of(lj.x), lse2_of(lj.y)};
    const float dl[2] = {dj.x, dj.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = hopper::fast_exp2(fmaf(st[i], c, -l[e & 1]));
      if (kMask && !visible(q + shift + 8 * j + (e & 1), key0 + 8 * (e >> 1),
                            a.sk, a.causal, a.window))
        p = 0.f;
      st[i] = p;
      dp[i] = p * (dp[i] - dl[e & 1]);
    }
  }
}

// dS of a 64-query x N-key block in place of dP: element i is query
// row + 8 ((i/2)%2), key col + 8 (i/4) + i%2; l2 / dl: the base-2 lse and
// the delta of the thread's two rows; shift as in dkv_probs
template <bool kMask, int N = 64>
__device__ __forceinline__ void dq_probs(float (&dp)[N / 2],
                                         const float (&st)[N / 2],
                                         const float (&l2)[2],
                                         const float (&dl)[2], float c,
                                         int row, int col,
                                         const BwdArgs& a, int shift = 0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int hf = (i >> 1) & 1;
    float p = hopper::fast_exp2(fmaf(st[i], c, -l2[hf]));
    if (kMask && !visible(row + shift + 8 * hf, col + 8 * (i >> 2) + (i & 1),
                          a.sk, a.causal, a.window))
      p = 0.f;
    dp[i] = p * (dp[i] - dl[hf]);
  }
}

// The 64 x N fp32 product x as bf16 register A fragments, one per k16
// slice of its columns
template <int N = 64>
__device__ __forceinline__ void fragments(uint32_t (&f)[N / 16][4],
                                          const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc (64 x DP) += X Y over the tile's R rows: X as register fragments,
// Y the streamed tile as an MN-major B
template <int DP, int R = kInner>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 2],
                                           const uint32_t (&f)[R / 16][4],
                                           uint32_t y_tile) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs_tb<DP>(acc, f[kk], mnmajor<R>(y_tile, kk));
}

// A consumer warpgroup's loop over nt streamed tiles of N rows.
// start(st, dp, n) waits for tile n and starts its two score products as
// one commit group; finish(st, dp, n) turns the scores into the tile's
// contributions and starts their products; release(n) frees tile n's
// stage once they are done. The products run on every tile, masked
// or not, and each group is waited for in straight-line code: a wgmma
// group kept in flight across a branch makes ptxas serialise them.
template <int N = 64, class Start, class Finish, class Release>
__device__ __forceinline__ void consume(int nt, Start start, Finish finish,
                                        Release release) {
  for (int n = 0; n < nt; ++n) {
    float st[N / 2], dp[N / 2];
    start(st, dp, n);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dp);
    finish(st, dp, n);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    release(n);
  }
}

}  // namespace
}  // namespace apex_torch
