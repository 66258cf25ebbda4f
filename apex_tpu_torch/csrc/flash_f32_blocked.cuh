// Device pieces of the fp32 flash-attention kernels on register-blocked
// FMA fed by a double-buffered cp.async ring, shared by the resident
// backward pair (dq_f32_blocked / dkv_f32_blocked, flash_attention_bwd.cu)
// and the forward (fwd_f32_blocked: its resident instances in
// flash_attention.cu, its split ones in flash_attention_stream.cu): the
// cp.async copies of operand rows, the thread layout, the 4 x BN/8 score
// and 4 x DP/8 output micro-tiles, the P / dS tile whose rows one warp
// writes and reads, the launch of either direction's kernel
// (launch_f32_k), and the forward's step over one key tile, its kernel and
// its launch. The bands, the masks, the segment rows and the bias lines
// come from flash_bwd_wgmma.cuh.

#pragma once

#include "flash_bwd_wgmma.cuh"

namespace apex_torch {
namespace {

// Float offsets in dynamic shared memory: the two resident operands (Q, dO
// or K, V; 16 NW rows each), two stages of the streamed pair (K, V or Q,
// dO; BN rows each, with the BN queries' lse and delta for dK/dV), then the
// dS tile (dQ) or the P^T and dS^T tiles (dK/dV), outer rows by BN. Operand
// rows at pitch DP + 4, P / dS rows at BN + 8: see scores_fma and
// accumulate_fma.
template <int DP, int NW, int BN, bool kDkv>
struct F32Layout {
  static constexpr int kP = DP + 4;
  static constexpr int kPd = BN + 8;
  static constexpr int kRows = 16 * NW;
  static constexpr int kRing = 2 * kRows * kP;
  static constexpr int kStage = 2 * BN * kP + (kDkv ? 2 * BN : 0);
  static constexpr int kTiles = kRing + 2 * kStage;
  static constexpr int kTile = kRows * kPd;
  static constexpr size_t kBytes =
      sizeof(float) * (kTiles + (kDkv ? 2 : 1) * kTile);
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of one head (`head`: its row 0, `rs`: the row stride)
// into a tile of R rows at pitch DP + 4 by cp.async, all NT threads taking
// part: rows past n and columns past d are zeros. vec: 16-byte copies
// (d % 4 == 0, the head and rs on 16 bytes), else 4-byte ones.
template <int DP, int R, int NT>
__device__ __forceinline__ void ring_rows(float* dst, const float* head,
                                          long long rs, int r0, int n, int d,
                                          bool vec) {
  constexpr int kP = DP + 4;
  if (vec) {
    constexpr int C = DP / 4;
    for (int e = threadIdx.x; e < R * C; e += NT) {
      const int r = e / C, c = (e % C) * 4;
      const bool in = r0 + r < n && c < d;
      cp_async_16(dst + r * kP + c, in ? head + (r0 + r) * rs + c : head,
                  in);
    }
  } else {
    for (int e = threadIdx.x; e < R * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      const bool in = r0 + r < n && c < d;
      hopper::cp_async_4(dst + r * kP + c,
                         in ? head + (r0 + r) * rs + c : head, in);
    }
  }
}

// The thread layout of the fp32 kernels: thread (ty, tx) = (tid / 8, tid %
// 8) of 32 NW keeps outer rows own_row(ty, i), i < 4 -- pairs 8 apart (the
// row, row + 8 of SegRows and BiasLines), a warp's rows consecutive -- and
// the inner rows (S's columns) tx + 8 j, j < BN / 8, and the output
// columns col_of(tx, m) = 32 (m / 4) + 4 tx + m % 4, m < DP / 8.
template <int BM>
__device__ __forceinline__ int own_row(int ty, int i) {
  return (ty & 7) + 16 * (ty >> 3) + 8 * (i & 1) + (BM / 2) * (i >> 1);
}

__device__ __forceinline__ int col_of(int tx, int m) {
  return 32 * (m >> 2) + 4 * tx + (m & 3);
}

// s[i][j] = X[own_row(ty, i)] . Y[tx + 8 j] over the first 4 kd4 columns
// (zero past d), each an fmaf chain from 0 in column order, as the plain
// version's fp32 product sums it. x and y: tiles at pitch DP + 4; 16-byte
// loads, each operand read once a 4 x BN/8 micro-tile: a warp's four X
// rows lie 16 bytes apart and its eight Y rows too, so no bank conflict.
template <int DP, int BM, int BN>
__device__ __forceinline__ void scores_fma(float (&s)[4][BN / 8],
                                           const float* x, const float* y,
                                           int kd4, int ty, int tx) {
  constexpr int kP = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int kq = 0; kq < kd4; ++kq) {
    float4 xa[4], yb[BN / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xa[i] = *reinterpret_cast<const float4*>(x + own_row<BM>(ty, i) * kP +
                                               4 * kq);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      yb[j] = *reinterpret_cast<const float4*>(y + (tx + 8 * j) * kP +
                                               4 * kq);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float v = fmaf(xa[i].x, yb[j].x, s[i][j]);
        v = fmaf(xa[i].y, yb[j].y, v);
        v = fmaf(xa[i].z, yb[j].z, v);
        s[i][j] = fmaf(xa[i].w, yb[j].w, v);
      }
  }
}

// The BN-wide rows of a P / dS tile (pitch BN + 8) that a thread wrote:
// element (i, j) at own_row(ty, i), column tx + 8 j. A warp writes 8 words
// of four consecutive rows: banks 8 row + tx, no conflict.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(float* tile,
                                           const float (&z)[4][BN / 8],
                                           int ty, int tx) {
  constexpr int kPd = BN + 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      tile[own_row<BM>(ty, i) * kPd + tx + 8 * j] = z[i][j];
}

// acc[i][m] (row own_row(ty, i), column col_of(tx, m)) += Z[row][c]
// W[c][column] for c = 0.. BN - 1 in order: one fmaf chain per element
// across the band's tiles, as the plain version's product sums it. Z: a
// P / dS tile (pitch BN + 8; 16-byte loads of 4 columns of the thread's
// rows, broadcast across its warp: banks 8 row + c..); W: a streamed tile
// (pitch DP + 4; a 16-byte load of the 8 tx of a warp covers 32
// consecutive columns: 128 bytes, no conflict). UC: the loop's unroll
// factor (1: the backward's registers).
template <int DP, int BM, int BN, int UC = 1>
__device__ __forceinline__ void accumulate_fma(float (&acc)[4][DP / 8],
                                               const float* z, const float* w,
                                               int ty, int tx) {
  constexpr int kP = DP + 4, kPd = BN + 8;
#pragma unroll (UC)
  for (int c4 = 0; c4 < BN; c4 += 4) {
    float zc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 zq =
          *reinterpret_cast<const float4*>(z + own_row<BM>(ty, i) * kPd + c4);
      zc[i][0] = zq.x;
      zc[i][1] = zq.y;
      zc[i][2] = zq.z;
      zc[i][3] = zq.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* wr = w + (c4 + u) * kP + 4 * tx;
#pragma unroll
      for (int g = 0; g < DP / 32; ++g) {
        const float4 wq = *reinterpret_cast<const float4*>(wr + 32 * g);
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * g + e] = fmaf(zc[i][u], wv[e], acc[i][4 * g + e]);
      }
    }
  }
}

// A thread's 4 x DP/8 result times `mul` into `out` (contiguous rows of
// d): rows row0 + own_row(ty, i), none past n rows or d columns
template <int DP, int BM>
__device__ __forceinline__ void store_f32(float* out,
                                          const float (&acc)[4][DP / 8],
                                          float mul, int row0, int n, int d,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + own_row<BM>(ty, i);
    if (row >= n) continue;
    float* o = out + (size_t)row * d;
#pragma unroll
    for (int m = 0; m < DP / 8; ++m) {
      const int col = col_of(tx, m);
      if (col < d) o[col] = acc[i][m] * mul;
    }
  }
}

// Whether an fp32 operand's rows take 16-byte copies: d % 4 == 0 and its
// base and (b, h, s) strides on 16 bytes
inline bool rows_vec(const void* p, const Strides& s, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         s.b % 4 == 0 && s.h % 4 == 0 && s.s % 4 == 0;
}

// ---------------------------------------------------------------------------
// the forward: O = softmax(scale Q K^T [+ bias], masked) V and lse
// ---------------------------------------------------------------------------

// The arguments of fwd_f32_blocked: items (b*h, query tile, split) over
// bands of at most nsplit splits of split_tiles key tiles; a band's only
// split writes o and lse, a split of a longer band its partial for fwd_merge.
struct FwdF32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;    // (b*h, sq, d) contiguous
  float* lse;  // (b*h, sq) contiguous
  float* acc;  // (nsplit, b*h, sq, d): the partials' sums, where nsplit > 1
  float* m;    // (nsplit, b*h, sq): their row max
  float* l;    // (nsplit, b*h, sq): their row sum
  int h, bh, sq, sk, d;
  Strides qs, ks, vs;
  float scale;
  int causal, window;  // window <= 0: none
  int shift;           // q_off - k_off (k_tiles); kGen instances only
  int n_outer;         // query tiles of a head
  int nsplit;          // splits of the longest band (1: the resident route)
  int split_tiles;     // key tiles of a split at most
  int items;           // bh * n_outer * nsplit: the CTAs of the grid
  int vec;             // bit i set: operand i (q, k, v) takes 16-byte copies
  BiasArgs bias;       // p == nullptr: none (the kBias instances read it)
  SegArgs seg;
};

// FwdF32Args of both routes: the operands, the masks (with the ring's
// shift) and the split fields
// (acc, m, l: the partials, null where no band has several splits;
// split_tiles; nsplit, 1 for bands of one split), with no bias
inline FwdF32Args fwd_f32_args(const void* q, const void* k, const void* v,
                               void* o, void* lse, int h, int bh, int sq,
                               int sk, int d, Strides qs, Strides ks,
                               Strides vs, float scale, int causal,
                               int window, int shift, const SegArgs& seg,
                               float* acc,
                               float* m, float* l, int split_tiles,
                               int nsplit) {
  FwdF32Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.acc = acc;
  a.m = m;
  a.l = l;
  a.h = h;
  a.bh = bh;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.qs = qs;
  a.ks = ks;
  a.vs = vs;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.shift = shift;
  a.split_tiles = split_tiles;
  a.nsplit = nsplit > 1 ? nsplit : 1;
  a.seg = seg;
  return a;
}

// Float offsets in dynamic shared memory: Q (16 NW rows), two stages of the
// streamed pair (K, V; BN rows each), then the P tile (16 NW rows by BN).
// Operand rows at pitch DP + 4, P rows at BN + 8, as in F32Layout.
// kMinBlocks, the CTAs an SM holds at once for __launch_bounds__: as many
// as its 228 KB of shared memory takes (1 KB each reserved), two for both
// instances, which leaves each thread up to 255 registers (ptxas: no spill).
template <int DP, int NW, int BN>
struct FwdF32Layout {
  static constexpr int kP = DP + 4;
  static constexpr int kPd = BN + 8;
  static constexpr int kRows = 16 * NW;
  static constexpr int kRing = kRows * kP;
  static constexpr int kStage = 2 * BN * kP;
  static constexpr int kTiles = kRing + 2 * kStage;
  static constexpr size_t kBytes = sizeof(float) * (kTiles + kRows * kPd);
  static constexpr int kMinBlocks = (int)(233472 / (kBytes + 1024));
};

// The unroll factor of the forward's P V product (accumulate_fma), chosen
// on the card among 1, 2 and 4 with scores_fma's at 2 and 4 (PERF.md:
// within 2% of one another; 4 and 4 spills)
constexpr int kFwdAccUnroll = 2;

// The forward's step over one key tile that has landed (K at ks, V at vs),
// on a thread's 4 rows (own_row) and BN/8 keys (k0 + tx + 8 j): S = Q K^T
// (scores_fma: one fmaf chain over the head dimension in column order),
// s = scale S (+ the bias line's value where kBias, as _fwd_kernel adds
// it after the scale), kNegInf where an edge tile masks the pair (visible()
// and, where kGen, the segment rows' test), the row max over the 8 lanes
// that share a row (three shuffles; q0: the first row's position for the
// masks, plus a ring step's shift), alpha = exp(m_old - m), P = exp(s -
// m) (0 while a row has seen nothing: m <= kNegInf / 2, the plain
// version's guard), l and O rescaled by alpha, P through the warp's own
// rows of the shared tile pt (store_tile, __syncwarp) and O += P V
// (accumulate_fma: one fmaf chain a column over the keys in order). exp
// is expf, in natural units as the plain version takes it. l is this
// thread's share of its rows' sums (its BN/8 keys); the kernel sums the 8
// lanes once, after the band.
template <int DP, int BM, int BN, bool kBias, bool kGen>
__device__ __forceinline__ void fwd_f32_step(
    float (&acc)[4][DP / 8], float (&m)[4], float (&l)[4], const float* qs,
    const float* ks, const float* vs, float* pt, int kd4, int ty, int tx,
    int q0, int k0, float scale, int sk, int causal, int window, bool edge,
    const BiasLines (&br)[2], const SegRows (&sg)[2]) {
  float s[4][BN / 8];
  scores_fma<DP, BM, BN>(s, qs, ks, kd4, ty, tx);
  float mx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int key = k0 + tx + 8 * j;
      float sv = s[i][j] * scale;
      if constexpr (kBias) {
        const BiasLines& b = br[i >> 1];
        if (b.r[i & 1] != nullptr && key < sk)
          sv += __ldg(b.r[i & 1] + key * b.s);
      }
      if (edge && !(visible(q0 + own_row<BM>(ty, i), key, sk, causal,
                            window) &&
                    (!kGen || sg[i >> 1].sees(i & 1, key))))
        sv = kNegInf;
      s[i][j] = sv;
      mx[i] = fmaxf(mx[i], sv);
    }
  }
  float alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool dead = m[i] <= kNegInf * 0.5f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p = dead ? 0.f : expf(s[i][j] - m[i]);
      s[i][j] = p;
      sum += p;
    }
    l[i] = l[i] * alpha[i] + sum;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) acc[i][c] *= alpha[i];
  }
  store_tile<BM, BN>(pt, s, ty, tx);
  __syncwarp();  // a row's P is written and read by one warp
  accumulate_fma<DP, BM, BN, kFwdAccUnroll>(acc, pt, vs, ty, tx);
}

// The fp32 forward, one CTA per item. Item w = blockIdx.x is split (w / bh)
// % nsplit of query tile n_outer - 1 - w / (bh nsplit) (the longest causal
// band first) of head w % bh. The CTA keeps 16 NW queries (Q, loaded once
// by cp.async) and streams the BN-row key tiles (K, V) of its split of the
// band -- the causal limit and the window (k_tiles), cut by split_of
// (kSplit; the resident instances take the whole band), narrowed by the
// segment bounds (seg_band) -- through the ring's two stages, the next tile
// landing while this one computes, and runs fwd_f32_step on each: interior
// tiles with no test, edge tiles (the diagonal, a window edge, the ragged
// end, a segment edge) with one. A band's only split normalises in
// registers and writes o = O / l and the lse m + log l (o = 0 exactly and
// lse kNegInf for a row that saw no key, l == 0); a split of a longer band
// writes its partial (acc = O, m: kNegInf where l == 0, l) for fwd_merge,
// an empty one too. Each element is written once, with no atomics: two
// calls give the same bits. kBias: the additive bias (the resident
// route's); kGen: the window, the segment ids and the ring's shift (the
// bands and the masks at row + shift; an empty band writes o = 0 and lse
// kNegInf); the instances without them run no test for either.
template <int DP, int NW, int BN, bool kBias, bool kGen, bool kSplit>
__global__ void __launch_bounds__(NW * 32,
                                  FwdF32Layout<DP, NW, BN>::kMinBlocks)
    fwd_f32_blocked(const FwdF32Args a) {
  using L = FwdF32Layout<DP, NW, BN>;
  constexpr int NT = NW * 32, kP = L::kP, BM = L::kRows;
  extern __shared__ float smf[];
  float* qs = smf;
  float* ring = smf + L::kRing;
  float* pt = smf + L::kTiles;  // P
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int kd4 = (a.d + 3) / 4, nk = (a.sk + BN - 1) / BN;
  const int window = kGen ? a.window : 0;
  const int shift = kGen ? a.shift : 0;
  const int nsplit = kSplit ? a.nsplit : 1;
  const int w = blockIdx.x;
  const int bh = w % a.bh, t = w / a.bh;
  const int split = t % nsplit, qt = a.n_outer - 1 - t / nsplit;
  const int bi = bh / a.h, hi = bh - bi * a.h, q0 = qt * BM;
  Band band = k_tiles(qt, nk, a.causal, window, BM, BN, shift);
  bool direct = true;
  if constexpr (kSplit) {
    // an empty band's split 0 writes its rows' o = 0 and lse
    const int ns = n_splits(band, a.split_tiles);
    int t0, t1;
    if (split_of(band, split, a.split_tiles, t0, t1))
      band = Band{t0, t1};
    else if (ns > 0 || split > 0)
      return;
    direct = ns <= 1;
  }
  if constexpr (kGen) band = seg_band(a.seg, band, bi, qt);
  const int nt = max(0, band.hi - band.lo);
  const float* qh = a.q + bi * a.qs.b + hi * a.qs.h;
  const float* kh = a.k + bi * a.ks.b + hi * a.ks.h;
  const float* vh = a.v + bi * a.vs.b + hi * a.vs.h;
  auto load_stage = [&](int i, int s) {
    float* to = ring + s * L::kStage;
    ring_rows<DP, BN, NT>(to, kh, a.ks.s, i * BN, a.sk, a.d, a.vec & 2);
    ring_rows<DP, BN, NT>(to + BN * kP, vh, a.vs.s, i * BN, a.sk, a.d,
                          a.vec & 4);
  };
  if (nt > 0) {
    ring_rows<DP, BM, NT>(qs, qh, a.qs.s, q0, a.sq, a.d, a.vec & 1);
    load_stage(band.lo, 0);
  }
  cp_async_commit();

  // rows own_row(ty, 2 p) and + 8 share SegRows / BiasLines p
  SegRows sg[2] = {};
  BiasLines br[2] = {};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int q = q0 + own_row<BM>(ty, 2 * p);
    if constexpr (kGen) sg[p] = seg_rows(a.seg, false, bi, q, a.sq, a.sk);
    if constexpr (kBias) br[p] = bias_rows(a.bias, bi, hi, q, a.sq);
  }
  float acc[4][DP / 8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) acc[i][c] = 0.f;
  }

  for (int n = 0; n < nt; ++n) {
    if (n + 1 < nt) load_stage(band.lo + n + 1, (n + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = ring + (n & 1) * L::kStage;
    const int ti = band.lo + n, k0 = ti * BN;
    bool edge = !interior<BN, BM>(q0 + shift, k0, a.sk, a.causal, window);
    if constexpr (kGen)
      edge = edge || !(seg_interior(a.seg, sg[0], bi, qt, ti, k0, BN) &&
                       seg_interior(a.seg, sg[1], bi, qt, ti, k0, BN));
    fwd_f32_step<DP, BM, BN, kBias, kGen>(
        acc, m, l, qs, ks, ks + BN * kP, pt, kd4, ty, tx, q0 + shift, k0,
        a.scale,
        a.sk, a.causal, window, edge, br, sg);
    __syncthreads();  // this stage is free for tile n + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  const size_t head = (size_t)bh * a.sq;
  if (direct) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) acc[i][c] *= inv;
    }
    store_f32<DP, BM>(a.o + head * a.d, acc, 1.f, q0, a.sq, a.d, ty, tx);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + own_row<BM>(ty, i);
        if (row < a.sq)
          a.lse[head + row] = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
      }
    }
  } else {
    const size_t at = (size_t)split * a.bh * a.sq + head;
    store_f32<DP, BM>(a.acc + at * a.d, acc, 1.f, q0, a.sq, a.d, ty, tx);
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + own_row<BM>(ty, i);
        if (row < a.sq) {
          a.m[at + row] = l[i] > 0.f ? m[i] : kNegInf;
          a.l[at + row] = l[i];
        }
      }
    }
  }
}

// An fp32 kernel (the forward's or the backward pair's) over one CTA per
// item, or (persistent) as many CTAs as fit on the card at once
template <auto Kernel, size_t kSmem, int kThreads, typename Args>
int launch_f32_k(const Args& r, int persistent, cudaStream_t stream) {
  int err = set_max_smem<Kernel>(kSmem);
  if (err) return err;
  int grid = r.items;
  if (persistent) {
    static int resident = 0;  // CTAs the card holds at once, per instance
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      err = (int)cudaGetDevice(&dev);
      if (!err)
        err = (int)cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
      if (!err)
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, Kernel, kThreads, kSmem);
      if (err) return err;
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    grid = grid < resident ? grid : resident;
  }
  Kernel<<<grid, kThreads, kSmem, stream>>>(r);
  return (int)cudaGetLastError();
}

template <int DP, int NW, int BN, bool kBias, bool kGen, bool kSplit>
int launch_fwd_f32_k(const FwdF32Args& a, cudaStream_t stream) {
  return launch_f32_k<fwd_f32_blocked<DP, NW, BN, kBias, kGen, kSplit>,
                      FwdF32Layout<DP, NW, BN>::kBytes, NW * 32>(a, 0,
                                                                 stream);
}

// The fp32 forward's warps a CTA: 16 NW query rows (fwd_f32_tiles_ok)
constexpr int kFwdF32Warps = 4;

// The instance with the bias where one is given (resident only), and with
// the general masks where a window, segment ids or a ring shift are
template <int DP, int BN, bool kSplit>
int launch_fwd_f32_masks(const FwdF32Args& a, cudaStream_t stream) {
  const bool gen = a.window > 0 || a.seg.q != nullptr || a.shift != 0;
  if constexpr (!kSplit) {
    if (a.bias.p != nullptr)
      return gen ? launch_fwd_f32_k<DP, kFwdF32Warps, BN, true, true, false>(
                       a, stream)
                 : launch_fwd_f32_k<DP, kFwdF32Warps, BN, true, false, false>(
                       a, stream);
  }
  return gen ? launch_fwd_f32_k<DP, kFwdF32Warps, BN, false, true, kSplit>(
                   a, stream)
             : launch_fwd_f32_k<DP, kFwdF32Warps, BN, false, false, kSplit>(
                   a, stream);
}

// The tiles of the fp32 forward: 64 query rows a CTA (4 warps) over 64-row
// key tiles up to d = 64, over 32-row ones above (the 128-wide instances'
// registers and shared memory). The card's sweep of 128-row CTAs, 32-row
// key tiles at d <= 64 and the persistent grid found none faster (PERF.md).
inline bool fwd_f32_tiles_ok(int d, int outer_tile, int inner_tile) {
  return outer_tile == 16 * kFwdF32Warps && inner_tile == (d > 64 ? 32 : 64);
}

// The fp32 forward at the tiles of fwd_f32_tiles_ok over the items of
// a.nsplit splits a band: the grid and the operands' copy widths, then the
// instance of the padded head_dim (64 or 128).
template <bool kSplit>
int launch_fwd_f32(FwdF32Args a, cudaStream_t stream) {
  constexpr int kRows = 16 * kFwdF32Warps;
  a.n_outer = (a.sq + kRows - 1) / kRows;
  const long long items = (long long)a.bh * a.n_outer * a.nsplit;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  a.vec = rows_vec(a.q, a.qs, a.d) | rows_vec(a.k, a.ks, a.d) << 1 |
          rows_vec(a.v, a.vs, a.d) << 2;
  if (a.d > 64) return launch_fwd_f32_masks<128, 32, kSplit>(a, stream);
  return launch_fwd_f32_masks<64, 64, kSplit>(a, stream);
}

}  // namespace
}  // namespace apex_torch
