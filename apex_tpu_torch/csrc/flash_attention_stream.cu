// Streamed flash attention for Hopper: a split-K/V forward with its merge
// pass, a split-K/V dQ pass and a split-Q dK/dV pass.
//
// Replaces: apex_tpu/ops/flash_attention.py _fwd_kernel_stream (pallas_call
// in _flash_fwd_stream, :992), _bwd_dq_kernel_stream (pallas_call in
// _flash_bwd_stream, :1101) and _bwd_dkv_kernel_stream (:1172). They
// compute what the resident kernels compute -- O = softmax(scale Q K^T) V
// with the fp32 lse, then dQ = scale dS K and dK = scale dS^T Q,
// dV = P^T dO from P = exp(S - lse), dS = P (dO V^T - delta) -- under the
// causal mask (key k visible to query q iff k <= q) and/or the sliding
// window (keys [q-w+1, q] causal, [q-w+1, q+w-1] not: _apply_pos_masks).
//
// On the TPU the streamed kernels put the K/V (or Q) loop in the grid and
// carry acc/m/l, or the dQ/dK/dV sums, in VMEM scratch from one sequential
// trip to the next; the window shrinks the grid to the band (_window_grid).
// Hopper's blocks run in parallel and carry nothing between them, so here
// the loop is SPLIT ACROSS CTAs:
// - every CTA owns one 64-row tile and one split of the tiles it sees: at
//   most `split_tiles` 64-row tiles of the band [lo, hi) that the causal
//   limit and the window leave (_window_k_range / _window_q_range), cut
//   into equal pieces; tiles outside the band are never visited, so a
//   window costs O(s w) and no CTA does more than one split of work however
//   long or lopsided a row is;
// - forward: grid (q tile, split, b*h). Each CTA runs the online softmax
//   over its split and writes an fp32 partial (unnormalised acc, m, l);
//   fwd_merge then combines a row's partials, m* = max m_i,
//   l* = sum l_i e^(m_i - m*), o = sum acc_i e^(m_i - m*) / l*,
//   lse = m* + log l* (the _combine of transformer/ring.py:64-68). A row
//   with no visible key ends with l* = 0: o = 0 exactly, lse = -1e30;
// - dQ: grid (q tile, split, b*h); dK/dV: grid (k tile, split, b*h). Each
//   CTA keeps its partial in fp32 registers and adds it into an fp32
//   accumulator with atomicAdd (red.global.add.f32): no partial buffers and
//   no reduction pass, at the price of an order of addition that changes
//   from run to run (a few splits a row, so within fp32 rounding). The
//   wrapper zeroes the accumulators before and casts them to q's dtype
//   after.
//
// Bound on this card: operations (2 products of 2*d FLOPs per visible pair
// forward, 3 for dQ, 4 for dK/dV, against 4-6 (s, d) operands moved once).
// Simple first (wgmma, TMA, pipelined loads and tuning of the split length
// are later work): bf16 runs every product on the tensor cores with
// mma.sync m16n8k16 (fp32 sums), P and dS rounded to bf16 as A operands
// straight from the accumulator registers, as the resident kernels do;
// fp32 runs plain FMA with operands in shared memory. Any sq, sk and
// d <= 128 (bf16 pads d to 64 or 128 with zeros); ragged edges are masked
// in the kernels; q/k/v/dO may be strided (b, h, s) views with a contiguous
// head_dim, so the fused-QKV views need no copy.

#include "common.cuh"

namespace apex_torch {
namespace {

constexpr int kFma = 256;        // fp32 kernels: 4 lanes per tile row
constexpr int kDimMax = 128;
constexpr int kPl = kTile + 1;   // fp32 P / dS tile rows
constexpr int kMergeRows = 8;    // rows per merge block (one warp each)

struct StreamArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b*h, sq) contiguous
  const float* delta;  // (b*h, sq) contiguous
  float* acc;  // fwd: (nsplit, b*h, sq, d) partial sums; dq; dk
  float* m;    // fwd: (nsplit, b*h, sq) partial row max
  float* l;    // fwd: (nsplit, b*h, sq) partial row sum
  float* dv;   // dK/dV: the dV accumulator
  int h, bh, sq, sk, d;
  Strides qs, ks, vs, dos;
  float scale;
  int causal, window, split_tiles;  // window <= 0: none
};

// floor(a / b) for b > 0
__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  return (a >= 0 ? a : a - b + 1) / b;
}

struct Band {
  int lo, hi;  // [lo, hi) of 64-row tiles
};

// key tiles that query tile qt sees: the causal limit, then the window
// (_window_k_range with blk_q = blk_k = kTile and no ring offsets)
__device__ __forceinline__ Band k_tiles(int qt, int nk, int causal,
                                        int window) {
  Band r{0, nk};
  if (causal) r.hi = min(r.hi, qt + 1);
  if (window > 0) {
    r.lo = max(r.lo, floordiv(qt * kTile - window + 1, kTile));
    if (!causal)
      r.hi = max(0, min(r.hi, floordiv((qt + 1) * kTile + window - 2, kTile) + 1));
  }
  return r;
}

// query tiles that see key tile kt (_window_q_range)
__device__ __forceinline__ Band q_tiles(int kt, int nq, int causal,
                                        int window) {
  Band r{0, nq};
  if (causal) r.lo = min(kt, nq);
  if (window > 0) {
    r.hi = max(0, min(r.hi, floordiv((kt + 1) * kTile + window - 2, kTile) + 1));
    if (!causal) r.lo = max(r.lo, floordiv(kt * kTile - window + 1, kTile));
  }
  return r;
}

// Split s of the band: ceil(n / split_tiles) pieces of equal length (the
// last may be shorter). False when the band has no split s.
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

__device__ __forceinline__ bool visible(int row, int col, int sk, int causal,
                                        int window) {
  return col < sk && (!causal || col <= row) &&
         (window <= 0 || (row - col < window && (causal || col - row < window)));
}

__device__ __forceinline__ bool live_row(float lse) {
  return lse > kNegInf * 0.5f;
}

// ---------------------------------------------------------------------------
// forward: bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads) fwd_split_mma(StreamArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;      // Q and K rows, in halves
  constexpr int LDV = kTile + 8;  // V^T rows
  constexpr int NT = kTile / 8;   // key n-tiles of S per warp
  constexpr int DT = DP / 8;      // dim n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile * LD;
  bf16* Vt = Ks + kTile * LD;

  const int qt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  const int sq = a.sq, sk = a.sk, d = a.d;
  int t0, t1;
  if (!split_of(k_tiles(qt, (sk + kTile - 1) / kTile, a.causal, a.window),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const int rowA = q0 + wr + g, rowB = rowA + 8;

  const bf16* qb = static_cast<const bf16*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  load_rows<DP, VEC>(Qs, LD, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  for (int j = t0; j < t1; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_rows<DP, VEC>(Ks, LD, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
    load_rows_t<DP, VEC>(Vt, LDV, vb + (long long)k0 * a.vs.s, a.vs.s,
                         sk - k0, d);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const bf16* qa = Qs + (wr + g) * LD + kk + tig * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kp = Ks + (nt * 8 + g) * LD + kk + tig * 2;
        mma_bf16(s[nt], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }

    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + tig * 2 + (i & 1);
        const int row = i < 2 ? rowA : rowB;
        s[nt][i] = visible(row, col, sk, a.causal, a.window)
                       ? s[nt][i] * a.scale
                       : kNegInf;
      }
      mxA = fmaxf(mxA, fmaxf(s[nt][0], s[nt][1]));
      mxB = fmaxf(mxB, fmaxf(s[nt][2], s[nt][3]));
    }
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 1));
    mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, 2));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 1));
    mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, 2));
    const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
    // nothing visible yet: keep p at 0 so l stays 0 (the reference's guard)
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
        const bf16* vp = Vt + (dt * 8 + g) * LDV + kt * 16 + tig * 2;
        mma_bf16(oacc[dt], a0, a1, a2, a3, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // the partial: unnormalised acc, m and l of this split
  const size_t base = ((size_t)split * a.bh + bh) * sq;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int row = i < 2 ? rowA : rowB;
      if (row < sq && col < d) a.acc[(base + row) * d + col] = oacc[dt][i];
    }
  }
  if (tig == 0) {
    if (rowA < sq) {
      a.m[base + rowA] = mA;
      a.l[base + rowA] = lA;
    }
    if (rowB < sq) {
      a.m[base + rowB] = mB;
      a.l[base + rowB] = lB;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: fp32 on FMA
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFma) fwd_split_fma(StreamArgs a) {
  extern __shared__ float smem[];
  const int sq = a.sq, sk = a.sk, d = a.d, dp = d + 1;
  float* Qs = smem;            // kTile x dp, pre-scaled
  float* Ks = Qs + kTile * dp;
  float* Vs = Ks + kTile * dp;  // kTile x d
  float* Ps = Vs + kTile * d;   // kTile x kPl

  const int qt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  int t0, t1;
  if (!split_of(k_tiles(qt, (sk + kTile - 1) / kTile, a.causal, a.window),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int qrow = q0 + r;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;

  for (int e = tid; e < kTile * d; e += kFma) {
    const int rr = e / d, cc = e - rr * d;
    const int qi = q0 + rr;
    Qs[rr * dp + cc] = qi < sq ? qb[(long long)qi * a.qs.s + cc] * a.scale : 0.f;
  }

  float acc[kDimMax / 4];
#pragma unroll
  for (int j = 0; j < kDimMax / 4; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int j = t0; j < t1; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    for (int e = tid; e < kTile * d; e += kFma) {
      const int rr = e / d, cc = e - rr * d;
      const int ki = k0 + rr;
      const bool in = ki < sk;
      Ks[rr * dp + cc] = in ? kb[(long long)ki * a.ks.s + cc] : 0.f;
      Vs[rr * d + cc] = in ? vb[(long long)ki * a.vs.s + cc] : 0.f;
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
      const int kpos = k0 + c4 + 4 * jj;
      s[jj] = visible(qrow, kpos, sk, a.causal, a.window) ? s[jj] : kNegInf;
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
      Ps[r * kPl + c4 + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same 4 lanes

#pragma unroll
    for (int jj = 0; jj < kDimMax / 4; ++jj) acc[jj] *= alpha;
    for (int c = 0; c < kTile; ++c) {
      const float p = Ps[r * kPl + c];
#pragma unroll
      for (int jj = 0; jj < kDimMax / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) acc[jj] = fmaf(p, Vs[c * d + col], acc[jj]);
      }
    }
  }

  if (qrow < sq) {
    const size_t at = ((size_t)split * a.bh + bh) * sq + qrow;
    float* arow = a.acc + at * d;
#pragma unroll
    for (int jj = 0; jj < kDimMax / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) arow[col] = acc[jj];
    }
    if (c4 == 0) {
      a.m[at] = m;
      a.l[at] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: the merge pass, one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMergeRows * 32)
    fwd_merge(StreamArgs a, T* __restrict__ o, float* __restrict__ lse) {
  const long long row = (long long)blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.bh * a.sq;
  if (row >= rows) return;
  const int d = a.d;
  const int qt = (int)(row % a.sq) / kTile;
  const Band band = k_tiles(qt, (a.sk + kTile - 1) / kTile, a.causal, a.window);
  const int ns = band.hi > band.lo
                     ? (band.hi - band.lo + a.split_tiles - 1) / a.split_tiles
                     : 0;
  int t0, t1;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s)
    if (split_of(band, s, a.split_tiles, t0, t1))
      mx = fmaxf(mx, a.m[s * rows + row]);
  float l = 0.f, acc[kDimMax / 32];
#pragma unroll
  for (int c = 0; c < kDimMax / 32; ++c) acc[c] = 0.f;
  for (int s = 0; s < ns; ++s) {
    if (!split_of(band, s, a.split_tiles, t0, t1)) continue;
    const float w = expf(a.m[s * rows + row] - mx);
    l += a.l[s * rows + row] * w;
    const float* part = a.acc + (s * rows + row) * d;
#pragma unroll
    for (int c = 0; c < kDimMax / 32; ++c) {
      const int col = lane + 32 * c;
      if (col < d) acc[c] += part[col] * w;
    }
  }
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
#pragma unroll
  for (int c = 0; c < kDimMax / 32; ++c) {
    const int col = lane + 32 * c;
    if (col < d) o[row * d + col] = from_f32<T>(acc[c] * inv);
  }
  if (lane == 0) lse[row] = mx + logf(l_safe);
}

// ---------------------------------------------------------------------------
// dQ: bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads) dq_split_mma(StreamArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;      // Q, dO, K, V rows, in halves
  constexpr int LDT = kTile + 8;  // K^T rows
  constexpr int NT = kTile / 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;
  bf16* Kt = Vs + kTile * LD;  // DP x LDT

  const int qt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  const int sq = a.sq, sk = a.sk, d = a.d;
  int t0, t1;
  if (!split_of(k_tiles(qt, (sk + kTile - 1) / kTile, a.causal, a.window),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const int rowA = q0 + wr + g, rowB = rowA + 8;

  const bf16* qb = static_cast<const bf16*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const bf16* ob =
      static_cast<const bf16*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_rows<DP, VEC>(Qs, LD, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);
  load_rows<DP, VEC>(dOs, LD, ob + (long long)q0 * a.dos.s, a.dos.s, sq - q0,
                     d);

  const size_t head = (size_t)bh * sq;
  const float lseA = rowA < sq ? a.lse[head + rowA] : kNegInf;
  const float lseB = rowB < sq ? a.lse[head + rowB] : kNegInf;
  const float dlA = rowA < sq ? a.delta[head + rowA] : 0.f;
  const float dlB = rowB < sq ? a.delta[head + rowB] : 0.f;
  const bool liveA = live_row(lseA), liveB = live_row(lseB);

  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int j = t0; j < t1; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_rows<DP, VEC>(Ks, LD, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
    load_rows<DP, VEC>(Vs, LD, vb + (long long)k0 * a.vs.s, a.vs.s, sk - k0, d);
    load_rows_t<DP, VEC>(Kt, LDT, kb + (long long)k0 * a.ks.s, a.ks.s,
                         sk - k0, d);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const bf16* qa = Qs + (wr + g) * LD + kk + tig * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
      const bf16* oa = dOs + (wr + g) * LD + kk + tig * 2;
      const uint32_t o0 = ld32(oa), o1 = ld32(oa + 8 * LD);
      const uint32_t o2 = ld32(oa + 8), o3 = ld32(oa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kp = Ks + (nt * 8 + g) * LD + kk + tig * 2;
        mma_bf16(s[nt], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
        const bf16* vp = Vs + (nt * 8 + g) * LD + kk + tig * 2;
        mma_bf16(dp[nt], o0, o1, o2, o3, ld32(vp), ld32(vp + 8));
      }
    }

    // dS = P * (dP - delta), in place of S
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + tig * 2 + (i & 1);
        const bool up = i < 2;
        const int row = up ? rowA : rowB;
        const bool valid =
            visible(row, col, sk, a.causal, a.window) && (up ? liveA : liveB);
        const float p =
            valid ? expf(s[nt][i] * a.scale - (up ? lseA : lseB)) : 0.f;
        s[nt][i] = p * (dp[nt][i] - (up ? dlA : dlB));
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kt = 0; kt < kTile / 16; ++kt) {
      const uint32_t a0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t a1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t a2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* kp = Kt + (dt * 8 + g) * LDT + kt * 16 + tig * 2;
        mma_bf16(dq[dt], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int row = i < 2 ? rowA : rowB;
      if (row < sq && col < d)
        atomicAdd(a.acc + (head + row) * d + col, dq[dt][i] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads) dkv_split_mma(StreamArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;
  constexpr int LDT = kTile + 8;  // Q^T, dO^T rows
  constexpr int NT = kTile / 8;   // query n-tiles of S^T / dP^T per warp
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* dOs = Qs + kTile * LD;
  bf16* Qt = dOs + kTile * LD;  // DP x LDT
  bf16* dOt = Qt + DP * LDT;
  float* lse_s = reinterpret_cast<float*>(dOt + DP * LDT);
  float* delta_s = lse_s + kTile;

  const int kt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  const int sq = a.sq, sk = a.sk, d = a.d;
  int t0, t1;
  if (!split_of(q_tiles(kt, (sq + kTile - 1) / kTile, a.causal, a.window),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const int keyA = k0 + wr + g, keyB = keyA + 8;

  const bf16* qb = static_cast<const bf16*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const bf16* ob =
      static_cast<const bf16*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_rows<DP, VEC>(Ks, LD, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
  load_rows<DP, VEC>(Vs, LD, vb + (long long)k0 * a.vs.s, a.vs.s, sk - k0, d);
  const size_t head = (size_t)bh * sq;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int qi = t0; qi < t1; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_rows<DP, VEC>(Qs, LD, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0,
                       d);
    load_rows_t<DP, VEC>(Qt, LDT, qb + (long long)q0 * a.qs.s, a.qs.s,
                         sq - q0, d);
    load_rows<DP, VEC>(dOs, LD, ob + (long long)q0 * a.dos.s, a.dos.s,
                       sq - q0, d);
    load_rows_t<DP, VEC>(dOt, LDT, ob + (long long)q0 * a.dos.s, a.dos.s,
                         sq - q0, d);
    for (int t = threadIdx.x; t < kTile; t += kMmaThreads) {
      const bool in = q0 + t < sq;
      lse_s[t] = in ? a.lse[head + q0 + t] : kNegInf;
      delta_s[t] = in ? a.delta[head + q0 + t] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const bf16* ka = Ks + (wr + g) * LD + kk + tig * 2;
      const uint32_t a0 = ld32(ka), a1 = ld32(ka + 8 * LD);
      const uint32_t a2 = ld32(ka + 8), a3 = ld32(ka + 8 * LD + 8);
      const bf16* va = Vs + (wr + g) * LD + kk + tig * 2;
      const uint32_t v0 = ld32(va), v1 = ld32(va + 8 * LD);
      const uint32_t v2 = ld32(va + 8), v3 = ld32(va + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* qp = Qs + (nt * 8 + g) * LD + kk + tig * 2;
        mma_bf16(s[nt], a0, a1, a2, a3, ld32(qp), ld32(qp + 8));
        const bf16* op = dOs + (nt * 8 + g) * LD + kk + tig * 2;
        mma_bf16(dp[nt], v0, v1, v2, v3, ld32(op), ld32(op + 8));
      }
    }

    // P^T in place of S^T, dS^T = P^T * (dP^T - delta) in place of dP^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + tig * 2 + (i & 1);
        const int qrow = q0 + qc;
        const int key = i < 2 ? keyA : keyB;
        const float l = lse_s[qc];
        const bool valid = qrow < sq &&
                           visible(qrow, key, sk, a.causal, a.window) &&
                           live_row(l);
        const float p = valid ? expf(s[nt][i] * a.scale - l) : 0.f;
        s[nt][i] = p;
        dp[nt][i] = p * (dp[nt][i] - delta_s[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int kt2 = 0; kt2 < kTile / 16; ++kt2) {
      const uint32_t p0 = pack_bf16(s[2 * kt2][0], s[2 * kt2][1]);
      const uint32_t p1 = pack_bf16(s[2 * kt2][2], s[2 * kt2][3]);
      const uint32_t p2 = pack_bf16(s[2 * kt2 + 1][0], s[2 * kt2 + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kt2 + 1][2], s[2 * kt2 + 1][3]);
      const uint32_t d0 = pack_bf16(dp[2 * kt2][0], dp[2 * kt2][1]);
      const uint32_t d1 = pack_bf16(dp[2 * kt2][2], dp[2 * kt2][3]);
      const uint32_t d2 = pack_bf16(dp[2 * kt2 + 1][0], dp[2 * kt2 + 1][1]);
      const uint32_t d3 = pack_bf16(dp[2 * kt2 + 1][2], dp[2 * kt2 + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int off = (dt * 8 + g) * LDT + kt2 * 16 + tig * 2;
        mma_bf16(dv[dt], p0, p1, p2, p3, ld32(dOt + off), ld32(dOt + off + 8));
        mma_bf16(dk[dt], d0, d1, d2, d3, ld32(Qt + off), ld32(Qt + off + 8));
      }
    }
  }

  const size_t khead = (size_t)bh * sk;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int key = i < 2 ? keyA : keyB;
      if (key < sk && col < d) {
        const size_t at = (khead + key) * d + col;
        atomicAdd(a.acc + at, dk[dt][i] * a.scale);
        atomicAdd(a.dv + at, dv[dt][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ and dK/dV: fp32 on FMA
// ---------------------------------------------------------------------------

// kTile x d fp32 tile into dst (row pitch d + 1), zero past rows_valid
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int rows_valid,
                                         int d) {
  const int dp = d + 1;
  for (int e = threadIdx.x; e < kTile * d; e += kFma) {
    const int r = e / d, c = e - r * d;
    dst[r * dp + c] = r < rows_valid ? src[r * stride + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kFma) dq_split_fma(StreamArgs a) {
  extern __shared__ float smf[];
  const int sq = a.sq, sk = a.sk, d = a.d, dp = d + 1;
  float* Qs = smf;
  float* dOs = Qs + kTile * dp;
  float* Ks = dOs + kTile * dp;
  float* Vs = Ks + kTile * dp;
  float* Ds = Vs + kTile * dp;  // kTile x kPl: dS

  const int qt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  int t0, t1;
  if (!split_of(k_tiles(qt, (sk + kTile - 1) / kTile, a.causal, a.window),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = qt * kTile;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int qrow = q0 + r;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const float* ob =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_f32(Qs, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);
  load_f32(dOs, ob + (long long)q0 * a.dos.s, a.dos.s, sq - q0, d);
  const size_t head = (size_t)bh * sq;
  const float l = qrow < sq ? a.lse[head + qrow] : kNegInf;
  const float dl = qrow < sq ? a.delta[head + qrow] : 0.f;
  const bool live = live_row(l);

  float acc[kDimMax / 4];
#pragma unroll
  for (int jj = 0; jj < kDimMax / 4; ++jj) acc[jj] = 0.f;

  for (int j = t0; j < t1; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_f32(Ks, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
    load_f32(Vs, vb + (long long)k0 * a.vs.s, a.vs.s, sk - k0, d);
    __syncthreads();
    float s[kTile / 4], dpv[kTile / 4];
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) s[jj] = dpv[jj] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float qv = Qs[r * dp + kk], ov = dOs[r * dp + kk];
#pragma unroll
      for (int jj = 0; jj < kTile / 4; ++jj) {
        const int c = c4 + 4 * jj;
        s[jj] = fmaf(qv, Ks[c * dp + kk], s[jj]);
        dpv[jj] = fmaf(ov, Vs[c * dp + kk], dpv[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int c = c4 + 4 * jj, kpos = k0 + c;
      const bool valid = visible(qrow, kpos, sk, a.causal, a.window) && live;
      const float p = valid ? expf(s[jj] * a.scale - l) : 0.f;
      Ds[r * kPl + c] = p * (dpv[jj] - dl);
    }
    __syncwarp();  // a row's dS is written and read by the same 4 lanes
    for (int c = 0; c < kTile; ++c) {
      const float ds = Ds[r * kPl + c];
#pragma unroll
      for (int jj = 0; jj < kDimMax / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) acc[jj] = fmaf(ds, Ks[c * dp + col], acc[jj]);
      }
    }
  }
  if (qrow < sq) {
    float* out = a.acc + (head + qrow) * d;
#pragma unroll
    for (int jj = 0; jj < kDimMax / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) atomicAdd(out + col, acc[jj] * a.scale);
    }
  }
}

__global__ void __launch_bounds__(kFma) dkv_split_fma(StreamArgs a) {
  extern __shared__ float smf[];
  const int sq = a.sq, sk = a.sk, d = a.d, dp = d + 1;
  float* Ks = smf;
  float* Vs = Ks + kTile * dp;
  float* Qs = Vs + kTile * dp;
  float* dOs = Qs + kTile * dp;
  float* Ps = dOs + kTile * dp;  // kTile x kPl: P^T
  float* Ds = Ps + kTile * kPl;  // dS^T
  float* lse_s = Ds + kTile * kPl;
  float* delta_s = lse_s + kTile;

  const int kt = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  int t0, t1;
  if (!split_of(q_tiles(kt, (sq + kTile - 1) / kTile, a.causal, a.window),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int k0 = kt * kTile;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int key = k0 + r;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const float* ob =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_f32(Ks, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
  load_f32(Vs, vb + (long long)k0 * a.vs.s, a.vs.s, sk - k0, d);
  const size_t head = (size_t)bh * sq;

  float dk[kDimMax / 4], dv[kDimMax / 4];
#pragma unroll
  for (int jj = 0; jj < kDimMax / 4; ++jj) dk[jj] = dv[jj] = 0.f;

  for (int qi = t0; qi < t1; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_f32(Qs, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);
    load_f32(dOs, ob + (long long)q0 * a.dos.s, a.dos.s, sq - q0, d);
    for (int t = threadIdx.x; t < kTile; t += kFma) {
      const bool in = q0 + t < sq;
      lse_s[t] = in ? a.lse[head + q0 + t] : kNegInf;
      delta_s[t] = in ? a.delta[head + q0 + t] : 0.f;
    }
    __syncthreads();
    float s[kTile / 4], dpv[kTile / 4];
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) s[jj] = dpv[jj] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float kv = Ks[r * dp + kk], vv = Vs[r * dp + kk];
#pragma unroll
      for (int jj = 0; jj < kTile / 4; ++jj) {
        const int c = c4 + 4 * jj;
        s[jj] = fmaf(kv, Qs[c * dp + kk], s[jj]);
        dpv[jj] = fmaf(vv, dOs[c * dp + kk], dpv[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTile / 4; ++jj) {
      const int c = c4 + 4 * jj, qrow = q0 + c;
      const float l = lse_s[c];
      const bool valid = qrow < sq &&
                         visible(qrow, key, sk, a.causal, a.window) &&
                         live_row(l);
      const float p = valid ? expf(s[jj] * a.scale - l) : 0.f;
      Ps[r * kPl + c] = p;
      Ds[r * kPl + c] = p * (dpv[jj] - delta_s[c]);
    }
    __syncwarp();  // a key row's P/dS are written and read by the same lanes
    for (int c = 0; c < kTile; ++c) {
      const float p = Ps[r * kPl + c], ds = Ds[r * kPl + c];
#pragma unroll
      for (int jj = 0; jj < kDimMax / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) {
          dv[jj] = fmaf(p, dOs[c * dp + col], dv[jj]);
          dk[jj] = fmaf(ds, Qs[c * dp + col], dk[jj]);
        }
      }
    }
  }
  if (key < sk) {
    const size_t at = ((size_t)bh * sk + key) * d;
#pragma unroll
    for (int jj = 0; jj < kDimMax / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) {
        atomicAdd(a.acc + at + col, dk[jj] * a.scale);
        atomicAdd(a.dv + at + col, dv[jj]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <auto Kernel>
int launch(const StreamArgs& a, dim3 grid, int threads, size_t smem,
           cudaStream_t stream) {
  const int err = set_max_smem<Kernel>(smem);
  if (err) return err;
  StreamArgs arg = a;
  void* params[] = {&arg};
  const cudaError_t launched = cudaLaunchKernel(
      reinterpret_cast<const void*>(Kernel), grid, dim3(threads), params,
      smem, stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <int DP, bool VEC>
int launch_mma(Pass pass, const StreamArgs& a, dim3 grid,
               cudaStream_t stream) {
  constexpr size_t rows = sizeof(__nv_bfloat16) * kTile * (DP + 8);
  constexpr size_t trans = sizeof(__nv_bfloat16) * DP * (kTile + 8);
  if (pass == kFwd)
    return launch<fwd_split_mma<DP, VEC>>(a, grid, kMmaThreads,
                                          2 * rows + trans, stream);
  if (pass == kDq)
    return launch<dq_split_mma<DP, VEC>>(a, grid, kMmaThreads,
                                         4 * rows + trans, stream);
  return launch<dkv_split_mma<DP, VEC>>(
      a, grid, kMmaThreads, 4 * rows + 2 * trans + 2 * kTile * sizeof(float),
      stream);
}

// The split pass of `pass` over grid (outer tiles, nsplit, b*h).
int launch_split(Pass pass, const StreamArgs& a, int nsplit, int dtype,
                 cudaStream_t stream) {
  const int outer = pass == kDkv ? a.sk : a.sq;
  const dim3 grid((outer + kTile - 1) / kTile, nsplit, a.bh);
  if (dtype == kF32) {
    const size_t tile = sizeof(float) * kTile * (a.d + 1);
    const size_t ptile = sizeof(float) * kTile * kPl;
    if (pass == kFwd)
      return launch<fwd_split_fma>(
          a, grid, kFma, 2 * tile + sizeof(float) * kTile * a.d + ptile,
          stream);
    if (pass == kDq)
      return launch<dq_split_fma>(a, grid, kFma, 4 * tile + ptile, stream);
    return launch<dkv_split_fma>(
        a, grid, kFma, 4 * tile + 2 * ptile + 2 * kTile * sizeof(float),
        stream);
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  bool vec = vec_ok(a.d, a.q, a.qs) && vec_ok(a.d, a.k, a.ks) &&
             vec_ok(a.d, a.v, a.vs);
  if (pass != kFwd) vec = vec && vec_ok(a.d, a.dout, a.dos);
  if (a.d <= 64)
    return vec ? launch_mma<64, true>(pass, a, grid, stream)
               : launch_mma<64, false>(pass, a, grid, stream);
  return vec ? launch_mma<128, true>(pass, a, grid, stream)
             : launch_mma<128, false>(pass, a, grid, stream);
}

bool args_ok(int b, int h, int sq, int sk, int d, int split_tiles,
             int nsplit) {
  return d >= 1 && d <= kDimMax && b >= 1 && h >= 1 && sq >= 1 && sk >= 1 &&
         split_tiles >= 1 && nsplit >= 0 && nsplit <= 65535 &&
         (long long)b * h <= 65535;
}

StreamArgs make_args(const void* q, const void* k, const void* v, int b,
                     int h, int sq, int sk, int d, float scale, int causal,
                     int window, int split_tiles) {
  StreamArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.h = h;
  a.bh = b * h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.split_tiles = split_tiles;
  return a;
}

}  // namespace
}  // namespace apex_torch

using namespace apex_torch;

// Forward: the split pass, then the merge. q/k/v strides in elements,
// (batch, head, seq) each, head_dim stride 1. acc (nsplit, b*h, sq, d) and
// m, l (nsplit, b*h, sq) are fp32 workspaces; o contiguous (b, h, sq, d) in
// q's dtype, lse contiguous (b, h, sq) fp32. window <= 0: none. nsplit: the
// most splits any q tile's band has (the wrapper computes it).
extern "C" int apex_flash_fwd_stream(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    void* o, void* lse, int b, int h, int sq, int sk, int d, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    int window, int split_tiles, int nsplit, int dtype, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit))
    return (int)cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  StreamArgs a = make_args(q, k, v, b, h, sq, sk, d, scale, causal, window,
                           split_tiles);
  a.qs = Strides{qsb, qsh, qss};
  a.ks = Strides{ksb, ksh, kss};
  a.vs = Strides{vsb, vsh, vss};
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  cudaStream_t s = (cudaStream_t)stream;
  if (nsplit > 0) {
    const int err = launch_split(kFwd, a, nsplit, dtype, s);
    if (err) return err;
  }
  const long long rows = (long long)b * h * sq;
  const dim3 grid((unsigned)((rows + kMergeRows - 1) / kMergeRows));
  if (dtype == kF32)
    fwd_merge<float><<<grid, kMergeRows * 32, 0, s>>>(a, (float*)o,
                                                     (float*)lse);
  else
    fwd_merge<__nv_bfloat16><<<grid, kMergeRows * 32, 0, s>>>(
        a, (__nv_bfloat16*)o, (float*)lse);
  return (int)cudaGetLastError();
}

// dQ: adds into dq_acc, fp32 contiguous (b, h, sq, d), which the caller
// zeroed. q/k/v/dout strides as above; lse/delta contiguous (b, h, sq).
extern "C" int apex_flash_bwd_dq_stream(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, int b, int h, int sq,
    int sk, int d, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal,
    int window, int split_tiles, int nsplit, int dtype, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit))
    return (int)cudaErrorInvalidValue;
  StreamArgs a = make_args(q, k, v, b, h, sq, sk, d, scale, causal, window,
                           split_tiles);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.acc = static_cast<float*>(dq_acc);
  a.qs = Strides{qsb, qsh, qss};
  a.ks = Strides{ksb, ksh, kss};
  a.vs = Strides{vsb, vsh, vss};
  a.dos = Strides{osb, osh, oss};
  if (nsplit == 0) return 0;  // no query sees a key: dQ stays 0
  return launch_split(kDq, a, nsplit, dtype, (cudaStream_t)stream);
}

// dK/dV: add into dk_acc and dv_acc, fp32 contiguous (b, h, sk, d), which
// the caller zeroed; other arguments as above.
extern "C" int apex_flash_bwd_dkv_stream(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk_acc, void* dv_acc, int b,
    int h, int sq, int sk, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, int split_tiles, int nsplit, int dtype,
    void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit))
    return (int)cudaErrorInvalidValue;
  StreamArgs a = make_args(q, k, v, b, h, sq, sk, d, scale, causal, window,
                           split_tiles);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.acc = static_cast<float*>(dk_acc);
  a.dv = static_cast<float*>(dv_acc);
  a.qs = Strides{qsb, qsh, qss};
  a.ks = Strides{ksb, ksh, kss};
  a.vs = Strides{vsb, vsh, vss};
  a.dos = Strides{osb, osh, oss};
  if (nsplit == 0) return 0;
  return launch_split(kDkv, a, nsplit, dtype, (cudaStream_t)stream);
}
