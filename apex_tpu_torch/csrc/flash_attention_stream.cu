// Streamed flash attention for Hopper: a split-K/V forward with its merge
// pass, a split-K/V dQ pass and a split-Q dK/dV pass.
//
// Replaces: apex_tpu/ops/flash_attention.py _fwd_kernel_stream (pallas_call
// in _flash_fwd_stream, :992), _bwd_dq_kernel_stream (pallas_call in
// _flash_bwd_stream, :1101) and _bwd_dkv_kernel_stream (:1172). They
// compute what the resident kernels compute -- O = softmax(scale Q K^T) V
// with the fp32 lse, then dQ = scale dS K and dK = scale dS^T Q,
// dV = P^T dO from P = exp(scale S - lse), dS = P (dO V^T - delta) -- under
// the causal mask (key k visible to query q iff k <= q) and/or the sliding
// window (keys [q-w+1, q] causal, [q-w+1, q+w-1] not: _apply_pos_masks).
// A row with no visible key adds exactly 0.
//
// On the TPU the streamed kernels put the K/V (or Q) loop in the grid and
// carry acc/m/l, or the dQ/dK/dV sums, in VMEM scratch from one sequential
// trip to the next; the window shrinks the grid to the band (_window_grid).
// Hopper's blocks run in parallel and carry nothing between them, so here
// the loop is SPLIT ACROSS CTAs: every CTA owns one outer tile and one split
// of the inner tiles the causal limit and the window leave it (k_tiles /
// q_tiles: _window_k_range / _window_q_range), at most `split_tiles` of
// them; tiles outside the band are never visited, so a window costs O(s w).
// - forward (64-row tiles both ways): each CTA runs the online softmax over
//   its split and writes an fp32 partial (unnormalised acc, m, l); fwd_merge
//   combines a row's partials, m* = max m_i, l* = sum l_i e^(m_i - m*),
//   o = sum acc_i e^(m_i - m*) / l*, lse = m* + log l* (the _combine of
//   transformer/ring.py:64-68). A row with no visible key ends with l* = 0:
//   o = 0 exactly, lse = -1e30. bf16 on mma.sync m16n8k16, fp32 on FMA.
// - dQ and dK/dV: each CTA adds its split's fp32 partial into zeroed fp32
//   accumulators by atomics (no partial buffers, no reduction pass; the
//   order of addition changes from run to run, within fp32 rounding). The
//   wrapper zeroes them before and casts them to q's dtype after.
//
// Bound on this card: operations -- 2 products of 2 d FLOPs per visible
// pair forward, 3 for dQ and 4 for dK/dV (7 for the backward pair), against
// 4-6 (s, d) operands moved once.
//
// The bf16 backward (dq_wgmma, dkv_wgmma) is built for Hopper's tensor
// cores. A CTA of three warpgroups keeps kOuter = 128 rows of one side
// (queries for dQ, keys for dK/dV) and streams kInner = 64-row tiles of the
// other through a kStages-deep ring in shared memory: warp 8 (the producer,
// its registers handed to the consumers with setmaxnreg) starts the TMA
// loads, mbarriers signal arrival and free slots, and warpgroups 0 and 1
// (64 rows each) run wgmma on what has arrived. What this does about each
// limit of the first (mma.sync) version:
// 1. Loads overlap compute: TMA fills the ring while the consumers work; no
//    thread copies a tile and no block-wide barrier waits for one.
// 2. No transposed copy: S^T = K Q^T and dP^T = V dO^T (dK/dV), S = Q K^T and
//    dP = dO V^T (dQ) read both operands K-major; dV += P^T dO, dK += dS^T Q
//    and dQ += dS K read the streamed tile as it lies, through the
//    descriptor's transpose (an MN-major B, allowed for 16-bit types).
// 3. Operands come from shared memory through wgmma descriptors over
//    128-byte-swizzled tiles (the layout TMA writes), and P / dS go from the
//    accumulator registers straight into register A fragments.
// 4. Masks only where a block needs them: a (64-row, 64-row) block with
//    every pair visible runs an instance of the score loop with no test;
//    edge blocks (the diagonal, a window edge, the ragged end) run the one
//    that tests each score. exp2 with scale log2(e) folded in, lse log2(e)
//    per row; a row with no visible key carries lse = +inf, so its P is
//    exactly 0 with no test.
// 5. Bigger CTAs: 128 resident rows against a 64-row stream, each split up
//    to split_tiles = 128 streamed tiles (tuned on the card: PERF.md).
// The split's partial goes out by vectorised atomics (float2 atomicAdd).
// q/k/v/dO are read by TMA as (b, h, s, d) tensor maps, so strided views
// (the fused-QKV heads) go in without a copy; where TMA cannot read a tensor
// (a base or stride not 16-byte aligned, d % 8 != 0) the wrapper passes a
// contiguous copy with d padded to a multiple of 8. Any sq, sk and
// d <= 128 (64 or 128 in the kernels, zeros past d). fp32 keeps the FMA
// kernels (dq_split_fma, dkv_split_fma) with 64-row tiles both ways.

#include "common.cuh"
#include "hopper.cuh"

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
  int lo, hi;  // [lo, hi) of tiles
};

// key tiles (bk rows) that query tile qt (bq rows) sees: the causal limit,
// then the window (_window_k_range with no ring offsets)
__device__ __forceinline__ Band k_tiles(int qt, int nk, int causal,
                                        int window, int bq = kTile,
                                        int bk = kTile) {
  Band r{0, nk};
  if (causal) r.hi = min(r.hi, ((qt + 1) * bq + bk - 1) / bk);
  if (window > 0) {
    r.lo = max(r.lo, floordiv(qt * bq - window + 1, bk));
    if (!causal)
      r.hi = max(0, min(r.hi, floordiv((qt + 1) * bq + window - 2, bk) + 1));
  }
  return r;
}

// query tiles (bq rows) that see key tile kt (bk rows) (_window_q_range)
__device__ __forceinline__ Band q_tiles(int kt, int nq, int causal,
                                        int window, int bq = kTile,
                                        int bk = kTile) {
  Band r{0, nq};
  if (causal) r.lo = min(kt * bk / bq, nq);
  if (window > 0) {
    r.hi = max(0, min(r.hi, floordiv((kt + 1) * bk + window - 2, bq) + 1));
    if (!causal) r.lo = max(r.lo, floordiv(kt * bk - window + 1, bq));
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
// dQ and dK/dV in bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kOuter = 128;   // rows a CTA keeps: queries (dQ), keys (dK/dV)
constexpr int kInner = 64;    // rows of a streamed tile
constexpr int kStages = 3;    // depth of the ring
constexpr int kWg = 128;      // threads of a warpgroup
constexpr int kBwdThreads = 3 * kWg;  // two consumers, then the producer's
constexpr int kRowBytes = 128;        // a swizzled row: 64 bf16
constexpr int kKStep = 16 * kRowBytes;  // 16 rows: one k16 step of MN-major B
constexpr float kLog2e = 1.4426950408889634f;

struct BwdMaps {
  CUtensorMap q, k, v, dout;  // encode_rows_map: 64 x 64 boxes
};

struct BwdArgs {
  const float* lse;    // (b*h, sq) contiguous
  const float* delta;  // (b*h, sq) contiguous
  float* acc;          // dQ, or dK
  float* dv;
  int h, sq, sk, d;
  uint32_t qpos, kpos, vpos, opos;  // coordinate placement of each map
  float scale;
  int causal, window, split_tiles;
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

// TMA of rows [r0, r0 + R) x all DP columns of one head into a tile of R
// rows: 64-column chunks one after another, 64-row boxes.
template <int DP, int R>
__device__ __forceinline__ void tma_rows(unsigned char* dst,
                                         const CUtensorMap* map, uint32_t pos,
                                         uint64_t* bar, int r0, int hi,
                                         int bi) {
  const int ps = pos & 3, ph = (pos >> 2) & 3;
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int rb = 0; rb < R / 64; ++rb) {
      const int row = r0 + rb * 64;
      const int x1 = ps == 1 ? row : ph == 1 ? hi : bi;
      const int x2 = ps == 2 ? row : ph == 2 ? hi : bi;
      const int x3 = ps == 3 ? row : ph == 3 ? hi : bi;
      hopper::tma_load_4d(dst + (c * R + rb * 64) * kRowBytes, map, bar,
                          c * 64, x1, x2, x3);
    }
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
// tile whose 64-column chunks lie kInner rows apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return hopper::sw128_desc(tile + kk * kKStep, kInner * kRowBytes, 1024);
}

// Whether every pair of a 64-query x 64-key block is visible: an interior
// block, whose scores need no test. Edge blocks (the diagonal, a window
// edge, the ragged end) test each score. Queries past sq need no test:
// their Q and dO rows are TMA's zero fill, so they add 0.
__device__ __forceinline__ bool interior(int qa, int ka, int sk, int causal,
                                         int window) {
  const int qb = qa + 63, kb = ka + 63;
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

// 64 x 64 scores of a warpgroup's 64 rows against a tile's 64 rows:
// S = A B^T over DP columns, both operands K-major in shared memory
template <int DP, int RA>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile,
                                       int a_row, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    hopper::wgmma_ss_n64(s, kmajor<RA>(a_tile, a_row, kk),
                         kmajor<kInner>(b_tile, 0, kk), kk > 0);
}

// P^T and dS^T of a 64-key x 64-query block, in place of S^T and dP^T:
// element i of the accumulators is key key0 + 8 ((i/2)%2), query
// q + 8 (i/4) + i%2; lse and delta of the tile's queries in `stats`.
// kMask: the block is an edge block (the diagonal, a window edge, the
// ragged end), so each pair is tested; interior blocks skip the test.
template <bool kMask>
__device__ __forceinline__ void dkv_probs(float (&st)[32], float (&dp)[32],
                                          const float* stats, float c, int q,
                                          int key0, const BwdArgs& a) {
  const int qc = q % kInner;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lj = *reinterpret_cast<const float2*>(stats + 8 * j + qc);
    const float2 dj =
        *reinterpret_cast<const float2*>(stats + kInner + 8 * j + qc);
    const float l[2] = {lse2_of(lj.x), lse2_of(lj.y)};
    const float dl[2] = {dj.x, dj.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = hopper::fast_exp2(fmaf(st[i], c, -l[e & 1]));
      if (kMask && !visible(q + 8 * j + (e & 1), key0 + 8 * (e >> 1), a.sk,
                            a.causal, a.window))
        p = 0.f;
      st[i] = p;
      dp[i] = p * (dp[i] - dl[e & 1]);
    }
  }
}

// dS of a 64-query x 64-key block in place of dP: element i is query
// row + 8 ((i/2)%2), key col + 8 (i/4) + i%2; l2 / dl: the base-2 lse and
// the delta of the thread's two rows
template <bool kMask>
__device__ __forceinline__ void dq_probs(float (&dp)[32],
                                         const float (&st)[32],
                                         const float (&l2)[2],
                                         const float (&dl)[2], float c,
                                         int row, int col,
                                         const BwdArgs& a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hf = (i >> 1) & 1;
    float p = hopper::fast_exp2(fmaf(st[i], c, -l2[hf]));
    if (kMask && !visible(row + 8 * hf, col + 8 * (i >> 2) + (i & 1), a.sk,
                          a.causal, a.window))
      p = 0.f;
    dp[i] = p * (dp[i] - dl[hf]);
  }
}

// The 64 x 64 fp32 product x as bf16 register A fragments, one per k16
// slice of its columns
__device__ __forceinline__ void fragments(uint32_t (&f)[4][4],
                                          const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc (64 x DP) += X Y over the tile's 64 rows: X as register fragments,
// Y the streamed tile as an MN-major B
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 2],
                                           const uint32_t (&f)[4][4],
                                           uint32_t y_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tb<DP>(acc, f[kk], mnmajor(y_tile, kk));
}

// A consumer warpgroup's loop over the nt tiles of its split.
// start(st, dp, n) waits for tile n and starts its two score products as
// one commit group; finish(st, dp, n) turns the scores into the tile's
// contributions and starts their products; release(n) frees tile n's
// stage once they are done. The products run on every tile, masked
// or not, and each group is waited for in straight-line code: a wgmma
// group kept in flight across a branch makes ptxas serialise them.
template <class Start, class Finish, class Release>
__device__ __forceinline__ void consume(int nt, Start start, Finish finish,
                                        Release release) {
  for (int n = 0; n < nt; ++n) {
    float st[32], dp[32];
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

// dK/dV: one CTA keeps 128 keys (K and V, loaded once) and streams the
// query tiles of its split (Q, dO, lse, delta) through the ring. Warpgroups
// 0 and 1 own 64 keys each: S^T = K Q^T and dP^T = V dO^T, then
// P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta) in
// registers, and dV += P^T dO, dK += dS^T Q with Q and dO read through the
// descriptor as MN-major B -- no transposed copy. Warp 8 starts the TMA
// loads and the cp.async copies of the row statistics.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dkv_wgmma(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using L = BwdLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* stats = reinterpret_cast<float*>(base + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_ready = empty + kStages;

  const int bh = blockIdx.x, kt = blockIdx.y, split = blockIdx.z;
  int t0, t1;
  if (!split_of(q_tiles(kt, (a.sq + kInner - 1) / kInner, a.causal, a.window,
                        kInner, kOuter),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int k0 = kt * kOuter;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA's, each lane's copies
      hopper::mbar_init(&empty[s], 8);      // each consumer warp
    }
    hopper::mbar_init(kv_ready, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x >= 2 * kWg + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::mbar_arrive_tx(kv_ready, 2 * L::kOuterBytes);
      tma_rows<DP, kOuter>(base, &maps.k, a.kpos, kv_ready, k0, hi, bi);
      tma_rows<DP, kOuter>(base + L::kOuterBytes, &maps.v, a.vpos, kv_ready,
                           k0, hi, bi);
    }
    const float* lse = a.lse + (size_t)bh * a.sq;
    const float* delta = a.delta + (size_t)bh * a.sq;
    for (int i = t0; i < t1; ++i) {
      const int n = i - t0, s = n % kStages, q0 = i * kInner;
      hopper::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
      unsigned char* qs = base + L::kRing + s * 2 * L::kInnerBytes;
      if (lane == 0) {
        hopper::mbar_arrive_tx(&full[s], 2 * L::kInnerBytes);
        tma_rows<DP, kInner>(qs, &maps.q, a.qpos, &full[s], q0, hi, bi);
        tma_rows<DP, kInner>(qs + L::kInnerBytes, &maps.dout, a.opos,
                             &full[s], q0, hi, bi);
      }
      copy_stats(stats + s * 2 * kInner, lse, delta, q0, kInner, a.sq,
                 &full[s]);
    }
    hopper::cp_async_wait_all();
    return;
  }

  hopper::regs_alloc<240>();
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int kw = k0 + wg * 64;                  // this warpgroup's keys
  const int key0 = kw + warp * 16 + lane / 4;   // keys of d[i]: + 8 ((i/2)%2)
  const int qcol = 2 * (lane % 4);              // + 8 (i/4) + i%2
  const float c = a.scale * kLog2e;
  const uint32_t ks = hopper::smem_u32(base), vs = ks + L::kOuterBytes;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  hopper::mbar_wait(kv_ready, 0);

  const uint32_t ring = hopper::smem_u32(base + L::kRing);
  auto start = [&](float (&st)[32], float (&dp)[32], int n) {
    const int s = n % kStages;
    hopper::mbar_wait(&full[s], (n / kStages) & 1);
    const uint32_t qs = ring + s * 2 * L::kInnerBytes;
    hopper::wgmma_fence();
    scores<DP, kOuter>(st, ks, wg * 64, qs);
    scores<DP, kOuter>(dp, vs, wg * 64, qs + L::kInnerBytes);
    hopper::wgmma_commit();
  };
  auto finish = [&](float (&st)[32], float (&dp)[32], int n) {
    const int s = n % kStages, q0 = (t0 + n) * kInner;
    const float* l2 = stats + s * 2 * kInner;
    if (interior(q0, kw, a.sk, a.causal, a.window))
      dkv_probs<false>(st, dp, l2, c, q0 + qcol, key0, a);
    else
      dkv_probs<true>(st, dp, l2, c, q0 + qcol, key0, a);
    uint32_t pf[4][4], sf[4][4];
    fragments(pf, st);
    fragments(sf, dp);
    const uint32_t qs = ring + s * 2 * L::kInnerBytes;
    hopper::wgmma_fence();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    accumulate<DP>(dv, pf, qs + L::kInnerBytes);
    accumulate<DP>(dk, sf, qs);
  };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[n % kStages]);
  };
  consume(t1 - t0, start, finish, release);
  hopper::fence_regs(dv);
  hopper::fence_regs(dk);

  // vectorised reduce-add of the split's fp32 partial
  const size_t khead = (size_t)bh * a.sk;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + qcol;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + 8 * hf, idx = 4 * j + 2 * hf;
      if (key < a.sk && col < a.d) {
        const size_t at = (khead + key) * a.d + col;
        atomicAdd(reinterpret_cast<float2*>(a.acc + at),
                  make_float2(dk[idx] * a.scale, dk[idx + 1] * a.scale));
        atomicAdd(reinterpret_cast<float2*>(a.dv + at),
                  make_float2(dv[idx], dv[idx + 1]));
      }
    }
  }
}

// dQ: one CTA keeps 128 queries (Q, dO, lse, delta, loaded once) and
// streams the key tiles of its split (K, V) through the ring. Warpgroups 0
// and 1 own 64 queries each: S = Q K^T and dP = dO V^T, then P and
// dS = P (dP - delta) in registers, and dQ += dS K with K read through the
// descriptor as MN-major B.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dq_wgmma(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using L = BwdLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* stats = reinterpret_cast<float*>(base + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_ready = empty + kStages;

  const int n_outer = (a.sq + kOuter - 1) / kOuter;
  const int bh = blockIdx.x, split = blockIdx.z;
  const int qt = n_outer - 1 - (int)blockIdx.y;  // causal: longest band first
  int t0, t1;
  if (!split_of(k_tiles(qt, (a.sk + kInner - 1) / kInner, a.causal, a.window,
                        kOuter, kInner),
                split, a.split_tiles, t0, t1))
    return;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  const int q0 = qt * kOuter;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init(q_ready, 1 + 32);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x >= 2 * kWg + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::mbar_arrive_tx(q_ready, 2 * L::kOuterBytes);
      tma_rows<DP, kOuter>(base, &maps.q, a.qpos, q_ready, q0, hi, bi);
      tma_rows<DP, kOuter>(base + L::kOuterBytes, &maps.dout, a.opos,
                           q_ready, q0, hi, bi);
    }
    const float* lse = a.lse + (size_t)bh * a.sq;
    const float* delta = a.delta + (size_t)bh * a.sq;
    copy_stats(stats, lse, delta, q0, kOuter, a.sq, q_ready);
    hopper::cp_async_wait_all();
    if (lane != 0) return;
    for (int i = t0; i < t1; ++i) {
      const int n = i - t0, s = n % kStages;
      hopper::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
      unsigned char* ks = base + L::kRing + s * 2 * L::kInnerBytes;
      hopper::mbar_arrive_tx(&full[s], 2 * L::kInnerBytes);
      tma_rows<DP, kInner>(ks, &maps.k, a.kpos, &full[s], i * kInner, hi, bi);
      tma_rows<DP, kInner>(ks + L::kInnerBytes, &maps.v, a.vpos, &full[s],
                           i * kInner, hi, bi);
    }
    return;
  }

  hopper::regs_alloc<240>();
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int qw = q0 + wg * 64;                  // this warpgroup's queries
  const int r0 = warp * 16 + lane / 4;          // rows of d[i]: + 8 ((i/2)%2)
  const int kcol = 2 * (lane % 4);              // + 8 (i/4) + i%2
  const float c = a.scale * kLog2e;
  const uint32_t qs = hopper::smem_u32(base), os = qs + L::kOuterBytes;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  hopper::mbar_wait(q_ready, 0);
  const int ra = wg * 64 + r0;
  const float l2[2] = {lse2_of(stats[ra]), lse2_of(stats[ra + 8])};
  const float dl[2] = {stats[kOuter + ra], stats[kOuter + ra + 8]};

  const uint32_t ring = hopper::smem_u32(base + L::kRing);
  auto start = [&](float (&st)[32], float (&dp)[32], int n) {
    const int s = n % kStages;
    hopper::mbar_wait(&full[s], (n / kStages) & 1);
    const uint32_t ks = ring + s * 2 * L::kInnerBytes;
    hopper::wgmma_fence();
    scores<DP, kOuter>(st, qs, wg * 64, ks);
    scores<DP, kOuter>(dp, os, wg * 64, ks + L::kInnerBytes);
    hopper::wgmma_commit();
  };
  auto finish = [&](float (&st)[32], float (&dp)[32], int n) {
    const int k0 = (t0 + n) * kInner;
    if (interior(qw, k0, a.sk, a.causal, a.window))
      dq_probs<false>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
    else
      dq_probs<true>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
    uint32_t sf[4][4];
    fragments(sf, dp);
    hopper::wgmma_fence();
    hopper::fence_regs(dq);
    accumulate<DP>(dq, sf, ring + (n % kStages) * 2 * L::kInnerBytes);
  };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[n % kStages]);
  };
  consume(t1 - t0, start, finish, release);
  hopper::fence_regs(dq);

  const size_t head = (size_t)bh * a.sq;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + kcol;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = qw + r0 + 8 * hf, idx = 4 * j + 2 * hf;
      if (row < a.sq && col < a.d)
        atomicAdd(reinterpret_cast<float2*>(a.acc + (head + row) * a.d + col),
                  make_float2(dq[idx] * a.scale, dq[idx + 1] * a.scale));
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
int launch_fwd_mma(const StreamArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr size_t rows = sizeof(__nv_bfloat16) * kTile * (DP + 8);
  constexpr size_t trans = sizeof(__nv_bfloat16) * DP * (kTile + 8);
  return launch<fwd_split_mma<DP, VEC>>(a, grid, kMmaThreads,
                                        2 * rows + trans, stream);
}

// The split pass of `pass` over grid (outer tiles, nsplit, b*h): the
// forward in both types, dQ and dK/dV in fp32.
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
  if (dtype != kBF16 || pass != kFwd) return (int)cudaErrorInvalidValue;
  const bool vec = vec_ok(a.d, a.q, a.qs) && vec_ok(a.d, a.k, a.ks) &&
                   vec_ok(a.d, a.v, a.vs);
  if (a.d <= 64)
    return vec ? launch_fwd_mma<64, true>(a, grid, stream)
               : launch_fwd_mma<64, false>(a, grid, stream);
  return vec ? launch_fwd_mma<128, true>(a, grid, stream)
             : launch_fwd_mma<128, false>(a, grid, stream);
}

// bf16 dQ or dK/dV over grid (b*h, outer tiles, nsplit): the four tensor
// maps, then the kernel of the padded head_dim.
template <int DP>
int launch_bwd_dp(Pass pass, const BwdMaps& maps, const BwdArgs& a, int bh,
                  int nsplit, cudaStream_t stream) {
  constexpr size_t smem = BwdLayout<DP>::kBytes;
  const int outer = pass == kDkv ? a.sk : a.sq;
  const dim3 grid(bh, (outer + kOuter - 1) / kOuter, nsplit);
  int err;
  if (pass == kDq) {
    err = set_max_smem<dq_wgmma<DP>>(smem);
    if (err) return err;
    dq_wgmma<DP><<<grid, kBwdThreads, smem, stream>>>(maps, a);
  } else {
    err = set_max_smem<dkv_wgmma<DP>>(smem);
    if (err) return err;
    dkv_wgmma<DP><<<grid, kBwdThreads, smem, stream>>>(maps, a);
  }
  return (int)cudaGetLastError();
}

int launch_bwd(Pass pass, const StreamArgs& s, int b, int nsplit,
               cudaStream_t stream) {
  BwdMaps maps;
  BwdArgs a{};
  int err = 0;
  const int h = s.h;
  if (!err) err = encode_rows_map(&maps.q, &a.qpos, s.q, b, h, s.sq, s.d,
                                  s.qs.b, s.qs.h, s.qs.s);
  if (!err) err = encode_rows_map(&maps.k, &a.kpos, s.k, b, h, s.sk, s.d,
                                  s.ks.b, s.ks.h, s.ks.s);
  if (!err) err = encode_rows_map(&maps.v, &a.vpos, s.v, b, h, s.sk, s.d,
                                  s.vs.b, s.vs.h, s.vs.s);
  if (!err) err = encode_rows_map(&maps.dout, &a.opos, s.dout, b, h, s.sq,
                                  s.d, s.dos.b, s.dos.h, s.dos.s);
  if (err) return err;
  a.lse = s.lse;
  a.delta = s.delta;
  a.acc = s.acc;
  a.dv = s.dv;
  a.h = h;
  a.sq = s.sq;
  a.sk = s.sk;
  a.d = s.d;
  a.scale = s.scale;
  a.causal = s.causal;
  a.window = s.window;
  a.split_tiles = s.split_tiles;
  return s.d <= 64 ? launch_bwd_dp<64>(pass, maps, a, s.bh, nsplit, stream)
                   : launch_bwd_dp<128>(pass, maps, a, s.bh, nsplit, stream);
}

// The backward's tiles as the wrapper sees them (outer rows kept, inner rows
// streamed): bf16 takes kOuter / kInner, fp32 kTile / kTile.
bool bwd_tiles_ok(int dtype, int outer_tile, int inner_tile) {
  if (dtype == kBF16) return outer_tile == kOuter && inner_tile == kInner;
  return dtype == kF32 && outer_tile == kTile && inner_tile == kTile;
}

int launch_bwd_pass(Pass pass, const StreamArgs& a, int b, int nsplit,
                    int dtype, cudaStream_t stream) {
  if (nsplit == 0) return 0;  // no query sees a key: the sums stay 0
  if (dtype == kBF16) return launch_bwd(pass, a, b, nsplit, stream);
  return launch_split(pass, a, nsplit, dtype, stream);
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
// outer_tile / inner_tile: the rows a CTA keeps and streams, as the wrapper
// computed nsplit with them (bf16: kOuter / kInner; fp32: kTile / kTile).
// bf16 reads q/k/v/dout by TMA: 16-byte-aligned bases and strides, d % 8 == 0.
extern "C" int apex_flash_bwd_dq_stream(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, int b, int h, int sq,
    int sk, int d, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal,
    int window, int outer_tile, int inner_tile, int split_tiles, int nsplit,
    int dtype, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit) ||
      !bwd_tiles_ok(dtype, outer_tile, inner_tile))
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
  return launch_bwd_pass(kDq, a, b, nsplit, dtype, (cudaStream_t)stream);
}

// dK/dV: add into dk_acc and dv_acc, fp32 contiguous (b, h, sk, d), which
// the caller zeroed; other arguments as above.
extern "C" int apex_flash_bwd_dkv_stream(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk_acc, void* dv_acc, int b,
    int h, int sq, int sk, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, int outer_tile, int inner_tile, int split_tiles,
    int nsplit, int dtype, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit) ||
      !bwd_tiles_ok(dtype, outer_tile, inner_tile))
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
  return launch_bwd_pass(kDkv, a, b, nsplit, dtype, (cudaStream_t)stream);
}
