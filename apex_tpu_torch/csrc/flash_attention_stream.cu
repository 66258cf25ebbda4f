// Streamed flash attention for Hopper: a split-K/V forward with its merge
// pass, a split-K/V dQ pass and a split-Q dK/dV pass.
//
// Replaces: apex_tpu/ops/flash_attention.py _fwd_kernel_stream (pallas_call
// in _flash_fwd_stream, :992), and in bf16 _bwd_dq_kernel_stream
// (pallas_call in _flash_bwd_stream, :1101) and _bwd_dkv_kernel_stream
// (:1172); in fp32 the streamed wrappers launch the resident fp32 backward
// pair (flash_attention_bwd.cu) over whole bands, as the JAX kernels carry
// a whole band along their grid's sequential axis. They
// compute what the resident kernels compute -- O = softmax(scale Q K^T) V
// with the fp32 lse, then dQ = scale dS K and dK = scale dS^T Q,
// dV = P^T dO from P = exp(scale S - lse), dS = P (dO V^T - delta) -- under
// the causal mask (key k visible to query q iff k <= q) and/or the sliding
// window (keys [q-w+1, q] causal, [q-w+1, q+w-1] not: _apply_pos_masks).
// A row with no visible key adds exactly 0.
//
// Segment ids (a query sees only keys of its own id, never the pad id:
// _seg_mask_if_needed) join the mask on edge blocks; a block whose query
// and key tiles hold one non-pad id is interior. The splits stay static
// (the bands of the causal limit and the window, cut on the host from
// shapes alone); with contiguous_segments each split CTA narrows its range
// to its outer tile's [lo, hi) from the metadata at this kernel's tiles
// (SegArgs, read on the card). A forward split left empty still hands the
// merge an empty partial (m = -1e30, l = 0), or writes o = 0 and lse =
// -1e30 where it is its band's only split, so the merge's fixed order
// gives what mask-only evaluation gives; an empty dQ or dK/dV split adds
// nothing and skips its atomics.
//
// On the TPU the streamed kernels put the K/V (or Q) loop in the grid and
// carry acc/m/l, or the dQ/dK/dV sums, in VMEM scratch from one sequential
// trip to the next; the window shrinks the grid to the band (_window_grid).
// Hopper's blocks run in parallel and carry nothing between them, so here
// the loop is SPLIT ACROSS CTAs: every CTA owns one outer tile and one split
// of the inner tiles the causal limit and the window leave it (k_tiles /
// q_tiles: _window_k_range / _window_q_range), at most `split_tiles` of
// them; tiles outside the band are never visited, so a window costs O(s w).
// - forward: each CTA runs the online softmax over its split. Where a band
//   has several splits, each writes an fp32 partial (unnormalised acc, m,
//   l) and fwd_merge combines a row's partials, m* = max m_i,
//   l* = sum l_i e^(m_i - m*), o = sum acc_i e^(m_i - m*) / l*,
//   lse = m* + log l* (the _combine of transformer/ring.py:64-68). A row
//   with no visible key ends with l* = 0: o = 0 exactly, lse = -1e30. A
//   band of one split is normalised in registers and written with no
//   partial, no workspace and no merge, in both dtypes: bf16 on wgmma
//   (fwd_wgmma, below), fp32 on register-blocked FMA (the split instances
//   of fwd_f32_blocked, flash_f32_blocked.cuh: the resident fp32 forward's
//   CTA body over one split, FWD_F32_OUTER_TILE queries over
//   FWD_F32_INNER_TILE-row key tiles, splits of up to FWD_F32_SPLIT_TILES).
// - dQ and dK/dV (bf16): each CTA adds its split's fp32 partial into
//   zeroed fp32 accumulators by atomics (no partial buffers, no reduction
//   pass; the order of addition changes from run to run, within fp32
//   rounding). The wrapper zeroes them before and casts them to bf16
//   after.
//
// Bound on this card: operations -- 2 products of 2 d FLOPs per visible
// pair forward, 3 for dQ and 4 for dK/dV (7 for the backward pair), against
// 4-6 (s, d) operands moved once.
//
// The bf16 forward (fwd_wgmma) keeps kFwdOuter = 128 queries a CTA (two
// consumer warpgroups of 64 rows and a producer warp, as the backward
// below) and streams BN = 64 or 128-row K/V tiles (FWD_INNER_TILE, chosen
// on the card) through the ring. What it does about each limit of the
// first (mma.sync) version: loads by TMA overlap the products (no thread
// copies a tile, no block barrier); S = Q K^T reads both operands K-major
// and O += P V takes P from the score registers as A fragments and V as an
// MN-major B (no V^T copy, no P in shared memory); only edge blocks test
// each score (a second instance of the softmax), with exp2 and
// scale log2(e) folded in; splits of up to FWD_SPLIT_TILES key tiles, so
// that at the path shapes each band is one split, written directly with no
// fp32 partial, no workspace and no merge launch; the longest bands launch
// first. Its layout, online softmax and consumer step over a key tile are
// in flash_fwd_wgmma.cuh, shared with the resident forward.
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
// Their building blocks (the bands, the ring's layout, the TMA row loads,
// the descriptors and products, P / dS in registers, the consumer loop) are
// in flash_bwd_wgmma.cuh, shared with the resident pair.
// q/k/v/dO are read by TMA as (b, h, s, d) tensor maps, so strided views
// (the fused-QKV heads) go in without a copy; where TMA cannot read a tensor
// (a base or stride not 16-byte aligned, d % 8 != 0) the wrapper passes a
// contiguous copy with d padded to a multiple of 8 (the forward's q/k/v
// alike). Any sq, sk and d <= 128 (64 or 128 in the kernels, zeros past
// d).

#include "flash_f32_blocked.cuh"
#include "flash_fwd_wgmma.cuh"

namespace apex_torch {
namespace {

constexpr int kDimMax = 128;
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
  SegArgs seg;
};

// ---------------------------------------------------------------------------
// forward: the merge pass, one warp per row
// ---------------------------------------------------------------------------

// Rows of bq-row query tiles whose band of bk-row key tiles has at least
// min_splits splits (the others were written by the split pass itself).
template <typename T>
__global__ void __launch_bounds__(kMergeRows * 32)
    fwd_merge(StreamArgs a, T* __restrict__ o, float* __restrict__ lse, int bq,
              int bk, int min_splits) {
  const long long row = (long long)blockIdx.x * kMergeRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.bh * a.sq;
  if (row >= rows) return;
  const int d = a.d;
  const int qt = (int)(row % a.sq) / bq;
  const Band band =
      k_tiles(qt, (a.sk + bk - 1) / bk, a.causal, a.window, bq, bk);
  const int ns = n_splits(band, a.split_tiles);
  if (ns < min_splits) return;
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

// dK/dV: one CTA keeps 128 keys (K and V, loaded once) and streams the
// query tiles of its split (Q, dO, lse, delta) through the ring. Warpgroups
// 0 and 1 own 64 keys each: S^T = K Q^T and dP^T = V dO^T, then
// P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta) in
// registers, and dV += P^T dO, dK += dS^T Q with Q and dO read through the
// descriptor as MN-major B -- no transposed copy. Warp 8 starts the TMA
// loads and the cp.async copies of the row statistics. kGen: the segment
// ids (the split narrowed by seg_band, the segment test on edge blocks);
// without them the kernel as it was.
template <int DP, bool kGen>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dkv_wgmma(const __grid_constant__ BwdMaps maps, const BwdArgs a,
              const SegArgs seg) {
  using L = BwdLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
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
  if constexpr (kGen) {
    const Band nb = seg_band(seg, Band{t0, t1}, bi, kt);
    if (nb.lo >= nb.hi) return;  // no query of this split shares an id
    t0 = nb.lo;
    t1 = nb.hi;
  }
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
  SegRows sg{};
  if constexpr (kGen) sg = seg_rows(seg, true, bi, key0, a.sq, a.sk);
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
    if constexpr (kGen) {
      if (interior(q0, kw, a.sk, a.causal, a.window) &&
          seg_interior(seg, sg, bi, kt, t0 + n, q0, kInner)) {
        dkv_probs<false>(st, dp, l2, c, q0 + qcol, key0, a);
      } else {
        seg_mask<kInner>(st, sg, q0 + qcol);
        dkv_probs<true>(st, dp, l2, c, q0 + qcol, key0, a);
      }
    } else {
      if (interior(q0, kw, a.sk, a.causal, a.window))
        dkv_probs<false>(st, dp, l2, c, q0 + qcol, key0, a);
      else
        dkv_probs<true>(st, dp, l2, c, q0 + qcol, key0, a);
    }
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
// descriptor as MN-major B. kGen: as in dkv_wgmma.
template <int DP, bool kGen>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dq_wgmma(const __grid_constant__ BwdMaps maps, const BwdArgs a,
             const SegArgs seg) {
  using L = BwdLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
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
  if constexpr (kGen) {
    const Band nb = seg_band(seg, Band{t0, t1}, bi, qt);
    if (nb.lo >= nb.hi) return;  // no key of this split shares an id
    t0 = nb.lo;
    t1 = nb.hi;
  }
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
  SegRows sg{};
  if constexpr (kGen) sg = seg_rows(seg, false, bi, qw + r0, a.sq, a.sk);
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
    if constexpr (kGen) {
      if (interior(qw, k0, a.sk, a.causal, a.window) &&
          seg_interior(seg, sg, bi, qt, t0 + n, k0, kInner)) {
        dq_probs<false>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
      } else {
        seg_mask<kInner>(st, sg, k0 + kcol);
        dq_probs<true>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
      }
    } else {
      if (interior(qw, k0, a.sk, a.causal, a.window))
        dq_probs<false>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
      else
        dq_probs<true>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
    }
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
// forward in bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

struct FwdMaps {
  CUtensorMap q, k, v;  // encode_rows_map: 64 x 64 boxes
};

struct FwdArgs {
  __nv_bfloat16* o;  // (b*h, sq, d) contiguous
  float* lse;        // (b*h, sq) contiguous
  float* acc;        // (nsplit, b*h, sq, d) partials, or null (one split)
  float* m;          // (nsplit, b*h, sq) partial row max, natural units
  float* l;          // (nsplit, b*h, sq) partial row sum
  int h, bh, sq, sk, d;
  uint32_t qpos, kpos, vpos;  // coordinate placement of each map
  float scale;
  int causal, window, split_tiles;
};

// The forward: one CTA keeps 128 queries (Q, loaded once by TMA) and
// streams the key tiles of its split (K, V; BN rows each) through the
// ring. Warpgroups 0 and 1 own 64 queries each: S = Q K^T (both operands
// K-major), the online softmax in registers, then O += P V with P straight
// from the score registers as A fragments and V read through the
// descriptor as an MN-major B -- no V^T copy, no P in shared memory. Warp 8
// starts the TMA loads. A band of one split normalises in registers and
// writes o and lse itself; a split of a longer band writes its fp32
// partial (acc, m, l) for fwd_merge. Split 0 of an empty band writes its
// rows' o = 0 and lse = -1e30. kGen: the segment ids (the split narrowed
// by seg_band, the segment test on edge blocks); a split that the segment
// bounds leave empty writes what split 0 of an empty band writes (its
// band's only split) or an empty partial. Without them the kernel as it
// was.
template <int DP, int BN, bool kGen>
__global__ void __launch_bounds__(kBwdThreads, 1)
    fwd_wgmma(const __grid_constant__ FwdMaps maps, const FwdArgs a,
              const SegArgs seg) {
  using L = FwdLayout<DP, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_ready = empty + kStages;

  const int n_outer = (a.sq + kFwdOuter - 1) / kFwdOuter;
  const int bh = blockIdx.x, split = blockIdx.z;
  const int qt = n_outer - 1 - (int)blockIdx.y;  // causal: longest band first
  const int q0 = qt * kFwdOuter;
  const Band band =
      k_tiles(qt, (a.sk + BN - 1) / BN, a.causal, a.window, kFwdOuter, BN);
  int t0, t1;
  if (!split_of(band, split, a.split_tiles, t0, t1)) {
    if (split == 0 && band.hi <= band.lo) {  // no query here sees a key
      const size_t head = (size_t)bh * a.sq;
      const int rows = min(kFwdOuter, a.sq - q0);
      for (int e = threadIdx.x; e < rows * a.d; e += kBwdThreads)
        a.o[(head + q0) * a.d + e] = __float2bfloat16_rn(0.f);
      for (int r = threadIdx.x; r < rows; r += kBwdThreads)
        a.lse[head + q0 + r] = kNegInf;
    }
    return;
  }
  const bool direct = band.hi - band.lo <= a.split_tiles;
  const int bi = bh / a.h, hi = bh - bi * a.h;
  if constexpr (kGen) {
    const Band nb = seg_band(seg, Band{t0, t1}, bi, qt);
    if (nb.lo >= nb.hi) {  // no key of this split shares an id
      const size_t head = (size_t)bh * a.sq;
      const int rows = min(kFwdOuter, a.sq - q0);
      if (direct) {
        for (int e = threadIdx.x; e < rows * a.d; e += kBwdThreads)
          a.o[(head + q0) * a.d + e] = __float2bfloat16_rn(0.f);
        for (int r = threadIdx.x; r < rows; r += kBwdThreads)
          a.lse[head + q0 + r] = kNegInf;
      } else {
        const size_t at = ((size_t)split * a.bh + bh) * a.sq + q0;
        for (int e = threadIdx.x; e < rows * a.d; e += kBwdThreads)
          a.acc[at * a.d + e] = 0.f;
        for (int r = threadIdx.x; r < rows; r += kBwdThreads) {
          a.m[at + r] = kNegInf;
          a.l[at + r] = 0.f;
        }
      }
      return;
    }
    t0 = nb.lo;
    t1 = nb.hi;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // each consumer warp
    }
    hopper::mbar_init(q_ready, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x != 2 * kWg) return;
    hopper::mbar_arrive_tx(q_ready, L::kQBytes);
    tma_rows<DP, kFwdOuter>(base, &maps.q, a.qpos, q_ready, q0, hi, bi);
    for (int i = t0; i < t1; ++i) {
      const int n = i - t0, s = n % kStages;
      hopper::mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
      unsigned char* ks = base + L::kRing + s * 2 * L::kTileBytes;
      hopper::mbar_arrive_tx(&full[s], 2 * L::kTileBytes);
      tma_rows<DP, BN>(ks, &maps.k, a.kpos, &full[s], i * BN, hi, bi);
      tma_rows<DP, BN>(ks + L::kTileBytes, &maps.v, a.vpos, &full[s], i * BN,
                       hi, bi);
    }
    return;
  }

  hopper::regs_alloc<240>();
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int qw = q0 + wg * 64;            // this warpgroup's queries
  const int r0 = warp * 16 + lane / 4;    // rows of d[i]: + 8 ((i/2)%2)
  const int kcol = 2 * (lane % 4);        // + 8 (i/4) + i%2
  const float c = a.scale * kLog2e;
  SegRows sg{};
  if constexpr (kGen) sg = seg_rows(seg, false, bi, qw + r0, a.sq, a.sk);
  const uint32_t qs = hopper::smem_u32(base);
  const uint32_t ring = hopper::smem_u32(base + L::kRing);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m2[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_ready, 0);

  for (int n = 0; n < t1 - t0; ++n) {
    const int s = n % kStages, k0 = (t0 + n) * BN;
    const uint32_t ks = ring + s * 2 * L::kTileBytes;
    hopper::mbar_wait(&full[s], (n / kStages) & 1);
    if constexpr (kGen)
      fwd_tile<DP, kFwdOuter, BN, false, true>(
          o, m2, l, qs, wg * 64, ks, ks + L::kTileBytes, c, qw + r0,
          k0 + kcol, a.sk, a.causal, a.window,
          !interior<BN>(qw, k0, a.sk, a.causal, a.window) ||
              !seg_interior(seg, sg, bi, qt, t0 + n, k0, BN),
          {}, &sg);
    else
      fwd_tile<DP, kFwdOuter, BN>(
          o, m2, l, qs, wg * 64, ks, ks + L::kTileBytes, c, qw + r0,
          k0 + kcol, a.sk, a.causal, a.window,
          !interior<BN>(qw, k0, a.sk, a.causal, a.window));
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  row_sums(l);
  const size_t head = (size_t)bh * a.sq;
  if (direct) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = qw + r0 + 8 * hf;
      if (row >= a.sq) continue;
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
      __nv_bfloat16* orow = a.o + (head + row) * a.d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + kcol, idx = 4 * j + 2 * hf;
        if (col < a.d)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[idx] * inv, o[idx + 1] * inv);
      }
      if (lane % 4 == 0) a.lse[head + row] = lse_of(m2[hf], l[hf]);
    }
    return;
  }
  // the split's partial: unnormalised acc, m (natural units; kNegInf where
  // the split sees nothing, so that fwd_merge weighs it 0) and l
  const size_t at = ((size_t)split * a.bh + bh) * a.sq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = qw + r0 + 8 * hf;
    if (row >= a.sq) continue;
    float* arow = a.acc + (at + row) * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + kcol, idx = 4 * j + 2 * hf;
      if (col < a.d)
        *reinterpret_cast<float2*>(arow + col) =
            make_float2(o[idx], o[idx + 1]);
    }
    if (lane % 4 == 0) {
      a.m[at + row] = l[hf] > 0.f ? m2[hf] * kLn2 : kNegInf;
      a.l[at + row] = l[hf];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Pass { kDq = 1, kDkv = 2 };

// The bf16 forward over grid (b*h, outer tiles, max(nsplit, 1)) with the
// kernel of the padded head_dim and the key tile, then the merge of the
// bands of several splits, if any.
template <int DP, int BN, bool kGen>
int launch_fwd_wgmma_k(const FwdMaps& maps, const FwdArgs& a,
                       const SegArgs& seg, int nsplit, cudaStream_t stream) {
  constexpr size_t smem = FwdLayout<DP, BN>::kBytes;
  const int err = set_max_smem<fwd_wgmma<DP, BN, kGen>>(smem);
  if (err) return err;
  const dim3 grid(a.bh, (a.sq + kFwdOuter - 1) / kFwdOuter,
                  nsplit > 1 ? nsplit : 1);
  fwd_wgmma<DP, BN, kGen><<<grid, kBwdThreads, smem, stream>>>(maps, a, seg);
  return (int)cudaGetLastError();
}

// The instance with the segment ids where they are given
template <int DP, int BN>
int launch_fwd_wgmma(const FwdMaps& maps, const FwdArgs& a,
                     const SegArgs& seg, int nsplit, cudaStream_t stream) {
  return seg.q != nullptr
             ? launch_fwd_wgmma_k<DP, BN, true>(maps, a, seg, nsplit, stream)
             : launch_fwd_wgmma_k<DP, BN, false>(maps, a, seg, nsplit,
                                                 stream);
}

int launch_fwd_bf16(const StreamArgs& s, int b, int inner_tile, int nsplit,
                    void* o, void* lse, cudaStream_t stream) {
  FwdMaps maps;
  FwdArgs a{};
  int err = encode_rows_map(&maps.q, &a.qpos, s.q, b, s.h, s.sq, s.d, s.qs.b,
                            s.qs.h, s.qs.s);
  if (!err) err = encode_rows_map(&maps.k, &a.kpos, s.k, b, s.h, s.sk, s.d,
                                  s.ks.b, s.ks.h, s.ks.s);
  if (!err) err = encode_rows_map(&maps.v, &a.vpos, s.v, b, s.h, s.sk, s.d,
                                  s.vs.b, s.vs.h, s.vs.s);
  if (err) return err;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.acc = s.acc;
  a.m = s.m;
  a.l = s.l;
  a.h = s.h;
  a.bh = s.bh;
  a.sq = s.sq;
  a.sk = s.sk;
  a.d = s.d;
  a.scale = s.scale;
  a.causal = s.causal;
  a.window = s.window;
  a.split_tiles = s.split_tiles;
  if (s.d <= 64)
    err = inner_tile == 64
              ? launch_fwd_wgmma<64, 64>(maps, a, s.seg, nsplit, stream)
              : launch_fwd_wgmma<64, 128>(maps, a, s.seg, nsplit, stream);
  else
    err = inner_tile == 64
              ? launch_fwd_wgmma<128, 64>(maps, a, s.seg, nsplit, stream)
              : launch_fwd_wgmma<128, 128>(maps, a, s.seg, nsplit, stream);
  if (err || nsplit <= 1) return err;
  const long long rows = (long long)s.bh * s.sq;
  const dim3 grid((unsigned)((rows + kMergeRows - 1) / kMergeRows));
  fwd_merge<__nv_bfloat16><<<grid, kMergeRows * 32, 0, stream>>>(
      s, (__nv_bfloat16*)o, (float*)lse, kFwdOuter, inner_tile, 2);
  return (int)cudaGetLastError();
}

// fp32: fwd_f32_blocked (flash_f32_blocked.cuh) over the items (b*h,
// query tile, split) of up to max(nsplit, 1) splits a band, plain grid,
// then the merge of the bands of several splits, if any.
int launch_fwd_f32_split(const StreamArgs& s, int outer_tile,
                         int inner_tile, int nsplit, void* o, void* lse,
                         cudaStream_t stream) {
  const int err = launch_fwd_f32<true>(
      fwd_f32_args(s.q, s.k, s.v, o, lse, s.h, s.bh, s.sq, s.sk, s.d, s.qs,
                   s.ks, s.vs, s.scale, s.causal, s.window, s.seg, s.acc,
                   s.m, s.l, s.split_tiles, nsplit),
      stream);
  if (err || nsplit <= 1) return err;
  const long long rows = (long long)s.bh * s.sq;
  const dim3 grid((unsigned)((rows + kMergeRows - 1) / kMergeRows));
  fwd_merge<float><<<grid, kMergeRows * 32, 0, stream>>>(
      s, (float*)o, (float*)lse, outer_tile, inner_tile, 2);
  return (int)cudaGetLastError();
}

// bf16 dQ or dK/dV over grid (b*h, outer tiles, nsplit): the four tensor
// maps, then the kernel of the padded head_dim.
template <int DP, bool kGen>
int launch_bwd_dp_k(Pass pass, const BwdMaps& maps, const BwdArgs& a,
                    const SegArgs& seg, int bh, int nsplit,
                    cudaStream_t stream) {
  constexpr size_t smem = BwdLayout<DP>::kBytes;
  const int outer = pass == kDkv ? a.sk : a.sq;
  const dim3 grid(bh, (outer + kOuter - 1) / kOuter, nsplit);
  int err;
  if (pass == kDq) {
    err = set_max_smem<dq_wgmma<DP, kGen>>(smem);
    if (err) return err;
    dq_wgmma<DP, kGen><<<grid, kBwdThreads, smem, stream>>>(maps, a, seg);
  } else {
    err = set_max_smem<dkv_wgmma<DP, kGen>>(smem);
    if (err) return err;
    dkv_wgmma<DP, kGen><<<grid, kBwdThreads, smem, stream>>>(maps, a, seg);
  }
  return (int)cudaGetLastError();
}

// The instance with the segment ids where they are given
template <int DP>
int launch_bwd_dp(Pass pass, const BwdMaps& maps, const BwdArgs& a,
                  const SegArgs& seg, int bh, int nsplit,
                  cudaStream_t stream) {
  return seg.q != nullptr
             ? launch_bwd_dp_k<DP, true>(pass, maps, a, seg, bh, nsplit,
                                         stream)
             : launch_bwd_dp_k<DP, false>(pass, maps, a, seg, bh, nsplit,
                                          stream);
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
  return s.d <= 64
             ? launch_bwd_dp<64>(pass, maps, a, s.seg, s.bh, nsplit, stream)
             : launch_bwd_dp<128>(pass, maps, a, s.seg, s.bh, nsplit, stream);
}

// The backward's tiles as the wrapper sees them (outer rows kept, inner rows
// streamed): bf16 only, kOuter / kInner
bool bwd_tiles_ok(int dtype, int outer_tile, int inner_tile) {
  return dtype == kBF16 && outer_tile == kOuter && inner_tile == kInner;
}

// no launch where no query sees a key (the zeroed sums stay 0)
int launch_bwd_pass(Pass pass, const StreamArgs& a, int b, int nsplit,
                    cudaStream_t stream) {
  if (nsplit == 0) return 0;
  return launch_bwd(pass, a, b, nsplit, stream);
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
// most splits any query tile's band has (the wrapper computes it with
// outer_tile / inner_tile / split_tiles). bf16 (fwd_wgmma, read by TMA:
// 16-byte aligned bases and strides, d % 8 == 0): kFwdOuter / 64 or 128;
// fp32 (fwd_f32_blocked): the tiles of fwd_f32_tiles_ok. A band of one
// split is written by the split pass, and the merge runs, over the other
// rows, only where nsplit > 1 -- acc, m and l may be null otherwise.
// qseg / kseg: int32 (b, sq) / (b, sk) segment ids or null; bounds and
// ranges (both null: mask only), omm, imm: their (b, 2, n) metadata at
// outer_tile / inner_tile, the ranges over the outer side's rows (SegArgs;
// for dK/dV below the outer side is the keys).
extern "C" int apex_flash_fwd_stream(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    void* o, void* lse, int b, int h, int sq, int sk, int d, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int causal,
    int window, int outer_tile, int inner_tile, int split_tiles, int nsplit,
    int dtype, const void* qseg, const void* kseg, const void* bounds,
    const void* omm, const void* imm, const void* ranges, int pad_id,
    int has_pad, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit) ||
      !seg_ok(qseg, kseg, bounds, omm, imm, ranges))
    return (int)cudaErrorInvalidValue;
  const bool bf16_ok = dtype == kBF16 && outer_tile == kFwdOuter &&
                       (inner_tile == 64 || inner_tile == 128) &&
                       (nsplit <= 1 || (acc && m && l));
  const bool f32_ok = dtype == kF32 &&
                      fwd_f32_tiles_ok(d, outer_tile, inner_tile) &&
                      (nsplit <= 1 || (acc && m && l));
  if (!bf16_ok && !f32_ok) return (int)cudaErrorInvalidValue;
  StreamArgs a = make_args(q, k, v, b, h, sq, sk, d, scale, causal, window,
                           split_tiles);
  a.qs = Strides{qsb, qsh, qss};
  a.ks = Strides{ksb, ksh, kss};
  a.vs = Strides{vsb, vsh, vss};
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.seg = make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id, has_pad,
                   sq, sk, outer_tile, inner_tile);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBF16)
    return launch_fwd_bf16(a, b, inner_tile, nsplit, o, lse, s);
  return launch_fwd_f32_split(a, outer_tile, inner_tile, nsplit, o, lse, s);
}

// dQ (bf16 operands): adds into dq_acc, fp32 contiguous (b, h, sq, d),
// which the caller zeroed. q/k/v/dout strides as above; lse/delta
// contiguous (b, h, sq). outer_tile / inner_tile: the rows a CTA keeps and
// streams, kOuter / kInner, as the wrapper computed nsplit with them. TMA
// reads q/k/v/dout: 16-byte-aligned bases and strides, d % 8 == 0. fp32
// operands are refused: their wrapper launches the resident fp32 pair.
extern "C" int apex_flash_bwd_dq_stream(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, int b, int h, int sq,
    int sk, int d, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal,
    int window, int outer_tile, int inner_tile, int split_tiles, int nsplit,
    int dtype, const void* qseg, const void* kseg, const void* bounds,
    const void* omm, const void* imm, const void* ranges, int pad_id,
    int has_pad, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit) ||
      !bwd_tiles_ok(dtype, outer_tile, inner_tile) ||
      !seg_ok(qseg, kseg, bounds, omm, imm, ranges))
    return (int)cudaErrorInvalidValue;
  StreamArgs a = make_args(q, k, v, b, h, sq, sk, d, scale, causal, window,
                           split_tiles);
  a.seg = make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id, has_pad,
                   sq, sk, outer_tile, inner_tile);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.acc = static_cast<float*>(dq_acc);
  a.qs = Strides{qsb, qsh, qss};
  a.ks = Strides{ksb, ksh, kss};
  a.vs = Strides{vsb, vsh, vss};
  a.dos = Strides{osb, osh, oss};
  return launch_bwd_pass(kDq, a, b, nsplit, (cudaStream_t)stream);
}

// dK/dV (bf16 operands): add into dk_acc and dv_acc, fp32 contiguous
// (b, h, sk, d), which the caller zeroed; other arguments as above.
extern "C" int apex_flash_bwd_dkv_stream(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk_acc, void* dv_acc, int b,
    int h, int sq, int sk, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, int outer_tile, int inner_tile, int split_tiles,
    int nsplit, int dtype, const void* qseg, const void* kseg,
    const void* bounds, const void* omm, const void* imm, const void* ranges,
    int pad_id, int has_pad, void* stream) {
  if (!args_ok(b, h, sq, sk, d, split_tiles, nsplit) ||
      !bwd_tiles_ok(dtype, outer_tile, inner_tile) ||
      !seg_ok(qseg, kseg, bounds, omm, imm, ranges))
    return (int)cudaErrorInvalidValue;
  StreamArgs a = make_args(q, k, v, b, h, sq, sk, d, scale, causal, window,
                           split_tiles);
  a.seg = make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id, has_pad,
                   sk, sq, outer_tile, inner_tile);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.acc = static_cast<float*>(dk_acc);
  a.dv = static_cast<float*>(dv_acc);
  a.qs = Strides{qsb, qsh, qss};
  a.ks = Strides{ksb, ksh, kss};
  a.vs = Strides{vsb, vsh, vss};
  a.dos = Strides{osb, osh, oss};
  return launch_bwd_pass(kDkv, a, b, nsplit, (cudaStream_t)stream);
}
