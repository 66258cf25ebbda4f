// Flash-attention backward for Hopper, resident: a dQ kernel and a dK/dV
// kernel.
//
// Replaces: apex_tpu/ops/flash_attention.py _bwd_dq_kernel (pallas_call at
// _flash_bwd, flash_attention.py:1301) and _bwd_dkv_kernel (pallas_call at
// :1376); in fp32 also _bwd_dq_kernel_stream (pallas_call in
// _flash_bwd_stream, :1101) and _bwd_dkv_kernel_stream (:1172): the
// streamed wrappers launch the fp32 pair below over whole bands, as those
// kernels carry a whole band along their grid's sequential axis, and write
// each output once. Both recompute, per (query, key) pair,
//   S = scale * Q K^T,  P = exp(S - lse)  (0 where masked, and 0 for a row
//   whose lse <= kNegInf / 2: a fully masked row),
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
// from the forward's fp32 lse and the fp32 delta the wrapper computes
// outside the kernels (as _flash_bwd does at :1210). The dQ kernel gives
// dQ = scale * dS K; the dK/dV kernel gives dV = P^T dO and
// dK = scale * dS^T Q. Causal masking is top-left aligned (key k visible to
// query q iff k <= q), as in the forward.
//
// The sliding window and the segment ids (a query sees only keys of its
// own id, never the pad id) narrow each outer tile's band as the
// reference's loop limits do (:402-404, :478-484): the causal limit, the
// window (k_tiles / q_tiles) and, with contiguous_segments, the tile's
// [lo, hi) from the metadata at this kernel's tiles (SegArgs). Interior
// blocks (one non-pad id on both sides, the causal/window test passed)
// skip every test; edge blocks test q_id == k_id beside visible(). An
// empty band still stores its rows: dQ = 0, or dK = dV = 0. A fully
// masked row has lse kNegInf, so its P is 0 (lse2_of) and its dQ 0.
//
// The additive bias (b|1, h|1, sq, sk), fp32, read in place through four
// element strides (0 on a broadcast dim), joins S before P is recomputed
// in both passes (S = scale * Q K^T + bias, :345-346 and :442-443). Where
// the bias needs a gradient, the dQ pass also writes dbias = dS (the
// reference's dbias rows, :380-382), fp32, into a (b, h, sq, sk) buffer,
// each element once by the CTA that holds its row: with a bias of shape
// (b, h, ...) that buffer is dbias; with a bias broadcast over b or h it
// holds per-(b, h) partials, and dbias_finish sums them over the broadcast
// dims in a fixed order (no atomics: two calls give the same bits). The
// bias kernels are separate instances (kBias); without a bias the kernels
// are unchanged.
//
// The TPU kernels keep the whole K/V (dQ pass) or Q/dO (dK/dV pass)
// resident in VMEM (the kfull/qfull BlockSpecs, :1239 and :1312) and loop
// over it inside one grid step. That is a VMEM layout rule, not behaviour:
// here one CTA owns one outer tile and streams every inner tile of its band
// (the causal limit, :402-404; the causal start, :478) through shared
// memory, so any sequence length works. Two passes and no atomics: each CTA
// writes its rows once, so two calls give bit-identical results, as the
// reference's two passes do.
//
// Bound on this card: operations (3 products of 2*d FLOPs per visible pair
// in the dQ pass, 4 in the dK/dV pass, against 4-6 (s, d) operands moved
// once).
//
// bf16 (dq_resident_wgmma, dkv_resident_wgmma): wgmma fed by a TMA ring, on
// the building blocks of the streamed pair (flash_bwd_wgmma.cuh).
// - One CTA per (kOuter = 128-row outer tile, b*h) item over its whole
//   band: dQ keeps 128 queries (Q, dO, lse, delta, loaded once) and
//   streams the key tiles (K, V) of its causal band; dK/dV keeps 128 keys
//   (K, V) and streams the query tiles (Q, dO, lse, delta) from the causal
//   start. No split, no fp32 workspace, no zero-fill, no atomics.
// - Three warpgroups: warpgroups 0 and 1 own 64 rows each of the outer
//   tile and run wgmma; warp 8 (the producer, its registers handed to the
//   consumers with setmaxnreg) starts the TMA loads of a kStages-deep ring
//   of BN-row inner tiles, with full and empty mbarriers. BN is 64, or 128
//   for dQ with DP = 64 (RES_BWD_DQ_INNER_TILE in ops/flash_attention.py,
//   chosen on the card; dK/dV at 128 spills registers).
// - S / dP (S^T / dP^T) read both operands K-major from 128-byte-swizzled
//   tiles; P and dS go from the accumulators into register A fragments;
//   dQ += dS K, dV += P^T dO and dK += dS^T Q read the streamed tile as an
//   MN-major B: no transposed copy, no P or dS in shared memory. exp2 with
//   scale log2(e) folded in; only edge blocks (the diagonal, the ragged
//   end) test each score.
// - Longest bands first: dQ walks its query tiles from the last (the
//   longest causal band), dK/dV its key tiles from the first.
// - The epilogue: each warpgroup rounds its 64 rows (scaled) to bf16 into a
//   staging tile of its own, in the swizzled layout TMA reads, and one of
//   its threads stores them with TMA: no row past sq / sk and no column past
//   d is written. The staging tiles are apart from the resident rows, so
//   the producer loads the next item's rows while the consumers store.
// - Schedules: a grid of one CTA per item (plain), or one CTA per SM that
//   walks the items in the same order (persistent); the same kernel, the
//   grid decides. Chosen on the card: RES_BWD_PERSISTENT.
// q/k/v/dO are read through (b, h, s, d) tensor maps, so strided views (the
// fused-QKV heads) go in without a copy; what TMA refuses (a base or
// stride off 16 bytes, d % 8 != 0) the wrapper passes as a padded copy. A
// head_dim up to 64 takes the 64-wide kernels (TMA zero-fills the columns
// past d), up to 128 the 128-wide ones.
//
// fp32 (dq_f32_blocked, dkv_f32_blocked): register-blocked FMA fed by a
// double-buffered cp.async ring, on the building blocks it shares with the
// fp32 forward (flash_f32_blocked.cuh). The first port's FMA kernels read one
// shared-memory operand per FMA, one row and 16 columns a thread, and
// reached 7% of the 67 TFLOP/s fp32 peak.
// - A CTA of NW warps keeps 16 NW outer rows (queries for dQ, keys for
//   dK/dV) and streams the BN-row inner tiles of its band through two
//   stages: the next tile lands while this one computes. 16-byte copies
//   where a row is on 16 bytes (d % 4 == 0 and aligned strides), 4-byte
//   ones otherwise; columns past d and rows past sq / sk are zero-filled.
//   Operand rows at pitch DP + 4.
// - Each thread holds a 4 x BN/8 micro-tile of S and dP (4 outer rows,
//   BN/8 inner rows) and a 4 x DP/8 one of each output, so each
//   shared-memory operand is read once a micro-tile, 16 bytes at a time,
//   with no bank conflict (scores_fma, accumulate_fma). P and dS go from
//   registers through a shared tile whose rows the same warp writes and
//   reads (__syncwarp).
// - Every sum is one fmaf chain in the order the plain version's fp32
//   products take (S and dP over the head dimension, the gradients over
//   the band's keys or queries): the resident fp32 limits (a worst row of
//   1e-5, dbias and the segment cases at 1e-5 / 2e-6) hold on rows whose
//   exact value cancels, such as dQ of a query that sees one key. Split
//   TF32 on mma.sync (x = hi + lo, three TF32 products) was tried first:
//   2-3e-6 of max |ref| but 3e-3 on such rows (PERF.md), so it is not
//   here.
// - Masks: interior tiles skip every test; edge tiles (the diagonal, a
//   window edge, the ragged ends, a segment edge) test each pair. exp as
//   the plain version takes it, expf(scale s + bias - lse).
// - Longest band first, one CTA per item or as many CTAs as fit walking
//   the items (RES_BWD_F32_PERSISTENT), each output element written once:
//   no atomics, two calls give the same bits.
// Any sq, sk and d <= 128 (S's column groups past d skipped); q/k/v/dO may be
// strided (b, h, s) with a contiguous head_dim.

#include <type_traits>

#include "flash_f32_blocked.cuh"

namespace apex_torch {
namespace {

constexpr int kMaxDim = 128;

// The arguments of an entry point, as the host passes them to either route
struct CallArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  void* dq;            // (b, h, sq, d) contiguous
  void* dk;            // (b, h, sk, d) contiguous
  void* dv;
  int h, sq, sk, d;
  Strides qs, ks, vs, dos;
  float scale;
  int causal, window;  // window <= 0: none
  BiasArgs bias;  // p == nullptr: none
  float* dbias;   // (b, h, sq, sk) fp32 dS, or nullptr: no dbias
  SegArgs seg;
};

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring, one CTA per whole band
// ---------------------------------------------------------------------------

struct ResMaps {
  BwdMaps in;              // q, k, v, dout
  CUtensorMap out0, out1;  // dQ; or dK and dV: (b, h, s, d) contiguous
};

struct ResArgs {
  BwdArgs a;             // lse, delta, shapes, map positions, masks
  uint32_t pos0, pos1;   // coordinate placement of out0 / out1
  int bh, n_outer;       // b*h, outer tiles of a head
  int items;             // bh * n_outer: the CTAs of the plain grid
};

// The kBias instances' arguments: the bias and, for dQ, the dbias buffer
// ((b, h, sq, sk) fp32 dS, or nullptr). The instances without a bias take
// ResArgs alone, so their parameters are what they were.
struct ResBiasArgs : ResArgs {
  BiasArgs bias;
  float* dbias;
};

template <bool kBias>
using ResArgsOf =
    typename std::conditional<kBias, ResBiasArgs, ResArgs>::type;

// Byte offsets in dynamic shared memory (after aligning it to 1024): the
// two resident operands (kOuter rows each), the ring of streamed pairs (BN
// rows each), the output staging (one tile of kOuter rows for dQ, two for
// dK and dV), fp32 row statistics (the resident rows' for dQ, each stage's
// for dK/dV), mbarriers.
template <int DP, int BN, bool kDkv>
struct ResLayout {
  static constexpr int kChunks = DP / 64;
  static constexpr int kOuterBytes = kChunks * kOuter * kRowBytes;
  static constexpr int kInnerBytes = kChunks * BN * kRowBytes;
  static constexpr int kRing = 2 * kOuterBytes;
  static constexpr int kStage = kRing + kStages * 2 * kInnerBytes;
  static constexpr int kStats = kStage + (kDkv ? 2 : 1) * kOuterBytes;
  static constexpr int kStatFloats = kDkv ? 2 * kStages * BN : 2 * kOuter;
  static constexpr int kBars = kStats + kStatFloats * 4;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 2) * 8;
};

// dQ: a CTA takes the items blockIdx.x, + gridDim.x, ...; item w is query
// tile n_outer - 1 - w / bh (longest causal band first) of head w % bh. For
// each it keeps 128 queries (Q, dO, lse, delta) and streams the BN-row key
// tiles of the band (K, V) through the ring. Warpgroups 0 and 1 own 64
// queries each: S = Q K^T and dP = dO V^T, then P and dS = P (dP - delta)
// in registers, and dQ += dS K with K read through the descriptor as an
// MN-major B. Warp 8 starts the TMA loads; its 32 lanes copy the lse and
// delta rows. kBias: the bias joins S (add_bias) and, where r.dbias is
// given, each tile's dS is stored to it as well (store_dbias). kGen: the
// general masks (the window, the segment ids: bands narrowed by seg_band,
// the segment test on edge blocks); without them the causal kernel as it
// was.
template <int DP, int BN, bool kBias, bool kGen>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dq_resident_wgmma(const __grid_constant__ ResMaps maps,
                      const ResArgsOf<kBias> r, const SegArgs seg) {
  using L = ResLayout<DP, BN, false>;
  const BwdArgs& a = r.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(base + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;  // an item's Q, dO, lse, delta
  uint64_t* res_empty = res_full + 1;    // the consumers are done with them
  const int nk = (a.sk + BN - 1) / BN;
  const int window = kGen ? a.window : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // each consumer warp
    }
    hopper::mbar_init(res_full, 1 + 32);  // the TMA's, each lane's copies
    hopper::mbar_init(res_empty, 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x >= 2 * kWg + 32) return;
    const int lane = threadIdx.x & 31;
    int it = 0;  // ring tiles so far, over this CTA's items
    for (int w = blockIdx.x, j = 0; w < r.items; w += gridDim.x, ++j) {
      const int bh = w % r.bh, qt = r.n_outer - 1 - w / r.bh;
      const int bi = bh / a.h, hi = bh - bi * a.h, q0 = qt * kOuter;
      Band band = k_tiles(qt, nk, a.causal, window, kOuter, BN);
      if constexpr (kGen) band = seg_band(seg, band, bi, qt);
      hopper::mbar_wait(res_empty, (j & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_tx(res_full, 2 * L::kOuterBytes);
        tma_rows<DP, kOuter>(base, &maps.in.q, a.qpos, res_full, q0, hi, bi);
        tma_rows<DP, kOuter>(base + L::kOuterBytes, &maps.in.dout, a.opos,
                             res_full, q0, hi, bi);
      }
      copy_stats(stats, a.lse + (size_t)bh * a.sq,
                 a.delta + (size_t)bh * a.sq, q0, kOuter, a.sq, res_full);
      if (lane != 0) continue;
      for (int i = band.lo; i < band.hi; ++i, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* ks = base + L::kRing + s * 2 * L::kInnerBytes;
        hopper::mbar_arrive_tx(&full[s], 2 * L::kInnerBytes);
        tma_rows<DP, BN>(ks, &maps.in.k, a.kpos, &full[s], i * BN, hi, bi);
        tma_rows<DP, BN>(ks + L::kInnerBytes, &maps.in.v, a.vpos, &full[s],
                         i * BN, hi, bi);
      }
    }
    hopper::cp_async_wait_all();
    return;
  }

  hopper::regs_alloc<240>();
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // rows of d[i]: + 8 ((i/2)%2)
  const int kcol = 2 * (lane % 4);      // + 8 (i/4) + i%2
  const float c = a.scale * kLog2e;
  const uint32_t qs = hopper::smem_u32(base), os = qs + L::kOuterBytes;
  const uint32_t ring = hopper::smem_u32(base + L::kRing);
  unsigned char* stage = base + L::kStage + wg * 64 * kRowBytes;
  int it = 0;
  for (int w = blockIdx.x, j = 0; w < r.items; w += gridDim.x, ++j) {
    const int bh = w % r.bh, qt = r.n_outer - 1 - w / r.bh;
    const int bi = bh / a.h, hi = bh - bi * a.h;
    const int qw = qt * kOuter + wg * 64;  // this warpgroup's queries
    Band band = k_tiles(qt, nk, a.causal, window, kOuter, BN);
    SegRows sg{};
    if constexpr (kGen) {
      band = seg_band(seg, band, bi, qt);
      sg = seg_rows(seg, false, bi, qw + r0, a.sq, a.sk);
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    hopper::mbar_wait(res_full, j & 1);
    const int ra = wg * 64 + r0;
    const float l2[2] = {lse2_of(stats[ra]), lse2_of(stats[ra + 8])};
    const float dl[2] = {stats[kOuter + ra], stats[kOuter + ra + 8]};
    const int it0 = it;
    auto start = [&](float (&st)[BN / 2], float (&dp)[BN / 2], int n) {
      const int g = it0 + n, s = g % kStages;
      hopper::mbar_wait(&full[s], (g / kStages) & 1);
      const uint32_t ks = ring + s * 2 * L::kInnerBytes;
      hopper::wgmma_fence();
      scores<DP, kOuter, BN>(st, qs, wg * 64, ks);
      scores<DP, kOuter, BN>(dp, os, wg * 64, ks + L::kInnerBytes);
      hopper::wgmma_commit();
    };
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[(it0 + n) % kStages]);
    };
    const int nt = band.hi - band.lo;
    if constexpr (kBias) {
      // the bias joins S (base 2 from here on); where dbias is wanted, each
      // tile's dS goes to the rows of this thread's queries
      const BiasLines brows = bias_rows(r.bias, bi, hi, qw + r0, a.sq);
      float* drows[2] = {nullptr, nullptr};
      if (r.dbias != nullptr) {
        for (int hf = 0; hf < 2; ++hf)
          if (qw + r0 + 8 * hf < a.sq)
            drows[hf] = r.dbias + ((size_t)bh * a.sq + qw + r0 + 8 * hf) *
                                      (size_t)a.sk;
      }
      auto finish = [&](float (&st)[BN / 2], float (&dp)[BN / 2], int n) {
        const int k0 = (band.lo + n) * BN;
        add_bias<BN>(st, brows, c, k0 + kcol, a.sk);
        if constexpr (kGen) {
          if (interior<BN>(qw, k0, a.sk, a.causal, a.window) &&
              seg_interior(seg, sg, bi, qt, band.lo + n, k0, BN)) {
            dq_probs<false, BN>(dp, st, l2, dl, 1.f, qw + r0, k0 + kcol, a);
          } else {
            seg_mask<BN>(st, sg, k0 + kcol);
            dq_probs<true, BN>(dp, st, l2, dl, 1.f, qw + r0, k0 + kcol, a);
          }
        } else {
          if (interior<BN>(qw, k0, a.sk, a.causal, 0))
            dq_probs<false, BN>(dp, st, l2, dl, 1.f, qw + r0, k0 + kcol, a);
          else
            dq_probs<true, BN>(dp, st, l2, dl, 1.f, qw + r0, k0 + kcol, a);
        }
        if (r.dbias != nullptr) store_dbias<BN>(drows, dp, k0 + kcol, a.sk);
        uint32_t sf[BN / 16][4];
        fragments<BN>(sf, dp);
        hopper::wgmma_fence();
        hopper::fence_regs(dq);
        accumulate<DP, BN>(dq, sf,
                           ring + ((it0 + n) % kStages) * 2 * L::kInnerBytes);
      };
      consume<BN>(nt, start, finish, release);
    } else {
      auto finish = [&](float (&st)[BN / 2], float (&dp)[BN / 2], int n) {
        const int k0 = (band.lo + n) * BN;
        if constexpr (kGen) {
          if (interior<BN>(qw, k0, a.sk, a.causal, a.window) &&
              seg_interior(seg, sg, bi, qt, band.lo + n, k0, BN)) {
            dq_probs<false, BN>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
          } else {
            seg_mask<BN>(st, sg, k0 + kcol);
            dq_probs<true, BN>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
          }
        } else {
          if (interior<BN>(qw, k0, a.sk, a.causal, 0))
            dq_probs<false, BN>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
          else
            dq_probs<true, BN>(dp, st, l2, dl, c, qw + r0, k0 + kcol, a);
        }
        uint32_t sf[BN / 16][4];
        fragments<BN>(sf, dp);
        hopper::wgmma_fence();
        hopper::fence_regs(dq);
        accumulate<DP, BN>(dq, sf,
                           ring + ((it0 + n) % kStages) * 2 * L::kInnerBytes);
      };
      consume<BN>(nt, start, finish, release);
    }
    it += nt;
    hopper::fence_regs(dq);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(res_empty);

    staging_free(wg);
    stage_rows<DP>(stage, dq, a.scale, a.scale);
    staging_ready(wg);
    if (tid == 0) {
      store_rows<DP>(&maps.out0, r.pos0, stage, qw, hi, bi);
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();
}

// dK/dV: item w is key tile w / bh (under causal, tile 0 has the longest
// band) of head w % bh. For each a CTA keeps 128 keys (K and V) and streams
// the BN-row query tiles from the causal start (Q, dO, lse, delta) through
// the ring. Warpgroups 0 and 1 own 64 keys each: S^T = K Q^T and
// dP^T = V dO^T, then P^T = exp2(S^T scale log2e - lse log2e) and
// dS^T = P^T (dP^T - delta) in registers, and dV += P^T dO, dK += dS^T Q
// with Q and dO read through the descriptor as MN-major B. Warp 8 starts
// the TMA loads; its 32 lanes copy each query tile's lse and delta. A key
// tile that no query sees (sk > sq under causal) stores zeros. kBias: the
// bias joins S^T (add_bias_t, each key's bias column). kGen: as in the dQ
// kernel.
template <int DP, int BN, bool kBias, bool kGen>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dkv_resident_wgmma(const __grid_constant__ ResMaps maps,
                       const ResArgsOf<kBias> r, const SegArgs seg) {
  using L = ResLayout<DP, BN, true>;
  const BwdArgs& a = r.a;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(base + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;  // an item's K and V
  uint64_t* res_empty = res_full + 1;    // the consumers are done with them
  const int nq = (a.sq + BN - 1) / BN;
  const int window = kGen ? a.window : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA's, each lane's copies
      hopper::mbar_init(&empty[s], 8);      // each consumer warp
    }
    hopper::mbar_init(res_full, 1);
    hopper::mbar_init(res_empty, 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x >= 2 * kWg + 32) return;
    const int lane = threadIdx.x & 31;
    int it = 0;
    for (int w = blockIdx.x, j = 0; w < r.items; w += gridDim.x, ++j) {
      const int bh = w % r.bh, kt = w / r.bh;
      const int bi = bh / a.h, hi = bh - bi * a.h, k0 = kt * kOuter;
      Band band = q_tiles(kt, nq, a.causal, window, BN, kOuter);
      if constexpr (kGen) band = seg_band(seg, band, bi, kt);
      hopper::mbar_wait(res_empty, (j & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_tx(res_full, 2 * L::kOuterBytes);
        tma_rows<DP, kOuter>(base, &maps.in.k, a.kpos, res_full, k0, hi, bi);
        tma_rows<DP, kOuter>(base + L::kOuterBytes, &maps.in.v, a.vpos,
                             res_full, k0, hi, bi);
      }
      const float* lse = a.lse + (size_t)bh * a.sq;
      const float* delta = a.delta + (size_t)bh * a.sq;
      for (int i = band.lo; i < band.hi; ++i, ++it) {
        const int s = it % kStages, q0 = i * BN;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* qs = base + L::kRing + s * 2 * L::kInnerBytes;
        if (lane == 0) {
          hopper::mbar_arrive_tx(&full[s], 2 * L::kInnerBytes);
          tma_rows<DP, BN>(qs, &maps.in.q, a.qpos, &full[s], q0, hi, bi);
          tma_rows<DP, BN>(qs + L::kInnerBytes, &maps.in.dout, a.opos,
                           &full[s], q0, hi, bi);
        }
        copy_stats(stats + s * 2 * BN, lse, delta, q0, BN, a.sq, &full[s]);
      }
    }
    hopper::cp_async_wait_all();
    return;
  }

  hopper::regs_alloc<240>();
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int qcol = 2 * (lane % 4);  // queries of d[i]: + 8 (i/4) + i%2
  const float c = a.scale * kLog2e;
  const uint32_t ks = hopper::smem_u32(base), vs = ks + L::kOuterBytes;
  const uint32_t ring = hopper::smem_u32(base + L::kRing);
  unsigned char* stage = base + L::kStage + wg * 64 * kRowBytes;
  int it = 0;
  for (int w = blockIdx.x, j = 0; w < r.items; w += gridDim.x, ++j) {
    const int bh = w % r.bh, kt = w / r.bh;
    const int bi = bh / a.h, hi = bh - bi * a.h;
    const int kw = kt * kOuter + wg * 64;        // this warpgroup's keys
    const int key0 = kw + warp * 16 + lane / 4;  // of d[i]: + 8 ((i/2)%2)
    Band band = q_tiles(kt, nq, a.causal, window, BN, kOuter);
    SegRows sg{};
    if constexpr (kGen) {
      band = seg_band(seg, band, bi, kt);
      sg = seg_rows(seg, true, bi, key0, a.sq, a.sk);
    }
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    hopper::mbar_wait(res_full, j & 1);
    const int it0 = it;
    auto start = [&](float (&st)[BN / 2], float (&dp)[BN / 2], int n) {
      const int g = it0 + n, s = g % kStages;
      hopper::mbar_wait(&full[s], (g / kStages) & 1);
      const uint32_t qs = ring + s * 2 * L::kInnerBytes;
      hopper::wgmma_fence();
      scores<DP, kOuter, BN>(st, ks, wg * 64, qs);
      scores<DP, kOuter, BN>(dp, vs, wg * 64, qs + L::kInnerBytes);
      hopper::wgmma_commit();
    };
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[(it0 + n) % kStages]);
    };
    const int nt = band.hi - band.lo;
    if constexpr (kBias) {
      // the bias joins S^T (base 2 from here on)
      const BiasLines bcols = bias_cols(r.bias, bi, hi, key0, a.sk);
      auto finish = [&](float (&st)[BN / 2], float (&dp)[BN / 2], int n) {
        const int s = (it0 + n) % kStages, q0 = (band.lo + n) * BN;
        const float* st_s = stats + s * 2 * BN;
        add_bias_t<BN>(st, bcols, c, q0 + qcol, a.sq);
        if constexpr (kGen) {
          if (interior<64, BN>(q0, kw, a.sk, a.causal, a.window) &&
              seg_interior(seg, sg, bi, kt, band.lo + n, q0, BN)) {
            dkv_probs<false, BN>(st, dp, st_s, 1.f, q0 + qcol, key0, a);
          } else {
            seg_mask<BN>(st, sg, q0 + qcol);
            dkv_probs<true, BN>(st, dp, st_s, 1.f, q0 + qcol, key0, a);
          }
        } else {
          if (interior<64, BN>(q0, kw, a.sk, a.causal, 0))
            dkv_probs<false, BN>(st, dp, st_s, 1.f, q0 + qcol, key0, a);
          else
            dkv_probs<true, BN>(st, dp, st_s, 1.f, q0 + qcol, key0, a);
        }
        uint32_t pf[BN / 16][4], sf[BN / 16][4];
        fragments<BN>(pf, st);
        fragments<BN>(sf, dp);
        const uint32_t qs = ring + s * 2 * L::kInnerBytes;
        hopper::wgmma_fence();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        accumulate<DP, BN>(dv, pf, qs + L::kInnerBytes);
        accumulate<DP, BN>(dk, sf, qs);
      };
      consume<BN>(nt, start, finish, release);
    } else {
      auto finish = [&](float (&st)[BN / 2], float (&dp)[BN / 2], int n) {
        const int s = (it0 + n) % kStages, q0 = (band.lo + n) * BN;
        const float* st_s = stats + s * 2 * BN;
        if constexpr (kGen) {
          if (interior<64, BN>(q0, kw, a.sk, a.causal, a.window) &&
              seg_interior(seg, sg, bi, kt, band.lo + n, q0, BN)) {
            dkv_probs<false, BN>(st, dp, st_s, c, q0 + qcol, key0, a);
          } else {
            seg_mask<BN>(st, sg, q0 + qcol);
            dkv_probs<true, BN>(st, dp, st_s, c, q0 + qcol, key0, a);
          }
        } else {
          if (interior<64, BN>(q0, kw, a.sk, a.causal, 0))
            dkv_probs<false, BN>(st, dp, st_s, c, q0 + qcol, key0, a);
          else
            dkv_probs<true, BN>(st, dp, st_s, c, q0 + qcol, key0, a);
        }
        uint32_t pf[BN / 16][4], sf[BN / 16][4];
        fragments<BN>(pf, st);
        fragments<BN>(sf, dp);
        const uint32_t qs = ring + s * 2 * L::kInnerBytes;
        hopper::wgmma_fence();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
        accumulate<DP, BN>(dv, pf, qs + L::kInnerBytes);
        accumulate<DP, BN>(dk, sf, qs);
      };
      consume<BN>(nt, start, finish, release);
    }
    it += nt;
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(res_empty);

    staging_free(wg);
    stage_rows<DP>(stage, dk, a.scale, a.scale);
    stage_rows<DP>(stage + L::kOuterBytes, dv, 1.f, 1.f);
    staging_ready(wg);
    if (tid == 0) {
      store_rows<DP>(&maps.out0, r.pos0, stage, kw, hi, bi);
      store_rows<DP>(&maps.out1, r.pos1, stage + L::kOuterBytes, kw, hi, bi);
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();
}

// ---------------------------------------------------------------------------
// fp32: register-blocked FMA fed by a double-buffered cp.async ring
// ---------------------------------------------------------------------------

struct F32Args {
  CallArgs a;
  int bh, n_outer;  // b*h, outer tiles of a head
  int items;        // bh * n_outer: the CTAs of the plain grid
  int vec;          // bit i set: operand i (q, k, v, dO) takes 16-byte copies
};

// dQ: item w is query tile n_outer - 1 - w / bh (the longest causal band
// first) of head w % bh; a CTA takes items blockIdx.x, + gridDim.x, ....
// For each it keeps 16 NW queries (Q, dO) and streams the BN-row key tiles
// (K, V) of the band: S = Q K^T and dP = dO V^T in 4 x BN/8 micro-tiles,
// P = exp(scale S + bias - lse) and dS = P (dP - delta) in registers
// (stored as dbias where a.dbias is given), dS through the warp's rows of
// a shared tile, dQ += dS K; dQ written once, times scale.
template <int DP, int NW, int BN>
__global__ void __launch_bounds__(NW * 32) dq_f32_blocked(const F32Args r) {
  using L = F32Layout<DP, NW, BN, false>;
  constexpr int NT = NW * 32, kP = L::kP, BM = L::kRows;
  const CallArgs& a = r.a;
  extern __shared__ float smf[];
  float* qs = smf;
  float* os = qs + BM * kP;
  float* ring = smf + L::kRing;
  float* dst = smf + L::kTiles;  // dS
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int kd4 = (a.d + 3) / 4, nk = (a.sk + BN - 1) / BN;
  const float inf = __int_as_float(0x7f800000);
  for (int w = blockIdx.x; w < r.items; w += gridDim.x) {
    const int bh = w % r.bh, qt = r.n_outer - 1 - w / r.bh;
    const int bi = bh / a.h, hi = bh - bi * a.h, q0 = qt * BM;
    const float* qh =
        static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
    const float* kh =
        static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
    const float* vh =
        static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
    const float* oh =
        static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
    const Band band =
        seg_band(a.seg, k_tiles(qt, nk, a.causal, a.window, BM, BN), bi, qt);
    const int nt = band.hi - band.lo;
    auto load_stage = [&](int i, int s) {
      float* to = ring + s * L::kStage;
      ring_rows<DP, BN, NT>(to, kh, a.ks.s, i * BN, a.sk, a.d, r.vec & 2);
      ring_rows<DP, BN, NT>(to + BN * kP, vh, a.vs.s, i * BN, a.sk, a.d,
                            r.vec & 4);
    };
    __syncthreads();  // the previous item is done with every tile
    if (nt > 0) {
      ring_rows<DP, BM, NT>(qs, qh, a.qs.s, q0, a.sq, a.d, r.vec & 1);
      ring_rows<DP, BM, NT>(os, oh, a.dos.s, q0, a.sq, a.d, r.vec & 8);
      load_stage(band.lo, 0);
    }
    cp_async_commit();

    const size_t head = (size_t)bh * a.sq;
    float l[4], dl[4];
    float* drows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + own_row<BM>(ty, i);
      const float lse = q < a.sq ? a.lse[head + q] : kNegInf;
      l[i] = lse > kNegInf * 0.5f ? lse : inf;  // exp(s - inf) = 0
      dl[i] = q < a.sq ? a.delta[head + q] : 0.f;
      drows[i] = a.dbias != nullptr && q < a.sq
                     ? a.dbias + (head + q) * (size_t)a.sk
                     : nullptr;
    }
    // rows own_row(ty, 2 p) and + 8 share SegRows / BiasLines p
    SegRows sg[2];
    BiasLines br[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int q = q0 + own_row<BM>(ty, 2 * p);
      sg[p] = seg_rows(a.seg, false, bi, q, a.sq, a.sk);
      br[p] = a.bias.p != nullptr ? bias_rows(a.bias, bi, hi, q, a.sq)
                                  : BiasLines{{nullptr, nullptr}, 0};
    }
    float acc[4][DP / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < DP / 8; ++m) acc[i][m] = 0.f;

    for (int n = 0; n < nt; ++n) {
      if (n + 1 < nt) load_stage(band.lo + n + 1, (n + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* ks = ring + (n & 1) * L::kStage;
      const int k0 = (band.lo + n) * BN;
      const bool edge =
          !(interior<BN, BM>(q0, k0, a.sk, a.causal, a.window) &&
            seg_interior(a.seg, sg[0], bi, qt, band.lo + n, k0, BN) &&
            seg_interior(a.seg, sg[1], bi, qt, band.lo + n, k0, BN));
      {
        float s[4][BN / 8], dp[4][BN / 8];
        scores_fma<DP, BM, BN>(s, qs, ks, kd4, ty, tx);
        scores_fma<DP, BM, BN>(dp, os, ks + BN * kP, kd4, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int key = k0 + tx + 8 * j;
            const BiasLines& b = br[i >> 1];
            float sv = s[i][j] * a.scale;
            if (b.r[i & 1] != nullptr && key < a.sk)
              sv += __ldg(b.r[i & 1] + key * b.s);
            float p = expf(sv - l[i]);
            if (edge && !(visible(q0 + own_row<BM>(ty, i), key, a.sk,
                                  a.causal, a.window) &&
                          sg[i >> 1].sees(i & 1, key)))
              p = 0.f;
            dp[i][j] = p * (dp[i][j] - dl[i]);
            if (drows[i] != nullptr && key < a.sk) drows[i][key] = dp[i][j];
          }
        store_tile<BM, BN>(dst, dp, ty, tx);
      }
      __syncwarp();  // a row's dS is written and read by one warp
      accumulate_fma<DP, BM, BN>(acc, dst, ks, ty, tx);
      __syncthreads();  // this stage is free for tile n + 2
    }
    cp_async_wait<0>();
    store_f32<DP, BM>(static_cast<float*>(a.dq) + head * a.d, acc, a.scale,
                      q0, a.sq, a.d, ty, tx);
  }
}

// dK/dV: item w is key tile w / bh (under causal, tile 0 has the longest
// band) of head w % bh. For each a CTA keeps 16 NW keys (K, V) and streams
// the BN-row query tiles (Q, dO, lse, delta) from the causal start: S^T =
// K Q^T and dP^T = V dO^T in 4 x BN/8 micro-tiles, P^T and dS^T in
// registers and through the warp's rows of two shared tiles, dV += P^T dO
// and dK += dS^T Q; both written once (dK times scale). A key that no
// query sees gets 0.
template <int DP, int NW, int BN>
__global__ void __launch_bounds__(NW * 32) dkv_f32_blocked(const F32Args r) {
  using L = F32Layout<DP, NW, BN, true>;
  constexpr int NT = NW * 32, kP = L::kP, BM = L::kRows;
  const CallArgs& a = r.a;
  extern __shared__ float smf[];
  float* ks = smf;
  float* vs = ks + BM * kP;
  float* ring = smf + L::kRing;
  float* pt = smf + L::kTiles;  // P^T, then dS^T
  float* dst = pt + L::kTile;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int kd4 = (a.d + 3) / 4, nq = (a.sq + BN - 1) / BN;
  const float inf = __int_as_float(0x7f800000);
  for (int w = blockIdx.x; w < r.items; w += gridDim.x) {
    const int bh = w % r.bh, kt = w / r.bh;
    const int bi = bh / a.h, hi = bh - bi * a.h, k0 = kt * BM;
    const float* qh =
        static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
    const float* kh =
        static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
    const float* vh =
        static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
    const float* oh =
        static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
    const size_t head = (size_t)bh * a.sq;
    const Band band =
        seg_band(a.seg, q_tiles(kt, nq, a.causal, a.window, BN, BM), bi, kt);
    const int nt = band.hi - band.lo;
    auto load_stage = [&](int i, int s) {
      float* to = ring + s * L::kStage;
      ring_rows<DP, BN, NT>(to, qh, a.qs.s, i * BN, a.sq, a.d, r.vec & 1);
      ring_rows<DP, BN, NT>(to + BN * kP, oh, a.dos.s, i * BN, a.sq, a.d,
                            r.vec & 8);
      if (threadIdx.x < 2 * BN) {  // lse, then delta
        const int q = i * BN + threadIdx.x % BN;
        const float* src = (threadIdx.x < BN ? a.lse : a.delta) + head;
        hopper::cp_async_4(to + 2 * BN * kP + threadIdx.x,
                           q < a.sq ? src + q : src, q < a.sq);
      }
    };
    __syncthreads();  // the previous item is done with every tile
    if (nt > 0) {
      ring_rows<DP, BM, NT>(ks, kh, a.ks.s, k0, a.sk, a.d, r.vec & 2);
      ring_rows<DP, BM, NT>(vs, vh, a.vs.s, k0, a.sk, a.d, r.vec & 4);
      load_stage(band.lo, 0);
    }
    cp_async_commit();

    SegRows sg[2];
    BiasLines bc[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int key = k0 + own_row<BM>(ty, 2 * p);
      sg[p] = seg_rows(a.seg, true, bi, key, a.sq, a.sk);
      bc[p] = a.bias.p != nullptr ? bias_cols(a.bias, bi, hi, key, a.sk)
                                  : BiasLines{{nullptr, nullptr}, 0};
    }
    float dk[4][DP / 8], dv[4][DP / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < DP / 8; ++m) dk[i][m] = dv[i][m] = 0.f;

    for (int n = 0; n < nt; ++n) {
      if (n + 1 < nt) load_stage(band.lo + n + 1, (n + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* qs = ring + (n & 1) * L::kStage;
      const float* dos = qs + BN * kP;
      const float* st = dos + BN * kP;  // lse, delta of the tile's queries
      const int q0 = (band.lo + n) * BN;
      const bool edge =
          !(q0 + BN <= a.sq &&
            interior<BM, BN>(q0, k0, a.sk, a.causal, a.window) &&
            seg_interior(a.seg, sg[0], bi, kt, band.lo + n, q0, BN) &&
            seg_interior(a.seg, sg[1], bi, kt, band.lo + n, q0, BN));
      {
        float s[4][BN / 8], dp[4][BN / 8];
        scores_fma<DP, BM, BN>(s, ks, qs, kd4, ty, tx);
        scores_fma<DP, BM, BN>(dp, vs, dos, kd4, ty, tx);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int qi = tx + 8 * j, q = q0 + qi;
          const float lse = st[qi], delta = st[BN + qi];
          const float lq = lse > kNegInf * 0.5f ? lse : inf;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const BiasLines& b = bc[i >> 1];
            float sv = s[i][j] * a.scale;
            if (b.r[i & 1] != nullptr && q < a.sq)
              sv += __ldg(b.r[i & 1] + q * b.s);
            float p = expf(sv - lq);
            if (edge && !(q < a.sq &&
                          visible(q, k0 + own_row<BM>(ty, i), a.sk,
                                  a.causal, a.window) &&
                          sg[i >> 1].sees(i & 1, q)))
              p = 0.f;
            s[i][j] = p;
            dp[i][j] = p * (dp[i][j] - delta);
          }
        }
        store_tile<BM, BN>(pt, s, ty, tx);
        store_tile<BM, BN>(dst, dp, ty, tx);
      }
      __syncwarp();  // a key row's P / dS are written and read by one warp
      accumulate_fma<DP, BM, BN>(dv, pt, dos, ty, tx);
      accumulate_fma<DP, BM, BN>(dk, dst, qs, ty, tx);
      __syncthreads();  // this stage is free for tile n + 2
    }
    cp_async_wait<0>();
    const size_t out = (size_t)bh * a.sk * a.d;
    store_f32<DP, BM>(static_cast<float*>(a.dk) + out, dk, a.scale, k0, a.sk,
                      a.d, ty, tx);
    store_f32<DP, BM>(static_cast<float*>(a.dv) + out, dv, 1.f, k0, a.sk,
                      a.d, ty, tx);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DP, int NW, int BN>
int launch_dq_f32(const F32Args& r, int persistent, cudaStream_t stream) {
  return launch_f32_k<dq_f32_blocked<DP, NW, BN>,
                      F32Layout<DP, NW, BN, false>::kBytes, NW * 32>(
      r, persistent, stream);
}

template <int DP, int NW, int BN>
int launch_dkv_f32(const F32Args& r, int persistent, cudaStream_t stream) {
  return launch_f32_k<dkv_f32_blocked<DP, NW, BN>,
                      F32Layout<DP, NW, BN, true>::kBytes, NW * 32>(
      r, persistent, stream);
}

// fp32: outer_tile rows a CTA (16 a warp), 64 rows a stage (32 for dK/dV
// above d = 64: tiles_ok has checked them); the 64-wide instances up to
// d = 64, else 128.
int launch_f32(bool dkv, const CallArgs& a, int b, int outer_tile,
               int persistent, cudaStream_t stream) {
  F32Args r{};
  r.a = a;
  r.bh = b * a.h;
  r.n_outer = ((dkv ? a.sk : a.sq) + outer_tile - 1) / outer_tile;
  const long long items = (long long)r.bh * r.n_outer;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  r.items = (int)items;
  r.vec = rows_vec(a.q, a.qs, a.d) | rows_vec(a.k, a.ks, a.d) << 1 |
          rows_vec(a.v, a.vs, a.d) << 2 | rows_vec(a.dout, a.dos, a.d) << 3;
  const bool wide = outer_tile == 128;
  if (!dkv) {
    if (a.d > 64) return launch_dq_f32<128, 4, 64>(r, persistent, stream);
    return wide ? launch_dq_f32<64, 8, 64>(r, persistent, stream)
                : launch_dq_f32<64, 4, 64>(r, persistent, stream);
  }
  if (a.d > 64) return launch_dkv_f32<128, 4, 32>(r, persistent, stream);
  return wide ? launch_dkv_f32<64, 8, 64>(r, persistent, stream)
              : launch_dkv_f32<64, 4, 64>(r, persistent, stream);
}

// A resident kernel with its shared memory over `grid` CTAs: one per item,
// or one per SM (persistent).
template <auto Kernel, size_t kSmem, class Args>
int launch_res(const ResMaps& maps, const Args& r, const SegArgs& seg,
               int grid, cudaStream_t stream) {
  const int err = set_max_smem<Kernel>(kSmem);
  if (err) return err;
  Kernel<<<grid, kBwdThreads, kSmem, stream>>>(maps, r, seg);
  return (int)cudaGetLastError();
}

// The instance with the bias where one is given, and with the general
// masks where a window or segment ids are
template <int DP, int BN, bool kGen>
int launch_dq_k(const ResMaps& maps, const ResBiasArgs& r,
                const SegArgs& seg, int grid, cudaStream_t stream) {
  constexpr size_t smem = ResLayout<DP, BN, false>::kBytes;
  if (r.bias.p != nullptr)
    return launch_res<dq_resident_wgmma<DP, BN, true, kGen>, smem>(
        maps, r, seg, grid, stream);
  return launch_res<dq_resident_wgmma<DP, BN, false, kGen>, smem>(
      maps, static_cast<const ResArgs&>(r), seg, grid, stream);
}

template <int DP, int BN>
int launch_dq(const ResMaps& maps, const ResBiasArgs& r, const SegArgs& seg,
              int grid, cudaStream_t stream) {
  return r.a.window > 0 || seg.q != nullptr
             ? launch_dq_k<DP, BN, true>(maps, r, seg, grid, stream)
             : launch_dq_k<DP, BN, false>(maps, r, seg, grid, stream);
}

template <int DP, bool kGen>
int launch_dkv_k(const ResMaps& maps, const ResBiasArgs& r,
                 const SegArgs& seg, int grid, cudaStream_t stream) {
  constexpr size_t smem = ResLayout<DP, 64, true>::kBytes;
  if (r.bias.p != nullptr)
    return launch_res<dkv_resident_wgmma<DP, 64, true, kGen>, smem>(
        maps, r, seg, grid, stream);
  return launch_res<dkv_resident_wgmma<DP, 64, false, kGen>, smem>(
      maps, static_cast<const ResArgs&>(r), seg, grid, stream);
}

template <int DP>
int launch_dkv(const ResMaps& maps, const ResBiasArgs& r, const SegArgs& seg,
               int grid, cudaStream_t stream) {
  return r.a.window > 0 || seg.q != nullptr
             ? launch_dkv_k<DP, true>(maps, r, seg, grid, stream)
             : launch_dkv_k<DP, false>(maps, r, seg, grid, stream);
}

// dbias of a bias broadcast over b (bb = 1) and/or h (bh = 1) from the dQ
// pass's per-(b, h) dS partials ws (b, h, n) with n = sq * sk: out (bb, bh,
// n), each element the sum over the broadcast dims in a fixed order (b
// outer, h inner), so two calls give the same bits. Bound by bytes: ws
// read once, out written once.
__global__ void __launch_bounds__(256)
    dbias_finish(const float* __restrict__ ws, float* __restrict__ out,
                 int b, int h, int bb, int bh, long long n) {
  const long long total = (long long)bb * bh * n;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long e = idx % n, o = idx / n;
    const int ho = (int)(o % bh), bo = (int)(o / bh);
    const int b0 = bb == 1 ? 0 : bo, b1 = bb == 1 ? b : bo + 1;
    const int h0 = bh == 1 ? 0 : ho, h1 = bh == 1 ? h : ho + 1;
    float sum = 0.f;
    for (int bi = b0; bi < b1; ++bi)
      for (int hi = h0; hi < h1; ++hi)
        sum += ws[((long long)bi * h + hi) * n + e];
    out[idx] = sum;
  }
}

int launch_dbias_finish(const float* ws, float* out, int b, int h, int bb,
                        int bh, long long n, cudaStream_t stream) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const long long blocks = ((long long)bb * bh * n + 255) / 256;
  const int grid = (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
  dbias_finish<<<grid, 256, 0, stream>>>(ws, out, b, h, bb, bh, n);
  return (int)cudaGetLastError();
}

// bf16: the four operand maps and the output maps (out0: dQ or dK, out1:
// dV; contiguous (b, h, s, d)), then the kernel. inner_tile 64, or 128 for
// dQ with d <= 64 (dK/dV at 128 spills); persistent: one CTA per SM.
int launch_res_bwd(bool dkv, const CallArgs& f, int b, int inner_tile,
                   int persistent, cudaStream_t stream) {
  ResMaps maps;
  ResBiasArgs r{};
  BwdArgs& a = r.a;
  const int h = f.h, d = f.d, so = dkv ? f.sk : f.sq;
  int err = encode_rows_map(&maps.in.q, &a.qpos, f.q, b, h, f.sq, d, f.qs.b,
                            f.qs.h, f.qs.s);
  if (!err) err = encode_rows_map(&maps.in.k, &a.kpos, f.k, b, h, f.sk, d,
                                  f.ks.b, f.ks.h, f.ks.s);
  if (!err) err = encode_rows_map(&maps.in.v, &a.vpos, f.v, b, h, f.sk, d,
                                  f.vs.b, f.vs.h, f.vs.s);
  if (!err) err = encode_rows_map(&maps.in.dout, &a.opos, f.dout, b, h, f.sq,
                                  d, f.dos.b, f.dos.h, f.dos.s);
  const long long ob = (long long)h * so * d, oh = (long long)so * d;
  if (!err) err = encode_rows_map(&maps.out0, &r.pos0, dkv ? f.dk : f.dq, b, h,
                                  so, d, ob, oh, d);
  if (!err && dkv)
    err = encode_rows_map(&maps.out1, &r.pos1, f.dv, b, h, so, d, ob, oh, d);
  if (err) return err;
  a.lse = f.lse;
  a.delta = f.delta;
  a.h = h;
  a.sq = f.sq;
  a.sk = f.sk;
  a.d = d;
  a.scale = f.scale;
  a.causal = f.causal;
  a.window = f.window;
  r.bias = f.bias;
  r.dbias = f.dbias;
  r.bh = b * h;
  r.n_outer = (so + kOuter - 1) / kOuter;
  const long long items = (long long)r.bh * r.n_outer;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  r.items = (int)items;
  int grid = r.items;
  if (persistent) {
    int dev = 0, sms = 0;
    err = (int)cudaGetDevice(&dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
    if (err) return err;
    grid = grid < sms ? grid : sms;
  }
  if (dkv)
    return d > 64 ? launch_dkv<128>(maps, r, f.seg, grid, stream)
                  : launch_dkv<64>(maps, r, f.seg, grid, stream);
  if (d > 64) return launch_dq<128, 64>(maps, r, f.seg, grid, stream);
  return inner_tile == 128 ? launch_dq<64, 128>(maps, r, f.seg, grid, stream)
                           : launch_dq<64, 64>(maps, r, f.seg, grid, stream);
}

// The tiles a caller names: bf16 kOuter rows kept, 64 streamed (or 128 for
// dQ with d <= 64); fp32 64 rows kept (or 128 with d <= 64), 64 streamed
// (32 for dK/dV above d = 64: its registers); either schedule.
bool tiles_ok(bool dkv, int dtype, int d, int outer_tile, int inner_tile,
              int persistent) {
  if (persistent != 0 && persistent != 1) return false;
  if (dtype == kBF16)
    return outer_tile == kOuter &&
           (inner_tile == 64 || (inner_tile == 128 && d <= 64 && !dkv));
  return dtype == kF32 &&
         (outer_tile == 64 || (outer_tile == 128 && d <= 64)) &&
         inner_tile == (dkv && d > 64 ? 32 : 64);
}

int launch_bwd(bool dkv, const CallArgs& a, int b, int outer_tile,
               int inner_tile, int persistent, int dtype,
               cudaStream_t stream) {
  if (a.d < 1 || a.d > kMaxDim || b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 ||
      !tiles_ok(dkv, dtype, a.d, outer_tile, inner_tile, persistent))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_f32(dkv, a, b, outer_tile, persistent, stream);
  return launch_res_bwd(dkv, a, b, inner_tile, persistent, stream);
}

CallArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta, int h,
                  int sq, int sk, int d, const long long* st,
                  const void* bias, const long long* bst, float scale,
                  int causal, int window, const SegArgs& seg) {
  CallArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.dos = Strides{st[9], st[10], st[11]};
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.seg = seg;
  a.bias = BiasArgs{static_cast<const float*>(bias), bst[0], bst[1], bst[2],
                    bst[3]};
  return a;
}

}  // namespace
}  // namespace apex_torch

using namespace apex_torch;

// q/k/v/dout strides in elements, (batch, head, seq) each, head_dim stride 1.
// lse/delta contiguous (b, h, sq) fp32; dq contiguous (b, h, sq, d) in q's
// dtype. bias: an fp32 (b|1, h|1, sq, sk) additive bias read through its
// element strides (bsb, bsh, bsq, bsk; 0 on a broadcast dim), or null.
// dbias_ws: null, or (with a bias) a contiguous fp32 (b, h, sq, sk) buffer
// the kernel writes dS into (zeroed by the caller where a band leaves tiles
// unvisited: causal, a window, segment bounds); dbias: (bb, bh, sq, sk)
// contiguous fp32, the same buffer as dbias_ws where (bb, bh) == (b, h),
// else the dbias_finish launch sums the partials into it. window <= 0:
// none. outer_tile / inner_tile: the rows a CTA keeps and streams;
// persistent: as many CTAs as the card holds, walking the items (bf16: 128
// / 64, or 128 for dQ with d <= 64 / 0 or 1; fp32: 64 or 128 (d <= 64) /
// 64, or 32 for dK/dV above d = 64 / 0 or 1). bf16 reads q/k/v/dout and
// writes dq by TMA: 16-byte-aligned bases and strides, d % 8 == 0. qseg /
// kseg: int32 (b, sq) / (b, sk) segment ids or null; bounds and ranges
// (both null: mask only), omm, imm: their (b, 2, n) metadata at outer_tile /
// inner_tile (SegArgs; the outer side, whose rows the ranges cover, is the
// queries for dQ, the keys for dK/dV).
extern "C" int apex_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* bias,
    void* dbias_ws, void* dbias, int b, int h, int sq, int sk, int d,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long bsb, long long bsh, long long bsq,
    long long bsk, int bb, int bh, float scale, int causal, int window,
    int outer_tile, int inner_tile, int persistent, int dtype,
    const void* qseg, const void* kseg, const void* bounds, const void* omm,
    const void* imm, const void* ranges, int pad_id, int has_pad,
    void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const long long bst[4] = {bsb, bsh, bsq, bsk};
  if ((dbias_ws != nullptr &&
       (bias == nullptr || dbias == nullptr || (bb != 1 && bb != b) ||
        (bh != 1 && bh != h))) ||
      !seg_ok(qseg, kseg, bounds, omm, imm, ranges))
    return (int)cudaErrorInvalidValue;
  CallArgs a = make_args(
      q, k, v, dout, lse, delta, h, sq, sk, d, st, bias, bst, scale, causal,
      window, make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id, has_pad,
                       sq, sk, outer_tile, inner_tile));
  a.dq = dq;
  a.dbias = static_cast<float*>(dbias_ws);
  cudaStream_t s = (cudaStream_t)stream;
  const int err =
      launch_bwd(false, a, b, outer_tile, inner_tile, persistent, dtype, s);
  if (err || dbias_ws == nullptr || (bb == b && bh == h)) return err;
  return launch_dbias_finish(static_cast<const float*>(dbias_ws),
                             static_cast<float*>(dbias), b, h, bb, bh,
                             (long long)sq * sk, s);
}

// dk/dv contiguous (b, h, sk, d) in k's dtype; other arguments as above.
extern "C" int apex_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* bias,
    int b, int h, int sq, int sk, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    long long bsb, long long bsh, long long bsq, long long bsk, float scale,
    int causal, int window, int outer_tile, int inner_tile, int persistent,
    int dtype, const void* qseg, const void* kseg, const void* bounds,
    const void* omm, const void* imm, const void* ranges, int pad_id,
    int has_pad, void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const long long bst[4] = {bsb, bsh, bsq, bsk};
  if (!seg_ok(qseg, kseg, bounds, omm, imm, ranges))
    return (int)cudaErrorInvalidValue;
  CallArgs a = make_args(
      q, k, v, dout, lse, delta, h, sq, sk, d, st, bias, bst, scale, causal,
      window, make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id, has_pad,
                       sk, sq, outer_tile, inner_tile));
  a.dk = dk;
  a.dv = dv;
  return launch_bwd(true, a, b, outer_tile, inner_tile, persistent, dtype,
                    (cudaStream_t)stream);
}
