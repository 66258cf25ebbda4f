// Flash-attention backward for Hopper, resident: a dQ kernel and a dK/dV
// kernel.
//
// Replaces: apex_tpu/ops/flash_attention.py _bwd_dq_kernel (pallas_call at
// _flash_bwd, flash_attention.py:1301) and _bwd_dkv_kernel (pallas_call at
// :1376). Both recompute, per (query, key) pair,
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
// fp32 (bwd_dq_fma_kernel, bwd_dkv_fma_kernel): plain FMA, one CTA per
// (64-row tile, head, batch) over its band, 4 neighbouring lanes per tile
// row, operands in shared memory as fp32 (rows padded by one word against
// bank conflicts), written directly. Any sq, sk and d <= 128; q/k/v/dO may
// be strided (b, h, s) with a contiguous head_dim.

#include <type_traits>

#include "flash_bwd_wgmma.cuh"

namespace apex_torch {
namespace {

constexpr int kFmaThreads = 256;  // 4 lanes per tile row
constexpr int kMaxDim = 128;
constexpr int kPLd = kTile + 1;   // fp32 P / dS tile rows

struct FmaArgs {
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

__device__ __forceinline__ bool live_row(float lse) {
  return lse > kNegInf * 0.5f;
}

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
// fp32 on FMA
// ---------------------------------------------------------------------------
// kTile x d fp32 tile into dst (row pitch d + 1), zero past rows_valid
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int rows_valid,
                                         int d) {
  const int dp = d + 1;
  for (int e = threadIdx.x; e < kTile * d; e += kFmaThreads) {
    const int r = e / d, c = e - r * d;
    dst[r * dp + c] = r < rows_valid ? src[r * stride + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kFmaThreads) bwd_dq_fma_kernel(FmaArgs a) {
  extern __shared__ float smf[];
  const int sq = a.sq, sk = a.sk, d = a.d, dp = d + 1;
  float* Qs = smf;
  float* dOs = Qs + kTile * dp;
  float* Ks = dOs + kTile * dp;
  float* Vs = Ks + kTile * dp;
  float* Ds = Vs + kTile * dp;  // kTile x kPLd: dS

  const int q0 = blockIdx.x * kTile, hi = blockIdx.y, bi = blockIdx.z;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int qrow = q0 + r;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const float* ob =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_f32(Qs, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);
  load_f32(dOs, ob + (long long)q0 * a.dos.s, a.dos.s, sq - q0, d);
  const size_t head = (size_t)(bi * a.h + hi) * sq;
  const float l = qrow < sq ? a.lse[head + qrow] : kNegInf;
  const float dl = qrow < sq ? a.delta[head + qrow] : 0.f;
  const bool live = live_row(l);
  // this row's bias and dbias rows (none past sq)
  const float* brow = a.bias.p != nullptr && qrow < sq
                          ? a.bias.p + bi * a.bias.sb + hi * a.bias.sh +
                                qrow * a.bias.sq
                          : nullptr;
  float* drow = a.dbias != nullptr && qrow < sq
                    ? a.dbias + (head + qrow) * (size_t)sk
                    : nullptr;

  float acc[kMaxDim / 4];
#pragma unroll
  for (int jj = 0; jj < kMaxDim / 4; ++jj) acc[jj] = 0.f;
  const Band band = seg_band(
      a.seg, k_tiles(blockIdx.x, (sk + kTile - 1) / kTile, a.causal, a.window),
      bi, blockIdx.x);
  const SegRows sg = seg_rows(a.seg, false, bi, qrow, sq, sk);

  for (int j = band.lo; j < band.hi; ++j) {
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
      const bool valid = visible(qrow, kpos, sk, a.causal, a.window) &&
                         sg.sees(0, kpos) && live;
      float sv = s[jj] * a.scale;
      if (brow != nullptr && valid) sv += __ldg(brow + kpos * a.bias.sk);
      const float p = valid ? expf(sv - l) : 0.f;
      const float ds = p * (dpv[jj] - dl);
      Ds[r * kPLd + c] = ds;
      if (drow != nullptr && kpos < sk) drow[kpos] = ds;
    }
    __syncwarp();  // a row's dS is written and read by the same 4 lanes
    for (int c = 0; c < kTile; ++c) {
      const float ds = Ds[r * kPLd + c];
#pragma unroll
      for (int jj = 0; jj < kMaxDim / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) acc[jj] = fmaf(ds, Ks[c * dp + col], acc[jj]);
      }
    }
  }
  if (qrow < sq) {
    float* out = static_cast<float*>(a.dq) + (head + qrow) * d;
#pragma unroll
    for (int jj = 0; jj < kMaxDim / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) out[col] = acc[jj] * a.scale;
    }
  }
}

__global__ void __launch_bounds__(kFmaThreads) bwd_dkv_fma_kernel(FmaArgs a) {
  extern __shared__ float smf[];
  const int sq = a.sq, sk = a.sk, d = a.d, dp = d + 1;
  float* Ks = smf;
  float* Vs = Ks + kTile * dp;
  float* Qs = Vs + kTile * dp;
  float* dOs = Qs + kTile * dp;
  float* Ps = dOs + kTile * dp;  // kTile x kPLd: P^T
  float* Ds = Ps + kTile * kPLd;  // dS^T
  float* lse_s = Ds + kTile * kPLd;
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, hi = blockIdx.y, bi = blockIdx.z;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int key = k0 + r;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const float* ob =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_f32(Ks, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
  load_f32(Vs, vb + (long long)k0 * a.vs.s, a.vs.s, sk - k0, d);
  const size_t head = (size_t)(bi * a.h + hi) * sq;
  // this key's bias column (none past sk)
  const float* bcol = a.bias.p != nullptr && key < sk
                          ? a.bias.p + bi * a.bias.sb + hi * a.bias.sh +
                                key * a.bias.sk
                          : nullptr;

  float dk[kMaxDim / 4], dv[kMaxDim / 4];
#pragma unroll
  for (int jj = 0; jj < kMaxDim / 4; ++jj) dk[jj] = dv[jj] = 0.f;
  const Band band = seg_band(
      a.seg, q_tiles(blockIdx.x, (sq + kTile - 1) / kTile, a.causal, a.window),
      bi, blockIdx.x);
  const SegRows sg = seg_rows(a.seg, true, bi, key, sq, sk);

  for (int qi = band.lo; qi < band.hi; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_f32(Qs, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);
    load_f32(dOs, ob + (long long)q0 * a.dos.s, a.dos.s, sq - q0, d);
    for (int t = threadIdx.x; t < kTile; t += kFmaThreads) {
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
                         sg.sees(0, qrow) && live_row(l);
      float sv = s[jj] * a.scale;
      if (bcol != nullptr && valid) sv += __ldg(bcol + qrow * a.bias.sq);
      const float p = valid ? expf(sv - l) : 0.f;
      Ps[r * kPLd + c] = p;
      Ds[r * kPLd + c] = p * (dpv[jj] - delta_s[c]);
    }
    __syncwarp();  // a key row's P/dS are written and read by the same lanes
    for (int c = 0; c < kTile; ++c) {
      const float p = Ps[r * kPLd + c], ds = Ds[r * kPLd + c];
#pragma unroll
      for (int jj = 0; jj < kMaxDim / 4; ++jj) {
        const int col = c4 + 4 * jj;
        if (col < d) {
          dv[jj] = fmaf(p, dOs[c * dp + col], dv[jj]);
          dk[jj] = fmaf(ds, Qs[c * dp + col], dk[jj]);
        }
      }
    }
  }
  if (key < sk) {
    const size_t at = ((size_t)(bi * a.h + hi) * sk + key) * d;
    float* dk_out = static_cast<float*>(a.dk) + at;
    float* dv_out = static_cast<float*>(a.dv) + at;
#pragma unroll
    for (int jj = 0; jj < kMaxDim / 4; ++jj) {
      const int col = c4 + 4 * jj;
      if (col < d) {
        dk_out[col] = dk[jj] * a.scale;
        dv_out[col] = dv[jj];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <auto Kernel>
int launch(const FmaArgs& a, int tiles, int b, int threads, size_t smem,
           cudaStream_t stream) {
  const int err = set_max_smem<Kernel>(smem);
  if (err) return err;
  FmaArgs arg = a;
  void* params[] = {&arg};
  const cudaError_t launched =
      cudaLaunchKernel(reinterpret_cast<const void*>(Kernel),
                       dim3(tiles, a.h, b), dim3(threads), params, smem,
                       stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

int launch_fma(bool dkv, const FmaArgs& a, int b, cudaStream_t stream) {
  const size_t tile = sizeof(float) * kTile * (a.d + 1);
  const size_t ptile = sizeof(float) * kTile * kPLd;
  if (dkv)
    return launch<bwd_dkv_fma_kernel>(
        a, (a.sk + kTile - 1) / kTile, b, kFmaThreads,
        4 * tile + 2 * ptile + 2 * kTile * sizeof(float), stream);
  return launch<bwd_dq_fma_kernel>(a, (a.sq + kTile - 1) / kTile, b,
                                   kFmaThreads, 4 * tile + ptile, stream);
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
int launch_res_bwd(bool dkv, const FmaArgs& f, int b, int inner_tile,
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
// dQ with d <= 64), either schedule; fp32 kTile both ways, the plain grid.
bool tiles_ok(bool dkv, int dtype, int d, int outer_tile, int inner_tile,
              int persistent) {
  if (dtype == kBF16)
    return outer_tile == kOuter &&
           (inner_tile == 64 || (inner_tile == 128 && d <= 64 && !dkv)) &&
           (persistent == 0 || persistent == 1);
  return dtype == kF32 && outer_tile == kTile && inner_tile == kTile &&
         persistent == 0;
}

int launch_bwd(bool dkv, const FmaArgs& a, int b, int outer_tile,
               int inner_tile, int persistent, int dtype,
               cudaStream_t stream) {
  if (a.d < 1 || a.d > kMaxDim || b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 ||
      !tiles_ok(dkv, dtype, a.d, outer_tile, inner_tile, persistent))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return launch_fma(dkv, a, b, stream);
  return launch_res_bwd(dkv, a, b, inner_tile, persistent, stream);
}

FmaArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta, int h,
                  int sq, int sk, int d, const long long* st,
                  const void* bias, const long long* bst, float scale,
                  int causal, int window, const SegArgs& seg) {
  FmaArgs a{};
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
// persistent: one CTA per SM walking the items (bf16: 128 / 64, or 128 for
// dQ with d <= 64 / 0 or 1; fp32: 64 / 64 / 0). bf16 reads q/k/v/dout and
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
  FmaArgs a = make_args(
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
  FmaArgs a = make_args(
      q, k, v, dout, lse, delta, h, sq, sk, d, st, bias, bst, scale, causal,
      window, make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id, has_pad,
                       sk, sq, outer_tile, inner_tile));
  a.dk = dk;
  a.dv = dv;
  return launch_bwd(true, a, b, outer_tile, inner_tile, persistent, dtype,
                    (cudaStream_t)stream);
}
