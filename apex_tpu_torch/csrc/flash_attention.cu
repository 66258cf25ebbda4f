// Flash-attention forward for Hopper, resident.
//
// Replaces: apex_tpu/ops/flash_attention.py _fwd_kernel (def :251,
// pallas_call in _flash_fwd, :889). Computes O = softmax(scale * Q K^T
// [+ bias] [causal mask]) V and the per-row lse = m + log(l) (fp32), with
// the online-softmax recurrence: a running max m, a running sum l and an
// fp32 accumulator per query row. Causal masking is top-left aligned (key
// k is visible to query q iff k <= q, _apply_pos_masks), K/V tiles past
// the causal diagonal are never loaded, and a row whose every key is
// masked (an all -inf bias row) outputs exactly 0 with lse kNegInf
// (l == 0).
//
// The sliding window (keys [q-w+1, q] causal, [q-w+1, q+w-1] not) and the
// segment ids (a query sees only keys of its own id, never the pad id:
// _seg_mask_if_needed, :226-249) narrow each query tile's band of key
// tiles as the reference's loop limits do (:299-323): the causal limit,
// the window (k_tiles) and, with contiguous_segments, the tile's [lo, hi)
// from the metadata the wrapper computes at this kernel's tiles
// (SegArgs). A block is interior, with no test on its scores, only where
// the causal/window test says so and its query and key tiles hold one
// non-pad id; an edge block tests q_id == k_id beside visible(). A query
// tile whose band is empty still writes o = 0 and lse = kNegInf.
//
// The ring offsets (the reference's off_ref, :262-263): a ring step's
// shards sit at global positions q_off and k_off, and the causal and window
// tests take query row r and key c at (r + q_off) - (c + k_off). Only that
// difference enters, so the entry point takes one signed `shift` = q_off -
// k_off; the bands shift with it (k_tiles), c < sk stays a test of the
// local key. A shift can leave a tile's band, or every band, empty: such
// rows write o = 0 and lse = kNegInf like any row that sees no key. The
// shift is read by the kGen instances alone, so a launch at shift 0 is the
// launch it was.
//
// The additive bias (b|1, h|1, sq, sk), fp32, is read in place through
// four element strides (0 on a broadcast dim) and added after the scale,
// before the row max (_fwd_kernel :274-275). Each thread loads the values
// of its own scores directly (read-only path; BERT's padding bias has the
// query stride 0, so a key tile's values are one row shared by all rows,
// from L1): no staging in shared memory. The bias kernels are separate
// instances (kBias), so the routes without a bias are unchanged.
//
// Bound on this card: in bf16 bytes at the path shapes (1024 tokens: 4 * s
// * d elements moved against 4 * pairs * d FLOPs), operations at long
// sequence; in fp32 operations (67 TFLOP/s of FMA). Two kernels behind one
// entry:
// - bf16 (the serving and training paths): fwd_resident_wgmma<DP, BN, NWG>,
//   wgmma fed by a TMA ring on the pieces it shares with the streamed
//   forward (flash_fwd_wgmma.cuh, flash_bwd_wgmma.cuh):
//   - one CTA holds BM = 64 NWG queries (NWG = 2 consumer warpgroups of 64
//     rows; 1 where RES_FWD_OUTER_TILE = 64) and a producer warp that
//     starts the TMA loads of BN-row K/V tiles (RES_FWD_INNER_TILE) into a
//     kStages-deep ring; mbarriers hand the tiles over;
//   - each CTA takes the whole causal band of its query tile: no split, no
//     fp32 partial, no merge;
//   - persistent (RES_FWD_PERSISTENT): as many CTAs as fit on the card
//     walk the (query tile, b*h) items longest band first; the producer
//     loads the next item's Q while the consumers finish the current one,
//     and the ring's phase runs across items. Else a plain grid of one
//     CTA per item in the same order;
//   - S = Q K^T reads Q and K K-major, O += P V takes P from the score
//     registers as A fragments and V as an MN-major B: no V^T copy; only
//     edge blocks (the diagonal, the ragged end) test each score; exp2
//     with scale log2(e) folded in;
//   - o is rounded to bf16 into a swizzled staging tile per warpgroup and
//     stored by TMA, which writes no row past sq and no column past d: no
//     row is written twice, and two calls give the same bits; lse is
//     written per row by the consumers.
//   q/k/v are read through (b, h, s, d) tensor maps, so strided views (the
//   fused-QKV heads) go in without a copy; what TMA refuses (a base or
//   stride off 16 bytes, d % 8 != 0) the wrapper passes as a padded copy.
//   A head_dim up to 64 takes the 64-wide kernels (TMA zero-fills the
//   columns past d), up to 128 the 128-wide ones, on 64-row key tiles.
// - fp32 (the O0 pretrain, generate_gpt's prefill, the fp32 gradient
//   gates): fwd_f32_blocked (flash_f32_blocked.cuh), register-blocked FMA
//   fed by a two-stage cp.async ring, on the pieces of the fp32 backward
//   pair (dq_f32_blocked / dkv_f32_blocked) and the step the streamed fp32
//   forward shares:
//   - a CTA of 4 warps keeps 64 queries (RES_FWD_F32_OUTER_TILE; Q loaded
//     once) and streams the 64-row key tiles of its whole band
//     (RES_FWD_F32_INNER_TILE), the next tile landing while this one
//     computes: no split, no workspace, no merge; one CTA an item, the
//     longest band first (128-row CTAs, 32-row key tiles and the
//     persistent grid were slower on the card: PERF.md);
//   - each thread holds a 4 x BN/8 micro-tile of S and a 4 x DP/8 one of
//     O, so every shared-memory operand is read once a micro-tile, 16 bytes
//     at a time (the first port's kernel read one operand an FMA and
//     reached 6% of 67 TFLOP/s);
//   - on the FMA units, not split TF32: S is one fmaf chain over the head
//     dimension in column order, O the online recurrence's chain over the
//     keys, and exp is expf in natural units, as the plain version takes
//     it; the fp32 limits (each row within 1e-5, the segment cases 2e-6)
//     are those split TF32 missed in the backward (PERF.md). On the card,
//     against the plain version: o 3.2e-7 of max |ref| and a worst row of
//     1.4e-6 at (4,16,1024,64) causal (SDPA's fp32 forward 6.1e-7 and
//     2.5e-6), the segment cases 1-5e-7;
//   - masks only on edge tiles; the bias in kBias instances, each thread
//     loading its scores' values; the window and segment ids in kGen ones;
//   - o written once, times 1 / l, lse by each row's first lane: two calls
//     give the same bits.
//   Any sq, sk and d <= 128 (64-wide instances up to d = 64; above, 64
//   queries over 32-row key tiles); q/k/v strided over (b, h, s) with a
//   contiguous head_dim, 16-byte copies where the rows allow.

#include "flash_f32_blocked.cuh"
#include "flash_fwd_wgmma.cuh"

namespace apex_torch {
namespace {

constexpr int kMaxD = 128;

// fp32: fwd_f32_blocked (flash_f32_blocked.cuh) over the items of the whole
// bands, one split each (no workspace, no merge), plain grid
int launch_res_fwd_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int b, int h, int sq, int sk, int d,
                       Strides qs, Strides ks, Strides vs, float scale,
                       int causal, int window, int shift,
                       const BiasArgs& bias, const SegArgs& seg,
                       int inner_tile, cudaStream_t stream) {
  FwdF32Args a = fwd_f32_args(q, k, v, o, lse, h, b * h, sq, sk, d, qs, ks,
                              vs, scale, causal, window, shift, seg, nullptr,
                              nullptr, nullptr,
                              (sk + inner_tile - 1) / inner_tile, 1);
  a.bias = bias;
  return launch_fwd_f32<false>(a, stream);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring, one CTA per whole band, persistent
// ---------------------------------------------------------------------------

struct ResFwdMaps {
  CUtensorMap q, k, v;  // encode_rows_map: 64 x 64 boxes
  CUtensorMap o;        // (b, h, sq, d) contiguous, the TMA store's
};

struct ResFwdArgs {
  float* lse;  // (b*h, sq) contiguous
  int h, sq, sk;
  uint32_t qpos, kpos, vpos, opos;  // coordinate placement of each map
  float scale;
  int causal, window;
  int shift;        // q_off - k_off (k_tiles); kGen instances only
  int bh, n_outer;  // b*h, query tiles of a head
  int items;        // bh * n_outer: the CTAs of the plain grid
  BiasArgs bias;    // read by the kBias instances only
  SegArgs seg;
};

// NWG consumer warpgroups of 64 queries each (BM = 64 NWG query rows an
// item), then the producer's warpgroup. With one consumer two CTAs can
// share an SM: 128 registers a thread at launch, the producer's handed
// over (setmaxnreg) so that the consumer holds 232; with two, 168 at
// launch and 240 after, as in the backward.
template <int NWG>
struct ResFwdShape {
  static constexpr int kThreads = (NWG + 1) * kWg;
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;
  static constexpr int kConsumerRegs = NWG == 1 ? 232 : 240;
};

// Item w is query tile n_outer - 1 - w / bh (longest causal band first) of
// head w % bh; a CTA takes the items blockIdx.x, + gridDim.x, ... For each
// it keeps BM queries (Q, loaded once by TMA) and streams the BN-row key
// tiles of the whole causal band (K, V) through the ring: no split, no fp32
// partial, no merge. Warpgroup g < NWG owns queries [64 g, 64 g + 64) of
// the tile and runs fwd_tile on each key tile; the producer's first thread
// starts the TMA loads, the next item's Q as soon as the consumers are done
// with the current one (the q_full / q_empty pair), while they finish and
// store; the ring's phase runs across items. Each warpgroup rounds its o to
// bf16 into a staging tile of its own in TMA's swizzled layout and one of
// its threads stores it by TMA (no row past sq, no column past d written);
// its threads write the rows' lse. kBias: the additive bias, added to each
// key tile's scores before the row max (fwd_tile). kGen: the general masks,
// the window and the segment ids: the band is then the causal limit, the
// window and the segment bounds (seg_band; an empty one writes o = 0 and
// lse = kNegInf like a fully masked row), and edge blocks take the segment
// test; the ring's shift joins the masks and the bands there too. The
// instances without them are the causal kernel as it was.
template <int DP, int BN, int NWG, bool kBias, bool kGen>
__global__ void __launch_bounds__(ResFwdShape<NWG>::kThreads,
                                  ResFwdShape<NWG>::kMinBlocks)
    fwd_resident_wgmma(const __grid_constant__ ResFwdMaps maps,
                       const ResFwdArgs a) {
  constexpr int BM = 64 * NWG;
  using L = FwdLayout<DP, BN, BM, true>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;  // an item's Q has landed
  uint64_t* q_empty = q_full + 1;      // the consumers are done with it
  const int nk = (a.sk + BN - 1) / BN;
  const int window = kGen ? a.window : 0;
  const int shift = kGen ? a.shift : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NWG);  // each consumer warp
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * NWG);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == NWG) {  // the producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x != NWG * kWg) return;
    int it = 0;  // ring tiles so far, over this CTA's items
    for (int w = blockIdx.x, j = 0; w < a.items; w += gridDim.x, ++j) {
      const int bh = w % a.bh, qt = a.n_outer - 1 - w / a.bh;
      const int bi = bh / a.h, hi = bh - bi * a.h;
      Band band = k_tiles(qt, nk, a.causal, window, BM, BN, shift);
      if constexpr (kGen) band = seg_band(a.seg, band, bi, qt);
      hopper::mbar_wait(q_empty, (j & 1) ^ 1);
      hopper::mbar_arrive_tx(q_full, L::kQBytes);
      tma_rows<DP, BM>(base, &maps.q, a.qpos, q_full, qt * BM, hi, bi);
      for (int i = band.lo; i < band.hi; ++i, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* ks = base + L::kRing + s * 2 * L::kTileBytes;
        hopper::mbar_arrive_tx(&full[s], 2 * L::kTileBytes);
        tma_rows<DP, BN>(ks, &maps.k, a.kpos, &full[s], i * BN, hi, bi);
        tma_rows<DP, BN>(ks + L::kTileBytes, &maps.v, a.vpos, &full[s],
                         i * BN, hi, bi);
      }
    }
    return;
  }

  hopper::regs_alloc<ResFwdShape<NWG>::kConsumerRegs>();
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // rows of d[i]: + 8 ((i/2)%2)
  const int kcol = 2 * (lane % 4);      // + 8 (i/4) + i%2
  const float c = a.scale * kLog2e;
  const uint32_t qs = hopper::smem_u32(base);
  const uint32_t ring = hopper::smem_u32(base + L::kRing);
  unsigned char* stage = base + L::kStage + wg * 64 * kRowBytes;
  int it = 0;
  for (int w = blockIdx.x, j = 0; w < a.items; w += gridDim.x, ++j) {
    const int bh = w % a.bh, qt = a.n_outer - 1 - w / a.bh;
    const int bi = bh / a.h, hi = bh - bi * a.h;
    const int qw = qt * BM + wg * 64;  // this warpgroup's queries
    Band band = k_tiles(qt, nk, a.causal, window, BM, BN, shift);
    SegRows sg{};
    if constexpr (kGen) {
      band = seg_band(a.seg, band, bi, qt);
      sg = seg_rows(a.seg, false, bi, qw + r0, a.sq, a.sk);
    }
    BiasLines brows{};
    if constexpr (kBias) brows = bias_rows(a.bias, bi, hi, qw + r0, a.sq);
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m2[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
    float l[2] = {0.f, 0.f};
    hopper::mbar_wait(q_full, j & 1);
    const int nt = band.hi - band.lo;
    for (int n = 0; n < nt; ++n) {
      const int g = it + n, s = g % kStages, k0 = (band.lo + n) * BN;
      const uint32_t ks = ring + s * 2 * L::kTileBytes;
      hopper::mbar_wait(&full[s], (g / kStages) & 1);
      if constexpr (kGen)
        fwd_tile<DP, BM, BN, kBias, true>(
            o, m2, l, qs, wg * 64, ks, ks + L::kTileBytes, c,
            qw + r0 + shift, k0 + kcol, a.sk, a.causal, a.window,
            !interior<BN>(qw + shift, k0, a.sk, a.causal, a.window) ||
                !seg_interior(a.seg, sg, bi, qt, band.lo + n, k0, BN),
            brows, &sg);
      else
        fwd_tile<DP, BM, BN, kBias>(o, m2, l, qs, wg * 64, ks,
                                    ks + L::kTileBytes, c, qw + r0, k0 + kcol,
                                    a.sk, a.causal, 0,
                                    !interior<BN>(qw, k0, a.sk, a.causal, 0),
                                    brows);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    it += nt;
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(q_empty);

    row_sums(l);
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                          l[1] > 0.f ? 1.f / l[1] : 0.f};
    if (lane % 4 == 0) {
      const size_t head = (size_t)bh * a.sq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = qw + r0 + 8 * hf;
        if (row < a.sq) a.lse[head + row] = lse_of(m2[hf], l[hf]);
      }
    }
    staging_free(wg);
    stage_rows<DP, BM>(stage, o, inv[0], inv[1]);
    staging_ready(wg);
    if (tid == 0) {
      store_rows<DP, BM>(&maps.o, a.opos, stage, qw, hi, bi);
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();
}

// One kernel with its shared memory over `grid` CTAs.
template <int DP, int BN, int NWG, bool kBias, bool kGen>
int launch_res_fwd_k(const ResFwdMaps& maps, const ResFwdArgs& a,
                     bool persistent, cudaStream_t stream) {
  constexpr size_t smem = FwdLayout<DP, BN, 64 * NWG, true>::kBytes;
  constexpr int threads = ResFwdShape<NWG>::kThreads;
  auto kernel = fwd_resident_wgmma<DP, BN, NWG, kBias, kGen>;
  int err = set_max_smem<fwd_resident_wgmma<DP, BN, NWG, kBias, kGen>>(smem);
  if (err) return err;
  int grid = a.items;
  if (persistent) {  // as many CTAs as fit on the card at once
    static int per_sm = 0;  // CTAs an SM holds: once per instantiation
    int dev = 0, sms = 0;
    err = (int)cudaGetDevice(&dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
    if (!err && per_sm == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, smem);
    if (err) return err;
    const int fit = sms * (per_sm > 0 ? per_sm : 1);
    grid = grid < fit ? grid : fit;
  }
  kernel<<<grid, threads, smem, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// The instance with the bias where one is given, and with the general
// masks where a window, segment ids or a ring shift are
template <int DP, int BN, int NWG>
int launch_res_fwd(const ResFwdMaps& maps, const ResFwdArgs& a,
                   bool persistent, cudaStream_t stream) {
  const bool bias = a.bias.p != nullptr;
  if (a.window > 0 || a.seg.q != nullptr || a.shift != 0)
    return bias ? launch_res_fwd_k<DP, BN, NWG, true, true>(maps, a,
                                                            persistent, stream)
                : launch_res_fwd_k<DP, BN, NWG, false, true>(
                      maps, a, persistent, stream);
  return bias ? launch_res_fwd_k<DP, BN, NWG, true, false>(maps, a,
                                                           persistent, stream)
              : launch_res_fwd_k<DP, BN, NWG, false, false>(maps, a,
                                                            persistent,
                                                            stream);
}

// bf16: the tensor maps of q, k, v and o, then the kernel of the padded
// head_dim (64 or 128), the key tile (64 or 128 rows where d <= 64; 64
// above, where 128-row tiles and the staging overflow shared memory) and
// the query tile (128 rows, or 64 where d <= 64).
int launch_res_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int h, int sq, int sk, int d,
                        Strides qs, Strides ks, Strides vs, float scale,
                        int causal, int window, int shift,
                        const BiasArgs& bias, const SegArgs& seg,
                        int outer_tile, int inner_tile, int persistent,
                        cudaStream_t stream) {
  ResFwdMaps maps;
  ResFwdArgs a{};
  a.bias = bias;
  a.seg = seg;
  a.window = window;
  a.shift = shift;
  int err = encode_rows_map(&maps.q, &a.qpos, q, b, h, sq, d, qs.b, qs.h,
                            qs.s);
  if (!err) err = encode_rows_map(&maps.k, &a.kpos, k, b, h, sk, d, ks.b,
                                  ks.h, ks.s);
  if (!err) err = encode_rows_map(&maps.v, &a.vpos, v, b, h, sk, d, vs.b,
                                  vs.h, vs.s);
  if (!err) err = encode_rows_map(&maps.o, &a.opos, o, b, h, sq, d,
                                  (long long)h * sq * d, (long long)sq * d,
                                  d);
  if (err) return err;
  a.lse = static_cast<float*>(lse);
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.causal = causal;
  a.bh = b * h;
  a.n_outer = (sq + outer_tile - 1) / outer_tile;
  const long long items = (long long)a.bh * a.n_outer;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  const bool p = persistent != 0;
  if (d > 64) return launch_res_fwd<128, 64, 2>(maps, a, p, stream);
  if (outer_tile == 64)
    return inner_tile == 64 ? launch_res_fwd<64, 64, 1>(maps, a, p, stream)
                            : launch_res_fwd<64, 128, 1>(maps, a, p, stream);
  return inner_tile == 64 ? launch_res_fwd<64, 64, 2>(maps, a, p, stream)
                          : launch_res_fwd<64, 128, 2>(maps, a, p, stream);
}

// The tiles a caller names: bf16 128 (or 64 where d <= 64) query rows, 64
// (or 128 where d <= 64) key rows, either schedule; fp32 those of
// fwd_f32_tiles_ok on the plain grid.
bool fwd_tiles_ok(int dtype, int d, int outer_tile, int inner_tile,
                  int persistent) {
  if (dtype == kBF16)
    return (persistent == 0 || persistent == 1) &&
           (outer_tile == 128 || (outer_tile == 64 && d <= 64)) &&
           (inner_tile == 64 || (inner_tile == 128 && d <= 64));
  return dtype == kF32 && persistent == 0 &&
         fwd_f32_tiles_ok(d, outer_tile, inner_tile);
}

}  // namespace

}  // namespace apex_torch

using namespace apex_torch;

// q/k/v strides in elements: (batch, head, seq); the head_dim stride is 1.
// o is contiguous (b, h, sq, d) in q's dtype; lse contiguous (b, h, sq) fp32.
// bias: an fp32 (b|1, h|1, sq, sk) additive bias read through its element
// strides (bsb, bsh, bsq, bsk; 0 on a broadcast dim), or null for none.
// window <= 0: none. shift: q_off - k_off, the global position of q's row 0
// minus k's (a ring step's offsets; 0 unsharded), which the causal and
// window tests and their bands take. outer_tile / inner_tile: the query
// rows of an item and
// the key rows of a streamed tile; persistent: as many CTAs as fit on the
// card walking the items (bf16: 128, or 64 where d <= 64 / 64 or 128 / 0 or
// 1; fp32: 64 / 64, or 64 / 32 above d = 64 / 0). bf16 reads q/k/v and
// writes o by TMA: 16-byte-aligned bases and strides, d % 8 == 0. qseg /
// kseg: int32 (b, sq) / (b, sk) segment ids, or null for none; bounds and
// ranges (both null: mask only), omm, imm: their (b, 2, n) metadata at
// outer_tile / inner_tile, ranges over the keys of each query (SegArgs);
// pad_id counts where has_pad.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int sq, int sk,
                              int d, long long qsb, long long qsh,
                              long long qss, long long ksb, long long ksh,
                              long long kss, long long vsb, long long vsh,
                              long long vss, const void* bias,
                              long long bsb, long long bsh, long long bsq,
                              long long bsk, float scale, int causal,
                              int window, int shift, int outer_tile,
                              int inner_tile,
                              int persistent, int dtype, const void* qseg,
                              const void* kseg, const void* bounds,
                              const void* omm, const void* imm,
                              const void* ranges, int pad_id, int has_pad,
                              void* stream) {
  if (d < 1 || d > kMaxD || b < 1 || h < 1 || sq < 1 || sk < 1 ||
      !fwd_tiles_ok(dtype, d, outer_tile, inner_tile, persistent) ||
      !seg_ok(qseg, kseg, bounds, omm, imm, ranges))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const BiasArgs ba{static_cast<const float*>(bias), bsb, bsh, bsq, bsk};
  const SegArgs seg = make_seg(qseg, kseg, bounds, omm, imm, ranges, pad_id,
                               has_pad, sq, sk, outer_tile, inner_tile);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_res_fwd_f32(q, k, v, o, lse, b, h, sq, sk, d, qs, ks, vs,
                              scale, causal, window, shift, ba, seg,
                              inner_tile, s);
  return launch_res_fwd_bf16(q, k, v, o, lse, b, h, sq, sk, d, qs, ks, vs,
                             scale, causal, window, shift, ba, seg,
                             outer_tile, inner_tile, persistent, s);
}
