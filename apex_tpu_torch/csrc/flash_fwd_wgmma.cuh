// Device pieces of the bf16 flash-attention forward on wgmma fed by a TMA
// ring, shared by the streamed forward (fwd_wgmma,
// flash_attention_stream.cu) and the resident one (fwd_resident_wgmma,
// flash_attention.cu): the shared-memory layout of a CTA, one key tile of
// the online softmax in base 2, and a consumer warpgroup's step over one
// key tile (scores, the online softmax, P as register fragments, O += P V).
// The bands, the TMA row loads, the descriptors, the products and
// `interior` come from flash_bwd_wgmma.cuh.

#pragma once

#include "flash_bwd_wgmma.cuh"

namespace apex_torch {
namespace {

constexpr int kFwdOuter = 128;  // query rows of a streamed CTA (two warpgroups)
constexpr float kLn2 = 0.6931471805599453f;

// Byte offsets in dynamic shared memory (after aligning it to 1024): Q (BM
// rows), the ring of (K, V) pairs of BN rows each, the output staging (BM
// rows where kStaged: the resident forward's TMA store), mbarriers (the
// ring's full and empty ones, then a pair for Q).
template <int DP, int BN, int BM = kFwdOuter, bool kStaged = false>
struct FwdLayout {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQBytes = kChunks * BM * kRowBytes;
  static constexpr int kTileBytes = kChunks * BN * kRowBytes;
  static constexpr int kRing = kQBytes;
  static constexpr int kStage = kRing + kStages * 2 * kTileBytes;
  static constexpr int kBars = kStage + (kStaged ? kQBytes : 0);
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 2) * 8;
};

// One key tile of the online softmax in base 2, on a warpgroup's 64 x BN
// scores st: element i is row `row` + 8 ((i/2)%2), key col + 8 (i/4) + i%2.
// m2 (the running max of scale log2(e) s), l (this thread's share of the
// running sum) and the rows' rescale factors alpha, per row half; st
// becomes P. kMask: an edge block, so each pair is tested; a masked score
// is -inf and exp2 makes it exactly 0. A row with nothing visible yet keeps
// m2 = -inf and subtracts 0 instead, so its P and alpha are 0, not NaN.
template <bool kMask, int BN>
__device__ __forceinline__ void online_softmax(float (&st)[BN / 2],
                                               float (&m2)[2], float (&l)[2],
                                               float (&alpha)[2], float c,
                                               int row, int col, int sk,
                                               int causal, int window) {
  const float ninf = __int_as_float(0xff800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int hf = (i >> 1) & 1;
    if (kMask && !visible(row + 8 * hf, col + 8 * (i >> 2) + (i & 1), sk,
                          causal, window))
      st[i] = ninf;
    mx[hf] = fmaxf(mx[hf], st[i]);
  }
  float sub[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float m_new = fmaxf(m2[hf], mx[hf] * c);
    sub[hf] = m_new == ninf ? 0.f : m_new;
    alpha[hf] = hopper::fast_exp2(m2[hf] - sub[hf]);
    m2[hf] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int hf = (i >> 1) & 1;
    st[i] = hopper::fast_exp2(fmaf(st[i], c, -sub[hf]));
    sum[hf] += st[i];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// A consumer warpgroup's step over one key tile that has landed: S = Q K^T
// over the warpgroup's 64 rows (from row q_row of a BM-row Q tile; both
// operands K-major), the online softmax (the masked instance only on an
// edge block), o rescaled, then O += P V with P straight from the score
// registers as A fragments and V read through the descriptor as an
// MN-major B -- no V^T copy, no P in shared memory. Each product group is
// waited for in straight-line code. row / col: the thread's first query's
// position for the masks (its row, plus a ring step's shift: k_tiles) and
// its first key (online_softmax); edge: whether the block needs the test (in the
// general-mask kernels, kGen, with the rows' segment step, seg_mask of
// sg, first). kBias: the
// additive bias (the resident forward's), read through `bias` (the rows of
// row and row + 8, add_bias) and added in base 2 before the row max, as
// _fwd_kernel adds it after the scale (s = (q scale) k^T + bias).
template <int DP, int BM, int BN, bool kBias = false, bool kGen = false>
__device__ __forceinline__ void fwd_tile(
    float (&o)[DP / 2], float (&m2)[2], float (&l)[2], uint32_t qs,
    int q_row, uint32_t ks, uint32_t vs, float c, int row, int col, int sk,
    int causal, int window, bool edge, const BiasLines& bias = {},
    const SegRows* sg = nullptr) {
  float st[BN / 2];
  hopper::wgmma_fence();
  scores<DP, BM, BN>(st, qs, q_row, ks);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(st);
  if constexpr (kBias) {
    add_bias<BN, false>(st, bias, c, col, sk);
    c = 1.f;  // st is in base 2 now
  }
  float alpha[2];
  if constexpr (kGen) {
    if (edge) seg_mask<BN>(st, *sg, col);
  }
  if (edge)
    online_softmax<true, BN>(st, m2, l, alpha, c, row, col, sk, causal,
                             window);
  else
    online_softmax<false, BN>(st, m2, l, alpha, c, row, col, sk, causal,
                              window);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  uint32_t pf[BN / 16][4];
  fragments<BN>(pf, st);
  hopper::wgmma_fence();
  hopper::fence_regs(o);
  accumulate<DP, BN>(o, pf, vs);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
}

// The row sums of a warpgroup's rows (each thread holds a quarter of its
// rows' columns), summed over the four threads of a row.
__device__ __forceinline__ void row_sums(float (&l)[2]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
  }
}

// The lse of a row in natural units from its base-2 max and its sum:
// kNegInf where the row saw no key (l == 0)
__device__ __forceinline__ float lse_of(float m2, float l) {
  return l > 0.f ? m2 * kLn2 + logf(l) : kNegInf;
}

}  // namespace
}  // namespace apex_torch
