// Flash-attention backward for Hopper: a dQ kernel and a dK/dV kernel.
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
// The TPU kernels keep the whole K/V (dQ pass) or Q/dO (dK/dV pass)
// resident in VMEM (the kfull/qfull BlockSpecs, :1239 and :1312). That is a
// VMEM layout rule, not behaviour: here 64-row tiles stream through shared
// memory and any sequence length works.
//
// Bound on this card: operations (3 products of 2*d FLOPs per pair in the
// dQ pass, 4 in the dK/dV pass, against 4-5 (s, d) operands moved once).
// Design (simple first; wgmma, TMA and pipelined loads are later work):
// - two passes and no atomics, deterministic as the reference: one CTA per
//   (64-query tile, head, batch) loops over the key tiles up to the causal
//   limit (:402-404) and keeps dQ in fp32 registers; one CTA per (64-key
//   tile, head, batch) keeps its K/V tile in shared memory and dK/dV in fp32
//   registers, and loops over the query tiles from the causal start (:478);
// - bf16: every product on the tensor cores with mma.sync m16n8k16 (fp32
//   sums), 4 warps of 16 tile rows each; P and dS are rounded to bf16 as
//   the A operands of the dV/dK/dQ products (the reference kernel keeps them
//   fp32), which the bf16 tolerance against the plain version covers; the
//   S/dP accumulators feed those products straight from registers;
// - fp32: plain FMA, 4 neighbouring lanes per tile row, operands in shared
//   memory as fp32 (rows padded by one word against bank conflicts).
// Any sq, sk and d <= 128 (unaligned d takes scalar loads); q/k/v/dO may be
// strided (b, h, s) with a contiguous head_dim.

#include "common.cuh"

namespace apex_torch {
namespace {

constexpr int kFmaThreads = 256;  // 4 lanes per tile row
constexpr int kMaxDim = 128;
constexpr int kPLd = kTile + 1;   // fp32 P / dS tile rows

struct BwdArgs {
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
  int causal;
};

__device__ __forceinline__ bool live_row(float lse) {
  return lse > kNegInf * 0.5f;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;      // Q, dO, K, V rows, in halves
  constexpr int LDT = kTile + 8;  // K^T rows
  constexpr int NT = kTile / 8;   // key n-tiles of S / dP per warp
  constexpr int DT = DP / 8;      // dim n-tiles of dQ per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;
  bf16* Vs = Ks + kTile * LD;
  bf16* Kt = Vs + kTile * LD;  // DP x LDT

  const int q0 = blockIdx.x * kTile, hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const int rowA = q0 + wr + g, rowB = rowA + 8;
  const int sq = a.sq, sk = a.sk, d = a.d;

  const bf16* qb = static_cast<const bf16*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const bf16* ob =
      static_cast<const bf16*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_rows<DP, VEC>(Qs, LD, qb + (long long)q0 * a.qs.s, a.qs.s, sq - q0, d);
  load_rows<DP, VEC>(dOs, LD, ob + (long long)q0 * a.dos.s, a.dos.s, sq - q0,
                     d);

  const size_t head = (size_t)(bi * a.h + hi) * sq;
  const float lseA = rowA < sq ? a.lse[head + rowA] : kNegInf;
  const float lseB = rowB < sq ? a.lse[head + rowB] : kNegInf;
  const float dlA = rowA < sq ? a.delta[head + rowA] : 0.f;
  const float dlB = rowB < sq ? a.delta[head + rowB] : 0.f;
  const bool liveA = live_row(lseA), liveB = live_row(lseB);

  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int nk = (sk + kTile - 1) / kTile;
  if (a.causal) nk = min(nk, (q0 + 2 * kTile - 1) / kTile);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
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
        const bool valid = col < sk && (!a.causal || col <= row) &&
                           (up ? liveA : liveB);
        const float p =
            valid ? expf(s[nt][i] * a.scale - (up ? lseA : lseB)) : 0.f;
        s[nt][i] = p * (dp[nt][i] - (up ? dlA : dlB));
      }
    }

    // dQ += dS K  (dS as the A operand straight from its accumulators)
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

  bf16* out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int row = i < 2 ? rowA : rowB;
      if (row < sq && col < d)
        out[(head + row) * d + col] = __float2bfloat16_rn(dq[dt][i] * a.scale);
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkv_mma_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;      // K, V, Q, dO rows, in halves
  constexpr int LDT = kTile + 8;  // Q^T, dO^T rows
  constexpr int NT = kTile / 8;   // query n-tiles of S^T / dP^T per warp
  constexpr int DT = DP / 8;      // dim n-tiles of dK / dV per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* dOs = Qs + kTile * LD;
  bf16* Qt = dOs + kTile * LD;  // DP x LDT
  bf16* dOt = Qt + DP * LDT;
  float* lse_s = reinterpret_cast<float*>(dOt + DP * LDT);
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const int keyA = k0 + wr + g, keyB = keyA + 8;
  const int sq = a.sq, sk = a.sk, d = a.d;

  const bf16* qb = static_cast<const bf16*>(a.q) + bi * a.qs.b + hi * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bi * a.ks.b + hi * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bi * a.vs.b + hi * a.vs.h;
  const bf16* ob =
      static_cast<const bf16*>(a.dout) + bi * a.dos.b + hi * a.dos.h;
  load_rows<DP, VEC>(Ks, LD, kb + (long long)k0 * a.ks.s, a.ks.s, sk - k0, d);
  load_rows<DP, VEC>(Vs, LD, vb + (long long)k0 * a.vs.s, a.vs.s, sk - k0, d);
  const size_t head = (size_t)(bi * a.h + hi) * sq;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int nq = (sq + kTile - 1) / kTile;
  // causal: query tiles wholly above this key tile see none of its keys
  const int start = a.causal ? min(k0 / kTile, nq) : 0;

  for (int qi = start; qi < nq; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();  // the previous tile's readers are done
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
        const bool valid = qrow < sq && key < sk &&
                           (!a.causal || key <= qrow) && live_row(l);
        const float p = valid ? expf(s[nt][i] * a.scale - l) : 0.f;
        s[nt][i] = p;
        dp[nt][i] = p * (dp[nt][i] - delta_s[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from registers
#pragma unroll
    for (int kt = 0; kt < kTile / 16; ++kt) {
      const uint32_t p0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t p1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t p2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const uint32_t d0 = pack_bf16(dp[2 * kt][0], dp[2 * kt][1]);
      const uint32_t d1 = pack_bf16(dp[2 * kt][2], dp[2 * kt][3]);
      const uint32_t d2 = pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]);
      const uint32_t d3 = pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int off = (dt * 8 + g) * LDT + kt * 16 + tig * 2;
        mma_bf16(dv[dt], p0, p1, p2, p3, ld32(dOt + off), ld32(dOt + off + 8));
        mma_bf16(dk[dt], d0, d1, d2, d3, ld32(Qt + off), ld32(Qt + off + 8));
      }
    }
  }

  const size_t khead = (size_t)(bi * a.h + hi) * sk;
  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dt * 8 + tig * 2 + (i & 1);
      const int key = i < 2 ? keyA : keyB;
      if (key < sk && col < d) {
        const size_t at = (khead + key) * d + col;
        dk_out[at] = __float2bfloat16_rn(dk[dt][i] * a.scale);
        dv_out[at] = __float2bfloat16_rn(dv[dt][i]);
      }
    }
  }
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

__global__ void __launch_bounds__(kFmaThreads) bwd_dq_fma_kernel(BwdArgs a) {
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

  float acc[kMaxDim / 4];
#pragma unroll
  for (int jj = 0; jj < kMaxDim / 4; ++jj) acc[jj] = 0.f;
  int nk = (sk + kTile - 1) / kTile;
  if (a.causal) nk = min(nk, (q0 + 2 * kTile - 1) / kTile);

  for (int j = 0; j < nk; ++j) {
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
      const bool valid = kpos < sk && (!a.causal || kpos <= qrow) && live;
      const float p = valid ? expf(s[jj] * a.scale - l) : 0.f;
      Ds[r * kPLd + c] = p * (dpv[jj] - dl);
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

__global__ void __launch_bounds__(kFmaThreads) bwd_dkv_fma_kernel(BwdArgs a) {
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

  float dk[kMaxDim / 4], dv[kMaxDim / 4];
#pragma unroll
  for (int jj = 0; jj < kMaxDim / 4; ++jj) dk[jj] = dv[jj] = 0.f;
  const int nq = (sq + kTile - 1) / kTile;
  const int start = a.causal ? min(k0 / kTile, nq) : 0;

  for (int qi = start; qi < nq; ++qi) {
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
      const bool valid = qrow < sq && key < sk &&
                         (!a.causal || key <= qrow) && live_row(l);
      const float p = valid ? expf(s[jj] * a.scale - l) : 0.f;
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
int launch(const BwdArgs& a, int tiles, int b, int threads, size_t smem,
           cudaStream_t stream) {
  const int err = set_max_smem<Kernel>(smem);
  if (err) return err;
  BwdArgs arg = a;
  void* params[] = {&arg};
  const cudaError_t launched =
      cudaLaunchKernel(reinterpret_cast<const void*>(Kernel),
                       dim3(tiles, a.h, b), dim3(threads), params, smem,
                       stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

template <int DP, bool VEC>
int launch_mma(bool dkv, const BwdArgs& a, int b, cudaStream_t stream) {
  constexpr size_t rows = sizeof(__nv_bfloat16) * kTile * (DP + 8);
  constexpr size_t trans = sizeof(__nv_bfloat16) * DP * (kTile + 8);
  if (dkv)
    return launch<bwd_dkv_mma_kernel<DP, VEC>>(
        a, (a.sk + kTile - 1) / kTile, b, kMmaThreads,
        4 * rows + 2 * trans + 2 * kTile * sizeof(float), stream);
  return launch<bwd_dq_mma_kernel<DP, VEC>>(a, (a.sq + kTile - 1) / kTile, b,
                                            kMmaThreads, 4 * rows + trans,
                                            stream);
}

template <int DP>
int launch_mma_dp(bool vec, bool dkv, const BwdArgs& a, int b,
                  cudaStream_t stream) {
  return vec ? launch_mma<DP, true>(dkv, a, b, stream)
             : launch_mma<DP, false>(dkv, a, b, stream);
}

int launch_bwd(bool dkv, const BwdArgs& a, int b, int dtype,
               cudaStream_t stream) {
  if (a.d < 1 || a.d > kMaxDim || b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    const size_t tile = sizeof(float) * kTile * (a.d + 1);
    const size_t ptile = sizeof(float) * kTile * kPLd;
    if (dkv)
      return launch<bwd_dkv_fma_kernel>(
          a, (a.sk + kTile - 1) / kTile, b, kFmaThreads,
          4 * tile + 2 * ptile + 2 * kTile * sizeof(float), stream);
    return launch<bwd_dq_fma_kernel>(a, (a.sq + kTile - 1) / kTile, b,
                                     kFmaThreads, 4 * tile + ptile, stream);
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  const bool vec = vec_ok(a.d, a.q, a.qs) && vec_ok(a.d, a.k, a.ks) &&
                   vec_ok(a.d, a.v, a.vs) && vec_ok(a.d, a.dout, a.dos);
  if (a.d <= 32) return launch_mma_dp<32>(vec, dkv, a, b, stream);
  if (a.d <= 64) return launch_mma_dp<64>(vec, dkv, a, b, stream);
  return launch_mma_dp<128>(vec, dkv, a, b, stream);
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta, int h,
                  int sq, int sk, int d, const long long* st, float scale,
                  int causal) {
  BwdArgs a{};
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
  return a;
}

}  // namespace
}  // namespace apex_torch

using namespace apex_torch;

// q/k/v/dout strides in elements, (batch, head, seq) each, head_dim stride 1.
// lse/delta contiguous (b, h, sq) fp32; dq contiguous (b, h, sq, d) in q's
// dtype.
extern "C" int apex_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int sq,
    int sk, int d, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal,
    int dtype, void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  BwdArgs a = make_args(q, k, v, dout, lse, delta, h, sq, sk, d, st, scale,
                        causal);
  a.dq = dq;
  return launch_bwd(false, a, b, dtype, (cudaStream_t)stream);
}

// dk/dv contiguous (b, h, sk, d) in k's dtype; other arguments as above.
extern "C" int apex_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int sq, int sk, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int dtype, void* stream) {
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  BwdArgs a = make_args(q, k, v, dout, lse, delta, h, sq, sk, d, st, scale,
                        causal);
  a.dk = dk;
  a.dv = dv;
  return launch_bwd(true, a, b, dtype, (cudaStream_t)stream);
}
