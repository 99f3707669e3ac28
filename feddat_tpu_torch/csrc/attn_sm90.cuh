// Whole-sequence attention for Hopper (sm_90a): the forward core and the
// per-head backward of kernels #1, #3, #4, #5 and #6.
//
// One function each way, at the TPU kernels' rounding points, on q/k/v
// [B, H, S, 64] bf16 and a [B, S] fp32 padding-bias row:
//
//   forward   s   = fp32(q k^T) * scale + bias_row     (two roundings: __fmul_rn, __fadd_rn)
//             m   = the exact max of s over all S keys (no running max)
//             p   = exp(s - m),  l = sum(p)            (fp32, l over the unrounded p)
//             o   = bf16((bf16(p) . v) / l),  lse = m + log(l)
//   backward  p  = exp(s - lse),  dv = bf16(bf16(p)^T . dO)
//             dp = dO v^T,  delta = rowsum(dO * o)     (fp32)
//             ds = bf16(p (dp - delta))
//             dq = bf16((ds . k) * scale),  dk = bf16((ds^T . q) * scale)
//
// P is rounded to bf16 once before P.v and dv, and ds once before dq and dk,
// as the TPU kernels round them (the flash kernels #7-#9 keep both at fp32
// precision instead: flash_attention.cu).  exp is expf, as torch.exp.  These
// are the functions of
//   feddat_tpu/ops/fused_attention.py::_fwd_kernel, _bwd_kernel   (#5, #6)
//   feddat_tpu/ops/attn_block.py::_fwd_kernel                      (#1, its attention stage)
//   feddat_tpu/ops/attn_block.py::_bwd_kernel                      (#3, its per-head part)
//   feddat_tpu/ops/layer_block.py::_layer_bwd_kernel               (#4, its per-head part)
// The bodies here are __device__ functions; each library that runs them
// gives them __global__ entries of its own, so a profile's kernel names tell
// the wrappers apart: fused_attention.cu's fused_fwd_kernel and
// fused_bwd_dq/dkdv_kernel (#5, #6), attn_block.cu's block_core_fwd_kernel
// (#1) and attn_bwd.cuh's block_core_bwd_dq/dkdv_kernel (#3, #4).
//
// Every operand and output is a Heads view addressed by strides (common.cuh),
// so the [B, H, S, 64] views that split() makes of [B, S, Dm] projections, and
// #1/#3/#4's [3, B*S, Dm] q/k/v scratch planes, are read, and the outputs
// written, in place.  Any S >= 1 runs: nothing of size S is held on chip.
//
// What bounds them on the H100.  At the training shape (B=64, H=12, S=185)
// one [S, S] x 64 product over all heads is 3.4 GFLOP.  The forward does
// three (q.k^T twice, P.v: ~10 us at 989 TFLOP/s) and moves ~73 MB (q, k, v,
// o, lse: ~22 us at 3.35 TB/s); the backward pair does seven (s and dp in
// each launch, dv, dq, dk: ~24 us) and moves ~147 MB (~44 us).  Both are
// bound by bytes at that S, and beside the tensor cores each logit costs
// ~10-15 fp32 instructions (scale, bias, exp, max or sum, ds, the bf16 pack)
// on the CUDA cores; at ALBEF's S=577 the products grow with S^2 and the
// exp work on the CUDA cores bounds them.
//
// Design, as #7-#9 are built (flash_sm90.cuh):
//   * one block is one warpgroup (128 threads) owning 64 rows, queries (the
//     forward, the dq launch) or keys (the dkdv launch): at S=185 the rows pad
//     to 192, not to the 256 of 128-row blocks, and several blocks share an SM;
//   * the operand that the block owns is loaded once into swizzled tiles; the
//     other side's 64-row tiles (and their bias, lse and delta) go through a
//     two-stage ring filled by cp.async, so step j+1's copies run while step
//     j computes;
//   * every product is wgmma.m64n64k16 on natural [row][d] tiles: q.k^T,
//     dO.v^T, k.q^T and v.dO^T read both tiles K-major; P.v, ds.k, P^T.dO and
//     ds^T.q take bf16(P) or bf16(ds) as one register A fragment (the C
//     fragment of the product before) and read v, k, dO or q through wgmma's
//     transposed B (desc_mn): nothing is transposed anywhere;
//   * the forward sweeps the keys twice: sweep 1 computes s and keeps only
//     the row max; sweep 2 recomputes s bit for bit (the same wgmma chain on
//     the same tiles), forms p and l, and adds bf16(p).v.  So the max is the
//     exact max over all keys (a fully masked row gives the unbiased softmax,
//     as on the TPU) and no logits tile is kept: the third product costs less
//     at a byte-bound shape than shared memory for S logits would, and S is
//     free;
//   * the backward is two launches in the FlashAttention-2 manner: the dq
//     launch (64 queries a block, K/V/bias through the ring) also writes delta
//     to a [B, H, S] scratch; the dkdv launch (64 keys a block, Q/dO/lse/delta
//     through the ring) accumulates dk and dv over all queries in registers.
//     Each output row is owned by one block and summed in fp32 registers with
//     no atomics, so a second call is bitwise equal.
// What still bounds them: inside a warpgroup nothing overlaps (each step waits
// for its products, then runs the elementwise work), and every 64-row block
// reads the other side's whole sequence again from L2 (the forward reads K
// twice).  Blocks per SM on the H100 (ptxas, CUDA 12.8): forward 112
// registers and 42.5 KB of shared memory, 4 blocks (a bound of 5 gives 96
// registers and runs 1-4% slower); dq 128 registers under its bound of 4 (136
// under 3: 4-7% slower) and 50.7 KB, 4 blocks; dkdv 166 registers and
// 51.2 KB, 3 blocks (PERF.md §6).  The entries' __launch_bounds__ are
// FWD_MIN_BLOCKS, DQ_MIN_BLOCKS and DKDV_MIN_BLOCKS.
// Keys past S and queries past S contribute exactly 0 (the zero rows that
// cp.async fills in do not give p = 0: a zero q row has logits = bias, and a
// zero-filled lse gives p = exp(s)), and their rows are not written.
//
// fp32 (#1, #3 and #4 in float32: the bodies' T = float).  The TPU kernels'
// rounding points are casts to the model dtype, so in fp32 nothing rounds: P
// and ds enter their products at fp32 precision and o, dq, dk, dv are fp32.
// The operands q, k, v, dO are the three bf16 terms of each fp32 value
// (common.cuh's split3, Heads::tt apart), each loaded into a tile of its own
// (so a Q, K, V or dO block takes three tiles), and every product is the six
// term products in common.cuh's pair order on the same wgmma paths; P and ds
// are split in registers the same way (term_frag).  The six products cost
// 6x the bf16 tensor-core work, and the tiles 3x the shared memory (forward
// 122 KB, dq and dkdv 146 KB: one block per SM).
#pragma once

#include "flash_sm90.cuh"

namespace port {
namespace attn {

constexpr int FA_ROWS = 64;      // rows a block owns, and rows of each streamed step
constexpr int FA_D = 64;         // head dim
constexpr int FA_THREADS = 128;  // one warpgroup
constexpr int FA_STAGES = 2;     // ring stages: step j+1's copies in flight during step j
constexpr int TB = sm90::TILE_BYTES;

// The forward's operands: q, k, v [B, H, S, 64] bf16 views (the terms of
// fp32 ones); bias [B, S] fp32 or null; outputs o [B, H, S, 64] of the
// element type T and lse [B, H, S] fp32.
template <typename T>
struct FusedFwdArgs {
  Heads<const bf16> q, k, v;
  const float* bias;
  Heads<T> o;
  float* lse;
  int S, H;
  float scale;
};

// The backward's operands: q, k, v, dout [B, H, S, 64] bf16 views (the terms
// of fp32 ones) and ctx (the forward's o, of the element type); lse
// [B, H, S] fp32 from the forward; bias [B, S] fp32 or null; delta [B, H, S]
// fp32 scratch (written by the dq launch, read by the dkdv launch); dq, dk,
// dv outputs of the element type.
template <typename T>
struct FusedBwdArgs {
  Heads<const bf16> q, k, v;
  Heads<const bf16> dout;
  Heads<const T> ctx;
  const float* lse;
  const float* bias;
  float* delta;
  Heads<T> dq, dk, dv;
  int S, H;
  float scale;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the 1024-byte aligned start of the dynamic shared memory `raw` (the wgmma
// swizzle is a function of the address), as a shared-space address and a pointer
__device__ __forceinline__ uint32_t aligned_smem(uint8_t* raw, uint8_t** ptr) {
  const uint32_t at = sm90::smem_addr(raw);
  const uint32_t base = (at + 1023u) & ~1023u;
  *ptr = raw + (base - at);
  return base;
}

// eight adjacent values of a [.., 64] operand given as NT bf16 terms tt apart
template <int NT>
__device__ __forceinline__ void load_terms8(const bf16* p, long long tt, float (&v)[8]) {
  load8(p, v);
  if (NT == 3) {
    float m[8], l[8];
    load8(p + tt, m);
    load8(p + 2 * tt, l);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (v[i] + m[i]) + l[i];  // exact: the terms' sum is the fp32 value
  }
}

// the NT term tiles of rows [r0, r0 + 64) of an operand (terms tt apart)
// into consecutive swizzled tiles from `tile` by cp.async
template <int NT>
__device__ __forceinline__ void load_tiles(uint32_t tile, const bf16* src, long long ss, long long tt, int r0,
                                           int S, int tid) {
#pragma unroll
  for (int t = 0; t < NT; ++t) sm90::load_tile<FA_THREADS>(tile + t * TB, src + t * tt, ss, r0, S, tid);
}

// 64 fp32 values [i0, i0 + 64) of `src` into shared memory by cp.async (one
// 4-byte copy for each of the first 64 threads), zero past n
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n, int tid) {
  if (tid < FA_ROWS) {
    const bool ok = i0 + tid < n;
    sm90::cp_async4(sm90::smem_addr(dst + tid), src + (ok ? i0 + tid : 0), ok);
  }
}

// the products on term tiles (flash_sm90.cuh)
using sm90::product_rs;
using sm90::product_ss;

// ----------------------------------------------------------- forward
// Dynamic shared memory: Q, then K and V of each stage (NT tiles each), then
// 64 bias floats of each stage.
template <int NT>
__host__ __device__ constexpr int fwd_smem() { return 1024 + NT * (1 + 2 * FA_STAGES) * TB + FA_STAGES * FA_ROWS * 4; }

// The block's 64 queries at one 64-key step: s = fp32(q.k^T) * scale + bias,
// -inf at keys past S, into x (in place of the accumulator)
__device__ __forceinline__ void logits(float (&x)[32], const float* bs, bool has_bias, int k0, int S,
                                       float scale, int tig) {
#pragma unroll
  for (int nt = 0; nt < FA_ROWS / 8; ++nt) {
    const int c = nt * 8 + tig * 2;  // step-local key of x[nt * 4 + 0|2]
    const float2 bv = has_bias ? *reinterpret_cast<const float2*>(bs + c) : make_float2(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __fadd_rn(__fmul_rn(x[nt * 4 + e], scale), (e & 1) ? bv.y : bv.x);
      x[nt * 4 + e] = k0 + c + (e & 1) < S ? v : -INFINITY;
    }
  }
}

template <typename T>
__device__ __forceinline__ void fused_fwd_body(const FusedFwdArgs<T>& p) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t fa_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fa_smem, &sp);
  const uint32_t sQ = sbase;  // stage st: K at sbase + NT (1 + 2 st) TB, V NT tiles later
  float* bias_s = reinterpret_cast<float*>(sp + NT * (1 + 2 * FA_STAGES) * TB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int nk = (p.S + FA_ROWS - 1) / FA_ROWS;
  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  const float* brow = p.bias != nullptr ? p.bias + (long long)b * p.S : nullptr;

  // step j < nk is sweep 1 at key tile j (K and bias), step j >= nk sweep 2
  // at key tile j - nk (K, V and bias); step j goes to ring stage j % 2, one
  // commit group (empty past the last step)
  auto stage = [&](int j) {
    if (j < 2 * nk) {
      const int st = j % FA_STAGES, k0 = (j < nk ? j : j - nk) * FA_ROWS;
      const uint32_t sk = sbase + NT * (1 + 2 * st) * TB;
      load_tiles<NT>(sk, kb, p.k.ss, p.k.tt, k0, p.S, tid);
      if (j >= nk) load_tiles<NT>(sk + NT * TB, vb, p.v.ss, p.v.tt, k0, p.S, tid);
      if (brow != nullptr) load_vec(bias_s + st * FA_ROWS, brow, k0, p.S, tid);
    }
    sm90::cp_async_commit();
  };

  load_tiles<NT>(sQ, p.q.at(b, h), p.q.ss, p.q.tt, q0, p.S, tid);
  stage(0);  // Q lands with the first step

  float m[2] = {-INFINITY, -INFINITY};  // rows lrow, lrow + 8: this thread's max, then the row's
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int j = 0; j < 2 * nk; ++j) {
    const int st = j % FA_STAGES, k0 = (j < nk ? j : j - nk) * FA_ROWS;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; the warpgroup is done with step j-1's stage
    stage(j + 1);
    const uint32_t sk = sbase + NT * (1 + 2 * st) * TB;

    float s[32];
    sm90::wg_fence();
    product_ss<NT>(s, sQ, sk);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);
    logits(s, bias_s + st * FA_ROWS, brow != nullptr, k0, p.S, p.scale, tig);

    if (j < nk) {  // sweep 1: the row max
#pragma unroll
      for (int i = 0; i < 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
      if (j == nk - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
      continue;
    }
    // sweep 2: p = exp(s - m) (exp(-inf) = 0 at keys past S), l += p, o += T(p).v
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = expf(s[i] - m[r]);
      l[r] += s[i];
    }
    sm90::pin(o);
    sm90::wg_fence();
    product_rs<NT>(o, s, sk + NT * TB);
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    sm90::pin(o);
  }

  const int lrow = warp * 16 + g;  // block-local row of o[..0|1]; lrow + 8 of o[..2|3]
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
  T* ob = p.o.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int nt = 0; nt < FA_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.S)
        store2(ob + (long long)row[r] * p.o.ss + col, o[nt * 4 + 2 * r] / l[r], o[nt * 4 + 2 * r + 1] / l[r]);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.S) p.lse[((long long)b * p.H + h) * p.S + row[r]] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------- backward
// Each library defines its dkdv entry before its dq entry, as #9 precedes #8
// in flash_attention.cu (ptxas's allocation for one kernel can move with the
// body of the one before it; PERF.md §6 records what each got).
//
// dkdv's dynamic shared memory: K and V of the block, then Q and dO of each
// stage (NT tiles each), then lse and delta (64 floats each) of each stage.
template <int NT>
__host__ __device__ constexpr int dkdv_smem() { return 1024 + NT * (2 + 2 * FA_STAGES) * TB + FA_STAGES * 2 * FA_ROWS * 4; }

template <typename T>
__device__ __forceinline__ void fused_bwd_dkdv_body(const FusedBwdArgs<T>& p) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t fa_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fa_smem, &sp);
  const uint32_t sK = sbase, sV = sbase + NT * TB;  // stage st: Q at sbase + NT (2 + 2 st) TB, dO NT tiles later
  float* vec_s = reinterpret_cast<float*>(sp + NT * (2 + 2 * FA_STAGES) * TB);  // [stage][lse 64 | delta 64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * FA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lkey = warp * 16 + g;  // block-local key of d[..0|1]; lkey + 8 of d[..2|3]
  const int key[2] = {k0 + lkey, k0 + lkey + 8};
  const long long lse0 = ((long long)b * p.H + h) * p.S;
  const bf16* qb = p.q.at(b, h);
  const bf16* dob = p.dout.at(b, h);
  const int nq = (p.S + FA_ROWS - 1) / FA_ROWS;

  // the bias of this thread's two keys (clamped: keys past S drop out below)
  float bkey[2] = {0.f, 0.f};
  if (p.bias != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) bkey[r] = p.bias[(long long)b * p.S + min(key[r], p.S - 1)];
  }

  // query step j's Q, dO, lse and delta into ring stage j % 2 (one commit
  // group, empty past the last step)
  auto stage = [&](int j) {
    if (j < nq) {
      const int st = j % FA_STAGES, qt = j * FA_ROWS;
      const uint32_t sq = sbase + NT * (2 + 2 * st) * TB;
      load_tiles<NT>(sq, qb, p.q.ss, p.q.tt, qt, p.S, tid);
      load_tiles<NT>(sq + NT * TB, dob, p.dout.ss, p.dout.tt, qt, p.S, tid);
      load_vec(vec_s + st * 2 * FA_ROWS, p.lse + lse0, qt, p.S, tid);
      load_vec(vec_s + st * 2 * FA_ROWS + FA_ROWS, p.delta + lse0, qt, p.S, tid);
    }
    sm90::cp_async_commit();
  };

  load_tiles<NT>(sK, p.k.at(b, h), p.k.ss, p.k.tt, k0, p.S, tid);
  load_tiles<NT>(sV, p.v.at(b, h), p.v.ss, p.v.tt, k0, p.S, tid);
  stage(0);  // K and V land with the first step

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < nq; ++j) {
    const int st = j % FA_STAGES, qt = j * FA_ROWS;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; the warpgroup is done with step j-1's stage
    stage(j + 1);
    const uint32_t sq = sbase + NT * (2 + 2 * st) * TB, so = sq + NT * TB;

    // s^T = K.Q^T and dp^T = V.dO^T: rows = the block's 64 keys, columns = 64 queries
    float s[32], dp[32];
    sm90::wg_fence();
    product_ss<NT>(s, sK, sq);
    product_ss<NT>(dp, sV, so);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);
    sm90::pin(dp);

    // p^T and ds^T in place; queries past S and keys past S give exactly 0
    const float* lse_s = vec_s + st * 2 * FA_ROWS;
    const float* dl_s = lse_s + FA_ROWS;
#pragma unroll
    for (int nt = 0; nt < FA_ROWS / 8; ++nt) {
      const int qi = nt * 8 + tig * 2;  // step-local query of d[nt * 4 + 0|2]
      const float2 lq = *reinterpret_cast<const float2*>(lse_s + qi);
      const float2 dq = *reinterpret_cast<const float2*>(dl_s + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        float pr = 0.f, ds = 0.f;
        if (qt + qi + c < p.S && key[r] < p.S) {
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), bkey[r]);
          pr = expf(x - (c ? lq.y : lq.x));
          ds = pr * (dp[nt * 4 + e] - (c ? dq.y : dq.x));
        }
        s[nt * 4 + e] = pr;
        dp[nt * 4 + e] = ds;
      }
    }

    // dv += T(p^T).dO and dk += T(ds^T).q, dO and q from their natural tiles
    sm90::pin(dk);
    sm90::pin(dv);
    sm90::wg_fence();
    product_rs<NT>(dv, s, so);
    product_rs<NT>(dk, dp, sq);
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    sm90::pin(dk);
    sm90::pin(dv);
  }

  T* dkb = p.dk.at(b, h);
  T* dvb = p.dv.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FA_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key[r] < p.S) {
        store2(dvb + (long long)key[r] * p.dv.ss + col, dv[nt * 4 + 2 * r], dv[nt * 4 + 2 * r + 1]);
        store2(dkb + (long long)key[r] * p.dk.ss + col, dk[nt * 4 + 2 * r] * p.scale,
               dk[nt * 4 + 2 * r + 1] * p.scale);
      }
  }
}

// dq's dynamic shared memory: Q and dO of the block, then K and V of each
// stage (NT tiles each), then 64 bias floats of each stage, then the block's
// 64 deltas.
template <int NT>
__host__ __device__ constexpr int dq_smem() { return 1024 + NT * (2 + 2 * FA_STAGES) * TB + (FA_STAGES + 1) * FA_ROWS * 4; }

template <typename T>
__device__ __forceinline__ void fused_bwd_dq_body(const FusedBwdArgs<T>& p) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t fa_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fa_smem, &sp);
  const uint32_t sQ = sbase, sO = sbase + NT * TB;  // stage st: K at sbase + NT (2 + 2 st) TB, V NT tiles later
  float* bias_s = reinterpret_cast<float*>(sp + NT * (2 + 2 * FA_STAGES) * TB);
  float* delta_s = bias_s + FA_STAGES * FA_ROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lrow = warp * 16 + g;  // block-local row of d[..0|1]; lrow + 8 of d[..2|3]
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
  const long long lse0 = ((long long)b * p.H + h) * p.S;
  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  const bf16* dob = p.dout.at(b, h);
  const float* brow = p.bias != nullptr ? p.bias + (long long)b * p.S : nullptr;
  const int nk = (p.S + FA_ROWS - 1) / FA_ROWS;

  // key step j's K, V and bias into ring stage j % 2 (one commit group, empty
  // past the last step)
  auto stage = [&](int j) {
    if (j < nk) {
      const int st = j % FA_STAGES, k0 = j * FA_ROWS;
      const uint32_t sk = sbase + NT * (2 + 2 * st) * TB;
      load_tiles<NT>(sk, kb, p.k.ss, p.k.tt, k0, p.S, tid);
      load_tiles<NT>(sk + NT * TB, vb, p.v.ss, p.v.tt, k0, p.S, tid);
      if (brow != nullptr) load_vec(bias_s + st * FA_ROWS, brow, k0, p.S, tid);
    }
    sm90::cp_async_commit();
  };

  load_tiles<NT>(sQ, p.q.at(b, h), p.q.ss, p.q.tt, q0, p.S, tid);
  load_tiles<NT>(sO, dob, p.dout.ss, p.dout.tt, q0, p.S, tid);
  stage(0);  // Q and dO land with the first step

  // delta = rowsum(dO * o) in fp32 while they land: two threads a row, 32
  // columns each, from device memory; written to the scratch for the dkdv launch
  {
    const int r = tid >> 1, c0 = (tid & 1) * 32, q = q0 + r;
    float acc = 0.f;
    if (q < p.S) {
      const bf16* dr = dob + (long long)q * p.dout.ss + c0;
      const T* orow = p.ctx.at(b, h) + (long long)q * p.ctx.ss + c0;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        float de[8], oe[8];
        load_terms8<NT>(dr + c, p.dout.tt, de);
        load8(orow + c, oe);
#pragma unroll
        for (int t = 0; t < 8; ++t) acc += de[t] * oe[t];
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = acc;
      if (q < p.S) p.delta[lse0 + q] = acc;
    }
  }
  __syncthreads();

  // lse and delta of this thread's two rows (lse clamped: rows past S drop out below)
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = p.lse[lse0 + min(row[r], p.S - 1)];
    dl_r[r] = delta_s[lrow + 8 * r];
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int st = j % FA_STAGES, k0 = j * FA_ROWS;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; the warpgroup is done with step j-1's stage
    stage(j + 1);
    const uint32_t sk = sbase + NT * (2 + 2 * st) * TB;

    // s = Q.K^T and dp = dO.V^T for the block's 64 rows x 64 keys
    float s[32], dp[32];
    sm90::wg_fence();
    product_ss<NT>(s, sQ, sk);
    product_ss<NT>(dp, sO, sk + NT * TB);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);
    sm90::pin(dp);

    // ds = p (dp - delta) in place of s; keys past S and rows past S give exactly 0
    const float* bs = bias_s + st * FA_ROWS;
#pragma unroll
    for (int nt = 0; nt < FA_ROWS / 8; ++nt) {
      const int c = nt * 8 + tig * 2;  // step-local key of d[nt * 4 + 0|2]
      const float2 bv = brow != nullptr ? *reinterpret_cast<const float2*>(bs + c) : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = 0.f;
        if (k0 + c + (e & 1) < p.S && row[r] < p.S) {
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), (e & 1) ? bv.y : bv.x);
          const float pr = expf(x - lse_r[r]);
          ds = pr * (dp[nt * 4 + e] - dl_r[r]);
        }
        s[nt * 4 + e] = ds;
      }
    }

    // dq += T(ds).k, k from its natural [key][d] tile
    sm90::pin(dq);
    sm90::wg_fence();
    product_rs<NT>(dq, s, sk);
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    sm90::pin(dq);
  }

  T* dqb = p.dq.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FA_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.S)
        store2(dqb + (long long)row[r] * p.dq.ss + col, dq[nt * 4 + 2 * r] * p.scale,
               dq[nt * 4 + 2 * r + 1] * p.scale);
  }
}

// Blocks per SM each entry's registers must allow: bf16 as measured (PERF.md
// §6); fp32's shared memory holds one block per SM, so its registers are free.
constexpr int FWD_MIN_BLOCKS = 4, DQ_MIN_BLOCKS = 4, DKDV_MIN_BLOCKS = 2;
template <typename T>
__host__ __device__ constexpr int fwd_min_blocks() { return kTerms<T> == 1 ? FWD_MIN_BLOCKS : 1; }
template <typename T>
__host__ __device__ constexpr int dq_min_blocks() { return kTerms<T> == 1 ? DQ_MIN_BLOCKS : 1; }
template <typename T>
__host__ __device__ constexpr int dkdv_min_blocks() { return kTerms<T> == 1 ? DKDV_MIN_BLOCKS : 1; }

inline bool bad_sizes(int B, int H, int S) { return B < 1 || H < 1 || S < 1 || B > 65535 || H > 65535; }

// The forward over B batch elements on `st` through `kernel`, an entry whose
// body is fused_fwd_body; `done` is the entry's own per-device record of its
// raised shared-memory limit (sm90::allow_smem).  Returns the CUDA error.
template <typename Kernel, typename T>
inline int launch_fwd(Kernel kernel, int* done, const FusedFwdArgs<T>& a, int B, cudaStream_t st) {
  if (bad_sizes(B, a.H, a.S)) return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem<kTerms<T>>();
  const cudaError_t err = sm90::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + FA_ROWS - 1) / FA_ROWS, a.H, B);
  kernel<<<grid, FA_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The backward's two launches on `st` (dq with delta through `dq`, then dk/dv
// through `dkdv`: entries whose bodies are fused_bwd_dq_body and
// fused_bwd_dkdv_body, with their own limit records).  Returns the CUDA error.
template <typename KernelDq, typename KernelDkdv, typename T>
inline int launch_bwd(KernelDq dq, int* dq_done, KernelDkdv dkdv, int* dkdv_done, const FusedBwdArgs<T>& a,
                      int B, cudaStream_t st) {
  if (bad_sizes(B, a.H, a.S)) return (int)cudaErrorInvalidValue;
  constexpr int dq_bytes = dq_smem<kTerms<T>>(), dkdv_bytes = dkdv_smem<kTerms<T>>();
  cudaError_t err = sm90::allow_smem(dq, dq_bytes, dq_done);
  if (err == cudaSuccess) err = sm90::allow_smem(dkdv, dkdv_bytes, dkdv_done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + FA_ROWS - 1) / FA_ROWS, a.H, B);
  dq<<<grid, FA_THREADS, dq_bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv<<<grid, FA_THREADS, dkdv_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace port
