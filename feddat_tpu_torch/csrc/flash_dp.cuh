// The flash backward's dq (#8) and dk/dv (#9) launches at every head dim D
// from 1 to 256 but 64, in bf16, for Hopper (sm_90a).  Head dim 64 keeps
// flash_attention.cu's own kernels; fp32 at any head dim but 64, and bf16
// past 256, keep attn_any.cuh's streaming bodies (any_dq_body<T, true>,
// any_dkdv_body<T, true>), whose shared memory does not grow with D.
//
// They compute what feddat_tpu/ops/flash.py:75-152 computes, at the rounding
// points of flash_attention.cu's backward: s = (q * scale) k^T + bias (the
// compact [B|1, H|1, Sq|1, Skv|1] bias by element strides), p = exp(s - lse)
// by ex2.approx, ds = p (dp - delta) with delta given, p and ds at fp32
// precision in their products (bf16 hi + lo), every sum in one fixed order
// and no atomics, so a second call is bitwise equal.
//
// Design.  What held attn_any.cuh's bodies back: one warpgroup owned 64 rows
// and one 64-column output chunk, re-streamed its own rows at every step and
// recomputed s and dp once per output chunk.  Here, as in the head-dim-64
// #8/#9 (flash_attention.cu):
//   * a block of two warpgroups owns 128 rows (queries for #8, keys for #9),
//     64 per warpgroup, at D <= 128; their own rows (q and dO, or k and v)
//     are loaded ONCE into swizzled chunk tiles and stay resident;
//   * only the other side streams: one 64-row step per stage of a two-stage
//     cp.async ring (k, v and the bias tile for #8; q, dO, lse, delta and the
//     bias tile for #9), so step j+1's copies run under step j's products;
//   * at D <= 128 a warpgroup owns every output column, so s and dp are
//     computed once per step; at 128 < D <= 256 the block owns 64 rows and
//     its two warpgroups split the output columns (0-127 and 128 up): s and
//     dp twice, with the resident and streamed tiles shared by both;
//   * the bias tile of the block's rows and the step's keys (or one key row
//     when it is constant over queries) is staged with the step.
// Padding.  D is padded to DP = a multiple of 16 (the depth of one wgmma
// k-step): q.k^T and dO.v^T run DP / 16 k-steps, so D = 80 does 80 columns of
// that work, not 128.  The operands sit in 128B-swizzled [64 rows][64] chunk
// tiles (flash_sm90.cuh's layout), zero past D.  An output product of width
// NO runs one wgmma of N = 64 per whole 64-column chunk and one of N = 16, 32
// or 48 for the rest (D = 80: N = 64 + 16), rather than one of N = 80: each
// instruction's transposed B then stays inside one 64-column swizzle atom,
// the layout the head-dim-64 kernels already run, and the accumulators are
// the padded width and no more.
// Registers.  #8: s, dp (32 each) and dq (DP / 2 <= 64) a thread.  #9 holds
// dk and dv (up to 64 each); at an output width above 96 it computes s^T and
// dp^T in two 32-query halves of the step (16 registers each, a rolled loop:
// the wide instances' code stays small), so the four accumulators fit
// without spilling; up to 96, in one 64-query product as the head-dim-64 #9.
// Shared memory.  At D <= 128: resident 2 x 2 x NC tiles, ring 2 x 2 x NC
// (NC = chunks of 64 columns), at most 128 KB, plus the bias tiles.  At
// 128 < D <= 256 the block's 64 rows halve the resident tiles (at most 192 KB
// with two stages); where the bias tile does not fit beside two stages (D >
// 192 with a [query][key] bias) the ring runs one stage.
// Rows whose 16-byte chunks are not aligned (D not a multiple of 8, or a
// head at a column that is no multiple of 8) are read element by element in
// place into the same tiles, as attn_any.cuh does.
#pragma once

#include "attn_any.cuh"

namespace port {
namespace fdp {

using anyd::AnyArgs;

constexpr int THREADS = 256;           // two warpgroups
constexpr int STEP = 64;               // rows of the streamed side per ring stage
constexpr int TB = sm90::TILE_BYTES;   // one [64][64] bf16 chunk tile
constexpr int KEY_LD = STEP + 8;       // fp32 row of #8's staged [rows][64 keys] bias tile
constexpr int MAX_D = 256;             // the largest head dim these bodies take
constexpr int MAX_SMEM = 232448;       // a block's shared memory on the H100
enum { BIAS_NONE = 0, BIAS_ROW = 1, BIAS_TILE = 2 };

// head dim D padded to whole wgmma k-steps: the instance that runs it
__host__ __device__ constexpr int padded(int D) { return (D + 15) / 16 * 16; }

// #9 (dkv) or #8 at head dim a.D (1 <= D <= MAX_D, not 64), bf16: one launch
// of the instance of padded(a.D), its ring two stages where the shared
// memory takes them, else one.  Defined in flash_dp.cu, which is linked into
// flash_attention.cu's library.  Returns the CUDA error.
int flash_dp_bwd(const AnyArgs<bf16>& a, bool dkv, int B, cudaStream_t st);

template <int DP>
struct Geo {
  static constexpr int NC = (DP + 63) / 64;           // chunk tiles of 64 rows of an operand
  static constexpr int KS = DP / 16;                  // k-steps of q.k^T and dO.v^T
  static constexpr int CG = DP > 128 ? 2 : 1;         // warpgroups on one row group (column groups)
  static constexpr int RG = 2 / CG;                   // row groups of 64 a block owns
  static constexpr int BR = STEP * RG;                // rows a block owns
  static constexpr int NO0 = DP > 128 ? 128 : DP;     // output columns of column group 0
  static constexpr int NO1 = DP > 128 ? DP - 128 : DP;  // of column group 1 (from column 128)
  static constexpr int NACC = (NO0 + 63) / 64;        // 64-column accumulators of a warpgroup
  static constexpr int SW9 = NO0 > 96 ? 32 : 64;      // #9's queries per s^T/dp^T product
  static constexpr int LD9 = BR + 4;                  // fp32 row of #9's staged [64 q][BR keys] bias tile
};

// dynamic shared memory of one launch: the resident tiles, the ring's
// tiles, then its fp32 rows (#8: the bias; #9: lse, delta and the bias)
template <bool DKV, int DP>
__host__ __device__ constexpr int smem_bytes(int mode, int nstg) {
  using G = Geo<DP>;
  return 1024 + (2 * G::RG * G::NC + 2 * G::NC * nstg) * TB +
         4 * nstg *
             (DKV ? 2 * STEP + (mode == BIAS_TILE ? STEP * G::LD9 : 0)
                  : (mode == BIAS_ROW ? STEP : mode == BIAS_TILE ? G::BR * KEY_LD : 0));
}

// #8 takes two blocks an SM where its registers allow (D <= 64, as the
// head-dim-64 #8); #9 and the wider #8 one
template <int DP>
constexpr int dq_blocks() { return DP <= 64 ? 2 : 1; }

// ------------------------------------------------------------------ wgmma
// d (+)= A . B^T for M = 64 and N = 16 or 32 (d's N / 2 registers), A and B
// K-major swizzled tiles; d is overwritten when acc == 0
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  sm90::wgmma_ss(d, da, db, acc);
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A . B with A [64][16] bf16 in registers and B [16][N] MN-major in
// shared memory (one swizzle atom), for N = 16, 32, 48 or 64: the first N / 2
// registers of a 64-column accumulator
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  sm90::wgmma_rs_t(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs_t<16>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_t<32>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs_t<48>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// pin the first N registers of an accumulator (sm90::pin: no read or write
// of them moves across this point)
template <int N>
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the A fragments (bf16 hi, bf16 lo = x - hi) of k-step ks from an M = 64
// accumulator x of any N: x at fp32 precision as hi + lo
template <int N>
__device__ __forceinline__ void hilo(const float (&x)[N], int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = x[ks * 8 + 2 * i], b = x[ks * 8 + 2 * i + 1];
    hi[i] = pack_bf16(a, b);
    lo[i] = pack_bf16(a - round_bf16(a), b - round_bf16(b));
  }
}

// acc (columns oc0 .. oc0 + NO of the product) += the fragments' 16 rows of
// B, whose natural [row][d] chunk tiles start at `b`, rows 16 kg .. 16 kg + 15
// (the transposed B of each chunk)
template <int OC0, int NO, int NACC>
__device__ __forceinline__ void out_step(float (&acc)[NACC][32], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                         uint32_t b, int kg) {
  constexpr int NF = NO / 64, TN = NO % 64;
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    const uint64_t db = sm90::desc_mn(b + (OC0 / 64 + c) * TB, kg);
    wgmma_rs_t<64>(acc[c], hi, db);
    wgmma_rs_t<64>(acc[c], lo, db);
  }
  if constexpr (TN > 0) {
    const uint64_t db = sm90::desc_mn(b + (OC0 / 64 + NF) * TB, kg);
    wgmma_rs_t<TN>(acc[NF], hi, db);
    wgmma_rs_t<TN>(acc[NF], lo, db);
  }
}

template <int NO, int NACC>
__device__ __forceinline__ void pin_out(float (&acc)[NACC][32]) {
#pragma unroll
  for (int c = 0; c < NO / 64; ++c) pin<32>(acc[c]);
  if constexpr (NO % 64 > 0) pin<(NO % 64) / 2>(acc[NO / 64]);
}

// ------------------------------------------------------------------ loads
// rows [r0, r0 + 64) of one (batch, head)'s [S, D] operand `src` (row
// stride ss) into its NC chunk tiles from `tile`, zero past S and D: 16-byte
// cp.async copies when `vec`, else element loads stored as 16-byte chunks.
// Chunks at or past DP are never read, and not written.
template <int DP>
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* src, long long ss, int r0, int S, int D,
                                          bool vec, int tid) {
#pragma unroll
  for (int c = 0; c < Geo<DP>::NC; ++c) {
#pragma unroll
    for (int j = 0; j < STEP * 8 / THREADS; ++j) {
      const int i = tid + j * THREADS, r = i >> 3, col = c * 64 + (i & 7) * 8;
      if (col >= DP) continue;
      const uint32_t dst = tile + c * TB + sm90::swz(r, i & 7);
      const bool rok = r0 + r < S;
      if (vec) {
        const bool ok = rok && col < D;
        sm90::cp_async16(dst, src + (ok ? (long long)(r0 + r) * ss + col : 0), ok);
      } else {
        const bf16* row = src + (long long)(rok ? r0 + r : 0) * ss;
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = col + 2 * e;
          const uint32_t lo = rok && x < D ? anyd::bits(row + x) : 0u;
          const uint32_t hi = rok && x + 1 < D ? anyd::bits(row + x + 1) : 0u;
          w[e] = lo | (hi << 16);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]),
                     "r"(w[3])
                     : "memory");
      }
    }
  }
}

// s = A . B^T over the DP columns: A's 64 rows from its chunk tiles at `a`, B's
// N rows from its chunk tiles at `b` (rows n0 .. n0 + N - 1 of the step),
// both K-major; one wgmma chain of DP / 16 k-steps
template <int DP, int N>
__device__ __forceinline__ void dot(float (&s)[N / 2], uint32_t a, uint32_t b, int n0) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss<N>(s, sm90::desc_k(a + (ks >> 2) * TB, ks & 3), sm90::desc_k(b + (ks >> 2) * TB + n0 * 128, ks & 3),
                ks);
}

// one 64-column accumulator chunk's values, rows lrow (+ 8) of the warpgroup's
// tile at `row0`, columns c0 + nt * 8 + 2 tig (+ 1) below D, times mul
template <int NT>
__device__ __forceinline__ void store_acc(bf16* base, long long ss, int row0, int S, int c0, int D,
                                          const float (&acc)[32], float mul, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1), col = c0 + nt * 8 + tig * 2 + (e & 1);
      if (row < S && col < D) base[(long long)row * ss + col] = __float2bfloat16_rn(acc[nt * 4 + e] * mul);
    }
  }
}

// columns oc0 .. oc0 + NO of a warpgroup's output rows
template <int OC0, int NO, int NACC>
__device__ __forceinline__ void store_out(const Heads<bf16>& o, int b, int h, int row0, int S, int D,
                                          const float (&acc)[NACC][32], float mul, int tig) {
  bf16* base = o.at(b, h);
#pragma unroll
  for (int c = 0; c < NO / 64; ++c) store_acc<8>(base, o.ss, row0, S, OC0 + 64 * c, D, acc[c], mul, tig);
  if constexpr (NO % 64 > 0)
    store_acc<(NO % 64) / 8>(base, o.ss, row0, S, OC0 + 64 * (NO / 64), D, acc[NO / 64], mul, tig);
}

// ------------------------------------------------------------------- #8
// One 64-key step of a warpgroup's 64 queries, output columns OC0 .. OC0 +
// NO: s = q.k^T and dp = dO.v^T over DP, ds in place of s, dq += ds . k.
template <int DP, int OC0, int NO, int NACC>
__device__ __forceinline__ void dq_step(float (&dq)[NACC][32], const AnyArgs<bf16>& p, uint32_t sq, uint32_t so,
                                        uint32_t sk, const float* bs, int mode, int k0, int lrow,
                                        const int (&row)[2], const float (&lse_r)[2], const float (&dl_r)[2],
                                        int tig) {
  constexpr int NC = Geo<DP>::NC;
  float s[32], dp[32];
  sm90::wg_fence();
  dot<DP, 64>(s, sq, sk, 0);
  dot<DP, 64>(dp, so, sk + NC * TB, 0);
  sm90::wg_commit();
  sm90::wg_wait_all();
  sm90::pin(s);
  sm90::pin(dp);

  // ds = p (dp - delta); keys past Skv and rows past Sq give 0
#pragma unroll
  for (int nt = 0; nt < STEP / 8; ++nt) {
    const int c = nt * 8 + tig * 2;  // step-local key of s[nt * 4 + 0|2]
    float2 bv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    if (mode == BIAS_ROW) {
      bv[0] = bv[1] = *reinterpret_cast<const float2*>(bs + c);
    } else if (mode == BIAS_TILE) {
      bv[0] = *reinterpret_cast<const float2*>(bs + lrow * KEY_LD + c);
      bv[1] = *reinterpret_cast<const float2*>(bs + (lrow + 8) * KEY_LD + c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float ds = 0.f;
      if (k0 + c + (e & 1) < p.Skv && row[r] < p.Sq) {
        const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), (e & 1) ? bv[r].y : bv[r].x);
        ds = sm90::ex2((x - lse_r[r]) * sm90::LOG2E) * (dp[nt * 4 + e] - dl_r[r]);
      }
      s[nt * 4 + e] = ds;
    }
  }

  // dq += ds . k at fp32 precision, k from its natural [key][d] chunk tiles
  pin_out<NO>(dq);
  sm90::wg_fence();
#pragma unroll
  for (int ks = 0; ks < STEP / 16; ++ks) {
    uint32_t hi[4], lo[4];
    hilo(s, ks, hi, lo);
    out_step<OC0, NO>(dq, hi, lo, sk, ks);
  }
  sm90::wg_commit();
  sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
  pin_out<NO>(dq);
}

template <int DP>
__device__ __forceinline__ void dq_body(const AnyArgs<bf16>& p, int mode, int nstg) {
  using G = Geo<DP>;
  constexpr int NC = G::NC;
  extern __shared__ __align__(16) uint8_t fdp_smem[];
  const uint32_t at = sm90::smem_addr(fdp_smem), sbase = (at + 1023u) & ~1023u;
  const uint32_t sQ = sbase, sO = sbase + G::RG * NC * TB, sS = sbase + 2 * G::RG * NC * TB;
  float* const bias_s = reinterpret_cast<float*>(fdp_smem + (sbase - at) + (2 * G::RG + 2 * nstg) * NC * TB);
  const int bias_stage = mode == BIAS_ROW ? STEP : mode == BIAS_TILE ? G::BR * KEY_LD : 0;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = G::CG == 1 ? wg : 0;
  const int q0 = blockIdx.x * G::BR, h = blockIdx.y, b = blockIdx.z;
  const int lrow = rg * 64 + warp * 16 + g;  // block-local row of s[..0|1]; lrow + 8 of s[..2|3]
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
  const int nsteps = (p.Skv + STEP - 1) / STEP;
  const float* bb = p.bias + b * p.bsb + h * p.bsh;  // read only when mode != BIAS_NONE

  // step j's k, v and bias into ring stage j % nstg (one commit group)
  auto stage = [&](int j) {
    const int st = j % nstg, k0 = j * STEP;
    const uint32_t sk = sS + st * 2 * NC * TB;
    load_rows<DP>(sk, p.k.at(b, h), p.k.ss, k0, p.Skv, p.D, p.vk, tid);
    load_rows<DP>(sk + NC * TB, p.v.at(b, h), p.v.ss, k0, p.Skv, p.D, p.vv, tid);
    const uint32_t sb = sm90::smem_addr(bias_s + st * bias_stage);
    if (mode == BIAS_ROW) {
      if (tid < STEP) {
        const bool ok = k0 + tid < p.Skv;
        sm90::cp_async4(sb + tid * 4, bb + (ok ? (long long)(k0 + tid) * p.bsk : 0), ok);
      }
    } else if (mode == BIAS_TILE) {
      for (int i = tid; i < G::BR * STEP; i += THREADS) {
        const int r = i / STEP, c = i % STEP;
        const bool ok = q0 + r < p.Sq && k0 + c < p.Skv;
        sm90::cp_async4(sb + (r * KEY_LD + c) * 4,
                        bb + (ok ? (long long)(q0 + r) * p.bsq + (long long)(k0 + c) * p.bsk : 0), ok);
      }
    }
    sm90::cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < G::RG; ++t) {
    load_rows<DP>(sQ + t * NC * TB, p.q.at(b, h), p.q.ss, q0 + STEP * t, p.Sq, p.D, p.vq, tid);
    load_rows<DP>(sO + t * NC * TB, p.dout.at(b, h), p.dout.ss, q0 + STEP * t, p.Sq, p.D, p.vdo, tid);
  }
  stage(0);  // q and dO land with the first step

  // lse and delta of this thread's two rows (clamped: rows past Sq drop out)
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = min(row[r], p.Sq - 1);
    lse_r[r] = p.lse[lse0 + q];
    dl_r[r] = p.delta[lse0 + q];
  }

  float dq[G::NACC][32];
#pragma unroll
  for (int c = 0; c < G::NACC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  const uint32_t sq = sQ + rg * NC * TB, so = sO + rg * NC * TB;
  for (int j = 0; j < nsteps; ++j) {
    const int st = j % nstg;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (nstg > 1 && j + 1 < nsteps) stage(j + 1);
    const uint32_t sk = sS + st * 2 * NC * TB;
    const float* bs = bias_s + st * bias_stage;
    if (G::CG == 1 || wg == 0) {
      dq_step<DP, 0, G::NO0>(dq, p, sq, so, sk, bs, mode, j * STEP, lrow, row, lse_r, dl_r, tig);
    } else {
      dq_step<DP, 128, G::NO1>(dq, p, sq, so, sk, bs, mode, j * STEP, lrow, row, lse_r, dl_r, tig);
    }
    if (nstg == 1 && j + 1 < nsteps) {
      __syncthreads();  // every warpgroup is done with the one stage
      stage(j + 1);
    }
  }
  if (G::CG == 1 || wg == 0) {
    store_out<0, G::NO0>(p.dq, b, h, row[0], p.Sq, p.D, dq, p.scale, tig);
  } else {
    store_out<128, G::NO1>(p.dq, b, h, row[0], p.Sq, p.D, dq, p.scale, tig);
  }
}

// ------------------------------------------------------------------- #9
// One 64-query step of a warpgroup's 64 keys, output columns OC0 .. OC0 +
// NO: s^T = k.q^T and dp^T = v.dO^T over DP (SW queries at a time), p^T and
// ds^T in place, dv += p^T . dO and dk += ds^T . q.
template <int DP, int SW, int OC0, int NO, int NACC>
__device__ __forceinline__ void dkv_step(float (&dk)[NACC][32], float (&dv)[NACC][32], const AnyArgs<bf16>& p,
                                         uint32_t sk, uint32_t sv, uint32_t sq, uint32_t so, const float* lse_s,
                                         const float* dl_s, const float* bs, const float (&bkey)[2], int mode,
                                         int qt, int lkey, const int (&key)[2], int tig) {
  constexpr int LD9 = Geo<DP>::LD9;
#pragma unroll 1
  for (int jj = 0; jj < STEP / SW; ++jj) {
    float s[SW / 2], dp[SW / 2];
    sm90::wg_fence();
    dot<DP, SW>(s, sk, sq, jj * SW);
    dot<DP, SW>(dp, sv, so, jj * SW);
    sm90::wg_commit();
    sm90::wg_wait_all();
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) asm volatile("" : "+f"(s[i]), "+f"(dp[i])::"memory");

    // p^T and ds^T in place; queries past Sq and keys past Skv give 0
#pragma unroll
    for (int nt = 0; nt < SW / 8; ++nt) {
      const int qi = jj * SW + nt * 8 + tig * 2;  // step-local query of s[nt * 4 + 0|2]
      const float2 lq = *reinterpret_cast<const float2*>(lse_s + qi);
      const float2 dq = *reinterpret_cast<const float2*>(dl_s + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        float pr = 0.f, ds = 0.f;
        if (qt + qi + c < p.Sq && key[r] < p.Skv) {
          const float bv = mode == BIAS_ROW    ? bkey[r]
                           : mode == BIAS_TILE ? bs[(qi + c) * LD9 + lkey + 8 * r]
                                               : 0.f;
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), bv);
          pr = sm90::ex2((x - (c ? lq.y : lq.x)) * sm90::LOG2E);
          ds = pr * (dp[nt * 4 + e] - (c ? dq.y : dq.x));
        }
        s[nt * 4 + e] = pr;
        dp[nt * 4 + e] = ds;
      }
    }

    // dv += p^T . dO and dk += ds^T . q at fp32 precision, dO and q from their
    // natural [q][d] chunk tiles: p and ds as hi + lo, interleaved by k-step
    pin_out<NO>(dk);
    pin_out<NO>(dv);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < SW / 16; ++ks) {
      const int kg = jj * (SW / 16) + ks;
      uint32_t hi[4], lo[4];
      hilo(s, ks, hi, lo);
      out_step<OC0, NO>(dv, hi, lo, so, kg);
      hilo(dp, ks, hi, lo);
      out_step<OC0, NO>(dk, hi, lo, sq, kg);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    pin_out<NO>(dk);
    pin_out<NO>(dv);
  }
}

template <int DP>
__device__ __forceinline__ void dkv_body(const AnyArgs<bf16>& p, int mode, int nstg) {
  using G = Geo<DP>;
  constexpr int NC = G::NC, SW = G::SW9;
  extern __shared__ __align__(16) uint8_t fdp_smem[];
  const uint32_t at = sm90::smem_addr(fdp_smem), sbase = (at + 1023u) & ~1023u;
  const uint32_t sK = sbase, sV = sbase + G::RG * NC * TB, sS = sbase + 2 * G::RG * NC * TB;
  float* const vec_s = reinterpret_cast<float*>(fdp_smem + (sbase - at) + (2 * G::RG + 2 * nstg) * NC * TB);
  float* const bias_s = vec_s + nstg * 2 * STEP;  // [stage][lse 64 | delta 64], then the bias tiles
  const int bias_stage = mode == BIAS_TILE ? STEP * G::LD9 : 0;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = G::CG == 1 ? wg : 0;
  const int k0 = blockIdx.x * G::BR, h = blockIdx.y, b = blockIdx.z;
  const int lkey = rg * 64 + warp * 16 + g;  // block-local key of s[..0|1]; lkey + 8 of s[..2|3]
  const int key[2] = {k0 + lkey, k0 + lkey + 8};
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;
  const int nsteps = (p.Sq + STEP - 1) / STEP;
  const float* bb = p.bias + b * p.bsb + h * p.bsh;  // read only when mode != BIAS_NONE

  // a bias constant over queries is two registers (clamped: keys past Skv drop out)
  float bkey[2] = {0.f, 0.f};
  if (mode == BIAS_ROW) {
#pragma unroll
    for (int r = 0; r < 2; ++r) bkey[r] = bb[(long long)min(key[r], p.Skv - 1) * p.bsk];
  }

  // query step j's q, dO, lse, delta and bias into ring stage j % nstg
  auto stage = [&](int j) {
    const int st = j % nstg, qt = j * STEP;
    const uint32_t sq = sS + st * 2 * NC * TB;
    load_rows<DP>(sq, p.q.at(b, h), p.q.ss, qt, p.Sq, p.D, p.vq, tid);
    load_rows<DP>(sq + NC * TB, p.dout.at(b, h), p.dout.ss, qt, p.Sq, p.D, p.vdo, tid);
    if (tid < 2 * STEP) {
      const int i = tid % STEP;
      const bool ok = qt + i < p.Sq;
      const float* src = (tid < STEP ? p.lse : p.delta) + lse0 + (ok ? qt + i : 0);
      sm90::cp_async4(sm90::smem_addr(vec_s + st * 2 * STEP + tid), src, ok);
    }
    if (mode == BIAS_TILE) {
      const uint32_t sb = sm90::smem_addr(bias_s + st * bias_stage);
      for (int i = tid; i < STEP * G::BR; i += THREADS) {
        const int r = i / G::BR, c = i % G::BR;
        const bool ok = qt + r < p.Sq && k0 + c < p.Skv;
        sm90::cp_async4(sb + (r * G::LD9 + c) * 4,
                        bb + (ok ? (long long)(qt + r) * p.bsq + (long long)(k0 + c) * p.bsk : 0), ok);
      }
    }
    sm90::cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < G::RG; ++t) {
    load_rows<DP>(sK + t * NC * TB, p.k.at(b, h), p.k.ss, k0 + STEP * t, p.Skv, p.D, p.vk, tid);
    load_rows<DP>(sV + t * NC * TB, p.v.at(b, h), p.v.ss, k0 + STEP * t, p.Skv, p.D, p.vv, tid);
  }
  stage(0);  // k and v land with the first step

  float dk[G::NACC][32], dv[G::NACC][32];
#pragma unroll
  for (int c = 0; c < G::NACC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  const uint32_t sk = sK + rg * NC * TB, sv = sV + rg * NC * TB;
  for (int j = 0; j < nsteps; ++j) {
    const int st = j % nstg;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (nstg > 1 && j + 1 < nsteps) stage(j + 1);
    const uint32_t sq = sS + st * 2 * NC * TB, so = sq + NC * TB;
    const float* lse_s = vec_s + st * 2 * STEP;
    const float* bs = bias_s + st * bias_stage;
    if (G::CG == 1 || wg == 0) {
      dkv_step<DP, SW, 0, G::NO0>(dk, dv, p, sk, sv, sq, so, lse_s, lse_s + STEP, bs, bkey, mode, j * STEP, lkey,
                                  key, tig);
    } else {
      dkv_step<DP, SW, 128, G::NO1>(dk, dv, p, sk, sv, sq, so, lse_s, lse_s + STEP, bs, bkey, mode, j * STEP,
                                    lkey, key, tig);
    }
    if (nstg == 1 && j + 1 < nsteps) {
      __syncthreads();  // every warpgroup is done with the one stage
      stage(j + 1);
    }
  }
  if (G::CG == 1 || wg == 0) {
    store_out<0, G::NO0>(p.dv, b, h, key[0], p.Skv, p.D, dv, 1.f, tig);
    store_out<0, G::NO0>(p.dk, b, h, key[0], p.Skv, p.D, dk, p.scale, tig);
  } else {
    store_out<128, G::NO1>(p.dv, b, h, key[0], p.Skv, p.D, dv, 1.f, tig);
    store_out<128, G::NO1>(p.dk, b, h, key[0], p.Skv, p.D, dk, p.scale, tig);
  }
}

}  // namespace fdp
}  // namespace port
