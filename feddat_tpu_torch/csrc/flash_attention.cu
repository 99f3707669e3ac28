// Flash attention for Hopper (sm_90a): the forward (#7) and the backward's dq
// (#8) and dk/dv (#9) launches, online softmax over tiles of the other side.
//
// Replaces the TPU kernel feddat_tpu/ops/flash.py::_flash_fwd_kernel (kernel
// #7, called through _flash_forward), the same function at the same points:
//
//   s   = (q * scale) k^T + bias             fp32 (bf16 products, fp32 sums)
//   m   = running row max, from NEG_INF = -1e30; l = running row sum
//   acc = acc * exp(m_old - m) + p v,  p = exp(s - m) in fp32 (never rounded)
//   o   = bf16(acc / max(l, 1e-30)),  lse = m + log(max(l, 1e-30))
//
// q [B, H, Sq, 64] and k, v [B, H, Skv, 64] bf16 are Heads views (common.cuh),
// so the [B, H, S, 64] views that split() makes of [B, S, Dm] projections are
// read in place; o is written through a Heads view too (the wrapper hands a
// [B, S, H, 64] buffer, so merging the heads is a free view).  The bias is the
// compact fp32 [B|1, H|1, Sq|1, Skv|1] tensor addressed by element strides,
// 0 on a broadcast dim, so a padding row, a causal block or a packed
// block-diagonal bias is never expanded in memory.  Sq and Skv are free: key
// columns past Skv are skipped (the TPU pads them with -1e30, whose exp
// underflows to the same 0), query rows past Sq are not written.
//
// P stays fp32 in P.v, as the TPU kernel keeps it: p is split into bf16 hi =
// bf16(p) and lo = bf16(p - hi) and both multiply the bf16 v with fp32
// accumulation (p - hi is exact, lo keeps 8 more bits: p is carried to ~2^-17
// of itself, far below o's bf16 rounding).  Rounding p to bf16, as kernel #5
// does, would move o by up to 2^-9 of each term.  exp is ex2.approx on the
// logit's distance from the max times log2(e): ~2^-21 of p, far below too.
//
// What bounds it on the H100.  At ALBEF's ViT site (B=16, H=12, S=577)
// q.k^T is 8.2 GFLOP of bf16 products (~8.3 us at 989 TFLOP/s) and P.v the
// same again twice over (hi and lo: ~16.6 us, the time TF32 would take); q, k,
// v, o and lse are ~57 MB (~17 us at 3.35 TB/s): operations bound it.  At the
// short text sites bytes do.  Beside the tensor cores, each logit costs ~15
// fp32 instructions (scale, bias, max, exp, sum, the hi/lo split): ~30 us at
// the CUDA cores' rate, so the softmax must overlap the products.
//
// Design.  A 64-row mma.sync kernel that stages every key tile with the
// threads that then compute on it, writes V transposed by scalar stores and
// reads the bias per element from global memory reaches ~7% of the bound.
// So:
//   * one block of two warpgroups owns 128 query rows, 64 per warpgroup; Q is
//     loaded once into shared memory;
//   * K, V and the bias tile of each 64-key step go through a two-stage ring
//     filled by cp.async: while the warpgroups compute on step j, step j+1 is
//     in flight;
//   * q.k^T is one wgmma.m64n64k16 chain per warpgroup with Q and K both read
//     from their swizzled tiles (flash_sm90.cuh), K in its natural [key][d]
//     layout;
//   * P.v is wgmma with p's hi and lo halves as register A fragments (the C
//     fragments of q.k^T, no shared-memory round trip) and V read from its
//     natural [key][d] tile through wgmma's transposed B: nothing is stored
//     transposed;
//   * the bias tile of the block's rows and the step's keys is staged in
//     shared memory with K (a [128][64] fp32 tile, or one 64-key row when the
//     bias is constant over queries), so it is read from device memory once
//     per block;
//   * two blocks fit an SM (<= 128 registers a thread), so one block's
//     softmax overlaps the other's products.
// What still bounds it: inside a warpgroup nothing overlaps.  Each step waits
// for q.k^T, runs the softmax on the CUDA cores, then waits for P.v, and ptxas
// fences the register-A products (its C7519 note); only the SM's other three
// warpgroups fill those gaps.  At the ViT site the 960 blocks make 3.6 waves
// of 264.  The next steps are a producer warp with TMA and mbarriers, and
// q.k^T of step j+1 started before the softmax of step j (FlashAttention-3's
// ping-pong).  PERF.md §6 has the times.
//
// ---------------------------------------------------------------- backward
// Replaces feddat_tpu/ops/flash.py::_flash_bwd_dq_kernel (kernel #8) and
// ::_flash_bwd_dkv_kernel (kernel #9), called through _flash_bwd, the same
// functions at the same points (P rebuilt from the forward's lse):
//
//   s  = (q * scale) k^T + bias,  p = exp(s - lse)        fp32
//   dp = dO v^T,  ds = p (dp - delta),  delta = rowsum(dO * o)   (fp32; delta
//        is one fp32 reduction before the launches, as JAX does it in XLA)
//   #8: dq = bf16(scale * sum_keys ds k)
//   #9: dv = bf16(sum_queries p^T dO),  dk = bf16(scale * sum_queries ds^T q)
//
// p and ds stay fp32 in their products, as the TPU kernels keep them: each is
// split into bf16 hi + lo and both multiply the bf16 operand with fp32
// accumulation (as #7 does for P.v).  Rounding ds to bf16, as #6 does, would
// move dq and dk by up to 2^-9 of each term.  Keys past Skv and queries past
// Sq contribute exactly 0 (JAX pads them with -1e30 and with zero rows of q,
// dO and delta); their rows are not written.  No atomics: each block owns its
// output tile, so a second call is bitwise equal.
//
// What bounds them on the H100.  At ALBEF's ViT site (B=16, H=12, S=577) one
// [S, S] x 64 product is 8.2 GFLOP.  #8 does s and dp on bf16 operands (~16.6
// us at 989 TFLOP/s) and ds.k at fp32 precision (hi + lo, the work of one TF32
// product: ~16.6 us at 495 TFLOP/s); #9 does s^T and dp^T in bf16 and p^T.dO
// and ds^T.q at fp32 precision (~50 us).  Each moves ~70 MB (~21 us at 3.35
// TB/s): operations bound both.
//
// A 64-query mma.sync kernel that stages every key tile with the threads that
// then compute on it, writes K transposed by scalar stores and reads the bias
// per element from global memory reaches ~8% of the bound (the first design of
// all three).  Both are built as #7 is:
//   * #8: one block of two warpgroups owns 128 queries, 64 per warpgroup; Q and
//     dO are loaded once into swizzled tiles, lse and delta of the thread's two
//     rows sit in registers.  K, V and the bias of each 64-key step go through
//     #7's two-stage ring (stage_keys: the same staging, bias tile included).
//     s = Q.K^T and dp = dO.V^T are wgmma chains on the natural tiles read
//     K-major; dQ += dS.K takes dS as register A fragments (hi + lo) and reads
//     K from the same natural [key][d] tile as wgmma's transposed B.  Three
//     64 x 64 fp32 accumulators (s, dp, dq) are 96 registers before any
//     fragment or address, yet ptxas fits the kernel in 125 with no spills,
//     under __launch_bounds__(256, 2) as under (256, 1): two blocks share an
//     SM (66 KB of shared memory each without a bias tile; a [128][64] bias
//     tile takes 137 KB and leaves one).  The bound keeps it so: an edit that
//     needs more registers spills in ptxas's report instead of silently
//     halving the blocks per SM.  A third consumer warpgroup (<= 168
//     registers) would pad ViT's 577 queries to 768 rows instead of 640;
//   * #9: one block of two warpgroups owns 128 keys, 64 per warpgroup; K and V
//     are loaded once into swizzled tiles and are the A operands of s^T = K.Q^T
//     and dp^T = V.dO^T;
//   * Q and dO of each 64-query step, with that step's lse, delta and bias
//     tile, go through a two-stage cp.async ring;
//   * s^T and dp^T are wgmma chains reading Q and dO in their natural [q][d]
//     layout as K-major B; dV += P^T.dO and dK += dS^T.Q take P^T and dS^T as
//     register A fragments (hi + lo) and read dO and Q from the same tiles as
//     wgmma's transposed B: two tiles per step, none transposed;
//   * dK and dV accumulate in registers for the block's whole walk over the
//     queries and are written once.
// What still bounds them: inside a warpgroup nothing overlaps.  Each step
// waits for the bf16 products, then runs the elementwise p and ds, then the
// hi + lo products; only the SM's other block (#8) hides those waits, and in
// #9 nothing does (four 64 x 64 fp32 accumulators, 215 registers, one block
// of 8 warps per SM).  A producer warp with TMA, the next step's products
// issued before this step's elementwise work, or splitting #9's accumulators
// across more warpgroups would.

#include "flash_sm90.cuh"

using namespace port;

namespace {

constexpr int FL_BQ = 64;       // #9: queries per streamed step
constexpr int FL_BK = 64;       // #7, #8: keys per streamed step
constexpr int FL_D = 64;        // head dim
constexpr float FL_NEG_INF = -1e30f;

// two warpgroups per block, a two-stage ring of 64-row tiles
constexpr int FS_THREADS = 256;
constexpr int FS_ROWS = 128;             // query rows (#7, #8) or keys (#9) per block
constexpr int FS_STAGES = 2;
constexpr int KEY_BIAS_LD = FL_BK + 8;   // fp32 row of the staged [128 q][64 key] bias tile (#7, #8)
constexpr int F9_BIAS_LD = FS_ROWS + 4;  // fp32 row of #9's staged [64 q][128 key] bias tile
constexpr int TB = sm90::TILE_BYTES;

// How the kernels stage the bias: none, one row constant over queries, or a
// [query][key] tile per step.
enum { BIAS_NONE = 0, BIAS_ROW = 1, BIAS_TILE = 2 };

struct FlashArgs {
  Heads<const bf16> q, k, v;
  Heads<bf16> o;
  const float* bias;             // compact bias or null
  long long bsb, bsh, bsq, bsk;  // its element strides, 0 on broadcast dims
  float* lse;                    // [B, H, Sq]
  int H, Sq, Skv;
  float scale;
};

template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return {static_cast<T*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

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

// #7's and #8's ring: the K and V tiles of one 64-key step and the bias of
// the block's 128 query rows at those keys.  The bias is staged as none, one
// 64-key row (constant over queries), or a [128][KEY_BIAS_LD] fp32 tile, so it
// is read from device memory once per block.
__host__ __device__ int key_bias_floats(int mode) {
  return mode == BIAS_NONE ? 0 : mode == BIAS_ROW ? FL_BK : FS_ROWS * KEY_BIAS_LD;
}

// start the copies of (b, h)'s step at key k0 for the block at query q0 into
// the stage at `sk` (K, then V) and `bs` (its bias); one commit group.  Keys
// past Skv and rows past Sq are zero-filled.  `p` is #7's FlashArgs or #8's
// FlashBwdArgs, read in place (kernel parameters, no registers held).
template <typename Args>
__device__ __forceinline__ void stage_keys(const Args& p, int b, int h, int q0, int k0, int mode,
                                           uint32_t sk, float* bs, int tid) {
  sm90::load_tile<FS_THREADS>(sk, p.k.at(b, h), p.k.ss, k0, p.Skv, tid);
  sm90::load_tile<FS_THREADS>(sk + TB, p.v.at(b, h), p.v.ss, k0, p.Skv, tid);
  const uint32_t sb = sm90::smem_addr(bs);
  const float* bb = p.bias + b * p.bsb + h * p.bsh;  // read only when mode != BIAS_NONE
  if (mode == BIAS_ROW) {
    if (tid < FL_BK) {
      const bool ok = k0 + tid < p.Skv;
      sm90::cp_async4(sb + tid * 4, bb + (ok ? (long long)(k0 + tid) * p.bsk : 0), ok);
    }
  } else if (mode == BIAS_TILE) {
    for (int i = tid; i < FS_ROWS * FL_BK; i += FS_THREADS) {
      const int r = i / FL_BK, c = i % FL_BK;
      const bool ok = q0 + r < p.Sq && k0 + c < p.Skv;
      sm90::cp_async4(sb + (r * KEY_BIAS_LD + c) * 4,
                      bb + (ok ? (long long)(q0 + r) * p.bsq + (long long)(k0 + c) * p.bsk : 0), ok);
    }
  }
  sm90::cp_async_commit();
}

// the staged bias of block rows lrow and lrow + 8 at the step's keys c, c + 1
__device__ __forceinline__ void staged_bias(int mode, const float* bs, int lrow, int c, float2 (&bv)[2]) {
  bv[0] = bv[1] = make_float2(0.f, 0.f);
  if (mode == BIAS_ROW) {
    bv[0] = bv[1] = *reinterpret_cast<const float2*>(bs + c);
  } else if (mode == BIAS_TILE) {
    bv[0] = *reinterpret_cast<const float2*>(bs + lrow * KEY_BIAS_LD + c);
    bv[1] = *reinterpret_cast<const float2*>(bs + (lrow + 8) * KEY_BIAS_LD + c);
  }
}

// #7's dynamic shared memory: Q (two tiles), then K and V of each stage, then
// the bias of each stage
int fwd_smem_bytes(int mode) { return 1024 + (2 + 2 * FS_STAGES) * TB + FS_STAGES * key_bias_floats(mode) * 4; }

__global__ void __launch_bounds__(FS_THREADS, 2) flash_fwd_kernel(FlashArgs p, int mode) {
  extern __shared__ __align__(16) uint8_t fs_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fs_smem, &sp);
  const uint32_t sQ = sbase;                             // + wg * TB
  float* bias_s = reinterpret_cast<float*>(sp + (2 + 2 * FS_STAGES) * TB);
  const int bias_stage = key_bias_floats(mode);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FS_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lrow = wg * 64 + warp * 16 + g;  // block-local row of d[..0|1]; lrow + 8 of d[..2|3]
  const int nsteps = (p.Skv + FL_BK - 1) / FL_BK;
  // step j's K, V and bias go to ring stage j % 2
  auto stage = [&](int j) {
    const int st = j % FS_STAGES;
    stage_keys(p, b, h, q0, j * FL_BK, mode, sbase + (2 + 2 * st) * TB, bias_s + st * bias_stage, tid);
  };

  const bf16* qb = p.q.at(b, h);
  sm90::load_tile<FS_THREADS>(sQ, qb, p.q.ss, q0, p.Sq, tid);
  sm90::load_tile<FS_THREADS>(sQ + TB, qb, p.q.ss, q0 + 64, p.Sq, tid);
  stage(0);  // Q lands with the first step

  float m[2] = {FL_NEG_INF, FL_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums (its 2 columns of each 8-key tile)
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    const int st = j % FS_STAGES, k0 = j * FL_BK;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (j + 1 < nsteps) stage(j + 1);
    const uint32_t sk = sbase + (2 + 2 * st) * TB;

    // s = q.k^T for the warpgroup's 64 rows x 64 keys
    float s[32];
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FL_D / 16; ++ks)
      sm90::wgmma_ss(s, sm90::desc_k(sQ + wg * TB, ks), sm90::desc_k(sk, ks), ks);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);

    // scale, bias; keys past Skv drop out (-inf: exp gives 0 and the max ignores them)
    const float* bs = bias_s + st * bias_stage;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
      const int c = nt * 8 + tig * 2;  // step-local key of d[nt * 4 + 0|2]
      float2 bv[2];
      staged_bias(mode, bs, lrow, c, bv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = -INFINITY;
        if (k0 + c + (e & 1) < p.Skv)
          x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), (e & 1) ? bv[r].y : bv[r].x);
        s[nt * 4 + e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      corr[r] = sm90::ex2((m[r] - mn) * sm90::LOG2E);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float e = sm90::ex2((s[i] - m[r]) * sm90::LOG2E);
      s[i] = e;
      l[r] += e;
      o[i] *= corr[r];
    }

    // o += p.v with p = hi + lo in bf16, v from its natural [key][d] tile
    sm90::pin(o);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FL_BK / 16; ++ks) {
      uint32_t hi[4], lo[4];
      sm90::hilo_frags(s, ks, hi, lo);
      const uint64_t dv = sm90::desc_mn(sk + TB, ks);
      sm90::wgmma_rs_t(o, hi, dv);
      sm90::wgmma_rs_t(o, lo, dv);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    sm90::pin(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  bf16* ob = p.o.at(b, h);
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row[r] * p.o.ss + col) =
            pack_bf16(o[nt * 4 + 2 * r] / l[r], o[nt * 4 + 2 * r + 1] / l[r]);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq) p.lse[((long long)b * p.H + h) * p.Sq + row[r]] = m[r] + logf(l[r]);
  }
}

struct FlashBwdArgs {
  Heads<const bf16> q, k, v, dout;
  Heads<bf16> dq, dk, dv;
  const float* bias;             // compact bias or null
  long long bsb, bsh, bsq, bsk;  // its element strides, 0 on broadcast dims
  const float* lse;              // [B, H, Sq] from the forward
  const float* delta;            // [B, H, Sq] rowsum(dO * o)
  int H, Sq, Skv;
  float scale;
};

// #9's kernel comes before #8's in this file on purpose: with #8's first,
// ptxas (CUDA 12.8) gave #9 167 registers instead of 215 and #9 ran 1.44x
// slower (0.284 against 0.197 ms at the ViT site on the H100); #8's own code
// is the same either way.
// #9's dynamic shared memory: K and V of the block (two tiles each), then Q and
// dO of each stage, then lse and delta of each stage (64 fp32 each), then the
// bias tile of each stage ([64][F9_BIAS_LD] fp32, only when it varies over queries)
__host__ __device__ int dkv_bias_floats(int mode) { return mode == BIAS_TILE ? FL_BQ * F9_BIAS_LD : 0; }
int dkv_smem_bytes(int mode) {
  return 1024 + (4 + 2 * FS_STAGES) * TB + FS_STAGES * (2 * FL_BQ + dkv_bias_floats(mode)) * 4;
}

__global__ void __launch_bounds__(FS_THREADS, 1) flash_bwd_dkv_kernel(FlashBwdArgs p, int mode) {
  extern __shared__ __align__(16) uint8_t fs_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fs_smem, &sp);
  const uint32_t sK = sbase, sV = sbase + 2 * TB;  // + wg * TB
  float* vec_s = reinterpret_cast<float*>(sp + (4 + 2 * FS_STAGES) * TB);  // [stage][lse 64 | delta 64]
  float* bias_s = vec_s + FS_STAGES * 2 * FL_BQ;
  const int bias_stage = dkv_bias_floats(mode);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * FS_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lkey = wg * 64 + warp * 16 + g;  // block-local key of d[..0|1]; lkey + 8 of d[..2|3]
  const int key[2] = {k0 + lkey, k0 + lkey + 8};
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;
  const bf16* qb = p.q.at(b, h);
  const bf16* dob = p.dout.at(b, h);
  const float* bb = p.bias != nullptr ? p.bias + b * p.bsb + h * p.bsh : nullptr;
  const int nsteps = (p.Sq + FL_BQ - 1) / FL_BQ;

  // a bias constant over queries is two registers (clamped: keys past Skv drop out)
  float bkey[2] = {0.f, 0.f};
  if (mode == BIAS_ROW) {
#pragma unroll
    for (int r = 0; r < 2; ++r) bkey[r] = bb[(long long)min(key[r], p.Skv - 1) * p.bsk];
  }

  // start the copies of query step j's Q, dO, lse, delta and bias into ring stage j % 2
  // (one commit group)
  auto stage = [&](int j) {
    const int st = j % FS_STAGES, qt = j * FL_BQ;
    const uint32_t sq = sbase + (4 + 2 * st) * TB;
    sm90::load_tile<FS_THREADS>(sq, qb, p.q.ss, qt, p.Sq, tid);
    sm90::load_tile<FS_THREADS>(sq + TB, dob, p.dout.ss, qt, p.Sq, tid);
    if (tid < 2 * FL_BQ) {
      const int i = tid % FL_BQ;
      const bool ok = qt + i < p.Sq;
      const float* src = (tid < FL_BQ ? p.lse : p.delta) + lse0 + (ok ? qt + i : 0);
      sm90::cp_async4(sm90::smem_addr(vec_s + st * 2 * FL_BQ + tid), src, ok);
    }
    if (mode == BIAS_TILE) {
      const uint32_t sb = sm90::smem_addr(bias_s + st * bias_stage);
      for (int i = tid; i < FL_BQ * FS_ROWS; i += FS_THREADS) {
        const int r = i / FS_ROWS, c = i % FS_ROWS;
        const bool ok = qt + r < p.Sq && k0 + c < p.Skv;
        sm90::cp_async4(sb + (r * F9_BIAS_LD + c) * 4,
                        bb + (ok ? (long long)(qt + r) * p.bsq + (long long)(k0 + c) * p.bsk : 0), ok);
      }
    }
    sm90::cp_async_commit();
  };

  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    sm90::load_tile<FS_THREADS>(sK + t * TB, kb, p.k.ss, k0 + 64 * t, p.Skv, tid);
    sm90::load_tile<FS_THREADS>(sV + t * TB, vb, p.v.ss, k0 + 64 * t, p.Skv, tid);
  }
  stage(0);  // K and V land with the first step

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    const int st = j % FS_STAGES, qt = j * FL_BQ;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (j + 1 < nsteps) stage(j + 1);
    const uint32_t sq = sbase + (4 + 2 * st) * TB, so = sq + TB;

    // s^T = K.Q^T and dp^T = V.dO^T: rows = the warpgroup's 64 keys, columns = 64 queries
    float s[32], dp[32];
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FL_D / 16; ++ks)
      sm90::wgmma_ss(s, sm90::desc_k(sK + wg * TB, ks), sm90::desc_k(sq, ks), ks);
#pragma unroll
    for (int ks = 0; ks < FL_D / 16; ++ks)
      sm90::wgmma_ss(dp, sm90::desc_k(sV + wg * TB, ks), sm90::desc_k(so, ks), ks);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);
    sm90::pin(dp);

    // p^T and ds^T in place; queries past Sq and keys past Skv give 0
    const float* lse_s = vec_s + st * 2 * FL_BQ;
    const float* dl_s = lse_s + FL_BQ;
    const float* bs = bias_s + st * bias_stage;
#pragma unroll
    for (int nt = 0; nt < FL_BQ / 8; ++nt) {
      const int qi = nt * 8 + tig * 2;  // step-local query of d[nt * 4 + 0|2]
      const float2 lq = *reinterpret_cast<const float2*>(lse_s + qi);
      const float2 dq = *reinterpret_cast<const float2*>(dl_s + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = e & 1;
        float pr = 0.f, ds = 0.f;
        if (qt + qi + c < p.Sq && key[r] < p.Skv) {
          const float bv = mode == BIAS_ROW    ? bkey[r]
                           : mode == BIAS_TILE ? bs[(qi + c) * F9_BIAS_LD + lkey + 8 * r]
                                               : 0.f;
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), bv);
          pr = sm90::ex2((x - (c ? lq.y : lq.x)) * sm90::LOG2E);
          ds = pr * (dp[nt * 4 + e] - (c ? dq.y : dq.x));
        }
        s[nt * 4 + e] = pr;
        dp[nt * 4 + e] = ds;
      }
    }

    // dv += p^T.dO and dk += ds^T.q, p and ds as bf16 hi + lo, dO and q from
    // their natural [q][d] tiles
    sm90::pin(dk);
    sm90::pin(dv);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FL_BQ / 16; ++ks) {
      uint32_t hi[4], lo[4];
      sm90::hilo_frags(s, ks, hi, lo);
      const uint64_t dso = sm90::desc_mn(so, ks);
      sm90::wgmma_rs_t(dv, hi, dso);
      sm90::wgmma_rs_t(dv, lo, dso);
      sm90::hilo_frags(dp, ks, hi, lo);
      const uint64_t dsq = sm90::desc_mn(sq, ks);
      sm90::wgmma_rs_t(dk, hi, dsq);
      sm90::wgmma_rs_t(dk, lo, dsq);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    sm90::pin(dk);
    sm90::pin(dv);
  }

  bf16* dkb = p.dk.at(b, h);
  bf16* dvb = p.dv.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key[r] < p.Skv) {
        *reinterpret_cast<uint32_t*>(dvb + (long long)key[r] * p.dv.ss + col) =
            pack_bf16(dv[nt * 4 + 2 * r], dv[nt * 4 + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dkb + (long long)key[r] * p.dk.ss + col) =
            pack_bf16(dk[nt * 4 + 2 * r] * p.scale, dk[nt * 4 + 2 * r + 1] * p.scale);
      }
  }
}

// #8's dynamic shared memory: Q and dO (two tiles each), then K and V of each
// stage, then the bias of each stage (as #7's)
int dq_smem_bytes(int mode) { return 1024 + (4 + 2 * FS_STAGES) * TB + FS_STAGES * key_bias_floats(mode) * 4; }

// <= 128 registers a thread, so two blocks share an SM where the shared
// memory allows it (see the note at the top of the file).
__global__ void __launch_bounds__(FS_THREADS, 2) flash_bwd_dq_kernel(FlashBwdArgs p, int mode) {
  extern __shared__ __align__(16) uint8_t fs_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fs_smem, &sp);
  const uint32_t sQ = sbase, sO = sbase + 2 * TB;  // + wg * TB
  float* bias_s = reinterpret_cast<float*>(sp + (4 + 2 * FS_STAGES) * TB);
  const int bias_stage = key_bias_floats(mode);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FS_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lrow = wg * 64 + warp * 16 + g;  // block-local row of d[..0|1]; lrow + 8 of d[..2|3]
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
  const int nsteps = (p.Skv + FL_BK - 1) / FL_BK;
  // step j's K, V and bias go to ring stage j % 2
  auto stage = [&](int j) {
    const int st = j % FS_STAGES;
    stage_keys(p, b, h, q0, j * FL_BK, mode, sbase + (4 + 2 * st) * TB, bias_s + st * bias_stage, tid);
  };

  const bf16* qb = p.q.at(b, h);
  const bf16* dob = p.dout.at(b, h);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    sm90::load_tile<FS_THREADS>(sQ + t * TB, qb, p.q.ss, q0 + 64 * t, p.Sq, tid);
    sm90::load_tile<FS_THREADS>(sO + t * TB, dob, p.dout.ss, q0 + 64 * t, p.Sq, tid);
  }
  stage(0);  // Q and dO land with the first step

  // lse and delta of this thread's two rows (clamped: rows past Sq drop out below)
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = min(row[r], p.Sq - 1);
    lse_r[r] = p.lse[lse0 + q];
    dl_r[r] = p.delta[lse0 + q];
  }

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    const int st = j % FS_STAGES, k0 = j * FL_BK;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (j + 1 < nsteps) stage(j + 1);
    const uint32_t sk = sbase + (4 + 2 * st) * TB;

    // s = q.k^T and dp = dO.v^T for the warpgroup's 64 rows x 64 keys
    float s[32], dp[32];
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FL_D / 16; ++ks)
      sm90::wgmma_ss(s, sm90::desc_k(sQ + wg * TB, ks), sm90::desc_k(sk, ks), ks);
#pragma unroll
    for (int ks = 0; ks < FL_D / 16; ++ks)
      sm90::wgmma_ss(dp, sm90::desc_k(sO + wg * TB, ks), sm90::desc_k(sk + TB, ks), ks);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);
    sm90::pin(dp);

    // ds = p (dp - delta) in place of s; keys past Skv and rows past Sq give 0
    const float* bs = bias_s + st * bias_stage;
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
      const int c = nt * 8 + tig * 2;  // step-local key of d[nt * 4 + 0|2]
      float2 bv[2];
      staged_bias(mode, bs, lrow, c, bv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = 0.f;
        if (k0 + c + (e & 1) < p.Skv && row[r] < p.Sq) {
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), (e & 1) ? bv[r].y : bv[r].x);
          const float pr = sm90::ex2((x - lse_r[r]) * sm90::LOG2E);
          ds = pr * (dp[nt * 4 + e] - dl_r[r]);
        }
        s[nt * 4 + e] = ds;
      }
    }

    // dq += ds.k with ds = hi + lo in bf16, k from its natural [key][d] tile
    sm90::pin(dq);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < FL_BK / 16; ++ks) {
      uint32_t hi[4], lo[4];
      sm90::hilo_frags(s, ks, hi, lo);
      const uint64_t dk = sm90::desc_mn(sk, ks);
      sm90::wgmma_rs_t(dq, hi, dk);
      sm90::wgmma_rs_t(dq, lo, dk);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
    sm90::pin(dq);
  }

  bf16* dqb = p.dq.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        *reinterpret_cast<uint32_t*>(dqb + (long long)row[r] * p.dq.ss + col) =
            pack_bf16(dq[nt * 4 + 2 * r] * p.scale, dq[nt * 4 + 2 * r + 1] * p.scale);
  }
}

FlashBwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* bias, const void* lse, const void* delta, void* dq, void* dk,
                      void* dv, const long long* strides, int H, int Sq, int Skv, float scale) {
  FlashBwdArgs a{};
  a.q = heads<const bf16>(q, strides);
  a.k = heads<const bf16>(k, strides + 3);
  a.v = heads<const bf16>(v, strides + 6);
  a.dout = heads<const bf16>(dout, strides + 9);
  a.dq = heads<bf16>(dq, strides + 12);
  a.dk = heads<bf16>(dk, strides + 15);
  a.dv = heads<bf16>(dv, strides + 18);
  a.bias = static_cast<const float*>(bias);
  a.bsb = strides[21];
  a.bsh = strides[22];
  a.bsq = strides[23];
  a.bsk = strides[24];
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.scale = scale;
  return a;
}

bool bad_sizes(int B, int H, int Sq, int Skv) {
  return B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535;
}

int bias_mode(const void* bias, long long bsq) {
  return bias == nullptr ? BIAS_NONE : bsq == 0 ? BIAS_ROW : BIAS_TILE;
}

int fwd_smem_done[64], dq_smem_done[64], dkv_smem_done[64];

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q [B, H, Sq, 64], k and v [B, H, Skv, 64] bf16 and o (output, [B, H, Sq, 64])
// by element strides (strides[0..11]: q, k, v, o as sb, sh, ss); bias fp32 or
// null with strides[12..15] = its b, h, q, k element strides (0 on broadcast
// dims); lse [B, H, Sq] fp32 (output).  Every bf16 operand's start must be
// 16-byte aligned and its strides multiples of 8 elements (cp.async copies 16
// bytes).  Returns the CUDA error of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, const long long* strides, int B, int H, int Sq, int Skv,
                        float scale, void* stream) {
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  FlashArgs a{};
  a.q = heads<const bf16>(q, strides);
  a.k = heads<const bf16>(k, strides + 3);
  a.v = heads<const bf16>(v, strides + 6);
  a.o = heads<bf16>(o, strides + 9);
  a.bias = static_cast<const float*>(bias);
  a.bsb = strides[12];
  a.bsh = strides[13];
  a.bsq = strides[14];
  a.bsk = strides[15];
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.scale = scale;
  const cudaError_t err = sm90::allow_smem(flash_fwd_kernel, fwd_smem_bytes(BIAS_TILE), fwd_smem_done);
  if (err != cudaSuccess) return (int)err;
  const int mode = bias_mode(bias, a.bsq);
  dim3 grid((Sq + FS_ROWS - 1) / FS_ROWS, H, B);
  flash_fwd_kernel<<<grid, FS_THREADS, fwd_smem_bytes(mode), reinterpret_cast<cudaStream_t>(stream)>>>(
      a, mode);
  return (int)cudaGetLastError();
}

// The backward's operands by element strides: strides[0..20] are q, k, v, dout,
// dq, dk, dv as (sb, sh, ss), all [B, H, S, 64] bf16 (dq/dk/dv outputs);
// strides[21..24] the bias's b, h, q, k element strides (0 on broadcast dims;
// bias fp32 or null); lse and delta [B, H, Sq] fp32 contiguous.  Each entry
// point launches one kernel and returns the CUDA error of the launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* bias, const void* lse, const void* delta, void* dq,
                           const long long* strides, int B, int H, int Sq, int Skv, float scale,
                           void* stream) {
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const FlashBwdArgs a = bwd_args(q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, strides, H,
                                  Sq, Skv, scale);
  const cudaError_t err = sm90::allow_smem(flash_bwd_dq_kernel, dq_smem_bytes(BIAS_TILE), dq_smem_done);
  if (err != cudaSuccess) return (int)err;
  const int mode = bias_mode(bias, a.bsq);
  dim3 grid((Sq + FS_ROWS - 1) / FS_ROWS, H, B);
  flash_bwd_dq_kernel<<<grid, FS_THREADS, dq_smem_bytes(mode), reinterpret_cast<cudaStream_t>(stream)>>>(
      a, mode);
  return (int)cudaGetLastError();
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* bias, const void* lse, const void* delta, void* dk, void* dv,
                            const long long* strides, int B, int H, int Sq, int Skv, float scale,
                            void* stream) {
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const FlashBwdArgs a = bwd_args(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, strides, H, Sq,
                                  Skv, scale);
  const cudaError_t err = sm90::allow_smem(flash_bwd_dkv_kernel, dkv_smem_bytes(BIAS_TILE), dkv_smem_done);
  if (err != cudaSuccess) return (int)err;
  const int mode = bias_mode(bias, a.bsq);
  dim3 grid((Skv + FS_ROWS - 1) / FS_ROWS, H, B);
  flash_bwd_dkv_kernel<<<grid, FS_THREADS, dkv_smem_bytes(mode),
                         reinterpret_cast<cudaStream_t>(stream)>>>(a, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
