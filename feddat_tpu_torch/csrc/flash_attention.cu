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
//
// ------------------------------------------------------------------- fp32
// All three take bf16 or fp32 q, k, v (dO), as the TPU kernels take the
// model's dtype (they upcast every operand to fp32 and write o, dq, dk, dv in
// the inputs' dtype).  The kernels are templates over that element type T;
// the bf16 instances are the kernels described above, unchanged.  In the fp32
// instances:
//   * each fp32 operand is its three bf16 terms (common.cuh's split3: x = hi +
//     mid + lo exactly), written once per call as contiguous [B, H, S, 64]
//     planes in the caller's workspace (split3_heads_kernel, by the #7 and #8
//     entries; #9's entry reads the planes #8's left there) and loaded as
//     three swizzled tiles per 64-row block;
//   * q.k^T and dO.v^T are the six term products of common.cuh's pair order
//     (sm90::product_ss), and P, dP's ds (#8, #9) are split into three bf16
//     terms in registers and multiply v's, k's, dO's or q's three term tiles
//     the same way (sm90::product_rs): every product is fp32-accurate;
//   * o, dq, dk and dv sum each 64-row step's products in a fresh
//     accumulator and add it to theirs in one fp32 add (step_sum): the
//     tensor cores round each addition at the magnitude of the running sum,
//     so the first design, which let the products of every step add into
//     it, read up to 4.5x the plain fp32 version's error from float64 at
//     S=577 (and the fp32 ALBEF step's adapter gradients 1.4e-4 from the
//     plain fp32 path's); summed apart, at most 0.9x.  #8 and #9 take the
//     step's sum in a product accumulator that is dead at that point (#9
//     runs its two products apart for it), #7 in 32 registers more;
//   * exp is expf, as the plain versions and jnp.exp;
//   * o, dq, dk and dv are written as fp32, lse stays fp32.
// Shared memory triples with the tiles (TB = 8 KB each): #7 takes 18 tiles
// and, with a [128][KEY_BIAS_LD] bias tile per stage, 222,208 B (one block
// per SM of 232,448 B); #8 and #9 take 24 tiles, 197,632 and 198,656 B with
// no bias or a bias row.  Their bias-tile mode (ALBEF's decoder: causal plus
// padding, or the packed block-diagonal bias) would need 271,360 and 266,240
// B with two ring stages, so their fp32 tile-mode instances run ONE ring
// stage (185,344 and 182,784 B): step j+1's copies start after every
// warpgroup is done with step j, so nothing overlaps the copies in that mode.
// Every fp32 instance runs one block per SM (__launch_bounds__(256, 1)).
//
// ------------------------------------------------------ other head dims
// Head dim 64 runs the kernels above.  Every other head dim from 1 to 256
// runs attn_any.cuh's bodies with FLASH = true (the same functions at the
// same points: online softmax from -1e30, P and ds at fp32 precision, the
// compact bias), D padded to 64-column chunks, one warpgroup a block, under
// this file's flash_any_fwd_kernel and flash_any_bwd_dq/dkv_kernel, defined
// after every head-dim-64 entry so that those compile as before.  There an
// fp32 operand's terms are contiguous [B, H, S, D] planes.

#include "attn_any.cuh"

using namespace port;

namespace {

constexpr int FL_BQ = 64;       // #9: queries per streamed step
constexpr int FL_BK = 64;       // #7, #8: keys per streamed step
constexpr int FL_D = 64;        // head dim
constexpr float FL_NEG_INF = -1e30f;

// two warpgroups per block, a two-stage ring of 64-row tiles (one stage in
// #8's and #9's fp32 bias-tile instances)
constexpr int FS_THREADS = 256;
constexpr int FS_ROWS = 128;             // query rows (#7, #8) or keys (#9) per block
constexpr int FS_STAGES = 2;
constexpr int KEY_BIAS_LD = FL_BK + 8;   // fp32 row of the staged [128 q][64 key] bias tile (#7, #8)
constexpr int F9_BIAS_LD = FS_ROWS + 4;  // fp32 row of #9's staged [64 q][128 key] bias tile
constexpr int TB = sm90::TILE_BYTES;

// How the kernels stage the bias: none, one row constant over queries, or a
// [query][key] tile per step.
enum { BIAS_NONE = 0, BIAS_ROW = 1, BIAS_TILE = 2 };

// q, k, v: bf16, or the three bf16 term planes of fp32 ones (Heads::tt
// apart); o of the element type T.
template <typename T>
struct FlashArgs {
  Heads<const bf16> q, k, v;
  Heads<T> o;
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

// exp of a logit's distance from the row max or lse: ex2.approx in bf16
// (~2^-21 of p, far below o's rounding), expf in fp32 (as torch.exp)
template <typename T>
__device__ __forceinline__ float exp_t(float x) {
  if constexpr (kTerms<T> == 1) {
    return sm90::ex2(x * sm90::LOG2E);
  } else {
    return expf(x);
  }
}

// d += x . B for a 64 x 64 fp32 x (P or dS) at fp32 precision and a bf16 B,
// the natural [64 rows][64] tile read as wgmma's transposed B: x as bf16 hi +
// lo, both multiplying B (the bf16 kernels)
__device__ __forceinline__ void hilo_product(float (&d)[32], const float (&x)[32], uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < FL_BK / 16; ++ks) {
    uint32_t hi[4], lo[4];
    sm90::hilo_frags(x, ks, hi, lo);
    const uint64_t db = sm90::desc_mn(b, ks);
    sm90::wgmma_rs_t(d, hi, db);
    sm90::wgmma_rs_t(d, lo, db);
  }
}

// The same product in fp32, acc += x . B with x's three terms on B's three
// term tiles: the six term products of one step summed in `tmp` (a fresh
// accumulator) and added to acc in one fp32 add each.  The tensor cores'
// accumulation rounds at the magnitude of the sum it adds to, so a running
// sum over the whole sequence would take every step's products at its own,
// larger magnitude (the error grows with the steps).
__device__ __forceinline__ void step_sum(float (&acc)[32], float (&tmp)[32], const float (&x)[32],
                                         uint32_t b) {
  sm90::wg_fence();
  sm90::product_rs<3, true>(tmp, x, b);
  sm90::wg_commit();
  sm90::wg_wait_all();
  sm90::pin(tmp);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
}

// rows [r0, r0 + 64) of an operand's NT term planes (tt apart) into
// consecutive swizzled tiles from `tile`
template <int NT>
__device__ __forceinline__ void load_terms(uint32_t tile, const bf16* src, long long ss, long long tt, int r0,
                                           int S, int tid) {
#pragma unroll
  for (int t = 0; t < NT; ++t) sm90::load_tile<FS_THREADS>(tile + t * TB, src + t * tt, ss, r0, S, tid);
}

// #7's and #8's ring: the K and V tiles of one 64-key step and the bias of
// the block's 128 query rows at those keys.  The bias is staged as none, one
// 64-key row (constant over queries), or a [128][KEY_BIAS_LD] fp32 tile, so it
// is read from device memory once per block.
__host__ __device__ int key_bias_floats(int mode) {
  return mode == BIAS_NONE ? 0 : mode == BIAS_ROW ? FL_BK : FS_ROWS * KEY_BIAS_LD;
}

// start the copies of (b, h)'s step at key k0 for the block at query q0 into
// the stage at `sk` (K's NT term tiles, then V's) and `bs` (its bias); one
// commit group.  Keys past Skv and rows past Sq are zero-filled.  `p` is #7's
// FlashArgs or #8's FlashBwdArgs, read in place (kernel parameters, no
// registers held).
template <int NT, typename Args>
__device__ __forceinline__ void stage_keys(const Args& p, int b, int h, int q0, int k0, int mode,
                                           uint32_t sk, float* bs, int tid) {
  load_terms<NT>(sk, p.k.at(b, h), p.k.ss, p.k.tt, k0, p.Skv, tid);
  load_terms<NT>(sk + NT * TB, p.v.at(b, h), p.v.ss, p.v.tt, k0, p.Skv, tid);
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

// Blocks per SM a kernel's registers must allow: two for #7's and #8's bf16
// instances (see above), one for every fp32 instance (its shared memory holds
// one block per SM).
template <typename T>
constexpr int blocks_fwd_dq() { return kTerms<T> == 1 ? 2 : 1; }

// #7's dynamic shared memory: Q (two warpgroups' NT tiles), then K and V of
// each stage, then the bias of each stage
template <int NT, int NSTG>
int fwd_smem_bytes(int mode) { return 1024 + NT * (2 + 2 * NSTG) * TB + NSTG * key_bias_floats(mode) * 4; }

template <typename T, int NSTG>
__global__ void __launch_bounds__(FS_THREADS, blocks_fwd_dq<T>()) flash_fwd_kernel(FlashArgs<T> p, int mode) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t fs_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fs_smem, &sp);
  const uint32_t sQ = sbase;                             // + wg * NT * TB
  float* bias_s = reinterpret_cast<float*>(sp + NT * (2 + 2 * NSTG) * TB);
  const int bias_stage = key_bias_floats(mode);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FS_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lrow = wg * 64 + warp * 16 + g;  // block-local row of d[..0|1]; lrow + 8 of d[..2|3]
  const int nsteps = (p.Skv + FL_BK - 1) / FL_BK;
  // step j's K, V and bias go to ring stage j % NSTG
  auto stage = [&](int j) {
    const int st = j % NSTG;
    stage_keys<NT>(p, b, h, q0, j * FL_BK, mode, sbase + NT * (2 + 2 * st) * TB, bias_s + st * bias_stage, tid);
  };

  const bf16* qb = p.q.at(b, h);
  load_terms<NT>(sQ, qb, p.q.ss, p.q.tt, q0, p.Sq, tid);
  load_terms<NT>(sQ + NT * TB, qb, p.q.ss, p.q.tt, q0 + 64, p.Sq, tid);
  stage(0);  // Q lands with the first step

  float m[2] = {FL_NEG_INF, FL_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums (its 2 columns of each 8-key tile)
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    const int st = j % NSTG, k0 = j * FL_BK;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (NSTG > 1 && j + 1 < nsteps) stage(j + 1);
    const uint32_t sk = sbase + NT * (2 + 2 * st) * TB;

    // s = q.k^T for the warpgroup's 64 rows x 64 keys
    float s[32];
    sm90::wg_fence();
    sm90::product_ss<NT>(s, sQ + wg * NT * TB, sk);
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
      corr[r] = exp_t<T>(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float e = exp_t<T>(s[i] - m[r]);
      s[i] = e;
      l[r] += e;
      o[i] *= corr[r];
    }

    // o += p.v at fp32 precision, v from its natural [key][d] tiles (fp32:
    // the step's products summed apart, then added to o: step_sum)
    if constexpr (NT == 1) {
      sm90::pin(o);
      sm90::wg_fence();
      hilo_product(o, s, sk + TB);
      sm90::wg_commit();
      sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
      sm90::pin(o);
    } else {
      float pv[32];
      step_sum(o, pv, s, sk + NT * TB);
    }
    if (NSTG == 1 && j + 1 < nsteps) {
      __syncthreads();  // every warpgroup is done with the one stage
      stage(j + 1);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  T* ob = p.o.at(b, h);
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        store2(ob + (long long)row[r] * p.o.ss + col, o[nt * 4 + 2 * r] / l[r], o[nt * 4 + 2 * r + 1] / l[r]);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq) p.lse[((long long)b * p.H + h) * p.Sq + row[r]] = m[r] + logf(l[r]);
  }
}

// q, k, v, dout: bf16, or the three bf16 term planes of fp32 ones; dq, dk,
// dv of the element type T.
template <typename T>
struct FlashBwdArgs {
  Heads<const bf16> q, k, v, dout;
  Heads<T> dq, dk, dv;
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
// is the same either way.  (The entries below keep that order too.)
// #9's dynamic shared memory: K and V of the block (two warpgroups' NT tiles
// each), then Q and dO of each stage, then lse and delta of each stage (64
// fp32 each), then the bias tile of each stage ([64][F9_BIAS_LD] fp32, only
// when it varies over queries)
__host__ __device__ int dkv_bias_floats(int mode) { return mode == BIAS_TILE ? FL_BQ * F9_BIAS_LD : 0; }
template <int NT, int NSTG>
int dkv_smem_bytes(int mode) {
  return 1024 + NT * (4 + 2 * NSTG) * TB + NSTG * (2 * FL_BQ + dkv_bias_floats(mode)) * 4;
}

template <typename T, int NSTG>
__global__ void __launch_bounds__(FS_THREADS, 1) flash_bwd_dkv_kernel(FlashBwdArgs<T> p, int mode) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t fs_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fs_smem, &sp);
  const uint32_t sK = sbase, sV = sbase + 2 * NT * TB;  // + wg * NT * TB
  float* vec_s = reinterpret_cast<float*>(sp + NT * (4 + 2 * NSTG) * TB);  // [stage][lse 64 | delta 64]
  float* bias_s = vec_s + NSTG * 2 * FL_BQ;
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

  // start the copies of query step j's Q, dO, lse, delta and bias into ring
  // stage j % NSTG (one commit group)
  auto stage = [&](int j) {
    const int st = j % NSTG, qt = j * FL_BQ;
    const uint32_t sq = sbase + NT * (4 + 2 * st) * TB;
    load_terms<NT>(sq, qb, p.q.ss, p.q.tt, qt, p.Sq, tid);
    load_terms<NT>(sq + NT * TB, dob, p.dout.ss, p.dout.tt, qt, p.Sq, tid);
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
    load_terms<NT>(sK + t * NT * TB, kb, p.k.ss, p.k.tt, k0 + 64 * t, p.Skv, tid);
    load_terms<NT>(sV + t * NT * TB, vb, p.v.ss, p.v.tt, k0 + 64 * t, p.Skv, tid);
  }
  stage(0);  // K and V land with the first step

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    const int st = j % NSTG, qt = j * FL_BQ;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (NSTG > 1 && j + 1 < nsteps) stage(j + 1);
    const uint32_t sq = sbase + NT * (4 + 2 * st) * TB, so = sq + NT * TB;

    const float* lse_s = vec_s + st * 2 * FL_BQ;
    const float* dl_s = lse_s + FL_BQ;
    const float* bs = bias_s + st * bias_stage;
    // p^T from s^T in place; queries past Sq and keys past Skv give 0
    auto probs = [&](float (&x)[32]) {
#pragma unroll
      for (int nt = 0; nt < FL_BQ / 8; ++nt) {
        const int qi = nt * 8 + tig * 2;  // step-local query of d[nt * 4 + 0|2]
        const float2 lq = *reinterpret_cast<const float2*>(lse_s + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = e & 1;
          float pr = 0.f;
          if (qt + qi + c < p.Sq && key[r] < p.Skv) {
            const float bv = mode == BIAS_ROW    ? bkey[r]
                             : mode == BIAS_TILE ? bs[(qi + c) * F9_BIAS_LD + lkey + 8 * r]
                                                 : 0.f;
            const float xs = __fadd_rn(__fmul_rn(x[nt * 4 + e], p.scale), bv);
            pr = exp_t<T>(xs - (c ? lq.y : lq.x));
          }
          x[nt * 4 + e] = pr;
        }
      }
    };

    float s[32], dp[32];
    if constexpr (NT == 1) {
      // s^T = K.Q^T and dp^T = V.dO^T: rows = the warpgroup's 64 keys, columns = 64 queries
      sm90::wg_fence();
      sm90::product_ss<NT>(s, sK + wg * NT * TB, sq);
      sm90::product_ss<NT>(dp, sV + wg * NT * TB, so);
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(s);
      sm90::pin(dp);

      // p^T and ds^T in place; queries past Sq and keys past Skv give 0
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
            pr = exp_t<T>(x - (c ? lq.y : lq.x));
            ds = pr * (dp[nt * 4 + e] - (c ? dq.y : dq.x));
          }
          s[nt * 4 + e] = pr;
          dp[nt * 4 + e] = ds;
        }
      }

      // dv += p^T.dO and dk += ds^T.q at fp32 precision, dO and q from their
      // natural [q][d] tiles: p and ds as hi + lo, the two products
      // interleaved by k-step
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
    } else {
      // fp32: the step's dv and dk products each summed apart (step_sum) in
      // the accumulator that is free at that point, with no registers more:
      // s^T -> p^T; dv += p^T.dO (summed in dp); dp^T -> ds^T (p^T still in
      // s); dk += ds^T.q (summed in s)
      sm90::wg_fence();
      sm90::product_ss<NT>(s, sK + wg * NT * TB, sq);
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(s);
      probs(s);
      step_sum(dv, dp, s, so);
      sm90::wg_fence();
      sm90::product_ss<NT>(dp, sV + wg * NT * TB, so);
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(dp);
#pragma unroll
      for (int nt = 0; nt < FL_BQ / 8; ++nt) {
        const float2 dq = *reinterpret_cast<const float2*>(dl_s + nt * 8 + tig * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt * 4 + e] = s[nt * 4 + e] * (dp[nt * 4 + e] - ((e & 1) ? dq.y : dq.x));
      }
      step_sum(dk, s, dp, sq);
    }
    if (NSTG == 1 && j + 1 < nsteps) {
      __syncthreads();  // every warpgroup is done with the one stage
      stage(j + 1);
    }
  }

  T* dkb = p.dk.at(b, h);
  T* dvb = p.dv.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key[r] < p.Skv) {
        store2(dvb + (long long)key[r] * p.dv.ss + col, dv[nt * 4 + 2 * r], dv[nt * 4 + 2 * r + 1]);
        store2(dkb + (long long)key[r] * p.dk.ss + col, dk[nt * 4 + 2 * r] * p.scale,
               dk[nt * 4 + 2 * r + 1] * p.scale);
      }
  }
}

// #8's dynamic shared memory: Q and dO (two warpgroups' NT tiles each), then
// K and V of each stage, then the bias of each stage (as #7's)
template <int NT, int NSTG>
int dq_smem_bytes(int mode) { return 1024 + NT * (4 + 2 * NSTG) * TB + NSTG * key_bias_floats(mode) * 4; }

// bf16: <= 128 registers a thread, so two blocks share an SM where the shared
// memory allows it (see the note at the top of the file).
template <typename T, int NSTG>
__global__ void __launch_bounds__(FS_THREADS, blocks_fwd_dq<T>()) flash_bwd_dq_kernel(FlashBwdArgs<T> p, int mode) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t fs_smem[];
  uint8_t* sp;
  const uint32_t sbase = aligned_smem(fs_smem, &sp);
  const uint32_t sQ = sbase, sO = sbase + 2 * NT * TB;  // + wg * NT * TB
  float* bias_s = reinterpret_cast<float*>(sp + NT * (4 + 2 * NSTG) * TB);
  const int bias_stage = key_bias_floats(mode);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FS_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lrow = wg * 64 + warp * 16 + g;  // block-local row of d[..0|1]; lrow + 8 of d[..2|3]
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
  const int nsteps = (p.Skv + FL_BK - 1) / FL_BK;
  // step j's K, V and bias go to ring stage j % NSTG
  auto stage = [&](int j) {
    const int st = j % NSTG;
    stage_keys<NT>(p, b, h, q0, j * FL_BK, mode, sbase + NT * (4 + 2 * st) * TB, bias_s + st * bias_stage, tid);
  };

  const bf16* qb = p.q.at(b, h);
  const bf16* dob = p.dout.at(b, h);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    load_terms<NT>(sQ + t * NT * TB, qb, p.q.ss, p.q.tt, q0 + 64 * t, p.Sq, tid);
    load_terms<NT>(sO + t * NT * TB, dob, p.dout.ss, p.dout.tt, q0 + 64 * t, p.Sq, tid);
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
    const int st = j % NSTG, k0 = j * FL_BK;
    sm90::cp_async_wait_all();
    __syncthreads();  // step j has landed; every warpgroup is done with step j-1's stage
    if (NSTG > 1 && j + 1 < nsteps) stage(j + 1);
    const uint32_t sk = sbase + NT * (4 + 2 * st) * TB;

    // s = q.k^T and dp = dO.v^T for the warpgroup's 64 rows x 64 keys
    float s[32], dp[32];
    sm90::wg_fence();
    sm90::product_ss<NT>(s, sQ + wg * NT * TB, sk);
    sm90::product_ss<NT>(dp, sO + wg * NT * TB, sk + NT * TB);
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
          const float pr = exp_t<T>(x - lse_r[r]);
          ds = pr * (dp[nt * 4 + e] - dl_r[r]);
        }
        s[nt * 4 + e] = ds;
      }
    }

    // dq += ds.k at fp32 precision, k from its natural [key][d] tiles (fp32:
    // the step's products summed apart in dp's registers, free now: step_sum)
    if constexpr (NT == 1) {
      sm90::pin(dq);
      sm90::wg_fence();
      hilo_product(dq, s, sk);
      sm90::wg_commit();
      sm90::wg_wait_all();  // this stage is refilled after the next step's barrier
      sm90::pin(dq);
    } else {
      step_sum(dq, dp, s, sk);
    }
    if (NSTG == 1 && j + 1 < nsteps) {
      __syncthreads();  // every warpgroup is done with the one stage
      stage(j + 1);
    }
  }

  T* dqb = p.dq.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        store2(dqb + (long long)row[r] * p.dq.ss + col, dq[nt * 4 + 2 * r] * p.scale,
               dq[nt * 4 + 2 * r + 1] * p.scale);
  }
}

bool bad_sizes(int B, int H, int Sq, int Skv) {
  return B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535;
}

int bias_mode(const void* bias, long long bsq) {
  return bias == nullptr ? BIAS_NONE : bsq == 0 ? BIAS_ROW : BIAS_TILE;
}

// each instance's shared-memory limit, raised once per device
template <typename T, int NSTG>
int fwd_smem_done[64];
template <typename T, int NSTG>
int dq_smem_done[64];
template <typename T, int NSTG>
int dkv_smem_done[64];

// Elements of one operand's three term planes: q's (and dout's) over Sq,
// k's and v's over Skv.  The workspace holds q's, k's, v's, then dout's.
long long terms_q(int B, int H, int Sq) { return 3LL * B * H * Sq * FL_D; }

// The operands q, k, v (and dout) of a call in T: the bf16 views, or the
// fp32 views' term planes in `planes`, split here when `split` (the #7 and #8
// entries) or as the #8 entry left them (the #9 entry).
template <typename T>
int term_operands(const void* const* src, const long long* strides, int n, int B, int H, int Sq, int Skv,
                  bf16* planes, bool split, Heads<const bf16>* const* dst, cudaStream_t st) {
  const long long nq = terms_q(B, H, Sq), nkv = terms_q(B, H, Skv);
  const long long off[4] = {0, nq, nq + nkv, nq + 2 * nkv};
  const int len[4] = {Sq, Skv, Skv, Sq};
  for (int i = 0; i < n; ++i) {
    if (kTerms<T> == 3 && !split) {
      *dst[i] = term_planes(planes + off[i], B, H, len[i]);
      continue;
    }
    bf16* at = planes != nullptr ? planes + off[i] : nullptr;  // none in bf16
    const int e = heads_operand(heads<const T>(src[i], strides + 3 * i), B, H, len[i], at, dst[i], st);
    if (e) return e;
  }
  return 0;
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse, bf16* planes,
              const long long* strides, int B, int H, int Sq, int Skv, float scale, cudaStream_t st) {
  FlashArgs<T> a{};
  const void* src[3] = {q, k, v};
  Heads<const bf16>* const dst[3] = {&a.q, &a.k, &a.v};
  const int e = term_operands<T>(src, strides, 3, B, H, Sq, Skv, planes, true, dst, st);
  if (e) return e;
  a.o = heads<T>(o, strides + 9);
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
  const auto kernel = flash_fwd_kernel<T, FS_STAGES>;
  constexpr int NT = kTerms<T>;
  const cudaError_t err =
      sm90::allow_smem(kernel, fwd_smem_bytes<NT, FS_STAGES>(BIAS_TILE), fwd_smem_done<T, FS_STAGES>);
  if (err != cudaSuccess) return (int)err;
  const int mode = bias_mode(bias, a.bsq);
  dim3 grid((Sq + FS_ROWS - 1) / FS_ROWS, H, B);
  kernel<<<grid, FS_THREADS, fwd_smem_bytes<NT, FS_STAGES>(mode), st>>>(a, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_args(FlashBwdArgs<T>* a, const void* q, const void* k, const void* v, const void* dout,
             const void* bias, const void* lse, const void* delta, void* dq, void* dk, void* dv, bf16* planes,
             bool split, const long long* strides, int B, int H, int Sq, int Skv, float scale,
             cudaStream_t st) {
  const void* src[4] = {q, k, v, dout};
  Heads<const bf16>* const dst[4] = {&a->q, &a->k, &a->v, &a->dout};
  const int e = term_operands<T>(src, strides, 4, B, H, Sq, Skv, planes, split, dst, st);
  if (e) return e;
  a->dq = heads<T>(dq, strides + 12);
  a->dk = heads<T>(dk, strides + 15);
  a->dv = heads<T>(dv, strides + 18);
  a->bias = static_cast<const float*>(bias);
  a->bsb = strides[21];
  a->bsh = strides[22];
  a->bsq = strides[23];
  a->bsk = strides[24];
  a->lse = static_cast<const float*>(lse);
  a->delta = static_cast<const float*>(delta);
  a->H = H;
  a->Sq = Sq;
  a->Skv = Skv;
  a->scale = scale;
  return 0;
}

// The widest bias mode a backward instance takes, whose shared memory its
// limit is raised to: the fp32 two-stage instances do not take the tile
// (their tile would not fit; the one-stage instances take it).
template <typename T, int NSTG>
constexpr int widest_bias() { return kTerms<T> == 3 && NSTG > 1 ? BIAS_ROW : BIAS_TILE; }

template <typename T, int NSTG>
int launch_dkv(const FlashBwdArgs<T>& a, int mode, int B, cudaStream_t st) {
  constexpr int NT = kTerms<T>;
  const auto kernel = flash_bwd_dkv_kernel<T, NSTG>;
  const cudaError_t err =
      sm90::allow_smem(kernel, dkv_smem_bytes<NT, NSTG>(widest_bias<T, NSTG>()), dkv_smem_done<T, NSTG>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Skv + FS_ROWS - 1) / FS_ROWS, a.H, B);
  kernel<<<grid, FS_THREADS, dkv_smem_bytes<NT, NSTG>(mode), st>>>(a, mode);
  return (int)cudaGetLastError();
}

template <typename T, int NSTG>
int launch_dq(const FlashBwdArgs<T>& a, int mode, int B, cudaStream_t st) {
  constexpr int NT = kTerms<T>;
  const auto kernel = flash_bwd_dq_kernel<T, NSTG>;
  const cudaError_t err =
      sm90::allow_smem(kernel, dq_smem_bytes<NT, NSTG>(widest_bias<T, NSTG>()), dq_smem_done<T, NSTG>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + FS_ROWS - 1) / FS_ROWS, a.H, B);
  kernel<<<grid, FS_THREADS, dq_smem_bytes<NT, NSTG>(mode), st>>>(a, mode);
  return (int)cudaGetLastError();
}

// #9 (DKV, reading the terms #8's entry left) or #8 (splitting them): the
// fp32 bias-tile instances run one ring stage (see the note at the top)
template <typename T, bool DKV>
int flash_bwd(const void* q, const void* k, const void* v, const void* dout, const void* bias, const void* lse,
              const void* delta, void* dq, void* dk, void* dv, bf16* planes, const long long* strides, int B,
              int H, int Sq, int Skv, float scale, cudaStream_t st) {
  FlashBwdArgs<T> a{};
  const int e = bwd_args<T>(&a, q, k, v, dout, bias, lse, delta, dq, dk, dv, planes, !DKV, strides, B, H, Sq,
                            Skv, scale, st);
  if (e) return e;
  const int mode = bias_mode(bias, a.bsq);
  if constexpr (kTerms<T> == 3) {
    if (mode == BIAS_TILE) return DKV ? launch_dkv<T, 1>(a, mode, B, st) : launch_dq<T, 1>(a, mode, B, st);
  }
  return DKV ? launch_dkv<T, FS_STAGES>(a, mode, B, st) : launch_dq<T, FS_STAGES>(a, mode, B, st);
}

// ------------------------------------------------ other head dims (attn_any.cuh)
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) flash_any_fwd_kernel(anyd::AnyArgs<T> p) {
  anyd::any_fwd_body<T, true>(p);
}
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) flash_any_bwd_dkv_kernel(anyd::AnyArgs<T> p) {
  anyd::any_dkdv_body<T, true>(p);
}
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) flash_any_bwd_dq_kernel(anyd::AnyArgs<T> p) {
  anyd::any_dq_body<T, true>(p);
}
int any_fwd_done[2][64], any_dq_done[2][64], any_dkv_done[2][64];

// Elements of one operand's three term planes at head dim D (q's and dout's
// over Sq, k's and v's over Skv); the workspace holds q's, k's, v's, then dout's.
long long terms_any(int B, int H, int S, int D) { return 3LL * B * H * S * D; }

// The operands q, k, v (and dout) of a call at head dim D: the bf16 views
// (read in place), or the fp32 views' term planes in `planes`, split here
// when `split` (the forward and dq entries) or as the dq entry left them.
template <typename T>
int any_operands(anyd::AnyArgs<T>* a, const void* const* src, const long long* strides, int n, int B, int H,
                 int Sq, int Skv, int D, bf16* planes, bool split, cudaStream_t st) {
  const long long nq = terms_any(B, H, Sq, D), nkv = terms_any(B, H, Skv, D);
  const long long off[4] = {0, nq, nq + nkv, nq + 2 * nkv};
  const int len[4] = {Sq, Skv, Skv, Sq};
  Heads<const bf16>* dst[4] = {&a->q, &a->k, &a->v, &a->dout};
  int* vec[4] = {&a->vq, &a->vk, &a->vv, &a->vdo};
  for (int i = 0; i < n; ++i) {
    bf16* at = planes != nullptr ? planes + off[i] : nullptr;  // none in bf16
    if (kTerms<T> == 3 && !split) {
      const long long term = (long long)B * H * len[i] * D;
      *dst[i] = {at, (long long)H * len[i] * D, (long long)len[i] * D, D, term};
      *vec[i] = anyd::vec_ok(*dst[i], D);
      continue;
    }
    const int e = heads_operand_any(heads<const T>(src[i], strides + 3 * i), B, H, len[i], D, at, dst[i], vec[i], st);
    if (e) return e;
  }
  return 0;
}

template <typename T>
void any_common(anyd::AnyArgs<T>* a, const void* bias, const long long* bs, const void* lse, int H, int Sq,
                int Skv, int D, float scale) {
  a->bias = static_cast<const float*>(bias);
  a->bsb = bs[0];
  a->bsh = bs[1];
  a->bsq = bs[2];
  a->bsk = bs[3];
  a->lse = static_cast<float*>(const_cast<void*>(lse));
  a->H = H;
  a->Sq = Sq;
  a->Skv = Skv;
  a->D = D;
  a->ND = anyd::chunks(D);
  a->scale = scale;
}

template <typename T>
int flash_any_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse, bf16* planes,
                  const long long* strides, int B, int H, int Sq, int Skv, int D, float scale, cudaStream_t st) {
  if (anyd::bad_sizes(B, H, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  anyd::AnyArgs<T> a{};
  const void* src[3] = {q, k, v};
  if (const int e = any_operands<T>(&a, src, strides, 3, B, H, Sq, Skv, D, planes, true, st)) return e;
  a.o = heads<T>(o, strides + 9);
  any_common<T>(&a, bias, strides + 12, lse, H, Sq, Skv, D, scale);
  return anyd::launch_any_fwd(flash_any_fwd_kernel<T>, any_fwd_done[kTerms<T> == 1 ? 0 : 1], a, B, st);
}

template <typename T, bool DKV>
int flash_any_bwd(const void* q, const void* k, const void* v, const void* dout, const void* bias, const void* lse,
                  const void* delta, void* dq, void* dk, void* dv, bf16* planes, const long long* strides, int B,
                  int H, int Sq, int Skv, int D, float scale, cudaStream_t st) {
  if (anyd::bad_sizes(B, H, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  anyd::AnyArgs<T> a{};
  const void* src[4] = {q, k, v, dout};
  if (const int e = any_operands<T>(&a, src, strides, 4, B, H, Sq, Skv, D, planes, !DKV, st)) return e;
  a.dq = heads<T>(dq, strides + 12);
  a.dk = heads<T>(dk, strides + 15);
  a.dv = heads<T>(dv, strides + 18);
  any_common<T>(&a, bias, strides + 21, lse, H, Sq, Skv, D, scale);
  a.delta = static_cast<float*>(const_cast<void*>(delta));
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  if (DKV) return anyd::launch_any_bwd(flash_any_bwd_dkv_kernel<T>, any_dkv_done[ti], a, B, true, st);
  return anyd::launch_any_bwd(flash_any_bwd_dq_kernel<T>, any_dq_done[ti], a, B, false, st);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The largest head dim the entry points take (their argument D); a library
// without this symbol takes head dim 64 only, and no D.
int attention_max_head_dim() { return anyd::MAX_D; }

// Bytes of scratch the entries need: fp32 q, k, v (and dout for the
// backward) as three bf16 term planes each; none in bf16.  The backward's
// two entries share one workspace.
long long flash_attention_workspace(int B, int H, int Sq, int Skv, int D, int backward, int f32) {
  if (!f32) return 0;
  return 2 * ((backward ? 2 : 1) * terms_any(B, H, Sq, D) + 2 * terms_any(B, H, Skv, D));
}

// q [B, H, Sq, D], k and v [B, H, Skv, D] and o (output, [B, H, Sq, D]), all
// bf16 (f32 = 0) or fp32 (f32 = 1), by element strides (strides[0..11]: q, k,
// v, o as sb, sh, ss); bias fp32 or null with strides[12..15] = its b, h, q, k
// element strides (0 on broadcast dims); lse [B, H, Sq] fp32 (output);
// workspace of flash_attention_workspace bytes; head dim 1 <= D <= 256, unit
// stride over D.  At D = 64 every operand's start must be 16-byte aligned
// and its strides multiples of 8 elements (cp.async copies 16 bytes); any
// other D reads any strides.  Returns the CUDA error of the launches.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, void* workspace, const long long* strides, int B, int H, int Sq,
                        int Skv, int D, int f32, float scale, void* stream) {
  bf16* planes = static_cast<bf16*>(workspace);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != FL_D) {
    if (f32) return flash_any_fwd<float>(q, k, v, bias, o, lse, planes, strides, B, H, Sq, Skv, D, scale, st);
    return flash_any_fwd<bf16>(q, k, v, bias, o, lse, planes, strides, B, H, Sq, Skv, D, scale, st);
  }
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  if (!f32) return flash_fwd<bf16>(q, k, v, bias, o, lse, planes, strides, B, H, Sq, Skv, scale, st);
  return flash_fwd<float>(q, k, v, bias, o, lse, planes, strides, B, H, Sq, Skv, scale, st);
}

// The backward's operands by element strides: strides[0..20] are q, k, v, dout,
// dq, dk, dv as (sb, sh, ss), all [B, H, S, D] bf16 (f32 = 0) or fp32 (f32 =
// 1) (dq/dk/dv outputs); strides[21..24] the bias's b, h, q, k element strides
// (0 on broadcast dims; bias fp32 or null); lse and delta [B, H, Sq] fp32
// contiguous; workspace of flash_attention_workspace(backward = 1) bytes.  In
// fp32 the dq entry splits q, k, v and dout into the workspace and the dkv
// entry reads those terms: call dq first, with the same workspace and
// operands.  Each entry point launches its kernel and returns the CUDA error.
// (dkv's entry is defined first: #9's instances before #8's, as above.)
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* bias, const void* lse, const void* delta, void* dk, void* dv,
                            void* workspace, const long long* strides, int B, int H, int Sq, int Skv,
                            int D, int f32, float scale, void* stream) {
  bf16* planes = static_cast<bf16*>(workspace);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != FL_D) {
    if (f32)
      return flash_any_bwd<float, true>(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, planes, strides, B, H,
                                        Sq, Skv, D, scale, st);
    return flash_any_bwd<bf16, true>(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, planes, strides, B, H, Sq,
                                     Skv, D, scale, st);
  }
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  if (!f32)
    return flash_bwd<bf16, true>(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, planes, strides, B, H, Sq, Skv,
                                 scale, st);
  return flash_bwd<float, true>(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, planes, strides, B, H, Sq, Skv,
                                scale, st);
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* bias, const void* lse, const void* delta, void* dq,
                           void* workspace, const long long* strides, int B, int H, int Sq, int Skv,
                           int D, int f32, float scale, void* stream) {
  bf16* planes = static_cast<bf16*>(workspace);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != FL_D) {
    if (f32)
      return flash_any_bwd<float, false>(q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, planes, strides, B,
                                         H, Sq, Skv, D, scale, st);
    return flash_any_bwd<bf16, false>(q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, planes, strides, B, H,
                                      Sq, Skv, D, scale, st);
  }
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  if (!f32)
    return flash_bwd<bf16, false>(q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, planes, strides, B, H, Sq,
                                  Skv, scale, st);
  return flash_bwd<float, false>(q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, planes, strides, B, H, Sq,
                                 Skv, scale, st);
}

}  // extern "C"
