// Flash attention forward for Hopper (sm_90a): online softmax over key tiles.
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
// bf16(p) and lo = bf16(p - hi) and both multiply the bf16 v on mma.sync with
// fp32 accumulation (p - hi is exact, lo keeps 8 more bits: p is carried to
// ~2^-17 of itself, far below o's bf16 rounding).  Rounding p to bf16, as
// kernel #5 does, would move o by up to 2^-9 of each term.
//
// What bounds it on the H100.  At ALBEF's ViT site (B=16, H=12, S=577)
// q.k^T is 8.2 GFLOP of bf16 products (~8.3 us at 989 TFLOP/s) and P.v the
// same again twice over (hi and lo: ~16.6 us, the time TF32 would take); q, k,
// v, o and lse are ~57 MB (~17 us at 3.35 TB/s): operations bound it.  At the
// short text sites bytes do.
//
// Design: one block of 4 warps per (64-query tile, head, batch element),
// 16 query rows per warp; a loop over 64-key tiles staged in shared memory (K
// as [key][d], V transposed as [d][key]); q.k^T and P.v on mma.sync m16n8k16,
// the logits tile held in registers and handed to P.v as A fragments (no
// shared-memory round trip); the running max/sum per row kept by the 4
// threads of a quad.  wgmma, TMA and a ring of tiles are later work.
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
// split into bf16 hi + lo and both multiply the bf16 operand on mma.sync with
// fp32 accumulation (as #7 does for P.v).  Rounding ds to bf16, as #6 does,
// would move dq and dk by up to 2^-9 of each term.  Keys past Skv and queries
// past Sq contribute exactly 0 (JAX pads them with -1e30 and with zero rows of
// q, dO and delta); their rows are not written.  No atomics: each block owns
// its output tile, so a second call is bitwise equal.
//
// What bounds them on the H100.  At ALBEF's ViT site (B=16, H=12, S=577) one
// [S, S] x 64 product is 8.2 GFLOP.  #8 does s and dp on bf16 operands (~16.6
// us at 989 TFLOP/s) and ds.k at fp32 precision (hi + lo, the work of one TF32
// product: ~16.6 us at 495 TFLOP/s); #9 does s^T and dp^T in bf16 and p^T.dO
// and ds^T.q at fp32 precision (~50 us).  Each moves ~70 MB (~21 us at 3.35
// TB/s): operations bound both.
//
// Design, in the FlashAttention-2 manner of attn_bwd.cuh (whose tile staging
// and fragment helpers it reuses): #8 is one block of 4 warps per (64-query
// tile, head, batch element) streaming 64-key tiles (K natural and transposed,
// V natural); #9 one block per (64-key tile, head, batch element) streaming
// 64-query tiles (Q and dO natural and transposed).  The logits are rebuilt in
// registers and handed from C fragments to A fragments with no shared-memory
// round trip.  The bias is read by element strides as in the forward.

#include "attn_bwd.cuh"

using namespace port;

namespace {

constexpr int FL_BQ = 64;       // query rows per block (16 per warp)
constexpr int FL_BK = 64;       // keys per staged tile
constexpr int FL_D = 64;        // head dim
constexpr int FL_THREADS = 128;
constexpr int FL_LD = FL_D + 8;  // padded smem row (bf16)
constexpr float FL_NEG_INF = -1e30f;

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

__global__ void __launch_bounds__(FL_THREADS) flash_fwd_kernel(FlashArgs p) {
  __shared__ __align__(16) bf16 Qs[FL_BQ * FL_LD];
  __shared__ __align__(16) bf16 Ks[FL_BK * FL_LD];  // [key][d]
  __shared__ __align__(16) bf16 Vt[FL_D * FL_LD];   // [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FL_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = p.q.at(b, h);
  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  const int qr = warp * 16;
  const int row[2] = {q0 + qr + g, q0 + qr + g + 8};  // this thread's two query rows

  // bias rows of this thread's queries (clamped: rows past Sq are never written)
  const float* brow[2] = {nullptr, nullptr};
  if (p.bias != nullptr) {
    const float* base = p.bias + b * p.bsb + h * p.bsh;
#pragma unroll
    for (int i = 0; i < 2; ++i) brow[i] = base + (long long)min(row[i], p.Sq - 1) * p.bsq;
  }

  for (int i = tid; i < FL_BQ * (FL_D / 8); i += FL_THREADS) {
    const int r = i / (FL_D / 8), c = (i % (FL_D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq) v = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * p.q.ss + c);
    *reinterpret_cast<uint4*>(Qs + r * FL_LD + c) = v;
  }
  __syncthreads();
  uint32_t qa[FL_D / 16][4];
#pragma unroll
  for (int ks = 0; ks < FL_D / 16; ++ks) {
    const bf16* pq = Qs + (qr + g) * FL_LD + ks * 16 + tig * 2;
    qa[ks][0] = lds32(pq);
    qa[ks][1] = lds32(pq + 8 * FL_LD);
    qa[ks][2] = lds32(pq + 8);
    qa[ks][3] = lds32(pq + 8 * FL_LD + 8);
  }

  float m[2] = {FL_NEG_INF, FL_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums (its 2 columns of each n-tile)
  float acc[FL_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[nt][t] = 0.f;

  for (int kt = 0; kt < p.Skv; kt += FL_BK) {
    __syncthreads();  // the previous tile's K and V reads are done
    for (int i = tid; i < FL_BK * (FL_D / 8); i += FL_THREADS) {
      const int r = i / (FL_D / 8), c = (i % (FL_D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < p.Skv) v = *reinterpret_cast<const uint4*>(kb + (long long)(kt + r) * p.k.ss + c);
      *reinterpret_cast<uint4*>(Ks + r * FL_LD + c) = v;
    }
    for (int i = tid; i < FL_BK * (FL_D / 8); i += FL_THREADS) {
      const int r = i % FL_BK, c = (i / FL_BK) * 8;  // r: key, c: first dim
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < p.Skv) v = *reinterpret_cast<const uint4*>(vb + (long long)(kt + r) * p.v.ss + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t) Vt[(c + t) * FL_LD + r] = e[t];
    }
    __syncthreads();

    // s = q.k^T for the warp's 16 rows x 64 keys (C fragments: [0..1] row g, [2..3] row g+8)
    float s[FL_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) s[nt][t] = 0.f;
#pragma unroll
      for (int ks = 0; ks < FL_D / 16; ++ks) {
        const bf16* pk = Ks + (nt * 8 + g) * FL_LD + ks * 16 + tig * 2;
        uint32_t kf[2] = {lds32(pk), lds32(pk + 8)};
        mma_16816(s[nt], qa[ks], kf);
      }
    }

    // scale, bias; keys past Skv drop out (-inf: exp gives 0 and the max ignores them)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int key = kt + nt * 8 + tig * 2 + (t & 1), r = t >> 1;
        float x = -INFINITY;
        if (key < p.Skv) {
          const float bv = brow[r] != nullptr ? brow[r][key * p.bsk] : 0.f;
          x = __fadd_rn(__fmul_rn(s[nt][t], p.scale), bv);
        }
        s[nt][t] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float e = expf(s[nt][t] - m[t >> 1]);
        s[nt][t] = e;
        l[t >> 1] += e;
      }
    }
#pragma unroll
    for (int nt = 0; nt < FL_D / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // acc += p.v, p = hi + lo in bf16: the C fragments of key tiles 2ks and
    // 2ks+1 are the A fragment of the 16-key step ks
#pragma unroll
    for (int ks = 0; ks < FL_BK / 16; ++ks) {
      const float x[8] = {s[2 * ks][0], s[2 * ks][1], s[2 * ks][2], s[2 * ks][3],
                          s[2 * ks + 1][0], s[2 * ks + 1][1], s[2 * ks + 1][2], s[2 * ks + 1][3]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
        lo[i] = pack_bf16(x[2 * i] - round_bf16(x[2 * i]), x[2 * i + 1] - round_bf16(x[2 * i + 1]));
      }
#pragma unroll
      for (int nt = 0; nt < FL_D / 8; ++nt) {
        const bf16* pv = Vt + (nt * 8 + g) * FL_LD + ks * 16 + tig * 2;
        uint32_t vf[2] = {lds32(pv), lds32(pv + 8)};
        mma_16816(acc[nt], hi, vf);
        mma_16816(acc[nt], lo, vf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  bf16* ob = p.o.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row[r] * p.o.ss + col) =
            pack_bf16(acc[nt][2 * r] / l[r], acc[nt][2 * r + 1] / l[r]);
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

// acc[nt] (16 x 64) += X(16 x 64 fp32 C fragments) . B, X carried at fp32
// precision as bf16 hi + lo (two mma.sync per step); B given transposed as a
// [64 n][FL_LD] tile ([n][k]), as in attn_bwd.cuh::frag_times_tile
__device__ __forceinline__ void frag_hilo_times_tile(float (*x)[4], const bf16* bt, int g, int tig,
                                                     float (*acc)[4]) {
#pragma unroll
  for (int ks = 0; ks < FL_BK / 16; ++ks) {
    const float e[8] = {x[2 * ks][0], x[2 * ks][1], x[2 * ks][2], x[2 * ks][3],
                        x[2 * ks + 1][0], x[2 * ks + 1][1], x[2 * ks + 1][2], x[2 * ks + 1][3]};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = pack_bf16(e[2 * i], e[2 * i + 1]);
      lo[i] = pack_bf16(e[2 * i] - round_bf16(e[2 * i]), e[2 * i + 1] - round_bf16(e[2 * i + 1]));
    }
#pragma unroll
    for (int nt = 0; nt < FL_D / 8; ++nt) {
      const bf16* pb = bt + (nt * 8 + g) * FL_LD + ks * 16 + tig * 2;
      uint32_t b[2] = {lds32(pb), lds32(pb + 8)};
      mma_16816(acc[nt], hi, b);
      mma_16816(acc[nt], lo, b);
    }
  }
}

__global__ void __launch_bounds__(FL_THREADS) flash_bwd_dq_kernel(FlashBwdArgs p) {
  __shared__ __align__(16) bf16 Qs[FL_BQ * FL_LD];
  __shared__ __align__(16) bf16 Os[FL_BQ * FL_LD];  // dO tile
  __shared__ __align__(16) bf16 Ks[FL_BK * FL_LD];  // [key][d]
  __shared__ __align__(16) bf16 Kt[FL_D * FL_LD];   // [d][key]
  __shared__ __align__(16) bf16 Vs[FL_BK * FL_LD];  // [key][d]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FL_BQ, h = blockIdx.y, b = blockIdx.z;
  const int wr = warp * 16;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};  // this thread's two query rows
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;

  // lse, delta and bias row of this thread's queries (clamped: rows past Sq drop out)
  float lse_r[2], dl_r[2];
  const float* brow[2] = {nullptr, nullptr};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = min(row[r], p.Sq - 1);
    lse_r[r] = p.lse[lse0 + q];
    dl_r[r] = p.delta[lse0 + q];
    if (p.bias != nullptr) brow[r] = p.bias + b * p.bsb + h * p.bsh + (long long)q * p.bsq;
  }

  stage_tile(p.q.at(b, h), p.q.ss, q0, p.Sq, Qs, nullptr);
  stage_tile(p.dout.at(b, h), p.dout.ss, q0, p.Sq, Os, nullptr);
  __syncthreads();
  uint32_t qa[FL_D / 16][4], oa[FL_D / 16][4];
  a_frags(Qs, wr, g, tig, qa);
  a_frags(Os, wr, g, tig, oa);

  float acc[FL_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  for (int kt = 0; kt < p.Skv; kt += FL_BK) {
    __syncthreads();  // the previous tile's reads are done
    stage_tile(kb, p.k.ss, kt, p.Skv, Ks, Kt);
    stage_tile(vb, p.v.ss, kt, p.Skv, Vs, nullptr);
    __syncthreads();
    float s[FL_BK / 8][4], dp[FL_BK / 8][4];
    rows_times_tile(qa, Ks, g, tig, s);
    rows_times_tile(oa, Vs, g, tig, dp);
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + tig * 2 + (e & 1), r = e >> 1;
        float ds = 0.f;
        if (key < p.Skv && row[r] < p.Sq) {
          const float bv = brow[r] != nullptr ? brow[r][key * p.bsk] : 0.f;
          const float pr = expf(__fadd_rn(__fmul_rn(s[nt][e], p.scale), bv) - lse_r[r]);
          ds = pr * (dp[nt][e] - dl_r[r]);
        }
        s[nt][e] = ds;
      }
    }
    frag_hilo_times_tile(s, Kt, g, tig, acc);
  }

  bf16* dqb = p.dq.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        *reinterpret_cast<uint32_t*>(dqb + (long long)row[r] * p.dq.ss + col) =
            pack_bf16(acc[nt][2 * r] * p.scale, acc[nt][2 * r + 1] * p.scale);
  }
}

__global__ void __launch_bounds__(FL_THREADS) flash_bwd_dkv_kernel(FlashBwdArgs p) {
  __shared__ __align__(16) bf16 Qs[FL_BQ * FL_LD];  // [q][d]   (K tile while staging)
  __shared__ __align__(16) bf16 Qt[FL_D * FL_LD];   // [d][q]   (V tile while staging)
  __shared__ __align__(16) bf16 Os[FL_BQ * FL_LD];  // dO [q][d]
  __shared__ __align__(16) bf16 Ot[FL_D * FL_LD];   // dO [d][q]
  __shared__ float lse_s[FL_BQ];
  __shared__ float dl_s[FL_BQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * FL_BK, h = blockIdx.y, b = blockIdx.z;
  const int wr = warp * 16;
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};  // this thread's two keys
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;

  // bias columns of this thread's keys (clamped: keys past Skv drop out)
  const float* bcol[2] = {nullptr, nullptr};
  if (p.bias != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bcol[r] = p.bias + b * p.bsb + h * p.bsh + (long long)min(key[r], p.Skv - 1) * p.bsk;
  }

  stage_tile(p.k.at(b, h), p.k.ss, k0, p.Skv, Qs, nullptr);
  stage_tile(p.v.at(b, h), p.v.ss, k0, p.Skv, Qt, nullptr);
  __syncthreads();
  uint32_t ka[FL_D / 16][4], va[FL_D / 16][4];
  a_frags(Qs, wr, g, tig, ka);
  a_frags(Qt, wr, g, tig, va);

  float dk[FL_D / 8][4], dv[FL_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  const bf16* qb = p.q.at(b, h);
  const bf16* dob = p.dout.at(b, h);
  for (int qt = 0; qt < p.Sq; qt += FL_BQ) {
    __syncthreads();  // the previous tile's reads (and the K/V fragments) are done
    stage_tile(qb, p.q.ss, qt, p.Sq, Qs, Qt);
    stage_tile(dob, p.dout.ss, qt, p.Sq, Os, Ot);
    for (int j = tid; j < FL_BQ; j += FL_THREADS) {
      const bool ok = qt + j < p.Sq;
      lse_s[j] = ok ? p.lse[lse0 + qt + j] : 0.f;
      dl_s[j] = ok ? p.delta[lse0 + qt + j] : 0.f;
    }
    __syncthreads();
    float st[FL_BQ / 8][4], dpt[FL_BQ / 8][4];
    rows_times_tile(ka, Qs, g, tig, st);   // s^T: rows = keys, cols = queries
    rows_times_tile(va, Os, g, tig, dpt);  // dp^T
#pragma unroll
    for (int nt = 0; nt < FL_BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + tig * 2 + (e & 1), r = e >> 1;
        float pr = 0.f, ds = 0.f;
        if (qt + qi < p.Sq && key[r] < p.Skv) {
          const float bv = bcol[r] != nullptr ? bcol[r][(long long)(qt + qi) * p.bsq] : 0.f;
          pr = expf(__fadd_rn(__fmul_rn(st[nt][e], p.scale), bv) - lse_s[qi]);
          ds = pr * (dpt[nt][e] - dl_s[qi]);
        }
        st[nt][e] = pr;
        dpt[nt][e] = ds;
      }
    }
    frag_hilo_times_tile(st, Ot, g, tig, dv);
    frag_hilo_times_tile(dpt, Qt, g, tig, dk);
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
            pack_bf16(dv[nt][2 * r], dv[nt][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dkb + (long long)key[r] * p.dk.ss + col) =
            pack_bf16(dk[nt][2 * r] * p.scale, dk[nt][2 * r + 1] * p.scale);
      }
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

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q [B, H, Sq, 64], k and v [B, H, Skv, 64] bf16 and o (output, [B, H, Sq, 64])
// by element strides (strides[0..11]: q, k, v, o as sb, sh, ss); bias fp32 or
// null with strides[12..15] = its b, h, q, k element strides (0 on broadcast
// dims); lse [B, H, Sq] fp32 (output).  Returns the CUDA error of the launch.
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
  dim3 grid((Sq + FL_BQ - 1) / FL_BQ, H, B);
  flash_fwd_kernel<<<grid, FL_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
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
  dim3 grid((Sq + FL_BQ - 1) / FL_BQ, H, B);
  flash_bwd_dq_kernel<<<grid, FL_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* bias, const void* lse, const void* delta, void* dk, void* dv,
                            const long long* strides, int B, int H, int Sq, int Skv, float scale,
                            void* stream) {
  if (bad_sizes(B, H, Sq, Skv)) return (int)cudaErrorInvalidValue;
  const FlashBwdArgs a = bwd_args(q, k, v, dout, bias, lse, delta, nullptr, dk, dv, strides, H, Sq,
                                  Skv, scale);
  dim3 grid((Skv + FL_BK - 1) / FL_BK, H, B);
  flash_bwd_dkv_kernel<<<grid, FL_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
