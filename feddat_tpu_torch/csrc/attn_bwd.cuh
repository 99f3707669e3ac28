// Attention-block backward with frozen projections, for Hopper (sm_90a).
//
// The attention half of two TPU kernels, written once:
//   feddat_tpu/ops/attn_block.py::_bwd_kernel       (kernel #3, lines 139-240)
//   feddat_tpu/ops/layer_block.py::_layer_bwd_kernel (kernel #4, lines 240-302)
// (kernel #6, feddat_tpu/ops/fused_attention.py::_bwd_kernel, is the per-head
// part alone; it runs on fused_attention.cu's wgmma kernels, not on these).
// Same function, same rounding points (attn_block.py:145-205):
//
//   xln   = bf16(LayerNorm1(x))           (optional, one row pass)
//   dctx  = bf16(g_att . Wo)              (g_att [M, Dm] bf16)
//   q/k/v = bf16(xln . W^T + b)           (recomputed, never stored by the forward)
//   per head: s = q k^T * scale + bias_row,  P = exp(s - lse)   (fp32, saved lse)
//             dv = bf16(bf16(P)^T . dctx)
//             dP = dctx . v^T,  delta = rowsum(dctx * ctx)       (fp32)
//             ds = bf16(P * (dP - delta))
//             dq = bf16((ds . k) * scale),  dk = bf16((ds^T . q) * scale)
//   dxln  = dq . Wq + dk . Wk + dv . Wv   (fp32; the caller finishes through LN1)
//
// What bounds it on the H100: at the training shape (B=64, S=185, Dm=768,
// H=12) the five projection-sized products (dctx, q/k/v, dx with K = 3 Dm) are
// ~97.8 GFLOP and the per-head products (s, dP recomputed twice, dv, dk, dq)
// ~33.6 GFLOP of bf16 tensor-core work: ~0.13 ms at 989 TFLOP/s, against
// ~0.03 ms of bytes.  Operations bound it.  The projection products run on
// wgmma through gemm_sm90.cuh (three launches); LN1, when fused, is one row
// pass that writes bf16(LN1(x)) once (common.cuh::ln_fwd_rows_kernel).
//
// What the design does about it.  The TPU kernel holds one batch element's
// q/k/v and all four weights in VMEM and walks the heads in order; a Hopper
// block has 227 KB, too little for one (batch, head)'s q, k, v, dO plus an fp32
// dK/dV accumulator over all queries.  So the per-head part is split in the
// FlashAttention-2 manner into two launches, each accumulating in fp32
// registers and casting once (the TPU's rounding points):
//   attn_bwd_dq_kernel:   one block per (64-query tile, head, batch element):
//                         delta for its rows (written for the next launch),
//                         then over key tiles S, P, dP, dS and dQ += dS.K;
//   attn_bwd_dkdv_kernel: one block per (64-key tile, head, batch element):
//                         over query tiles S^T, P^T, dP^T, dS^T, then
//                         dV += bf16(P)^T.dO and dK += dS^T.Q.
// P and dS never leave registers: the mma C fragment of one product is the A
// fragment of the next.  Padded query rows and keys are never summed, which is
// the TPU's exp(-1e9) = 0 and zero-padded cotangent.  Operands and outputs
// are Heads views (common.cuh): #3/#4 address their [3, M, Dm] scratch planes
// in place.
#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace port {

constexpr int AB_T = 64;         // rows per tile (queries or keys)
constexpr int AB_D = 64;         // head dim
constexpr int AB_THREADS = 128;  // 4 warps x 16 rows
constexpr int AB_LD = AB_D + 8;  // padded smem row (bf16)

struct AttnBwdArgs {
  Heads<const bf16> q, k, v;
  Heads<const bf16> dout;  // cotangent of the attention output (dctx)
  Heads<const bf16> ctx;   // the forward's attention output
  const float* lse;    // [B, H, S]
  const float* bias;   // [B, S] additive key bias, or null
  float* delta;        // [B, H, S] written by the dq launch, read by the dkdv launch
  Heads<bf16> dq, dk, dv;
  int S, H;
  float scale;
};

// stage rows [r0, r0+64) of one (batch, head)'s [S, 64] operand `src` (row
// stride ss): natural [row][d] and/or transposed [d][row]
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, long long ss, int r0, int S,
                                           bf16* nat, bf16* tr) {
  for (int i = threadIdx.x; i < AB_T * (AB_D / 8); i += AB_THREADS) {
    const int r = i / (AB_D / 8), c = (i % (AB_D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    if (nat != nullptr) *reinterpret_cast<uint4*>(nat + r * AB_LD + c) = v;
    if (tr != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t) tr[(c + t) * AB_LD + r] = e[t];
    }
  }
}

// A fragments of this warp's 16 rows of a [64][AB_LD] tile, for the 4 k-steps over d
__device__ __forceinline__ void a_frags(const bf16* tile, int wr, int g, int tig, uint32_t (*fr)[4]) {
#pragma unroll
  for (int ks = 0; ks < AB_D / 16; ++ks) {
    const bf16* p = tile + (wr + g) * AB_LD + ks * 16 + tig * 2;
    fr[ks][0] = lds32(p);
    fr[ks][1] = lds32(p + 8 * AB_LD);
    fr[ks][2] = lds32(p + 8);
    fr[ks][3] = lds32(p + 8 * AB_LD + 8);
  }
}

// c[nt] (16 rows x 64 cols) = A(16 x 64) . B^T where B is a [64][AB_LD] tile ([n][k])
__device__ __forceinline__ void rows_times_tile(uint32_t (*af)[4], const bf16* bt, int g, int tig,
                                                float (*c)[4]) {
#pragma unroll
  for (int nt = 0; nt < AB_T / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < AB_D / 16; ++ks) {
      const bf16* pb = bt + (nt * 8 + g) * AB_LD + ks * 16 + tig * 2;
      uint32_t b[2] = {lds32(pb), lds32(pb + 8)};
      mma_16816(c[nt], af[ks], b);
    }
  }
}

// acc[nt] (16 x 64) += X(16 x 64, fp32 C fragments, rounded to bf16 here) . B where
// B is given transposed as a [64 n][AB_LD] tile ([n][k])
__device__ __forceinline__ void frag_times_tile(float (*x)[4], const bf16* bt, int g, int tig,
                                                float (*acc)[4]) {
#pragma unroll
  for (int ks = 0; ks < AB_T / 16; ++ks) {
    uint32_t a[4] = {pack_bf16(x[2 * ks][0], x[2 * ks][1]), pack_bf16(x[2 * ks][2], x[2 * ks][3]),
                     pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                     pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
    for (int nt = 0; nt < AB_D / 8; ++nt) {
      const bf16* pb = bt + (nt * 8 + g) * AB_LD + ks * 16 + tig * 2;
      uint32_t b[2] = {lds32(pb), lds32(pb + 8)};
      mma_16816(acc[nt], a, b);
    }
  }
}

__global__ void __launch_bounds__(AB_THREADS) attn_bwd_dq_kernel(AttnBwdArgs p) {
  __shared__ __align__(16) bf16 Qs[AB_T * AB_LD];
  __shared__ __align__(16) bf16 Os[AB_T * AB_LD];   // dO tile
  __shared__ __align__(16) bf16 Ks[AB_T * AB_LD];   // [key][d]
  __shared__ __align__(16) bf16 Kt[AB_D * AB_LD];   // [d][key]
  __shared__ __align__(16) bf16 Vs[AB_T * AB_LD];   // [key][d]
  __shared__ float brow[AB_T];
  __shared__ float lse_s[AB_T];
  __shared__ float delta_s[AB_T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * AB_T, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * p.S;  // this batch element's bias row
  const int wr = warp * 16;
  const size_t lse0 = ((size_t)b * p.H + h) * p.S;
  const bf16* qb = p.q.at(b, h);
  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  const bf16* dob = p.dout.at(b, h);
  const bf16* ob = p.ctx.at(b, h);

  stage_tile(qb, p.q.ss, q0, p.S, Qs, nullptr);
  stage_tile(dob, p.dout.ss, q0, p.S, Os, nullptr);
  // delta = rowsum(dO * ctx) in fp32 for this warp's 16 rows
  for (int r = 0; r < 16; ++r) {
    const int q = q0 + wr + r;
    float s = 0.f;
    if (q < p.S) {
      const bf16* dr = dob + q * p.dout.ss;
      const bf16* cr = ob + q * p.ctx.ss;
      for (int d = lane; d < AB_D; d += 32) s += __bfloat162float(dr[d]) * __bfloat162float(cr[d]);
    }
    s = warp_sum(s);
    if (lane == 0) {
      delta_s[wr + r] = s;
      lse_s[wr + r] = q < p.S ? p.lse[lse0 + q] : 0.f;
      if (q < p.S) p.delta[lse0 + q] = s;
    }
  }
  __syncthreads();
  uint32_t qa[AB_D / 16][4], oa[AB_D / 16][4];
  a_frags(Qs, wr, g, tig, qa);
  a_frags(Os, wr, g, tig, oa);
  const int r_top = q0 + wr + g, r_bot = r_top + 8;
  const float lse_top = lse_s[wr + g], lse_bot = lse_s[wr + g + 8];
  const float dl_top = delta_s[wr + g], dl_bot = delta_s[wr + g + 8];

  float acc[AB_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < AB_D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kt = 0; kt < p.S; kt += AB_T) {
    __syncthreads();
    stage_tile(kb, p.k.ss, kt, p.S, Ks, Kt);
    stage_tile(vb, p.v.ss, kt, p.S, Vs, nullptr);
    for (int j = tid; j < AB_T; j += AB_THREADS)
      brow[j] = (kt + j < p.S && p.bias != nullptr) ? p.bias[row0 + kt + j] : 0.f;
    __syncthreads();
    float s[AB_T / 8][4], dp[AB_T / 8][4];
    rows_times_tile(qa, Ks, g, tig, s);
    rows_times_tile(oa, Vs, g, tig, dp);
#pragma unroll
    for (int nt = 0; nt < AB_T / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + tig * 2 + (e & 1);
        const bool top = e < 2;
        const bool ok = key < p.S && (top ? r_top : r_bot) < p.S;
        const float logit = __fadd_rn(__fmul_rn(s[nt][e], p.scale), brow[key - kt]);
        const float pr = ok ? expf(logit - (top ? lse_top : lse_bot)) : 0.f;
        s[nt][e] = ok ? pr * (dp[nt][e] - (top ? dl_top : dl_bot)) : 0.f;  // ds, rounded below
      }
    }
    frag_times_tile(s, Kt, g, tig, acc);
  }

  bf16* dqb = p.dq.at(b, h);
#pragma unroll
  for (int nt = 0; nt < AB_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (r_top < p.S)
      *reinterpret_cast<uint32_t*>(dqb + r_top * p.dq.ss + col) =
          pack_bf16(acc[nt][0] * p.scale, acc[nt][1] * p.scale);
    if (r_bot < p.S)
      *reinterpret_cast<uint32_t*>(dqb + r_bot * p.dq.ss + col) =
          pack_bf16(acc[nt][2] * p.scale, acc[nt][3] * p.scale);
  }
}

__global__ void __launch_bounds__(AB_THREADS) attn_bwd_dkdv_kernel(AttnBwdArgs p) {
  __shared__ __align__(16) bf16 Qs[AB_T * AB_LD];   // [q][d]   (K tile while staging)
  __shared__ __align__(16) bf16 Qt[AB_D * AB_LD];   // [d][q]   (V tile while staging)
  __shared__ __align__(16) bf16 Os[AB_T * AB_LD];   // dO [q][d]
  __shared__ __align__(16) bf16 Ot[AB_D * AB_LD];   // dO [d][q]
  __shared__ float brow[AB_T];
  __shared__ float lse_s[AB_T];
  __shared__ float delta_s[AB_T];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * AB_T, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * p.S;  // this batch element's bias row
  const int wr = warp * 16;
  const size_t lse0 = ((size_t)b * p.H + h) * p.S;
  const bf16* qb = p.q.at(b, h);
  const bf16* dob = p.dout.at(b, h);

  stage_tile(p.k.at(b, h), p.k.ss, k0, p.S, Qs, nullptr);
  stage_tile(p.v.at(b, h), p.v.ss, k0, p.S, Qt, nullptr);
  for (int j = tid; j < AB_T; j += AB_THREADS)
    brow[j] = (k0 + j < p.S && p.bias != nullptr) ? p.bias[row0 + k0 + j] : 0.f;
  __syncthreads();
  uint32_t ka[AB_D / 16][4], va[AB_D / 16][4];
  a_frags(Qs, wr, g, tig, ka);
  a_frags(Qt, wr, g, tig, va);
  const int key_top = k0 + wr + g, key_bot = key_top + 8;
  const float b_top = brow[wr + g], b_bot = brow[wr + g + 8];

  float dk[AB_D / 8][4], dv[AB_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < AB_D / 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  for (int qt = 0; qt < p.S; qt += AB_T) {
    __syncthreads();
    stage_tile(qb, p.q.ss, qt, p.S, Qs, Qt);
    stage_tile(dob, p.dout.ss, qt, p.S, Os, Ot);
    for (int j = tid; j < AB_T; j += AB_THREADS) {
      const bool ok = qt + j < p.S;
      lse_s[j] = ok ? p.lse[lse0 + qt + j] : 0.f;
      delta_s[j] = ok ? p.delta[lse0 + qt + j] : 0.f;
    }
    __syncthreads();
    float st[AB_T / 8][4], dpt[AB_T / 8][4];
    rows_times_tile(ka, Qs, g, tig, st);   // S^T: rows = keys, cols = queries
    rows_times_tile(va, Os, g, tig, dpt);  // dP^T
#pragma unroll
    for (int nt = 0; nt < AB_T / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + tig * 2 + (e & 1);
        const bool top = e < 2;
        const bool ok = qt + qi < p.S && (top ? key_top : key_bot) < p.S;
        const float logit = __fadd_rn(__fmul_rn(st[nt][e], p.scale), top ? b_top : b_bot);
        const float pr = ok ? expf(logit - lse_s[qi]) : 0.f;
        st[nt][e] = pr;                                          // P^T (rounded to bf16 for dV)
        dpt[nt][e] = ok ? pr * (dpt[nt][e] - delta_s[qi]) : 0.f;  // dS^T
      }
    }
    frag_times_tile(st, Ot, g, tig, dv);
    frag_times_tile(dpt, Qt, g, tig, dk);
  }

  bf16* dvb = p.dv.at(b, h);
  bf16* dkb = p.dk.at(b, h);
#pragma unroll
  for (int nt = 0; nt < AB_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (key_top < p.S) {
      *reinterpret_cast<uint32_t*>(dvb + key_top * p.dv.ss + col) = pack_bf16(dv[nt][0], dv[nt][1]);
      *reinterpret_cast<uint32_t*>(dkb + key_top * p.dk.ss + col) =
          pack_bf16(dk[nt][0] * p.scale, dk[nt][1] * p.scale);
    }
    if (key_bot < p.S) {
      *reinterpret_cast<uint32_t*>(dvb + key_bot * p.dv.ss + col) = pack_bf16(dv[nt][2], dv[nt][3]);
      *reinterpret_cast<uint32_t*>(dkb + key_bot * p.dk.ss + col) =
          pack_bf16(dk[nt][2] * p.scale, dk[nt][3] * p.scale);
    }
  }
}

// The two per-head launches on `st` (dq with delta, then dk/dv): the
// attention core of #3 and #4.  Returns the CUDA error.
inline int launch_attn_bwd(const AttnBwdArgs& t, int B, cudaStream_t st) {
  const dim3 grid((t.S + AB_T - 1) / AB_T, t.H, B);
  attn_bwd_dq_kernel<<<grid, AB_THREADS, 0, st>>>(t);
  int err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_dkdv_kernel<<<grid, AB_THREADS, 0, st>>>(t);
  return (int)cudaGetLastError();
}

// Everything of the attention backward up to dxln (fp32 [M, Dm]), on `st`.
// ws: qkv [3, M, Dm] bf16, dqkv [3, M, Dm] bf16, dctx [M, Dm] bf16, delta [B, H, S] f32
// and, with LN1 (gamma given), xln [M, Dm] bf16.
struct AttnBwdProblem {
  const bf16* x;                 // [M, Dm] pre-LN input (or the LN output when gamma is null)
  const bf16 *wq, *wk, *wv, *wo;  // [Dm, Dm] nn.Linear layout
  const float* bqkv;             // [3, Dm]
  const float* gamma;            // LN1 [Dm] or null
  const float* beta;
  float ln_eps;
  const float* bias;             // [B, S] or null
  const bf16* ctx;
  const float* lse;
  const bf16* g_att;             // [M, Dm] bf16 cotangent of the block's output
  bf16* qkv;
  bf16* dqkv;
  bf16* dctx;
  float* delta;
  bf16* xln;                     // bf16(LN1(x)) when gamma is given
  int B, S, Dm, H;
  float scale;
};

inline int attn_bwd_to_dxln(const AttnBwdProblem& a, int dx_epi_bf16, bf16* dx_bf16, float* dxln,
                            cudaStream_t st) {
  const int M = a.B * a.S;
  const size_t plane = (size_t)M * a.Dm;
  int err;

  GemmArgs c{};  // dctx = bf16(g_att . Wo)
  c.a[0] = a.g_att;
  c.lda = a.Dm;
  c.b[0] = a.wo;
  c.ldb = a.Dm;
  c.M = M;
  c.N = a.Dm;
  c.K = a.Dm;
  c.c_bf16[0] = a.dctx;
  if ((err = launch_gemm_sm90<B_NN, EPI_BF16>(c, st))) return err;

  // q/k/v = bf16(xln . W^T + b), xln = bf16(LN1(x)) when gamma is given
  if ((err = launch_qkv(a.x, a.gamma, a.beta, a.ln_eps, a.xln, a.wq, a.wk, a.wv, a.bqkv, a.qkv, M,
                        a.Dm, st)))
    return err;

  const long long sb = (long long)a.S * a.Dm;  // [M, Dm] planes, head h at column h*64
  AttnBwdArgs t{};
  t.q = {a.qkv, sb, AB_D, a.Dm};
  t.k = {a.qkv + plane, sb, AB_D, a.Dm};
  t.v = {a.qkv + 2 * plane, sb, AB_D, a.Dm};
  t.dout = {a.dctx, sb, AB_D, a.Dm};
  t.ctx = {a.ctx, sb, AB_D, a.Dm};
  t.lse = a.lse;
  t.bias = a.bias;
  t.delta = a.delta;
  t.dq = {a.dqkv, sb, AB_D, a.Dm};
  t.dk = {a.dqkv + plane, sb, AB_D, a.Dm};
  t.dv = {a.dqkv + 2 * plane, sb, AB_D, a.Dm};
  t.S = a.S;
  t.H = a.H;
  t.scale = a.scale;
  if ((err = launch_attn_bwd(t, a.B, st))) return err;

  GemmArgs d{};  // dxln = dq.Wq + dk.Wk + dv.Wv  (one product, K = 3 Dm)
  for (int i = 0; i < 3; ++i) d.a[i] = a.dqkv + i * plane;
  d.lda = a.Dm;
  d.a_kseg = a.Dm;
  d.b[0] = a.wq;
  d.b[1] = a.wk;
  d.b[2] = a.wv;
  d.ldb = a.Dm;
  d.b_seg = a.Dm;
  d.M = M;
  d.N = a.Dm;
  d.K = 3 * a.Dm;
  if (dx_epi_bf16) {
    d.c_bf16[0] = dx_bf16;
    return launch_gemm_sm90<B_NN, EPI_BF16>(d, st);
  }
  d.c_f32 = dxln;
  return launch_gemm_sm90<B_NN, EPI_F32>(d, st);
}

}  // namespace port
