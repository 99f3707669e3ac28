// Attention-block backward with frozen projections, for Hopper (sm_90a).
//
// The attention half of two TPU kernels, written once:
//   feddat_tpu/ops/attn_block.py::_bwd_kernel       (kernel #3, lines 139-240)
//   feddat_tpu/ops/layer_block.py::_layer_bwd_kernel (kernel #4, lines 240-302)
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
// ~0.03 ms of bytes.  Operations bound it.
//
// What the design does about it.  The TPU kernel holds one batch element's
// q/k/v and all four weights in VMEM and walks the heads in order.  On the
// card it is a short sequence of launches on the caller's stream:
//   * the projection products on wgmma through gemm_sm90.cuh: dctx, the q/k/v
//     recompute (launch_qkv, the very launches of #1's forward, so the
//     backward's p = exp(s - lse) is rebuilt from the forward's own logits;
//     LN1, when fused, is one row pass that writes bf16(LN1(x)) once) and dx
//     with K = 3 Dm;
//   * the per-head part on attn_sm90.cuh's wgmma kernels, the code of #6, under
//     this file's entries block_core_bwd_dq_kernel (writes delta to the
//     [B, H, S] scratch) and block_core_bwd_dkdv_kernel, over Heads views of
//     the [3, M, Dm] q/k/v and dq|dk|dv scratch planes and the dctx/ctx
//     planes in place.  Any S >= 1 runs.  At a head dim other than 64 the
//     per-head part is attn_any.cuh's under block_any_bwd_dq/dkdv_kernel.
// In fp32 (T = float) every product's activation operand is split into its
// bf16 terms first (common.cuh's split3, into AttnBwdScratch::planes) and the
// weights' terms come from the caller; nothing rounds, and the products are
// the six term products of gemm_sm90.cuh and attn_sm90.cuh.
// The entries live in the file-level anonymous namespace (the one the
// including .cu file uses too: nvcc's host stubs cannot tell kernels of two
// anonymous namespaces of one file apart), so #3's library (attn_block.cu)
// and #4's (layer_block.cu) each get their own, with their own records of
// the raised shared-memory limit.
#pragma once

#include "attn_any.cuh"
#include "attn_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

// dkdv before dq (attn_sm90.cuh)
template <typename T>
__global__ void __launch_bounds__(port::attn::FA_THREADS, port::attn::dkdv_min_blocks<T>())
    block_core_bwd_dkdv_kernel(port::attn::FusedBwdArgs<T> p) {
  port::attn::fused_bwd_dkdv_body(p);
}

template <typename T>
__global__ void __launch_bounds__(port::attn::FA_THREADS, port::attn::dq_min_blocks<T>())
    block_core_bwd_dq_kernel(port::attn::FusedBwdArgs<T> p) {
  port::attn::fused_bwd_dq_body(p);
}

// per element type (bf16, fp32)
int core_dq_smem_done[2][64], core_dkdv_smem_done[2][64];

// the per-head part at every other head dim (attn_any.cuh), after the
// head-dim-64 entries
template <typename T>
__global__ void __launch_bounds__(port::anyd::THREADS, 1) block_any_bwd_dkdv_kernel(port::anyd::AnyArgs<T> p) {
  port::anyd::any_dkdv_body<T, false>(p);
}
template <typename T>
__global__ void __launch_bounds__(port::anyd::THREADS, 1) block_any_bwd_dq_kernel(port::anyd::AnyArgs<T> p) {
  port::anyd::any_dq_body<T, false>(p);
}
int any_dq_smem_done[2][64], any_dkdv_smem_done[2][64];

}  // namespace

namespace port {

// Everything of the attention backward up to dxln (fp32 [M, Dm]), on `st`,
// in the element type T.
struct AttnBwdScratch {
  void* qkv;     // [3, M, Dm] T: the recomputed q/k/v
  void* dqkv;    // [3, M, Dm] T: dq|dk|dv
  void* dctx;    // [M, Dm] T
  float* delta;  // [B, H, S]
  void* xln;     // [M, Dm] T: LN1(x) when gamma is given
  bf16* planes;  // fp32: the bf16 terms of each product's activation operand (12 M Dm)
};

template <typename T>
struct AttnBwdProblem {
  const T* x;                          // [M, Dm] pre-LN input (or the LN output when gamma is null)
  const bf16 *wq, *wk, *wv, *wo;       // [Dm, Dm] nn.Linear layout: bf16, or fp32's planes w_term apart
  long long w_term;
  const float* bqkv;                   // [3, Dm]
  const float* gamma;                  // LN1 [Dm] or null
  const float* beta;
  float ln_eps;
  const float* bias;                   // [B, S] or null
  const T* ctx;
  const float* lse;
  const T* g_att;                      // [M, Dm] cotangent of the block's output
  AttnBwdScratch ws;
  int B, S, Dm, H;
  float scale;
};

// Bytes of the fp32 backward's operand planes: the q|k|v and dctx terms the
// per-head part reads at once, 12 M Dm bf16 (the dctx and dx products' A
// terms take fewer).
inline size_t attn_bwd_planes_bytes(size_t md) { return 12 * md * 2; }

template <typename T>
inline int attn_bwd_to_dxln(const AttnBwdProblem<T>& a, T* dx_t, float* dxln, cudaStream_t st) {
  const int M = a.B * a.S;
  const size_t plane = (size_t)M * a.Dm;
  T* const qkv = static_cast<T*>(a.ws.qkv);
  T* const dqkv = static_cast<T*>(a.ws.dqkv);
  T* const dctx = static_cast<T*>(a.ws.dctx);
  bf16* const planes = a.ws.planes;
  int err;

  GemmArgs c{};  // dctx = T(g_att . Wo)
  if ((err = operand_of(a.g_att, (long long)plane, planes, &c.a[0], &c.a_term, st))) return err;
  c.lda = a.Dm;
  c.b[0] = a.wo;
  c.b_term = a.w_term;
  c.ldb = a.Dm;
  c.M = M;
  c.N = a.Dm;
  c.K = a.Dm;
  c.c[0] = dctx;
  if ((err = launch_gemm_sm90<B_NN, EPI_OUT, T>(c, st))) return err;

  // q/k/v = T(xln . W^T + b), xln = T(LN1(x)) when gamma is given
  const bf16* w[3] = {a.wq, a.wk, a.wv};
  if ((err = launch_qkv<T>(a.x, a.gamma, a.beta, a.ln_eps, static_cast<T*>(a.ws.xln), planes, w, a.w_term,
                           a.bqkv, qkv, M, a.Dm, st)))
    return err;

  // the per-head part's operands: q/k/v and dctx themselves, or their terms
  // (q|k|v's planes 3 M Dm apart, then dctx's M Dm apart)
  const bf16 *qkv_op, *dctx_op;
  long long qkv_tt, dctx_tt;
  if ((err = operand_of(static_cast<const T*>(qkv), 3 * (long long)plane, planes, &qkv_op, &qkv_tt, st)))
    return err;
  if ((err = operand_of(static_cast<const T*>(dctx), (long long)plane, planes + 9 * plane, &dctx_op, &dctx_tt,
                        st)))
    return err;
  const long long sb = (long long)a.S * a.Dm;  // [M, Dm] planes, head h at column h*hd
  const int hd = a.Dm / a.H;
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  if (hd == attn::FA_D) {
    attn::FusedBwdArgs<T> t{};
    t.q = {qkv_op, sb, hd, a.Dm, qkv_tt};
    t.k = {qkv_op + plane, sb, hd, a.Dm, qkv_tt};
    t.v = {qkv_op + 2 * plane, sb, hd, a.Dm, qkv_tt};
    t.dout = {dctx_op, sb, hd, a.Dm, dctx_tt};
    t.ctx = {a.ctx, sb, hd, a.Dm, 0};
    t.lse = a.lse;
    t.bias = a.bias;
    t.delta = a.ws.delta;
    t.dq = {dqkv, sb, hd, a.Dm, 0};
    t.dk = {dqkv + plane, sb, hd, a.Dm, 0};
    t.dv = {dqkv + 2 * plane, sb, hd, a.Dm, 0};
    t.S = a.S;
    t.H = a.H;
    t.scale = a.scale;
    if ((err = attn::launch_bwd(block_core_bwd_dq_kernel<T>, core_dq_smem_done[ti], block_core_bwd_dkdv_kernel<T>,
                                core_dkdv_smem_done[ti], t, a.B, st)))
      return err;
  } else {
    anyd::AnyArgs<T> t{};
    t.q = {qkv_op, sb, hd, a.Dm, qkv_tt};
    t.k = {qkv_op + plane, sb, hd, a.Dm, qkv_tt};
    t.v = {qkv_op + 2 * plane, sb, hd, a.Dm, qkv_tt};
    t.dout = {dctx_op, sb, hd, a.Dm, dctx_tt};
    t.vq = anyd::vec_ok(t.q, hd);
    t.vk = anyd::vec_ok(t.k, hd);
    t.vv = anyd::vec_ok(t.v, hd);
    t.vdo = anyd::vec_ok(t.dout, hd);
    t.ctx = {a.ctx, sb, hd, a.Dm, 0};
    t.lse = const_cast<float*>(a.lse);
    t.bias = a.bias;
    t.bsb = a.S;  // [B, S]
    t.bsk = 1;
    t.delta = a.ws.delta;
    t.dq = {dqkv, sb, hd, a.Dm, 0};
    t.dk = {dqkv + plane, sb, hd, a.Dm, 0};
    t.dv = {dqkv + 2 * plane, sb, hd, a.Dm, 0};
    t.H = a.H;
    t.Sq = t.Skv = a.S;
    t.D = hd;
    t.ND = anyd::chunks(hd);
    t.scale = a.scale;
    if ((err = anyd::launch_any_bwd(block_any_bwd_dq_kernel<T>, any_dq_smem_done[ti], t, a.B, false, st)))
      return err;
    if ((err = anyd::launch_any_bwd(block_any_bwd_dkdv_kernel<T>, any_dkdv_smem_done[ti], t, a.B, true, st)))
      return err;
  }

  GemmArgs d{};  // dxln = dq.Wq + dk.Wk + dv.Wv  (one product, K = 3 Dm)
  const bf16* dop;
  if ((err = operand_of(static_cast<const T*>(dqkv), 3 * (long long)plane, planes, &dop, &d.a_term, st)))
    return err;
  for (int i = 0; i < 3; ++i) d.a[i] = dop + i * plane;
  d.lda = a.Dm;
  d.a_kseg = a.Dm;
  d.b[0] = a.wq;
  d.b[1] = a.wk;
  d.b[2] = a.wv;
  d.b_term = a.w_term;
  d.ldb = a.Dm;
  d.b_seg = a.Dm;
  d.M = M;
  d.N = a.Dm;
  d.K = 3 * a.Dm;
  if (dx_t != nullptr) {
    d.c[0] = dx_t;
    return launch_gemm_sm90<B_NN, EPI_OUT, T>(d, st);
  }
  d.c_f32 = dxln;
  return launch_gemm_sm90<B_NN, EPI_F32, T>(d, st);
}

}  // namespace port
