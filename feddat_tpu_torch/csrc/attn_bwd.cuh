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
//     planes in place.  Any S >= 1 runs.
// The entries live in the file-level anonymous namespace (the one the
// including .cu file uses too: nvcc's host stubs cannot tell kernels of two
// anonymous namespaces of one file apart), so #3's library (attn_block.cu)
// and #4's (layer_block.cu) each get their own, with their own records of
// the raised shared-memory limit.
#pragma once

#include "attn_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

// dkdv before dq (attn_sm90.cuh)
__global__ void __launch_bounds__(port::attn::FA_THREADS, port::attn::DKDV_MIN_BLOCKS)
    block_core_bwd_dkdv_kernel(port::attn::FusedBwdArgs p) {
  port::attn::fused_bwd_dkdv_body(p);
}

__global__ void __launch_bounds__(port::attn::FA_THREADS, port::attn::DQ_MIN_BLOCKS)
    block_core_bwd_dq_kernel(port::attn::FusedBwdArgs p) {
  port::attn::fused_bwd_dq_body(p);
}

int core_dq_smem_done[64], core_dkdv_smem_done[64];

}  // namespace

namespace port {

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
  const int hd = attn::FA_D;
  attn::FusedBwdArgs t{};
  t.q = {a.qkv, sb, hd, a.Dm};
  t.k = {a.qkv + plane, sb, hd, a.Dm};
  t.v = {a.qkv + 2 * plane, sb, hd, a.Dm};
  t.dout = {a.dctx, sb, hd, a.Dm};
  t.ctx = {a.ctx, sb, hd, a.Dm};
  t.lse = a.lse;
  t.bias = a.bias;
  t.delta = a.delta;
  t.dq = {a.dqkv, sb, hd, a.Dm};
  t.dk = {a.dqkv + plane, sb, hd, a.Dm};
  t.dv = {a.dqkv + 2 * plane, sb, hd, a.Dm};
  t.S = a.S;
  t.H = a.H;
  t.scale = a.scale;
  if ((err = attn::launch_bwd(block_core_bwd_dq_kernel, core_dq_smem_done, block_core_bwd_dkdv_kernel,
                              core_dkdv_smem_done, t, a.B, st)))
    return err;

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
