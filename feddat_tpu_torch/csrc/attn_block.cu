// Fused pre-LN attention block, forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel feddat_tpu/ops/attn_block.py::_fwd_kernel
// (kernel #1, called through _fwd_call).  Same function, same rounding points:
//
//   xln   = LayerNorm(x)  (optional; fp32, fast variance max(E[x^2]-mu^2, 0))
//   q/k/v = bf16(xln . W + b)            (bf16 products, fp32 accumulation)
//   s     = q k^T * scale + bias_row     (fp32, per head, whole key row)
//   p     = exp(s - max), l = sum(p)     (fp32)
//   ctx   = bf16((bf16(p) . v) / l),  lse = max + log(l)
//   out   = bf16(ctx . Wo + bo)
//
// What bounds it on the H100: at the serving shape (B=16, S=281, Dm=768,
// H=12) one call does ~25.1 GFLOP of bf16 products and moves ~25 MB, so it is
// bound by tensor-core operations (~25.4 us at 989 TFLOP/s bf16), not by
// bytes (~7.7 us); the fp32 softmax and LayerNorm (~1.8 us on the CUDA
// cores) run beside the tensor cores and do not add to that floor.
//
// What the design does about it.  The TPU kernel keeps all four weight
// matrices (4.7 MB) and one batch element's activations resident in VMEM and
// walks the heads in order.  A Hopper block has 227 KB of shared memory, so
// the work is cut into launches on the caller's stream:
//   (a) with the LayerNorm fused, one row pass (common.cuh::ln_fwd_rows_kernel)
//       writes bf16(LN1(x)) once.  Its [M, Dm] plane is the `ctx` output:
//       nothing else writes ctx before the attention core, which runs after
//       the q|k|v product has read the plane (stream order), so the plane
//       takes no memory of its own;
//   (b) q|k|v in one wgmma GEMM (gemm_sm90.cuh, N = 3*Dm, one segment per
//       projection), bias-add and bf16 cast in the epilogue.  (a) and (b) are
//       gemm_sm90.cuh::launch_qkv, the very launches of the backward's q/k/v
//       recompute (#3, #4), so the backward's p = exp(s - lse) is rebuilt
//       from the forward's own logits;
//   (c) the attention core: attn_sm90.cuh's wgmma forward, the code of #5,
//       under this file's entry block_core_fwd_kernel: one warpgroup per
//       (64 queries, head, batch element) over Heads views of the projection
//       scratch (strides S*Dm, 64, Dm) and of the ctx plane; the keys swept
//       twice, so the softmax is the TPU's exact two-pass form (no online
//       rescaling) and no logits tile is kept: any S >= 1 runs;
//   (d) the out-projection on the same GEMM.
// q/k/v round-trip through device memory (3 x B*S*Dm bf16, from L2 mostly).

// Backward: replaces feddat_tpu/ops/attn_block.py::_bwd_kernel (kernel #3,
// called through _attn_block_bwd): dx only, the projections frozen.  The
// attention part is attn_bwd.cuh, shared with the whole-layer backward (#4):
// its products on wgmma (gemm_sm90.cuh), its per-head part on attn_sm90.cuh's
// backward kernels; with the LayerNorm fused, one row pass writes
// bf16(LN1(x)) for the q/k/v recompute and another
// (common.cuh::ln_bwd_rows_kernel) takes dxln back through LN1.  Its bound
// and design are in attn_bwd.cuh.

#include "attn_bwd.cuh"

using namespace port;

namespace {

__global__ void __launch_bounds__(attn::FA_THREADS, attn::FWD_MIN_BLOCKS)
    block_core_fwd_kernel(attn::FusedFwdArgs p) {
  attn::fused_fwd_body(p);
}

int core_fwd_smem_done[64];

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [B, S, Dm] bf16; wq/wk/wv/wo [Dm, Dm] bf16 (nn.Linear [out, in]);
// bqkv [3, Dm] f32; bo [Dm] f32; gb [2, Dm] f32 or null (no fused LN);
// bias [B, S] f32 or null; qkv scratch [3, B*S, Dm] bf16 (left holding q/k/v).
// Outputs: ctx [B, S, Dm] bf16 (also the LN1 plane's scratch before the
// attention core writes it), lse [B, H, S] f32, out [B, S, Dm] bf16.
// Returns the CUDA error of the launches (0 = success).
int attn_block_fwd(const void* x, const void* wq, const void* wk, const void* wv,
                   const void* wo, const void* bqkv, const void* bo, const void* gb,
                   const void* bias, void* qkv, void* ctx, void* lse, void* out,
                   int B, int S, int Dm, int H, float scale, float ln_eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t plane = (size_t)M * Dm;
  bf16* qkv_b = static_cast<bf16*>(qkv);
  const float* gamma = static_cast<const float*>(gb);
  int e = launch_qkv(static_cast<const bf16*>(x), gamma, gamma != nullptr ? gamma + Dm : nullptr, ln_eps,
                     static_cast<bf16*>(ctx), static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
                     static_cast<const bf16*>(wv), static_cast<const float*>(bqkv), qkv_b, M, Dm, st);
  if (e) return e;
  const long long sb = (long long)S * Dm;  // [3, B*S, Dm] planes, head h at column h*64
  const int hd = attn::FA_D;
  attn::FusedFwdArgs t{};
  t.q = {qkv_b, sb, hd, Dm};
  t.k = {qkv_b + plane, sb, hd, Dm};
  t.v = {qkv_b + 2 * plane, sb, hd, Dm};
  t.bias = static_cast<const float*>(bias);
  t.o = {static_cast<bf16*>(ctx), sb, hd, Dm};
  t.lse = static_cast<float*>(lse);
  t.S = S;
  t.H = H;
  t.scale = scale;
  if ((e = attn::launch_fwd(block_core_fwd_kernel, core_fwd_smem_done, t, B, st))) return e;

  GemmArgs o{};
  o.a[0] = static_cast<const bf16*>(ctx);
  o.lda = Dm;
  o.b[0] = static_cast<const bf16*>(wo);
  o.ldb = Dm;
  o.bias[0] = static_cast<const float*>(bo);
  o.c_bf16[0] = static_cast<bf16*>(out);
  o.M = M;
  o.N = Dm;
  o.K = Dm;
  return launch_gemm_sm90<B_NT, EPI_BIAS_BF16>(o, st);
}

// Bytes of scratch attn_block_bwd needs: qkv and dq|dk|dv [3, M, Dm] bf16 each,
// dctx [M, Dm] bf16, delta [B, H, S] f32 and, with the fused LN, dxln [M, Dm]
// f32 and xln = bf16(LN1(x)) [M, Dm] bf16.
long long attn_block_bwd_workspace(int B, int S, int Dm, int H, int has_ln) {
  const long long md = (long long)B * S * Dm;
  return 7 * md * 2 + (long long)B * H * S * 4 + (has_ln ? md * 4 + md * 2 + 256 : 0) + 5 * 256;
}

// x [B, S, Dm] bf16 (pre-LN when gb is given); weights and biases as the
// forward; gb [2, Dm] f32 or null; bias [B, S] f32 or null; ctx [B, S, Dm]
// bf16 and lse [B, H, S] f32 from the forward; g [B, S, Dm] bf16.
// Output dx [B, S, Dm] bf16.  Returns the CUDA error of the launches.
int attn_block_bwd(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
                   const void* bqkv, const void* gb, const void* bias, const void* ctx,
                   const void* lse, const void* g, void* workspace, void* dx, int B, int S, int Dm,
                   int H, float scale, float ln_eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t md = (size_t)B * S * Dm;
  char* w = static_cast<char*>(workspace);
  auto carve = [&](size_t bytes) {
    char* p = w;
    w += (bytes + 255) / 256 * 256;
    return p;
  };
  AttnBwdProblem a{};
  a.x = static_cast<const bf16*>(x);
  a.wq = static_cast<const bf16*>(wq);
  a.wk = static_cast<const bf16*>(wk);
  a.wv = static_cast<const bf16*>(wv);
  a.wo = static_cast<const bf16*>(wo);
  a.bqkv = static_cast<const float*>(bqkv);
  a.gamma = gb ? static_cast<const float*>(gb) : nullptr;
  a.beta = gb ? static_cast<const float*>(gb) + Dm : nullptr;
  a.ln_eps = ln_eps;
  a.bias = static_cast<const float*>(bias);
  a.ctx = static_cast<const bf16*>(ctx);
  a.lse = static_cast<const float*>(lse);
  a.g_att = static_cast<const bf16*>(g);
  a.qkv = reinterpret_cast<bf16*>(carve(3 * md * 2));
  a.dqkv = reinterpret_cast<bf16*>(carve(3 * md * 2));
  a.dctx = reinterpret_cast<bf16*>(carve(md * 2));
  a.delta = reinterpret_cast<float*>(carve((size_t)B * H * S * 4));
  a.B = B;
  a.S = S;
  a.Dm = Dm;
  a.H = H;
  a.scale = scale;
  if (gb == nullptr) return attn_bwd_to_dxln(a, 1, static_cast<bf16*>(dx), nullptr, st);
  float* dxln = reinterpret_cast<float*>(carve(md * 4));
  a.xln = reinterpret_cast<bf16*>(carve(md * 2));
  int err = attn_bwd_to_dxln(a, 0, nullptr, dxln, st);
  if (err) return err;
  return launch_ln_bwd_rows(a.x, a.gamma, ln_eps, dxln, nullptr, static_cast<bf16*>(dx), nullptr,
                            B * S, Dm, st);
}

}  // extern "C"
