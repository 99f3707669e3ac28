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
// At a head dim other than 64 (any Dm that divides into 1 to 256 per head)
// step (c) is attn_any.cuh's core under block_any_fwd_kernel, reading the
// heads of the projection planes in place at any column.
// q/k/v round-trip through device memory (3 x B*S*Dm bf16, from L2 mostly).

// Backward: replaces feddat_tpu/ops/attn_block.py::_bwd_kernel (kernel #3,
// called through _attn_block_bwd): dx only, the projections frozen.  The
// attention part is attn_bwd.cuh, shared with the whole-layer backward (#4):
// its products on wgmma (gemm_sm90.cuh), its per-head part on attn_sm90.cuh's
// backward kernels; with the LayerNorm fused, one row pass writes
// bf16(LN1(x)) for the q/k/v recompute and another
// (common.cuh::ln_bwd_rows_kernel) takes dxln back through LN1.  Its bound
// and design are in attn_bwd.cuh.
//
// Both ways take bf16 or fp32 activations and weights (the model's dtype, as
// the TPU kernels do), with the same fp32 biases and LayerNorm rows.  In fp32
// nothing rounds, and each product is the six bf16 term products of its
// operands' splits (common.cuh): the C entry points split the four weights
// into the workspace, and each activation operand is split before its
// product.  fp32 moves twice the bytes and does 6x the tensor-core work of
// bf16 (one block per SM in the attention cores).

#include "attn_bwd.cuh"

using namespace port;

namespace {

template <typename T>
__global__ void __launch_bounds__(attn::FA_THREADS, attn::fwd_min_blocks<T>())
    block_core_fwd_kernel(attn::FusedFwdArgs<T> p) {
  attn::fused_fwd_body(p);
}

int core_fwd_smem_done[2][64];  // per element type (bf16, fp32)

// the core at every other head dim (attn_any.cuh), after the head-dim-64 entry
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) block_any_fwd_kernel(anyd::AnyArgs<T> p) {
  anyd::any_fwd_body<T, false>(p);
}
int any_fwd_smem_done[2][64];

// A workspace's buffers in order, each on a 256-byte boundary (0-byte ones
// take no room): their offsets and the total.
template <int N>
struct Carve {
  size_t off[N];
  size_t total;
  explicit Carve(const size_t (&bytes)[N]) {
    total = 0;
    for (int i = 0; i < N; ++i) {
      off[i] = total;
      total += (bytes[i] + 255) / 256 * 256;
    }
  }
};

// The forward's workspace: qkv [3, M, Dm] T (first, so that it holds q/k/v
// after the call), then in fp32 the four weights' terms and the activation
// operands' terms (x's, q|k|v's and ctx's in turn: 9 M Dm bf16 at most).
enum { FW_QKV, FW_WTERMS, FW_PLANES, FW_COUNT };
Carve<FW_COUNT> fwd_ws(int B, int S, int Dm, bool f32) {
  const size_t md = (size_t)B * S * Dm, es = f32 ? 4 : 2;
  const size_t bytes[FW_COUNT] = {3 * md * es, f32 ? 12 * (size_t)Dm * Dm * 2 : 0, f32 ? 9 * md * 2 : 0};
  return Carve<FW_COUNT>(bytes);
}

// The backward's workspace: qkv and dq|dk|dv [3, M, Dm] T each, dctx [M, Dm]
// T, delta [B, H, S] f32, with the fused LN dxln [M, Dm] f32 and xln [M, Dm]
// T, and in fp32 the weights' terms and the activation operands' terms.
enum { BW_QKV, BW_DQKV, BW_DCTX, BW_DELTA, BW_DXLN, BW_XLN, BW_WTERMS, BW_PLANES, BW_COUNT };
Carve<BW_COUNT> bwd_ws(int B, int S, int Dm, int H, bool has_ln, bool f32) {
  const size_t md = (size_t)B * S * Dm, es = f32 ? 4 : 2;
  const size_t bytes[BW_COUNT] = {3 * md * es, 3 * md * es, md * es, (size_t)B * H * S * 4,
                                  has_ln ? md * 4 : 0, has_ln ? md * es : 0,
                                  f32 ? 12 * (size_t)Dm * Dm * 2 : 0, f32 ? attn_bwd_planes_bytes(md) : 0};
  return Carve<BW_COUNT>(bytes);
}

// The four projections' operands (q, k, v, o): the bf16 weights, or the terms
// of the fp32 ones written into `wterms` (4 Dm^2 apart); sets *w_term.
template <typename T>
int projection_operands(const void* const* w, int Dm, bf16* wterms, const bf16** ops, long long* w_term,
                        cudaStream_t st) {
  const T* wt[4];
  for (int i = 0; i < 4; ++i) wt[i] = static_cast<const T*>(w[i]);
  const long long dd = (long long)Dm * Dm;
  *w_term = kTerms<T> == 3 ? 4 * dd : 0;
  return weight_operands<T>(wt, 4, dd, wterms, 4 * dd, ops, st);
}

template <typename T>
int block_fwd(const T* x, const void* const* w, const float* bqkv, const float* bo, const float* gamma,
              float ln_eps, const float* bias, char* ws, T* ctx, float* lse, T* out, int B, int S, int Dm,
              int H, float scale, cudaStream_t st) {
  const int M = B * S;
  const size_t plane = (size_t)M * Dm;
  const Carve<FW_COUNT> L = fwd_ws(B, S, Dm, kTerms<T> == 3);
  T* qkv = reinterpret_cast<T*>(ws + L.off[FW_QKV]);
  bf16* planes = reinterpret_cast<bf16*>(ws + L.off[FW_PLANES]);
  const bf16* wop[4];
  long long w_term;
  int e = projection_operands<T>(w, Dm, reinterpret_cast<bf16*>(ws + L.off[FW_WTERMS]), wop, &w_term, st);
  if (e) return e;
  e = launch_qkv<T>(x, gamma, gamma != nullptr ? gamma + Dm : nullptr, ln_eps, ctx, planes, wop, w_term, bqkv,
                    qkv, M, Dm, st);
  if (e) return e;
  const bf16* qop;
  long long qtt;
  if ((e = operand_of(static_cast<const T*>(qkv), 3 * (long long)plane, planes, &qop, &qtt, st))) return e;
  const long long sb = (long long)S * Dm;  // [3, B*S, Dm] planes, head h at column h*hd
  const int hd = Dm / H;
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  if (hd == attn::FA_D) {
    attn::FusedFwdArgs<T> t{};
    t.q = {qop, sb, hd, Dm, qtt};
    t.k = {qop + plane, sb, hd, Dm, qtt};
    t.v = {qop + 2 * plane, sb, hd, Dm, qtt};
    t.bias = bias;
    t.o = {ctx, sb, hd, Dm, 0};
    t.lse = lse;
    t.S = S;
    t.H = H;
    t.scale = scale;
    if ((e = attn::launch_fwd(block_core_fwd_kernel<T>, core_fwd_smem_done[ti], t, B, st))) return e;
  } else {
    anyd::AnyArgs<T> t{};
    t.q = {qop, sb, hd, Dm, qtt};
    t.k = {qop + plane, sb, hd, Dm, qtt};
    t.v = {qop + 2 * plane, sb, hd, Dm, qtt};
    t.vq = anyd::vec_ok(t.q, hd);
    t.vk = anyd::vec_ok(t.k, hd);
    t.vv = anyd::vec_ok(t.v, hd);
    t.bias = bias;
    t.bsb = S;  // [B, S]
    t.bsk = 1;
    t.o = {ctx, sb, hd, Dm, 0};
    t.lse = lse;
    t.H = H;
    t.Sq = t.Skv = S;
    t.D = hd;
    t.ND = anyd::chunks(hd);
    t.scale = scale;
    if ((e = anyd::launch_any_fwd(block_any_fwd_kernel<T>, any_fwd_smem_done[ti], t, B, st))) return e;
  }

  GemmArgs o{};
  if ((e = operand_of(static_cast<const T*>(ctx), (long long)plane, planes, &o.a[0], &o.a_term, st))) return e;
  o.lda = Dm;
  o.b[0] = wop[3];
  o.b_term = w_term;
  o.ldb = Dm;
  o.bias[0] = bo;
  o.c[0] = out;
  o.M = M;
  o.N = Dm;
  o.K = Dm;
  return launch_gemm_sm90<B_NT, EPI_BIAS, T>(o, st);
}

template <typename T>
int block_bwd(const T* x, const void* const* w, const float* bqkv, const float* gb, const float* bias,
              const T* ctx, const float* lse, const T* g, char* ws, T* dx, int B, int S, int Dm, int H,
              float scale, float ln_eps, cudaStream_t st) {
  const Carve<BW_COUNT> L = bwd_ws(B, S, Dm, H, gb != nullptr, kTerms<T> == 3);
  const bf16* wop[4];
  long long w_term;
  int err = projection_operands<T>(w, Dm, reinterpret_cast<bf16*>(ws + L.off[BW_WTERMS]), wop, &w_term, st);
  if (err) return err;
  AttnBwdProblem<T> a{};
  a.x = x;
  a.wq = wop[0];
  a.wk = wop[1];
  a.wv = wop[2];
  a.wo = wop[3];
  a.w_term = w_term;
  a.bqkv = bqkv;
  a.gamma = gb;
  a.beta = gb != nullptr ? gb + Dm : nullptr;
  a.ln_eps = ln_eps;
  a.bias = bias;
  a.ctx = ctx;
  a.lse = lse;
  a.g_att = g;
  a.ws = {ws + L.off[BW_QKV], ws + L.off[BW_DQKV], ws + L.off[BW_DCTX],
          reinterpret_cast<float*>(ws + L.off[BW_DELTA]), ws + L.off[BW_XLN],
          reinterpret_cast<bf16*>(ws + L.off[BW_PLANES])};
  a.B = B;
  a.S = S;
  a.Dm = Dm;
  a.H = H;
  a.scale = scale;
  if (gb == nullptr) return attn_bwd_to_dxln<T>(a, dx, nullptr, st);
  float* dxln = reinterpret_cast<float*>(ws + L.off[BW_DXLN]);
  if ((err = attn_bwd_to_dxln<T>(a, nullptr, dxln, st))) return err;
  return launch_ln_bwd_rows<T>(x, gb, ln_eps, dxln, nullptr, dx, nullptr, B * S, Dm, st);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of scratch attn_block_fwd needs (f32: float32 activations and weights).
long long attn_block_fwd_workspace(int B, int S, int Dm, int f32) {
  return (long long)fwd_ws(B, S, Dm, f32 != 0).total;
}

// x [B, S, Dm] and wq/wk/wv/wo [Dm, Dm] (nn.Linear [out, in]), bf16 (f32 = 0)
// or fp32 (f32 = 1); bqkv [3, Dm] f32; bo [Dm] f32; gb [2, Dm] f32 or null
// (no fused LN); bias [B, S] f32 or null; workspace of attn_block_fwd_workspace
// bytes (left holding q/k/v [3, B*S, Dm] at its start).
// Outputs: ctx [B, S, Dm] (also the LN1 plane's scratch before the attention
// core writes it), lse [B, H, S] f32, out [B, S, Dm], in x's type.
// Returns the CUDA error of the launches (0 = success).
int attn_block_fwd(const void* x, const void* wq, const void* wk, const void* wv,
                   const void* wo, const void* bqkv, const void* bo, const void* gb,
                   const void* bias, void* workspace, void* ctx, void* lse, void* out,
                   int B, int S, int Dm, int H, int f32, float scale, float ln_eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* w[4] = {wq, wk, wv, wo};
  const float* bq = static_cast<const float*>(bqkv);
  const float* bo_ = static_cast<const float*>(bo);
  const float* gamma = static_cast<const float*>(gb);
  const float* brow = static_cast<const float*>(bias);
  char* ws = static_cast<char*>(workspace);
  if (f32)
    return block_fwd<float>(static_cast<const float*>(x), w, bq, bo_, gamma, ln_eps, brow, ws,
                            static_cast<float*>(ctx), static_cast<float*>(lse), static_cast<float*>(out), B,
                            S, Dm, H, scale, st);
  return block_fwd<bf16>(static_cast<const bf16*>(x), w, bq, bo_, gamma, ln_eps, brow, ws,
                         static_cast<bf16*>(ctx), static_cast<float*>(lse), static_cast<bf16*>(out), B, S,
                         Dm, H, scale, st);
}

// Bytes of scratch attn_block_bwd needs.
long long attn_block_bwd_workspace(int B, int S, int Dm, int H, int has_ln, int f32) {
  return (long long)bwd_ws(B, S, Dm, H, has_ln != 0, f32 != 0).total;
}

// x [B, S, Dm] (pre-LN when gb is given) and the weights as the forward, in
// bf16 (f32 = 0) or fp32 (f32 = 1); biases as the forward; gb [2, Dm] f32 or
// null; bias [B, S] f32 or null; ctx [B, S, Dm] (x's type) and lse [B, H, S]
// f32 from the forward; g [B, S, Dm] in x's type.  Output dx [B, S, Dm] in
// x's type.  Returns the CUDA error of the launches.
int attn_block_bwd(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
                   const void* bqkv, const void* gb, const void* bias, const void* ctx,
                   const void* lse, const void* g, void* workspace, void* dx, int B, int S, int Dm,
                   int H, int f32, float scale, float ln_eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* w[4] = {wq, wk, wv, wo};
  const float* bq = static_cast<const float*>(bqkv);
  const float* gamma = static_cast<const float*>(gb);
  const float* brow = static_cast<const float*>(bias);
  const float* lse_ = static_cast<const float*>(lse);
  char* ws = static_cast<char*>(workspace);
  if (f32)
    return block_bwd<float>(static_cast<const float*>(x), w, bq, gamma, brow, static_cast<const float*>(ctx),
                            lse_, static_cast<const float*>(g), ws, static_cast<float*>(dx), B, S, Dm, H,
                            scale, ln_eps, st);
  return block_bwd<bf16>(static_cast<const bf16*>(x), w, bq, gamma, brow, static_cast<const bf16*>(ctx), lse_,
                         static_cast<const bf16*>(g), ws, static_cast<bf16*>(dx), B, S, Dm, H, scale, ln_eps,
                         st);
}

}  // extern "C"
