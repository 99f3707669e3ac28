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
// the work is cut into three launches on the caller's stream:
//   (a) port::gemm_kernel (common.cuh): one tiled bf16 GEMM for q|k|v
//       together (N = 3*Dm), mma.sync m16n8k16 with fp32 accumulators,
//       LayerNorm applied in the prologue while the A tile is staged into
//       shared memory (row statistics computed once per 128-row tile),
//       bias-add and bf16 cast in the epilogue;
//   (b) attn_kernel: one block per (query tile of 64, head, batch element);
//       the fp32 logits of its 64 rows over the whole key range stay in
//       shared memory, so the softmax is the TPU's exact two-pass form (no
//       online rescaling); padded keys are simply never summed;
//   (c) the same GEMM again for the out-projection.
// q/k/v round-trip through device memory (3 x B*S*Dm bf16, from L2 mostly).
// wgmma, TMA and fusing the three launches are later work.
//
// Backward: replaces feddat_tpu/ops/attn_block.py::_bwd_kernel (kernel #3,
// called through _attn_block_bwd): dx only, the projections frozen.  The
// attention part is attn_bwd.cuh, shared with the whole-layer backward (#4);
// with the LayerNorm fused, one row pass (common.cuh::ln_bwd_rows_kernel)
// takes dxln back through LN1.  Its bound and design are in attn_bwd.cuh.

#include "attn_bwd.cuh"

namespace {

using namespace port;

// --------------------------------------------------------------------- (b)
constexpr int ATT_BQ = 64;       // query rows per block (16 per warp)
constexpr int ATT_BK = 64;       // keys per staged K/V tile
constexpr int ATT_D = 64;        // head dim
constexpr int ATT_THREADS = 128;
constexpr int ATT_LD = ATT_D + 8;  // padded smem row (bf16)

struct AttnArgs {
  const bf16* q;      // [B*S, Dm]; head h in columns [h*64, h*64+64)
  const bf16* k;
  const bf16* v;
  const float* bias;  // [B, S] additive key bias, or null
  bf16* ctx;          // [B*S, Dm]
  float* lse;         // [B, H, S]
  int S, Dm, H, sp;   // sp = S rounded up to ATT_BK
  float scale;
};

size_t attn_smem_bytes(int sp) {
  return sizeof(float) * ((size_t)ATT_BQ * (sp + 8) + sp + 2 * ATT_BQ) +
         sizeof(bf16) * 2 * ATT_BQ * ATT_LD;
}

__global__ void __launch_bounds__(ATT_THREADS) attn_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lld = p.sp + 8;  // logits row stride (fp32)
  float* L = reinterpret_cast<float*>(smem);  // [ATT_BQ][lld]
  float* brow = L + ATT_BQ * lld;             // [sp]
  float* m_s = brow + p.sp;                   // [ATT_BQ]
  float* l_s = m_s + ATT_BQ;                  // [ATT_BQ]
  bf16* Qs = reinterpret_cast<bf16*>(l_s + ATT_BQ);  // [ATT_BQ][ATT_LD]
  bf16* KVs = Qs + ATT_BQ * ATT_LD;  // K tile [key][d], then V tile transposed [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * ATT_BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * p.S;  // first token row of this batch element
  const int col0 = h * ATT_D;
  const int qr = warp * 16;             // this warp's rows within the tile

  for (int j = tid; j < p.sp; j += ATT_THREADS)
    brow[j] = (j < p.S && p.bias != nullptr) ? p.bias[row0 + j] : 0.f;
  for (int i = tid; i < ATT_BQ * (ATT_D / 8); i += ATT_THREADS) {
    const int r = i / (ATT_D / 8), c = (i % (ATT_D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.S) v = *reinterpret_cast<const uint4*>(p.q + (row0 + q0 + r) * p.Dm + col0 + c);
    *reinterpret_cast<uint4*>(Qs + r * ATT_LD + c) = v;
  }
  __syncthreads();

  uint32_t qa[ATT_D / 16][4];
#pragma unroll
  for (int ks = 0; ks < ATT_D / 16; ++ks) {
    const bf16* pq = Qs + (qr + g) * ATT_LD + ks * 16 + tig * 2;
    qa[ks][0] = lds32(pq);
    qa[ks][1] = lds32(pq + 8 * ATT_LD);
    qa[ks][2] = lds32(pq + 8);
    qa[ks][3] = lds32(pq + 8 * ATT_LD + 8);
  }

  // phase 1: scaled, biased fp32 logits of the warp's 16 rows x all keys
  for (int kt = 0; kt < p.sp; kt += ATT_BK) {
    __syncthreads();
    for (int i = tid; i < ATT_BK * (ATT_D / 8); i += ATT_THREADS) {
      const int r = i / (ATT_D / 8), c = (i % (ATT_D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < p.S) v = *reinterpret_cast<const uint4*>(p.k + (row0 + kt + r) * p.Dm + col0 + c);
      *reinterpret_cast<uint4*>(KVs + r * ATT_LD + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < ATT_BK / 8; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < ATT_D / 16; ++ks) {
        const bf16* pk = KVs + (nt * 8 + g) * ATT_LD + ks * 16 + tig * 2;
        uint32_t kb[2] = {lds32(pk), lds32(pk + 8)};
        mma_16816(c, qa[ks], kb);
      }
      const int key = kt + nt * 8 + tig * 2;
      const bool v0 = key < p.S, v1 = key + 1 < p.S;
      const float b0 = brow[key], b1 = brow[key + 1];
      float2 top, bot;
      top.x = v0 ? __fadd_rn(__fmul_rn(c[0], p.scale), b0) : -INFINITY;
      top.y = v1 ? __fadd_rn(__fmul_rn(c[1], p.scale), b1) : -INFINITY;
      bot.x = v0 ? __fadd_rn(__fmul_rn(c[2], p.scale), b0) : -INFINITY;
      bot.y = v1 ? __fadd_rn(__fmul_rn(c[3], p.scale), b1) : -INFINITY;
      *reinterpret_cast<float2*>(L + (qr + g) * lld + key) = top;
      *reinterpret_cast<float2*>(L + (qr + g + 8) * lld + key) = bot;
    }
  }
  __syncwarp();

  // phase 2: row max, p = exp(s - max) in place, l = sum(p) (fp32)
  for (int r = 0; r < 16; ++r) {
    float* lr = L + (qr + r) * lld;
    float m = -INFINITY;
    for (int j = lane; j < p.S; j += 32) m = fmaxf(m, lr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < p.sp; j += 32) {
      const float e = j < p.S ? expf(lr[j] - m) : 0.f;
      lr[j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[qr + r] = m;
      l_s[qr + r] = l;
    }
  }
  __syncwarp();

  // phase 3: ctx = bf16(p) . v, fp32 accumulators for 16 rows x 64 dims
  float acc[ATT_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < ATT_D / 8; ++nt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[nt][t] = 0.f;

  for (int kt = 0; kt < p.sp; kt += ATT_BK) {
    __syncthreads();
    for (int i = tid; i < ATT_BK * (ATT_D / 8); i += ATT_THREADS) {
      const int r = i % ATT_BK, c = (i / ATT_BK) * 8;  // r: key, c: first dim
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < p.S) v = *reinterpret_cast<const uint4*>(p.v + (row0 + kt + r) * p.Dm + col0 + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t) KVs[(c + t) * ATT_LD + r] = e[t];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < ATT_BK / 16; ++ks) {
      const float* p0 = L + (qr + g) * lld + kt + ks * 16 + tig * 2;
      const float* p1 = p0 + 8 * lld;
      const float2 x00 = *reinterpret_cast<const float2*>(p0);
      const float2 x10 = *reinterpret_cast<const float2*>(p1);
      const float2 x01 = *reinterpret_cast<const float2*>(p0 + 8);
      const float2 x11 = *reinterpret_cast<const float2*>(p1 + 8);
      uint32_t pa[4] = {pack_bf16(x00.x, x00.y), pack_bf16(x10.x, x10.y),
                        pack_bf16(x01.x, x01.y), pack_bf16(x11.x, x11.y)};
#pragma unroll
      for (int nt = 0; nt < ATT_D / 8; ++nt) {
        const bf16* pv = KVs + (nt * 8 + g) * ATT_LD + ks * 16 + tig * 2;
        uint32_t vb[2] = {lds32(pv), lds32(pv + 8)};
        mma_16816(acc[nt], pa, vb);
      }
    }
  }

  const int r_top = q0 + qr + g, r_bot = r_top + 8;
  const float l_top = l_s[qr + g], l_bot = l_s[qr + g + 8];
#pragma unroll
  for (int nt = 0; nt < ATT_D / 8; ++nt) {
    const int col = col0 + nt * 8 + tig * 2;
    if (r_top < p.S)
      *reinterpret_cast<uint32_t*>(p.ctx + (row0 + r_top) * p.Dm + col) =
          pack_bf16(acc[nt][0] / l_top, acc[nt][1] / l_top);
    if (r_bot < p.S)
      *reinterpret_cast<uint32_t*>(p.ctx + (row0 + r_bot) * p.Dm + col) =
          pack_bf16(acc[nt][2] / l_bot, acc[nt][3] / l_bot);
  }
  if (lane < 16 && q0 + qr + lane < p.S)
    p.lse[((size_t)b * p.H + h) * p.S + q0 + qr + lane] = m_s[qr + lane] + logf(l_s[qr + lane]);
}

}  // namespace

using namespace port;

extern "C" {

// Largest S the attention kernel's shared memory holds (the wrapper checks).
int attn_block_max_seq(void) {
  int sp = 0;
  while (attn_smem_bytes(sp + ATT_BK) <= 227 * 1024) sp += ATT_BK;
  return sp;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [B, S, Dm] bf16; wq/wk/wv/wo [Dm, Dm] bf16 (nn.Linear [out, in]);
// bqkv [3, Dm] f32; bo [Dm] f32; gb [2, Dm] f32 or null (no fused LN);
// bias [B, S] f32 or null; qkv scratch [3, B*S, Dm] bf16.
// Outputs: ctx [B, S, Dm] bf16, lse [B, H, S] f32, out [B, S, Dm] bf16.
// Returns the CUDA error of the launches (0 = success).
int attn_block_fwd(const void* x, const void* wq, const void* wk, const void* wv,
                   const void* wo, const void* bqkv, const void* bo, const void* gb,
                   const void* bias, void* qkv, void* ctx, void* lse, void* out,
                   int B, int S, int Dm, int H, float scale, float ln_eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S;
  const size_t plane = (size_t)M * Dm;
  const float* bq = static_cast<const float*>(bqkv);
  bf16* qkv_b = static_cast<bf16*>(qkv);

  GemmArgs a{};
  a.a[0] = static_cast<const bf16*>(x);
  a.lda = Dm;
  a.b[0] = static_cast<const bf16*>(wq);
  a.b[1] = static_cast<const bf16*>(wk);
  a.b[2] = static_cast<const bf16*>(wv);
  a.ldb = Dm;
  a.b_seg = Dm;
  for (int i = 0; i < 3; ++i) {
    a.bias[i] = bq + (size_t)i * Dm;
    a.c_bf16[i] = qkv_b + i * plane;
  }
  a.c_seg = Dm;
  a.ln_gamma = gb ? static_cast<const float*>(gb) : nullptr;
  a.ln_beta = gb ? static_cast<const float*>(gb) + Dm : nullptr;
  a.ln_eps = ln_eps;
  a.M = M;
  a.N = 3 * Dm;
  a.K = Dm;
  int e = launch_gemm<B_NT, EPI_BIAS_BF16>(a, st);
  if (e) return e;
  cudaError_t err;

  AttnArgs t{};
  t.q = qkv_b;
  t.k = qkv_b + plane;
  t.v = qkv_b + 2 * plane;
  t.bias = static_cast<const float*>(bias);
  t.ctx = static_cast<bf16*>(ctx);
  t.lse = static_cast<float*>(lse);
  t.S = S;
  t.Dm = Dm;
  t.H = H;
  t.sp = (S + ATT_BK - 1) / ATT_BK * ATT_BK;
  t.scale = scale;
  const size_t smem = attn_smem_bytes(t.sp);
  err = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_kernel<<<dim3(t.sp / ATT_BQ, H, B), ATT_THREADS, smem, st>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

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
  return launch_gemm<B_NT, EPI_BIAS_BF16>(o, st);
}

// Bytes of scratch attn_block_bwd needs: qkv and dq|dk|dv [3, M, Dm] bf16 each,
// dctx [M, Dm] bf16, delta [B, H, S] f32 and, with the fused LN, dxln [M, Dm] f32.
long long attn_block_bwd_workspace(int B, int S, int Dm, int H, int has_ln) {
  const long long md = (long long)B * S * Dm;
  return 7 * md * 2 + (long long)B * H * S * 4 + (has_ln ? md * 4 : 0) + 5 * 256;
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
  int err = attn_bwd_to_dxln(a, 0, nullptr, dxln, st);
  if (err) return err;
  return launch_ln_bwd_rows(a.x, a.gamma, ln_eps, dxln, nullptr, static_cast<bf16*>(dx), nullptr,
                            B * S, Dm, st);
}

}  // extern "C"
