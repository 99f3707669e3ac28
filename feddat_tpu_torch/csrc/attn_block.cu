// Fused pre-LN attention block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel feddat_tpu/ops/attn_block.py::_fwd_kernel (called
// through _fwd_call).  Same function, same rounding points:
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
//   (a) gemm_bias_kernel: one tiled bf16 GEMM for q|k|v together
//       (N = 3*Dm), mma.sync m16n8k16 with fp32 accumulators, LayerNorm
//       applied in the prologue while the A tile is staged into shared
//       memory (row statistics computed once per 128-row tile), bias-add and
//       bf16 cast in the epilogue;
//   (b) attn_kernel: one block per (query tile of 64, head, batch element);
//       the fp32 logits of its 64 rows over the whole key range stay in
//       shared memory, so the softmax is the TPU's exact two-pass form (no
//       online rescaling); padded keys are simply never summed;
//   (c) gemm_bias_kernel again for the out-projection.
// q/k/v round-trip through device memory (3 x B*S*Dm bf16, from L2 mostly).
// wgmma, TMA and fusing the three launches are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- (a), (c)
constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;        // 8 warps: 2 along M x 4 along N
constexpr int GEMM_LD = GEMM_BK + 8;     // padded smem row (bf16): conflict-free fragments

struct GemmArgs {
  const bf16* a;          // [M, K] row-major activations
  const bf16* w[3];       // per output segment: [n_seg, K] (nn.Linear layout)
  const float* bias[3];   // per output segment: [n_seg] fp32
  bf16* c[3];             // per output segment: [M, n_seg]
  const float* ln_gamma;  // [K] fp32, or null: no fused LayerNorm
  const float* ln_beta;   // [K] fp32
  float ln_eps;
  int M, K, n_seg;
};

__global__ void __launch_bounds__(GEMM_THREADS) gemm_bias_kernel(GemmArgs p) {
  __shared__ __align__(16) bf16 As[GEMM_BM * GEMM_LD];
  __shared__ __align__(16) bf16 Bs[GEMM_BN * GEMM_LD];
  __shared__ float row_mu[GEMM_BM];
  __shared__ float row_rstd[GEMM_BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM;
  const int ncol = blockIdx.x * GEMM_BN;
  const int seg = ncol / p.n_seg, n0 = ncol % p.n_seg;
  const bf16* __restrict__ W = p.w[seg];
  const bool ln = p.ln_gamma != nullptr;

  if (ln) {  // row statistics of this tile, fp32, fast-variance form
    for (int r = warp; r < GEMM_BM; r += GEMM_THREADS / 32) {
      const int row = m0 + r;
      float s = 0.f, ss = 0.f;
      if (row < p.M) {
        const bf16* xr = p.a + (size_t)row * p.K;
        for (int k = lane * 8; k < p.K; k += 32 * 8) {
          uint4 v = *reinterpret_cast<const uint4*>(xr + k);
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float f = __bfloat162float(e[i]);
            s += f;
            ss += f * f;
          }
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      if (lane == 0) {
        float mu = s / (float)p.K;
        float var = fmaxf(ss / (float)p.K - mu * mu, 0.f);
        row_mu[r] = mu;
        row_rstd[r] = rsqrtf(var + p.ln_eps);
      }
    }
    __syncthreads();
  }

  // each thread stages 2 x 16 B of A and of B per k-tile
  uint4 ra[2], rb[2];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 2, c8 = (idx & 3) * 8;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M) ra[i] = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * p.K + k0 + c8);
      rb[i] = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * p.K + k0 + c8);
    }
  };
  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 2, c8 = (idx & 3) * 8;
      uint4 va = ra[i];
      if (ln && m0 + r < p.M) {
        const float mu = row_mu[r], rstd = row_rstd[r];
        bf16* e = reinterpret_cast<bf16*>(&va);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int k = k0 + c8 + t;
          float xf = __bfloat162float(e[t]);
          float y = __fadd_rn(__fmul_rn(__fmul_rn(xf - mu, rstd), p.ln_gamma[k]), p.ln_beta[k]);
          e[t] = __float2bfloat16_rn(y);
        }
      }
      *reinterpret_cast<uint4*>(As + r * GEMM_LD + c8) = va;
      *reinterpret_cast<uint4*>(Bs + r * GEMM_LD + c8) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int wm = (warp >> 2) * 64;  // warp's 64 rows
  const int wn = (warp & 3) * 32;   // warp's 32 columns

  load_tiles(0);
  for (int k0 = 0; k0 < p.K; k0 += GEMM_BK) {
    __syncthreads();
    store_tiles(k0);
    __syncthreads();
    if (k0 + GEMM_BK < p.K) load_tiles(k0 + GEMM_BK);  // in flight during the MMAs
#pragma unroll
    for (int ks = 0; ks < GEMM_BK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* pa = As + (wm + mt * 16 + g) * GEMM_LD + ks + tig * 2;
        af[mt][0] = lds32(pa);
        af[mt][1] = lds32(pa + 8 * GEMM_LD);
        af[mt][2] = lds32(pa + 8);
        af[mt][3] = lds32(pa + 8 * GEMM_LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* pb = Bs + (wn + nt * 8 + g) * GEMM_LD + ks + tig * 2;
        bfr[nt][0] = lds32(pb);
        bfr[nt][1] = lds32(pb + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }

  const float* __restrict__ bias = p.bias[seg];
  bf16* __restrict__ C = p.c[seg];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = m0 + wm + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + tig * 2;
      const float b0 = bias[col], b1 = bias[col + 1];
      if (r0 < p.M)
        *reinterpret_cast<uint32_t*>(C + (size_t)r0 * p.n_seg + col) =
            pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (r0 + 8 < p.M)
        *reinterpret_cast<uint32_t*>(C + (size_t)(r0 + 8) * p.n_seg + col) =
            pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

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
  a.a = static_cast<const bf16*>(x);
  a.w[0] = static_cast<const bf16*>(wq);
  a.w[1] = static_cast<const bf16*>(wk);
  a.w[2] = static_cast<const bf16*>(wv);
  for (int i = 0; i < 3; ++i) {
    a.bias[i] = bq + (size_t)i * Dm;
    a.c[i] = qkv_b + i * plane;
  }
  a.ln_gamma = gb ? static_cast<const float*>(gb) : nullptr;
  a.ln_beta = gb ? static_cast<const float*>(gb) + Dm : nullptr;
  a.ln_eps = ln_eps;
  a.M = M;
  a.K = Dm;
  a.n_seg = Dm;
  gemm_bias_kernel<<<dim3(3 * Dm / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM), GEMM_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

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
  o.a = static_cast<const bf16*>(ctx);
  for (int i = 0; i < 3; ++i) {
    o.w[i] = static_cast<const bf16*>(wo);
    o.bias[i] = static_cast<const float*>(bo);
    o.c[i] = static_cast<bf16*>(out);
  }
  o.M = M;
  o.K = Dm;
  o.n_seg = Dm;
  gemm_bias_kernel<<<dim3(Dm / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM), GEMM_THREADS, 0, st>>>(o);
  return (int)cudaGetLastError();
}

}  // extern "C"
