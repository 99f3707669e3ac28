// Whole pre-LN layer backward with a trainable adapter, for Hopper (sm_90a).
//
// Replaces the TPU kernel feddat_tpu/ops/layer_block.py::_layer_bwd_kernel
// (kernel #4, called through _layer_block_bwd).  The layer is
//
//   h = x + attn(LN1(x)),  o = h + FFN(LN2(h)),  out = o + w_a.ad_a(o) [+ w_b.ad_b(o)]
//
// and from the forward's residuals (x, aout, ctx, lse) and g = d out this
// computes d x and the active adapter's weight gradients; the backbone and
// the ensemble partner are frozen.  Same rounding points as the TPU kernel
// (layer_block.py:163-302): h, m, o, relu_a, g_delta_a = bf16(g w_a), g_f,
// g_p1, g_att and the attention's q/k/v, P, ds, dq/dk/dv are bf16; p1, g_down_a,
// g_o, g_m, g_h and dxln stay fp32; dbda sums the fp32 g_down_a and dbua the
// bf16 g_delta_a; GELU and its derivative use the kernel's polynomial erf.
//
// What bounds it on the H100: at the training shape (B=64, S=185 -> 11 840
// rows, Dm=768, F=3072, r=48) one call does ~362 GFLOP: FFN recompute 111.7,
// FFN backward 111.7, the attention part's projections 97.8, per-head
// attention 33.6 (bf16 tensor cores, ~0.36 ms at 989 TFLOP/s) and the adapters
// ~7.0 (bf16 values with fp32 sums: tensor-core work too); ~0.35 ms at 989
// TFLOP/s.  It moves ~105 MB (~0.03 ms).  Operations bound it.
//
// What the design does about it.  The TPU kernel walks batch elements in
// order with the whole FFN and both attention weights resident in VMEM and
// carries the adapter gradients across its sequential grid.  On the card the
// work is a short sequence of launches on the caller's stream:
//   1. ln2_fwd_rows_kernel: h = bf16(x + aout), m = bf16(LN2(h));
//   2. the FFN recompute through port::gemm_kernel: p1 = m.W1^T + b1 kept
//      fp32 with ge = bf16(gelu(p1)) in the same epilogue, then
//      o = bf16(h + bf16(ge.W2^T + b2));
//   3. adapter_bwd_rows_kernel: both members' down projections, the active
//      adapter's relu and g_down, and g_o = g + g_down.Wd^T (bf16 values
//      with fp32 sums on the tensor cores, mma.sync);
//      adapter_wgrad_kernel writes per-chunk partial sums of the weight
//      gradients and adapter_wgrad_reduce_kernel adds them in a fixed order,
//      so two runs give bitwise the same gradients (no float atomics);
//   4. g_p1 = bf16((g_f.W2) * gelu'(p1)) (GEMM epilogue), g_m = g_p1.W1;
//   5. ln_bwd_rows_kernel: g_h = g_o + LN2_bwd(g_m), g_att = bf16(g_h);
//   6. the attention backward of attn_bwd.cuh (shared with kernel #3) to dxln;
//   7. ln_bwd_rows_kernel: dx = bf16(LN1_bwd(dxln) + g_h).
// p1 (fp32, 145 MB at the training shape) goes through device memory; fusing
// steps 2 and 4 so that it never does, and wgmma/TMA GEMMs, are later work.

#include "attn_bwd.cuh"

namespace {

using namespace port;

// ----------------------------------------------------------------- step 1
__global__ void ln2_fwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ aout,
                                    const float* __restrict__ gamma, const float* __restrict__ beta,
                                    float eps, bf16* __restrict__ h, bf16* __restrict__ m, int M, int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float hv = round_bf16(__bfloat162float(x[off + k]) + __bfloat162float(aout[off + k]));
    h[off + k] = __float2bfloat16_rn(hv);
    s += hv;
    ss += hv * hv;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float rstd = rsqrtf(fmaxf(ss / (float)D - mu * mu, 0.f) + eps);
  for (int k = lane; k < D; k += 32) {
    const float hv = __bfloat162float(h[off + k]);
    m[off + k] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(__fmul_rn(hv - mu, rstd), gamma[k]), beta[k]));
  }
}

// ----------------------------------------------------------------- step 3
constexpr int AW_ROWS = 256;  // rows per chunk of the weight-gradient partial sums
constexpr int AW_COLS = 64;   // Dm columns per block
constexpr int AW_SUB = 32;    // rows staged at a time
constexpr int AW_JMAX = 16;   // bottleneck r <= 4 * AW_JMAX
constexpr int AD_MAX_R = 4 * AW_JMAX;
constexpr int AR_ROWS = 64;     // rows per block of the row pass: 4 warps x 16
constexpr int AR_THREADS = 128;
constexpr int AR_K = 32;        // Dm columns staged per step
constexpr int AR_LD = AR_K + 8;  // padded smem row (bf16)
constexpr int AR_NCHUNK = 64;   // Dm columns of g_o per warp pass

struct AdapterBwdArgs {
  const bf16* o;              // [M, D] recomputed o
  const bf16* g;              // [M, D] d out
  const bf16 *wda, *wdb;      // [D, R] down kernels (flax layout)
  const bf16 *wdaT, *wdbT;    // [R, D] down kernels, transposed
  const bf16 *wua, *wub;      // [R, D] up kernels (flax layout)
  const float *bda, *bdb;     // [R]
  float w_a, w_b;
  bf16* relu_a;               // [M, R]
  float* gdown_a;             // [M, R]
  float* g_o;                 // [M, D]
  bf16* g_f;                  // [M, D]
  int M, D;
};

// The adapters' row pass on tensor cores (all three products take bf16
// values with fp32 sums, as on the TPU), one warp per 16 rows:
//   down   = o . Wd + bd               for both members (N = 2R)
//   g_relu = bf16(g w) . Wu^T          for each member with its own w
//   g_down = down > 0 ? g_relu : 0
//   g_o    = (g + bf16(g_down_a) . Wda^T) [+ bf16(g_down_b) . Wdb^T]
// The first two stream Dm in AR_K-wide chunks through shared memory; g_down
// stays in registers (its C fragments are the A fragments of the third);
// the third reads Wd^T fragments from L1/L2 (36 KB per member).
template <int R, bool USE_B>
__global__ void __launch_bounds__(AR_THREADS) adapter_bwd_rows_kernel(AdapterBwdArgs p) {
  constexpr int NM = USE_B ? 2 : 1;  // members
  constexpr int NT = R / 8;          // n-tiles of one member
  __shared__ __align__(16) bf16 Os[AR_ROWS * AR_LD];
  __shared__ __align__(16) bf16 Gs[NM][AR_ROWS * AR_LD];  // bf16(g w) per member
  __shared__ __align__(16) bf16 Wd[NM * R * AR_LD];        // [n = member j][k = d]
  __shared__ __align__(16) bf16 Wu[NM * R * AR_LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * AR_ROWS, wr = warp * 16;
  const int r_top = m0 + wr + g, r_bot = r_top + 8;

  float down[NM][NT][4], grelu[NM][NT][4];
#pragma unroll
  for (int a = 0; a < NM; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) down[a][nt][e] = grelu[a][nt][e] = 0.f;

  for (int k0 = 0; k0 < p.D; k0 += AR_K) {
    __syncthreads();
    for (int i = tid; i < AR_ROWS * (AR_K / 8); i += AR_THREADS) {
      const int r = i / (AR_K / 8), c = (i % (AR_K / 8)) * 8;
      uint4 vo = make_uint4(0u, 0u, 0u, 0u), vg = vo;
      if (m0 + r < p.M) {
        vo = *reinterpret_cast<const uint4*>(p.o + (size_t)(m0 + r) * p.D + k0 + c);
        vg = *reinterpret_cast<const uint4*>(p.g + (size_t)(m0 + r) * p.D + k0 + c);
      }
      *reinterpret_cast<uint4*>(Os + r * AR_LD + c) = vo;
      const bf16* ge = reinterpret_cast<const bf16*>(&vg);
#pragma unroll
      for (int a = 0; a < NM; ++a) {
        const float w = a ? p.w_b : p.w_a;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          Gs[a][r * AR_LD + c + t] = __float2bfloat16_rn(__bfloat162float(ge[t]) * w);
      }
    }
    for (int i = tid; i < NM * R * (AR_K / 8); i += AR_THREADS) {
      const int n = i / (AR_K / 8), c = (i % (AR_K / 8)) * 8;
      const int a = n / R, j = n % R;
      const bf16* wdT = a ? p.wdbT : p.wdaT;
      const bf16* wu = a ? p.wub : p.wua;
      *reinterpret_cast<uint4*>(Wd + n * AR_LD + c) =
          *reinterpret_cast<const uint4*>(wdT + (size_t)j * p.D + k0 + c);
      *reinterpret_cast<uint4*>(Wu + n * AR_LD + c) =
          *reinterpret_cast<const uint4*>(wu + (size_t)j * p.D + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < AR_K; ks += 16) {
      uint32_t ao[4], ag[NM][4];
      const bf16* po = Os + (wr + g) * AR_LD + ks + tig * 2;
      ao[0] = lds32(po);
      ao[1] = lds32(po + 8 * AR_LD);
      ao[2] = lds32(po + 8);
      ao[3] = lds32(po + 8 * AR_LD + 8);
#pragma unroll
      for (int a = 0; a < NM; ++a) {
        const bf16* pg = Gs[a] + (wr + g) * AR_LD + ks + tig * 2;
        ag[a][0] = lds32(pg);
        ag[a][1] = lds32(pg + 8 * AR_LD);
        ag[a][2] = lds32(pg + 8);
        ag[a][3] = lds32(pg + 8 * AR_LD + 8);
      }
#pragma unroll
      for (int a = 0; a < NM; ++a)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = a * R + nt * 8 + g;
          uint32_t bd[2] = {lds32(Wd + n * AR_LD + ks + tig * 2), lds32(Wd + n * AR_LD + ks + tig * 2 + 8)};
          uint32_t bu[2] = {lds32(Wu + n * AR_LD + ks + tig * 2), lds32(Wu + n * AR_LD + ks + tig * 2 + 8)};
          mma_16816(down[a][nt], ao, bd);
          mma_16816(grelu[a][nt], ag[a], bu);
        }
    }
  }

  // gate, write relu_a and g_down_a, keep bf16(g_down) as A fragments
  uint32_t gdn[NM][R / 16][4];
#pragma unroll
  for (int a = 0; a < NM; ++a) {
    const float* bias = a ? p.bdb : p.bda;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nt * 8 + tig * 2;
      float gd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dn = down[a][nt][e] + bias[j + (e & 1)];
        down[a][nt][e] = dn;
        gd[e] = dn > 0.f ? grelu[a][nt][e] : 0.f;
      }
      if (a == 0) {
        if (r_top < p.M) {
          *reinterpret_cast<float2*>(p.gdown_a + (size_t)r_top * R + j) = make_float2(gd[0], gd[1]);
          *reinterpret_cast<uint32_t*>(p.relu_a + (size_t)r_top * R + j) =
              pack_bf16(fmaxf(down[a][nt][0], 0.f), fmaxf(down[a][nt][1], 0.f));
        }
        if (r_bot < p.M) {
          *reinterpret_cast<float2*>(p.gdown_a + (size_t)r_bot * R + j) = make_float2(gd[2], gd[3]);
          *reinterpret_cast<uint32_t*>(p.relu_a + (size_t)r_bot * R + j) =
              pack_bf16(fmaxf(down[a][nt][2], 0.f), fmaxf(down[a][nt][3], 0.f));
        }
      }
      // C fragment (n-tile nt) -> half of the A fragment of k-step nt / 2
      gdn[a][nt / 2][(nt & 1) * 2 + 0] = pack_bf16(gd[0], gd[1]);
      gdn[a][nt / 2][(nt & 1) * 2 + 1] = pack_bf16(gd[2], gd[3]);
    }
  }

  // g_o = (g + bf16(g_down_a) . Wda^T) [+ bf16(g_down_b) . Wdb^T]
  for (int n0 = 0; n0 < p.D; n0 += AR_NCHUNK) {
    float acc[NM][AR_NCHUNK / 8][4];
#pragma unroll
    for (int a = 0; a < NM; ++a) {
      const bf16* wd = a ? p.wdb : p.wda;
#pragma unroll
      for (int nt = 0; nt < AR_NCHUNK / 8; ++nt) {
        acc[a][nt][0] = acc[a][nt][1] = acc[a][nt][2] = acc[a][nt][3] = 0.f;
        const bf16* pw = wd + (size_t)(n0 + nt * 8 + g) * R + tig * 2;
#pragma unroll
        for (int ks = 0; ks < R / 16; ++ks) {
          uint32_t b[2] = {lds32(pw + ks * 16), lds32(pw + ks * 16 + 8)};
          mma_16816(acc[a][nt], gdn[a][ks], b);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < AR_NCHUNK / 8; ++nt) {
      const int col = n0 + nt * 8 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? r_bot : r_top;
        if (row >= p.M) continue;
        const size_t off = (size_t)row * p.D + col;
        const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(p.g + off);
        float v0 = __low2float(gv) + acc[0][nt][2 * half];
        float v1 = __high2float(gv) + acc[0][nt][2 * half + 1];
        if (USE_B) {
          v0 += acc[NM - 1][nt][2 * half];
          v1 += acc[NM - 1][nt][2 * half + 1];
        }
        *reinterpret_cast<float2*>(p.g_o + off) = make_float2(v0, v1);
        *reinterpret_cast<uint32_t*>(p.g_f + off) = pack_bf16(v0, v1);
      }
    }
  }
}

template <int R>
int launch_adapter_rows(const AdapterBwdArgs& p, bool use_b, cudaStream_t st) {
  const dim3 grid((p.M + AR_ROWS - 1) / AR_ROWS);
  if (use_b) adapter_bwd_rows_kernel<R, true><<<grid, AR_THREADS, 0, st>>>(p);
  else adapter_bwd_rows_kernel<R, false><<<grid, AR_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

struct AdapterWgradArgs {
  const bf16* o;         // [M, D]
  const bf16* g;         // [M, D]
  const bf16* relu_a;    // [M, R]
  const float* gdown_a;  // [M, R]
  float w_a;
  float* part;           // [chunks][2 R D + D + R]: dWu [R][D], dWd [D][R], dbu [D], dbd [R]
  int M, D, R;
};

// Partial sums over one chunk of AW_ROWS rows for AW_COLS columns of Dm:
// dWu[j][d] += relu_a[j] g_delta_a[d], dWd[d][j] += o[d] bf16(g_down_a[j]),
// dbu[d] += g_delta_a[d], dbd[j] += g_down_a[j] (the last in the x=0 blocks).
__global__ void __launch_bounds__(256) adapter_wgrad_kernel(AdapterWgradArgs p) {
  __shared__ float relu_s[AW_SUB][AD_MAX_R];
  __shared__ float gdn_s[AW_SUB][AD_MAX_R];
  __shared__ float gdf_s[AW_SUB][AD_MAX_R];
  __shared__ float gd_s[AW_SUB][AW_COLS];
  __shared__ float o_s[AW_SUB][AW_COLS];
  const int tid = threadIdx.x, dl = tid % AW_COLS, jg = tid / AW_COLS;
  const int d0 = blockIdx.x * AW_COLS, chunk = blockIdx.y;
  const bool bias_d = blockIdx.x == 0 && tid < p.R;
  float au[AW_JMAX], ad[AW_JMAX], abu = 0.f, abd = 0.f;
#pragma unroll
  for (int i = 0; i < AW_JMAX; ++i) au[i] = ad[i] = 0.f;
  const int r_begin = chunk * AW_ROWS, r_end = min(p.M, r_begin + AW_ROWS);
  for (int rs = r_begin; rs < r_end; rs += AW_SUB) {
    __syncthreads();
    for (int i = tid; i < AW_SUB * p.R; i += blockDim.x) {
      const int r = i / p.R, j = i % p.R, row = rs + r;
      const bool ok = row < r_end;
      const float gdv = ok ? p.gdown_a[(size_t)row * p.R + j] : 0.f;
      relu_s[r][j] = ok ? __bfloat162float(p.relu_a[(size_t)row * p.R + j]) : 0.f;
      gdf_s[r][j] = gdv;
      gdn_s[r][j] = round_bf16(gdv);
    }
    for (int i = tid; i < AW_SUB * AW_COLS; i += blockDim.x) {
      const int r = i / AW_COLS, c = i % AW_COLS, row = rs + r;
      const bool ok = row < r_end;
      const size_t off = (size_t)row * p.D + d0 + c;
      gd_s[r][c] = ok ? round_bf16(__bfloat162float(p.g[off]) * p.w_a) : 0.f;
      o_s[r][c] = ok ? __bfloat162float(p.o[off]) : 0.f;
    }
    __syncthreads();
    const int nr = min(AW_SUB, r_end - rs);
    for (int r = 0; r < nr; ++r) {
      const float gdv = gd_s[r][dl], ov = o_s[r][dl];
#pragma unroll
      for (int i = 0; i < AW_JMAX; ++i) {
        const int j = jg + 4 * i;
        if (j < p.R) {
          au[i] += relu_s[r][j] * gdv;
          ad[i] += ov * gdn_s[r][j];
        }
      }
      if (jg == 0) abu += gdv;
      if (bias_d) abd += gdf_s[r][tid];
    }
  }
  const size_t stride = (size_t)2 * p.R * p.D + p.D + p.R;
  float* out = p.part + chunk * stride;
#pragma unroll
  for (int i = 0; i < AW_JMAX; ++i) {
    const int j = jg + 4 * i;
    if (j < p.R) {
      out[(size_t)j * p.D + d0 + dl] = au[i];
      out[(size_t)p.R * p.D + (size_t)(d0 + dl) * p.R + j] = ad[i];
    }
  }
  if (jg == 0) out[(size_t)2 * p.R * p.D + d0 + dl] = abu;
  if (bias_d) out[(size_t)2 * p.R * p.D + p.D + tid] = abd;
}

// Adds the chunks' partial sums in chunk order (deterministic).
__global__ void adapter_wgrad_reduce_kernel(const float* __restrict__ part, int chunks, float* dwua,
                                            float* dwda, float* dbua, float* dbda, int D, int R) {
  const size_t rd = (size_t)R * D, stride = 2 * rd + D + R;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= stride) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[c * stride + idx];
  if (idx < rd) dwua[idx] = s;
  else if (idx < 2 * rd) dwda[idx - rd] = s;
  else if (idx < 2 * rd + D) dbua[idx - 2 * rd] = s;
  else dbda[idx - 2 * rd - D] = s;
}

// The workspace of layer_block_bwd: its buffers in order, each starting on a
// 256-byte boundary.  The only place that knows the layout.
enum WsBuffer {
  WS_H, WS_M, WS_O, WS_P1, WS_GE_GP1, WS_RELU_A, WS_GDOWN_A, WS_G_O, WS_G_M_DXLN, WS_G_H,
  WS_G_F, WS_G_ATT, WS_DCTX, WS_QKV, WS_DQKV, WS_DELTA, WS_PART, WS_COUNT
};

struct WsLayout {
  size_t off[WS_COUNT];
  size_t total;
};

WsLayout ws_layout(int B, int S, int Dm, int H, int F, int R) {
  const size_t M = (size_t)B * S, md = M * Dm, mf = M * F, mr = M * R;
  const size_t chunks = (M + AW_ROWS - 1) / AW_ROWS;
  const size_t bytes[WS_COUNT] = {
      md * 2, md * 2, md * 2,              // h, m, o
      mf * 4, mf * 2,                      // p1; ge, then g_p1
      mr * 2, mr * 4,                      // relu_a, g_down_a
      md * 4, md * 4, md * 4,              // g_o; g_m, then dxln; g_h
      md * 2, md * 2, md * 2,              // g_f, g_att, dctx
      md * 2 * 3, md * 2 * 3,              // qkv, dq|dk|dv
      (size_t)B * H * S * 4,               // delta
      chunks * (2 * (size_t)R * Dm + Dm + R) * 4,  // adapter partial sums
  };
  WsLayout l{};
  size_t off = 0;
  for (int i = 0; i < WS_COUNT; ++i) {
    l.off[i] = off;
    off += (bytes[i] + 255) / 256 * 256;
  }
  l.total = off;
  return l;
}

}  // namespace

using namespace port;

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int layer_block_max_bottleneck(void) { return AD_MAX_R; }

// Bytes of scratch layer_block_bwd needs at these shapes.
long long layer_block_bwd_workspace(int B, int S, int Dm, int H, int F, int R) {
  return (long long)ws_layout(B, S, Dm, H, F, R).total;
}

// Byte offsets in that scratch of what layer_block_bwd leaves there, rows
// M = B*S: h, m, o (bf16 [M, Dm]), p1 (fp32 [M, F]), relu_a (bf16 [M, R]),
// g_down_a (fp32 [M, R]) and g_o (fp32 [M, Dm]).
void layer_block_bwd_stage_offsets(int B, int S, int Dm, int H, int F, int R, long long* out) {
  const WsLayout l = ws_layout(B, S, Dm, H, F, R);
  const WsBuffer stages[7] = {WS_H, WS_M, WS_O, WS_P1, WS_RELU_A, WS_GDOWN_A, WS_G_O};
  for (int i = 0; i < 7; ++i) out[i] = (long long)l.off[stages[i]];
}

// Activations: x, aout, ctx [B, S, Dm] bf16; lse [B, H, S] f32; g [B, S, Dm]
// bf16; bias [B, S] f32 or null.  Frozen: wq..wo [Dm, Dm], w1 [F, Dm], w2 [Dm, F]
// bf16 (nn.Linear layout); bqkv [3, Dm], gb1/gb2 [2, Dm], b1 [F], b2 [Dm] f32.
// Adapters (flax layout): wda/wdb [Dm, R] and wua/wub [R, Dm] bf16, with
// wdaT/wdbT [R, Dm] (the down kernels transposed); bda/bdb [R] f32; R a
// multiple of 16.  Outputs: dx
// [B, S, Dm] bf16; dwda [Dm, R], dbda [R], dwua [R, Dm], dbua [Dm] f32.
int layer_block_bwd(const void* x, const void* aout, const void* ctx, const void* lse, const void* g,
                    const void* bias, const void* wq, const void* wk, const void* wv, const void* wo,
                    const void* bqkv, const void* gb1, const void* gb2, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* wda, const void* bda, const void* wua,
                    const void* wdaT, const void* wdb, const void* bdb, const void* wub,
                    const void* wdbT, void* workspace, void* dx, void* dwda, void* dbda, void* dwua,
                    void* dbua, int B, int S, int Dm, int H, int F, int R, float scale, float eps1,
                    float eps2, float w_a, float w_b, int use_b, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 16 || R % 16 || R > AD_MAX_R || Dm % AR_NCHUNK) return (int)cudaErrorInvalidValue;
  const int M = B * S;
  const WsLayout wl = ws_layout(B, S, Dm, H, F, R);
  char* ws = static_cast<char*>(workspace);
  auto buf = [&](WsBuffer i) { return ws + wl.off[i]; };
  bf16* h = reinterpret_cast<bf16*>(buf(WS_H));
  bf16* m = reinterpret_cast<bf16*>(buf(WS_M));
  bf16* o = reinterpret_cast<bf16*>(buf(WS_O));
  float* p1 = reinterpret_cast<float*>(buf(WS_P1));
  bf16* t_mf = reinterpret_cast<bf16*>(buf(WS_GE_GP1));  // ge, then g_p1
  bf16* relu_a = reinterpret_cast<bf16*>(buf(WS_RELU_A));
  float* gdown_a = reinterpret_cast<float*>(buf(WS_GDOWN_A));
  float* g_o = reinterpret_cast<float*>(buf(WS_G_O));
  float* g_m = reinterpret_cast<float*>(buf(WS_G_M_DXLN));  // g_m, then dxln
  float* g_h = reinterpret_cast<float*>(buf(WS_G_H));
  bf16* g_f = reinterpret_cast<bf16*>(buf(WS_G_F));
  bf16* g_att = reinterpret_cast<bf16*>(buf(WS_G_ATT));
  bf16* dctx = reinterpret_cast<bf16*>(buf(WS_DCTX));
  bf16* qkv = reinterpret_cast<bf16*>(buf(WS_QKV));
  bf16* dqkv = reinterpret_cast<bf16*>(buf(WS_DQKV));
  float* delta = reinterpret_cast<float*>(buf(WS_DELTA));
  const int chunks = (M + AW_ROWS - 1) / AW_ROWS;
  float* part = reinterpret_cast<float*>(buf(WS_PART));
  const float* gamma1 = static_cast<const float*>(gb1);
  const float* gamma2 = static_cast<const float*>(gb2);
  int err;

  // 1. h, m
  ln2_fwd_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(aout),
                                                    gamma2, gamma2 + Dm, eps2, h, m, M, Dm);
  if ((err = (int)cudaGetLastError())) return err;

  // 2. p1 = m.W1^T + b1 (fp32) with ge = bf16(gelu(p1)); o = bf16(h + bf16(ge.W2^T + b2))
  GemmArgs f1{};
  f1.a[0] = m;
  f1.lda = Dm;
  f1.b[0] = static_cast<const bf16*>(w1);
  f1.ldb = Dm;
  f1.M = M;
  f1.N = F;
  f1.K = Dm;
  f1.bias[0] = static_cast<const float*>(b1);
  f1.c_f32 = p1;
  f1.c_bf16[0] = t_mf;
  if ((err = launch_gemm<B_NT, EPI_FFN1>(f1, st))) return err;
  GemmArgs f2{};
  f2.a[0] = t_mf;
  f2.lda = F;
  f2.b[0] = static_cast<const bf16*>(w2);
  f2.ldb = F;
  f2.M = M;
  f2.N = Dm;
  f2.K = F;
  f2.bias[0] = static_cast<const float*>(b2);
  f2.aux_bf16 = h;
  f2.c_bf16[0] = o;
  if ((err = launch_gemm<B_NT, EPI_FFN2>(f2, st))) return err;

  // 3. adapter backward: rows, then deterministic weight-gradient sums
  AdapterBwdArgs ab{};
  ab.o = o;
  ab.g = static_cast<const bf16*>(g);
  ab.wda = static_cast<const bf16*>(wda);
  ab.wdb = static_cast<const bf16*>(wdb);
  ab.wdaT = static_cast<const bf16*>(wdaT);
  ab.wdbT = static_cast<const bf16*>(wdbT);
  ab.wua = static_cast<const bf16*>(wua);
  ab.wub = static_cast<const bf16*>(wub);
  ab.bda = static_cast<const float*>(bda);
  ab.bdb = static_cast<const float*>(bdb);
  ab.w_a = w_a;
  ab.w_b = w_b;
  ab.relu_a = relu_a;
  ab.gdown_a = gdown_a;
  ab.g_o = g_o;
  ab.g_f = g_f;
  ab.M = M;
  ab.D = Dm;
  switch (R) {
    case 16: err = launch_adapter_rows<16>(ab, use_b, st); break;
    case 32: err = launch_adapter_rows<32>(ab, use_b, st); break;
    case 48: err = launch_adapter_rows<48>(ab, use_b, st); break;
    default: err = launch_adapter_rows<64>(ab, use_b, st); break;
  }
  if (err) return err;
  AdapterWgradArgs aw{};
  aw.o = o;
  aw.g = static_cast<const bf16*>(g);
  aw.relu_a = relu_a;
  aw.gdown_a = gdown_a;
  aw.w_a = w_a;
  aw.part = part;
  aw.M = M;
  aw.D = Dm;
  aw.R = R;
  adapter_wgrad_kernel<<<dim3(Dm / AW_COLS, chunks), 256, 0, st>>>(aw);
  if ((err = (int)cudaGetLastError())) return err;
  const size_t outs = (size_t)2 * R * Dm + Dm + R;
  adapter_wgrad_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
      part, chunks, static_cast<float*>(dwua), static_cast<float*>(dwda), static_cast<float*>(dbua),
      static_cast<float*>(dbda), Dm, R);
  if ((err = (int)cudaGetLastError())) return err;

  // 4. g_p1 = bf16((g_f.W2) * gelu'(p1)); g_m = g_p1.W1
  GemmArgs b2g{};
  b2g.a[0] = g_f;
  b2g.lda = Dm;
  b2g.b[0] = static_cast<const bf16*>(w2);
  b2g.ldb = F;
  b2g.M = M;
  b2g.N = F;
  b2g.K = Dm;
  b2g.aux_f32 = p1;
  b2g.c_bf16[0] = t_mf;
  if ((err = launch_gemm<B_NN, EPI_GELU_BWD>(b2g, st))) return err;
  GemmArgs b1g{};
  b1g.a[0] = t_mf;
  b1g.lda = F;
  b1g.b[0] = static_cast<const bf16*>(w1);
  b1g.ldb = Dm;
  b1g.M = M;
  b1g.N = Dm;
  b1g.K = F;
  b1g.c_f32 = g_m;
  if ((err = launch_gemm<B_NN, EPI_F32>(b1g, st))) return err;

  // 5. g_h = g_o + LN2_bwd(g_m), g_att = bf16(g_h)
  if ((err = launch_ln_bwd_rows(h, gamma2, eps2, g_m, g_o, g_att, g_h, M, Dm, st))) return err;

  // 6. attention backward to dxln (into the g_m buffer)
  AttnBwdProblem a{};
  a.x = static_cast<const bf16*>(x);
  a.wq = static_cast<const bf16*>(wq);
  a.wk = static_cast<const bf16*>(wk);
  a.wv = static_cast<const bf16*>(wv);
  a.wo = static_cast<const bf16*>(wo);
  a.bqkv = static_cast<const float*>(bqkv);
  a.gamma = gamma1;
  a.beta = gamma1 + Dm;
  a.ln_eps = eps1;
  a.bias = static_cast<const float*>(bias);
  a.ctx = static_cast<const bf16*>(ctx);
  a.lse = static_cast<const float*>(lse);
  a.g_att = g_att;
  a.qkv = qkv;
  a.dqkv = dqkv;
  a.dctx = dctx;
  a.delta = delta;
  a.B = B;
  a.S = S;
  a.Dm = Dm;
  a.H = H;
  a.scale = scale;
  if ((err = attn_bwd_to_dxln(a, 0, nullptr, g_m, st))) return err;

  // 7. dx = bf16(LN1_bwd(dxln) + g_h)
  return launch_ln_bwd_rows(static_cast<const bf16*>(x), gamma1, eps1, g_m, g_h, static_cast<bf16*>(dx),
                            nullptr, M, Dm, st);
}

}  // extern "C"
