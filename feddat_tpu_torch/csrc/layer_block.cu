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
//   2. the FFN recompute on wgmma (gemm_sm90.cuh, as every product of steps
//      2, 4 and 6): p1 = m.W1^T + b1 kept fp32 with ge = bf16(gelu(p1)) in
//      the same epilogue, then o = bf16(h + bf16(ge.W2^T + b2));
//   3. adapter_bwd_rows_kernel: both members' down projections, the active
//      adapter's relu and g_down, and g_o = g + g_down.Wd^T (bf16 values
//      with fp32 sums on the tensor cores, mma.sync; 16 rows per block, Dm
//      split over its four warps);
//      adapter_wgrad_kernel writes per-chunk partial sums of the weight
//      gradients (dWu = relu_a^T . g_delta_a and dWd = o^T . bf16(g_down_a),
//      bf16 values with fp32 sums on the tensor cores) and
//      adapter_wgrad_reduce_kernel adds them in a fixed order, so two runs
//      give bitwise the same gradients (no float atomics);
//   4. g_p1 = bf16((g_f.W2) * gelu'(p1)) (GEMM epilogue), g_m = g_p1.W1;
//   5. ln_bwd_rows_kernel: g_h = g_o + LN2_bwd(g_m), g_att = bf16(g_h);
//   6. the attention backward of attn_bwd.cuh (shared with kernel #3) to dxln,
//      LN1 written once as bf16(LN1(x)) by a row pass, the per-head part on
//      attn_sm90.cuh's wgmma kernels (the code of #6; any S);
//   7. ln_bwd_rows_kernel: dx = bf16(LN1_bwd(dxln) + g_h).
// p1 (fp32, 145 MB at the training shape) goes through device memory: fusing
// steps 2 and 4 so that it never does would recompute m.W1^T (56 GFLOP) to
// save ~290 MB of traffic, an even trade.

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
constexpr int AW_ROWS = 256;    // rows per chunk of the weight-gradient partial sums
constexpr int AW_COLS = 64;     // Dm columns per block: 4 warps x 16
constexpr int AW_SUB = 64;      // rows staged at a time
constexpr int AW_THREADS = 128;
constexpr int AW_LD = AW_COLS + 8;  // padded smem row (bf16)
constexpr int AD_MAX_R = 64;    // largest bottleneck r (a multiple of 16)
constexpr int AR_ROWS = 16;      // rows per block of the row pass
constexpr int AR_WARPS = 4;      // warps per block, each a quarter of Dm
constexpr int AR_THREADS = 32 * AR_WARPS;
constexpr int AR_GROUP = 4;      // 8-column tiles of g_o whose reads go together
constexpr int AR_DM_MULTIPLE = AR_WARPS * 8 * AR_GROUP;  // Dm must be a multiple

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

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The m16n8k16 A fragment of rows r and r + 8, columns k..k+15, of a
// row-major bf16 matrix with row stride ld; rows at or past M read as 0.
__device__ __forceinline__ void a_frag_rows(uint32_t (&a)[4], const bf16* x, int ld, int r, int M, int k,
                                            int tig) {
  const bf16* p0 = x + (size_t)r * ld + k + tig * 2;
  a[0] = r < M ? ldg32(p0) : 0u;
  a[2] = r < M ? ldg32(p0 + 8) : 0u;
  a[1] = r + 8 < M ? ldg32(p0 + (size_t)8 * ld) : 0u;
  a[3] = r + 8 < M ? ldg32(p0 + (size_t)8 * ld + 8) : 0u;
}

// The m16n8k16 B fragment of a [N][K] row-major bf16 matrix (row n = output
// column, K contiguous, row stride ld): row n, columns k..k+15.
__device__ __forceinline__ void b_frag_rows(uint32_t (&b)[2], const bf16* w, int ld, int n, int k, int tig) {
  const bf16* p0 = w + (size_t)n * ld + k + tig * 2;
  b[0] = ldg32(p0);
  b[1] = ldg32(p0 + 8);
}

// The adapters' row pass on tensor cores (all three products take bf16
// values with fp32 sums, as on the TPU).  A block owns 16 rows; each of its
// four warps one quarter of Dm:
//   down   = o . Wd + bd               for both members (N = 2R)
//   g_relu = bf16(g w) . Wu^T          for each member with its own w
// each warp over its quarter, its fragments read straight from device memory
// (the weights from L1/L2); the four partial sums are added through shared
// memory in warp order, so every warp holds the same full sums;
//   g_down = down > 0 ? g_relu : 0     (its C fragments are the A fragments of)
//   g_o    = (g + bf16(g_down_a) . Wda^T) [+ bf16(g_down_b) . Wdb^T]
// each warp for its quarter of the columns.  The TPU kernel's rows run in
// order; here 740 blocks of short chains run side by side (a 64-row block
// streaming all of Dm through shared memory kept one or two blocks per SM
// and took 0.14 ms at the training shape).
template <int R, bool USE_B>
__global__ void __launch_bounds__(AR_THREADS) adapter_bwd_rows_kernel(AdapterBwdArgs p) {
  constexpr int NM = USE_B ? 2 : 1;  // members
  constexpr int NT = R / 8;          // n-tiles of one member
  constexpr int NACC = NM * NT * 4;  // one lane's share of a [16][NM R] accumulator
  __shared__ float red[AR_WARPS][NACC][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r_top = blockIdx.x * AR_ROWS + g, r_bot = r_top + 8;
  const int quarter = p.D / AR_WARPS, d0 = warp * quarter;

  float down[NM][NT][4], grelu[NM][NT][4];
#pragma unroll
  for (int a = 0; a < NM; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) down[a][nt][e] = grelu[a][nt][e] = 0.f;

  for (int k = d0; k < d0 + quarter; k += 16) {
    uint32_t ao[4], araw[4];
    a_frag_rows(ao, p.o, p.D, r_top, p.M, k, tig);
    a_frag_rows(araw, p.g, p.D, r_top, p.M, k, tig);
#pragma unroll
    for (int a = 0; a < NM; ++a) {
      const float w = a ? p.w_b : p.w_a;
      uint32_t ag[4];  // bf16(g w)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&araw[i]);
        ag[i] = pack_bf16(__low2float(v) * w, __high2float(v) * w);
      }
      const bf16* wdT = a ? p.wdbT : p.wdaT;
      const bf16* wu = a ? p.wub : p.wua;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bd[2], bu[2];
        b_frag_rows(bd, wdT, p.D, nt * 8 + g, k, tig);
        b_frag_rows(bu, wu, p.D, nt * 8 + g, k, tig);
        mma_16816(down[a][nt], ao, bd);
        mma_16816(grelu[a][nt], ag, bu);
      }
    }
  }

  // the quarters' partial sums, added in warp order (the same in every warp)
  auto reduce = [&](float (&acc)[NM][NT][4]) {
#pragma unroll
    for (int a = 0; a < NM; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][(a * NT + nt) * 4 + e][lane] = acc[a][nt][e];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NM; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (a * NT + nt) * 4 + e;
          float v = red[0][i][lane];
#pragma unroll
          for (int w = 1; w < AR_WARPS; ++w) v += red[w][i][lane];
          acc[a][nt][e] = v;
        }
    __syncthreads();
  };
  reduce(down);
  reduce(grelu);

  // gate; warp 0 writes relu_a and g_down_a; bf16(g_down) kept as A fragments
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
      if (a == 0 && warp == 0) {
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

  // g_o = (g + bf16(g_down_a) . Wda^T) [+ bf16(g_down_b) . Wdb^T] over this
  // warp's quarter, AR_GROUP column tiles at a time: a group's reads of g go
  // before its stores
  const int rows[2] = {r_top, r_bot};
  for (int n0 = d0; n0 < d0 + quarter; n0 += 8 * AR_GROUP) {
    __nv_bfloat162 gv[AR_GROUP][2];
#pragma unroll
    for (int t = 0; t < AR_GROUP; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        gv[t][h] = rows[h] < p.M
                       ? *reinterpret_cast<const __nv_bfloat162*>(p.g + (size_t)rows[h] * p.D + n0 + t * 8 + tig * 2)
                       : __floats2bfloat162_rn(0.f, 0.f);
    float acc[NM][AR_GROUP][4];
#pragma unroll
    for (int a = 0; a < NM; ++a) {
      const bf16* wd = a ? p.wdb : p.wda;
#pragma unroll
      for (int t = 0; t < AR_GROUP; ++t) {
        acc[a][t][0] = acc[a][t][1] = acc[a][t][2] = acc[a][t][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < R / 16; ++ks) {
          uint32_t b[2];
          b_frag_rows(b, wd, R, n0 + t * 8 + g, ks * 16, tig);
          mma_16816(acc[a][t], gdn[a][ks], b);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < AR_GROUP; ++t) {
      const int col = n0 + t * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= p.M) continue;
        const size_t off = (size_t)rows[h] * p.D + col;
        float v0 = __low2float(gv[t][h]) + acc[0][t][2 * h];
        float v1 = __high2float(gv[t][h]) + acc[0][t][2 * h + 1];
        if (USE_B) {
          v0 += acc[NM - 1][t][2 * h];
          v1 += acc[NM - 1][t][2 * h + 1];
        }
        *reinterpret_cast<float2*>(p.g_o + off) = make_float2(v0, v1);
        *reinterpret_cast<uint32_t*>(p.g_f + off) = pack_bf16(v0, v1);
      }
    }
  }
}

struct AdapterWgradArgs {
  const bf16* o;         // [M, D]
  const bf16* g;         // [M, D]
  const bf16* relu_a;    // [M, R]
  const float* gdown_a;  // [M, R]
  float w_a;
  float* part;           // [chunks][2 R D + D + R]: dWu [R][D], dWd [D][R], dbu [D], dbd [R]
  int M, D;
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Partial sums over one chunk of AW_ROWS rows for AW_COLS columns of Dm, on
// the tensor cores (every operand is a bf16 value, every sum fp32):
//   dWu^T[d][j] = sum_rows g_delta_a[d] relu_a[j],  g_delta_a = bf16(g w_a)
//   dWd[d][j]   = sum_rows o[d] bf16(g_down_a[j])
// i.e. C[64 d][R] = X^T . Y with X [rows][d] and Y [rows][j] as they lie in
// memory: the rows are the products' K, so both operands are read transposed
// from their natural tiles by ldmatrix.trans.  Warp w owns d rows 16w..16w+15.
// dbu[d] += g_delta_a[d] and dbd[j] += g_down_a[j] (the latter in the x = 0
// blocks) are summed row by row in fp32.
template <int R>
__global__ void __launch_bounds__(AW_THREADS) adapter_wgrad_kernel(AdapterWgradArgs p) {
  constexpr int RL = R + 8;  // padded smem row of the [rows][R] tiles (bf16)
  __shared__ __align__(16) bf16 Xo[AW_SUB * AW_LD];  // o
  __shared__ __align__(16) bf16 Xg[AW_SUB * AW_LD];  // g_delta_a
  __shared__ __align__(16) bf16 Yr[AW_SUB * RL];     // relu_a
  __shared__ __align__(16) bf16 Yd[AW_SUB * RL];     // bf16(g_down_a)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = blockIdx.x * AW_COLS, chunk = blockIdx.y;
  const int r_begin = chunk * AW_ROWS, r_end = min(p.M, r_begin + AW_ROWS);
  float du[R / 8][4], dd[R / 8][4];
#pragma unroll
  for (int nt = 0; nt < R / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) du[nt][e] = dd[nt][e] = 0.f;
  float abu = 0.f, abd = 0.f;
  // ldmatrix row addresses: thread t feeds row t % 8 of 8x8 matrix t / 8
  const int mi = lane >> 3, mr = lane & 7;
  const int xa = (mr + ((mi >> 1) << 3)) * AW_LD + warp * 16 + ((mi & 1) << 3);  // A: (k, m) blocks
  const int ya = (mr + ((mi & 1) << 3)) * RL + ((mi >> 1) << 3);                 // B: (k, n) blocks

  for (int rs = r_begin; rs < r_end; rs += AW_SUB) {
    __syncthreads();
    for (int i = tid; i < AW_SUB * (AW_COLS / 8); i += AW_THREADS) {
      const int r = i / (AW_COLS / 8), c = (i % (AW_COLS / 8)) * 8, row = rs + r;
      uint4 vo = make_uint4(0u, 0u, 0u, 0u), vg = vo;
      if (row < r_end) {
        vo = *reinterpret_cast<const uint4*>(p.o + (size_t)row * p.D + d0 + c);
        vg = *reinterpret_cast<const uint4*>(p.g + (size_t)row * p.D + d0 + c);
      }
      bf16* ge = reinterpret_cast<bf16*>(&vg);
#pragma unroll
      for (int t = 0; t < 8; ++t) ge[t] = __float2bfloat16_rn(__bfloat162float(ge[t]) * p.w_a);
      *reinterpret_cast<uint4*>(Xo + r * AW_LD + c) = vo;
      *reinterpret_cast<uint4*>(Xg + r * AW_LD + c) = vg;
    }
    for (int i = tid; i < AW_SUB * (R / 8); i += AW_THREADS) {
      const int r = i / (R / 8), c = (i % (R / 8)) * 8, row = rs + r;
      uint4 vr = make_uint4(0u, 0u, 0u, 0u), vd = vr;
      if (row < r_end) {
        vr = *reinterpret_cast<const uint4*>(p.relu_a + (size_t)row * R + c);
        const float4 a = *reinterpret_cast<const float4*>(p.gdown_a + (size_t)row * R + c);
        const float4 b = *reinterpret_cast<const float4*>(p.gdown_a + (size_t)row * R + c + 4);
        vd = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(Yr + r * RL + c) = vr;
      *reinterpret_cast<uint4*>(Yd + r * RL + c) = vd;
    }
    __syncthreads();
    const int nr = min(AW_SUB, r_end - rs);
    if (tid < AW_COLS)
      for (int r = 0; r < nr; ++r) abu += __bfloat162float(Xg[r * AW_LD + tid]);
    if (blockIdx.x == 0 && tid < R)
      for (int r = 0; r < nr; ++r) abd += p.gdown_a[(size_t)(rs + r) * R + tid];
#pragma unroll
    for (int ks = 0; ks < AW_SUB / 16; ++ks) {
      uint32_t ao[4], ag[4];
      ldsm_x4_trans(ao, Xo + ks * 16 * AW_LD + xa);
      ldsm_x4_trans(ag, Xg + ks * 16 * AW_LD + xa);
#pragma unroll
      for (int np = 0; np < R / 16; ++np) {
        uint32_t br[4], bd[4];
        ldsm_x4_trans(br, Yr + ks * 16 * RL + np * 16 + ya);
        ldsm_x4_trans(bd, Yd + ks * 16 * RL + np * 16 + ya);
        const uint32_t br0[2] = {br[0], br[1]}, br1[2] = {br[2], br[3]};
        const uint32_t bd0[2] = {bd[0], bd[1]}, bd1[2] = {bd[2], bd[3]};
        mma_16816(du[2 * np], ag, br0);
        mma_16816(du[2 * np + 1], ag, br1);
        mma_16816(dd[2 * np], ao, bd0);
        mma_16816(dd[2 * np + 1], ao, bd1);
      }
    }
  }
  const size_t rd = (size_t)R * p.D;
  float* out = p.part + chunk * (2 * rd + p.D + R);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < R / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + warp * 16 + g + 8 * (e >> 1), j = nt * 8 + tig * 2 + (e & 1);
      out[(size_t)j * p.D + d] = du[nt][e];
      out[rd + (size_t)d * R + j] = dd[nt][e];
    }
  if (tid < AW_COLS) out[2 * rd + d0 + tid] = abu;
  if (blockIdx.x == 0 && tid < R) out[2 * rd + p.D + tid] = abd;
}

// The adapter backward's row pass, then the chunks' weight-gradient partial
// sums, on `st`.
template <int R>
int launch_adapter_bwd(const AdapterBwdArgs& ab, const AdapterWgradArgs& aw, bool use_b, int chunks,
                       cudaStream_t st) {
  const dim3 grid((ab.M + AR_ROWS - 1) / AR_ROWS);
  if (use_b) adapter_bwd_rows_kernel<R, true><<<grid, AR_THREADS, 0, st>>>(ab);
  else adapter_bwd_rows_kernel<R, false><<<grid, AR_THREADS, 0, st>>>(ab);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  adapter_wgrad_kernel<R><<<dim3(aw.D / AW_COLS, chunks), AW_THREADS, 0, st>>>(aw);
  return (int)cudaGetLastError();
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
  WS_G_F, WS_G_ATT, WS_DCTX, WS_QKV, WS_DQKV, WS_DELTA, WS_PART, WS_XLN, WS_COUNT
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
      md * 2,                              // bf16(LN1(x))
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
  if (R < 16 || R % 16 || R > AD_MAX_R || Dm % AR_DM_MULTIPLE) return (int)cudaErrorInvalidValue;
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
  if ((err = launch_gemm_sm90<B_NT, EPI_FFN1>(f1, st))) return err;
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
  if ((err = launch_gemm_sm90<B_NT, EPI_FFN2>(f2, st))) return err;

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
  AdapterWgradArgs aw{};
  aw.o = o;
  aw.g = static_cast<const bf16*>(g);
  aw.relu_a = relu_a;
  aw.gdown_a = gdown_a;
  aw.w_a = w_a;
  aw.part = part;
  aw.M = M;
  aw.D = Dm;
  switch (R) {
    case 16: err = launch_adapter_bwd<16>(ab, aw, use_b, chunks, st); break;
    case 32: err = launch_adapter_bwd<32>(ab, aw, use_b, chunks, st); break;
    case 48: err = launch_adapter_bwd<48>(ab, aw, use_b, chunks, st); break;
    default: err = launch_adapter_bwd<64>(ab, aw, use_b, chunks, st); break;
  }
  if (err) return err;
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
  if ((err = launch_gemm_sm90<B_NN, EPI_GELU_BWD>(b2g, st))) return err;
  GemmArgs b1g{};
  b1g.a[0] = t_mf;
  b1g.lda = F;
  b1g.b[0] = static_cast<const bf16*>(w1);
  b1g.ldb = Dm;
  b1g.M = M;
  b1g.N = Dm;
  b1g.K = F;
  b1g.c_f32 = g_m;
  if ((err = launch_gemm_sm90<B_NN, EPI_F32>(b1g, st))) return err;

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
  a.xln = reinterpret_cast<bf16*>(buf(WS_XLN));
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
