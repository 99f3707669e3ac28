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
//
// Any bottleneck R >= 1.  The wrapper zero-pads R to Rp = nc chunks of one
// width Rc <= AD_CHUNK (a multiple of 16; R = 96 is two of 48, R = 192 three
// of 64): a padded down column gives relu(0) = 0 and a closed gate, so it adds
// nothing to g_o, and its gradients are dropped.  Step 3 runs once per chunk
// on the chunk's columns: the row pass keeps g_o's fp32 sums in device memory
// between chunks (each chunk adds its products in one fp32 add; the last
// writes g_f), and the weight gradients' partial sums of each chunk go to
// their own columns of the same per-row-chunk scratch, so their summation
// order is that of one chunk.
//
// Either element type: bf16 as above, or fp32 (the TPU kernel run in
// float32), where nothing rounds (h, m, o, relu_a, g_delta_a, g_f, g_p1,
// g_att and the attention's intermediates are fp32) and every product is the
// six bf16 term products of its operands' splits (common.cuh): the GEMMs' and
// the attention's activation operands are split into device-memory planes
// first, the weights once per call, and the adapter kernels split their
// fragments in registers (chunks of 16 columns, AD_CHUNK_F32, so the row
// pass's fragments and accumulators stay in registers).  The adapter
// kernels' mma.sync sums the five small term products in an accumulator of
// their own, added to the main one at the end: into the main one, each
// would round at its magnitude (8.6x the plain fp32 version's error in dWu
// at the training shape, PERF.md §6).

#include "attn_bwd.cuh"

namespace {

using namespace port;

// ----------------------------------------------------------------- step 1
template <typename T>
__global__ void ln2_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ aout,
                                    const float* __restrict__ gamma, const float* __restrict__ beta,
                                    float eps, T* __restrict__ h, T* __restrict__ m, int M, int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t off = (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float hv = round_t<T>(to_f(x[off + k]) + to_f(aout[off + k]));
    h[off + k] = from_f<T>(hv);
    s += hv;
    ss += hv * hv;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float rstd = rsqrtf(fmaxf(ss / (float)D - mu * mu, 0.f) + eps);
  for (int k = lane; k < D; k += 32) {
    const float hv = to_f(h[off + k]);
    m[off + k] = from_f<T>(__fadd_rn(__fmul_rn(__fmul_rn(hv - mu, rstd), gamma[k]), beta[k]));
  }
}

// ----------------------------------------------------------------- step 3
constexpr int AW_ROWS = 256;    // rows per chunk of the weight-gradient partial sums
constexpr int AW_COLS = 64;     // Dm columns per block: 4 warps x 16
constexpr int AW_SUB = 64;      // rows staged at a time (bf16; fp32 stages 16)
constexpr int AW_THREADS = 128;
constexpr int AW_LD = AW_COLS + 8;  // padded smem row (bf16)
constexpr int AD_CHUNK = 64;      // most bottleneck columns of one chunk (bf16)
constexpr int AD_CHUNK_F32 = 16;  // fp32: three terms of each fragment in registers
constexpr int AR_ROWS = 16;      // rows per block of the row pass
constexpr int AR_WARPS = 4;      // warps per block, each a quarter of Dm
constexpr int AR_THREADS = 32 * AR_WARPS;
constexpr int AR_GROUP = 4;      // 8-column tiles of g_o whose reads go together
constexpr int AR_DM_MULTIPLE = AR_WARPS * 8 * AR_GROUP;  // the width the adapter kernels walk

// The width the adapter kernels run at: Dm rounded up to AR_DM_MULTIPLE.  At
// another Dm (192, 48, ...) o and g are copied into zero-padded [M, Dw]
// planes and g_o and g_f copied back (pad_cols_kernel), and the caller gives
// the adapters' weights zero-padded to Dw (ops/layer_block.py): a padded
// column of o or g, and a zero row of Wd or column of Wu, adds nothing to
// down, g_relu or g_o, and its gradients are dropped by the caller.
inline int adapter_width(int Dm) { return (Dm + AR_DM_MULTIPLE - 1) / AR_DM_MULTIPLE * AR_DM_MULTIPLE; }

// The bottleneck's chunks: as few as take at most `most` columns each, all of
// one width, a multiple of 16 (ops/layer_block.py pads R to their sum).
inline int chunk_count(int R, int most) { return (R + most - 1) / most; }
inline int chunk_width(int R, int most) {
  const int n = chunk_count(R, most);
  return ((R + n - 1) / n + 15) / 16 * 16;
}

struct AdapterBwdArgs {
  const void* o;              // [M, D] recomputed o
  const void* g;              // [M, D] d out
  const void *wda, *wdb;      // [D, Rp] down kernels (flax layout)
  const void *wdaT, *wdbT;    // [Rp, D] down kernels, transposed
  const void *wua, *wub;      // [Rp, D] up kernels (flax layout)
  const float *bda, *bdb;     // [Rp]
  float w_a, w_b;
  void* relu_a;               // [M, Rp]
  float* gdown_a;             // [M, Rp]
  float* g_o;                 // [M, D]: g + the chunks' products so far
  void* g_f;                  // [M, D]
  int M, D, Rp;
  int j0;                     // the chunk's first bottleneck column
  int first, last;            // the chunk is the bottleneck's first, last
};

// The m16n8k16 A fragment of rows r and r + 8, columns k..k+15, of a
// row-major matrix with row stride ld, each value times `mul`, as NT bf16
// terms (NT = 1: the value rounded to bf16); rows at or past M read as 0.
template <int NT, typename T>
__device__ __forceinline__ void a_frag_terms(uint32_t (&a)[NT][4], const T* x, int ld, int r, int M, int k,
                                             int tig, float mul) {
  const T* p0 = x + (size_t)r * ld + k + tig * 2;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 v[4] = {r < M ? load2(p0) : zero, r + 8 < M ? load2(p0 + (size_t)8 * ld) : zero,
                       r < M ? load2(p0 + 8) : zero, r + 8 < M ? load2(p0 + (size_t)8 * ld + 8) : zero};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t[NT];
    split_pack<NT>(v[i].x * mul, v[i].y * mul, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) a[n][i] = t[n];
  }
}

// The m16n8k16 B fragment of a [N][K] row-major matrix (row n = output
// column, K contiguous, row stride ld): row n, columns k..k+15, as NT terms.
template <int NT, typename T>
__device__ __forceinline__ void b_frag_terms(uint32_t (&b)[NT][2], const T* w, int ld, int n, int k, int tig) {
  const T* p0 = w + (size_t)n * ld + k + tig * 2;
  const float2 v[2] = {load2(p0), load2(p0 + 8)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t t[NT];
    split_pack<NT>(v[i].x, v[i].y, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n][i] = t[n];
  }
}

// c += A . B over one 16-deep step, A and B as NT terms: the main term
// product hi.hi into c, the five small ones (common.cuh's pair order) into cs, which the
// caller adds to c once its sums are done (so they round at their own
// magnitude, 2^-8 of c's); cs is untouched for NT = 1.
template <int NT>
__device__ __forceinline__ void mma_terms(float* c, float* cs, const uint32_t (&a)[NT][4],
                                          const uint32_t (&b)[NT][2]) {
  if constexpr (NT == 3) {
#pragma unroll
    for (int pr = 0; pr < 5; ++pr) mma_16816(cs, a[pair_a(pr)], b[pair_b(pr)]);
  }
  mma_16816(c, a[0], b[0]);
}

// c += cs over n values (the small term products' sums, NT = 3)
template <int NT, int N>
__device__ __forceinline__ void add_small(float (&c)[N], const float (&cs)[N]) {
  if constexpr (NT == 3) {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] += cs[i];
  }
}

// The adapters' row pass on tensor cores for one chunk of RC bottleneck
// columns (all three products take T values with fp32 sums, as on the TPU:
// bf16 values, or fp32 ones as their three bf16 terms).  A block owns 16
// rows; each of its four warps one quarter of Dm:
//   down   = o . Wd + bd               for both members (N = 2 RC)
//   g_relu = T(g w) . Wu^T             for each member with its own w
// each warp over its quarter, its fragments read straight from device memory
// (the weights from L1/L2); the four partial sums are added through shared
// memory in warp order, so every warp holds the same full sums;
//   g_down = down > 0 ? g_relu : 0     (its C fragments are the A fragments of)
//   g_o    = (g + T(g_down_a) . Wda^T) [+ T(g_down_b) . Wdb^T]
// each warp for its quarter of the columns; a chunk after the first adds its
// products to the g_o the chunks before left, and the last writes g_f.  The
// TPU kernel's rows run in order; here 740 blocks of short chains run side by
// side (a 64-row block streaming all of Dm through shared memory kept one or
// two blocks per SM and took 0.14 ms at the training shape).
template <int RC, bool USE_B, typename T>
__global__ void __launch_bounds__(AR_THREADS) adapter_bwd_rows_kernel(AdapterBwdArgs p) {
  constexpr int NT = kTerms<T>;
  constexpr int NM = USE_B ? 2 : 1;  // members
  constexpr int NTL = RC / 8;        // n-tiles of one member
  constexpr int NACC = NM * NTL * 4; // one lane's share of a [16][NM RC] accumulator
  __shared__ float red[AR_WARPS][NACC][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r_top = blockIdx.x * AR_ROWS + g, r_bot = r_top + 8;
  const int quarter = p.D / AR_WARPS, d0 = warp * quarter;
  const T* o = static_cast<const T*>(p.o);
  const T* gin = static_cast<const T*>(p.g);

  float down[NM][NTL][4], grelu[NM][NTL][4], down_s[NM][NTL][4], grelu_s[NM][NTL][4];
#pragma unroll
  for (int a = 0; a < NM; ++a)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) down[a][nt][e] = grelu[a][nt][e] = down_s[a][nt][e] = grelu_s[a][nt][e] = 0.f;

  for (int k = d0; k < d0 + quarter; k += 16) {
    uint32_t ao[NT][4];
    a_frag_terms<NT>(ao, o, p.D, r_top, p.M, k, tig, 1.f);
#pragma unroll
    for (int a = 0; a < NM; ++a) {
      uint32_t ag[NT][4];  // T(g w)
      a_frag_terms<NT>(ag, gin, p.D, r_top, p.M, k, tig, a ? p.w_b : p.w_a);
      const T* wdT = static_cast<const T*>(a ? p.wdbT : p.wdaT);
      const T* wu = static_cast<const T*>(a ? p.wub : p.wua);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        uint32_t bd[NT][2], bu[NT][2];
        b_frag_terms<NT>(bd, wdT, p.D, p.j0 + nt * 8 + g, k, tig);
        b_frag_terms<NT>(bu, wu, p.D, p.j0 + nt * 8 + g, k, tig);
        mma_terms<NT>(down[a][nt], down_s[a][nt], ao, bd);
        mma_terms<NT>(grelu[a][nt], grelu_s[a][nt], ag, bu);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NM; ++a)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      add_small<NT>(down[a][nt], down_s[a][nt]);
      add_small<NT>(grelu[a][nt], grelu_s[a][nt]);
    }

  // the quarters' partial sums, added in warp order (the same in every warp)
  auto reduce = [&](float (&acc)[NM][NTL][4]) {
#pragma unroll
    for (int a = 0; a < NM; ++a)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][(a * NTL + nt) * 4 + e][lane] = acc[a][nt][e];
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NM; ++a)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (a * NTL + nt) * 4 + e;
          float v = red[0][i][lane];
#pragma unroll
          for (int w = 1; w < AR_WARPS; ++w) v += red[w][i][lane];
          acc[a][nt][e] = v;
        }
    __syncthreads();
  };
  reduce(down);
  reduce(grelu);

  // gate; warp 0 writes relu_a and g_down_a; T(g_down) kept as A fragments
  T* relu_a = static_cast<T*>(p.relu_a);
  uint32_t gdn[NM][RC / 16][NT][4];
#pragma unroll
  for (int a = 0; a < NM; ++a) {
    const float* bias = a ? p.bdb : p.bda;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int j = p.j0 + nt * 8 + tig * 2;
      float gd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dn = down[a][nt][e] + bias[j + (e & 1)];
        down[a][nt][e] = dn;
        gd[e] = dn > 0.f ? grelu[a][nt][e] : 0.f;
      }
      if (a == 0 && warp == 0) {
        if (r_top < p.M) {
          *reinterpret_cast<float2*>(p.gdown_a + (size_t)r_top * p.Rp + j) = make_float2(gd[0], gd[1]);
          store2(relu_a + (size_t)r_top * p.Rp + j, fmaxf(down[a][nt][0], 0.f), fmaxf(down[a][nt][1], 0.f));
        }
        if (r_bot < p.M) {
          *reinterpret_cast<float2*>(p.gdown_a + (size_t)r_bot * p.Rp + j) = make_float2(gd[2], gd[3]);
          store2(relu_a + (size_t)r_bot * p.Rp + j, fmaxf(down[a][nt][2], 0.f), fmaxf(down[a][nt][3], 0.f));
        }
      }
      // C fragment (n-tile nt) -> half of the A fragment of k-step nt / 2
      uint32_t top[NT], bot[NT];
      split_pack<NT>(gd[0], gd[1], top);
      split_pack<NT>(gd[2], gd[3], bot);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        gdn[a][nt / 2][n][(nt & 1) * 2 + 0] = top[n];
        gdn[a][nt / 2][n][(nt & 1) * 2 + 1] = bot[n];
      }
    }
  }

  // g_o = (g + T(g_down_a) . Wda^T) [+ T(g_down_b) . Wdb^T] over this warp's
  // quarter (after the first chunk: the g_o so far in place of g),
  // AR_GROUP column tiles at a time: a group's reads go before its stores
  const int rows[2] = {r_top, r_bot};
  for (int n0 = d0; n0 < d0 + quarter; n0 += 8 * AR_GROUP) {
    float2 gv[AR_GROUP][2];
#pragma unroll
    for (int t = 0; t < AR_GROUP; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t off = (size_t)rows[h] * p.D + n0 + t * 8 + tig * 2;
        gv[t][h] = rows[h] >= p.M ? make_float2(0.f, 0.f) : p.first ? load2(gin + off) : load2(p.g_o + off);
      }
    float acc[NM][AR_GROUP][4];
#pragma unroll
    for (int a = 0; a < NM; ++a) {
      const T* wd = static_cast<const T*>(a ? p.wdb : p.wda);
#pragma unroll
      for (int t = 0; t < AR_GROUP; ++t) {
        float small[4] = {0.f, 0.f, 0.f, 0.f};
        acc[a][t][0] = acc[a][t][1] = acc[a][t][2] = acc[a][t][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < RC / 16; ++ks) {
          uint32_t b[NT][2];
          b_frag_terms<NT>(b, wd, p.Rp, n0 + t * 8 + g, p.j0 + ks * 16, tig);
          mma_terms<NT>(acc[a][t], small, gdn[a][ks], b);
        }
        add_small<NT>(acc[a][t], small);
      }
    }
#pragma unroll
    for (int t = 0; t < AR_GROUP; ++t) {
      const int col = n0 + t * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= p.M) continue;
        const size_t off = (size_t)rows[h] * p.D + col;
        float v0 = gv[t][h].x + acc[0][t][2 * h];
        float v1 = gv[t][h].y + acc[0][t][2 * h + 1];
        if (USE_B) {
          v0 += acc[NM - 1][t][2 * h];
          v1 += acc[NM - 1][t][2 * h + 1];
        }
        *reinterpret_cast<float2*>(p.g_o + off) = make_float2(v0, v1);
        if (p.last) store2(static_cast<T*>(p.g_f) + off, v0, v1);
      }
    }
  }
}

struct AdapterWgradArgs {
  const void* o;         // [M, D]
  const void* g;         // [M, D]
  const void* relu_a;    // [M, Rp]
  const float* gdown_a;  // [M, Rp]
  float w_a;
  float* part;           // [chunks][2 Rp D + D + Rp]: dWu [Rp][D], dWd [D][Rp], dbu [D], dbd [Rp]
  int M, D, Rp;
  int j0;                // the bottleneck chunk's first column
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// the NT bf16 terms of eight values into NT smem rows `plane` bf16 apart
template <int NT>
__device__ __forceinline__ void store8_terms(bf16* dst, int plane, const float (&v)[8]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = split_term(v[i], n);
    store8(dst + n * plane, t);
  }
}

// Partial sums over one chunk of AW_ROWS rows for AW_COLS columns of Dm and
// the RC columns [j0, j0 + RC) of the bottleneck, on the tensor cores (every
// operand a bf16 value or term, every sum fp32):
//   dWu^T[d][j] = sum_rows g_delta_a[d] relu_a[j],  g_delta_a = T(g w_a)
//   dWd[d][j]   = sum_rows o[d] T(g_down_a[j])
// i.e. C[64 d][RC] = X^T . Y with X [rows][d] and Y [rows][j] as they lie in
// memory: the rows are the products' K, so both operands are read transposed
// from their natural tiles by ldmatrix.trans.  Warp w owns d rows 16w..16w+15.
// dbu[d] += g_delta_a[d] (the first chunk's blocks) and dbd[j] += g_down_a[j]
// (the x = 0 blocks) are summed row by row in fp32.
template <int RC, typename T>
__global__ void __launch_bounds__(AW_THREADS) adapter_wgrad_kernel(AdapterWgradArgs p) {
  constexpr int NT = kTerms<T>;
  constexpr int SUB = NT == 1 ? AW_SUB : 16;  // rows staged at a time
  constexpr int RL = RC + 8;  // padded smem row of the [rows][RC] tiles (bf16)
  __shared__ __align__(16) bf16 Xo[NT][SUB * AW_LD];  // o
  __shared__ __align__(16) bf16 Xg[NT][SUB * AW_LD];  // g_delta_a
  __shared__ __align__(16) bf16 Yr[NT][SUB * RL];     // relu_a
  __shared__ __align__(16) bf16 Yd[NT][SUB * RL];     // T(g_down_a)
  const T* o = static_cast<const T*>(p.o);
  const T* gin = static_cast<const T*>(p.g);
  const T* relu = static_cast<const T*>(p.relu_a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = blockIdx.x * AW_COLS, chunk = blockIdx.y;
  const int r_begin = chunk * AW_ROWS, r_end = min(p.M, r_begin + AW_ROWS);
  float du[RC / 8][4], dd[RC / 8][4], du_s[RC / 8][4], dd_s[RC / 8][4];
#pragma unroll
  for (int nt = 0; nt < RC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) du[nt][e] = dd[nt][e] = du_s[nt][e] = dd_s[nt][e] = 0.f;
  float abu = 0.f, abd = 0.f;
  // ldmatrix row addresses: thread t feeds row t % 8 of 8x8 matrix t / 8
  const int mi = lane >> 3, mr = lane & 7;
  const int xa = (mr + ((mi >> 1) << 3)) * AW_LD + warp * 16 + ((mi & 1) << 3);  // A: (k, m) blocks
  const int ya = (mr + ((mi & 1) << 3)) * RL + ((mi >> 1) << 3);                 // B: (k, n) blocks

  for (int rs = r_begin; rs < r_end; rs += SUB) {
    __syncthreads();
    for (int i = tid; i < SUB * (AW_COLS / 8); i += AW_THREADS) {
      const int r = i / (AW_COLS / 8), c = (i % (AW_COLS / 8)) * 8, row = rs + r;
      float vo[8] = {}, vg[8] = {};
      if (row < r_end) {
        load8(o + (size_t)row * p.D + d0 + c, vo);
        load8(gin + (size_t)row * p.D + d0 + c, vg);
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) vg[t] *= p.w_a;
      store8_terms<NT>(Xo[0] + r * AW_LD + c, SUB * AW_LD, vo);
      store8_terms<NT>(Xg[0] + r * AW_LD + c, SUB * AW_LD, vg);
    }
    for (int i = tid; i < SUB * (RC / 8); i += AW_THREADS) {
      const int r = i / (RC / 8), c = (i % (RC / 8)) * 8, row = rs + r;
      float vr[8] = {}, vd[8] = {};
      if (row < r_end) {
        load8(relu + (size_t)row * p.Rp + p.j0 + c, vr);
        load8(p.gdown_a + (size_t)row * p.Rp + p.j0 + c, vd);
      }
      store8_terms<NT>(Yr[0] + r * RL + c, SUB * RL, vr);
      store8_terms<NT>(Yd[0] + r * RL + c, SUB * RL, vd);
    }
    __syncthreads();
    const int nr = min(SUB, r_end - rs);
    if (p.j0 == 0 && tid < AW_COLS)
      for (int r = 0; r < nr; ++r) {
        float v = __bfloat162float(Xg[0][r * AW_LD + tid]);
        if constexpr (NT == 3)  // the terms' sum is the fp32 value
          v = (v + __bfloat162float(Xg[1][r * AW_LD + tid])) + __bfloat162float(Xg[2][r * AW_LD + tid]);
        abu += v;
      }
    if (blockIdx.x == 0 && tid < RC)
      for (int r = 0; r < nr; ++r) abd += p.gdown_a[(size_t)(rs + r) * p.Rp + p.j0 + tid];
#pragma unroll
    for (int ks = 0; ks < SUB / 16; ++ks) {
      uint32_t ao[NT][4], ag[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        ldsm_x4_trans(ao[n], Xo[n] + ks * 16 * AW_LD + xa);
        ldsm_x4_trans(ag[n], Xg[n] + ks * 16 * AW_LD + xa);
      }
#pragma unroll
      for (int np = 0; np < RC / 16; ++np) {
        uint32_t br0[NT][2], br1[NT][2], bd0[NT][2], bd1[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t br[4], bd[4];
          ldsm_x4_trans(br, Yr[n] + ks * 16 * RL + np * 16 + ya);
          ldsm_x4_trans(bd, Yd[n] + ks * 16 * RL + np * 16 + ya);
          br0[n][0] = br[0], br0[n][1] = br[1], br1[n][0] = br[2], br1[n][1] = br[3];
          bd0[n][0] = bd[0], bd0[n][1] = bd[1], bd1[n][0] = bd[2], bd1[n][1] = bd[3];
        }
        mma_terms<NT>(du[2 * np], du_s[2 * np], ag, br0);
        mma_terms<NT>(du[2 * np + 1], du_s[2 * np + 1], ag, br1);
        mma_terms<NT>(dd[2 * np], dd_s[2 * np], ao, bd0);
        mma_terms<NT>(dd[2 * np + 1], dd_s[2 * np + 1], ao, bd1);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < RC / 8; ++nt) {
    add_small<NT>(du[nt], du_s[nt]);
    add_small<NT>(dd[nt], dd_s[nt]);
  }
  const size_t rd = (size_t)p.Rp * p.D;
  float* out = p.part + chunk * (2 * rd + p.D + p.Rp);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < RC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + warp * 16 + g + 8 * (e >> 1), j = p.j0 + nt * 8 + tig * 2 + (e & 1);
      out[(size_t)j * p.D + d] = du[nt][e];
      out[rd + (size_t)d * p.Rp + j] = dd[nt][e];
    }
  if (p.j0 == 0 && tid < AW_COLS) out[2 * rd + d0 + tid] = abu;
  if (blockIdx.x == 0 && tid < RC) out[2 * rd + p.D + p.j0 + tid] = abd;
}

// The adapter backward on `st`, chunk by chunk of RC bottleneck columns: the
// row pass, then the chunk's weight-gradient partial sums.
template <int RC, typename T>
int launch_adapter_bwd(AdapterBwdArgs ab, AdapterWgradArgs aw, bool use_b, int row_chunks, cudaStream_t st) {
  const dim3 grid((ab.M + AR_ROWS - 1) / AR_ROWS);
  const int nc = ab.Rp / RC;
  for (int c = 0; c < nc; ++c) {
    ab.j0 = aw.j0 = c * RC;
    ab.first = c == 0;
    ab.last = c + 1 == nc;
    if (use_b) adapter_bwd_rows_kernel<RC, true, T><<<grid, AR_THREADS, 0, st>>>(ab);
    else adapter_bwd_rows_kernel<RC, false, T><<<grid, AR_THREADS, 0, st>>>(ab);
    int err = (int)cudaGetLastError();
    if (err) return err;
    adapter_wgrad_kernel<RC, T><<<dim3(aw.D / AW_COLS, row_chunks), AW_THREADS, 0, st>>>(aw);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

template <typename T>
int adapter_bwd(const AdapterBwdArgs& ab, const AdapterWgradArgs& aw, bool use_b, int row_chunks, int rc,
                cudaStream_t st) {
  switch (rc) {
    case 16: return launch_adapter_bwd<16, T>(ab, aw, use_b, row_chunks, st);
  }
  if constexpr (kTerms<T> == 1) {
    if (rc == 32) return launch_adapter_bwd<32, T>(ab, aw, use_b, row_chunks, st);
    if (rc == 48) return launch_adapter_bwd<48, T>(ab, aw, use_b, row_chunks, st);
    if (rc == 64) return launch_adapter_bwd<64, T>(ab, aw, use_b, row_chunks, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Adds the row chunks' partial sums in chunk order (deterministic).
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
  WS_G_F, WS_G_ATT, WS_DCTX, WS_QKV, WS_DQKV, WS_DELTA, WS_PART, WS_XLN, WS_WTERMS, WS_PLANES,
  WS_O_W, WS_G_W, WS_G_O_W, WS_G_F_W, WS_COUNT
};

struct WsLayout {
  size_t off[WS_COUNT];
  size_t total;
};

// es: bytes of the element type (2 bf16, 4 fp32)
WsLayout ws_layout(int B, int S, int Dm, int H, int F, int R, int es) {
  const size_t M = (size_t)B * S, md = M * Dm, mf = M * F, mr = M * R;
  const size_t chunks = (M + AW_ROWS - 1) / AW_ROWS;
  const bool f32 = es == 4;
  const int Dw = adapter_width(Dm);
  const size_t mw = Dw != Dm ? M * Dw : 0;  // the adapters' padded planes, when Dm needs them
  const size_t bytes[WS_COUNT] = {
      md * es, md * es, md * es,           // h, m, o
      mf * 4, mf * es,                     // p1; ge, then g_p1
      mr * es, mr * 4,                     // relu_a, g_down_a
      md * 4, md * 4, md * 4,              // g_o; g_m, then dxln; g_h
      md * es, md * es, md * es,           // g_f, g_att, dctx
      md * es * 3, md * es * 3,            // qkv, dq|dk|dv
      (size_t)B * H * S * 4,               // delta
      chunks * (2 * (size_t)R * Dw + Dw + R) * 4,  // adapter partial sums
      md * es,                             // LN1(x)
      f32 ? 3 * (4 * (size_t)Dm * Dm + 2 * (size_t)Dm * F) * 2 : 0,  // fp32: the weights' terms
      f32 ? (3 * mf > attn_bwd_planes_bytes(md) / 2 ? 3 * mf * 2 : attn_bwd_planes_bytes(md)) : 0,
      mw * es, mw * es, mw * 4, mw * es,   // o, g, g_o and g_f at the adapters' width
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

template <typename T>
int layer_bwd(const void* const* act, const float* lse, const float* bias, const void* const* w,
              const float* bqkv, const float* gamma1, const float* gamma2, const float* b1, const float* b2,
              const void* const* ad, const float* bda, const float* bdb, char* ws, T* dx, float* dwda,
              float* dbda, float* dwua, float* dbua, int B, int S, int Dm, int H, int F, int R, float scale,
              float eps1, float eps2, float w_a, float w_b, bool use_b, cudaStream_t st) {
  constexpr int es = sizeof(T);
  const int M = B * S;
  const size_t md = (size_t)M * Dm, mf = (size_t)M * F;
  const WsLayout wl = ws_layout(B, S, Dm, H, F, R, es);
  auto buf = [&](WsBuffer i) { return ws + wl.off[i]; };
  const T* x = static_cast<const T*>(act[0]);
  const T* aout = static_cast<const T*>(act[1]);
  const T* ctx = static_cast<const T*>(act[2]);
  const T* g = static_cast<const T*>(act[3]);
  T* h = reinterpret_cast<T*>(buf(WS_H));
  T* m = reinterpret_cast<T*>(buf(WS_M));
  T* o = reinterpret_cast<T*>(buf(WS_O));
  float* p1 = reinterpret_cast<float*>(buf(WS_P1));
  T* t_mf = reinterpret_cast<T*>(buf(WS_GE_GP1));  // ge, then g_p1
  float* g_o = reinterpret_cast<float*>(buf(WS_G_O));
  float* g_m = reinterpret_cast<float*>(buf(WS_G_M_DXLN));  // g_m, then dxln
  float* g_h = reinterpret_cast<float*>(buf(WS_G_H));
  T* g_f = reinterpret_cast<T*>(buf(WS_G_F));
  T* g_att = reinterpret_cast<T*>(buf(WS_G_ATT));
  bf16* planes = reinterpret_cast<bf16*>(buf(WS_PLANES));
  const int row_chunks = (M + AW_ROWS - 1) / AW_ROWS;
  float* part = reinterpret_cast<float*>(buf(WS_PART));
  int err;

  // the frozen weights' operands: wq, wk, wv, wo [Dm, Dm], w1 [F, Dm], w2 [Dm, F]
  // (fp32: their terms, one plane of all six w_term apart)
  const long long dd = (long long)Dm * Dm, df = (long long)Dm * F;
  const long long w_term = kTerms<T> == 3 ? 4 * dd + 2 * df : 0;
  bf16* wterms = reinterpret_cast<bf16*>(buf(WS_WTERMS));
  const T* wt[6];
  for (int i = 0; i < 6; ++i) wt[i] = static_cast<const T*>(w[i]);
  const bf16* wop[6];
  if ((err = weight_operands<T>(wt, 4, dd, wterms, w_term, wop, st))) return err;
  if ((err = weight_operands<T>(wt + 4, 2, df, wterms + 4 * dd, w_term, wop + 4, st))) return err;

  // 1. h, m
  ln2_fwd_rows_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(x, aout, gamma2, gamma2 + Dm, eps2, h, m, M, Dm);
  if ((err = (int)cudaGetLastError())) return err;

  // 2. p1 = m.W1^T + b1 (fp32) with ge = T(gelu(p1)); o = T(h + T(ge.W2^T + b2))
  GemmArgs f1{};
  if ((err = operand_of(static_cast<const T*>(m), (long long)md, planes, &f1.a[0], &f1.a_term, st))) return err;
  f1.lda = Dm;
  f1.b[0] = wop[4];
  f1.b_term = w_term;
  f1.ldb = Dm;
  f1.M = M;
  f1.N = F;
  f1.K = Dm;
  f1.bias[0] = b1;
  f1.c_f32 = p1;
  f1.c[0] = t_mf;
  if ((err = launch_gemm_sm90<B_NT, EPI_FFN1, T>(f1, st))) return err;
  GemmArgs f2{};
  if ((err = operand_of(static_cast<const T*>(t_mf), (long long)mf, planes, &f2.a[0], &f2.a_term, st)))
    return err;
  f2.lda = F;
  f2.b[0] = wop[5];
  f2.b_term = w_term;
  f2.ldb = F;
  f2.M = M;
  f2.N = Dm;
  f2.K = F;
  f2.bias[0] = b2;
  f2.aux = h;
  f2.c[0] = o;
  if ((err = launch_gemm_sm90<B_NT, EPI_FFN2, T>(f2, st))) return err;

  // 3. adapter backward: chunk by chunk, rows, then deterministic weight-gradient sums
  // (at the adapters' width Dw: o and g padded first, g_o and g_f copied back after)
  const int Dw = adapter_width(Dm);
  const bool padded = Dw != Dm;
  const T* o_w = o;
  const T* g_w = g;
  if (padded) {
    T* op = reinterpret_cast<T*>(buf(WS_O_W));
    T* gp = reinterpret_cast<T*>(buf(WS_G_W));
    if ((err = launch_pad_cols<T>(o, Dm, op, Dw, M, Dm, Dw, st))) return err;
    if ((err = launch_pad_cols<T>(g, Dm, gp, Dw, M, Dm, Dw, st))) return err;
    o_w = op;
    g_w = gp;
  }
  float* g_o_w = padded ? reinterpret_cast<float*>(buf(WS_G_O_W)) : g_o;
  T* g_f_w = padded ? reinterpret_cast<T*>(buf(WS_G_F_W)) : g_f;
  AdapterBwdArgs ab{};
  ab.o = o_w;
  ab.g = g_w;
  ab.wda = ad[0];
  ab.wua = ad[1];
  ab.wdaT = ad[2];
  ab.wdb = ad[3];
  ab.wub = ad[4];
  ab.wdbT = ad[5];
  ab.bda = bda;
  ab.bdb = bdb;
  ab.w_a = w_a;
  ab.w_b = w_b;
  ab.relu_a = buf(WS_RELU_A);
  ab.gdown_a = reinterpret_cast<float*>(buf(WS_GDOWN_A));
  ab.g_o = g_o_w;
  ab.g_f = g_f_w;
  ab.M = M;
  ab.D = Dw;
  ab.Rp = R;
  AdapterWgradArgs aw{};
  aw.o = o_w;
  aw.g = g_w;
  aw.relu_a = ab.relu_a;
  aw.gdown_a = ab.gdown_a;
  aw.w_a = w_a;
  aw.part = part;
  aw.M = M;
  aw.D = Dw;
  aw.Rp = R;
  const int most = kTerms<T> == 1 ? AD_CHUNK : AD_CHUNK_F32;
  if ((err = adapter_bwd<T>(ab, aw, use_b, row_chunks, chunk_width(R, most), st))) return err;
  const size_t outs = (size_t)2 * R * Dw + Dw + R;
  adapter_wgrad_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(part, row_chunks, dwua, dwda, dbua,
                                                                               dbda, Dw, R);
  if ((err = (int)cudaGetLastError())) return err;
  if (padded) {
    if ((err = launch_pad_cols<float>(g_o_w, Dw, g_o, Dm, M, Dm, Dm, st))) return err;
    if ((err = launch_pad_cols<T>(g_f_w, Dw, g_f, Dm, M, Dm, Dm, st))) return err;
  }

  // 4. g_p1 = T((g_f.W2) * gelu'(p1)); g_m = g_p1.W1
  GemmArgs b2g{};
  if ((err = operand_of(static_cast<const T*>(g_f), (long long)md, planes, &b2g.a[0], &b2g.a_term, st)))
    return err;
  b2g.lda = Dm;
  b2g.b[0] = wop[5];
  b2g.b_term = w_term;
  b2g.ldb = F;
  b2g.M = M;
  b2g.N = F;
  b2g.K = Dm;
  b2g.aux_f32 = p1;
  b2g.c[0] = t_mf;
  if ((err = launch_gemm_sm90<B_NN, EPI_GELU_BWD, T>(b2g, st))) return err;
  GemmArgs b1g{};
  if ((err = operand_of(static_cast<const T*>(t_mf), (long long)mf, planes, &b1g.a[0], &b1g.a_term, st)))
    return err;
  b1g.lda = F;
  b1g.b[0] = wop[4];
  b1g.b_term = w_term;
  b1g.ldb = Dm;
  b1g.M = M;
  b1g.N = Dm;
  b1g.K = F;
  b1g.c_f32 = g_m;
  if ((err = launch_gemm_sm90<B_NN, EPI_F32, T>(b1g, st))) return err;

  // 5. g_h = g_o + LN2_bwd(g_m), g_att = T(g_h)
  if ((err = launch_ln_bwd_rows<T>(h, gamma2, eps2, g_m, g_o, g_att, g_h, M, Dm, st))) return err;

  // 6. attention backward to dxln (into the g_m buffer)
  AttnBwdProblem<T> a{};
  a.x = x;
  a.wq = wop[0];
  a.wk = wop[1];
  a.wv = wop[2];
  a.wo = wop[3];
  a.w_term = w_term;
  a.bqkv = bqkv;
  a.gamma = gamma1;
  a.beta = gamma1 + Dm;
  a.ln_eps = eps1;
  a.bias = bias;
  a.ctx = ctx;
  a.lse = lse;
  a.g_att = g_att;
  a.ws = {buf(WS_QKV), buf(WS_DQKV), buf(WS_DCTX), reinterpret_cast<float*>(buf(WS_DELTA)), buf(WS_XLN), planes};
  a.B = B;
  a.S = S;
  a.Dm = Dm;
  a.H = H;
  a.scale = scale;
  if ((err = attn_bwd_to_dxln<T>(a, nullptr, g_m, st))) return err;

  // 7. dx = T(LN1_bwd(dxln) + g_h)
  return launch_ln_bwd_rows<T>(x, gamma1, eps1, g_m, g_h, dx, nullptr, M, Dm, st);
}

}  // namespace

using namespace port;

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The padded bottleneck the kernel takes for adapter bottleneck r >= 1 in
// bf16 (f32 = 0) or fp32 (f32 = 1): chunks of at most 64 (fp32: 16) columns,
// all of one width, a multiple of 16.  ops/layer_block.py pads to it.
int layer_block_padded_bottleneck(int r, int f32) {
  if (r < 1) return 0;
  const int most = f32 ? AD_CHUNK_F32 : AD_CHUNK;
  return chunk_count(r, most) * chunk_width(r, most);
}

// The width the adapters' weights and gradients take at layer width Dm: Dm
// rounded up to a multiple of 128 (ops/layer_block.py pads to it).
int layer_block_padded_width(int Dm) { return Dm < 1 ? 0 : adapter_width(Dm); }

// Bytes of scratch layer_block_bwd needs at these shapes (R padded).
long long layer_block_bwd_workspace(int B, int S, int Dm, int H, int F, int R, int f32) {
  return (long long)ws_layout(B, S, Dm, H, F, R, f32 ? 4 : 2).total;
}

// Byte offsets in that scratch of what layer_block_bwd leaves there, rows
// M = B*S: h, m, o (x's type, [M, Dm]), p1 (fp32 [M, F]), relu_a (x's type,
// [M, R]), g_down_a (fp32 [M, R]) and g_o (fp32 [M, Dm]).
void layer_block_bwd_stage_offsets(int B, int S, int Dm, int H, int F, int R, int f32, long long* out) {
  const WsLayout l = ws_layout(B, S, Dm, H, F, R, f32 ? 4 : 2);
  const WsBuffer stages[7] = {WS_H, WS_M, WS_O, WS_P1, WS_RELU_A, WS_GDOWN_A, WS_G_O};
  for (int i = 0; i < 7; ++i) out[i] = (long long)l.off[stages[i]];
}

// Activations: x, aout, ctx [B, S, Dm]; lse [B, H, S] f32; g [B, S, Dm];
// bias [B, S] f32 or null.  Frozen: wq..wo [Dm, Dm], w1 [F, Dm], w2 [Dm, F]
// (nn.Linear layout); bqkv [3, Dm], gb1/gb2 [2, Dm], b1 [F], b2 [Dm] f32.
// Adapters (flax layout) at the padded bottleneck R
// (layer_block_padded_bottleneck, zero past the real one) and the padded
// width Dw (layer_block_padded_width, zero past Dm): wda/wdb [Dw, R] and
// wua/wub [R, Dw], with wdaT/wdbT [R, Dw] (the down kernels transposed);
// bda/bdb [R] f32.  Activations, frozen weights and adapters bf16 (f32 = 0)
// or fp32 (f32 = 1).  Any Dm that divides into H heads of 1 to 256 and any
// F.  Outputs: dx [B, S, Dm] in x's type; dwda [Dw, R], dbda [R], dwua
// [R, Dw], dbua [Dw] f32.
int layer_block_bwd(const void* x, const void* aout, const void* ctx, const void* lse, const void* g,
                    const void* bias, const void* wq, const void* wk, const void* wv, const void* wo,
                    const void* bqkv, const void* gb1, const void* gb2, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* wda, const void* bda, const void* wua,
                    const void* wdaT, const void* wdb, const void* bdb, const void* wub,
                    const void* wdbT, void* workspace, void* dx, void* dwda, void* dbda, void* dwua,
                    void* dbua, int B, int S, int Dm, int H, int F, int R, int f32, float scale, float eps1,
                    float eps2, float w_a, float w_b, int use_b, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 16 || R != layer_block_padded_bottleneck(R, f32) || Dm < 1 || H < 1 || Dm % H || F < 1)
    return (int)cudaErrorInvalidValue;
  const void* act[4] = {x, aout, ctx, g};
  const void* w[6] = {wq, wk, wv, wo, w1, w2};
  const void* ad[6] = {wda, wua, wdaT, wdb, wub, wdbT};
  const float* f[7] = {static_cast<const float*>(lse), static_cast<const float*>(bias),
                       static_cast<const float*>(bqkv), static_cast<const float*>(gb1),
                       static_cast<const float*>(gb2), static_cast<const float*>(b1),
                       static_cast<const float*>(b2)};
  float* outs[4] = {static_cast<float*>(dwda), static_cast<float*>(dbda), static_cast<float*>(dwua),
                    static_cast<float*>(dbua)};
  char* ws = static_cast<char*>(workspace);
  if (f32)
    return layer_bwd<float>(act, f[0], f[1], w, f[2], f[3], f[4], f[5], f[6], ad, static_cast<const float*>(bda),
                            static_cast<const float*>(bdb), ws, static_cast<float*>(dx), outs[0], outs[1],
                            outs[2], outs[3], B, S, Dm, H, F, R, scale, eps1, eps2, w_a, w_b, use_b != 0, st);
  return layer_bwd<bf16>(act, f[0], f[1], w, f[2], f[3], f[4], f[5], f[6], ad, static_cast<const float*>(bda),
                         static_cast<const float*>(bdb), ws, static_cast<bf16*>(dx), outs[0], outs[1], outs[2],
                         outs[3], B, S, Dm, H, F, R, scale, eps1, eps2, w_a, w_b, use_b != 0, st);
}

}  // extern "C"
