// Building blocks shared by the port's kernels (sm_90a): mma.sync helpers,
// warp reductions, the TPU layer kernel's polynomial erf/GELU, the strided
// per-head operand view of the attention kernels, and one tiled bf16 GEMM
// with a choice of operand layout and epilogue.
//
// The GEMM (C[M, N] = A[M, K] . B, fp32 accumulation) of the attention-block
// forward (#1); the backward kernels #3 and #4 run the same contract
// (GemmArgs, gemm_store) on wgmma through gemm_sm90.cuh:
//   * B_NT: B given as [N, K] row-major (an nn.Linear weight [out, in]), so
//     C = A . W^T; the N range may be split into segments with their own
//     weight, bias and output (q|k|v in one launch);
//   * B_NN: B given as [K, N] row-major (C = A . W for a weight [out, in]
//     used on the input side of a backward); the K range may be split into
//     segments with their own A and B (dx = dq.Wq + dk.Wk + dv.Wv in one
//     launch, K = 3 Dm);
//   * an optional LayerNorm on A in the prologue (row statistics once per
//     128-row tile, fast-variance form, as the TPU kernels do);
//   * epilogues that fuse what the TPU kernels do right after the dot.
// Tiles: 128 x 128 x 32, 8 warps of 64 x 32, mma.sync m16n8k16 with fp32
// accumulators; the next k-tile is loaded into registers during the MMAs.
// N must be a multiple of 128 and K (and each K segment) of 32; M is free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace port {

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One [B, H, S, 64] bf16 operand of the attention kernels, addressed by element
// strides with the head dim contiguous: a [B*S, Dm] projection plane is
// {p, S*Dm, 64, Dm} (also what split() makes of a [B, S, Dm] tensor), a
// contiguous [B, H, S, 64] tensor {p, H*S*64, S*64, 64}.  The wrappers check
// that every stride is a multiple of 8 elements and p is 16-byte aligned, so
// each row's 8-element chunks load as uint4.
template <typename T>
struct Heads {
  T* p;
  long long sb, sh, ss;
  __device__ __forceinline__ T* at(int b, int h) const { return p + b * sb + h * sh; }
};

// erf as the TPU layer kernel computes it (feddat_tpu/ops/layer_block.py:92-113):
// the Eigen/XLA rational polynomial on x clamped to [-4, 4] (max abs error
// 6.0e-7 against the exact erf).  The plain version carries the same
// coefficients (feddat_tpu_torch/ops/layer_block.py::erf_poly).
__device__ __forceinline__ float erf_poly(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float a = -2.72614225801306e-10f;
  a = a * x2 + 2.77068142495902e-08f;
  a = a * x2 + -2.10102402082508e-06f;
  a = a * x2 + -5.69250639462346e-05f;
  a = a * x2 + -7.34990630326855e-04f;
  a = a * x2 + -2.95459980854025e-03f;
  a = a * x2 + -1.60960333262415e-02f;
  a = a * x;
  float b = -1.45660718464996e-05f;
  b = b * x2 + -2.13374055278905e-04f;
  b = b * x2 + -1.68282697438203e-03f;
  b = b * x2 + -7.37332916720468e-03f;
  b = b * x2 + -1.42647390514189e-02f;
  return a / b;
}

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu_poly(float x) {
  return 0.5f * x * (1.f + erf_poly(x * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad_poly(float x) {
  return 0.5f * (1.f + erf_poly(x * kInvSqrt2)) + x * expf(-0.5f * x * x) * kInvSqrt2Pi;
}

// ------------------------------------------------------------------- GEMM
constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int GEMM_LD = GEMM_BK + 8;  // padded smem row (bf16): conflict-free fragments

enum { B_NT = 0, B_NN = 1 };

enum {
  EPI_BIAS_BF16 = 0,  // c_bf16[seg] = bf16(acc + bias[seg])           (N segments)
  EPI_BF16 = 1,       // c_bf16[0]   = bf16(acc)
  EPI_F32 = 2,        // c_f32       = acc
  EPI_FFN1 = 3,       // p = acc + bias: c_f32 = p, c_bf16[0] = bf16(gelu_poly(p))
  EPI_FFN2 = 4,       // c_bf16[0] = bf16(h + bf16(acc + bias)), h = aux_bf16
  EPI_GELU_BWD = 5,   // c_bf16[0] = bf16(acc * gelu_grad_poly(aux_f32))
};

struct GemmArgs {
  const bf16* a[3];      // A segment s covers k in [s*a_kseg, (s+1)*a_kseg), row stride lda
  int lda, a_kseg;
  const bf16* b[3];      // B_NT: segment by n (b_seg), [n_seg, K] row-major, row stride ldb
                         // B_NN: segment by k (b_seg), [k_seg, N] row-major, row stride ldb
  int ldb, b_seg;
  int M, N, K;
  const float* ln_gamma;  // [K] fp32 or null: LayerNorm of A in the prologue (one A segment)
  const float* ln_beta;
  float ln_eps;
  const float* bias[3];   // per N segment (EPI_BIAS_BF16), or bias[0] over all N
  int c_seg;              // N-segment width of the outputs (EPI_BIAS_BF16); else N
  bf16* c_bf16[3];
  float* c_f32;
  int ldc;
  const bf16* aux_bf16;   // [M, ldc]
  const float* aux_f32;   // [M, ldc]
};

// What an epilogue reads besides the accumulator for two adjacent columns of
// one row: the bias pair and the aux pair (FFN2's h, the GELU backward's p1).
struct EpiIn {
  float2 bias, aux;
};

template <int EPI>
__device__ __forceinline__ EpiIn gemm_epi_load(const GemmArgs& p, int row, int col) {
  const size_t off = (size_t)row * p.ldc;
  EpiIn in{};
  if (EPI == EPI_BIAS_BF16) {
    const int seg = col / p.c_seg, cs = col % p.c_seg;
    in.bias = make_float2(p.bias[seg][cs], p.bias[seg][cs + 1]);
  } else if (EPI == EPI_FFN1 || EPI == EPI_FFN2) {
    in.bias = make_float2(p.bias[0][col], p.bias[0][col + 1]);
  }
  if (EPI == EPI_FFN2) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p.aux_bf16 + off + col);
    in.aux = make_float2(__low2float(h), __high2float(h));
  } else if (EPI == EPI_GELU_BWD) {
    in.aux = *reinterpret_cast<const float2*>(p.aux_f32 + off + col);
  }
  return in;
}

template <int EPI>
__device__ __forceinline__ void gemm_epi_store(const GemmArgs& p, int row, int col, float v0, float v1,
                                               const EpiIn& in) {
  const size_t off = (size_t)row * p.ldc;
  if (EPI == EPI_BIAS_BF16) {
    const int seg = col / p.c_seg, cs = col % p.c_seg;
    *reinterpret_cast<uint32_t*>(p.c_bf16[seg] + off + cs) = pack_bf16(v0 + in.bias.x, v1 + in.bias.y);
  } else if (EPI == EPI_BF16) {
    *reinterpret_cast<uint32_t*>(p.c_bf16[0] + off + col) = pack_bf16(v0, v1);
  } else if (EPI == EPI_F32) {
    *reinterpret_cast<float2*>(p.c_f32 + off + col) = make_float2(v0, v1);
  } else if (EPI == EPI_FFN1) {
    const float p0 = v0 + in.bias.x, p1 = v1 + in.bias.y;
    *reinterpret_cast<float2*>(p.c_f32 + off + col) = make_float2(p0, p1);
    *reinterpret_cast<uint32_t*>(p.c_bf16[0] + off + col) = pack_bf16(gelu_poly(p0), gelu_poly(p1));
  } else if (EPI == EPI_FFN2) {
    const float f0 = round_bf16(v0 + in.bias.x), f1 = round_bf16(v1 + in.bias.y);
    *reinterpret_cast<uint32_t*>(p.c_bf16[0] + off + col) = pack_bf16(in.aux.x + f0, in.aux.y + f1);
  } else if (EPI == EPI_GELU_BWD) {
    *reinterpret_cast<uint32_t*>(p.c_bf16[0] + off + col) =
        pack_bf16(v0 * gelu_grad_poly(in.aux.x), v1 * gelu_grad_poly(in.aux.y));
  }
}

// The epilogue at (row, col) and (row, col + 1): gemm_epi_load, then gemm_epi_store.
template <int EPI>
__device__ __forceinline__ void gemm_store(const GemmArgs& p, int row, int col, float v0, float v1) {
  gemm_epi_store<EPI>(p, row, col, v0, v1, gemm_epi_load<EPI>(p, row, col));
}

template <int BL, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) bf16 As[GEMM_BM * GEMM_LD];
  __shared__ __align__(16) bf16 Bs[GEMM_BN * GEMM_LD];  // always [n][k]
  __shared__ float row_mu[GEMM_BM];
  __shared__ float row_rstd[GEMM_BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const bool ln = p.ln_gamma != nullptr;

  if (ln) {  // row statistics of this tile, fp32, fast-variance form
    for (int r = warp; r < GEMM_BM; r += GEMM_THREADS / 32) {
      const int row = m0 + r;
      float s = 0.f, ss = 0.f;
      if (row < p.M) {
        const bf16* xr = p.a[0] + (size_t)row * p.lda;
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
    const int sa = k0 / p.a_kseg;
    const bf16* A = p.a[sa];
    const int ka = k0 - sa * p.a_kseg;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 2, c8 = (idx & 3) * 8;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M) ra[i] = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * p.lda + ka + c8);
      if (BL == B_NT) {
        const int sb = n0 / p.b_seg;
        rb[i] = *reinterpret_cast<const uint4*>(p.b[sb] + (size_t)(n0 - sb * p.b_seg + r) * p.ldb + k0 + c8);
      } else {
        const int sb = k0 / p.b_seg;
        const int kr = idx >> 4, n8 = (idx & 15) * 8;  // 32 k-rows x 128 n
        rb[i] = *reinterpret_cast<const uint4*>(p.b[sb] + (size_t)(k0 - sb * p.b_seg + kr) * p.ldb + n0 + n8);
      }
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
      if (BL == B_NT) {
        *reinterpret_cast<uint4*>(Bs + r * GEMM_LD + c8) = rb[i];
      } else {
        const int kr = idx >> 4, n8 = (idx & 15) * 8;
        const bf16* e = reinterpret_cast<const bf16*>(&rb[i]);
#pragma unroll
        for (int t = 0; t < 8; ++t) Bs[(n8 + t) * GEMM_LD + kr] = e[t];
      }
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

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r0 = m0 + wm + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + tig * 2;
      if (r0 < p.M) gemm_store<EPI>(p, r0, col, acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < p.M) gemm_store<EPI>(p, r0 + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Fills in GemmArgs's defaults (one segment each, ldc) and checks the shape
// against tiles `bn` wide and `bk` deep; false for a shape they do not cover.
template <int BL, int EPI>
inline bool gemm_prepare(GemmArgs& p, int bn, int bk) {
  if (p.a_kseg <= 0) p.a_kseg = p.K;
  if (p.b_seg <= 0) p.b_seg = (BL == B_NT) ? p.N : p.K;
  if (p.c_seg <= 0) p.c_seg = p.N;
  if (p.ldc <= 0) p.ldc = (EPI == EPI_BIAS_BF16) ? p.c_seg : p.N;
  return !(p.M < 1 || p.N % bn || p.K % bk || p.a_kseg % bk ||
           (BL == B_NT ? p.b_seg % bn : p.b_seg % bk) || p.c_seg % bn ||
           (p.ln_gamma != nullptr && p.a_kseg != p.K));
}

// Launches C = A . B with the given layout and epilogue on `st`; returns the
// CUDA error (cudaErrorInvalidValue for a shape the tiles do not cover).
template <int BL, int EPI>
inline int launch_gemm(GemmArgs p, cudaStream_t st) {
  if (!gemm_prepare<BL, EPI>(p, GEMM_BN, GEMM_BK)) return (int)cudaErrorInvalidValue;
  gemm_kernel<BL, EPI><<<dim3(p.N / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM), GEMM_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ LayerNorm forward
// One warp per row: out = bf16(LN(x)) in the arithmetic of gemm_kernel's
// LayerNorm prologue: the row statistics over 8-element chunks per lane, then
// warp_sum, and store_tiles's transform.  So a GEMM that reads `out` as its A
// operand sees bitwise what that prologue builds.  D a multiple of 8.
__global__ void ln_fwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float eps, bf16* __restrict__ out,
                                   int M, int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 8; k < D; k += 32 * 8) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float f = __bfloat162float(e[i]);
      s += f;
      ss += f * f;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float var = fmaxf(ss / (float)D - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int k = lane * 8; k < D; k += 32 * 8) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float xf = __bfloat162float(e[t]);
      float y = __fadd_rn(__fmul_rn(__fmul_rn(xf - mu, rstd), gamma[k + t]), beta[k + t]);
      e[t] = __float2bfloat16_rn(y);
    }
    *reinterpret_cast<uint4*>(out + (size_t)row * D + k) = v;
  }
}

inline int launch_ln_fwd_rows(const bf16* x, const float* gamma, const float* beta, float eps,
                              bf16* out, int M, int D, cudaStream_t st) {
  ln_fwd_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, gamma, beta, eps, out, M, D);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- LayerNorm backward
// One warp per row: out = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat*xhat))
// (+ resid), with dxhat = dy * gamma and the statistics of bf16 x recomputed in
// the fast-variance form (feddat_tpu/ops/layer_block.py:79-84 and
// attn_block.py:217-226).  Writes bf16 and/or fp32.
__global__ void ln_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma, float eps,
                                   const float* __restrict__ dy, const float* __restrict__ resid,
                                   bf16* __restrict__ out_bf16, float* __restrict__ out_f32, int M, int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * D;
  const float* dr = dy + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float f = __bfloat162float(xr[k]);
    s += f;
    ss += f * f;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float rstd = rsqrtf(fmaxf(ss / (float)D - mu * mu, 0.f) + eps);
  float m1 = 0.f, m2 = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float xhat = (__bfloat162float(xr[k]) - mu) * rstd;
    const float dxhat = dr[k] * gamma[k];
    m1 += dxhat;
    m2 += dxhat * xhat;
  }
  m1 = warp_sum(m1) / (float)D;
  m2 = warp_sum(m2) / (float)D;
  for (int k = lane; k < D; k += 32) {
    const float xhat = (__bfloat162float(xr[k]) - mu) * rstd;
    const float dxhat = dr[k] * gamma[k];
    float v = rstd * (dxhat - m1 - xhat * m2);
    if (resid != nullptr) v += resid[(size_t)row * D + k];
    if (out_f32 != nullptr) out_f32[(size_t)row * D + k] = v;
    if (out_bf16 != nullptr) out_bf16[(size_t)row * D + k] = __float2bfloat16_rn(v);
  }
}

inline int launch_ln_bwd_rows(const bf16* x, const float* gamma, float eps, const float* dy,
                              const float* resid, bf16* out_bf16, float* out_f32, int M, int D,
                              cudaStream_t st) {
  ln_bwd_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(x, gamma, eps, dy, resid, out_bf16, out_f32, M, D);
  return (int)cudaGetLastError();
}

}  // namespace port
