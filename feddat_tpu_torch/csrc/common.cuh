// Building blocks shared by the port's kernels (sm_90a): mma.sync helpers,
// warp reductions, the TPU layer kernel's polynomial erf/GELU, the strided
// per-head operand view of the attention kernels, the contract of the GEMMs
// that gemm_sm90.cuh runs on wgmma, and the LayerNorm row passes.
//
// The GEMM contract (C[M, N] = A[M, K] . B, fp32 accumulation), used by the
// attention-block forward (#1) and the backward kernels #3 and #4:
//   * B_NT: B given as [N, K] row-major (an nn.Linear weight [out, in]), so
//     C = A . W^T; the N range may be split into segments with their own
//     weight, bias and output (q|k|v in one launch);
//   * B_NN: B given as [K, N] row-major (C = A . W for a weight [out, in]
//     used on the input side of a backward); the K range may be split into
//     segments with their own A and B (dx = dq.Wq + dk.Wk + dv.Wv in one
//     launch, K = 3 Dm);
//   * epilogues that fuse what the TPU kernels do right after the dot.
// A LayerNorm of A is written once by ln_fwd_rows_kernel before the GEMM.
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

// Fills in GemmArgs's defaults (one segment each, ldc) and checks the shape
// against tiles `bn` wide and `bk` deep; false for a shape they do not cover.
template <int BL, int EPI>
inline bool gemm_prepare(GemmArgs& p, int bn, int bk) {
  if (p.a_kseg <= 0) p.a_kseg = p.K;
  if (p.b_seg <= 0) p.b_seg = (BL == B_NT) ? p.N : p.K;
  if (p.c_seg <= 0) p.c_seg = p.N;
  if (p.ldc <= 0) p.ldc = (EPI == EPI_BIAS_BF16) ? p.c_seg : p.N;
  return !(p.M < 1 || p.N % bn || p.K % bk || p.a_kseg % bk ||
           (BL == B_NT ? p.b_seg % bn : p.b_seg % bk) || p.c_seg % bn);
}

// ------------------------------------------------------ LayerNorm forward
// One warp per row: out = bf16(LN(x)) in the TPU kernels' fast-variance form
// (fp32 row statistics over 8-element chunks per lane, then warp_sum;
// var = max(E[x^2] - mu^2, 0); y = (x - mu) * rstd * gamma + beta, rounded
// once).  The q|k|v product of #1 and of #3/#4's recompute reads this plane as
// its A operand.  D a multiple of 8.
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
