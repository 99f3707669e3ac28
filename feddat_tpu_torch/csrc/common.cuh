// Building blocks shared by the port's kernels (sm_90a): mma.sync helpers,
// warp reductions, the TPU layer kernel's polynomial erf/GELU, the strided
// per-head operand view of the attention kernels, the contract of the GEMMs
// that gemm_sm90.cuh runs on wgmma, the LayerNorm row passes, and the split
// of fp32 operands into bf16 terms.
//
// The element type.  The kernels of #1-#4 take bf16 or fp32 activations and
// weights (the TPU kernels run in the model's dtype).  Every rounding point of
// the TPU kernels is a cast to that type, so in fp32 it rounds nowhere:
// from_f<float> and round_t<float> are the identity.  The tensor cores
// multiply bf16; an fp32 operand x is split into three bf16 terms,
// x = hi + mid + lo exactly (split3), and a product A.B is the sum of the
// six term products that carry more than fp32's last bit, the small ones
// first (pair_a/pair_b's order): lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
// then hi.hi.
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

#include <type_traits>

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

// ------------------------------------------------------- the element type
// bf16 terms of one operand value: 1 for bf16, 3 (hi, mid, lo) for fp32
template <typename T>
constexpr int kTerms = std::is_same<T, float>::value ? 3 : 1;
// term products of one product: 1, or the six of the split
template <typename T>
constexpr int kPairs = kTerms<T> == 3 ? 6 : 1;

// Pair i of a split product takes A's term pair_a(i) and B's term pair_b(i):
// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi (the small ones first, so
// that the fp32 sums take them at their own magnitude).  Pair 0 of an
// unsplit product is hi.hi.
__host__ __device__ constexpr int pair_a(int i) { return i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0; }
__host__ __device__ constexpr int pair_b(int i) { return i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0; }
template <typename T>
__host__ __device__ constexpr int term_a(int i) { return kPairs<T> == 1 ? 0 : pair_a(i); }
template <typename T>
__host__ __device__ constexpr int term_b(int i) { return kPairs<T> == 1 ? 0 : pair_b(i); }

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// the TPU kernels' rounding point .astype(dtype): bf16 rounding, or none
template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

// two adjacent elements
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(h), __high2float(h));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// eight adjacent elements, 16-byte aligned
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// term t of x's split: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).
// Each difference is exact in fp32, and x = hi + mid + lo exactly for every
// normal x (24 significant bits in three terms of 8).
__device__ __forceinline__ float split_term(float x, int t) {
  const float hi = round_bf16(x);
  if (t == 0) return hi;
  const float r1 = __fsub_rn(x, hi), mid = round_bf16(r1);
  return t == 1 ? mid : round_bf16(__fsub_rn(r1, mid));
}

// the NT terms of two adjacent values, each pair packed as an operand register
template <int NT>
__device__ __forceinline__ void split_pack(float a, float b, uint32_t (&t)[NT]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) t[i] = pack_bf16(split_term(a, i), split_term(b, i));
}

// x [n] fp32 -> its hi, mid and lo terms at out, out + term, out + 2 term.
// (This header's kernels that are not templates are static: a library built
// from several sources, ops/_build.py's PARTS, holds one copy per source.)
static __global__ void split3_kernel(const float* __restrict__ x, bf16* __restrict__ out, long long n,
                                     long long term) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
#pragma unroll
    for (int t = 0; t < 3; ++t) out[t * term + i] = __float2bfloat16_rn(split_term(v, t));
  }
}

inline int launch_split3(const float* x, bf16* out, long long n, long long term, cudaStream_t st) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256 < 132 * 32 ? (n + 255) / 256 : 132 * 32;
  split3_kernel<<<(unsigned)blocks, 256, 0, st>>>(x, out, n, term);
  return (int)cudaGetLastError();
}

// The bf16 operand of a product over x (n elements): bf16 x is its own
// operand (term stride 0); fp32 x is split into three planes of n elements at
// `planes`.  Sets the operand's start and term stride; returns the CUDA error.
inline int operand_of(const bf16* x, long long, bf16*, const bf16** op, long long* term, cudaStream_t) {
  *op = x;
  *term = 0;
  return 0;
}
inline int operand_of(const float* x, long long n, bf16* planes, const bf16** op, long long* term,
                      cudaStream_t st) {
  *op = planes;
  *term = n;
  return launch_split3(x, planes, n, n, st);
}

// One [B, H, S, 64] bf16 operand of the attention kernels, addressed by element
// strides with the head dim contiguous: a [B*S, Dm] projection plane is
// {p, S*Dm, 64, Dm} (also what split() makes of a [B, S, Dm] tensor), a
// contiguous [B, H, S, 64] tensor {p, H*S*64, S*64, 64}.  The wrappers check
// that every stride is a multiple of 8 elements and p is 16-byte aligned, so
// each row's 8-element chunks load as uint4.  The operand of an fp32 product
// is the split of its values: term t (mid, lo) lies tt elements after term
// t - 1.
template <typename T>
struct Heads {
  T* p;
  long long sb, sh, ss;
  long long tt;
  __device__ __forceinline__ T* at(int b, int h) const { return p + b * sb + h * sh; }
};

// x, a [B, H, S, 64] fp32 view by strides -> its hi, mid and lo terms as
// contiguous [B, H, S, 64] bf16 planes at out, out + term, out + 2 term
// (term = B H S 64): the operand of an fp32 attention product, split once
// where the view lies (a split() view of a projection is read in place).
// One thread per 8 adjacent elements of a row.
static __global__ void split3_heads_kernel(Heads<const float> x, bf16* __restrict__ out, int H, int S,
                                           long long term) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < term / 8;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i >> 3, bh = r / S;
    const int c = (int)(i & 7) * 8, s = (int)(r % S), h = (int)(bh % H), b = (int)(bh / H);
    float v[8], t[8];
    load8(x.at(b, h) + s * x.ss + c, v);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = split_term(v[e], k);
      store8(out + k * term + r * 64 + c, t);
    }
  }
}

// The operand that split3_heads_kernel writes at `planes`: contiguous
// [B, H, S, 64] term planes, B H S 64 elements apart.
inline Heads<const bf16> term_planes(const bf16* planes, int B, int H, int S) {
  return {planes, (long long)H * S * 64, (long long)S * 64, 64, (long long)B * H * S * 64};
}

// Splits the fp32 view `x` [B, H, S, 64] into three planes at `planes` and
// sets *op to them (term_planes); a bf16 view is its own operand.  Returns
// the CUDA error.
inline int heads_operand(Heads<const bf16> x, int, int, int, bf16*, Heads<const bf16>* op, cudaStream_t) {
  *op = x;
  return 0;
}
inline int heads_operand(Heads<const float> x, int B, int H, int S, bf16* planes, Heads<const bf16>* op,
                         cudaStream_t st) {
  *op = term_planes(planes, B, H, S);
  const long long rows = (long long)B * H * S, term = op->tt;
  const long long blocks = (rows + 31) / 32 < 132 * 32 ? (rows + 31) / 32 : 132 * 32;
  split3_heads_kernel<<<(unsigned)blocks, 256, 0, st>>>(x, planes, H, S, term);
  return (int)cudaGetLastError();
}

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

// Outputs in the element type T (bf16 rounds once, fp32 not at all):
enum {
  EPI_BIAS = 0,      // c[seg] = T(acc + bias[seg])                  (N segments)
  EPI_OUT = 1,       // c[0]   = T(acc)
  EPI_F32 = 2,       // c_f32  = acc
  EPI_FFN1 = 3,      // p = acc + bias: c_f32 = p, c[0] = T(gelu_poly(p))
  EPI_FFN2 = 4,      // c[0] = T(h + T(acc + bias)), h = aux
  EPI_GELU_BWD = 5,  // c[0] = T(acc * gelu_grad_poly(aux_f32))
};

struct GemmArgs {
  const bf16* a[3];      // A segment s covers k in [s*a_kseg, (s+1)*a_kseg), row stride lda
  int lda, a_kseg;
  const bf16* b[3];      // B_NT: segment by n (b_seg), [n_seg, K] row-major, row stride ldb
                         // B_NN: segment by k (b_seg), [k_seg, N] row-major, row stride ldb
  int ldb, b_seg;
  long long a_term, b_term;  // fp32 products: elements from one split term of A (B) to the next
  int M, N, K;
  const float* bias[3];   // per N segment (EPI_BIAS), or bias[0] over all N
  int c_seg;              // N-segment width of the outputs (EPI_BIAS); else N
  void* c[3];             // outputs of the element type
  float* c_f32;
  int ldc;
  const void* aux;        // [M, ldc] of the element type
  const float* aux_f32;   // [M, ldc]
};

// What an epilogue reads besides the accumulator for two adjacent columns of
// one row: the bias pair and the aux pair (FFN2's h, the GELU backward's p1).
struct EpiIn {
  float2 bias, aux;
};

template <int EPI, typename T>
__device__ __forceinline__ EpiIn gemm_epi_load(const GemmArgs& p, int row, int col) {
  const size_t off = (size_t)row * p.ldc;
  EpiIn in{};
  if (EPI == EPI_BIAS) {
    const int seg = col / p.c_seg, cs = col % p.c_seg;
    in.bias = make_float2(p.bias[seg][cs], p.bias[seg][cs + 1]);
  } else if (EPI == EPI_FFN1 || EPI == EPI_FFN2) {
    in.bias = make_float2(p.bias[0][col], p.bias[0][col + 1]);
  }
  if (EPI == EPI_FFN2) {
    in.aux = load2(static_cast<const T*>(p.aux) + off + col);
  } else if (EPI == EPI_GELU_BWD) {
    in.aux = *reinterpret_cast<const float2*>(p.aux_f32 + off + col);
  }
  return in;
}

template <int EPI, typename T>
__device__ __forceinline__ void gemm_epi_store(const GemmArgs& p, int row, int col, float v0, float v1,
                                               const EpiIn& in) {
  const size_t off = (size_t)row * p.ldc;
  T* const c0 = static_cast<T*>(p.c[0]) + (EPI == EPI_F32 ? 0 : off + col);
  if (EPI == EPI_BIAS) {
    const int seg = col / p.c_seg, cs = col % p.c_seg;
    store2(static_cast<T*>(p.c[seg]) + off + cs, v0 + in.bias.x, v1 + in.bias.y);
  } else if (EPI == EPI_OUT) {
    store2(c0, v0, v1);
  } else if (EPI == EPI_F32) {
    *reinterpret_cast<float2*>(p.c_f32 + off + col) = make_float2(v0, v1);
  } else if (EPI == EPI_FFN1) {
    const float p0 = v0 + in.bias.x, p1 = v1 + in.bias.y;
    *reinterpret_cast<float2*>(p.c_f32 + off + col) = make_float2(p0, p1);
    store2(c0, gelu_poly(p0), gelu_poly(p1));
  } else if (EPI == EPI_FFN2) {
    const float f0 = round_t<T>(v0 + in.bias.x), f1 = round_t<T>(v1 + in.bias.y);
    store2(c0, in.aux.x + f0, in.aux.y + f1);
  } else if (EPI == EPI_GELU_BWD) {
    store2(c0, v0 * gelu_grad_poly(in.aux.x), v1 * gelu_grad_poly(in.aux.y));
  }
}

// Fills in GemmArgs's defaults (one segment each, ldc) and checks the shape
// against tiles `bn` wide and `bk` deep; false for a shape they do not cover.
template <int BL, int EPI>
inline bool gemm_prepare(GemmArgs& p, int bn, int bk) {
  if (p.a_kseg <= 0) p.a_kseg = p.K;
  if (p.b_seg <= 0) p.b_seg = (BL == B_NT) ? p.N : p.K;
  if (p.c_seg <= 0) p.c_seg = p.N;
  if (p.ldc <= 0) p.ldc = (EPI == EPI_BIAS) ? p.c_seg : p.N;
  return !(p.M < 1 || p.N % bn || p.K % bk || p.a_kseg % bk ||
           (BL == B_NT ? p.b_seg % bn : p.b_seg % bk) || p.c_seg % bn);
}

// ------------------------------------------------------ LayerNorm forward
// One warp per row: out = LN(x) in the TPU kernels' fast-variance form (fp32
// row statistics over 8-element chunks per lane, then warp_sum;
// var = max(E[x^2] - mu^2, 0); y = (x - mu) * rstd * gamma + beta, rounded
// once to the element type).  The q|k|v product of #1 and of #3/#4's
// recompute reads this plane as its A operand.  D a multiple of 8 (any other
// D: ln_fwd_rows_any_kernel).
template <typename T>
__global__ void ln_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, float eps, T* __restrict__ out,
                                   int M, int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 8; k < D; k += 32 * 8) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float var = fmaxf(ss / (float)D - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int k = lane * 8; k < D; k += 32 * 8) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = __fadd_rn(__fmul_rn(__fmul_rn(v[t] - mu, rstd), gamma[k + t]), beta[k + t]);
    store8(out + (size_t)row * D + k, v);
  }
}

// The same row pass at a width D that is no multiple of 8: one element per
// lane at a time (the statistics' sums in another order, the same function).
template <typename T>
__global__ void ln_fwd_rows_any_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, float eps, T* __restrict__ out, int M,
                                       int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float v = to_f(xr[k]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float var = fmaxf(ss / (float)D - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int k = lane; k < D; k += 32)
    out[(size_t)row * D + k] = from_f<T>(__fadd_rn(__fmul_rn(__fmul_rn(to_f(xr[k]) - mu, rstd), gamma[k]), beta[k]));
}

template <typename T>
inline int launch_ln_fwd_rows(const T* x, const float* gamma, const float* beta, float eps, T* out, int M,
                              int D, cudaStream_t st) {
  if (D % 8) ln_fwd_rows_any_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(x, gamma, beta, eps, out, M, D);
  else ln_fwd_rows_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(x, gamma, beta, eps, out, M, D);
  return (int)cudaGetLastError();
}

// rows x cols of src (row stride lds) into dst (row stride ldd), columns
// [cols, cols_dst) of dst zero: the zero-padded copies (and their way back,
// cols_dst = cols) of the adapters' operands at a width the kernels' tiles
// do not cover (#2, #4).  One thread per element of dst.
template <typename T>
__global__ void pad_cols_kernel(const T* __restrict__ src, long long lds, T* __restrict__ dst, long long ldd,
                                long long rows, int cols, int cols_dst) {
  const long long n = rows * cols_dst;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / cols_dst;
    const int c = (int)(i % cols_dst);
    dst[r * ldd + c] = c < cols ? src[r * lds + c] : from_f<T>(0.f);
  }
}

template <typename T>
inline int launch_pad_cols(const T* src, long long lds, T* dst, long long ldd, long long rows, int cols,
                           int cols_dst, cudaStream_t st) {
  const long long n = rows * cols_dst;
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256 < 132 * 32 ? (n + 255) / 256 : 132 * 32;
  pad_cols_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(src, lds, dst, ldd, rows, cols, cols_dst);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- LayerNorm backward
// One warp per row: out = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat*xhat))
// (+ resid), with dxhat = dy * gamma and the statistics of x recomputed in
// the fast-variance form (feddat_tpu/ops/layer_block.py:79-84 and
// attn_block.py:217-226).  Writes the element type and/or fp32.
template <typename T>
__global__ void ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma, float eps,
                                   const float* __restrict__ dy, const float* __restrict__ resid,
                                   T* __restrict__ out_t, float* __restrict__ out_f32, int M, int D) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  const float* dr = dy + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float f = to_f(xr[k]);
    s += f;
    ss += f * f;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / (float)D;
  const float rstd = rsqrtf(fmaxf(ss / (float)D - mu * mu, 0.f) + eps);
  float m1 = 0.f, m2 = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float xhat = (to_f(xr[k]) - mu) * rstd;
    const float dxhat = dr[k] * gamma[k];
    m1 += dxhat;
    m2 += dxhat * xhat;
  }
  m1 = warp_sum(m1) / (float)D;
  m2 = warp_sum(m2) / (float)D;
  for (int k = lane; k < D; k += 32) {
    const float xhat = (to_f(xr[k]) - mu) * rstd;
    const float dxhat = dr[k] * gamma[k];
    float v = rstd * (dxhat - m1 - xhat * m2);
    if (resid != nullptr) v += resid[(size_t)row * D + k];
    if (out_f32 != nullptr) out_f32[(size_t)row * D + k] = v;
    if (out_t != nullptr) out_t[(size_t)row * D + k] = from_f<T>(v);
  }
}

template <typename T>
inline int launch_ln_bwd_rows(const T* x, const float* gamma, float eps, const float* dy, const float* resid,
                              T* out_t, float* out_f32, int M, int D, cudaStream_t st) {
  ln_bwd_rows_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(x, gamma, eps, dy, resid, out_t, out_f32, M, D);
  return (int)cudaGetLastError();
}

}  // namespace port
