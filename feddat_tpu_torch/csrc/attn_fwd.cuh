// Attention forward over whole key rows, for Hopper (sm_90a).
//
// The per-head attention of the TPU kernel
//   feddat_tpu/ops/attn_block.py::_fwd_kernel       (kernel #1, its attention stage)
// (kernel #5, feddat_tpu/ops/fused_attention.py::_fwd_kernel, is the same
// function; it runs on fused_attention.cu's wgmma kernel, not on this one).
// Same function, same rounding points:
//
//   s   = q k^T * scale + bias_row     (fp32; bf16 products, fp32 sums)
//   p   = exp(s - max), l = sum(p)     (fp32, the exact two-pass softmax)
//   o   = bf16((bf16(p) . v) / l),  lse = max + log(l)
//
// Design.  The TPU kernels hold one batch element's [H, S, S] logits in VMEM.
// A Hopper block has 227 KB, so attn_kernel takes one block per (64-query
// tile, head, batch element): the fp32 logits of its 64 rows over the whole
// key range stay in shared memory, so the softmax is the TPU's exact two-pass
// form (no online rescaling), and padded keys are simply never summed.  q.k^T
// and P.v run on mma.sync m16n8k16 with fp32 accumulators; K and V are staged
// 64 keys at a time.  Operands are Heads views (common.cuh), so #1's
// [3, B*S, Dm] projection scratch is read in place.  The largest S is what one
// block's shared memory holds (attn_fwd_max_seq: 768).
#pragma once

#include "common.cuh"

namespace port {

constexpr int ATT_BQ = 64;       // query rows per block (16 per warp)
constexpr int ATT_BK = 64;       // keys per staged K/V tile
constexpr int ATT_D = 64;        // head dim
constexpr int ATT_THREADS = 128;
constexpr int ATT_LD = ATT_D + 8;  // padded smem row (bf16)
constexpr size_t ATT_SMEM_MAX = 227 * 1024;

struct AttnFwdArgs {
  Heads<const bf16> q, k, v;
  const float* bias;  // [B, S] additive key bias, or null
  Heads<bf16> o;
  float* lse;         // [B, H, S]
  int S, H, sp;       // sp = S rounded up to ATT_BK
  float scale;
};

inline size_t attn_smem_bytes(int sp) {
  return sizeof(float) * ((size_t)ATT_BQ * (sp + 8) + sp + 2 * ATT_BQ) +
         sizeof(bf16) * 2 * ATT_BQ * ATT_LD;
}

__global__ void __launch_bounds__(ATT_THREADS) attn_kernel(AttnFwdArgs p) {
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
  const bf16* qb = p.q.at(b, h);
  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  const float* bias = p.bias != nullptr ? p.bias + (size_t)b * p.S : nullptr;
  const int qr = warp * 16;  // this warp's rows within the tile

  for (int j = tid; j < p.sp; j += ATT_THREADS)
    brow[j] = (j < p.S && bias != nullptr) ? bias[j] : 0.f;
  for (int i = tid; i < ATT_BQ * (ATT_D / 8); i += ATT_THREADS) {
    const int r = i / (ATT_D / 8), c = (i % (ATT_D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.S) v = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q.ss + c);
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
      if (kt + r < p.S) v = *reinterpret_cast<const uint4*>(kb + (kt + r) * p.k.ss + c);
      *reinterpret_cast<uint4*>(KVs + r * ATT_LD + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < ATT_BK / 8; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < ATT_D / 16; ++ks) {
        const bf16* pk = KVs + (nt * 8 + g) * ATT_LD + ks * 16 + tig * 2;
        uint32_t kf[2] = {lds32(pk), lds32(pk + 8)};
        mma_16816(c, qa[ks], kf);
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

  // phase 3: o = bf16(p) . v, fp32 accumulators for 16 rows x 64 dims
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
      if (kt + r < p.S) v = *reinterpret_cast<const uint4*>(vb + (kt + r) * p.v.ss + c);
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
        uint32_t vf[2] = {lds32(pv), lds32(pv + 8)};
        mma_16816(acc[nt], pa, vf);
      }
    }
  }

  bf16* ob = p.o.at(b, h);
  const int r_top = q0 + qr + g, r_bot = r_top + 8;
  const float l_top = l_s[qr + g], l_bot = l_s[qr + g + 8];
#pragma unroll
  for (int nt = 0; nt < ATT_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (r_top < p.S)
      *reinterpret_cast<uint32_t*>(ob + r_top * p.o.ss + col) =
          pack_bf16(acc[nt][0] / l_top, acc[nt][1] / l_top);
    if (r_bot < p.S)
      *reinterpret_cast<uint32_t*>(ob + r_bot * p.o.ss + col) =
          pack_bf16(acc[nt][2] / l_bot, acc[nt][3] / l_bot);
  }
  if (lane < 16 && q0 + qr + lane < p.S)
    p.lse[((size_t)b * p.H + h) * p.S + q0 + qr + lane] = m_s[qr + lane] + logf(l_s[qr + lane]);
}

// Largest S whose logits tile fits one block's shared memory.
inline int attn_fwd_max_seq() {
  int sp = 0;
  while (attn_smem_bytes(sp + ATT_BK) <= ATT_SMEM_MAX) sp += ATT_BK;
  return sp;
}

// Launches attn_kernel over B batch elements on `st`; returns the CUDA error
// (cudaErrorInvalidValue for an S beyond attn_fwd_max_seq).
inline int launch_attn_fwd(AttnFwdArgs a, int B, cudaStream_t st) {
  a.sp = (a.S + ATT_BK - 1) / ATT_BK * ATT_BK;
  const size_t smem = attn_smem_bytes(a.sp);
  if (a.S < 1 || smem > ATT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_kernel<<<dim3(a.sp / ATT_BQ, a.H, B), ATT_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace port
