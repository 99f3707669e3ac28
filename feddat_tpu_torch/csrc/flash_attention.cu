// Flash attention forward for Hopper (sm_90a): online softmax over key tiles.
//
// Replaces the TPU kernel feddat_tpu/ops/flash.py::_flash_fwd_kernel (kernel
// #7, called through _flash_forward), the same function at the same points:
//
//   s   = (q * scale) k^T + bias             fp32 (bf16 products, fp32 sums)
//   m   = running row max, from NEG_INF = -1e30; l = running row sum
//   acc = acc * exp(m_old - m) + p v,  p = exp(s - m) in fp32 (never rounded)
//   o   = bf16(acc / max(l, 1e-30)),  lse = m + log(max(l, 1e-30))
//
// q [B, H, Sq, 64] and k, v [B, H, Skv, 64] bf16 are Heads views (common.cuh),
// so the [B, H, S, 64] views that split() makes of [B, S, Dm] projections are
// read in place; o is written through a Heads view too (the wrapper hands a
// [B, S, H, 64] buffer, so merging the heads is a free view).  The bias is the
// compact fp32 [B|1, H|1, Sq|1, Skv|1] tensor addressed by element strides,
// 0 on a broadcast dim, so a padding row, a causal block or a packed
// block-diagonal bias is never expanded in memory.  Sq and Skv are free: key
// columns past Skv are skipped (the TPU pads them with -1e30, whose exp
// underflows to the same 0), query rows past Sq are not written.
//
// P stays fp32 in P.v, as the TPU kernel keeps it: p is split into bf16 hi =
// bf16(p) and lo = bf16(p - hi) and both multiply the bf16 v on mma.sync with
// fp32 accumulation (p - hi is exact, lo keeps 8 more bits: p is carried to
// ~2^-17 of itself, far below o's bf16 rounding).  Rounding p to bf16, as
// kernel #5 does, would move o by up to 2^-9 of each term.
//
// What bounds it on the H100.  At ALBEF's ViT site (B=16, H=12, S=577)
// q.k^T is 8.2 GFLOP of bf16 products (~8.3 us at 989 TFLOP/s) and P.v the
// same again twice over (hi and lo: ~16.6 us, the time TF32 would take); q, k,
// v, o and lse are ~57 MB (~17 us at 3.35 TB/s): operations bound it.  At the
// short text sites bytes do.
//
// Design: one block of 4 warps per (64-query tile, head, batch element),
// 16 query rows per warp; a loop over 64-key tiles staged in shared memory (K
// as [key][d], V transposed as [d][key]); q.k^T and P.v on mma.sync m16n8k16,
// the logits tile held in registers and handed to P.v as A fragments (no
// shared-memory round trip); the running max/sum per row kept by the 4
// threads of a quad.  wgmma, TMA and a ring of tiles are later work.

#include "common.cuh"

using namespace port;

namespace {

constexpr int FL_BQ = 64;       // query rows per block (16 per warp)
constexpr int FL_BK = 64;       // keys per staged tile
constexpr int FL_D = 64;        // head dim
constexpr int FL_THREADS = 128;
constexpr int FL_LD = FL_D + 8;  // padded smem row (bf16)
constexpr float FL_NEG_INF = -1e30f;

struct FlashArgs {
  Heads<const bf16> q, k, v;
  Heads<bf16> o;
  const float* bias;             // compact bias or null
  long long bsb, bsh, bsq, bsk;  // its element strides, 0 on broadcast dims
  float* lse;                    // [B, H, Sq]
  int H, Sq, Skv;
  float scale;
};

template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return {static_cast<T*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(FL_THREADS) flash_fwd_kernel(FlashArgs p) {
  __shared__ __align__(16) bf16 Qs[FL_BQ * FL_LD];
  __shared__ __align__(16) bf16 Ks[FL_BK * FL_LD];  // [key][d]
  __shared__ __align__(16) bf16 Vt[FL_D * FL_LD];   // [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * FL_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = p.q.at(b, h);
  const bf16* kb = p.k.at(b, h);
  const bf16* vb = p.v.at(b, h);
  const int qr = warp * 16;
  const int row[2] = {q0 + qr + g, q0 + qr + g + 8};  // this thread's two query rows

  // bias rows of this thread's queries (clamped: rows past Sq are never written)
  const float* brow[2] = {nullptr, nullptr};
  if (p.bias != nullptr) {
    const float* base = p.bias + b * p.bsb + h * p.bsh;
#pragma unroll
    for (int i = 0; i < 2; ++i) brow[i] = base + (long long)min(row[i], p.Sq - 1) * p.bsq;
  }

  for (int i = tid; i < FL_BQ * (FL_D / 8); i += FL_THREADS) {
    const int r = i / (FL_D / 8), c = (i % (FL_D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq) v = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * p.q.ss + c);
    *reinterpret_cast<uint4*>(Qs + r * FL_LD + c) = v;
  }
  __syncthreads();
  uint32_t qa[FL_D / 16][4];
#pragma unroll
  for (int ks = 0; ks < FL_D / 16; ++ks) {
    const bf16* pq = Qs + (qr + g) * FL_LD + ks * 16 + tig * 2;
    qa[ks][0] = lds32(pq);
    qa[ks][1] = lds32(pq + 8 * FL_LD);
    qa[ks][2] = lds32(pq + 8);
    qa[ks][3] = lds32(pq + 8 * FL_LD + 8);
  }

  float m[2] = {FL_NEG_INF, FL_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums (its 2 columns of each n-tile)
  float acc[FL_D / 8][4];
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[nt][t] = 0.f;

  for (int kt = 0; kt < p.Skv; kt += FL_BK) {
    __syncthreads();  // the previous tile's K and V reads are done
    for (int i = tid; i < FL_BK * (FL_D / 8); i += FL_THREADS) {
      const int r = i / (FL_D / 8), c = (i % (FL_D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < p.Skv) v = *reinterpret_cast<const uint4*>(kb + (long long)(kt + r) * p.k.ss + c);
      *reinterpret_cast<uint4*>(Ks + r * FL_LD + c) = v;
    }
    for (int i = tid; i < FL_BK * (FL_D / 8); i += FL_THREADS) {
      const int r = i % FL_BK, c = (i / FL_BK) * 8;  // r: key, c: first dim
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < p.Skv) v = *reinterpret_cast<const uint4*>(vb + (long long)(kt + r) * p.v.ss + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t) Vt[(c + t) * FL_LD + r] = e[t];
    }
    __syncthreads();

    // s = q.k^T for the warp's 16 rows x 64 keys (C fragments: [0..1] row g, [2..3] row g+8)
    float s[FL_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) s[nt][t] = 0.f;
#pragma unroll
      for (int ks = 0; ks < FL_D / 16; ++ks) {
        const bf16* pk = Ks + (nt * 8 + g) * FL_LD + ks * 16 + tig * 2;
        uint32_t kf[2] = {lds32(pk), lds32(pk + 8)};
        mma_16816(s[nt], qa[ks], kf);
      }
    }

    // scale, bias; keys past Skv drop out (-inf: exp gives 0 and the max ignores them)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int key = kt + nt * 8 + tig * 2 + (t & 1), r = t >> 1;
        float x = -INFINITY;
        if (key < p.Skv) {
          const float bv = brow[r] != nullptr ? brow[r][key * p.bsk] : 0.f;
          x = __fadd_rn(__fmul_rn(s[nt][t], p.scale), bv);
        }
        s[nt][t] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(tmax[r]));
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < FL_BK / 8; ++nt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float e = expf(s[nt][t] - m[t >> 1]);
        s[nt][t] = e;
        l[t >> 1] += e;
      }
    }
#pragma unroll
    for (int nt = 0; nt < FL_D / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // acc += p.v, p = hi + lo in bf16: the C fragments of key tiles 2ks and
    // 2ks+1 are the A fragment of the 16-key step ks
#pragma unroll
    for (int ks = 0; ks < FL_BK / 16; ++ks) {
      const float x[8] = {s[2 * ks][0], s[2 * ks][1], s[2 * ks][2], s[2 * ks][3],
                          s[2 * ks + 1][0], s[2 * ks + 1][1], s[2 * ks + 1][2], s[2 * ks + 1][3]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
        lo[i] = pack_bf16(x[2 * i] - round_bf16(x[2 * i]), x[2 * i + 1] - round_bf16(x[2 * i + 1]));
      }
#pragma unroll
      for (int nt = 0; nt < FL_D / 8; ++nt) {
        const bf16* pv = Vt + (nt * 8 + g) * FL_LD + ks * 16 + tig * 2;
        uint32_t vf[2] = {lds32(pv), lds32(pv + 8)};
        mma_16816(acc[nt], hi, vf);
        mma_16816(acc[nt], lo, vf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  bf16* ob = p.o.at(b, h);
#pragma unroll
  for (int nt = 0; nt < FL_D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row[r] * p.o.ss + col) =
            pack_bf16(acc[nt][2 * r] / l[r], acc[nt][2 * r + 1] / l[r]);
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < p.Sq) p.lse[((long long)b * p.H + h) * p.Sq + row[r]] = m[r] + logf(l[r]);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q [B, H, Sq, 64], k and v [B, H, Skv, 64] bf16 and o (output, [B, H, Sq, 64])
// by element strides (strides[0..11]: q, k, v, o as sb, sh, ss); bias fp32 or
// null with strides[12..15] = its b, h, q, k element strides (0 on broadcast
// dims); lse [B, H, Sq] fp32 (output).  Returns the CUDA error of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, const long long* strides, int B, int H, int Sq, int Skv,
                        float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  FlashArgs a{};
  a.q = heads<const bf16>(q, strides);
  a.k = heads<const bf16>(k, strides + 3);
  a.v = heads<const bf16>(v, strides + 6);
  a.o = heads<bf16>(o, strides + 9);
  a.bias = static_cast<const float*>(bias);
  a.bsb = strides[12];
  a.bsh = strides[13];
  a.bsq = strides[14];
  a.bsk = strides[15];
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.scale = scale;
  dim3 grid((Sq + FL_BQ - 1) / FL_BQ, H, B);
  flash_fwd_kernel<<<grid, FL_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
