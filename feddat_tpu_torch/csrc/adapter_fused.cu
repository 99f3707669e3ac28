// DAT ensemble-adapter epilogue, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel feddat_tpu/ops/adapter_fused.py::_kernel (called
// through _forward).  Same function, all arithmetic in fp32:
//
//   out = bf16( w * (relu(h . Wd_a + bd_a) . Wu_a + bu_a)
//             + (1 - w) * (relu(h . Wd_b + bd_b) . Wu_b + bu_b) )
//
// with h [N, D] and the four matrices in bf16 (the model casts them, like
// models/adapters.py:146 does), Wd [D, R], Wu [R, D] (flax layout).  The
// kernel returns the mix only; the caller adds the residual.
//
// What bounds it on the H100: at the serving shape (N = 16*281 rows, D = 768,
// R = 48) one call does 1.33 GFLOP and moves ~14 MB (~4.2 us of bytes).  Half
// of the work, h . Wd, has bf16 operands whose products are exact in fp32, so
// tensor cores could do it at the bf16 rate (~0.7 us); the up-projection
// multiplies the fp32 relu output and is fp32 work (~10.1 us at 67 TFLOP/s).
// The card's floor is therefore ~10.1 us, by operations (chip_smoke.py's
// adapter_bound); splitting the relu output into bf16 pieces would take it
// down to the byte floor.  This design does every product with fp32 FMAs,
// so its own target is ~20 us (all 1.33 GFLOP at the fp32 rate).
//
// What the design does about it.  On the TPU both adapters' weights (295 KB
// in bf16) stay in VMEM next to a 256-row block.  They do not fit a Hopper
// block's 227 KB of shared memory, so each block keeps only its 16 rows of h
// (transposed, fp32) and the 16 x 2R bottleneck activations in shared memory,
// and streams the weights from L2 (all blocks read the same 295 KB).  Each
// thread accumulates 16 rows in registers, so one weight load feeds 16 FMAs
// and the shared-memory reads are float4 broadcasts.  Tensor-core and
// register-tiled variants are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int AD_ROWS = 16;      // rows of h per block
constexpr int AD_THREADS = 192;
constexpr int AD_KSPLIT = 2;     // the down-projection's D axis is split in 2 per column

struct AdapterArgs {
  const bf16* h;  // [N, D]
  const bf16* wd[2];  // [D, R] per adapter (a, b)
  const bf16* bd[2];  // [R]
  const bf16* wu[2];  // [R, D]
  const bf16* bu[2];  // [D]
  bf16* out;          // [N, D]
  int N, D, R;
  float weight;
};

size_t adapter_smem_bytes(int D, int R) {
  return sizeof(float) * ((size_t)D * AD_ROWS + 2 * (size_t)AD_KSPLIT * R * AD_ROWS);
}

__global__ void __launch_bounds__(AD_THREADS) adapter_kernel(AdapterArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hT = reinterpret_cast<float*>(smem);  // [D][AD_ROWS]
  float* down = hT + (size_t)p.D * AD_ROWS;    // [AD_KSPLIT][2R][AD_ROWS] partial sums
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * AD_ROWS;
  const int R2 = 2 * p.R;

  // stage h transposed (fp32): hT[k][r]
  for (int i = tid; i < AD_ROWS * (p.D / 8); i += AD_THREADS) {
    const int r = i % AD_ROWS, k = (i / AD_ROWS) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.N) v = *reinterpret_cast<const uint4*>(p.h + (size_t)(row0 + r) * p.D + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) hT[(k + t) * AD_ROWS + r] = __bfloat162float(e[t]);
  }
  __syncthreads();

  // down-projections of both adapters: column c of [a | b], one half of D per job
  const int kspan = p.D / AD_KSPLIT;
  for (int job = tid; job < R2 * AD_KSPLIT; job += AD_THREADS) {
    const int c = job % R2, part = job / R2;
    const int ad = c < p.R ? 0 : 1, cc = c - ad * p.R;
    const bf16* __restrict__ wcol = p.wd[ad] + cc;
    float acc[AD_ROWS];
#pragma unroll
    for (int r = 0; r < AD_ROWS; ++r) acc[r] = 0.f;
    const int k_end = (part + 1) * kspan;
    for (int k = part * kspan; k < k_end; ++k) {
      const float w = __bfloat162float(wcol[(size_t)k * p.R]);
      const float4* hv = reinterpret_cast<const float4*>(hT + k * AD_ROWS);
#pragma unroll
      for (int q = 0; q < AD_ROWS / 4; ++q) {
        const float4 x = hv[q];
        acc[4 * q + 0] += x.x * w;
        acc[4 * q + 1] += x.y * w;
        acc[4 * q + 2] += x.z * w;
        acc[4 * q + 3] += x.w * w;
      }
    }
    float* dst = down + ((size_t)part * R2 + c) * AD_ROWS;
#pragma unroll
    for (int r = 0; r < AD_ROWS; ++r) dst[r] = acc[r];
  }
  __syncthreads();
  // bias + relu into the first partial plane
  for (int i = tid; i < R2 * AD_ROWS; i += AD_THREADS) {
    const int c = i / AD_ROWS;
    const int ad = c < p.R ? 0 : 1, cc = c - ad * p.R;
    float s = down[i];
    for (int part = 1; part < AD_KSPLIT; ++part) s += down[(size_t)part * R2 * AD_ROWS + i];
    down[i] = fmaxf(s + __bfloat162float(p.bd[ad][cc]), 0.f);
  }
  __syncthreads();

  // up-projections and the mix, one output column per thread at a time
  const float wa = p.weight, wb = 1.f - p.weight;
  for (int c = tid; c < p.D; c += AD_THREADS) {
    float aa[AD_ROWS], ab[AD_ROWS];
#pragma unroll
    for (int r = 0; r < AD_ROWS; ++r) aa[r] = ab[r] = 0.f;
    for (int k = 0; k < p.R; ++k) {
      const float ua = __bfloat162float(p.wu[0][(size_t)k * p.D + c]);
      const float ub = __bfloat162float(p.wu[1][(size_t)k * p.D + c]);
      const float4* da = reinterpret_cast<const float4*>(down + (size_t)k * AD_ROWS);
      const float4* db = reinterpret_cast<const float4*>(down + (size_t)(p.R + k) * AD_ROWS);
#pragma unroll
      for (int q = 0; q < AD_ROWS / 4; ++q) {
        const float4 x = da[q], y = db[q];
        aa[4 * q + 0] += x.x * ua;
        aa[4 * q + 1] += x.y * ua;
        aa[4 * q + 2] += x.z * ua;
        aa[4 * q + 3] += x.w * ua;
        ab[4 * q + 0] += y.x * ub;
        ab[4 * q + 1] += y.y * ub;
        ab[4 * q + 2] += y.z * ub;
        ab[4 * q + 3] += y.w * ub;
      }
    }
    const float ba = __bfloat162float(p.bu[0][c]), bb = __bfloat162float(p.bu[1][c]);
#pragma unroll
    for (int r = 0; r < AD_ROWS; ++r) {
      if (row0 + r < p.N) {
        const float a = aa[r] + ba, b = ab[r] + bb;
        p.out[(size_t)(row0 + r) * p.D + c] = __float2bfloat16_rn(wa * a + wb * b);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// h [N, D] bf16; wd_* [D, R], bd_* [R], wu_* [R, D], bu_* [D], all bf16;
// out [N, D] bf16.  D must be a multiple of 8 * AD_KSPLIT.
// Returns the CUDA error of the launch (0 = success).
int adapter_fused_fwd(const void* h, const void* wd_a, const void* bd_a, const void* wu_a,
                      const void* bu_a, const void* wd_b, const void* bd_b, const void* wu_b,
                      const void* bu_b, void* out, int N, int D, int R, float weight,
                      void* stream) {
  AdapterArgs a{};
  a.h = static_cast<const bf16*>(h);
  a.wd[0] = static_cast<const bf16*>(wd_a);
  a.bd[0] = static_cast<const bf16*>(bd_a);
  a.wu[0] = static_cast<const bf16*>(wu_a);
  a.bu[0] = static_cast<const bf16*>(bu_a);
  a.wd[1] = static_cast<const bf16*>(wd_b);
  a.bd[1] = static_cast<const bf16*>(bd_b);
  a.wu[1] = static_cast<const bf16*>(wu_b);
  a.bu[1] = static_cast<const bf16*>(bu_b);
  a.out = static_cast<bf16*>(out);
  a.N = N;
  a.D = D;
  a.R = R;
  a.weight = weight;
  const size_t smem = adapter_smem_bytes(D, R);
  cudaError_t err =
      cudaFuncSetAttribute(adapter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  adapter_kernel<<<(N + AD_ROWS - 1) / AD_ROWS, AD_THREADS, smem,
                   reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Largest D (for a given R) whose staging fits a block's shared memory.
int adapter_fused_max_dim(int R) {
  int d = 0;
  while (adapter_smem_bytes(d + 16, R) <= 227 * 1024) d += 16;
  return d;
}

}  // extern "C"
