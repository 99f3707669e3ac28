// Whole-sequence attention, forward (#5) and backward (#6), for Hopper (sm_90a).
//
// Replaces two TPU kernels, the same functions at the same rounding points:
//   feddat_tpu/ops/fused_attention.py::_fwd_kernel (kernel #5, lines 37-57,
//   called through _fwd_call), per (batch, head) on q/k/v [B, H, S, 64] bf16
//   and a [B, S] fp32 padding-bias row: o and lse;
//   feddat_tpu/ops/fused_attention.py::_bwd_kernel (kernel #6, lines 60-85,
//   called through _fused_bwd): dq, dk and dv, P rebuilt from the forward's lse.
//
// The functions, their bound on the H100 and the design (one warpgroup per 64
// rows, a two-stage cp.async ring, wgmma.m64n64k16, the keys swept twice for
// the exact max, the backward as a dq launch and a dkdv launch) are
// attn_sm90.cuh's, whose bodies #1's attention core and #3/#4's per-head part
// run too, under entries of their own (attn_block.cu, attn_bwd.cuh).  Here
// they get #5's and #6's entries, fused_fwd_kernel and fused_bwd_dq/dkdv_kernel,
// and C entry points that take the operands as [B, H, S, 64] views by
// strides, so split() views are read and written in place.  Any S >= 1 runs.
//
// Both take bf16 or fp32 q/k/v (and o, dO for #6), as the TPU kernels take
// the model's dtype.  In fp32 nothing rounds (bf16(P) and bf16(ds) are casts
// to fp32 there), the entries split each fp32 operand into its three bf16
// terms in the caller's workspace (common.cuh's split3_heads_kernel), and
// the bodies' fp32 instances take each product as six term products; o, dq,
// dk and dv are written as fp32.  The bf16 instances are unchanged.
//
// Every head dim from 1 to 256: head dim 64 runs the kernels above; any other
// runs attn_any.cuh's bodies (FLASH = false: the same function at the same
// rounding points, D padded to 64-column chunks) under this file's
// fused_any_fwd_kernel and fused_any_bwd_dq/dkdv_kernel, defined after the
// head-dim-64 entries so that those compile as before.  There an fp32
// operand's terms are contiguous [B, H, S, D] planes (split3_heads_any_kernel).

#include "attn_any.cuh"
#include "attn_sm90.cuh"

using namespace port;
using namespace port::attn;

namespace {

template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return {static_cast<T*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, fwd_min_blocks<T>()) fused_fwd_kernel(FusedFwdArgs<T> p) {
  fused_fwd_body(p);
}

// dkdv before dq (attn_sm90.cuh)
template <typename T>
__global__ void __launch_bounds__(FA_THREADS, dkdv_min_blocks<T>()) fused_bwd_dkdv_kernel(FusedBwdArgs<T> p) {
  fused_bwd_dkdv_body(p);
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, dq_min_blocks<T>()) fused_bwd_dq_kernel(FusedBwdArgs<T> p) {
  fused_bwd_dq_body(p);
}

// the kernels' shared-memory limits, raised once per device and element type
// (bf16, fp32; this library's own flags)
int fwd_smem_done[2][64], dq_smem_done[2][64], dkdv_smem_done[2][64];

// the kernels at every other head dim (attn_any.cuh), after the head-dim-64 ones
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) fused_any_fwd_kernel(anyd::AnyArgs<T> p) {
  anyd::any_fwd_body<T, false>(p);
}
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) fused_any_bwd_dkdv_kernel(anyd::AnyArgs<T> p) {
  anyd::any_dkdv_body<T, false>(p);
}
template <typename T>
__global__ void __launch_bounds__(anyd::THREADS, 1) fused_any_bwd_dq_kernel(anyd::AnyArgs<T> p) {
  anyd::any_dq_body<T, false>(p);
}
int any_fwd_done[2][64], any_dq_done[2][64], any_dkdv_done[2][64];

// Bytes of the workspace: fp32 q, k, v (and dout for the backward) as three
// bf16 term planes each, [B, H, S, D]; none in bf16.
long long workspace_bytes(int B, int H, int S, int D, bool backward, bool f32) {
  return f32 ? (backward ? 4 : 3) * 3 * (long long)B * H * S * D * 2 : 0;
}

// #5 at a head dim other than 64 (attn_any.cuh)
template <typename T>
int fused_any_fwd(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                  bf16* planes, const long long* strides, int B, int H, int S, int D, float scale,
                  cudaStream_t st) {
  if (anyd::bad_sizes(B, H, S, S, D)) return (int)cudaErrorInvalidValue;
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  const long long plane = 3 * (long long)B * H * S * D;
  anyd::AnyArgs<T> a{};
  int e = heads_operand_any(heads<const T>(q, strides), B, H, S, D, planes, &a.q, &a.vq, st);
  if (!e) e = heads_operand_any(heads<const T>(k, strides + 3), B, H, S, D, planes + plane, &a.k, &a.vk, st);
  if (!e) e = heads_operand_any(heads<const T>(v, strides + 6), B, H, S, D, planes + 2 * plane, &a.v, &a.vv, st);
  if (e) return e;
  a.o = heads<T>(o, strides + 9);
  a.bias = bias;
  a.bsb = S;  // [B, S]: a key row per batch element
  a.bsk = 1;
  a.lse = lse;
  a.H = H;
  a.Sq = a.Skv = S;
  a.D = D;
  a.ND = anyd::chunks(D);
  a.scale = scale;
  return anyd::launch_any_fwd(fused_any_fwd_kernel<T>, any_fwd_done[ti], a, B, st);
}

// #6 at a head dim other than 64: the dq launch (with delta), then dk/dv
template <typename T>
int fused_any_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* bias,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, bf16* planes,
                  const long long* strides, int B, int H, int S, int D, float scale, cudaStream_t st) {
  if (anyd::bad_sizes(B, H, S, S, D)) return (int)cudaErrorInvalidValue;
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  const long long plane = 3 * (long long)B * H * S * D;
  anyd::AnyArgs<T> a{};
  int e = heads_operand_any(heads<const T>(q, strides), B, H, S, D, planes, &a.q, &a.vq, st);
  if (!e) e = heads_operand_any(heads<const T>(k, strides + 3), B, H, S, D, planes + plane, &a.k, &a.vk, st);
  if (!e) e = heads_operand_any(heads<const T>(v, strides + 6), B, H, S, D, planes + 2 * plane, &a.v, &a.vv, st);
  if (!e)
    e = heads_operand_any(heads<const T>(dout, strides + 12), B, H, S, D, planes + 3 * plane, &a.dout, &a.vdo, st);
  if (e) return e;
  a.ctx = heads<const T>(o, strides + 9);
  a.dq = heads<T>(dq, strides + 15);
  a.dk = heads<T>(dk, strides + 18);
  a.dv = heads<T>(dv, strides + 21);
  a.bias = bias;
  a.bsb = S;
  a.bsk = 1;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.H = H;
  a.Sq = a.Skv = S;
  a.D = D;
  a.ND = anyd::chunks(D);
  a.scale = scale;
  if ((e = anyd::launch_any_bwd(fused_any_bwd_dq_kernel<T>, any_dq_done[ti], a, B, false, st))) return e;
  return anyd::launch_any_bwd(fused_any_bwd_dkdv_kernel<T>, any_dkdv_done[ti], a, B, true, st);
}

// #5 over B batch elements on `st` (q, k, v in T, split into `planes` in
// fp32); returns the CUDA error of the launches
template <typename T>
int fused_fwd(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
              bf16* planes, const long long* strides, int B, int H, int S, float scale, cudaStream_t st) {
  if (bad_sizes(B, H, S)) return (int)cudaErrorInvalidValue;
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  const long long plane = 3 * (long long)B * H * S * FA_D;  // one fp32 operand's terms
  FusedFwdArgs<T> a{};
  int e = heads_operand(heads<const T>(q, strides), B, H, S, planes, &a.q, st);
  if (!e) e = heads_operand(heads<const T>(k, strides + 3), B, H, S, planes + plane, &a.k, st);
  if (!e) e = heads_operand(heads<const T>(v, strides + 6), B, H, S, planes + 2 * plane, &a.v, st);
  if (e) return e;
  a.o = heads<T>(o, strides + 9);
  a.bias = bias;
  a.lse = lse;
  a.S = S;
  a.H = H;
  a.scale = scale;
  return launch_fwd(fused_fwd_kernel<T>, fwd_smem_done[ti], a, B, st);
}

// #6's two launches on `st` (dq with delta, then dk/dv; q, k, v, dout split
// into `planes` in fp32); returns the CUDA error
template <typename T>
int fused_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* bias,
              const float* lse, float* delta, void* dq, void* dk, void* dv, bf16* planes,
              const long long* strides, int B, int H, int S, float scale, cudaStream_t st) {
  if (bad_sizes(B, H, S)) return (int)cudaErrorInvalidValue;
  constexpr int ti = kTerms<T> == 1 ? 0 : 1;
  const long long plane = 3 * (long long)B * H * S * FA_D;
  FusedBwdArgs<T> a{};
  int e = heads_operand(heads<const T>(q, strides), B, H, S, planes, &a.q, st);
  if (!e) e = heads_operand(heads<const T>(k, strides + 3), B, H, S, planes + plane, &a.k, st);
  if (!e) e = heads_operand(heads<const T>(v, strides + 6), B, H, S, planes + 2 * plane, &a.v, st);
  if (!e) e = heads_operand(heads<const T>(dout, strides + 12), B, H, S, planes + 3 * plane, &a.dout, st);
  if (e) return e;
  a.ctx = heads<const T>(o, strides + 9);
  a.dq = heads<T>(dq, strides + 15);
  a.dk = heads<T>(dk, strides + 18);
  a.dv = heads<T>(dv, strides + 21);
  a.bias = bias;
  a.lse = lse;
  a.delta = delta;
  a.S = S;
  a.H = H;
  a.scale = scale;
  return launch_bwd(fused_bwd_dq_kernel<T>, dq_smem_done[ti], fused_bwd_dkdv_kernel<T>, dkdv_smem_done[ti], a,
                    B, st);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The largest head dim the entry points take (their argument D); a library
// without this symbol takes head dim 64 only, and no D.
int attention_max_head_dim() { return anyd::MAX_D; }

// Bytes of scratch fused_attention_fwd (backward = 0) or _bwd (1) needs.
long long fused_attention_workspace(int B, int H, int S, int D, int backward, int f32) {
  return workspace_bytes(B, H, S, D, backward != 0, f32 != 0);
}

// q, k, v [B, H, S, D] and o (output) by element strides (strides[0..11]:
// q, k, v, o as sb, sh, ss; unit stride over D), all bf16 (f32 = 0) or fp32
// (f32 = 1), head dim 1 <= D <= 256; bias [B, S] f32 or null; lse [B, H, S]
// f32 (output); workspace of fused_attention_workspace bytes.  At D = 64 every
// operand's start must be 16-byte aligned and its strides multiples of 8
// elements (16-byte copies); any other D reads any strides.
// Returns the CUDA error of the launches (0 = success).
int fused_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, void* workspace, const long long* strides, int B, int H, int S,
                        int D, int f32, float scale, void* stream) {
  const float* brow = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  bf16* planes = static_cast<bf16*>(workspace);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != FA_D) {
    if (f32) return fused_any_fwd<float>(q, k, v, brow, o, l, planes, strides, B, H, S, D, scale, st);
    return fused_any_fwd<bf16>(q, k, v, brow, o, l, planes, strides, B, H, S, D, scale, st);
  }
  if (f32) return fused_fwd<float>(q, k, v, brow, o, l, planes, strides, B, H, S, scale, st);
  return fused_fwd<bf16>(q, k, v, brow, o, l, planes, strides, B, H, S, scale, st);
}

// q, k, v, o, dout [B, H, S, D] and dq, dk, dv (outputs) by element
// strides (strides[0..23]: q, k, v, o, dout, dq, dk, dv), all bf16 (f32 = 0)
// or fp32 (f32 = 1); bias [B, S] f32 or null; lse [B, H, S] f32 from the
// forward; delta [B, H, S] f32 scratch; workspace of
// fused_attention_workspace bytes.  Returns the CUDA error of the launches.
int fused_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* bias, const void* lse, void* delta, void* dq,
                        void* dk, void* dv, void* workspace, const long long* strides, int B, int H,
                        int S, int D, int f32, float scale, void* stream) {
  const float* brow = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  bf16* planes = static_cast<bf16*>(workspace);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D != FA_D) {
    if (f32)
      return fused_any_bwd<float>(q, k, v, o, dout, brow, l, d, dq, dk, dv, planes, strides, B, H, S, D, scale, st);
    return fused_any_bwd<bf16>(q, k, v, o, dout, brow, l, d, dq, dk, dv, planes, strides, B, H, S, D, scale, st);
  }
  if (f32)
    return fused_bwd<float>(q, k, v, o, dout, brow, l, d, dq, dk, dv, planes, strides, B, H, S, scale, st);
  return fused_bwd<bf16>(q, k, v, o, dout, brow, l, d, dq, dk, dv, planes, strides, B, H, S, scale, st);
}

}  // extern "C"
