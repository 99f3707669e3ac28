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

#include "attn_sm90.cuh"

using namespace port;
using namespace port::attn;

namespace {

template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return {static_cast<T*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

__global__ void __launch_bounds__(FA_THREADS, FWD_MIN_BLOCKS) fused_fwd_kernel(FusedFwdArgs<bf16> p) {
  fused_fwd_body(p);
}

// dkdv before dq (attn_sm90.cuh)
__global__ void __launch_bounds__(FA_THREADS, DKDV_MIN_BLOCKS) fused_bwd_dkdv_kernel(FusedBwdArgs<bf16> p) {
  fused_bwd_dkdv_body(p);
}

__global__ void __launch_bounds__(FA_THREADS, DQ_MIN_BLOCKS) fused_bwd_dq_kernel(FusedBwdArgs<bf16> p) {
  fused_bwd_dq_body(p);
}

// the kernels' shared-memory limits, raised once per device (this library's own flags)
int fwd_smem_done[64], dq_smem_done[64], dkdv_smem_done[64];

// #5 over B batch elements on `st`; returns the CUDA error of the launch
int launch_fused_fwd(const FusedFwdArgs<bf16>& a, int B, cudaStream_t st) {
  return launch_fwd(fused_fwd_kernel, fwd_smem_done, a, B, st);
}

// #6's two launches on `st` (dq with delta, then dk/dv); returns the CUDA error
int launch_fused_bwd(const FusedBwdArgs<bf16>& a, int B, cudaStream_t st) {
  return launch_bwd(fused_bwd_dq_kernel, dq_smem_done, fused_bwd_dkdv_kernel, dkdv_smem_done, a, B, st);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k, v [B, H, S, 64] bf16 and o (output) by element strides
// (strides[0..11]: q, k, v, o as sb, sh, ss); bias [B, S] f32 or null; lse
// [B, H, S] f32 (output).  Every bf16 operand's start must be 16-byte aligned
// and its strides multiples of 8 elements (cp.async copies 16 bytes).
// Returns the CUDA error of the launch (0 = success).
int fused_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, const long long* strides, int B, int H, int S, float scale,
                        void* stream) {
  FusedFwdArgs<bf16> a{};
  a.q = heads<const bf16>(q, strides);
  a.k = heads<const bf16>(k, strides + 3);
  a.v = heads<const bf16>(v, strides + 6);
  a.o = heads<bf16>(o, strides + 9);
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<float*>(lse);
  a.S = S;
  a.H = H;
  a.scale = scale;
  return launch_fused_fwd(a, B, reinterpret_cast<cudaStream_t>(stream));
}

// q, k, v, o, dout [B, H, S, 64] bf16 and dq, dk, dv (outputs) by element
// strides (strides[0..23]: q, k, v, o, dout, dq, dk, dv); bias [B, S] f32 or
// null; lse [B, H, S] f32 from the forward; delta [B, H, S] f32 scratch.
// Returns the CUDA error of the launches.
int fused_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* bias, const void* lse, void* delta, void* dq,
                        void* dk, void* dv, const long long* strides, int B, int H, int S,
                        float scale, void* stream) {
  FusedBwdArgs<bf16> a{};
  a.q = heads<const bf16>(q, strides);
  a.k = heads<const bf16>(k, strides + 3);
  a.v = heads<const bf16>(v, strides + 6);
  a.ctx = heads<const bf16>(o, strides + 9);
  a.dout = heads<const bf16>(dout, strides + 12);
  a.dq = heads<bf16>(dq, strides + 15);
  a.dk = heads<bf16>(dk, strides + 18);
  a.dv = heads<bf16>(dv, strides + 21);
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.S = S;
  a.H = H;
  a.scale = scale;
  return launch_fused_bwd(a, B, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
