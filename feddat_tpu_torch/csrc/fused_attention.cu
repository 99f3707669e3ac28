// Whole-sequence attention for short S, forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel feddat_tpu/ops/fused_attention.py::_fwd_kernel
// (kernel #5, called through _fwd_call): o = softmax(q k^T * scale + bias_row) v
// and lse, per (batch, head), on q/k/v [B, H, S, 64] bf16 and a [B, S] fp32
// padding-bias row.  Backward: replaces _bwd_kernel (kernel #6, called through
// _fused_bwd): dq, dk, dv from q, k, v, the bias row, o, dO and lse, P
// recomputed from lse.  Same functions, same rounding points as the TPU
// kernels (listed in attn_fwd.cuh and attn_bwd.cuh).
//
// What bounds them on the H100: at the training shape (B=64, S=185, H=12)
// #5 does 6.7 GFLOP of bf16 products (q.k^T and P.v; ~7 us at 989 TFLOP/s)
// and must move ~73 MB (q, k, v, o, lse; ~22 us at 3.35 TB/s); #6 does 16.8
// GFLOP (s, dP, dv, dq, dk; ~17 us) and moves ~147 MB (q, k, v, o, dO in,
// dq, dk, dv out; ~44 us).  Both are bound by bytes.
//
// What the design does about it.  The TPU kernels run one batch element with
// all heads per grid step, because VMEM holds the [H, S, S] logits; a Hopper
// block has 227 KB.  So:
//   #5 is attn_fwd.cuh::attn_kernel, the attention stage of kernel #1: one
//      block per (64-query tile, head, batch element), that tile's fp32 logits
//      over all keys in shared memory (exact two-pass softmax), mma.sync for
//      q.k^T and P.v, lse written out;
//   #6 is attn_bwd.cuh's two launches, the attention core of #3 and #4: a dQ
//      launch that also writes delta = rowsum(dO * o), then a dK/dV launch,
//      each accumulating in fp32 registers and casting once.
// Every operand and output is a Heads view addressed by strides, so the
// [B, H, S, 64] views that split() makes of [B, S, Dm] projections are read,
// and the outputs written, in place: no transposing copy on either side.
// The only device-memory traffic beyond the bound's is K/V re-read per query
// tile (3 tiles at S=185, from L2) and the [B, H, S] delta scratch.  wgmma/TMA
// and larger tiles are later work.

#include "attn_bwd.cuh"
#include "attn_fwd.cuh"

using namespace port;

namespace {

// strides: 3 per operand (sb, sh, ss), in the order of the entry point's arguments
template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return {static_cast<T*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Largest S the forward kernel's shared memory holds (the wrapper checks).
int fused_attention_max_seq(void) { return attn_fwd_max_seq(); }

// q, k, v [B, H, S, 64] bf16 and o (output) by element strides
// (strides[0..11]: q, k, v, o); bias [B, S] f32 or null; lse [B, H, S] f32
// (output).  Returns the CUDA error of the launch (0 = success).
int fused_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, const long long* strides, int B, int H, int S, float scale,
                        void* stream) {
  AttnFwdArgs a{};
  a.q = heads<const bf16>(q, strides);
  a.k = heads<const bf16>(k, strides + 3);
  a.v = heads<const bf16>(v, strides + 6);
  a.o = heads<bf16>(o, strides + 9);
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<float*>(lse);
  a.S = S;
  a.H = H;
  a.scale = scale;
  return launch_attn_fwd(a, B, reinterpret_cast<cudaStream_t>(stream));
}

// q, k, v, o, dout [B, H, S, 64] bf16 and dq, dk, dv (outputs) by element
// strides (strides[0..23]: q, k, v, o, dout, dq, dk, dv); bias [B, S] f32 or
// null; lse [B, H, S] f32 from the forward; delta [B, H, S] f32 scratch.
// Returns the CUDA error of the launches.
int fused_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* bias, const void* lse, void* delta, void* dq,
                        void* dk, void* dv, const long long* strides, int B, int H, int S,
                        float scale, void* stream) {
  AttnBwdArgs a{};
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
  if (S < 1) return (int)cudaErrorInvalidValue;
  return launch_attn_bwd(a, B, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
