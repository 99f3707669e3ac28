// The instances of flash_dp.cuh's #8/#9 bodies (bf16, every head dim up to
// 256 but 64) and their launches: a part of flash_attention.cu's library,
// compiled apart (ops/_build.py's PARTS) with its device code split over the
// host's cores.  flash_attention.cu's C entry points call flash_dp_bwd.
#include "flash_dp.cuh"

using namespace port;

namespace {

// #9's entry before #8's, as in flash_attention.cu
template <int DP>
__global__ void __launch_bounds__(fdp::THREADS, 1)
    flash_dp_bwd_dkv_kernel(anyd::AnyArgs<bf16> p, int mode, int nstg) {
  fdp::dkv_body<DP>(p, mode, nstg);
}
template <int DP>
__global__ void __launch_bounds__(fdp::THREADS, fdp::dq_blocks<DP>())
    flash_dp_bwd_dq_kernel(anyd::AnyArgs<bf16> p, int mode, int nstg) {
  fdp::dq_body<DP>(p, mode, nstg);
}

// each instance's shared-memory limit, raised once per device
int dp_done[2][fdp::MAX_D / 16][64];

template <bool DKV, int DP>
int launch_dp(const anyd::AnyArgs<bf16>& a, int B, cudaStream_t st) {
  const int mode = a.bias == nullptr ? fdp::BIAS_NONE : a.bsq == 0 ? fdp::BIAS_ROW : fdp::BIAS_TILE;
  const int nstg = fdp::smem_bytes<DKV, DP>(mode, 2) <= fdp::MAX_SMEM ? 2 : 1;
  const int bytes = fdp::smem_bytes<DKV, DP>(mode, nstg);
  const auto kernel = DKV ? flash_dp_bwd_dkv_kernel<DP> : flash_dp_bwd_dq_kernel<DP>;
  const cudaError_t err = sm90::allow_smem(kernel, bytes, dp_done[DKV][DP / 16 - 1]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((DKV ? a.Skv : a.Sq) + fdp::Geo<DP>::BR - 1) / fdp::Geo<DP>::BR, a.H, B);
  kernel<<<grid, fdp::THREADS, bytes, st>>>(a, mode, nstg);
  return (int)cudaGetLastError();
}

// the instance of head dim a.D: D padded to 16 * I
template <bool DKV, int I = 1>
int dispatch_dp(const anyd::AnyArgs<bf16>& a, int B, cudaStream_t st) {
  if constexpr (16 * I > fdp::MAX_D) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (fdp::padded(a.D) == 16 * I) return launch_dp<DKV, 16 * I>(a, B, st);
    return dispatch_dp<DKV, I + 1>(a, B, st);
  }
}

}  // namespace

int port::fdp::flash_dp_bwd(const anyd::AnyArgs<bf16>& a, bool dkv, int B, cudaStream_t st) {
  if (a.D < 1 || a.D > MAX_D || a.D == 64) return (int)cudaErrorInvalidValue;
  return dkv ? dispatch_dp<true>(a, B, st) : dispatch_dp<false>(a, B, st);
}
