// Hopper (sm_90a) building blocks of the flash-attention kernels #7-#9
// (flash_attention.cu) and of the GEMM of #3 and #4 (gemm_sm90.cuh):
// 128-byte swizzled bf16 tiles filled by cp.async, wgmma descriptors of
// those tiles, the 64 x 64 x 16 warpgroup products of the attention kernels
// (on bf16 operands, or on the three bf16 term tiles of fp32 ones), and the
// raising of a kernel's dynamic shared-memory limit.
//
// Every operand tile is [64 rows][64] bf16: 128-byte rows whose 16-byte
// chunks are swizzled as wgmma's 128B layout (and TMA's SWIZZLE_128B) wants,
// chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4), in a tile whose shared
// address is 1024-byte aligned.  One such tile of a natural [s][d] operand is
// read both ways, so no operand is ever transposed in shared memory:
//   * K-major (rows are M or N, the 64 columns are K): q.k^T's Q and K, dp's
//     dO and V, s^T's K and Q, dp^T's V and dO;
//   * MN-major, wgmma's transposed B (rows are K, the 64 columns are N): P.V's
//     V, dQ's K, dV's dO, dK's Q.
#pragma once

#include "common.cuh"

namespace port {
namespace sm90 {

constexpr int TILE_ROWS = 64;
constexpr int TILE_BYTES = TILE_ROWS * 128;  // one [64][64] bf16 tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (8 bf16) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
  return static_cast<uint32_t>(r * 128 + ((chunk ^ (r & 7)) << 4));
}

// cp.async of 16 (or 4) bytes into shared memory, zero-filled when !valid
// (src must still be a mapped address; nothing is read from it then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// This thread's copies have landed; then make them visible to wgmma's async
// proxy (the caller's __syncthreads() makes everyone's visible to all).
// With PENDING > 0, the newest PENDING commit groups may still be in flight.
template <int PENDING = 0>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// rows [r0, r0 + 64) of one (batch, head)'s [S, 64] operand `src` (row stride
// ss elements) into a swizzled tile by cp.async; rows past S are zero
template <int THREADS>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src, long long ss, int r0, int S,
                                          int tid) {
  static_assert((TILE_ROWS * 8) % THREADS == 0, "chunks per thread");
#pragma unroll
  for (int j = 0; j < TILE_ROWS * 8 / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i >> 3, c = i & 7;
    const bool ok = r0 + r < S;
    cp_async16(tile + swz(r, c), src + (ok ? (long long)(r0 + r) * ss : 0) + c * 8, ok);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (in 16-byte units), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// K-major: 8-row groups 1024 B apart (SBO), LBO unused; k-step ks (16
// columns, 32 B) moves the start inside the swizzle atom, as CUTLASS does.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return desc_sw128(tile + ks * 32, 16, 1024);
}

// MN-major: K runs down the rows, 8-row groups 1024 B apart (SBO); N = 64
// is one swizzle atom wide, so LBO (the next 64 columns) is never used;
// k-step ks starts 16 rows further down.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return desc_sw128(tile + ks * 16 * 128, TILE_BYTES, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pin an accumulator's registers at this point of the program: the compiler
// may not move a read or write of them across it (wgmma writes them
// asynchronously, behind the compiler's back, until wg_wait_all).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FS_ACC32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),  \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FS_D32                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// The accumulator of a 64 x 64 fp32 product: warp w of the warpgroup holds
// rows 16w + g and 16w + g + 8 (g = lane / 4); d[nt * 4 + e] is row
// 16w + g + 8 (e >> 1), column nt * 8 + 2 (lane % 4) + (e & 1), the mma.sync
// C fragment of each 8-column tile.  Its A fragment in registers for a k-step
// is the mma.sync m16n8k16 A fragment of the warp's 16 rows.

// d (+)= A . B^T, A [64 M][16 K] and B [64 N][16 K] both K-major in shared
// memory; d is overwritten when acc == 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FS_ACC32(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A . B, A [64 M][16 K] bf16 in registers, B [16 K][64 N] MN-major in
// shared memory (wgmma's transposed B); d is overwritten when acc == 0
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FS_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// the A fragments (bf16 hi, bf16 lo = x - hi) of k-step ks (16 columns) from
// a 64 x 64 fp32 accumulator, so that hi + lo carries x at fp32 precision
__device__ __forceinline__ void hilo_frags(const float (&x)[32], int ks, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = x[ks * 8 + 2 * i], b = x[ks * 8 + 2 * i + 1];
    hi[i] = pack_bf16(a, b);
    lo[i] = pack_bf16(a - round_bf16(a), b - round_bf16(b));
  }
}

// the bf16 A fragment of k-step ks (16 columns) of a 64 x 64 fp32 accumulator:
// term t of each value's split (t = 0: the value rounded to bf16 once, round
// to nearest even)
__device__ __forceinline__ void term_frag(const float (&x)[32], int ks, int t, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(split_term(x[ks * 8 + 2 * i], t), split_term(x[ks * 8 + 2 * i + 1], t));
}

// d = A . B^T over the 64 head dims: A, B [64 rows][64] swizzled tiles, NT
// term tiles each (consecutive), the term pairs in common.cuh's order
template <int NT>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, uint32_t b) {
  constexpr int NP = NT == 3 ? 6 : 1;
#pragma unroll
  for (int pr = 0; pr < NP; ++pr)
#pragma unroll
    for (int ks = 0; ks < TILE_ROWS / 16; ++ks)
      wgmma_ss(d, desc_k(a + (NP == 1 ? 0 : pair_a(pr)) * TILE_BYTES, ks),
               desc_k(b + (NP == 1 ? 0 : pair_b(pr)) * TILE_BYTES, ks), pr + ks);
}

// d += x . B over 64 rows (d = x . B with FRESH): x a 64 x 64 fp32
// accumulator taken as NT bf16 terms (NT = 1: bf16(x)), B natural [64
// rows][64] swizzled tiles (NT terms) read as wgmma's transposed B, the term
// pairs in common.cuh's order
template <int NT, bool FRESH = false>
__device__ __forceinline__ void product_rs(float (&d)[32], const float (&x)[32], uint32_t b) {
  constexpr int NP = NT == 3 ? 6 : 1;
#pragma unroll
  for (int pr = 0; pr < NP; ++pr)
#pragma unroll
    for (int ks = 0; ks < TILE_ROWS / 16; ++ks) {
      uint32_t a[4];
      term_frag(x, ks, NP == 1 ? 0 : pair_a(pr), a);
      wgmma_rs_t(d, a, desc_mn(b + (NP == 1 ? 0 : pair_b(pr)) * TILE_BYTES, ks), FRESH ? pr + ks : 1);
    }
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (`done` remembers the devices); a launch that asks for more than the limit
// is refused with cudaErrorInvalidValue and never runs.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev] >= bytes)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return err;
}

}  // namespace sm90
}  // namespace port
