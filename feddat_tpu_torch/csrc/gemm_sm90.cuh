// The GEMM of the attention-block forward #1 and backward #3 (attn_block.cu)
// and of the whole-layer backward #4 (layer_block.cu), for Hopper (sm_90a):
// C[M, N] = A[M, K] . B with bf16 operands and fp32 sums, port::GemmArgs's
// contract (common.cuh) on wgmma, the output in the element type T:
//   * both B layouts: B_NT (B given as [N, K], an nn.Linear weight) and B_NN
//     (B given as [K, N]);
//   * N segments (B_NT: q|k|v in one launch, each with its weight, bias and
//     output) and K segments (B_NN: dx = dq.Wq + dk.Wk + dv.Wv, K = 3 Dm);
//   * the six epilogues of gemm_epi_store, FFN1's fp32 p1 with bf16 gelu(p1)
//     included;
//   * a ragged M.  N must be a multiple of 128, K and every segment of K of
//     64, an N segment of 128.  No LayerNorm prologue: a caller that needs
//     LN(x) as A writes it once with common.cuh's ln_fwd_rows_kernel.
//
// What bounds it.  At the training shape (M = 64 * 185 = 11 840 rows, Dm 768,
// F 3072) the products run from K = 768 to 3072 with N = 768 to 3072: 14-56
// GFLOP each, 14-57 us at 989 TFLOP/s.  FFN1 writes fp32 p1 and bf16 ge
// (218 MB, 65 us at 3.35 TB/s) and the GELU backward reads p1, so bytes bound
// those two; operations bound the rest.
//
// Design.  One block of two consumer warpgroups owns a 128 x 128 tile of C,
// 64 rows per warpgroup, and walks K in steps of 64 (one 128-byte swizzle row
// of bf16):
//   * each step's A tile ([128 rows][64 k], two swizzled [64][64] tiles) and
//     B tile go through a ring of G9_STAGES stages filled by cp.async, all 256
//     threads copying; while the warpgroups compute on step j, steps j+1 and
//     j+2 are in flight, the latter's copies issued behind step j's products.
//     Rows past M are zero-filled (source size 0);
//   * every product is wgmma.m64n128k16 with A and B read from shared memory.
//     A B_NT tile is [128 n][64 k], K-major like A.  A B_NN tile is kept as
//     it lies in memory, [64 k][128 n], as two 64-column swizzled tiles read
//     through wgmma's transposed (MN-major) descriptor whose leading byte
//     offset is the second tile's: no operand is transposed in shared memory;
//   * the accumulator has mma.sync's C layout per warp, so the epilogue
//     writes each thread's column pairs through gemm_epi_load/gemm_epi_store,
//     with the reads of 4 column tiles (bias, FFN2's h, the GELU backward's
//     fp32 p1) issued before their stores (8 made ptxas spill);
//   * 97 KB of shared memory and <= 128 registers a thread let two blocks
//     share an SM: one block's epilogue (FFN1 writes 96 KB a tile) and its
//     waits at the ring's barrier overlap the other's products.
// Every sum is taken in one fixed order (no split K, no atomics), so a second
// call is bitwise equal.  TMA with a producer warp is later work.
#pragma once

#include "flash_sm90.cuh"

namespace port {
namespace sm90 {

constexpr int G9_BM = 128;
constexpr int G9_BN = 128;
constexpr int G9_BK = 64;
constexpr int G9_STAGES = 3;
constexpr int G9_MIN_BLOCKS = 2;            // blocks per SM the registers must allow
constexpr int G9_EPI_TILES = 4;             // 8-column tiles whose epilogue reads go together
constexpr int G9_THREADS = 2 * G9_BM;       // one warpgroup per 64 rows
constexpr int G9_A_BYTES = G9_BM / 64 * TILE_BYTES;  // A: [64][64] tiles, one per warpgroup
constexpr int G9_STAGE_BYTES = G9_A_BYTES + G9_BN / 64 * TILE_BYTES;
constexpr int G9_SMEM = 1024 + G9_STAGES * G9_STAGE_BYTES;

#define G9_ACC64(d)                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),     \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),      \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),      \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),      \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),      \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define G9_D64                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "  \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "  \
  "%59, %60, %61, %62, %63}"

// d += A . B for a warpgroup: A [64 M][16 K] K-major, B [16 K][128 N] K-major
// (TRANS_B = 0) or MN-major (1), both in shared memory.  d[nt * 4 + e] is row
// 16 w + g + 8 (e >> 1), column nt * 8 + 2 (lane % 4) + (e & 1) of warp w.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " G9_D64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : G9_ACC64(d)
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// MN-major descriptor of a B_NN stage: two [64 k][64 n] tiles, the second
// (columns 64-127) TILE_BYTES after the first (the leading byte offset);
// 8-row groups of k 1024 B apart; k-step ks starts 16 rows further down.
__device__ __forceinline__ uint64_t desc_mn128(uint32_t tiles, int ks) {
  return desc_sw128(tiles + ks * 16 * 128, TILE_BYTES, 1024);
}

template <int BL, int EPI, typename T>
__global__ void __launch_bounds__(G9_THREADS, G9_MIN_BLOCKS) gemm_sm90_kernel(GemmArgs p) {
  extern __shared__ __align__(16) uint8_t g9_smem[];
  const uint32_t at = smem_addr(g9_smem);
  const uint32_t base = (at + 1023u) & ~1023u;  // the swizzle is a function of the address
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * G9_BM, n0 = blockIdx.x * G9_BN;
  const int nk = p.K / G9_BK, nsteps = kPairs<T> * nk;  // term pair kt / nk, k-step kt % nk

  // start the copies of step kt into ring stage kt % G9_STAGES (one commit group)
  auto stage = [&](int kt) {
    const uint32_t sa = base + (kt % G9_STAGES) * G9_STAGE_BYTES, sb = sa + G9_A_BYTES;
    const int pr = kt / nk, k0 = (kt - pr * nk) * G9_BK, seg = k0 / p.a_kseg;
    const bf16* A = p.a[seg] + term_a<T>(pr) * p.a_term + (k0 - seg * p.a_kseg);
#pragma unroll
    for (int j = 0; j < G9_BM * 8 / G9_THREADS; ++j) {  // G9_BM rows x 8 chunks of 16 B
      const int i = tid + j * G9_THREADS, r = i >> 3, c = i & 7;
      const bool ok = m0 + r < p.M;
      cp_async16(sa + swz(r, c), A + (size_t)(ok ? m0 + r : 0) * p.lda + c * 8, ok);
    }
    if (BL == B_NT) {  // [128 n][64 k]
      const int sg = n0 / p.b_seg;
      const bf16* Bp = p.b[sg] + term_b<T>(pr) * p.b_term + (size_t)(n0 - sg * p.b_seg) * p.ldb + k0;
#pragma unroll
      for (int j = 0; j < G9_BN * 8 / G9_THREADS; ++j) {
        const int i = tid + j * G9_THREADS, r = i >> 3, c = i & 7;
        cp_async16(sb + swz(r, c), Bp + (size_t)r * p.ldb + c * 8, true);
      }
    } else {  // [64 k][128 n] as two [64 k][64 n] tiles
      const int sg = k0 / p.b_seg;
      const bf16* Bp = p.b[sg] + term_b<T>(pr) * p.b_term + (size_t)(k0 - sg * p.b_seg) * p.ldb + n0;
#pragma unroll
      for (int j = 0; j < G9_BK * (G9_BN / 8) / G9_THREADS; ++j) {
        const int i = tid + j * G9_THREADS, r = i / (G9_BN / 8), c = i % (G9_BN / 8);
        cp_async16(sb + (c >> 3) * TILE_BYTES + swz(r, c & 7), Bp + (size_t)r * p.ldb + c * 8, true);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < G9_STAGES - 1; ++s) {
    if (s < nsteps) stage(s);
    else cp_async_commit();  // an empty group keeps the count of groups in step
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<G9_STAGES - 2>();  // this thread's copies of step kt have landed
    __syncthreads();  // everyone's; both warpgroups are done with step kt-1's stage
    const uint32_t sa = base + (kt % G9_STAGES) * G9_STAGE_BYTES, sb = sa + G9_A_BYTES;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < G9_BK / 16; ++ks) {
      const uint64_t da = desc_k(sa + wg * TILE_BYTES, ks);
      if (BL == B_NT) wgmma_m64n128<0>(acc, da, desc_k(sb, ks));
      else wgmma_m64n128<1>(acc, da, desc_mn128(sb, ks));
    }
    wg_commit();
    // the copies are issued while the products run; they refill step kt-1's stage
    if (kt + G9_STAGES - 1 < nsteps) stage(kt + G9_STAGES - 1);
    else cp_async_commit();
    wg_wait_all();
    pin(acc);
  }

  // The epilogue, G9_EPI_TILES 8-column tiles at a time: all of a group's
  // reads (bias, aux) are issued before its first store.  Stores through
  // GemmArgs's pointers may alias the reads as far as the compiler knows, so
  // one store before each read would make every read a round trip of its own.
  const int g = lane >> 2, tig = lane & 3;
  const int row[2] = {m0 + wg * 64 + warp * 16 + g, m0 + wg * 64 + warp * 16 + g + 8};
#pragma unroll
  for (int t0 = 0; t0 < G9_BN / 8; t0 += G9_EPI_TILES) {
    EpiIn in[G9_EPI_TILES][2];
#pragma unroll
    for (int t = 0; t < G9_EPI_TILES; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row[h] < p.M) in[t][h] = gemm_epi_load<EPI, T>(p, row[h], n0 + (t0 + t) * 8 + tig * 2);
#pragma unroll
    for (int t = 0; t < G9_EPI_TILES; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row[h] < p.M)
          gemm_epi_store<EPI, T>(p, row[h], n0 + (t0 + t) * 8 + tig * 2, acc[(t0 + t) * 4 + 2 * h],
                              acc[(t0 + t) * 4 + 2 * h + 1], in[t][h]);
  }
}

// ------------------------------------------------- any N, K and segment
// The product of gemm_sm90_kernel for a shape its tiles do not cover: N or K
// not a multiple of the tile, or N or K segments (q|k|v, dx's dq|dk|dv) that
// are not (Dm = 192, 48, ...).  The same block, ring, wgmma chain, term-pair
// order and k order, with three differences:
//   * each segment is tiled on its own (TailShape): grid.x walks the N
//     segments' ceil(width / 128) tiles and the k-steps walk each K
//     segment's ceil(width / 64) steps, so no tile spans two segments;
//   * rows and columns past M, a segment's N width or its K width are
//     zero-filled (a zero k column adds nothing to the sums): 16-byte copies
//     when every row stride, segment width and start allows (`vec`), else
//     element loads into the same swizzled chunks;
//   * the epilogue stores element by element (gemm_epi_one), guarded by M
//     and the segment's width, so no pair of columns need be aligned.
// The head-dim-64 shapes (Dm and F multiples of 128) never take this kernel.
struct TailShape {
  int segw_n, tn;  // an N segment's width and its 128-column tiles
  int segw_k, tk;  // a K segment's width and its 64-deep steps
  int nseg_k;
  int vec;         // 16-byte copies
};

__device__ __forceinline__ unsigned short bf16_bits(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// 8 adjacent bf16 of one row into 16-byte chunk c of swizzled tile row r:
// the first n of them (0 <= n <= 8) from src, the rest zero
__device__ __forceinline__ void chunk_copy(uint32_t dst, const bf16* src, int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, n > 0);  // src is a mapped address even when nothing is read
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < n ? bf16_bits(src + 2 * e) : 0u;
    const uint32_t hi = 2 * e + 1 < n ? bf16_bits(src + 2 * e + 1) : 0u;
    w[e] = lo | (hi << 16);
  }
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// one output element of the epilogue: row, column col of N segment seg
template <int EPI, typename T>
__device__ __forceinline__ void gemm_epi_one(const GemmArgs& p, int row, int seg, int col, float v) {
  const size_t off = (size_t)row * p.ldc + col;
  T* const c0 = static_cast<T*>(p.c[0]) + off;
  if (EPI == EPI_BIAS) {
    static_cast<T*>(p.c[seg])[off] = from_f<T>(v + p.bias[seg][col]);
  } else if (EPI == EPI_OUT) {
    *c0 = from_f<T>(v);
  } else if (EPI == EPI_F32) {
    p.c_f32[off] = v;
  } else if (EPI == EPI_FFN1) {
    const float pre = v + p.bias[0][col];
    p.c_f32[off] = pre;
    *c0 = from_f<T>(gelu_poly(pre));
  } else if (EPI == EPI_FFN2) {
    const float f = round_t<T>(v + p.bias[0][col]);
    *c0 = from_f<T>(to_f(static_cast<const T*>(p.aux)[off]) + f);
  } else if (EPI == EPI_GELU_BWD) {
    *c0 = from_f<T>(v * gelu_grad_poly(p.aux_f32[off]));
  }
}

template <int BL, int EPI, typename T>
__global__ void __launch_bounds__(G9_THREADS, 1) gemm_tail_kernel(GemmArgs p, TailShape ts) {
  extern __shared__ __align__(16) uint8_t g9_smem[];
  const uint32_t at = smem_addr(g9_smem);
  const uint32_t base = (at + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nseg = blockIdx.x / ts.tn, n0 = (blockIdx.x % ts.tn) * G9_BN;  // n0 within the segment
  const int m0 = blockIdx.y * G9_BM;
  const int nk = ts.nseg_k * ts.tk, nsteps = kPairs<T> * nk;
  const bool vec = ts.vec != 0;

  // step kt: term pair kt / nk; K segment ks, k0 within it
  auto stage = [&](int kt) {
    const uint32_t sa = base + (kt % G9_STAGES) * G9_STAGE_BYTES, sb = sa + G9_A_BYTES;
    const int pr = kt / nk, kq = kt - pr * nk, ks = kq / ts.tk, k0 = (kq % ts.tk) * G9_BK;
    const int kleft = ts.segw_k - k0;  // valid k of this step: [0, min(64, kleft))
    const bf16* A = p.a[ks] + term_a<T>(pr) * p.a_term + k0;
#pragma unroll
    for (int j = 0; j < G9_BM * 8 / G9_THREADS; ++j) {
      const int i = tid + j * G9_THREADS, r = i >> 3, c = i & 7;
      const int n = m0 + r < p.M ? min(8, max(0, kleft - c * 8)) : 0;
      chunk_copy(sa + swz(r, c), A + (size_t)(n > 0 ? m0 + r : 0) * p.lda + (n > 0 ? c * 8 : 0), n, vec);
    }
    if (BL == B_NT) {  // [128 n][64 k] of N segment nseg, k at ks * segw_k + k0
      const bf16* Bp = p.b[nseg] + term_b<T>(pr) * p.b_term + (size_t)ks * ts.segw_k + k0;
#pragma unroll
      for (int j = 0; j < G9_BN * 8 / G9_THREADS; ++j) {
        const int i = tid + j * G9_THREADS, r = i >> 3, c = i & 7;
        const int n = n0 + r < ts.segw_n ? min(8, max(0, kleft - c * 8)) : 0;
        chunk_copy(sb + swz(r, c), Bp + (size_t)(n > 0 ? n0 + r : 0) * p.ldb + (n > 0 ? c * 8 : 0), n, vec);
      }
    } else {  // [64 k][128 n] of K segment ks as two [64 k][64 n] tiles
      const bf16* Bp = p.b[ks] + term_b<T>(pr) * p.b_term + (size_t)k0 * p.ldb + n0;
#pragma unroll
      for (int j = 0; j < G9_BK * (G9_BN / 8) / G9_THREADS; ++j) {
        const int i = tid + j * G9_THREADS, r = i / (G9_BN / 8), c = i % (G9_BN / 8);
        const int n = r < kleft ? min(8, max(0, ts.segw_n - n0 - c * 8)) : 0;
        chunk_copy(sb + (c >> 3) * TILE_BYTES + swz(r, c & 7), Bp + (n > 0 ? (size_t)r * p.ldb + c * 8 : 0), n, vec);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < G9_STAGES - 1; ++s) {
    if (s < nsteps) stage(s);
    else cp_async_commit();
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<G9_STAGES - 2>();
    __syncthreads();
    const uint32_t sa = base + (kt % G9_STAGES) * G9_STAGE_BYTES, sb = sa + G9_A_BYTES;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < G9_BK / 16; ++ks) {
      const uint64_t da = desc_k(sa + wg * TILE_BYTES, ks);
      if (BL == B_NT) wgmma_m64n128<0>(acc, da, desc_k(sb, ks));
      else wgmma_m64n128<1>(acc, da, desc_mn128(sb, ks));
    }
    wg_commit();
    if (kt + G9_STAGES - 1 < nsteps) stage(kt + G9_STAGES - 1);
    else cp_async_commit();
    wg_wait_all();
    pin(acc);
  }

  const int g = lane >> 2, tig = lane & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int t = 0; t < G9_BN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1), col = n0 + t * 8 + tig * 2 + (e & 1);
      if (row < p.M && col < ts.segw_n) gemm_epi_one<EPI, T>(p, row, nseg, col, acc[t * 4 + e]);
    }
}

}  // namespace sm90

// The devices on which this library's instance of gemm_sm90_kernel<BL, EPI, T>
// has its limit raised.  Internal linkage on purpose: a static inside an
// inline function would be one object across every loaded library (a unique
// symbol), so one library's raised limit would let another skip raising its own.
template <int BL, int EPI, typename T>
static int g9_smem_done[64];
template <int BL, int EPI, typename T>
static int g9_tail_smem_done[64];

// The tail kernel's segments (GemmArgs's defaults filled in by
// gemm_prepare); false for a shape it does not take either: M < 1, or
// segments that do not divide N or K, or B_NN's K segments not A's.
template <int BL, int EPI>
inline bool gemm_tail_shape(const GemmArgs& p, sm90::TailShape* ts) {
  ts->segw_n = BL == B_NT ? p.b_seg : p.N;
  ts->segw_k = p.a_kseg;
  if (p.M < 1 || ts->segw_n < 1 || ts->segw_k < 1 || p.N % ts->segw_n || p.K % ts->segw_k) return false;
  if (BL == B_NN && p.b_seg != p.a_kseg) return false;
  if (EPI == EPI_BIAS && p.c_seg != ts->segw_n) return false;
  if (EPI != EPI_BIAS && p.N != ts->segw_n) return false;  // only the bias epilogue writes N segments
  ts->tn = (ts->segw_n + sm90::G9_BN - 1) / sm90::G9_BN;
  ts->tk = (ts->segw_k + sm90::G9_BK - 1) / sm90::G9_BK;
  ts->nseg_k = p.K / ts->segw_k;
  bool vec = p.lda % 8 == 0 && p.ldb % 8 == 0 && ts->segw_k % 8 == 0 && p.a_term % 8 == 0 && p.b_term % 8 == 0 &&
             (BL == B_NT || p.N % 8 == 0);
  for (int i = 0; i < ts->nseg_k && i < 3; ++i) vec = vec && reinterpret_cast<uintptr_t>(p.a[i]) % 16 == 0;
  const int nb = BL == B_NT ? p.N / ts->segw_n : ts->nseg_k;
  for (int i = 0; i < nb && i < 3; ++i) vec = vec && reinterpret_cast<uintptr_t>(p.b[i]) % 16 == 0;
  ts->vec = vec;
  return true;
}

// Launches C = A . B with the given layout and epilogue on `st` through
// sm90::gemm_sm90_kernel; returns the CUDA error (cudaErrorInvalidValue for a
// shape the tiles do not cover).  Raises the kernel's dynamic shared-memory
// limit once per device.
template <int BL, int EPI, typename T>
inline int launch_gemm_sm90(GemmArgs p, cudaStream_t st) {
  if (!gemm_prepare<BL, EPI>(p, sm90::G9_BN, sm90::G9_BK)) {
    sm90::TailShape ts;
    if (!gemm_tail_shape<BL, EPI>(p, &ts)) return (int)cudaErrorInvalidValue;
    const auto kernel = sm90::gemm_tail_kernel<BL, EPI, T>;
    const cudaError_t err = sm90::allow_smem(kernel, sm90::G9_SMEM, g9_tail_smem_done<BL, EPI, T>);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ts.tn * (p.N / ts.segw_n), (p.M + sm90::G9_BM - 1) / sm90::G9_BM);
    kernel<<<grid, sm90::G9_THREADS, sm90::G9_SMEM, st>>>(p, ts);
    return (int)cudaGetLastError();
  }
  const cudaError_t err =
      sm90::allow_smem(sm90::gemm_sm90_kernel<BL, EPI, T>, sm90::G9_SMEM, g9_smem_done<BL, EPI, T>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.N / sm90::G9_BN, (p.M + sm90::G9_BM - 1) / sm90::G9_BM);
  sm90::gemm_sm90_kernel<BL, EPI, T><<<grid, sm90::G9_THREADS, sm90::G9_SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

// The bf16 terms of a layer's fp32 weights, each [Dm, Dm] or [F, Dm]-sized
// matrix split into its planes `term` elements apart (bf16 weights are their
// own operands: nothing is written).  w and ops hold n matrices of `size`
// elements each; returns the CUDA error.
template <typename T>
inline int weight_operands(const T* const* w, int n, long long size, bf16* planes, long long term,
                           const bf16** ops, cudaStream_t st) {
  for (int i = 0; i < n; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      ops[i] = planes + i * size;
      if (int err = launch_split3(reinterpret_cast<const float*>(w[i]), planes + i * size, size, term, st))
        return err;
    } else {
      ops[i] = reinterpret_cast<const bf16*>(w[i]);
    }
  }
  return 0;
}

// An attention block's q|k|v = T(xin . W^T + b) on `st`: with gamma,
// xin = T(LN1(x)) written first into `xln` ([M, Dm]) by one row pass, else
// xin = x; then one GEMM with an N segment per projection, each into its
// [M, Dm] plane of qkv.  w holds the projections' operands (bf16 weights, or
// the planes of fp32 ones, w_term apart); in fp32, xin is split into `xs`
// (3 M Dm bf16) first.  #1's forward and #3's and #4's recompute all call
// this, so the backward rebuilds p from the forward's own q/k/v bitwise.
template <typename T>
inline int launch_qkv(const T* x, const float* gamma, const float* beta, float eps, T* xln, bf16* xs,
                      const bf16* const* w, long long w_term, const float* bqkv, T* qkv, int M, int Dm,
                      cudaStream_t st) {
  const T* xin = x;
  if (gamma != nullptr) {
    if (int err = launch_ln_fwd_rows(x, gamma, beta, eps, xln, M, Dm, st)) return err;
    xin = xln;
  }
  GemmArgs r{};
  if (int err = operand_of(xin, (long long)M * Dm, xs, &r.a[0], &r.a_term, st)) return err;
  r.lda = Dm;
  for (int i = 0; i < 3; ++i) r.b[i] = w[i];
  r.b_term = w_term;
  r.ldb = Dm;
  r.b_seg = Dm;
  r.M = M;
  r.N = 3 * Dm;
  r.K = Dm;
  for (int i = 0; i < 3; ++i) {
    r.bias[i] = bqkv + (size_t)i * Dm;
    r.c[i] = qkv + i * (size_t)M * Dm;
  }
  r.c_seg = Dm;
  return launch_gemm_sm90<B_NT, EPI_BIAS, T>(r, st);
}

}  // namespace port
