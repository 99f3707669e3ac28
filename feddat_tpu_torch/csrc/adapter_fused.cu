// DAT ensemble-adapter epilogue, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel feddat_tpu/ops/adapter_fused.py::_kernel (lines
// 30-47, called through _forward).  Same function, fp32 math on bf16 inputs
// and one rounding at the end:
//
//   a = relu(h . Wd_a + bd_a) . Wu_a + bu_a,  b = likewise,
//   out = bf16( w * a + (1 - w) * b )
//
// with h [N, D] and the four matrices in bf16 (the model casts them, like
// models/adapters.py:146 does), Wd [D, R], Wu [R, D] (flax layout).  The
// kernel returns the mix only; the caller adds the residual.
//
// What bounds it on the H100.  At the serving shape (N = 16*281 rows, D = 768,
// R = 48) one call moves ~14.1 MB (h in, the mix out, both adapters' weights:
// ~4.2 us at 3.35 TB/s).  The down projection has bf16 operands, so its
// products are exact in fp32 and tensor cores with fp32 sums do it at the bf16
// rate.  The up projection multiplies the fp32 ReLU output x; split as
// x = hi + mid + lo, three bf16 numbers with a residual below 2^-24 |x|, it is
// three bf16 products with fp32 sums, also at the bf16 rate.  All of it is
// ~2.6 GFLOP (~2.7 us at 989 TFLOP/s), so bytes bound the call
// (chip_smoke.py's adapter_bound).
//
// Design.  On the TPU a 256-row block keeps both adapters' weights (295 KB at
// R = 48) in VMEM; that does not fit a Hopper block's 227 KB, and 71 row tiles
// of 64 would fill half of the 132 SMs.  So each 64-row tile of h is a
// cluster of 4 CTAs of one warpgroup each, and rank r of the cluster
//   * takes the K slice [r D/4, (r+1) D/4) of the down projection of both
//     adapters at once: h and Wd tiles come by TMA (one thread issues a copy
//     per 64 x 64 tile into a two-stage ring, completion on an mbarrier;
//     zeros past N, the slice and R), wgmma.m64n64k16 reads h K-major and Wd
//     as it lies ([D, R], wgmma's transposed B, desc_mn), a's columns in
//     their own 64-column atoms, then b's;
//   * writes its fp32 [64, 2 Rc] partial to its shared memory; after a
//     cluster barrier it finishes rows [16 r, 16 r + 16): sums the four
//     partials through distributed shared memory in rank order 0, 1, 2, 3,
//     adds bd, applies the ReLU in fp32, splits x into bf16 hi, mid and lo,
//     writes them as K-major A tiles, and sends those rows to the other three
//     ranks by bulk shared-to-shared copies (an mbarrier on each receiver);
//   * computes its output columns [r D/4, (r+1) D/4) in chunks of 64: per
//     chunk two accumulators, a over a's lo, mid and hi k-steps and b over
//     b's, with Wu [R, D] staged as it lies (desc_mn) by TMA through two
//     buffers, the next chunk's copy in flight; the epilogue adds bu_a and
//     bu_b, forms w a + (1 - w) b in fp32 and rounds once to bf16.
// A bottleneck wider than AD_CHUNK = 128 columns is walked in chunks of one
// width Rc <= 128 (a multiple of 16; R = 192 is two of 96, R = 384 three of
// 128), each chunk the three steps above on its columns of Wd, bd and Wu:
// a chunk's partials, A parts and Wu buffers take the shared memory of one
// R = Rc call, and the up projection's fp32 sums of each adapter carry from
// one chunk to the next through a scratch in device memory (p.acc, 512 D
// bytes per row tile, written by the thread that reads it back), each
// chunk's sums added to them in one fp32 add; only the last chunk adds bu
// and mixes.  Nothing on chip grows with D: the K slice and
// the output columns are walked 64 at a time and bu is read per 64 columns,
// so any D that is a multiple of 64 runs.  Every byte of h is read from
// memory once per chunk, and each CTA reads a quarter of the weights (~74 KB
// at R = 48, not 295 KB).  Every sum has one fixed order (no atomics), so a
// second call is bitwise equal.  Rows past N read as zero and are never
// stored.  The regions of shared memory are reused phase by phase (Layout),
// 75 KB at R = 48: three CTAs per SM, so the 284 CTAs of the serving batch
// run in one wave.  Wd rows of R % 8 != 0 elements are not 16-byte aligned,
// which TMA needs: then every thread copies Wd element by element.
//
// fp32 (the model in float32, as the TPU kernel runs it): h, the four
// matrices and the biases are fp32 and the output is fp32, one rounding
// nowhere.  The C entry point splits h, Wd and Wu into their three bf16 terms
// (common.cuh's split3, planes in the workspace), the copy engine's views
// stack each operand's planes (so a term is a coordinate), and each product
// is the six term products in common.cuh's pair order: the down projection's
// h terms x Wd terms, the up projection's x parts x Wu terms.  A stage then
// holds three h tiles and three of each Wd atom, and a Wu buffer three terms:
// chunks of at most AD_CHUNK_F32 = 48 columns keep a CTA within 227 KB
// (218 KB at 48: one CTA per SM).
//
// Any width D >= 1.  A D that is no multiple of 64 runs the kernel at
// Dp = D rounded up to 64: the C entry point copies h into a zero-padded
// [N, Dp] plane, Wd into [Dp, R] (zero rows), Wu into [R, Dp] and bu into
// [Dp] (zero columns), runs the kernel on those, and copies the [N, Dp]
// output's first D columns out (common.cuh's pad_cols_kernel: five copies in
// and one out, counted in #2's time at such a D).  A zero column of h meets a
// zero row of Wd, and the output columns past D are never copied out; the
// padded planes also give TMA the 16-byte row strides it needs at any D.

#include <cuda.h>

#include "flash_sm90.cuh"

using namespace port;

namespace {

constexpr int AD_ROWS = 64;      // rows of h per cluster
constexpr int AD_THREADS = 128;  // one warpgroup per CTA
constexpr int AD_CLUSTER = 4;    // CTAs per row tile: K slices of GEMM1, column slices of GEMM2
constexpr int AD_CHUNK = 128;     // most bottleneck columns of one chunk
constexpr int AD_CHUNK_F32 = 48;  // fp32: three terms of every tile
constexpr int TB = sm90::TILE_BYTES;

// The operands of one call: h, Wd and Wu as bf16 (the terms of fp32 ones:
// planes N D, D R and R D elements apart), the biases and the output in the
// element type E.
template <typename E>
struct AdapterArgs {
  const bf16* h;      // [N, D]
  const bf16* wd[2];  // [D, R] per adapter (a, b)
  const E* bd[2];     // [R]
  const bf16* wu[2];  // [R, D]
  const E* bu[2];     // [D]
  E* out;             // [N, D]
  float* acc;         // the up projection's sums between chunks (nc > 1), else null
  int N, D, R;
  int nc;             // chunks of the bottleneck
  float weight;
};

// The bottleneck's chunks: as few as take at most `most` columns each, all
// of one width Rc, a multiple of 16 (the last one zero past R).
inline int chunk_most(bool f32) { return f32 ? AD_CHUNK_F32 : AD_CHUNK; }
inline int chunk_count(int R, bool f32) { return (R + chunk_most(f32) - 1) / chunk_most(f32); }
inline int chunk_width(int R, bool f32) {
  const int n = chunk_count(R, f32);
  return ((R + n - 1) / n + 15) / 16 * 16;
}

// two adjacent elements of type E as loaded, and as floats
template <typename E>
struct Pair {
  typedef float2 type;
};
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 type;
};
__device__ __forceinline__ float2 pair_f(float2 v) { return v; }
__device__ __forceinline__ float2 pair_f(__nv_bfloat162 v) { return make_float2(__low2float(v), __high2float(v)); }

// The copy engine's views of the operands (built per call by encode_maps):
// h and Wu as [rows][4 ranks][D/4] so that a box never crosses into the next
// rank's slice (the engine fills zeros past it, past N and past R), Wd as
// [4][D/4][R] (only when R % 8 == 0: the engine needs 16-byte row strides).
// An fp32 operand's three term planes are stacked along the outer axis: term
// t's rows start at t N (h) or t R (Wu), its ranks at 4 t (Wd).  A box of h
// past N or of Wu past R then reads the next term's rows, not zeros; those
// rows of h are never stored, and those of Wu meet x columns past R, which
// are exactly 0 (Wd's and bd's columns past R are zero).
struct TmaMaps {
  CUtensorMap h, wd[2], wu[2];
};

// Sizes that follow from D and the chunk width Rc.  Each adapter's chunk
// columns take KT2 64-column atoms of their own (a's, then b's: NA = 2 KT2
// atoms; a copy lands on a 1024-byte aligned atom), padded with zero columns.
// Shared memory, after 1024 bytes of alignment slack, in regions used in turn:
//   X: GEMM1's two-stage ring (an h tile and NA Wd tiles a stage), then the
//      A parts [3][NA];
//   B: this rank's fp32 partial (read by the whole cluster), then the two Wu
//      buffers, each [2 adapters][Rp rows][64 columns];
//   bd in bf16 (the packed columns), then five mbarriers (two ring stages,
//   two Wu buffers, the A parts' rows from the other ranks).
struct Layout {
  int Rp;   // the chunk's columns, Rc, padded to a multiple of 16
  int KT2;  // 64-column atoms of one adapter's Rp columns (64-row tiles of Wu)
  int NA;   // atoms of the packed bottleneck
  int KS;   // D / 4: a rank's K slice of GEMM1 and its columns of GEMM2
  int nkt;  // 64-wide tiles of a K slice, and 64-column chunks of GEMM2
  int stage, x_bytes, wu_block, b_bytes, bars, smem;
};

// nt: bf16 terms of each operand value (1, or 3 in fp32); es: bytes of the
// element type (bd's copy in shared memory)
__host__ __device__ inline Layout layout(int D, int R, int nt, int es) {
  Layout L;
  L.Rp = (R + 15) / 16 * 16;
  L.KT2 = (L.Rp + 63) / 64;
  L.NA = 2 * L.KT2;
  L.KS = D / AD_CLUSTER;
  L.nkt = (L.KS + 63) / 64;
  L.stage = nt * (1 + L.NA) * TB;
  const int parts = 3 * L.NA * TB;
  L.x_bytes = 2 * L.stage > parts ? 2 * L.stage : parts;
  L.wu_block = L.Rp * 128;  // [Rp rows][64] bf16, 128B-swizzled: one adapter's term
  const int partial = 2 * L.Rp * AD_ROWS * 4;
  L.b_bytes = partial > 4 * nt * L.wu_block ? partial : 4 * nt * L.wu_block;
  L.bars = L.x_bytes + L.b_bytes + (64 * L.NA * es + 7) / 8 * 8;
  L.smem = 1024 + L.bars + 5 * 8;
  return L;
}

// d += A . B: A [64 M][16 K] K-major and B [16 K][64 N] MN-major (wgmma's
// transposed B), both in shared memory
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS_D32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : FS_ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarrier `bar` expects `bytes` more from the copy engine (and this thread's arrival)
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of the 3-d view `map` at coordinates (c0, c1, c2) into shared
// memory at `dst`, counted on mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// The kernel for chunks of Rc = 16 RP16 bottleneck columns in the element
// type E: every wgmma chain has a compile-time length.  Chunk c of the
// bottleneck is columns [c Rc, c Rc + Rc) of each adapter (zero past R); the
// chunks run in order, and with more than one the up projection's fp32 sums
// go through p.acc.
template <int RP16, typename E>
__global__ void __cluster_dims__(AD_CLUSTER, 1, 1)
    __launch_bounds__(AD_THREADS, kTerms<E> == 1 && RP16 <= 4 ? 3 : 1)
        adapter_kernel(AdapterArgs<E> p, const __grid_constant__ TmaMaps maps) {
  constexpr int NT = kTerms<E>;                      // terms of h, Wd and Wu
  constexpr int KT2 = (RP16 + 3) / 4, NA = 2 * KT2;  // Rc = 16 RP16
  constexpr int NQ = 4 * RP16, QA = 2 * RP16;  // 8-column groups of the real columns: both, one adapter
  constexpr int BD_PER = 64 * NA / AD_THREADS;
  constexpr int NP = kPairs<E>;                // term products of GEMM1
  constexpr int NP2 = NT == 3 ? 6 : 3;         // of GEMM2 (x is always split)
  extern __shared__ __align__(16) uint8_t ad_smem[];
  const Layout L = layout(p.D, 16 * RP16, NT, sizeof(E));
  // a bf16 bottleneck of more than one chunk is wider than 128, so its chunks
  // are at least 80 columns wide (chunk_width): instances of RP16 <= 4 run one
  const int nc = NT == 3 || RP16 > 4 ? p.nc : 1;
  const uint32_t at = sm90::smem_addr(ad_smem);
  const uint32_t base = (at + 1023u) & ~1023u;  // the swizzle is a function of the address
  uint8_t* const sp = ad_smem + (base - at);
  const uint32_t sX = base, sB = base + L.x_bytes;
  E* const bd_s = reinterpret_cast<E*>(sp + L.x_bytes + L.b_bytes);  // [64 NA]
  const uint32_t bar_k = base + L.bars, bar_wu = bar_k + 16, bar_parts = bar_k + 32;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int tile = blockIdx.x / AD_CLUSTER, row0 = tile * AD_ROWS;
  const int k0 = rank * L.KS;  // this rank's K slice of GEMM1 and its output columns of GEMM2
  const bool tma_wd = (p.R & 7) == 0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_k + 8 * i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The ring stages and Wu buffers are counted across chunks (T = c nkt + t,
  // U = c nkt + ch): use n of either goes to stage n % 2 at phase (n / 2) % 2.
  int c0 = 0;  // the chunk's first bottleneck column
  int T0 = 0;  // its first GEMM1 tile and GEMM2 chunk, counted across chunks

  // k-tile t of GEMM1 into ring stage T % 2: h [row0, row0 + 64) x
  // k0 + [64 t, 64 t + 64) K-major, and Wd rows k0 + [64 t, 64 t + 64),
  // columns c0 + ..., of both adapters' atoms MN-major, zero past N, past the
  // slice and past R; NT term tiles of each (h's first, then Wd's [term][atom]).
  // Wd rows of R % 8 != 0 elements are not 16-byte aligned: then every thread
  // copies them element by element.
  auto stage_k = [&](int t) {
    if (t >= L.nkt) return;
    const int T = T0 + t;
    const uint32_t sH = sX + (T & 1) * L.stage, sWd = sH + NT * TB;
    if (tid == 0) {
      expect_bytes(bar_k + 8 * (T & 1), NT * TB * (1 + (tma_wd ? NA : 0)));
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        tma_load(sH + u * TB, &maps.h, t * 64, rank, row0 + u * p.N, bar_k + 8 * (T & 1));
        if (tma_wd)
#pragma unroll
          for (int A = 0; A < NA; ++A)
            tma_load(sWd + (u * NA + A) * TB, &maps.wd[A / KT2], c0 + (A % KT2) * 64, t * 64,
                     rank + AD_CLUSTER * u, bar_k + 8 * (T & 1));
      }
    }
    if (!tma_wd) {
#pragma unroll 1
      for (int j = 0; j < NT * NA * 512 / AD_THREADS; ++j) {
        const int i = tid + j * AD_THREADS, u = i / (NA * 512), A = (i >> 9) % NA, r = (i >> 3) & 63,
                  c = i & 7;
        const int ad = A / KT2, cc = c0 + (A % KT2) * 64 + c * 8, kk = t * 64 + r;
        const bf16* src = (ad ? p.wd[1] : p.wd[0]) + (size_t)u * p.D * p.R + (size_t)(k0 + kk) * p.R + cc;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = kk < L.KS && cc + e < p.R ? __bfloat162float(src[e]) : 0.f;
        st_shared16(sWd + (u * NA + A) * TB + sm90::swz(r, c),
                    make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                               pack_bf16(v[6], v[7])));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  };
  // Wu rows c0 + [0, Rc) (zero past R), columns k0 + [64 ch, 64 ch + 64) of
  // both adapters into buffer U % 2 of region B, [adapter][term] blocks
  auto stage_wu = [&](int ch) {
    if (tid == 0 && ch < L.nkt) {
      const int U = T0 + ch;
      const uint32_t buf = sB + (U & 1) * 2 * NT * L.wu_block, bar = bar_wu + 8 * (U & 1);
      expect_bytes(bar, 2 * NT * L.wu_block);
#pragma unroll
      for (int ad = 0; ad < 2; ++ad)
#pragma unroll
        for (int u = 0; u < NT; ++u)
          tma_load(buf + (ad * NT + u) * L.wu_block, &maps.wu[ad], ch * 64, rank, c0 + u * p.R, bar);
    }
  };
  auto group = [](int jj) { return jj < QA ? jj : 8 * KT2 + jj - QA; };  // packed 8-column group
  float4* part = reinterpret_cast<float4*>(sp + L.x_bytes);
  uint32_t remote_part[AD_CLUSTER];
#pragma unroll
  for (int r = 0; r < AD_CLUSTER; ++r)
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote_part[r])
                 : "r"(sm90::smem_addr(part) + (32 * rank + lane) * 16), "r"(r));
  const float wa = p.weight, wb = 1.f - p.weight;

  for (int c = 0; c < nc; ++c, c0 += 16 * RP16, T0 += L.nkt) {
    if (c > 0) {
      // the copies to the other ranks have read this rank's A parts (region
      // X), and every warp is done with them and with the Wu buffers
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
    }
    // bd goes to shared memory, its reads issued before the copies
    E bdv[BD_PER];
#pragma unroll
    for (int j = 0; j < BD_PER; ++j) {
      const int i = tid + j * AD_THREADS, ad = i >= 64 * KT2, cc = c0 + i - ad * 64 * KT2;
      bdv[j] = cc < p.R ? (ad ? p.bd[1] : p.bd[0])[cc] : from_f<E>(0.f);
    }
    stage_k(0);
    stage_k(1);
#pragma unroll
    for (int j = 0; j < BD_PER; ++j) bd_s[tid + j * AD_THREADS] = bdv[j];

    // GEMM1: this rank's partial of [h . Wd_a | h . Wd_b] over its K slice,
    // one wgmma group per 64-wide tile (the last tile's k-steps run in full on
    // zeros), tile t + 1's copies in flight meanwhile
    float acc[NA][32];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
      sm90::pin(acc[a]);  // the zeros are written before the first fence, not between the products
    }
    for (int t = 0; t < L.nkt; ++t) {
      const int T = T0 + t;
      wait_phase(bar_k + 8 * (T & 1), (T >> 1) & 1);
      __syncthreads();  // and the element-by-element Wd copies
      const uint32_t sH = sX + (T & 1) * L.stage, sWd = sH + NT * TB;
      sm90::wg_fence();
#pragma unroll
      for (int pr = 0; pr < NP; ++pr)  // h term . Wd term, the small pairs first
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t da = sm90::desc_k(sH + term_a<E>(pr) * TB, ks);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            wgmma_ss_t(acc[a], da, sm90::desc_mn(sWd + (term_b<E>(pr) * NA + a) * TB, ks));
        }
      sm90::wg_commit();
      sm90::wg_wait_all();
#pragma unroll
      for (int a = 0; a < NA; ++a) sm90::pin(acc[a]);
      __syncthreads();  // every warp is done with this stage
      stage_k(t + 2);
    }

    // The partial in region B in thread-major order, the 8-column groups of
    // the real columns only: group jj (a's QA groups, then b's) of thread tid
    // at float4 jj * 128 + tid, so each thread of every rank reads back the
    // elements it owns
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      const int j = group(jj);
      const float* d = &acc[j >> 3][4 * (j & 7)];
      part[jj * AD_THREADS + tid] = make_float4(d[0], d[1], d[2], d[3]);
    }
    cluster_sync();  // every rank's partial is written

    // Rank r finishes rows [16 r, 16 r + 16) of the tile (warp r's rows in
    // the accumulator layout): its warp w sums groups jj = w, w + 4, ... of
    // warp r's lane `lane` from the four partials in rank order 0..3, adds
    // bd, applies the ReLU, splits into bf16 hi, mid and lo, and writes the
    // parts into its own K-major A tiles [part][atom] (over the ring).
    // Packed group j is rows 16 rank + g and + 8, columns 8 j + 2 tig and + 1.
    // Then the copy engine sends those rows (2 KB of each tile) to the other
    // three ranks.
    constexpr int MB = RP16 < 4 ? RP16 : 4;  // owned groups read in one round trip
#pragma unroll
    for (int m0 = 0; m0 < RP16; m0 += MB) {
      float4 v[MB][AD_CLUSTER];
#pragma unroll
      for (int mm = 0; mm < MB; ++mm)
#pragma unroll
        for (int r = 0; r < AD_CLUSTER; ++r)
          if (m0 + mm < RP16)
            asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(v[mm][r].x), "=f"(v[mm][r].y), "=f"(v[mm][r].z), "=f"(v[mm][r].w)
                         : "r"(remote_part[r] + (4 * (m0 + mm) + warp) * AD_THREADS * 16));
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        if (m0 + mm >= RP16) break;
        const int j = group(4 * (m0 + mm) + warp), a = j >> 3, q = j & 7;
        float x[4] = {v[mm][0].x, v[mm][0].y, v[mm][0].z, v[mm][0].w};
#pragma unroll
        for (int r = 1; r < AD_CLUSTER; ++r) {
          x[0] = __fadd_rn(x[0], v[mm][r].x), x[1] = __fadd_rn(x[1], v[mm][r].y);
          x[2] = __fadd_rn(x[2], v[mm][r].z), x[3] = __fadd_rn(x[3], v[mm][r].w);
        }
        const int col = 8 * j + 2 * tig;
        const float b0 = to_f(bd_s[col]), b1 = to_f(bd_s[col + 1]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float pv[3][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = fmaxf(__fadd_rn(x[2 * hf + e], e ? b1 : b0), 0.f);
            const float hi = round_bf16(y), r1 = __fsub_rn(y, hi);
            const float mid = round_bf16(r1), lo = round_bf16(__fsub_rn(r1, mid));
            pv[0][e] = hi, pv[1][e] = mid, pv[2][e] = lo;
          }
          const uint32_t off = sm90::swz(16 * rank + g + 8 * hf, q) + tig * 4;
#pragma unroll
          for (int s = 0; s < 3; ++s)
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sX + (s * NA + a) * TB + off),
                         "r"(pack_bf16(pv[s][0], pv[s][1]))
                         : "memory");
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the parts, visible to the copy engine
    __syncthreads();
    if (tid == 0) {
      expect_bytes(bar_parts, (AD_CLUSTER - 1) * 3 * NA * 2048);
#pragma unroll 1
      for (int d = 1; d < AD_CLUSTER; ++d) {
        const uint32_t to = (rank + d) % AD_CLUSTER;
        uint32_t dst, bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(sX + rank * 2048), "r"(to));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(bar) : "r"(bar_parts), "r"(to));
#pragma unroll
        for (int blk = 0; blk < 3 * NA; ++blk)
          asm volatile(
              "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], 2048, [%2];\n" ::"r"(
                  dst + blk * TB),
              "r"(sX + rank * 2048 + blk * TB), "r"(bar)
              : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    // The other ranks' rows have landed; they were sent after their reads of
    // this rank's partial, so region B is free for the Wu buffers.
    wait_phase(bar_parts, c & 1);

    // GEMM2, 64 output columns at a time, chunk ch + 1's copies in flight
    // meanwhile.  Each adapter's accumulator starts at 0 for every chunk of
    // the bottleneck and takes the lo, mid and hi parts in that order (the
    // tensor cores' fp32 accumulation keeps more of the small parts' bits
    // that way: half the error against the fp64 function near 0, PERF.md
    // §6; in fp32 the six part x Wu-term pairs in common.cuh's pair order); a chunk
    // after the first adds the sums the chunks before left in p.acc in one
    // fp32 add, and the last forms the mix and rounds once.
    stage_wu(0);
    stage_wu(1);
    for (int ch = 0; ch < L.nkt; ++ch) {
      const int U = T0 + ch;
      wait_phase(bar_wu + 8 * (U & 1), (U >> 1) & 1);
      const uint32_t buf = sB + (U & 1) * 2 * NT * L.wu_block;
      // this thread's 32 fp32 sums of each adapter at (tile, rank, ch) in
      // p.acc, thread-major, so a warp's accesses are contiguous
      float* const saved = p.acc + ((((size_t)tile * AD_CLUSTER + rank) * L.nkt + ch) * 2 * 32) * AD_THREADS + tid;
      // bu of this thread's columns, read before the products so that they
      // land meanwhile (the epilogue's stores through p.out may alias them
      // as far as the compiler knows: a read there would wait for the stores
      // before it)
      typename Pair<E>::type bua2[8], bub2[8];
      if (c + 1 == nc)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = ch * 64 + nt * 8 + tig * 2;
          if (n < L.KS) {
            bua2[nt] = *reinterpret_cast<const typename Pair<E>::type*>(p.bu[0] + k0 + n);
            bub2[nt] = *reinterpret_cast<const typename Pair<E>::type*>(p.bu[1] + k0 + n);
          }
        }
      float ya[32], yb[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        ya[i] = 0.f;
        yb[i] = 0.f;
      }
      sm90::pin(ya);
      sm90::pin(yb);
      sm90::wg_fence();
#pragma unroll
      for (int pr = 0; pr < NP2; ++pr) {  // bf16: lo, then mid, then hi: the small parts first
        const int s = NT == 3 ? pair_a(pr) : 2 - pr, u = NT == 3 ? pair_b(pr) : 0;  // x's part, Wu's term
#pragma unroll
        for (int ks = 0; ks < RP16; ++ks) {
          const int ca = ks * 16, cb = 64 * KT2 + ks * 16;  // packed columns of a's and b's k-step
          wgmma_ss_t(ya, sm90::desc_k(sX + (s * NA + (ca >> 6)) * TB, (ca & 63) >> 4),
                     sm90::desc_mn(buf + u * L.wu_block + (ks >> 2) * TB, ks & 3));
          wgmma_ss_t(yb, sm90::desc_k(sX + (s * NA + (cb >> 6)) * TB, (cb & 63) >> 4),
                     sm90::desc_mn(buf + (NT + u) * L.wu_block + (ks >> 2) * TB, ks & 3));
        }
      }
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(ya);
      sm90::pin(yb);
      __syncthreads();  // every warp is done with this buffer
      stage_wu(ch + 2);

      if (c > 0) {  // the chunks before, then this one, each sum rounded once
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          ya[i] = __fadd_rn(saved[i * AD_THREADS], ya[i]);
          yb[i] = __fadd_rn(saved[(32 + i) * AD_THREADS], yb[i]);
        }
      }
      if (c + 1 < nc) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          saved[i * AD_THREADS] = ya[i];
          saved[(32 + i) * AD_THREADS] = yb[i];
        }
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = ch * 64 + nt * 8 + tig * 2;
        if (n >= L.KS) continue;
        const float2 fa = pair_f(bua2[nt]), fb = pair_f(bub2[nt]);
        const float bua[2] = {fa.x, fa.y}, bub[2] = {fb.x, fb.y};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + warp * 16 + g + 8 * hf;
          if (row >= p.N) continue;
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = nt * 4 + 2 * hf + e;
            o[e] = __fadd_rn(__fmul_rn(wa, __fadd_rn(ya[i], bua[e])), __fmul_rn(wb, __fadd_rn(yb[i], bub[e])));
          }
          store2(p.out + (size_t)row * p.D + k0 + n, o[0], o[1]);
        }
      }
    }
  }
  // the copies to the other ranks have read this rank's tiles before it exits
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d bf16 view {d0, d1, d2} (d0 contiguous; strides s1, s2 in bytes) in
// 128B-swizzled boxes {b0, b1, b2}; zeros outside the view
bool encode3(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
             uint32_t b0, uint32_t b1, uint32_t b2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2}, one[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// nt: the terms of each operand, stacked as the views' outer axis
template <typename E>
bool encode_maps(const AdapterArgs<E>& a, const Layout& L, int nt, TmaMaps* m) {
  const uint64_t KS = L.KS, R = a.R, D = a.D;
  bool ok = encode3(&m->h, a.h, KS, AD_CLUSTER, (uint64_t)nt * a.N, KS * 2, D * 2, 64, 1, AD_ROWS);
  for (int ad = 0; ad < 2; ++ad) {
    ok = ok && encode3(&m->wu[ad], a.wu[ad], KS, AD_CLUSTER, nt * R, KS * 2, D * 2, 64, 1, L.Rp);
    if (a.R % 8 == 0)
      ok = ok && encode3(&m->wd[ad], a.wd[ad], R, KS, AD_CLUSTER * nt, R * 2, KS * R * 2, 64, 64, 1);
  }
  return ok;
}

// The devices on which each instance has its shared-memory limit raised, per
// element type (bf16, fp32).
int smem_done[2][9][64];

template <int RP16, typename E>
int launch_rp(const AdapterArgs<E>& a, const TmaMaps& maps, int smem, cudaStream_t st) {
  const cudaError_t err =
      sm90::allow_smem(adapter_kernel<RP16, E>, smem, smem_done[kTerms<E> == 1 ? 0 : 1][RP16]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + AD_ROWS - 1) / AD_ROWS * AD_CLUSTER);
  adapter_kernel<RP16, E><<<grid, AD_THREADS, smem, st>>>(a, maps);
  return (int)cudaGetLastError();
}

// Bytes of p.acc a call needs: each row tile's 4 ranks x nkt output chunks x
// 2 adapters x 32 sums of each of 128 threads, fp32; 0 with one chunk.
size_t acc_bytes(int N, int D, int R, bool f32) {
  if (N <= 0 || chunk_count(R, f32) < 2) return 0;
  const Layout L = layout(D, chunk_width(R, f32), 1, 2);
  return (size_t)(N + AD_ROWS - 1) / AD_ROWS * AD_CLUSTER * L.nkt * 2 * 32 * AD_THREADS * 4;
}

// The workspace: fp32's operand terms (h's 3 N D, each Wd's and Wu's 3 D R
// bf16), then p.acc.
size_t terms_bytes(int N, int D, int R, bool f32) {
  return f32 ? ((size_t)3 * N * D + (size_t)12 * D * R) * 2 : 0;
}

template <typename E>
int launch(AdapterArgs<E> a, cudaStream_t st) {
  constexpr bool f32 = kTerms<E> == 3;
  if (a.N < 0 || a.D < 64 || a.D % 64 || a.R < 1) return (int)cudaErrorInvalidValue;
  if (a.N == 0) return 0;
  a.nc = chunk_count(a.R, f32);
  if (a.nc > 1 && a.acc == nullptr) return (int)cudaErrorInvalidValue;
  const Layout L = layout(a.D, chunk_width(a.R, f32), kTerms<E>, sizeof(E));
  TmaMaps maps;
  if (!encode_maps(a, L, kTerms<E>, &maps)) return (int)cudaErrorInvalidValue;
  switch (L.Rp / 16) {
    case 1: return launch_rp<1>(a, maps, L.smem, st);
    case 2: return launch_rp<2>(a, maps, L.smem, st);
    case 3: return launch_rp<3>(a, maps, L.smem, st);
  }
  if constexpr (!f32) {
    switch (L.Rp / 16) {
      case 4: return launch_rp<4>(a, maps, L.smem, st);
      case 5: return launch_rp<5>(a, maps, L.smem, st);
      case 6: return launch_rp<6>(a, maps, L.smem, st);
      case 7: return launch_rp<7>(a, maps, L.smem, st);
      default: return launch_rp<8>(a, maps, L.smem, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The call at a width D that is a multiple of 64 (the operands as the C
// entry point takes them; workspace of inner_bytes).
int adapter_fwd_at(const void* h, const void* const* wd, const void* const* bd, const void* const* wu,
                   const void* const* bu, void* out, void* workspace, int N, int D, int R, int f32, float weight,
                   cudaStream_t st) {
  if (!f32) {
    AdapterArgs<bf16> a{};
    a.h = static_cast<const bf16*>(h);
    for (int i = 0; i < 2; ++i) {
      a.wd[i] = static_cast<const bf16*>(wd[i]);
      a.bd[i] = static_cast<const bf16*>(bd[i]);
      a.wu[i] = static_cast<const bf16*>(wu[i]);
      a.bu[i] = static_cast<const bf16*>(bu[i]);
    }
    a.out = static_cast<bf16*>(out);
    a.acc = static_cast<float*>(workspace);
    a.N = N;
    a.D = D;
    a.R = R;
    a.weight = weight;
    return launch(a, st);
  }
  if (N < 0 || D < 64 || D % 64 || R < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  // the operands' terms: h's planes N D apart, each matrix's D R apart
  bf16* terms = static_cast<bf16*>(workspace);
  const long long nd = (long long)N * D, dr = (long long)D * R;
  AdapterArgs<float> a{};
  int err = launch_split3(static_cast<const float*>(h), terms, nd, nd, st);
  a.h = terms;
  bf16* w = terms + 3 * nd;
  for (int i = 0; i < 2 && !err; ++i) {
    err = launch_split3(static_cast<const float*>(wd[i]), w + 6 * i * dr, dr, dr, st);
    if (!err) err = launch_split3(static_cast<const float*>(wu[i]), w + (6 * i + 3) * dr, dr, dr, st);
    a.wd[i] = w + 6 * i * dr;
    a.wu[i] = w + (6 * i + 3) * dr;
    a.bd[i] = static_cast<const float*>(bd[i]);
    a.bu[i] = static_cast<const float*>(bu[i]);
  }
  if (err) return err;
  a.out = static_cast<float*>(out);
  const size_t tb = terms_bytes(N, D, R, true);
  a.acc = acc_bytes(N, D, R, true) ? reinterpret_cast<float*>(static_cast<char*>(workspace) + tb) : nullptr;
  a.N = N;
  a.D = D;
  a.R = R;
  a.weight = weight;
  return launch(a, st);
}


size_t inner_bytes(int N, int D, int R, bool f32) { return terms_bytes(N, D, R, f32) + acc_bytes(N, D, R, f32); }

// The width the kernel runs at, and the zero-padded operands' bytes in front
// of the kernel's own workspace when D is no multiple of 64 (es: bytes of the
// element type): h and out [N, Dp], two Wd [Dp, R], two Wu [R, Dp], two bu
// [Dp], each on a 256-byte boundary (TMA wants 16).
int padded_width(int D) { return (D + 63) / 64 * 64; }
enum { PAD_H, PAD_OUT, PAD_WD, PAD_WU = PAD_WD + 2, PAD_BU = PAD_WU + 2, PAD_COUNT = PAD_BU + 2 };
void pad_layout(int N, int D, int R, int es, size_t* off, size_t* total) {
  const size_t Dp = padded_width(D);
  const size_t bytes[PAD_COUNT] = {N * Dp * es, N * Dp * es, Dp * R * es, Dp * R * es,
                                   R * Dp * es, R * Dp * es, Dp * es, Dp * es};
  size_t at = 0;
  for (int i = 0; i < PAD_COUNT; ++i) {
    off[i] = at;
    at += (bytes[i] + 255) / 256 * 256;
  }
  *total = D % 64 ? at : 0;
}

template <typename E>
int adapter_fwd_padded(const void* h, const void* const* wd, const void* const* bd, const void* const* wu,
                       const void* const* bu, void* out, char* ws, int N, int D, int R, float weight,
                       cudaStream_t st) {
  const int Dp = padded_width(D);
  size_t off[PAD_COUNT], total;
  pad_layout(N, D, R, sizeof(E), off, &total);
  auto at = [&](int i) { return reinterpret_cast<E*>(ws + off[i]); };
  int err = launch_pad_cols<E>(static_cast<const E*>(h), D, at(PAD_H), Dp, N, D, Dp, st);
  const void *wdp[2], *wup[2], *bup[2];
  for (int i = 0; i < 2 && !err; ++i) {
    // Wd [D, R] as one row of D R elements, then zeros to Dp R
    err = launch_pad_cols<E>(static_cast<const E*>(wd[i]), 0, at(PAD_WD + i), 0, 1, D * R, Dp * R, st);
    if (!err) err = launch_pad_cols<E>(static_cast<const E*>(wu[i]), D, at(PAD_WU + i), Dp, R, D, Dp, st);
    if (!err) err = launch_pad_cols<E>(static_cast<const E*>(bu[i]), 0, at(PAD_BU + i), 0, 1, D, Dp, st);
    wdp[i] = at(PAD_WD + i);
    wup[i] = at(PAD_WU + i);
    bup[i] = at(PAD_BU + i);
  }
  if (!err)
    err = adapter_fwd_at(at(PAD_H), wdp, bd, wup, bup, at(PAD_OUT), ws + total, N, Dp, R, kTerms<E> == 3, weight,
                         st);
  if (!err) err = launch_pad_cols<E>(at(PAD_OUT), Dp, static_cast<E*>(out), D, N, D, D, st);
  return err;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of scratch adapter_fused_fwd needs at these shapes (0: none), bf16
// (f32 = 0) or fp32 (f32 = 1).
long long adapter_fused_workspace(int N, int D, int R, int f32) {
  if (D < 1 || N < 0) return 0;
  size_t off[PAD_COUNT], pad;
  pad_layout(N, D, R, f32 ? 4 : 2, off, &pad);
  return (long long)(pad + inner_bytes(N, padded_width(D), R, f32 != 0));
}


// h [N, D]; wd_* [D, R], bd_* [R], wu_* [R, D], bu_* [D], all bf16 (f32 = 0)
// or all fp32 (f32 = 1), 16-byte aligned; out [N, D] of the same type;
// workspace of adapter_fused_workspace bytes (may be null when that is 0).
// D >= 1, R >= 1, N >= 0 (cudaErrorInvalidValue otherwise).  Returns the
// CUDA error of the launches (0 = success).
int adapter_fused_fwd(const void* h, const void* wd_a, const void* bd_a, const void* wu_a,
                      const void* bu_a, const void* wd_b, const void* bd_b, const void* wu_b,
                      const void* bu_b, void* out, void* workspace, int N, int D, int R, int f32,
                      float weight, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* wd[2] = {wd_a, wd_b};
  const void* bd[2] = {bd_a, bd_b};
  const void* wu[2] = {wu_a, wu_b};
  const void* bu[2] = {bu_a, bu_b};
  if (N < 0 || D < 1 || R < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (D % 64 == 0) return adapter_fwd_at(h, wd, bd, wu, bu, out, workspace, N, D, R, f32, weight, st);
  char* ws = static_cast<char*>(workspace);
  if (f32) return adapter_fwd_padded<float>(h, wd, bd, wu, bu, out, ws, N, D, R, weight, st);
  return adapter_fwd_padded<bf16>(h, wd, bd, wu, bu, out, ws, N, D, R, weight, st);
}

}  // extern "C"
