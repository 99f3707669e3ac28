// Attention at any head dim D from 1 to 256, for Hopper (sm_90a): the
// forward, dq and dk/dv launches of #5/#6 (and of #1/#3/#4's attention cores)
// and of #7-#9, for every head dim but 64.  Head dim 64 keeps its own kernels
// (attn_sm90.cuh, flash_attention.cu), untouched: these bodies are separate
// code, so that instance's registers and times do not move.
//
// Each body computes the function of its head-dim-64 counterpart at the same
// rounding points (FLASH = false: attn_sm90.cuh's header, #1/#3/#4/#5/#6;
// FLASH = true: flash_attention.cu's header, #7-#9), in bf16 or fp32 (T):
//   * fused (FLASH = false): two sweeps over the keys for the exact row max,
//     P rounded to T before P.v and ds before dq and dk, expf, a [B, S] key
//     bias, delta = rowsum(dO * o) taken by the dq launch;
//   * flash (FLASH = true): the online softmax from -1e30, P and ds at fp32
//     precision in their products (bf16 hi + lo; in fp32 the three terms,
//     each step's products summed apart and added in one fp32 add),
//     ex2.approx in bf16 and expf in fp32, l >= 1e-30, the compact
//     [B|1, H|1, Sq|1, Skv|1] bias by element strides, delta given.
//
// Design.  D is padded to ND = ceil(D / 64) chunks of 64 columns; columns
// past D are zero in shared memory (so they add nothing to q.k^T or dO.v^T)
// and are never stored.  One block is one warpgroup owning 64 rows (queries,
// or keys in the dk/dv launch) and ONE 64-column chunk `oc` of the outputs
// (grid.y = H * ND): an output chunk's accumulator is 32 registers a thread
// at every D, as at D = 64.  The products over D (q.k^T, dO.v^T and their
// transposes) walk the chunks: the block streams, for each 64-row step of
// the other side, every chunk of BOTH operands of those products through a
// two-stage cp.async ring, one chunk per substep, and sums the chunks'
// products in the step's s and dp (in fp32 each chunk's six term products
// are summed apart and added in one fp32 add).  The chunks of a step run
// in the order oc + 1, ..., oc (mod ND), so the last substep's stage holds
// chunk oc of q, k, dO (and the forward's v chunk oc, loaded with it):
// exactly what the step's output products (P.v, ds.k, P^T.dO, ds^T.q) read.
// So the shared memory is one stage of at most four operands' chunk tiles
// whatever D is: 48 KB in bf16 and 144 KB in fp32 for two stages of the
// dq and dk/dv launches (fp32 at D = 256 fits with two stages).
// What it costs: each block re-reads its own rows' chunks once per step (from
// L2) and the blocks of the ND output chunks of one row block each compute
// the same s and dp, so the products over D are done ND times: at D = 80
// (two chunks) about twice the head-dim-64 kernels' tensor-core work per
// output column, at D = 256 four times.  A later design can keep the
// block's own rows resident and own two output chunks a block.
//
// Any layout.  An operand whose rows start on 16-byte boundaries (D and the
// strides multiples of 8 elements, its start 16-byte aligned) is copied 16
// bytes at a time with cp.async, zero-filled past S and D (the `vec` flags,
// set by the host); any other (D = 12 in bf16, or a head of a [B*S, Dm]
// plane at a column that is no multiple of 8) is read in place element by
// element with plain loads and stored to the swizzled tile as 16-byte
// chunks (synchronous, so those copies do not overlap the products).  The
// outputs are stored element by element, guarded by S and D.  The bias,
// lse and delta are read from device memory (L1) where each logit needs them.
// Every sum has one fixed order and no atomics: a second call is bitwise equal.
#pragma once

#include "flash_sm90.cuh"

namespace port {
namespace anyd {

constexpr int ROWS = 64;      // rows a block owns, and rows of each streamed step
constexpr int CHUNK = 64;     // head-dim columns of one chunk
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;
constexpr int MAX_D = 256;    // the largest head dim (4 chunks)
constexpr int TB = sm90::TILE_BYTES;
constexpr float NEG_INF = -1e30f;

// The operands of one call.  q, k, v, dout are [B, H, S, D] bf16 views (the
// three term planes of fp32 ones, Heads::tt apart), read 16 bytes at a time
// where vq/vk/vv/vdo is set; ctx is the forward's o (the fused dq launch's
// delta); o, dq, dk, dv are outputs of the element type; bias is null or
// fp32 with element strides (0 on broadcast dims); lse [B, H, Sq] is written
// by the forward and read by the backward; delta [B, H, Sq] is written by the
// fused dq launch and read by the dk/dv launch (flash: given).
template <typename T>
struct AnyArgs {
  Heads<const bf16> q, k, v, dout;
  int vq, vk, vv, vdo;
  Heads<const T> ctx;
  Heads<T> o, dq, dk, dv;
  const float* bias;
  long long bsb, bsh, bsq, bsk;
  float* lse;
  float* delta;
  int H, Sq, Skv, D, ND;
  float scale;
};

// The chunks ND of head dim D, and whether D is one the bodies take.
__host__ __device__ constexpr int chunks(int D) { return (D + CHUNK - 1) / CHUNK; }
inline bool takes_head_dim(int D) { return D >= 1 && D <= MAX_D; }

// whether a [B, H, S, D] view can be copied 16 bytes at a time
template <typename E>
inline int vec_ok(const Heads<E>& x, int D) {
  const long long m = 16 / sizeof(E);
  return D % m == 0 && x.sb % m == 0 && x.sh % m == 0 && x.ss % m == 0 && x.tt % m == 0 &&
         reinterpret_cast<uintptr_t>(x.p) % 16 == 0;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t aligned_smem(uint8_t* raw) {
  const uint32_t at = sm90::smem_addr(raw);
  return (at + 1023u) & ~1023u;
}

__device__ __forceinline__ unsigned short bits(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of one (batch, head)'s [S, D]
// operand `src` (row stride ss) into a swizzled tile, zero past S and D:
// 16-byte cp.async copies when `vec`, else element loads.
__device__ __forceinline__ void load_chunk(uint32_t tile, const bf16* src, long long ss, int r0, int S, int c0,
                                           int D, bool vec, int tid) {
#pragma unroll
  for (int j = 0; j < ROWS * 8 / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i >> 3, c = i & 7, col = c0 + c * 8;
    const bool rok = r0 + r < S;
    if (vec) {
      const bool ok = rok && col < D;
      sm90::cp_async16(tile + sm90::swz(r, c), src + (ok ? (long long)(r0 + r) * ss + col : 0), ok);
    } else {
      const bf16* row = src + (long long)(rok ? r0 + r : 0) * ss;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = col + 2 * e;
        const uint32_t lo = rok && x < D ? bits(row + x) : 0u;
        const uint32_t hi = rok && x + 1 < D ? bits(row + x + 1) : 0u;
        w[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(tile + sm90::swz(r, c)), "r"(w[0]),
                   "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// the NT term tiles of chunk c of rows [r0, r0 + 64) of an operand
template <int NT>
__device__ __forceinline__ void load_terms(uint32_t tile, const Heads<const bf16>& x, int b, int h, int r0, int S,
                                           int c, int D, bool vec, int tid) {
  const bf16* src = x.at(b, h);
#pragma unroll
  for (int t = 0; t < NT; ++t) load_chunk(tile + t * TB, src + t * x.tt, x.ss, r0, S, c * CHUNK, D, vec, tid);
}

// The six term products of fp32 operands (common.cuh's pair order) with the
// pair loop kept rolled: one pair's four k-steps per trip.  The head-dim-64
// kernels unroll all 24 (flash_sm90.cuh's product_ss/product_rs); here the
// rolled loop keeps each fp32 instance's code, and its build, a sixth as
// large, for the same products in the same order.
__device__ __forceinline__ void terms_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll 1
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int ks = 0; ks < CHUNK / 16; ++ks)
      sm90::wgmma_ss(d, sm90::desc_k(a + pair_a(pr) * TB, ks), sm90::desc_k(b + pair_b(pr) * TB, ks), pr + ks);
}

// d (+)= x . B with x's three terms on B's three term tiles (FRESH: d = x . B)
template <bool FRESH>
__device__ __forceinline__ void terms_rs(float (&d)[32], const float (&x)[32], uint32_t b) {
#pragma unroll 1
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int ks = 0; ks < ROWS / 16; ++ks) {
      uint32_t a[4];
      sm90::term_frag(x, ks, pair_a(pr), a);
      sm90::wgmma_rs_t(d, a, sm90::desc_mn(b + pair_b(pr) * TB, ks), FRESH ? pr + ks : 1);
    }
}

// d (+)= A . B^T over one chunk's 64 columns, bf16 tiles (fresh: overwrite)
__device__ __forceinline__ void chunk_ss(float (&d)[32], uint32_t a, uint32_t b, bool fresh) {
#pragma unroll
  for (int ks = 0; ks < CHUNK / 16; ++ks)
    sm90::wgmma_ss(d, sm90::desc_k(a, ks), sm90::desc_k(b, ks), fresh ? ks : 1);
}

// Substep t of a step's products over D: d = (t == 0 ? 0 : d) + A_c . B_c^T
// for a pair (A, B) of NT-term chunk tiles.  bf16: one wgmma chain into d; fp32:
// the chunk's six term products summed apart in tmp (a free accumulator),
// then added to d in one fp32 add.
template <int NT>
__device__ __forceinline__ void chunk_step(float (&d)[32], float (&tmp)[32], uint32_t a, uint32_t b, int t) {
  sm90::wg_fence();
  if constexpr (NT == 1) {
    chunk_ss(d, a, b, t == 0);
  } else {
    terms_ss(tmp, a, b);
  }
  sm90::wg_commit();
  sm90::wg_wait_all();
  sm90::pin(d);
  if constexpr (NT == 3) {
    sm90::pin(tmp);
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = t == 0 ? tmp[i] : d[i] + tmp[i];
  }
}

// d += x . B for a 64 x 64 fp32 x at fp32 precision: bf16 hi + lo (flash,
// bf16).  This and step_sum are flash_attention.cu's own, which stay in that
// file so that its head-dim-64 kernels compile as they did.
__device__ __forceinline__ void hilo_product(float (&d)[32], const float (&x)[32], uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < ROWS / 16; ++ks) {
    uint32_t hi[4], lo[4];
    sm90::hilo_frags(x, ks, hi, lo);
    const uint64_t db = sm90::desc_mn(b, ks);
    sm90::wgmma_rs_t(d, hi, db);
    sm90::wgmma_rs_t(d, lo, db);
  }
}

// acc += x . B over the step (flash, fp32): the step's six term products
// summed in tmp, added to acc in one fp32 add each
__device__ __forceinline__ void step_sum(float (&acc)[32], float (&tmp)[32], const float (&x)[32], uint32_t b) {
  sm90::wg_fence();
  terms_rs<true>(tmp, x, b);
  sm90::wg_commit();
  sm90::wg_wait_all();
  sm90::pin(tmp);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
}

// acc += x . B with x a probability or ds tile, at the family's precision:
// fused rounds x to T (product_rs on T's terms), flash keeps it fp32
template <typename T, bool FLASH>
__device__ __forceinline__ void out_product(float (&acc)[32], float (&tmp)[32], const float (&x)[32],
                                            uint32_t b) {
  constexpr int NT = kTerms<T>;
  if constexpr (FLASH && NT == 3) {
    step_sum(acc, tmp, x, b);
  } else {
    sm90::pin(acc);
    sm90::wg_fence();
    if constexpr (FLASH) {
      hilo_product(acc, x, b);
    } else if constexpr (NT == 3) {
      terms_rs<false>(acc, x, b);
    } else {
      sm90::product_rs<1>(acc, x, b);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(acc);
  }
}

template <typename T, bool FLASH>
__device__ __forceinline__ float exp_of(float x) {
  if constexpr (FLASH && kTerms<T> == 1) {
    return sm90::ex2(x * sm90::LOG2E);
  } else {
    return expf(x);
  }
}

template <typename T>
__device__ __forceinline__ float bias_at(const AnyArgs<T>& p, int b, int h, int q, int k) {
  return p.bias == nullptr ? 0.f : p.bias[b * p.bsb + h * p.bsh + (long long)q * p.bsq + (long long)k * p.bsk];
}

// One 64 x 64 output chunk: rows row0 + lrow (+ 8) of this thread, columns
// c0 + nt * 8 + 2 tig (+ 1), each value times mul[r], stored element by
// element where the row is below S and the column below D.
template <typename T>
__device__ __forceinline__ void store_chunk(T* base, long long ss, int row0, int lrow, int S, int c0, int D,
                                            const float (&acc)[32], const float (&mul)[2], int tig) {
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, row = row0 + lrow + 8 * r, col = c0 + nt * 8 + tig * 2 + (e & 1);
      if (row < S && col < D) base[(long long)row * ss + col] = from_f<T>(acc[nt * 4 + e] * mul[r]);
    }
  }
}

// ----------------------------------------------------------- forward
// A stage: chunk c of Q and K, and chunk oc of V (NT tiles each).
template <int NT>
__host__ __device__ constexpr int fwd_smem() { return 1024 + STAGES * 3 * NT * TB; }

template <typename T, bool FLASH>
__device__ __forceinline__ void any_fwd_body(const AnyArgs<T>& p) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t any_smem[];
  const uint32_t sbase = aligned_smem(any_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ND = p.ND, h = blockIdx.y / ND, oc = blockIdx.y % ND;
  const int q0 = blockIdx.x * ROWS, b = blockIdx.z;
  const int lrow = warp * 16 + g;
  const int nk = (p.Skv + ROWS - 1) / ROWS;
  constexpr int SWEEPS = FLASH ? 1 : 2;  // fused: sweep 0 for the row max
  const int nsub = SWEEPS * nk * ND;

  // substep i: step js = i / ND (key tile js % nk of sweep js / nk), chunk
  // (oc + 1 + i % ND) % ND; the step's last substep also loads V's chunk oc
  auto stage = [&](int i) {
    if (i < nsub) {
      const int js = i / ND, t = i % ND, c = (oc + 1 + t) % ND, k0 = (js % nk) * ROWS;
      const uint32_t st = sbase + (i % STAGES) * 3 * NT * TB;
      load_terms<NT>(st, p.q, b, h, q0, p.Sq, c, p.D, p.vq, tid);
      load_terms<NT>(st + NT * TB, p.k, b, h, k0, p.Skv, c, p.D, p.vk, tid);
      if (t == ND - 1 && js >= (SWEEPS - 1) * nk)
        load_terms<NT>(st + 2 * NT * TB, p.v, b, h, k0, p.Skv, oc, p.D, p.vv, tid);
    }
    sm90::cp_async_commit();
  };
  stage(0);

  float m[2] = {FLASH ? NEG_INF : -INFINITY, FLASH ? NEG_INF : -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[32], s[32], tmp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int i = 0; i < nsub; ++i) {
    const int js = i / ND, t = i % ND, k0 = (js % nk) * ROWS;
    const bool sweep2 = js >= (SWEEPS - 1) * nk;
    const uint32_t st = sbase + (i % STAGES) * 3 * NT * TB;
    sm90::cp_async_wait_all();
    __syncthreads();  // substep i has landed; the warpgroup is done with substep i-1's stage
    stage(i + 1);

    chunk_step<NT>(s, tmp, st, st + NT * TB, t);
    if (t != ND - 1) continue;

    // the step's logits: s * scale + bias, -inf at keys past Skv
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ROWS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + nt * 8 + tig * 2 + (e & 1);
        float x = -INFINITY;
        if (key < p.Skv)
          x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), bias_at(p, b, h, min(q0 + lrow + 8 * r, p.Sq - 1), key));
        s[nt * 4 + e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
    if (!sweep2) {  // fused sweep 0: the exact row max
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], tmax[r]);
      if (js == nk - 1)
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
      continue;
    }
    if constexpr (FLASH) {  // online: rescale by the new max
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(tmax[r]));
        const float corr = exp_of<T, FLASH>(m[r] - mn);
        m[r] = mn;
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (((j >> 1) & 1) == r) o[j] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = exp_of<T, FLASH>(s[j] - m[r]);
      l[r] += s[j];
    }
    out_product<T, FLASH>(o, tmp, s, st + 2 * NT * TB);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (FLASH) l[r] = fmaxf(l[r], 1e-30f);
  }
  // o / l as the head-dim-64 kernels divide: one division per value
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = o[j] / l[(j >> 1) & 1];
  const float one[2] = {1.f, 1.f};
  store_chunk<T>(p.o.at(b, h), p.o.ss, q0, lrow, p.Sq, oc * CHUNK, p.D, o, one, tig);
  if (oc == 0 && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + lrow + 8 * r;
      if (row < p.Sq) p.lse[((long long)b * p.H + h) * p.Sq + row] = m[r] + logf(l[r]);
    }
  }
}

// ------------------------------------------------------------ dq
// A stage: chunk c of Q, dO, K and V (NT tiles each).
template <int NT>
__host__ __device__ constexpr int bwd_smem() { return 1024 + STAGES * 4 * NT * TB; }

// the fused dq launch's delta of row q: rowsum(dO * o) over D in fp32, dO as
// its NT terms (two threads a row, even and odd columns, then one add)
template <typename T>
__device__ __forceinline__ float row_delta(const AnyArgs<T>& p, int b, int h, int q, int half) {
  constexpr int NT = kTerms<T>;
  const bf16* dr = p.dout.at(b, h) + (long long)q * p.dout.ss;
  const T* orow = p.ctx.at(b, h) + (long long)q * p.ctx.ss;
  float acc = 0.f;
  for (int c = half; c < p.D; c += 2) {
    float d = __bfloat162float(dr[c]);
    if (NT == 3) d = (d + __bfloat162float(dr[c + p.dout.tt])) + __bfloat162float(dr[c + 2 * p.dout.tt]);
    acc += d * to_f(orow[c]);
  }
  return acc;
}

template <typename T, bool FLASH>
__device__ __forceinline__ void any_dq_body(const AnyArgs<T>& p) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t any_smem[];
  const uint32_t sbase = aligned_smem(any_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ND = p.ND, h = blockIdx.y / ND, oc = blockIdx.y % ND;
  const int q0 = blockIdx.x * ROWS, b = blockIdx.z;
  const int lrow = warp * 16 + g;
  const int row[2] = {q0 + lrow, q0 + lrow + 8};
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;
  const int nk = (p.Skv + ROWS - 1) / ROWS;
  const int nsub = nk * ND;

  auto stage = [&](int i) {
    if (i < nsub) {
      const int j = i / ND, c = (oc + 1 + i % ND) % ND, k0 = j * ROWS;
      const uint32_t st = sbase + (i % STAGES) * 4 * NT * TB;
      load_terms<NT>(st, p.q, b, h, q0, p.Sq, c, p.D, p.vq, tid);
      load_terms<NT>(st + NT * TB, p.dout, b, h, q0, p.Sq, c, p.D, p.vdo, tid);
      load_terms<NT>(st + 2 * NT * TB, p.k, b, h, k0, p.Skv, c, p.D, p.vk, tid);
      load_terms<NT>(st + 3 * NT * TB, p.v, b, h, k0, p.Skv, c, p.D, p.vv, tid);
    }
    sm90::cp_async_commit();
  };
  stage(0);

  // delta of this thread's two rows: given (flash), or rowsum(dO * o) here,
  // written by the output chunk 0 blocks for the dk/dv launch (fused)
  float lse_r[2], dl_r[2];
  if constexpr (FLASH) {
#pragma unroll
    for (int r = 0; r < 2; ++r) dl_r[r] = p.delta[lse0 + min(row[r], p.Sq - 1)];
  } else {
    __shared__ float delta_s[ROWS];
    {
      const int r = tid >> 1, q = q0 + r;
      float acc = q < p.Sq ? row_delta(p, b, h, q, tid & 1) : 0.f;
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((tid & 1) == 0) {
        delta_s[r] = acc;
        if (oc == 0 && q < p.Sq) p.delta[lse0 + q] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) dl_r[r] = delta_s[lrow + 8 * r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) lse_r[r] = p.lse[lse0 + min(row[r], p.Sq - 1)];

  float dq[32], s[32], dp[32], tmp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int i = 0; i < nsub; ++i) {
    const int j = i / ND, t = i % ND, k0 = j * ROWS;
    const uint32_t st = sbase + (i % STAGES) * 4 * NT * TB;
    sm90::cp_async_wait_all();
    __syncthreads();
    stage(i + 1);

    chunk_step<NT>(s, tmp, st, st + 2 * NT * TB, t);
    chunk_step<NT>(dp, tmp, st + NT * TB, st + 3 * NT * TB, t);
    if (t != ND - 1) continue;

    // ds = p (dp - delta) in place of s; keys past Skv and rows past Sq give 0
#pragma unroll
    for (int nt = 0; nt < ROWS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + nt * 8 + tig * 2 + (e & 1);
        float ds = 0.f;
        if (key < p.Skv && row[r] < p.Sq) {
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), bias_at(p, b, h, row[r], key));
          ds = exp_of<T, FLASH>(x - lse_r[r]) * (dp[nt * 4 + e] - dl_r[r]);
        }
        s[nt * 4 + e] = ds;
      }
    }
    // dq += ds . k, k's chunk oc from its natural [key][d] tile (this stage)
    out_product<T, FLASH>(dq, tmp, s, st + 2 * NT * TB);
  }
  const float mul[2] = {p.scale, p.scale};
  store_chunk<T>(p.dq.at(b, h), p.dq.ss, q0, lrow, p.Sq, oc * CHUNK, p.D, dq, mul, tig);
}

// ---------------------------------------------------------- dk, dv
template <typename T, bool FLASH>
__device__ __forceinline__ void any_dkdv_body(const AnyArgs<T>& p) {
  constexpr int NT = kTerms<T>;
  extern __shared__ __align__(16) uint8_t any_smem[];
  const uint32_t sbase = aligned_smem(any_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int ND = p.ND, h = blockIdx.y / ND, oc = blockIdx.y % ND;
  const int k0 = blockIdx.x * ROWS, b = blockIdx.z;
  const int lkey = warp * 16 + g;
  const int key[2] = {k0 + lkey, k0 + lkey + 8};
  const long long lse0 = ((long long)b * p.H + h) * p.Sq;
  const int nq = (p.Sq + ROWS - 1) / ROWS;
  const int nsub = nq * ND;

  auto stage = [&](int i) {
    if (i < nsub) {
      const int j = i / ND, c = (oc + 1 + i % ND) % ND, qt = j * ROWS;
      const uint32_t st = sbase + (i % STAGES) * 4 * NT * TB;
      load_terms<NT>(st, p.k, b, h, k0, p.Skv, c, p.D, p.vk, tid);
      load_terms<NT>(st + NT * TB, p.v, b, h, k0, p.Skv, c, p.D, p.vv, tid);
      load_terms<NT>(st + 2 * NT * TB, p.q, b, h, qt, p.Sq, c, p.D, p.vq, tid);
      load_terms<NT>(st + 3 * NT * TB, p.dout, b, h, qt, p.Sq, c, p.D, p.vdo, tid);
    }
    sm90::cp_async_commit();
  };
  stage(0);

  float dk[32], dv[32], s[32], dp[32], tmp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < nsub; ++i) {
    const int j = i / ND, t = i % ND, qt = j * ROWS;
    const uint32_t st = sbase + (i % STAGES) * 4 * NT * TB;
    sm90::cp_async_wait_all();
    __syncthreads();
    stage(i + 1);

    // s^T = K.Q^T and dp^T = V.dO^T: rows = the block's 64 keys, columns = 64 queries
    chunk_step<NT>(s, tmp, st, st + 2 * NT * TB, t);
    chunk_step<NT>(dp, tmp, st + NT * TB, st + 3 * NT * TB, t);
    if (t != ND - 1) continue;

    // p^T and ds^T in place; queries past Sq and keys past Skv give exactly 0
#pragma unroll
    for (int nt = 0; nt < ROWS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, q = qt + nt * 8 + tig * 2 + (e & 1);
        float pr = 0.f, ds = 0.f;
        if (q < p.Sq && key[r] < p.Skv) {
          const float x = __fadd_rn(__fmul_rn(s[nt * 4 + e], p.scale), bias_at(p, b, h, q, key[r]));
          pr = exp_of<T, FLASH>(x - p.lse[lse0 + q]);
          ds = pr * (dp[nt * 4 + e] - p.delta[lse0 + q]);
        }
        s[nt * 4 + e] = pr;
        dp[nt * 4 + e] = ds;
      }
    }
    // dv += p^T . dO and dk += ds^T . q, chunk oc of dO and q (this stage)
    out_product<T, FLASH>(dv, tmp, s, st + 3 * NT * TB);
    out_product<T, FLASH>(dk, tmp, dp, st + 2 * NT * TB);
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {p.scale, p.scale};
  store_chunk<T>(p.dv.at(b, h), p.dv.ss, k0, lkey, p.Skv, oc * CHUNK, p.D, dv, one, tig);
  store_chunk<T>(p.dk.at(b, h), p.dk.ss, k0, lkey, p.Skv, oc * CHUNK, p.D, dk, mul, tig);
}

// ----------------------------------------------------------- launches
inline bool bad_sizes(int B, int H, int Sq, int Skv, int D) {
  return B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || (long long)H * chunks(D) > 65535 ||
         !takes_head_dim(D);
}

// The forward through `kernel` (an entry whose body is any_fwd_body), its
// shared-memory limit raised once per device (`done`).  Returns the CUDA error.
template <typename Kernel, typename T>
inline int launch_any_fwd(Kernel kernel, int* done, const AnyArgs<T>& a, int B, cudaStream_t st) {
  if (bad_sizes(B, a.H, a.Sq, a.Skv, a.D)) return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem<kTerms<T>>();
  const cudaError_t err = sm90::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H * a.ND, B);
  kernel<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// One backward launch (dq over query blocks, or dk/dv over key blocks).
template <typename Kernel, typename T>
inline int launch_any_bwd(Kernel kernel, int* done, const AnyArgs<T>& a, int B, bool dkdv, cudaStream_t st) {
  if (bad_sizes(B, a.H, a.Sq, a.Skv, a.D)) return (int)cudaErrorInvalidValue;
  constexpr int smem = bwd_smem<kTerms<T>>();
  const cudaError_t err = sm90::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((dkdv ? a.Skv : a.Sq) + ROWS - 1) / ROWS, a.H * a.ND, B);
  kernel<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace anyd

// x, a [B, H, S, D] fp32 view by strides -> its hi, mid and lo terms as
// contiguous [B, H, S, D] bf16 planes at out, out + term, out + 2 term (term =
// B H S D), one thread per element: the operand of an fp32 attention product
// at a head dim other than 64.
__global__ void split3_heads_any_kernel(Heads<const float> x, bf16* __restrict__ out, int H, int S, int D,
                                        long long term) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < term;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / D, bh = r / S;
    const int c = (int)(i % D), s = (int)(r % S), h = (int)(bh % H), b = (int)(bh / H);
    const float v = x.at(b, h)[(long long)s * x.ss + c];
#pragma unroll
    for (int t = 0; t < 3; ++t) out[t * term + i] = __float2bfloat16_rn(split_term(v, t));
  }
}

// The operand of an attention product at head dim D: a bf16 view is its own
// (read in place); an fp32 view is split into contiguous [B, H, S, D] term
// planes at `planes` (3 B H S D elements).  Sets *vec to whether it can be
// copied 16 bytes at a time.  Returns the CUDA error.
inline int heads_operand_any(Heads<const bf16> x, int, int, int, int D, bf16*, Heads<const bf16>* op, int* vec,
                             cudaStream_t) {
  *op = x;
  *vec = anyd::vec_ok(x, D);
  return 0;
}
inline int heads_operand_any(Heads<const float> x, int B, int H, int S, int D, bf16* planes,
                             Heads<const bf16>* op, int* vec, cudaStream_t st) {
  const long long term = (long long)B * H * S * D;
  *op = {planes, (long long)H * S * D, (long long)S * D, D, term};
  *vec = anyd::vec_ok(*op, D);
  const long long blocks = (term + 255) / 256 < 132 * 32 ? (term + 255) / 256 : 132 * 32;
  split3_heads_any_kernel<<<(unsigned)blocks, 256, 0, st>>>(x, planes, H, S, D, term);
  return (int)cudaGetLastError();
}

}  // namespace port
