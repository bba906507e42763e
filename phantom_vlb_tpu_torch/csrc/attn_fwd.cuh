// The Hopper (sm_90a) attention-forward core shared by flash_fwd.cu and
// ring_fwd.cu: on the primitives of hopper.cuh (mbarriers, TMA tile loads
// and stores, wgmma shared-memory descriptors, wgmma SS and RS products, the
// accumulator-to-A-fragment conversion), the warpgroup barriers and the
// consumer warpgroup's work: its Q rows pre-scaled in place, one kv tile
// folded into the online softmax, and the epilogue.
//
// The block both kernels run (384 threads, one block an SM, persistent):
// it walks work items (128-row q tile, q head, batch row) longest first
// (item_at). Per block:
// - warpgroup 0 is the producer (24 registers a thread by setmaxnreg in
//   flash_fwd.cu, 40 in ring_fwd.cu). Its thread 0 keeps a ring of NST
//   stages of K and V tiles (128 rows x 128, bf16) in flight by TMA, all
//   128B-swizzled, with a full and an empty mbarrier per stage, across
//   items: an item's first tiles are loaded while the consumers finish the
//   previous item, then each consumer warpgroup's 64 Q rows once that
//   warpgroup has stored its output from them (a full and an empty
//   mbarrier per warpgroup). Its warp 1 writes each stage's 128 bias floats
//   (kv rows past the sequence get MASK_VALUE) with ordinary loads, since a
//   bias row of S = 129 floats is not 16-byte aligned for a copy engine.
// - warpgroups 1 and 2 are consumers (240 registers a thread, 232 in
//   ring_fwd.cu), 64 q rows each. Per kv tile: S = Q K^T by wgmma SS
//   (m64n128k16, f32 sums), the bias row added, then MASK_VALUE where
//   col > row + offset and where col >= S (only on tiles that may hold
//   such keys), the online softmax in f32 registers (exp2 of the
//   difference taken before the log2(e) scale), P cast to bf16 in
//   registers, and O += P V by wgmma RS (m64n128k16, V MN-major from
//   shared memory).
//   Epilogue: out = O * (l == 0 ? 1 : 1 / l) in bf16, staged in the
//   warpgroup's own Q rows (swizzled as TMA reads them) and stored by TMA,
//   which drops the rows past the sequence; lse = m + log(max(l, 1e-30)).
//
// Register use per consumer thread: S 64, O 64, P 32 (of 232-240). Inside a
// warpgroup the work is pipelined: tile j's Q K^T and tile j-1's P V are
// issued together and tile j's softmax runs while P V does. Shared
// memory: Q 32 KB + NST * (K + V) 64 KB + the bias rows.
//
// Cost probes, timed only (chip_smoke.py phase 11): built with
// ATTN_FWD_PROBE_NO_EXP (the exponential left out) or ATTN_FWD_PROBE_NO_PV
// (the P V product left out), both wrong on purpose, a kernel says what
// that part costs.
//
// ptxas 12.9 crashed on wgmma with a runtime scale-d, on warpgroup loops
// with a runtime start and on empty-asm fences of freshly zeroed
// accumulators (found on flash_bwd.cu). Here accumulators are zeroed with
// moves and always accumulated into, loops start at constants, and
// register fences come only after a wgmma wait.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_fwd {

using namespace hopper;

constexpr int D = 128;                 // head dim
constexpr int BM = 128;                // q rows per block: two consumer warpgroups of 64
constexpr int BN = 128;                // kv rows per tile
constexpr int NTHREADS = 384;          // producer warpgroup + two consumer warpgroups
constexpr int NST = 3;                 // K/V stages in flight: two held by the pipelined consumers
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;
// Tensor-map encoding failures come back as this plus the CUresult.
constexpr int ENCODE_ERROR = 100000;

// Shared memory, bytes from a 1024-aligned base. A 128B-swizzled tile of R
// rows x 128 columns is two R x 64 halves of R * 128 bytes, as TMA writes
// them and as wgmma's descriptors read them.
struct Smem {
  static constexpr uint32_t TILE = 128 * 256;            // Q, K or V: 128 rows, both halves
  static constexpr uint32_t HALF = 128 * 128;            // one 64-column half
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + TILE;                // [NST]
  static constexpr uint32_t V = K + NST * TILE;          // [NST]
  static constexpr uint32_t BIAS = V + NST * TILE;       // [NST][BN] f32
  static constexpr uint32_t BAR = BIAS + NST * BN * 4;   // q_full[2], q_empty[2], full[NST], empty[NST]
  static constexpr uint32_t BYTES = BAR + 8 * (4 + 2 * NST) + 1024;   // + alignment slack
  static constexpr uint32_t STAGE_TX = 2 * TILE;         // K and V of a stage
  static constexpr uint32_t Q_TX = TILE / 2;             // a consumer warpgroup's 64 Q rows
  static_assert(BYTES <= 232448, "shared memory over the 227 KB a block may use");
};

// ---- primitives (the rest are in hopper.cuh) ----

// Barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// The consumer warpgroups take turns at issuing their products: warpgroup
// wg waits on barrier 3 + wg until the other has issued its own and
// arrived there (256 threads: one warpgroup waiting, the other arriving).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(3 + (wg ^ 1)) : "memory");
}

// 2^x in one MUFU instruction; a result below 2^-126 flushes to zero
// (exp2f's fix-ups for such results cost three more instructions, and such
// a term is below f32's resolution of a row sum that holds a 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// ---- the block's pieces ----------------------------------------------------

// The block's barriers and shared memory, from the dynamic shared memory.
struct Block {
  uint32_t base;                       // 1024-aligned shared address
  unsigned char* smem;                 // the same, generic
  __device__ __forceinline__ uint32_t q_full(int wg) const { return base + Smem::BAR + 8 * wg; }
  __device__ __forceinline__ uint32_t q_empty(int wg) const { return base + Smem::BAR + 16 + 8 * wg; }
  __device__ __forceinline__ uint32_t full(int st) const { return base + Smem::BAR + 32 + 8 * st; }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return base + Smem::BAR + 32 + 8 * NST + 8 * st;
  }
  __device__ __forceinline__ uint32_t k(int st) const { return base + Smem::K + st * Smem::TILE; }
  __device__ __forceinline__ uint32_t v(int st) const { return base + Smem::V + st * Smem::TILE; }
  __device__ __forceinline__ float* bias(int st) const {
    return reinterpret_cast<float*>(smem + Smem::BIAS + st * BN * 4);
  }
};

__device__ __forceinline__ Block block_init(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  Block blk{base, smem_raw + (base - raw)};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int wg = 0; wg < 2; ++wg) {
      mbar_init(blk.q_full(wg), 1);
      mbar_init(blk.q_empty(wg), 1);               // the warpgroup's storing thread
    }
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(blk.full(s), 1 + 32);              // the TMA thread + the bias warp's lanes
      mbar_init(blk.empty(s), NTHREADS - 128);     // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();
  return blk;
}

// ---- the persistent schedule ----------------------------------------------
//
// A block walks work items in rounds: round r takes item r * G + b on even
// rounds and r * G + (G - 1 - b) on odd ones (G blocks, b this one). Items
// are numbered longest first, so each round hands the blocks items of about
// one length and the snake order evens out what is left.
__device__ __forceinline__ int item_at(int round) {
  const int G = gridDim.x, b = blockIdx.x;
  return round * G + ((round & 1) ? G - 1 - b : b);
}

// Item w of nq q tiles x Hq heads x B batch rows: the q tile slowest and
// from the last (longest) down.
struct Item {
  int qi, h, b;
};

__device__ __forceinline__ Item item_of(int w, int nq, int Hq, int B) {
  const int per = Hq * B, rem = w % per;
  return Item{nq - 1 - w / per, rem % Hq, rem / Hq};
}

// Producer thread 0: consumer warpgroup wg's 64 Q rows of the block's
// round-th item (two 64-column halves) by TMA, once the warpgroup has
// stored the previous item's output from them.
__device__ __forceinline__ void load_q(const Block& blk, int wg, int round, const CUtensorMap* tm_q,
                                       int col0, int row0, int b) {
  if (round > 0) mbar_wait(blk.q_empty(wg), (round - 1) & 1);
  mbar_expect_tx(blk.q_full(wg), Smem::Q_TX);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    tma_load_3d(blk.base + Smem::Q + half * Smem::HALF + wg * 64 * 128, tm_q, col0 + half * 64, row0, b,
                blk.q_full(wg));
  }
}

// Producer thread 0: waits until the stage of the block's g-th kv tile is
// free and arms its full barrier; the caller then issues its K and V loads.
__device__ __forceinline__ int claim_stage(const Block& blk, int g) {
  const int st = g % NST;
  if (g >= NST) mbar_wait(blk.empty(st), ((g / NST) - 1) & 1);
  mbar_expect_tx(blk.full(st), Smem::STAGE_TX);
  return st;
}

// Producer warp 1: the bias row of the block's g-th kv tile into its stage,
// keys key0..key0+127 of a row of `len` keys at `row` (null: zeros); keys
// at or past len get MASK_VALUE.
__device__ __forceinline__ void put_bias(const Block& blk, int g, const float* row, int key0, int len) {
  const int lane = threadIdx.x & 31;
  const int st = g % NST;
  if (g >= NST) mbar_wait(blk.empty(st), ((g / NST) - 1) & 1);
  float* dst = blk.bias(st);
#pragma unroll
  for (int e = 0; e < BN / 32; ++e) {
    const int key = key0 + lane + 32 * e;
    dst[lane + 32 * e] = key >= len ? MASK_VALUE : (row != nullptr ? row[key] : 0.0f);
  }
  mbar_arrive(blk.full(st));
}

// A consumer thread's place: warpgroup wg (0 or 1) of the consumers, and
// its accumulator rows. Accumulator element i of an m64nN tile sits at row
// r0 + 8 * ((i >> 1) & 1) of the warpgroup's 64 and column
// 8 * (i >> 2) + 2 * tq + (i & 1).
struct Consumer {
  int wg, warp, g, tq;
  __device__ __forceinline__ Consumer() {
    const int ct = threadIdx.x - 128;
    wg = ct >> 7;
    warp = (ct >> 5) & 3;
    g = (ct & 31) >> 2;
    tq = ct & 3;
  }
  __device__ __forceinline__ int r0() const { return warp * 16 + g; }
};

// The warpgroup's 64 Q rows of the block's round-th item, pre-scaled in
// place once they land: bf16(q * s) with one rounding, as the reference
// multiplies q in its dtype; then made visible to wgmma.
__device__ __forceinline__ void scale_q(const Block& blk, const Consumer& c, float scale, int round) {
  mbar_wait(blk.q_full(c.wg), round & 1);
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint4* rows = reinterpret_cast<uint4*>(blk.smem + Smem::Q + half * Smem::HALF + c.wg * 64 * 128);
#pragma unroll
    for (int i = 0; i < (64 * 128 / 16) / 128; ++i) {
      uint4 x = rows[t + 128 * i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16(f.x * scale, f.y * scale);
      }
      rows[t + 128 * i] = x;
    }
  }
  fence_async_smem();
  warpgroup_sync(1 + c.wg);
}

// The online softmax state of a consumer thread: its two rows' running max
// and partial sum (the row's sum is over the quad), and its share of O.
struct Softmax {
  float m[2], l[2], o[64];
  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  }
};

// Where kv tile `it` sits: its first key, the causal offset its keys are
// held to (key > row + offset is masked), and whether it may hold a masked
// key for some row of the warpgroup (only then is the mask applied).
struct TileInfo {
  int key0, offset;
  bool masked;
};

// S = Q K^T for stage st, 64 rows x 128 keys, issued and committed (not
// waited for). The accumulators start from zeros.
__device__ __forceinline__ void issue_qk(const Block& blk, const Consumer& c, float (&s)[64], int st) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;
  const uint32_t sq = blk.base + Smem::Q + c.wg * 64 * 128;
  const uint32_t sk = blk.k(st);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * Smem::HALF + (kk & 3) * 32;
    wgmma_ss_n128<0, 0>(s, smem_desc(sq + off, 16, 1024), smem_desc(sk + off, 16, 1024));
  }
  wgmma_commit();
}

// O += P V for stage st, P (bf16) in registers, V MN-major with its halves
// 16 KB apart; issued and committed (not waited for).
__device__ __forceinline__ void issue_pv(const Block& blk, float (&o)[64], const uint32_t (&p)[32], int st) {
#ifdef ATTN_FWD_PROBE_NO_PV
  (void)blk;
  (void)st;
  o[0] += __uint_as_float(p[0] & p[31]);
#else
  const uint32_t sv = blk.v(st);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < BN / 16; ++k) {
    wgmma_rs_n128<1>(o, p + 4 * k, smem_desc(sv + k * 2048, Smem::HALF, 1024));
  }
#endif
  wgmma_commit();
}

// The softmax of one tile's scores s (stage st's bias row): + bias, then,
// with kMask, + MASK_VALUE where key key0 + col lies past row + offset (row:
// the element's q index, q_row0 the warpgroup's first) and where it lies at
// or past len; the running max and sum updated; s turned into p (f32);
// alpha, the factor O's rows must be rescaled by, returned.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(const Block& blk, const Consumer& c, Softmax& sm,
                                             float (&s)[64], float (&alpha)[2], int st, int q_row0,
                                             int key0, int offset, int len) {
  const float* bias = blk.bias(st);
  float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * c.tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      float x = s[i] + ((e & 1) ? bv.y : bv.x);
      if constexpr (kMask) {
        const int key = key0 + 8 * n + 2 * c.tq + (e & 1);
        const int row = q_row0 + c.r0() + 8 * (e >> 1);
        if (key > row + offset) x += MASK_VALUE;
        if (key >= len) x += MASK_VALUE;
      }
      s[i] = x;
      mc[e >> 1] = fmaxf(mc[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
    mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
    const float m_next = fmaxf(sm.m[r], mc[r]);
    alpha[r] = exp2_ftz((sm.m[r] - m_next) * LOG2E);
    sm.m[r] = m_next;
    sm.l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    // Subtract before scaling: MASK_VALUE * log2(e) would overflow.
#ifdef ATTN_FWD_PROBE_NO_EXP
    const float p = (s[i] - sm.m[r]) * LOG2E;
#else
    const float p = exp2_ftz((s[i] - sm.m[r]) * LOG2E);
#endif
    s[i] = p;
    sm.l[r] += p;
  }
}

template <class TileFn>
__device__ __forceinline__ void softmax_of(const Block& blk, const Consumer& c, Softmax& sm, float (&s)[64],
                                           float (&alpha)[2], int it, int st, int q_row0, int len,
                                           TileFn tile) {
  const TileInfo t = tile(it);
  if (t.masked) softmax_tile<true>(blk, c, sm, s, alpha, st, q_row0, t.key0, t.offset, len);
  else softmax_tile<false>(blk, c, sm, s, alpha, st, q_row0, t.key0, t.offset, len);
}

// The item's kv tiles 0..n-1 (the block's tiles g0..g0+n-1) folded into the
// warpgroup's rows, each once its stage has landed; tile(it) says where
// tile it sits (TileInfo). Pipelined inside the warpgroup: tile it's Q K^T
// and tile it-1's P V are issued together, and tile it's softmax runs while
// P V does; a stage is released once its P V is done. The arithmetic and
// its order are those of one tile at a time.
//
// Across the two warpgroups the products are issued in turns (ping-pong),
// n + 1 turns each per item, warpgroup 0 first: one's softmax runs while the
// other's products do. Warpgroup 1 seeds the first turn (seed_turns) and
// passes the turn after its last issue only if a later item of the block
// has tiles (`more`), so no arrival is left pending when the block ends.
__device__ __forceinline__ void seed_turns(const Consumer& c) {
  if (c.wg == 1) turn_pass(1);
}

template <class TileFn>
__device__ __forceinline__ void run_tiles(const Block& blk, const Consumer& c, Softmax& sm, int g0, int n,
                                          bool more, int q_row0, int len, TileFn tile) {
  if (n == 0) return;
  float s[64], alpha[2];
  uint32_t p[32];
  int st = g0 % NST;
  mbar_wait(blk.full(st), (g0 / NST) & 1);
  turn_wait(c.wg);
  issue_qk(blk, c, s, st);
  turn_pass(c.wg);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_of(blk, c, sm, s, alpha, 0, st, q_row0, len, tile);
  acc_to_a<64>(p, s);                  // O is still zero: nothing to rescale
  for (int it = 1; it < n; ++it) {
    const int g = g0 + it, prev = st;
    st = g % NST;
    mbar_wait(blk.full(st), (g / NST) & 1);
    turn_wait(c.wg);
    issue_qk(blk, c, s, st);
    issue_pv(blk, sm.o, p, prev);
    turn_pass(c.wg);
    wgmma_wait<1>();                   // Q K^T done; P V may still run
    fence_regs(s);
    softmax_of(blk, c, sm, s, alpha, it, st, q_row0, len, tile);
    wgmma_wait<0>();
    fence_regs(sm.o);
    mbar_arrive(blk.empty(prev));
#pragma unroll
    for (int i = 0; i < 64; ++i) sm.o[i] *= alpha[(i >> 1) & 1];
    acc_to_a<64>(p, s);
  }
  turn_wait(c.wg);
  issue_pv(blk, sm.o, p, st);
  if (c.wg == 0 || more) turn_pass(c.wg);
  wgmma_wait<0>();
  fence_regs(sm.o);
  mbar_arrive(blk.empty(st));
}

// Epilogue of a consumer warpgroup: out rows q_row0 + 0..63 (as the tensor
// map's row coordinate; rows past the tensor are dropped by TMA) and their
// lse, rows below len only, at lse_row[row]. The warpgroup's Q rows are
// free for the next item's once TMA has read the output from them.
__device__ __forceinline__ void finish(const Block& blk, const Consumer& c, Softmax& sm,
                                       const CUtensorMap* tm_o, int col0, int q_row0, int b,
                                       float* lse_row, int len) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = sm.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = (l == 0.0f) ? 1.0f : 1.0f / l;
    const int row = q_row0 + c.r0() + 8 * r;
    if (c.tq == 0 && row < len) lse_row[row] = sm.m[r] + logf(fmaxf(l, 1e-30f));
  }
  // out in bf16 into the warpgroup's own Q rows (no wgmma reads them any
  // more), 128B-swizzled as TMA reads them: row r's 16-byte chunk k sits at
  // chunk k ^ (r & 7), and r & 7 = g.
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int half = n >> 3, chunk = n & 7;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      unsigned char* dst = blk.smem + Smem::Q + half * Smem::HALF + (c.wg * 64 + c.r0() + 8 * r) * 128
                           + ((chunk ^ c.g) << 4) + 4 * c.tq;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(sm.o[4 * n + 2 * r] * inv[r], sm.o[4 * n + 2 * r + 1] * inv[r]);
    }
  }
  fence_async_smem();
  warpgroup_sync(1 + c.wg);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tma_store_3d(tm_o, blk.base + Smem::Q + half * Smem::HALF + c.wg * 64 * 128, col0 + half * 64,
                   q_row0, b);
    }
    bulk_commit();
    bulk_wait_read<0>();                  // shared memory stays until TMA has read it
    mbar_arrive(blk.q_empty(c.wg));
  }
}

// ---- host ----------------------------------------------------------------

// Tensor map of `batches` x `rows` rows of `width` bf16 (rows `row_stride`
// elements apart, batches `batch_stride` apart; `slots` of them, each
// `slot_stride` apart, make a 4th dimension when slots > 1): boxes of 64
// columns x `box_rows` rows, 128B-swizzled, zero-filled out of bounds.
inline CUresult encode_rows(CUtensorMap* map, const void* ptr, int width, int rows, int batches,
                            long long batch_stride, int box_rows, int slots = 1,
                            long long slot_stride = 0) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches), static_cast<cuuint64_t>(slots)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2,
                                 static_cast<cuuint64_t>(slot_stride) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, slots > 1 ? 4 : 3,
                                const_cast<void*>(ptr), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The persistent grid: one block an SM, never more blocks than items.
inline cudaError_t persistent_blocks(int items, int device, int* blocks) {
  static int sms[64] = {};
  if (sms[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *blocks = items < sms[device] ? items : sms[device];
  return cudaSuccess;
}

// cuTensorMapEncodeTiled needs a context current on this thread (PyTorch's
// autograd threads may not have made one so yet); cudaFree(0) binds the
// current device's.
inline cudaError_t bind_context() {
  CUcontext ctx = nullptr;
  if (cuCtxGetCurrent(&ctx) != CUDA_SUCCESS || ctx == nullptr) return cudaFree(nullptr);
  return cudaSuccess;
}

}  // namespace attn_fwd
