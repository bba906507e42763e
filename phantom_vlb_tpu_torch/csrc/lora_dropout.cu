// Fused LoRA adapter-input dropout + rank-r matmul for Hopper (sm_90a):
// forward, dx and dA.
//
// Replaces phantom_vlb_tpu/ops/lora_fused.py:_fwd_kernel (line 62),
// _dx_kernel (:92) and _da_kernel (:111), reached through
// fused_dropout_matmul (:147):
//   mid = (mask * x * s) @ A            s = 1/keep rounded to bf16, the
//                                       product rounded to bf16, f32 sums
//   dx  = (dmid @ A^T) * mask * inv     f32 product, f32 inv = 1/keep
//   dA  = (mask * x * s)^T @ dmid       f32 sums
// with x (M, K) bf16, A (K, R) bf16, R in {16, 32, 64, 128}, dmid (M, R)
// bf16. The mask is regenerated in every kernel and never stored: keep iff
// byte >= thr, the byte taken from `bits` (M, K) uint8 when given, else from
// a counter-based hash of (seed, row0 + row, (col0 + col) >> 2) alone:
//   word = fmix32(fmix32(seed ^ (row0 + row) * 0x9E3779B1) ^ ((col0 + col) >> 2)),
//   byte = (word >> 8 * (col & 3)) & 0xFF
// (fmix32 is MurmurHash3's finaliser), so one 32-bit word masks 4
// neighbouring elements and the mask depends on no tile shape: the three
// kernels agree on it by construction, and the port's plain version
// (ops/lora_fused.py:hash_bytes) computes the same bytes. row0 is the
// global index of x's first row: a rank that holds rows [row0, row0 + M)
// of a batch split over ranks draws those rows of the one-card mask. col0
// (a multiple of 4) is the global index of x's first column: a rank of the
// tensor axis whose row-parallel projection reads columns [col0, col0 + K)
// of the input draws those columns of it.
//
// Bound: rank-R contractions move far more bytes than they compute
// (2R = 32 FLOP per 2-byte element of x at R = 16, against the ~295 the
// card needs per byte to be bound by its tensor cores). The forward reads x
// once and A once and writes mid once, (M K + K R + M R) 2 bytes: 50.7 MB at
// M = 6144, K = 4096 (15.1 us at 3.35 TB/s), 176.8 MB at K = 14336 (52.8
// us). dA reads x and dmid once and writes dA in f32: 50.8 MB (15.2 us) and
// 177.3 MB (52.9 us). The products, 2 M K R flops (0.8 / 2.8 GFLOP), take
// under 3 us on mma.sync.
//
// Forward and dA (lora_fwd_kernel, lora_da_kernel: one body, reduce<R, DA>)
// each make one launch that writes the finished output:
// - Work. The forward's output tiles are x's 64-row chunks (mid's 64 x R
//   rows) and its reduced axis K's 64-column chunks; dA's output tiles are
//   K's 64-column chunks (dA's 64 x R rows) and its reduced axis M's 64-row
//   chunks. The grid is G thread-block clusters of cs blocks (cs <= 8, the
//   portable size): cluster c walks output tiles c, c + G, c + 2 G, ...
//   (so that the clusters read neighbouring tiles at once: dA's tiles are
//   128-byte strips of x's rows, and the L2 fetches 256), and its block of
//   rank q streams reduced chunks [n_red q / cs, n_red (q + 1) / cs) of
//   each, so every x tile is read by exactly one block. ops/lora_fused.py:_fwd_plan / _da_plan choose (cs, G) within one
//   wave (one block an SM; the card holds 30 clusters of 4 and 15 of 8) at
//   the least estimated time: the slowest block's tiles plus about 4
//   tiles' time per output tile (10 in dA), but no less than the whole
//   stream at the ~2.4 TB/s the card reads x by TMA (about 96 blocks'
//   worth: more gain nothing); then A or dmid resident, then the fewest
//   blocks. At r 16:
//     (M, K)          forward cs x G   dA cs x G
//     (6144, 4096)    1 x 96           2 x 64
//     (6144, 14336)   8 x 14           1 x 112
//     (3072, 4096)    2 x 48           2 x 64
//     (6144, 2048)    1 x 96           2 x 32     (a tensor rank's o input)
//     (6144, 7168)    1 x 96           1 x 112    (a tensor rank's down input)
// - Pipeline. One producer warp keeps a ring of NST 64 x 64 bf16 x tiles
//   (8 KB, 128B-swizzled; 12 at R = 16, 96 KB) in flight by TMA with
//   mbarriers, x loaded with an L2 evict-first policy (it is read once);
//   in bits mode the 64 x 64 u8 tile of the mask comes through the same
//   stage. A (forward) or dmid (dA)
//   is the other operand, 64 x R a chunk: the block's chunks stay resident
//   when they fit in shared memory (loaded once), else each stage carries
//   its chunk. Where a base is not 16-byte aligned (TMA's rule), the
//   producer warp loads the same tiles with plain loads into the same
//   layouts, inside the same kernel. In dA the producer warp also writes
//   each stage's 64 row keys (fmix32 of seed and row), which every
//   consumer warp would otherwise hash again.
// - Consumers: four groups of four warps (two at R >= 64) take the tiles
//   in turn, warp w & 3 of a group its 16 rows (forward) or columns (dA) of
//   the tile, all four k-steps. Each warp ldmatrix-es its fragments
//   (forward: x's rows as the MMA's A; dA: x's columns, .trans, since K is
//   the MMA's M), applies the mask and the bf16 scale to the fragments in
//   registers (the product rounded to bf16, dropped elements zero: the
//   reference's roundings; two bytes compared at once by a carry into each
//   16-bit lane, spread by a sign-replicating byte permute) and runs
//   mma.sync.m16n8k16 against A's or dmid's rows (ldmatrix.trans), f32 sums.
//   In the forward lanes t4 and t4 ^ 1 need the same hash words and hash
//   half each; in dA a register holds two rows, so the four lanes that need
//   the same words each hash one row's and trade them by shuffles. (All 16
//   warps on every tile, a k-step each, measured slower: their per-tile
//   waits and arrivals cost more than a deeper shared ring gave.)
// - Fold inside the launch. At the end of an output tile each group writes
//   its f32 partial (64 x R) to shared memory, and the consumer threads sum
//   them in group order into the block's partial (three slots, rotating
//   over the tiles). The cluster's barrier is passed one tile late: a block
//   arrives once its partial of tile i is written, and waits for that phase
//   only at the end of tile i + 1, so no block waits on a slower one's
//   tile. Then every block sums its share of tile i's rows over the
//   cluster's block partials through distributed shared memory in rank
//   order, and writes them: bf16 mid, f32 dA. No atomics and no order that
//   depends on which block arrives first: two calls on the same inputs are
//   bit-equal. Against this file's first kernels: no (split, M, R)
//   or (split, K, R) f32 buffer and no sum / cast launches after the kernel
//   (three launches a forward call and two a dA call become one), and 96 KB
//   of x in flight a block where a register prefetch held 8 KB.
// Cost probe: built with LORA_DROPOUT_PROBE_NO_MASK the mask and scale are
// left out (wrong on purpose); chip_smoke.py phase 11 times both kernels
// against it, which says what the mask costs and what the stream alone
// reaches.
// mma.sync and not wgmma: at R = 16 a tile's products are 64 x 16 x 64,
// below wgmma's 64-row, 4-warp granule in one operand, and on mma.sync they
// take a few percent of the time the tile takes to arrive; the masking,
// which wgmma would need in shared memory, is done in the registers the
// MMA reads.
//
// dx (lora_dx_kernel, not redesigned): a warp owns 16 rows x 64 columns;
// dmid's fragment is loaded once and A's fragments straight from global
// memory, with the product's columns permuted so that each thread ends with
// 16 neighbouring output columns per row: the mask is applied in registers
// and dx leaves in 16-byte stores.
//
// The scale s. The u8 rule's is 1/keep rounded to bf16, so the bf16 product
// x * s (one rounding of the exact product). The 32-bit rule's
// (ops/lora_fused.py:dropout_rule) is the f32 reciprocal of keep rounded to
// bf16, which is what PyTorch's x / bf16(keep) multiplies by on the card:
// x * s in f32, rounded to f32 and then to bf16, as that division does. The
// consumers take the f32 form only where s is not a bf16 value (the two
// agree wherever it is), a test that is the same for the whole launch.
//
// Keep bytes of the 32-bit rule (lora_keep_kernel): u8 keep[i] = 1 iff
// element i of torch.rand(numel, generator=torch.Generator("cuda")
// .manual_seed(seed)) < keep (f32), the generator fresh (offset 0), for the
// fwd / dx / dA kernels' bits mode at thr 1. PyTorch's draw
// (ATen/native/cuda/DistributionTemplates.h, distribution_elementwise_grid_
// stride_kernel on calc_execution_policy's grid): blocks of 256 threads,
// min(ceil(numel / 256), SMs x maxThreadsPerSM / 256) of them, T threads in
// all; thread t's curand Philox4x32-10 state has subsequence t (the counter's
// words z, w) and offset 0, and its i-th curand_uniform4 fills elements
// t + 4 T i + T j, j = 0..3, from word j of Philox4x32-10(counter (i, 0, t),
// key (seed lo, seed hi)) (curand_philox4x32_x.h). A word u becomes u * 2^-32
// + 2^-33 in f32 (curand_uniform.h), 1.0 becomes 0 (uniform_kernel's fold),
// and the compare is f32. Each thread here walks the same elements: every
// Philox output is used, a warp's 32 stores of one j are 32 neighbouring
// bytes, and the grid comes from the card's properties
// (ops/lora_fused.py:_rand_blocks), so it is PyTorch's on any card. The
// uniform and the compare become two integer compares: u(w) is monotone in
// the word w, so u < keep iff w < lo, and u == 1 (folded to 0, kept) iff
// w >= hi, with lo and hi found once on the host (ops/lora_fused.py:
// _keep_words; 25% faster than the float steps on the card). Indices are
// 32-bit: PyTorch draws at most 2^29 - 1 values in one launch.
// Bound: 1 byte written an element, 7.5 us at (6144, 4096) at 3.35 TB/s;
// the integer work, ten rounds of 2 IMAD.WIDE and 2 LOP3 a Philox call per
// 4 elements, takes longer (ops/lora_fused.py:keep_bytes_plain is the same
// draw in int64 torch ops).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 64;                          // chunk edge (rows and columns)
constexpr int NTHREADS = 128;                   // the dx kernel's block
constexpr uint32_t TILE_BYTES = CH * CH * 2;    // a 64 x 64 bf16 tile, 128-byte rows
constexpr uint32_t BITS_BYTES = CH * CH;        // a 64 x 64 u8 tile of the mask, 64-byte rows
constexpr uint32_t SMEM_LIMIT = 232448;         // what a block may use (227 KB)
constexpr uint32_t FULL_MASK = 0xFFFFFFFFu;

// By rank R: the consumer groups of four warps that take the tiles in turn
// (four at R <= 32, to hide the mask's integer work behind 16 warps; two
// above, for the registers of the wider sums), the block's threads (and
// one producer warp), the stages of the ring, the bytes of a 64 x R chunk
// of A or dmid, and the f32 row stride of a partial (padded against bank
// conflicts). The stages shrink with the rank, for the chunks' and
// partials' room (R = 128, off the path, keeps 2), and are a multiple of
// the groups, so that a stage always serves the same group: a group never
// waits on a phase of a stage two phases ahead of one another group has
// yet to see complete (a parity wait would pass).
__host__ __device__ constexpr int groups(int R) { return R <= 32 ? 4 : 2; }
__host__ __device__ constexpr int consumers(int R) { return groups(R) * 128; }
__host__ __device__ constexpr int threads(int R) { return consumers(R) + 32; }
__host__ __device__ constexpr int stages(int R) { return R == 16 ? 12 : R == 32 ? 8 : R == 64 ? 6 : 2; }
static_assert(stages(16) % groups(16) == 0 && stages(32) % groups(32) == 0 && stages(64) % groups(64) == 0 &&
              stages(128) % groups(128) == 0, "a stage must serve one group");
__host__ __device__ constexpr uint32_t p_slot(int R) { return CH * R * 2; }
__host__ __device__ constexpr int part_stride(int R) { return R + 4; }
__host__ __device__ constexpr uint32_t part_bytes(int R) { return CH * part_stride(R) * 4; }

// Shared memory of the forward / dA block, bytes from a 1024-aligned base:
// x tiles [NST], A or dmid chunks [p_slots], u8 mask tiles [NST] (bits
// mode), the row keys of each stage's 64 rows [NST] (dA), the groups'
// partials [groups(R)], the block's partials [3 slots], then full[NST],
// empty[NST], pfull. ops/lora_fused.py:smem_bytes mirrors this.
constexpr int PART_SLOTS = 3;
constexpr uint32_t KEYS_BYTES = CH * 4;
struct Layout {
  uint32_t x, p, bits, keys, gpart, part, bar, bytes;
};

__host__ __device__ inline Layout layout_of(int R, int p_slots, bool bits) {
  Layout l;
  const int nst = stages(R);
  l.x = 0;
  l.p = l.x + nst * TILE_BYTES;
  l.bits = l.p + p_slots * p_slot(R);
  l.keys = l.bits + (bits ? nst * BITS_BYTES : 0);
  l.gpart = l.keys + nst * KEYS_BYTES;
  l.part = l.gpart + groups(R) * part_bytes(R);
  l.bar = l.part + PART_SLOTS * part_bytes(R);
  l.bytes = l.bar + 8 * (2 * nst + 1) + 1024;   // + alignment slack
  return l;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int row) {
  return fmix32(seed ^ (static_cast<uint32_t>(row) * 0x9E3779B1u));
}

// The 4 mask bytes of element columns 4w .. 4w+3 of a row.
__device__ __forceinline__ uint32_t mask_word(uint32_t key, int col) {
  return fmix32(key ^ static_cast<uint32_t>(col >> 2));
}

// prmt.b32: result byte n is byte (sel >> 4n) & 7 of {hi:lo}, or that
// byte's sign bit replicated where (sel >> 4n) & 8.
__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
  return r;
}

// The keep mask of a bf16 pair from its two mask bytes, held at bits 0-7
// and 16-23 of b (the rest zero): byte + 0x8000 - thr has bit 15 set iff
// byte >= thr, each in its own 16-bit lane (kthr = (0x8000 - thr) *
// 0x10001), and bits 15 and 31 are spread over their halves by replicating
// those bytes' signs: 0xFFFF in the half of a kept element.
__device__ __forceinline__ uint32_t keep_pair(uint32_t b, uint32_t kthr) {
  return prmt(b + kthr, 0u, 0xBB99u);
}

// mask * x * s for a bf16 pair: the dropped halves zeroed, then each times
// s rounded to bf16 (0 * s = 0: the reference's where(keep, x * s, 0)).
__device__ __forceinline__ uint32_t drop_pair(uint32_t x2, uint32_t keep, __nv_bfloat162 s2) {
  const uint32_t kept = x2 & keep;
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&kept), s2);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The same with an f32 s: each kept half times s in f32, rounded to f32
// and then to bf16.
__device__ __forceinline__ uint32_t drop_pair_f32(uint32_t x2, uint32_t keep, float s) {
  const uint32_t kept = x2 & keep;
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(__uint_as_float(kept << 16), s),
                                                 __fmul_rn(__uint_as_float(kept & 0xFFFF0000u), s));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// 8 bf16 at (row, col .. col + 7) of a row-major (rows, ld) matrix, zeros
// past `rows`; `vec`: an aligned base, so one 16-byte load.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ g, int rows, int ld, int row,
                                       int col, bool vec) {
  if (row >= rows) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* p = g + static_cast<size_t>(row) * ld + col;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = e[2 * i] | (static_cast<uint32_t>(e[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 mask bytes at (row, col .. col + 15) of the (rows, ld) u8 matrix.
__device__ __forceinline__ uint4 load16_u8(const uint8_t* __restrict__ g, int rows, int ld, int row,
                                           int col, bool vec) {
  if (row >= rows) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = g + static_cast<size_t>(row) * ld + col;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = p[4 * i] | (p[4 * i + 1] << 8) | (p[4 * i + 2] << 16) | (static_cast<uint32_t>(p[4 * i + 3]) << 24);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* p;      // A (K, R) for the forward, dmid (M, R) for dA
  const uint8_t* bits;         // (M, K), or null for the hash
  void* out;                   // mid (M, R) bf16, or dA (K, R) f32
  int M, K;
  uint32_t seed;
  int row0, col0, thr;
  float scale;
  bool resident;               // the block's A / dmid chunks stay in shared memory
  bool tma;                    // the tensor maps are valid
  bool vec_x, vec_p, vec_bits;  // 16-byte plain loads allowed
};

// Barrier 1 of the block's consumer threads (the producer warp is not in it).
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// The block's partial of a tile: the groups' partials (gpart, [G][64][PST])
// summed in group order into part ([64][PST]), f32x4 items over `n`
// threads from `first`.
template <int R, int G>
__device__ __forceinline__ void sum_groups(const float* gpart, float* part, int first, int n) {
  constexpr int PST = part_stride(R);
  for (int e = first; e < CH * (R / 4); e += n) {
    const int off = (e / (R / 4)) * PST + (e % (R / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(gpart + off);
#pragma unroll
    for (int k = 1; k < G; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(gpart + k * CH * PST + off);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    *reinterpret_cast<float4*>(part + off) = v;
  }
}

// Output tile `out`'s rows [64 rank / cs, 64 (rank + 1) / cs): the sum of
// the cluster's block partials at shared address `slot` (in every block of
// the cluster), in rank order, up to 8 loads in flight; mid in bf16 (rows
// below M) or dA in f32. Items f32x4, over `n` threads from `first`.
template <int R, bool DA>
__device__ __forceinline__ void fold(const Args& a, uint32_t slot, int out, int rank, int cs, int first, int n) {
  constexpr int PST = part_stride(R);
  const int r0 = CH * rank / cs, r1 = CH * (rank + 1) / cs;
  for (int e = first; e < (r1 - r0) * (R / 4); e += n) {
    const int row = r0 + e / (R / 4), q = (e % (R / 4)) * 4;
    const uint32_t off = slot + (row * PST + q) * 4;
    float4 v = ld_cluster_f4(map_rank(off, 0));
    for (int src = 1; src < cs; src += 8) {
      float4 w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (src + i < cs) w[i] = ld_cluster_f4(map_rank(off, src + i));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (src + i < cs) {
          v.x += w[i].x;
          v.y += w[i].y;
          v.z += w[i].z;
          v.w += w[i].w;
        }
      }
    }
    const int orow = out * CH + row;
    if constexpr (DA) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + static_cast<size_t>(orow) * R + q) = v;
    } else if (orow < a.M) {
      uint2 o;
      o.x = pack_bf16(v.x, v.y);
      o.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + static_cast<size_t>(orow) * R + q) = o;
    }
  }
}

// The producer warp: the block's resident chunks (if resident), then per
// output tile li its share of reduced chunks, stage by stage: x's tile,
// A's or dmid's chunk (if not resident) and the mask's u8 tile (bits mode).
// It takes part in the cluster's barrier a tile behind, as the consumers
// arrive once their partials of a tile are written.
template <int R, bool DA>
__device__ __forceinline__ void produce(const Args& a, const CUtensorMap* tm_x, const CUtensorMap* tm_p,
                                        const CUtensorMap* tm_bits, const Layout& L, uint32_t base,
                                        int out0, int nout, int G, int red0, int share) {
  constexpr int NST = stages(R);
  const int lane = threadIdx.x & 31;
  const uint32_t full = base + L.bar, empty = full + 8 * NST, pfull = empty + 8 * NST;
  const int p_rows = DA ? a.M : a.K;
  const uint32_t tx = TILE_BYTES + (a.resident ? 0 : p_slot(R)) + (a.bits ? BITS_BYTES : 0);
  uint64_t policy = 0;
  if (a.tma && lane == 0) policy = evict_first_policy();

  // A chunk of A / dmid (64 rows from row `row`) into slot address `dst`.
  auto load_p = [&](uint32_t dst, int row, uint32_t bar) {
    if (a.tma) {
#pragma unroll
      for (int h = 0; h < (R >= 64 ? R / 64 : 1); ++h) tma_load_2d(dst + h * CH * 128, tm_p, h * 64, row, bar);
    } else {
      for (int q = lane; q < CH * R / 8; q += 32) {
        const int rr = q / (R / 8), c = (q % (R / 8)) * 8;
        st_shared16(dst + zoff<R>(rr, c), load8(a.p, p_rows, R, row + rr, c, a.vec_p));
      }
    }
  };

  if (a.resident) {
    if (a.tma) {
      if (lane == 0) {
        mbar_expect_tx(pfull, share * p_slot(R));
        for (int j = 0; j < share; ++j) load_p(base + L.p + j * p_slot(R), (red0 + j) * CH, pfull);
      }
    } else {
      for (int j = 0; j < share; ++j) load_p(base + L.p + j * p_slot(R), (red0 + j) * CH, pfull);
      mbar_arrive(pfull);
    }
  }
  for (int li = 0; li < nout; ++li) {
    const int out = out0 + li * G;
    // Every lane: in TMA mode lane 0 issues the copies, and all write the keys.
    for (int jj = 0; jj < share; ++jj) {
      const int t = li * share + jj, st = t % NST, red = red0 + jj;
      if (t >= NST) mbar_wait(empty + 8 * st, ((t / NST) - 1) & 1);
      const int col = (DA ? out : red) * CH, row = (DA ? red : out) * CH;
      const uint32_t xs = base + L.x + st * TILE_BYTES, bs = base + L.bits + st * BITS_BYTES;
      const uint32_t ps = base + L.p + st * p_slot(R);
      if (a.tma && lane == 0) {
        mbar_expect_tx(full + 8 * st, tx);
        tma_load_2d_hint(xs, tm_x, col, row, full + 8 * st, policy);
        if (!a.resident) load_p(ps, red * CH, full + 8 * st);
        if (a.bits) tma_load_2d_hint(bs, tm_bits, col, row, full + 8 * st, policy);
      }
      // dA in hash mode: the row keys of the tile's 64 rows, two a lane,
      // which the consumers would otherwise hash again in every warp.
      if (DA && a.bits == nullptr) {
        const uint32_t keys = base + L.keys + st * KEYS_BYTES;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = lane + 32 * h;
          asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(keys + 4 * rr), "r"(row_key(a.seed, a.row0 + row + rr))
                       : "memory");
        }
      }
      if (a.tma) {
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * st);   // the keys are written
      } else {
        for (int u0 = 0; u0 < 16; u0 += 4) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = lane + 32 * (u0 + u);
            v[u] = load8(a.x, a.M, a.K, row + (q >> 3), col + (q & 7) * 8, a.vec_x);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = lane + 32 * (u0 + u);
            st_shared16(xs + sw128(q >> 3, (q & 7) * 8), v[u]);
          }
        }
        if (!a.resident) load_p(ps, red * CH, 0);
        if (a.bits) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int q = lane + 32 * u;
            st_shared16(bs + (q >> 2) * 64 + (q & 3) * 16,
                        load16_u8(a.bits, a.M, a.K, row + (q >> 2), col + (q & 3) * 16, a.vec_bits));
          }
        }
        mbar_arrive(full + 8 * st);
      }
    }
    // The warp meets the cluster's barrier together, one tile behind its
    // loads, so that it never waits on the consumers' last tile: phase li -
    // 1 (the consumers' partials of tile li - 1) is passed once tile li's
    // loads are issued.
    __syncwarp();
    if (li >= 2) cluster_wait();
    if (li >= 1) cluster_arrive();
  }
  if (nout >= 2) cluster_wait();
  cluster_arrive();
  cluster_wait();
}

// The forward (DA false) and dA (DA true): grid (cs, G) in clusters of cs
// blocks, threads(R) threads, layout_of(R, p_slots, bits).bytes of shared
// memory with p_slots = ceil(n_red / cs) if resident, else stages(R).
template <int R, bool DA>
__device__ __forceinline__ void reduce(const CUtensorMap* tm_x, const CUtensorMap* tm_p,
                                       const CUtensorMap* tm_bits, const Args& a) {
  constexpr int NST = stages(R);
  constexpr int PST = part_stride(R);
  constexpr int GROUPS = groups(R);
  constexpr int CONSUMERS = consumers(R);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int n_out = DA ? a.K / CH : (a.M + CH - 1) / CH;
  const int n_red = DA ? (a.M + CH - 1) / CH : a.K / CH;
  const int cs = gridDim.x, G = gridDim.y, rank = blockIdx.x, cl = blockIdx.y;
  const int out0 = cl, nout = (n_out - cl + G - 1) / G;     // output tiles cl, cl + G, ...
  const int red0 = static_cast<int>(static_cast<long long>(n_red) * rank / cs);
  const int share = static_cast<int>(static_cast<long long>(n_red) * (rank + 1) / cs) - red0;
  const Layout L = layout_of(R, a.resident ? (n_red + cs - 1) / cs : NST, a.bits != nullptr);
  const uint32_t full = base + L.bar, empty = full + 8 * NST, pfull = empty + 8 * NST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    const uint32_t arrivals = a.tma ? 1 : 32;     // the TMA thread, or every producer lane
    for (int i = 0; i < NST; ++i) {
      mbar_init(full + 8 * i, a.tma ? 2 : 32);    // the TMA thread's copies, then its arrival once the
                                                  // keys are written; or every producer lane
      mbar_init(empty + 8 * i, 4);                // lane 0 of each warp of the tile's group
    }
    mbar_init(pfull, arrivals);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    produce<R, DA>(a, tm_x, tm_p, tm_bits, L, base, out0, nout, G, red0, share);
    cluster_arrive();
    cluster_wait();
    return;
  }

  // ---- consumer warps: group grp = warp >> 2 takes tiles t = grp, grp +
  // GROUPS, ...; warp wr = warp & 3 of it the tile's rows (forward) or
  // columns (dA) 16 wr .. + 15, all four k-steps ----
  const int grp = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3, mr = lane & 7;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(a.scale);   // exact where s is a bf16 value
  const bool s_bf16 = __low2float(s2) == a.scale;           // else the f32 form (see the head)
  const uint32_t kthr = static_cast<uint32_t>(0x8000 - a.thr) * 0x10001u;
  const bool hash = a.bits == nullptr;
  const bool odd = t4 & 1;
  // Forward: a register's two mask bytes are bytes 2 (t4 & 1) and + 1 of
  // its word, to bits 0-7 and 16-23. dA: byte j = g & 3 of its two words.
  const uint32_t fwd_sel = odd ? 0x4342u : 0x4140u;
  const int j = g & 3, gh = g >> 2;
  const uint32_t da_sel = static_cast<uint32_t>(j | ((j + 4) << 8));
  if (a.resident) mbar_wait(pfull, 0);
  for (int li = 0; li < nout; ++li) {
    const int out = out0 + li * G;
    float acc[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    // Forward: the row key of tile row wr * 16 + g + 8 (t4 & 1), whose words
    // this lane hashes for itself and its partner lane t4 ^ 1 (the same
    // words, the other row's of the two it needs).
    const uint32_t key = (!DA && hash) ? row_key(a.seed, a.row0 + out * CH + wr * 16 + g + 8 * odd) : 0u;
    for (int jj = ((grp - li * share) % GROUPS + GROUPS) % GROUPS; jj < share; jj += GROUPS) {
      const int t = li * share + jj, st = t % NST, red = red0 + jj;
      mbar_wait(full + 8 * st, (t / NST) & 1);
      const uint32_t xs = base + L.x + st * TILE_BYTES, bs = base + L.bits + st * BITS_BYTES;
      const uint32_t pc = base + L.p + (a.resident ? jj : st) * p_slot(R);
#pragma unroll
      for (int ks = 0; ks < CH / 16; ++ks) {
        uint32_t xa[4];
        if constexpr (!DA) {
          // acc (16 rows x R) += masked x (16 x 16) A rows (16 x R). Register
          // i: row g + 8 (i & 1), columns c, c + 1 with c = 16 ks + 8 (i >>
          // 1) + 2 t4, one mask word (that of lanes t4 and t4 ^ 1).
          ldsm_x4(xa, xs + sw128(wr * 16 + (mat & 1) * 8 + mr, ks * 16 + (mat >> 1) * 8));
#ifndef LORA_DROPOUT_PROBE_NO_MASK
          uint32_t w[4];
          if (hash) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t mine = mask_word(key, a.col0 + red * CH + ks * 16 + 8 * h + 2 * t4);
              const uint32_t other = __shfl_xor_sync(FULL_MASK, mine, 1);
              w[2 * h] = odd ? other : mine;          // row g
              w[2 * h + 1] = odd ? mine : other;      // row g + 8
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              w[i] = lds32(bs + (wr * 16 + g + 8 * (i & 1)) * 64 + ((ks * 16 + 8 * (i >> 1) + 2 * t4) & ~3));
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t kp = keep_pair(prmt(w[i], 0u, fwd_sel), kthr);
            xa[i] = s_bf16 ? drop_pair(xa[i], kp, s2) : drop_pair_f32(xa[i], kp, a.scale);
          }
#endif
        } else {
          // acc (16 columns of K x R) += masked x^T (16 x 16) dmid rows (16
          // x R). Register i holds x rows 16 ks + 2 t4 + 8 (i >> 1) and + 1
          // of column g + 8 (i & 1): byte j = g & 3 of words gh + 2 (i & 1)
          // (gh = g >> 2) of the warp's 16 columns. The four lanes of one
          // (gh, t4) need the same 8 words (4 rows, 2 words): lane j hashes
          // row j's two, and the others take them by shuffle.
          ldsm_x4_t(xa, xs + sw128(ks * 16 + (mat >> 1) * 8 + mr, wr * 16 + (mat & 1) * 8));
#ifndef LORA_DROPOUT_PROBE_NO_MASK
          const int row = 16 * ks + 2 * t4 + (j & 1) + 8 * (j >> 1);
          const uint32_t k = hash ? lds32(base + L.keys + st * KEYS_BYTES + 4 * row) : 0u;
          uint32_t mine[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = wr * 16 + 4 * gh + 8 * u;
            mine[u] = hash ? mask_word(k, a.col0 + out * CH + c) : lds32(bs + row * 64 + c);
          }
          uint32_t w[8];                      // [2 s + u]: row s of (2 t4, + 1, + 8, + 9), word u
#pragma unroll
          for (int q = 0; q < 8; ++q) w[q] = __shfl_sync(FULL_MASK, mine[q & 1], gh * 16 + (q >> 1) * 4 + t4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = 4 * (i >> 1) + (i & 1);     // rows 2 t4 (+ 8), word i & 1; the next row at q + 2
            const uint32_t kp = keep_pair(prmt(w[q], w[q + 2], da_sel) & 0x00FF00FFu, kthr);
            xa[i] = s_bf16 ? drop_pair(xa[i], kp, s2) : drop_pair_f32(xa[i], kp, a.scale);
          }
#endif
        }
#pragma unroll
        for (int np = 0; np < R / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, pc + zoff<R>(ks * 16 + (mat & 1) * 8 + mr, np * 16 + (mat >> 1) * 8));
          mma_bf16(acc[2 * np], xa, bb[0], bb[1]);
          mma_bf16(acc[2 * np + 1], xa, bb[2], bb[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    // The group's partial: element (i of n) of the accumulator is tile row
    // (forward) or column (dA) wr * 16 + g + 8 (i >> 1), rank 8 n + 2 t4 +
    // (i & 1). The groups' partials are summed in group order into the
    // block's (slot li % 3), and the cluster's barrier is passed with the
    // fold of the previous tile deferred to here: a block waits only for a
    // phase the others left a tile ago.
    float* gp = reinterpret_cast<float*>(smem_raw + (base + L.gpart - raw)) + grp * CH * PST;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        *reinterpret_cast<float2*>(gp + (wr * 16 + g + 8 * e2) * PST + n * 8 + 2 * t4) =
            make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]);
      }
    }
    consumers_sync<CONSUMERS>();
    sum_groups<R, GROUPS>(reinterpret_cast<const float*>(smem_raw + (base + L.gpart - raw)),
                          reinterpret_cast<float*>(smem_raw + (base + L.part - raw)) + (li % PART_SLOTS) * CH * PST,
                          tid, CONSUMERS);
    consumers_sync<CONSUMERS>();          // the groups' partials are free again
    if (li > 0) {
      cluster_wait();
      fold<R, DA>(a, base + L.part + ((li - 1) % PART_SLOTS) * part_bytes(R), out - G, rank, cs, tid, CONSUMERS);
    }
    cluster_arrive();
  }
  cluster_wait();
  fold<R, DA>(a, base + L.part + ((nout - 1) % PART_SLOTS) * part_bytes(R), out0 + (nout - 1) * G, rank, cs, tid,
              CONSUMERS);
  // No block leaves while another may still read its partials.
  cluster_arrive();
  cluster_wait();
}

template <int R>
__global__ void __launch_bounds__(threads(R), 1)
lora_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,      // x (M, K), 64 x 64 boxes
                const __grid_constant__ CUtensorMap tm_p,      // A (K, R), 64 x min(R, 64) boxes
                const __grid_constant__ CUtensorMap tm_bits,   // bits (M, K) u8, 64 x 64 boxes
                const Args a) {
  reduce<R, false>(&tm_x, &tm_p, &tm_bits, a);
}

template <int R>
__global__ void __launch_bounds__(threads(R), 1)
lora_da_kernel(const __grid_constant__ CUtensorMap tm_x,       // x (M, K), 64 x 64 boxes
               const __grid_constant__ CUtensorMap tm_p,       // dmid (M, R), 64 x min(R, 64) boxes
               const __grid_constant__ CUtensorMap tm_bits,    // bits (M, K) u8, 64 x 64 boxes
               const Args a) {
  reduce<R, true>(&tm_x, &tm_p, &tm_bits, a);
}

// Keep bits (bit e for element e) of 8 neighbouring elements at (row, col),
// col a multiple of 8.
__device__ __forceinline__ uint32_t keep8(const uint8_t* bits, uint32_t seed, int row0, int col0,
                                         int thr, int row, int col, int K) {
  uint32_t b[2];
  if (bits != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(bits + static_cast<size_t>(row) * K + col);
    b[0] = raw.x;
    b[1] = raw.y;
  } else {
    const uint32_t key = row_key(seed, row0 + row);
    b[0] = mask_word(key, col0 + col);
    b[1] = mask_word(key, col0 + col + 4);
  }
  uint32_t keep = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    keep |= static_cast<uint32_t>(static_cast<int>((b[e >> 2] >> (8 * (e & 3))) & 0xFFu) >= thr) << e;
  }
  return keep;
}

// dx: grid (ceil(M/16), ceil(K/256)); warp w owns 16 rows x 64 columns.
// Logical column (n-tile nt, c) of the product is physical column
// 16*(c >> 1) + 2*nt + (c & 1) of the warp's 64, so thread t's outputs are
// columns 16t .. 16t + 15 of each of its two rows.
template <int R>
__global__ void __launch_bounds__(NTHREADS)
lora_dx_kernel(const __nv_bfloat16* __restrict__ dmid, const __nv_bfloat16* __restrict__ a,
               const uint8_t* __restrict__ bits, __nv_bfloat16* __restrict__ dx,
               int M, int K, uint32_t seed, int row0, int col0, int thr, float inv_keep) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 16;
  const int k0 = (blockIdx.y * 4 + warp) * CH;
  if (k0 >= K) return;

  // dmid's A fragments for the R/16 k-steps over the rank.
  uint32_t da[R / 16][4];
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + 8 * (e & 1);
      const int col = kk * 16 + 2 * t + 8 * (e >> 1);
      da[kk][e] = row < M ? *reinterpret_cast<const uint32_t*>(dmid + static_cast<size_t>(row) * R + col)
                          : 0u;
    }
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const int bcol = k0 + 16 * (g >> 1) + (g & 1);     // physical column of B's column g, nt = 0
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const __nv_bfloat16* arow = a + static_cast<size_t>(bcol + 2 * nt) * R;
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(arow + kk * 16 + 2 * t);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(arow + kk * 16 + 8 + 2 * t);
      mma_bf16(acc[nt], da[kk], b0, b1);
    }
  }
  // Thread (g, t): rows g and g + 8, columns k0 + 16t + 2nt + {0, 1}.
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = m0 + g + 8 * e2;
    if (row >= M) continue;
    const int col = k0 + 16 * t;
    const uint32_t keep = keep8(bits, seed, row0, col0, thr, row, col, K)
                          | (keep8(bits, seed, row0, col0, thr, row, col + 8, K) << 8);
    uint32_t w[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float lo = ((keep >> (2 * nt)) & 1u) ? acc[nt][2 * e2] * inv_keep : 0.0f;
      const float hi = ((keep >> (2 * nt + 1)) & 1u) ? acc[nt][2 * e2 + 1] * inv_keep : 0.0f;
      w[nt] = pack_bf16(lo, hi);
    }
    uint4* dst = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * K + col);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Tensor-map encoding failures come back as this plus the CUresult.
constexpr int ENCODE_ERROR = 100000;

// Tensor map of a row-major (rows, cols) matrix of `type` (elem_bytes
// each): boxes of box_cols x box_rows, zero-filled past the edges.
CUresult encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr, int cols,
                   int rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The device the caller made current (below 64), with its context bound to
// this thread: cuTensorMapEncodeTiled needs it, and PyTorch's autograd
// threads may not have bound it yet (cudaFree(0) binds it).
cudaError_t current_device(int* device) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device >= 64) return cudaErrorInvalidDevice;
  CUcontext ctx = nullptr;
  if (cuCtxGetCurrent(&ctx) != CUDA_SUCCESS || ctx == nullptr) return cudaFree(nullptr);
  return cudaSuccess;
}

template <int R, bool DA>
void* reduce_kernel() {
  return DA ? reinterpret_cast<void*>(lora_da_kernel<R>) : reinterpret_cast<void*>(lora_fwd_kernel<R>);
}

// One launch of the forward (DA false: p = A, out = mid) or dA (p = dmid,
// out = dA) on a grid of `clusters` clusters of cs blocks.
template <int R, bool DA>
int reduce_run(const void* x, const void* p, const void* bits, void* out, int M, int K, int cs,
               int clusters, bool resident, uint32_t seed, int row0, int col0, int thr, float scale,
               cudaStream_t stream) {
  static bool ready[64] = {};        // the kernel's shared-memory limit raised on this device
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* kernel = reduce_kernel<R, DA>();
  if (!ready[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const int n_out = DA ? K / CH : (M + CH - 1) / CH;
  const int n_red = DA ? (M + CH - 1) / CH : K / CH;
  if (M <= 0 || K <= 0 || K % CH || !(cs == 1 || cs == 2 || cs == 4 || cs == 8) || cs > n_red ||
      clusters < 1 || clusters > n_out || clusters > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = layout_of(R, resident ? (n_red + cs - 1) / cs : stages(R), bits != nullptr);
  if (L.bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = aligned16(x) && aligned16(p) && (bits == nullptr || aligned16(bits));
  CUtensorMap tx, tp, tb;
  memset(&tx, 0, sizeof(tx));
  memset(&tp, 0, sizeof(tp));
  memset(&tb, 0, sizeof(tb));
  if (tma) {
    CUresult e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, CH, CH, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == CUDA_SUCCESS) {
      e = encode_2d(&tp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, R, DA ? M : K, R >= 64 ? 64 : R, CH,
                    R == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                    : R == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (e == CUDA_SUCCESS && bits != nullptr) {
      e = encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bits, K, M, CH, CH, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    if (e != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(e);
  }
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.p = static_cast<const __nv_bfloat16*>(p);
  a.bits = static_cast<const uint8_t*>(bits);
  a.out = out;
  a.M = M;
  a.K = K;
  a.seed = seed;
  a.row0 = row0;
  a.col0 = col0;
  a.thr = thr;
  a.scale = scale;
  a.resident = resident;
  a.tma = tma;
  a.vec_x = aligned16(x);
  a.vec_p = aligned16(p);
  a.vec_bits = bits != nullptr && aligned16(bits);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, clusters);
  cfg.blockDim = dim3(threads(R));
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (DA) {
    err = cudaLaunchKernelEx(&cfg, lora_da_kernel<R>, tx, tp, tb, a);
  } else {
    err = cudaLaunchKernelEx(&cfg, lora_fwd_kernel<R>, tx, tp, tb, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool DA>
int reduce_dispatch(const void* x, const void* p, const void* bits, void* out, int M, int K, int R, int cs,
                    int clusters, int resident, uint32_t seed, int row0, int col0, int thr, float scale,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 16: return reduce_run<16, DA>(x, p, bits, out, M, K, cs, clusters, resident, seed, row0, col0, thr, scale, st);
    case 32: return reduce_run<32, DA>(x, p, bits, out, M, K, cs, clusters, resident, seed, row0, col0, thr, scale, st);
    case 64: return reduce_run<64, DA>(x, p, bits, out, M, K, cs, clusters, resident, seed, row0, col0, thr, scale, st);
    case 128: return reduce_run<128, DA>(x, p, bits, out, M, K, cs, clusters, resident, seed, row0, col0, thr, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int R>
struct DxLaunch {
  static int run(const void* dmid, const void* a, const void* bits, void* dx, int M, int K,
                 uint32_t seed, int row0, int col0, int thr, float inv_keep, cudaStream_t stream) {
    const dim3 grid((M + 15) / 16, (K + 4 * CH - 1) / (4 * CH));
    lora_dx_kernel<R><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(dmid), static_cast<const __nv_bfloat16*>(a),
        static_cast<const uint8_t*>(bits), static_cast<__nv_bfloat16*>(dx), M, K, seed, row0, col0, thr,
        inv_keep);
    return static_cast<int>(cudaGetLastError());
  }
};

// Philox4x32-10 (curand_philox4x32_x.h): ten rounds, the key bumped
// between them.
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr int KEEP_BLOCK = 256;                 // PyTorch's block for its draws

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = PHILOX_M0 * c.x, hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo1 = PHILOX_M1 * c.z, hi1 = __umulhi(PHILOX_M1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c;
}

// curand's uniform of a word below keep, or 1 (folded to 0): see the head.
__device__ __forceinline__ uint8_t keep_byte(uint32_t word, uint32_t lo, uint32_t hi) {
  return (word < lo) | (word >= hi);
}

__global__ void __launch_bounds__(KEEP_BLOCK)
lora_keep_kernel(uint8_t* __restrict__ out, int numel, uint32_t k0, uint32_t k1, uint32_t lo, uint32_t hi) {
  const int t = blockIdx.x * KEEP_BLOCK + threadIdx.x;
  const int T = gridDim.x * KEEP_BLOCK;
  uint4 ctr = make_uint4(0u, 0u, static_cast<uint32_t>(t), 0u);
  for (int e = t; e < numel; e += 4 * T, ++ctr.x) {
    const uint4 w = philox4x32_10(ctr, k0, k1);
    out[e] = keep_byte(w.x, lo, hi);
    if (e + T < numel) out[e + T] = keep_byte(w.y, lo, hi);
    if (e + 2 * T < numel) out[e + 2 * T] = keep_byte(w.z, lo, hi);
    if (e + 3 * T < numel) out[e + 3 * T] = keep_byte(w.w, lo, hi);
  }
}

}  // namespace

// Plain-C launchers (bound with ctypes): the caller's current device and
// stream, contiguous row-major tensors, K a multiple of 64, R in {16, 32,
// 64, 128}, bits null for the hash (of global rows row0 + row and columns
// col0 + col). The forward and dA take their grid from
// ops/lora_fused.py:_fwd_plan / _da_plan: `clusters` clusters of cs blocks,
// `resident` (the block's chunks of A or dmid kept in shared memory). Each
// returns cudaGetLastError() after its launch (cudaErrorInvalidValue, before
// any launch, for a shape or plan it does not take).
extern "C" int lora_fwd_launch(const void* x, const void* a, const void* bits, void* mid, int M, int K,
                               int R, int cs, int clusters, int resident, uint32_t seed, int row0,
                               int col0, int thr, float scale, void* stream) {
  return reduce_dispatch<false>(x, a, bits, mid, M, K, R, cs, clusters, resident, seed, row0, col0, thr,
                                scale, stream);
}

extern "C" int lora_da_launch(const void* x, const void* dmid, const void* bits, void* da, int M, int K,
                              int R, int cs, int clusters, int resident, uint32_t seed, int row0, int col0,
                              int thr, float scale, void* stream) {
  return reduce_dispatch<true>(x, dmid, bits, da, M, K, R, cs, clusters, resident, seed, row0, col0, thr,
                               scale, stream);
}

extern "C" int lora_dx_launch(const void* dmid, const void* a, const void* bits, void* dx,
                              int M, int K, int R, uint32_t seed, int row0, int col0, int thr,
                              float inv_keep, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 16: return DxLaunch<16>::run(dmid, a, bits, dx, M, K, seed, row0, col0, thr, inv_keep, st);
    case 32: return DxLaunch<32>::run(dmid, a, bits, dx, M, K, seed, row0, col0, thr, inv_keep, st);
    case 64: return DxLaunch<64>::run(dmid, a, bits, dx, M, K, seed, row0, col0, thr, inv_keep, st);
    case 128: return DxLaunch<128>::run(dmid, a, bits, dx, M, K, seed, row0, col0, thr, inv_keep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of cs blocks of the forward (da 0) or dA (da 1) kernel at
// rank R with `smem` bytes of shared memory a block that the current device
// holds at once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int lora_cluster_capacity(int da, int R, int cs, int smem, int* clusters) {
  void* kernel = nullptr;
  switch (R) {
    case 16: kernel = da ? reduce_kernel<16, true>() : reduce_kernel<16, false>(); break;
    case 32: kernel = da ? reduce_kernel<32, true>() : reduce_kernel<32, false>(); break;
    case 64: kernel = da ? reduce_kernel<64, true>() : reduce_kernel<64, false>(); break;
    case 128: kernel = da ? reduce_kernel<128, true>() : reduce_kernel<128, false>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(threads(R));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// The 32-bit rule's keep bytes (see the head): `numel` (< 2^29) bytes into
// `out` on `blocks` blocks of 256 (PyTorch's grid for numel on the current
// device), the Philox key from the 64-bit seed, keep iff a word is below
// `lo` or at least `hi`.
extern "C" int lora_keep_launch(void* out, int numel, uint64_t seed, uint32_t lo, uint32_t hi, int blocks,
                                void* stream) {
  if (numel <= 0 || numel >= (1 << 29) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  lora_keep_kernel<<<blocks, KEEP_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), numel, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), lo, hi);
  return static_cast<int>(cudaGetLastError());
}
