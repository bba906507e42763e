// Fused LoRA rank-r epilogue for Hopper (sm_90a): the forward, and one
// backward kernel that reads dy once for dz and dB.
//
// Replaces phantom_vlb_tpu/ops/lora_epilogue.py:_fwd_kernel (line 45),
// _dz_kernel (:51) and _db_kernel (:69), reached through lora_epilogue
// (:96):
//   out = bf16(y + bf16(bf16(z @ B) * s))   f32 sums, the reference's roundings
//   dz  = bf16(s * (dy @ B^T))              f32 sums, one rounding
//   dB  = bf16(s * (z^T @ dy))              f32 sums, one rounding
// with y, dy (M, N) bf16, z (M, r) bf16, B (r, N) bf16, r <= 128, s the
// LoRA scaling (rounded to bf16 by the caller for the forward, f32 in the
// backward, as the reference multiplies). d(y) = dy passes through in the
// caller. The TPU's rank padding to 128 lanes is not copied: the rank is
// padded in shared memory and registers to R, the next of 16, 32, 64, 128,
// and M and N tails are masked (zero-filled) in the loads and stores.
//
// Forward (epi_fwd_kernel<R>): bound by bytes. y is read once and out
// written once, z and B read once: (2 M N + r (M + N)) * 2 bytes, 7.6 /
// 30.1 / 105.4 us at M = 6144, r = 16, N = 1024 / 4096 / 14336 (3.35
// TB/s). The rank product, 2 M N r flops (0.8 GFLOP at N = 4096), is under
// 1 us on the tensor cores, so the design is about streaming y through:
// - Persistent blocks that own column strips: y's 64 x 64 tiles are cut
//   into mb row groups x nb column groups within one wave of the card's
//   blocks (ops/lora_epilogue.py:_fwd_grid). A block loads its strip of B
//   (R x 64 per column chunk, at most FWD_CPB chunks) into shared memory
//   once and walks its row group's tiles. At M = 6144, r = 16 the grid is
//   mb x nb = 32 x 4 (N = 1024), 16 x 8 (4096) and 8 x 14 (14336).
// - The backward's producer warp (produce, below) keeps a ring of 8 y
//   tiles and a ring of z chunks in flight by TMA with mbarriers; y is
//   loaded with an L2 evict-first policy (it is read once).
// - Two groups of four consumer warps take the tiles in turn, 16 rows of a
//   tile a warp, so that one group's products and stores overlap the
//   other's (in bring-up one group was slower, and more stages were no
//   faster). A warp's z rows are its mma.sync A fragments (ldmatrix, once
//   a row chunk); acc = z B by ldmatrix.trans of the B chunk and
//   mma.sync.m16n8k16, f32 sums. Then
//   bf16(acc), times s and plus y in bf16x2 arithmetic, each correctly
//   rounded: a product or sum of two bf16 values rounded in f32 and then
//   to bf16 rounds as if once (f32 has more than 2 * 8 + 2 bits), so these
//   are the reference's roundings. The result goes over y in its slot, and
//   a TMA store of the warp's 16 rows leaves while the warp takes the next
//   tile; the slot is freed once the store has read it.
// - Where a stride or base does not allow TMA, the producer warp loads the
//   same tiles with plain 16-byte loads (as for the backward), and where
//   out's does not, each thread writes its elements.
//
// Backward (epi_dzdb_kernel<R, DZ, DB>): dz and dB from one pass over dy;
// the entry points for dz alone and dB alone are the same kernel with the
// other output compiled out. Bound by bytes: dy read once, z and B read
// once, dz and dB written once, (M N + 2 r (M + N)) * 2 bytes = 51.0 MB at
// M = 6144, N = 4096, r = 16 (15.2 us at 3.35 TB/s; 53.0 us at N = 14336).
// The tensor-core work, 4 M N r flops (1.6 GFLOP), is ~2 us even on
// mma.sync, so the design is about moving dy once, at the rate HBM gives:
// - Blocks: dy's 64 x 64 tiles are cut into mb row groups x nb column
//   groups (ops/lora_epilogue.py:_grid, within one wave of the card's
//   blocks), and a block walks its group pair's tiles row chunk by row
//   chunk. Its dB^T sums for each of its column chunks stay in registers
//   across the walk (at most 16 column chunks at R = 16: 128 registers a
//   thread), its dz sums for a row chunk until the row chunk ends. At
//   M = 6144, r = 16 the fused grid is mb x nb = 24 x 4 (N = 1024),
//   16 x 8 (4096) and 8 x 14 (14336).
// - Pipeline: one producer warp keeps a ring of 8 dy tiles (8 KB each,
//   128B-swizzled) in flight by TMA with mbarriers, with the block's B
//   chunks resident and a ring of z chunks beside it; dy is loaded with an
//   L2 evict-first policy (it is read once), which keeps the partials in L2
//   for the fold. Four consumer warps multiply each tile twice from the
//   same shared copy: ldmatrix + mma.sync.m16n8k16 against the B chunk for
//   dz (16 rows a warp) and ldmatrix.trans against the z chunk for dB^T (16
//   columns a warp); the swizzle XOR goes into the ldmatrix addresses.
//   mma.sync and not wgmma: the products are 64 x R x 64 with R = 16 on the
//   path, and their time hides behind the loads either way.
// - Where a stride or base does not allow TMA (N % 8 != 0, r != R, or a
//   base not 16-byte aligned), the producer warp loads the same tiles with
//   plain 16-byte loads (zeros past the edges) into the same layout.
// - Reduction in the same launch: each block writes f32 partials, its dz
//   rows x R (pdz[nb][M][R]) and its dB^T columns x R (rank-major,
//   pdb[mb][R][N_pad]), 4 R (M nb + N_pad mb) bytes in all (7.3 MB at N =
//   4096, r = 16, against dy's 50.3 MB). The launch is cooperative (every
//   block resident at once): after a grid-wide barrier (an arrival count
//   its last arrival resets, and a generation word) every thread of every
//   block sums some of the outputs' partials in partial order, scales by s,
//   rounds once and writes dz (M, r) and dB (r, N). A grid larger than one
//   wave (only where N needs more column groups than the card holds
//   blocks: N > 132 * 64 columns at r = 128, twice that at r = 64) is
//   launched plainly instead: the last block of a row group (column
//   group), found by an arrival count per group that the last block
//   resets, sums that group's dz rows (dB columns) alone. In bring-up that
//   last-block fold, used for every grid, was slower than the whole pass
//   over dy at N = 4096: one SM's reads are latency-bound. The counts live
//   in one int32 buffer per (device, stream) that the wrapper zeroes once;
//   every launch leaves them at zero. No atomics touch a sum, and every sum
//   has a fixed order: results repeat bit for bit.
// Against the two kernels and two finalize launches it replaces: dy is read
// once and not twice, there is one launch and no finalize, the ring keeps
// 64 KB a block in flight where a register prefetch kept 8 KB, and the
// finalize's strided reads are gone (the fold reads its partials coalesced).
// Cost probe: built with EPI_DZDB_PROBE_NO_FOLD the fold is left out (wrong
// on purpose); chip_smoke.py phase 11 times it against the kernel, which
// says what the fold costs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 64;                 // tile edge (rows and columns)

// 8 bf16 at (row, col .. col + 7) of a row-major matrix with leading
// dimension ld, zeros outside (rows, cols). `vec`: ld % 8 == 0 and an
// aligned base, so a piece that lies wholly inside is one 16-byte load.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ g, int rows, int cols,
                                       int ld, int row, int col, bool vec) {
  if (row >= rows || col >= cols) return make_uint4(0, 0, 0, 0);
  const __nv_bfloat16* p = g + static_cast<size_t>(row) * ld + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = col + 2 * i < cols ? e[2 * i] : 0u;
    const uint32_t hi = col + 2 * i + 1 < cols ? e[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int NST = 8;                          // y / dy tiles in flight a block
constexpr int CONSUMERS = 128;                  // four warps multiply
constexpr int THREADS = CONSUMERS + 32;         // and one warp loads
constexpr uint32_t TILE_BYTES = CH * CH * 2;    // a 64 x 64 bf16 tile, 128-byte rows
// The forward's consumers: FWD_GROUPS groups of four warps take turns at the
// tiles, so that one group's loads, products and stores overlap another's.
constexpr int FWD_GROUPS = 2;
constexpr int FWD_CONSUMERS = FWD_GROUPS * CONSUMERS;
constexpr int FWD_THREADS = FWD_CONSUMERS + 32;

// By padded rank R: the column chunks a block of the backward may own (its
// dB^T sums stay in registers, CPB * R / 2 a thread; ops/lora_epilogue.py
// CHUNKS_PER_BLOCK) and of the forward (its B strip, at most 64 KB;
// FWD_CHUNKS_PER_BLOCK), the z slots in flight, and the bytes of a B chunk
// (R ranks x 64 columns) and a z chunk (64 rows x R ranks).
template <int R>
struct Rank {
  static constexpr int CPB = R == 16 ? 16 : R == 32 ? 8 : R == 64 ? 2 : 1;
  static constexpr int FWD_CPB = 512 / R;
  static constexpr int ZST = R == 128 ? 4 : NST;
  static constexpr uint32_t B_SLOT = R * 128;
  static constexpr uint32_t Z_SLOT = CH * R * 2;
};

// Shared memory of epi_dzdb_kernel, bytes from a 1024-aligned base (every
// slot is a multiple of 1024 bytes, as the swizzles want).
template <int R, bool DZ, bool DB>
struct DzdbSmem {
  using K = Rank<R>;
  static constexpr uint32_t DY = 0;                                   // [NST] dy tiles
  static constexpr uint32_t B = DY + NST * TILE_BYTES;                // [CPB] B chunks
  static constexpr uint32_t Z = B + (DZ ? K::CPB * K::B_SLOT : 0);    // [ZST] z chunks
  // full[NST], empty[NST], zfull[ZST], zempty[ZST], bfull; then two flags
  static constexpr uint32_t BAR = Z + (DB ? K::ZST * K::Z_SLOT : 0);
  static constexpr uint32_t FLAGS = BAR + 8 * (2 * NST + 2 * K::ZST + 1);
  static constexpr uint32_t BYTES = FLAGS + 8 + 1024;                 // + alignment slack
};

// Shared memory of epi_fwd_kernel, as DzdbSmem; the B strip comes last, its
// size set at launch by the block's column chunks (ops/lora_epilogue.py
// fwd_smem_bytes mirrors this).
template <int R>
struct FwdSmem {
  using K = Rank<R>;
  static constexpr uint32_t Y = 0;                                    // [NST] y tiles
  static constexpr uint32_t Z = Y + NST * TILE_BYTES;                 // [ZST] z chunks
  // full[NST], empty[NST], zfull[ZST], zempty[ZST], bfull
  static constexpr uint32_t BAR = Z + K::ZST * K::Z_SLOT;
  static constexpr uint32_t B = (BAR + 8 * (2 * NST + 2 * K::ZST + 1) + 1023) / 1024 * 1024;
  static constexpr uint32_t bytes(int ncols) { return B + ncols * K::B_SLOT + 1024; }
};

// The row chunks [rb0, rb0 + nrows) and column chunks [cb0, cb0 + ncols) of
// 64 x 64 tiles that block (gj, gi) of an (nb, mb) grid owns.
struct Span {
  int rb0, nrows, cb0, ncols;
};

__device__ __forceinline__ Span span_of(int M, int N, int mb, int nb) {
  const int rc = (M + CH - 1) / CH, cc = (N + CH - 1) / CH;
  const int gj = blockIdx.x, gi = blockIdx.y;
  const int rb0 = static_cast<int>(static_cast<long long>(rc) * gi / mb);
  const int rb1 = static_cast<int>(static_cast<long long>(rc) * (gi + 1) / mb);
  const int cb0 = static_cast<int>(static_cast<long long>(cc) * gj / nb);
  const int cb1 = static_cast<int>(static_cast<long long>(cc) * (gj + 1) / nb);
  return {rb0, rb1 - rb0, cb0, cb1 - cb0};
}

// Shared-memory addresses of a block's rings: NST tiles, ZST z chunks, the B
// chunks, and their mbarriers.
struct Ring {
  uint32_t tiles, zs, bs, full, empty, zfull, zempty, bfull;
};

// The producer warp of both kernels: the block's B chunks once (WANT_B),
// then row chunk by row chunk its z chunk (WANT_Z) and the 64 x 64 tiles
// of x (y or dy) in its column chunks, in the order the consumers take
// them. `tma`: the tensor maps are valid, and lane 0 loads by TMA, x with
// an L2 evict-first policy (it is read once); else every lane loads with
// plain loads into the same swizzled layouts (vec_*: 16-byte loads of that
// tensor are allowed), zeros past the edges.
template <int R, bool WANT_B, bool WANT_Z>
__device__ __forceinline__ void produce(const Ring& q, const CUtensorMap* tm_x, const CUtensorMap* tm_z,
                                        const CUtensorMap* tm_b, const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ z,
                                        const __nv_bfloat16* __restrict__ b, int M, int N, int r,
                                        const Span& sp, bool tma, bool vec_x, bool vec_z, bool vec_b) {
  using K = Rank<R>;
  const int lane = threadIdx.x & 31;
  if (tma) {
    if (lane != 0) return;
    uint64_t x_policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(x_policy));
    if constexpr (WANT_B) {
      mbar_expect_tx(q.bfull, sp.ncols * K::B_SLOT);
      for (int jj = 0; jj < sp.ncols; ++jj) {
        tma_load_2d(q.bs + jj * K::B_SLOT, tm_b, (sp.cb0 + jj) * CH, 0, q.bfull);
      }
    }
    for (int li = 0; li < sp.nrows; ++li) {
      const int row0 = (sp.rb0 + li) * CH;
      if constexpr (WANT_Z) {
        const int zs = li % K::ZST;
        if (li >= K::ZST) mbar_wait(q.zempty + 8 * zs, ((li / K::ZST) - 1) & 1);
        mbar_expect_tx(q.zfull + 8 * zs, K::Z_SLOT);
#pragma unroll
        for (int h = 0; h < (R >= 64 ? R / 64 : 1); ++h) {
          tma_load_2d(q.zs + zs * K::Z_SLOT + h * CH * 128, tm_z, h * 64, row0, q.zfull + 8 * zs);
        }
      }
      for (int jj = 0; jj < sp.ncols; ++jj) {
        const int t = li * sp.ncols + jj, st = t % NST;
        if (t >= NST) mbar_wait(q.empty + 8 * st, ((t / NST) - 1) & 1);
        mbar_expect_tx(q.full + 8 * st, TILE_BYTES);
        tma_load_2d_hint(q.tiles + st * TILE_BYTES, tm_x, (sp.cb0 + jj) * CH, row0, q.full + 8 * st,
                         x_policy);
      }
    }
    return;
  }
  if constexpr (WANT_B) {
    for (int p = lane; p < sp.ncols * R * 8; p += 32) {
      const int jj = p / (R * 8), k = (p % (R * 8)) >> 3, c = (p & 7) * 8;
      st_shared16(q.bs + jj * K::B_SLOT + sw128(k, c), load8(b, r, N, N, k, (sp.cb0 + jj) * CH + c, vec_b));
    }
    mbar_arrive(q.bfull);
  }
  for (int li = 0; li < sp.nrows; ++li) {
    const int row0 = (sp.rb0 + li) * CH;
    if constexpr (WANT_Z) {
      const int zs = li % K::ZST;
      if (li >= K::ZST) mbar_wait(q.zempty + 8 * zs, ((li / K::ZST) - 1) & 1);
      for (int p = lane; p < CH * R / 8; p += 32) {
        const int row = p / (R / 8), c = (p % (R / 8)) * 8;
        st_shared16(q.zs + zs * K::Z_SLOT + zoff<R>(row, c), load8(z, M, r, r, row0 + row, c, vec_z));
      }
      mbar_arrive(q.zfull + 8 * zs);
    }
    for (int jj = 0; jj < sp.ncols; ++jj) {
      const int t = li * sp.ncols + jj, st = t % NST;
      if (t >= NST) mbar_wait(q.empty + 8 * st, ((t / NST) - 1) & 1);
      uint4 v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int p = lane + 32 * u;
        v[u] = load8(x, M, N, N, row0 + (p >> 3), (sp.cb0 + jj) * CH + (p & 7) * 8, vec_x);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int p = lane + 32 * u;
        st_shared16(q.tiles + st * TILE_BYTES + sw128(p >> 3, (p & 7) * 8), v[u]);
      }
      mbar_arrive(q.full + 8 * st);
    }
  }
}

// ---- forward ----

// grid (nb, mb), FWD_THREADS threads, FwdSmem<R>::bytes(column chunks a
// block) bytes. Block (gj, gi) owns span_of's tiles (at most FWD_CPB column
// chunks); consumer group k takes its tiles t = k, k + FWD_GROUPS, ...
// `tma`: tm_y, tm_z and tm_b are valid (else the producer warp loads with
// plain loads, vec_*: 16-byte loads of that tensor allowed);
// `tma_out`: tm_out is valid (boxes of 64 columns x 16 rows), else each
// consumer thread writes its elements of out.
template <int R>
__global__ void __launch_bounds__(FWD_THREADS, 1)
epi_fwd_kernel(const __grid_constant__ CUtensorMap tm_y,      // (M, N), 64 x 64 boxes
               const __grid_constant__ CUtensorMap tm_z,      // (M, r), 64 x min(R, 64) boxes
               const __grid_constant__ CUtensorMap tm_b,      // (r, N), R x 64 boxes
               const __grid_constant__ CUtensorMap tm_out,    // (M, N), 16 x 64 boxes
               const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ z,
               const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int M, int N,
               int r, int mb, int nb, float s, bool tma, bool tma_out, bool vec_y, bool vec_z,
               bool vec_b) {
  using K = Rank<R>;
  using L = FwdSmem<R>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR, empty = full + 8 * NST, zfull = empty + 8 * NST,
                 zempty = zfull + 8 * K::ZST, bfull = zempty + 8 * K::ZST;
  const Ring q = {base + L::Y, base + L::Z, base + L::B, full, empty, zfull, zempty, bfull};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Span sp = span_of(M, N, mb, nb);

  if (tid == 0) {
    const uint32_t arrivals = tma ? 1 : 32;     // the TMA thread, or every producer lane
    for (int i = 0; i < NST; ++i) {
      mbar_init(full + 8 * i, arrivals);
      mbar_init(empty + 8 * i, CONSUMERS / 32);  // lane 0 of each warp of the tile's group
    }
    for (int i = 0; i < K::ZST; ++i) {
      mbar_init(zfull + 8 * i, arrivals);
      mbar_init(zempty + 8 * i, FWD_CONSUMERS);
    }
    mbar_init(bfull, arrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == FWD_CONSUMERS / 32) {
    produce<R, true, true>(q, &tm_y, &tm_z, &tm_b, y, z, b, M, N, r, sp, tma, vec_y, vec_z, vec_b);
    return;
  }
  // ---- consumer warps: rows (warp % 4)*16 .. +15 of every tile of group warp / 4 ----
  const int grp = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3, mr = lane & 7;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(s);   // s is a bf16 value: exact
  int pending = -1;      // the last tile whose store may still read its slot (tma_out)
  mbar_wait(bfull, 0);
  for (int li = 0; li < sp.nrows; ++li) {
    const int zs = li % K::ZST, row0 = (sp.rb0 + li) * CH;
    mbar_wait(zfull + 8 * zs, (li / K::ZST) & 1);
    uint32_t a[R / 16][4];                    // z rows wr*16.. as A fragments, all R ranks
#pragma unroll
    for (int ks = 0; ks < R / 16; ++ks) {
      ldsm_x4(a[ks], q.zs + zs * K::Z_SLOT + zoff<R>(wr * 16 + (mat & 1) * 8 + mr, ks * 16 + (mat >> 1) * 8));
    }
    mbar_arrive(zempty + 8 * zs);
    for (int jj = 0; jj < sp.ncols; ++jj) {
      const int t = li * sp.ncols + jj, st = t % NST;
      if (t % FWD_GROUPS != grp) continue;
      mbar_wait(full + 8 * st, (t / NST) & 1);
      const uint32_t tile = q.tiles + st * TILE_BYTES, bchunk = q.bs + jj * K::B_SLOT;
      // acc (16 x 64) = z rows (16 x R) B chunk (R x 64)
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < R / 16; ++ks) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bchunk + sw128(ks * 16 + (mat & 1) * 8 + mr, np * 16 + (mat >> 1) * 8));
          mma_bf16(acc[2 * np], a[ks], bb[0], bb[1]);
          mma_bf16(acc[2 * np + 1], a[ks], bb[2], bb[3]);
        }
      }
      // Accumulator element i of n: row g (i < 2) or g + 8, column 8n + 2 t4
      // + (i & 1); y's pair of them is word (sw128(row, 8n) + 4 t4) / 4.
      __nv_bfloat162* ytile = reinterpret_cast<__nv_bfloat162*>(smem + (tile - base) + 4 * t4);
      __nv_bfloat162 yv[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) yv[n][e2] = ytile[sw128(wr * 16 + g + 8 * e2, n * 8) / 4];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const __nv_bfloat162 p = __float22bfloat162_rn(make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]));
          const __nv_bfloat162 o = __hadd2(yv[n][e2], __hmul2(p, s2));
          if (tma_out) {
            ytile[sw128(wr * 16 + g + 8 * e2, n * 8) / 4] = o;
          } else {
            const int row = row0 + wr * 16 + g + 8 * e2, col = (sp.cb0 + jj) * CH + n * 8 + 2 * t4;
            if (row < M && col < N) {
              __nv_bfloat16* dst = out + static_cast<size_t>(row) * N + col;
              dst[0] = o.x;
              if (col + 1 < N) dst[1] = o.y;
            }
          }
        }
      }
      if (tma_out) {
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          tma_store_2d(&tm_out, tile + wr * 16 * 128, (sp.cb0 + jj) * CH, row0 + wr * 16);
          bulk_commit();
          bulk_wait_read<1>();
          if (pending >= 0) mbar_arrive(empty + 8 * (pending % NST));
        }
        pending = t;
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
    }
  }
  if (tma_out && lane == 0) bulk_wait_read<0>();
}

// ---- backward: dz and dB from one pass over dy ----

// The sum of the `count` f32x4 partials at src + p * stride, in partial
// order (p = 0, 1, ...), with up to 8 loads in flight. The partials were
// written by other blocks of this launch: they are read through L2.
__device__ __forceinline__ float4 sum_partials(const float* src, size_t stride, int count) {
  float4 v = __ldcg(reinterpret_cast<const float4*>(src));
  for (int p = 1; p < count; p += 8) {
    float4 w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (p + i < count) w[i] = __ldcg(reinterpret_cast<const float4*>(src + (p + i) * stride));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (p + i < count) {
        v.x += w[i].x;
        v.y += w[i].y;
        v.z += w[i].z;
        v.w += w[i].w;
      }
    }
  }
  return v;
}

// dz rows [row0, row1): dz[row][k .. k + 3] (those below r) = bf16(s * the
// sum of the nb partials), for items (row, k / 4) first, first + step, ...
__device__ void fold_dz(const float* pdz, __nv_bfloat16* dz, int row0, int row1, long long first,
                        long long step, int M, int r, int R, int nb, float s) {
  const int Q = R / 4;
  const long long items = static_cast<long long>(row1 - row0) * Q;
  for (long long e = first; e < items; e += step) {
    const int row = row0 + static_cast<int>(e / Q), k = static_cast<int>(e % Q) * 4;
    if (k >= r) continue;
    const float4 v = sum_partials(pdz + static_cast<size_t>(row) * R + k, static_cast<size_t>(M) * R, nb);
    const float f[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat16* out = dz + static_cast<size_t>(row) * r + k;
    for (int i = 0; i < 4 && k + i < r; ++i) out[i] = __float2bfloat16_rn(s * f[i]);
  }
}

// dB columns [col0, col1) (multiples of 4): dB[k][col .. col + 3] (those
// below N) = bf16(s * the sum of the mb partials), for items (k, col / 4).
__device__ void fold_db(const float* pdb, __nv_bfloat16* db, int col0, int col1, long long first,
                        long long step, int N, size_t n_pad, int r, int R, int mb, float s) {
  const int q = (col1 - col0) / 4;
  const long long items = static_cast<long long>(r) * q;
  for (long long e = first; e < items; e += step) {
    const int k = static_cast<int>(e / q), col = col0 + static_cast<int>(e % q) * 4;
    if (col >= N) continue;
    const float4 v = sum_partials(pdb + static_cast<size_t>(k) * n_pad + col, R * n_pad, mb);
    __nv_bfloat16* out = db + static_cast<size_t>(k) * N + col;
    if (N % 4 == 0) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s * v.x, s * v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s * v.z, s * v.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out) = u;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && col + i < N; ++i) out[i] = __float2bfloat16_rn(s * f[i]);
    }
  }
}

// Every block of a cooperative launch waits here for all `blocks`, with
// its writes visible to all of them after. bar[0] counts arrivals (the
// last arrival resets it), bar[1] is a generation the last arrival bumps.
__device__ __forceinline__ void grid_sync(int* bar, int blocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* generation = bar + 1;
    const int gen = *generation;
    __threadfence();
    if (atomicAdd(bar, 1) == blocks - 1) {
      atomicExch(bar, 0);
      __threadfence();
      atomicAdd(bar + 1, 1);
    } else {
      uint64_t t0 = 0;
      for (uint32_t n = 0; *generation == gen; ++n) {
        if ((n & 1023) == 1023) {
          if (t0 == 0) t0 = global_ns();
          else if (global_ns() - t0 > 20000000000ull) __trap();
        }
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// grid (nb, mb), THREADS threads, DzdbSmem bytes. Block (gj, gi) owns
// row chunks [rc gi / mb, rc (gi + 1) / mb) and column chunks
// [cc gj / nb, cc (gj + 1) / nb) of dy's 64 x 64 tiles (at most CPB
// columns). `tma`: the tensor maps are valid; else the producer warp loads
// with plain loads (vec_*: 16-byte loads of that tensor are allowed).
// counters: the grid barrier's two words (arrivals, generation), then mb
// row-group and nb column-group counters; every count is zero on entry and
// on exit. `coop`: a cooperative launch (every block resident at once).
template <int R, bool DZ, bool DB>
__global__ void __launch_bounds__(THREADS, 1)
epi_dzdb_kernel(const __grid_constant__ CUtensorMap tm_dy,    // (M, N), 64 x 64 boxes
                const __grid_constant__ CUtensorMap tm_z,     // (M, r), 64 x min(R, 64) boxes
                const __grid_constant__ CUtensorMap tm_b,     // (r, N), R x 64 boxes
                const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ z,
                const __nv_bfloat16* __restrict__ b, float* __restrict__ pdz,
                float* __restrict__ pdb, int* __restrict__ counters,
                __nv_bfloat16* __restrict__ dz, __nv_bfloat16* __restrict__ db, int M, int N, int r,
                int mb, int nb, float s, bool tma, bool coop, bool vec_dy, bool vec_z, bool vec_b) {
  using K = Rank<R>;
  using L = DzdbSmem<R, DZ, DB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  volatile int* flags = reinterpret_cast<volatile int*>(smem_raw + (base - raw) + L::FLAGS);
  const uint32_t full = base + L::BAR, empty = full + 8 * NST, zfull = empty + 8 * NST,
                 zempty = zfull + 8 * K::ZST, bfull = zempty + 8 * K::ZST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gj = blockIdx.x, gi = blockIdx.y;
  const Span sp = span_of(M, N, mb, nb);
  const int rb0 = sp.rb0, rb1 = sp.rb0 + sp.nrows, cb0 = sp.cb0, cb1 = sp.cb0 + sp.ncols;
  const int nrows = sp.nrows, ncols = sp.ncols, cc = (N + CH - 1) / CH;
  const size_t n_pad = static_cast<size_t>(cc) * CH;

  if (tid == 0) {
    const uint32_t arrivals = tma ? 1 : 32;     // the TMA thread, or every producer lane
    for (int i = 0; i < NST; ++i) {
      mbar_init(full + 8 * i, arrivals);
      mbar_init(empty + 8 * i, CONSUMERS);
    }
    for (int i = 0; i < K::ZST; ++i) {
      mbar_init(zfull + 8 * i, arrivals);
      mbar_init(zempty + 8 * i, CONSUMERS);
    }
    mbar_init(bfull, arrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    const Ring q = {base + L::DY, base + L::Z, base + L::B, full, empty, zfull, zempty, bfull};
    produce<R, DZ, DB>(q, &tm_dy, &tm_z, &tm_b, dy, z, b, M, N, r, sp, tma, vec_dy, vec_z, vec_b);
  } else {
    // ---- consumer warps: each tile twice, dz rows and dB^T columns ----
    const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3, mr = lane & 7;
    float acc_db[DB ? K::CPB : 1][R / 8][4];
#pragma unroll
    for (int jj = 0; jj < (DB ? K::CPB : 1); ++jj)
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
        acc_db[jj][n][0] = acc_db[jj][n][1] = acc_db[jj][n][2] = acc_db[jj][n][3] = 0.0f;
    if constexpr (DZ) mbar_wait(bfull, 0);
    for (int li = 0; li < nrows; ++li) {
      const int zs = li % K::ZST;
      const uint32_t zchunk = base + L::Z + zs * K::Z_SLOT;
      if constexpr (DB) mbar_wait(zfull + 8 * zs, (li / K::ZST) & 1);
      float acc_dz[R / 8][4];
#pragma unroll
      for (int n = 0; n < R / 8; ++n) acc_dz[n][0] = acc_dz[n][1] = acc_dz[n][2] = acc_dz[n][3] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < K::CPB; ++jj) {
        if (jj < ncols) {
          const int t = li * ncols + jj, st = t % NST;
          mbar_wait(full + 8 * st, (t / NST) & 1);
          const uint32_t tile = base + L::DY + st * TILE_BYTES;
          if constexpr (DZ) {
            // dz rows warp*16.. += dy (16 x 64) B_chunk^T (64 x R)
            const uint32_t bchunk = base + L::B + jj * K::B_SLOT;
#pragma unroll
            for (int ks = 0; ks < CH / 16; ++ks) {
              uint32_t a[4];
              ldsm_x4(a, tile + sw128(warp * 16 + (mat & 1) * 8 + mr, ks * 16 + (mat >> 1) * 8));
#pragma unroll
              for (int np = 0; np < R / 16; ++np) {
                uint32_t bb[4];
                ldsm_x4(bb, bchunk + sw128(np * 16 + (mat >> 1) * 8 + mr, ks * 16 + (mat & 1) * 8));
                mma_bf16(acc_dz[2 * np], a, bb[0], bb[1]);
                mma_bf16(acc_dz[2 * np + 1], a, bb[2], bb[3]);
              }
            }
          }
          if constexpr (DB) {
            // dB^T columns warp*16.. += dy^T (16 x 64) z_chunk (64 x R)
#pragma unroll
            for (int ks = 0; ks < CH / 16; ++ks) {
              uint32_t a[4];
              ldsm_x4_t(a, tile + sw128(ks * 16 + (mat >> 1) * 8 + mr, warp * 16 + (mat & 1) * 8));
#pragma unroll
              for (int np = 0; np < R / 16; ++np) {
                uint32_t zb[4];
                ldsm_x4_t(zb, zchunk + zoff<R>(ks * 16 + (mat & 1) * 8 + mr, np * 16 + (mat >> 1) * 8));
                mma_bf16(acc_db[jj][2 * np], a, zb[0], zb[1]);
                mma_bf16(acc_db[jj][2 * np + 1], a, zb[2], zb[3]);
              }
            }
          }
          mbar_arrive(empty + 8 * st);
        }
      }
      if constexpr (DB) mbar_arrive(zempty + 8 * zs);
      if constexpr (DZ) {
        // Accumulator element i: row g (i < 2) or g + 8, rank 8n + 2 t4 + (i & 1).
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = (rb0 + li) * CH + warp * 16 + g + 8 * e2;
          if (row < M) {
            float* dst = pdz + (static_cast<size_t>(gj) * M + row) * R + 2 * t4;
#pragma unroll
            for (int n = 0; n < R / 8; ++n) {
              *reinterpret_cast<float2*>(dst + n * 8) = make_float2(acc_dz[n][2 * e2], acc_dz[n][2 * e2 + 1]);
            }
          }
        }
      }
    }
    if constexpr (DB) {
      // Element i: column g (i < 2) or g + 8 of the warp's 16, rank 8n + 2 t4 + (i & 1).
#pragma unroll
      for (int jj = 0; jj < K::CPB; ++jj) {
        if (jj < ncols) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = (cb0 + jj) * CH + warp * 16 + g + 8 * e2;
#pragma unroll
            for (int n = 0; n < R / 8; ++n) {
              const int k = n * 8 + 2 * t4;
              float* dst = pdb + (static_cast<size_t>(gi) * R + k) * n_pad + col;
              if (k < r) dst[0] = acc_db[jj][n][2 * e2];
              if (k + 1 < r) dst[n_pad] = acc_db[jj][n][2 * e2 + 1];
            }
          }
        }
      }
    }
  }

  // ---- the fold: every f32 sum of dz and dB over its partials, in
  // partial order. Cooperative launch: after a grid-wide barrier, spread
  // over every thread of every block. Otherwise (a grid larger than one
  // wave) the last block of a row group folds its dz rows and the last
  // block of a column group its dB columns. ----
  if (coop) {
    grid_sync(counters, mb * nb);
#ifndef EPI_DZDB_PROBE_NO_FOLD
    const long long step = static_cast<long long>(mb) * nb * THREADS;
    const long long first = (static_cast<long long>(gi) * nb + gj) * THREADS + tid;
    if constexpr (DZ) fold_dz(pdz, dz, 0, M, first, step, M, r, R, nb, s);
    if constexpr (DB) fold_db(pdb, db, 0, static_cast<int>(n_pad), first, step, N, n_pad, r, R, mb, s);
#endif
    return;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int last_row = 0, last_col = 0;
    if constexpr (DZ) {
      last_row = atomicAdd(&counters[2 + gi], 1) == nb - 1;
      if (last_row) atomicExch(&counters[2 + gi], 0);
    }
    if constexpr (DB) {
      last_col = atomicAdd(&counters[2 + mb + gj], 1) == mb - 1;
      if (last_col) atomicExch(&counters[2 + mb + gj], 0);
    }
    flags[0] = last_row;
    flags[1] = last_col;
  }
  __syncthreads();
  const bool last_row = flags[0] != 0, last_col = flags[1] != 0;
  if (!(last_row || last_col)) return;
  __threadfence();
#ifndef EPI_DZDB_PROBE_NO_FOLD
  if (DZ && last_row) fold_dz(pdz, dz, rb0 * CH, min(rb1 * CH, M), tid, THREADS, M, r, R, nb, s);
  if (DB && last_col) fold_db(pdb, db, cb0 * CH, cb1 * CH, tid, THREADS, N, n_pad, r, R, mb, s);
#endif
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Tensor-map encoding failures come back as this plus the CUresult.
constexpr int ENCODE_ERROR = 100000;

// Tensor map of a row-major (rows, cols) bf16 matrix: boxes of box_cols x
// box_rows, zero-filled past the edges.
CUresult encode_2d(CUtensorMap* map, const void* ptr, int cols, int rows, int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

template <int R>
int fwd_run(const void* y, const void* z, const void* b, void* out, int M, int N, int r, int mb, int nb,
            float s, cudaStream_t stream) {
  using K = Rank<R>;
  using L = FwdSmem<R>;
  static bool ready[64] = {};        // the kernel's shared-memory limit raised on this device
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(epi_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::bytes(K::FWD_CPB)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const int rc = (M + CH - 1) / CH, cc = (N + CH - 1) / CH;
  const int cols = (cc + nb - 1) / nb;          // the most column chunks a block owns
  if (mb < 1 || nb < 1 || mb > rc || nb > cc || mb > 65535 || cols > K::FWD_CPB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tma = N % 8 == 0 && r == R && aligned16(y) && aligned16(z) && aligned16(b);
  const bool tma_out = N % 8 == 0 && aligned16(out);
  CUtensorMap ty, tz, tb, tout;
  memset(&ty, 0, sizeof(ty));
  memset(&tz, 0, sizeof(tz));
  memset(&tb, 0, sizeof(tb));
  memset(&tout, 0, sizeof(tout));
  CUresult e = CUDA_SUCCESS;
  if (tma) {
    e = encode_2d(&ty, y, N, M, CH, CH, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == CUDA_SUCCESS) {
      e = encode_2d(&tz, z, r, M, R >= 64 ? 64 : R, CH,
                    R == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                    : R == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (e == CUDA_SUCCESS) e = encode_2d(&tb, b, N, r, CH, R, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (e == CUDA_SUCCESS && tma_out) e = encode_2d(&tout, out, N, M, CH, 16, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(e);
  epi_fwd_kernel<R><<<dim3(nb, mb), FWD_THREADS, L::bytes(cols), stream>>>(
      ty, tz, tb, tout, static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(z),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), M, N, r, mb, nb, s, tma,
      tma_out, N % 8 == 0 && aligned16(y), r % 8 == 0 && aligned16(z), N % 8 == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

template <int R, bool DZ, bool DB>
int dzdb_run(const void* dy, const void* z, const void* b, void* part, void* counters, void* dz,
             void* db, int M, int N, int r, int mb, int nb, float s, cudaStream_t stream) {
  using K = Rank<R>;
  using L = DzdbSmem<R, DZ, DB>;
  static int resident[64] = {};      // blocks of this kernel the device holds at once
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident[device] == 0) {
    err = cudaFuncSetAttribute(epi_dzdb_kernel<R, DZ, DB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::BYTES));
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epi_dzdb_kernel<R, DZ, DB>,
                                                          THREADS, L::BYTES);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[device] = per_sm * sms;
  }
  const int rc = (M + CH - 1) / CH, cc = (N + CH - 1) / CH;
  if (mb < 1 || nb < 1 || mb > rc || nb > cc || mb > 65535 || (cc + nb - 1) / nb > K::CPB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tma = N % 8 == 0 && r == R && aligned16(dy) && (!DB || aligned16(z)) &&
                   (!DZ || aligned16(b));
  CUtensorMap tdy, tz, tb;
  memset(&tdy, 0, sizeof(tdy));
  memset(&tz, 0, sizeof(tz));
  memset(&tb, 0, sizeof(tb));
  if (tma) {
    CUresult e = encode_2d(&tdy, dy, N, M, CH, CH, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == CUDA_SUCCESS && DB) {
      e = encode_2d(&tz, z, r, M, R >= 64 ? 64 : R, CH,
                    R == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                    : R == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (e == CUDA_SUCCESS && DZ) e = encode_2d(&tb, b, N, r, CH, R, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(e);
  }
  float* pdz = DZ ? static_cast<float*>(part) : nullptr;
  float* pdb = DB ? static_cast<float*>(part) + (DZ ? static_cast<size_t>(nb) * M * R : 0) : nullptr;
  const bool coop = mb * nb <= resident[device];
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, mb);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, epi_dzdb_kernel<R, DZ, DB>, tdy, tz, tb,
                           static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(z),
                           static_cast<const __nv_bfloat16*>(b), pdz, pdb, static_cast<int*>(counters),
                           static_cast<__nv_bfloat16*>(dz), static_cast<__nv_bfloat16*>(db), M, N, r,
                           mb, nb, s, tma, coop, N % 8 == 0 && aligned16(dy),
                           r % 8 == 0 && aligned16(z), N % 8 == 0 && aligned16(b));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool DZ, bool DB>
int dzdb_dispatch(const void* dy, const void* z, const void* b, void* part, void* counters, void* dz,
                  void* db, int M, int N, int r, int R, int mb, int nb, float s, void* stream) {
  if (M <= 0 || N <= 0 || r <= 0 || r > R) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 16: return dzdb_run<16, DZ, DB>(dy, z, b, part, counters, dz, db, M, N, r, mb, nb, s, st);
    case 32: return dzdb_run<32, DZ, DB>(dy, z, b, part, counters, dz, db, M, N, r, mb, nb, s, st);
    case 64: return dzdb_run<64, DZ, DB>(dy, z, b, part, counters, dz, db, M, N, r, mb, nb, s, st);
    case 128: return dzdb_run<128, DZ, DB>(dy, z, b, part, counters, dz, db, M, N, r, mb, nb, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain-C launchers (bound with ctypes): the caller's current device and
// stream, contiguous row-major bf16 tensors; 0 < r <= R, R in {16, 32, 64,
// 128} the padded rank, (mb, nb) the grid (ops/lora_epilogue.py:_fwd_grid
// for the forward, _grid for the backward). The backward's part is an f32 scratch of R (M nb + N_pad mb)
// floats for the outputs computed (dz's first), counters 2 + mb + nb int32
// that are zero and that every launch leaves zero (but the second word, a
// generation, which may hold anything). Each returns cudaGetLastError()
// after its launch.
extern "C" int epi_fwd_launch(const void* y, const void* z, const void* b, void* out, int M, int N,
                              int r, int R, int mb, int nb, float s, void* stream) {
  if (M <= 0 || N <= 0 || r <= 0 || r > R) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 16: return fwd_run<16>(y, z, b, out, M, N, r, mb, nb, s, st);
    case 32: return fwd_run<32>(y, z, b, out, M, N, r, mb, nb, s, st);
    case 64: return fwd_run<64>(y, z, b, out, M, N, r, mb, nb, s, st);
    case 128: return fwd_run<128>(y, z, b, out, M, N, r, mb, nb, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int epi_dzdb_launch(const void* dy, const void* z, const void* b, void* part,
                               void* counters, void* dz, void* db, int M, int N, int r, int R,
                               int mb, int nb, float s, void* stream) {
  return dzdb_dispatch<true, true>(dy, z, b, part, counters, dz, db, M, N, r, R, mb, nb, s, stream);
}

extern "C" int epi_dz_launch(const void* dy, const void* b, void* part, void* counters, void* dz,
                             int M, int N, int r, int R, int mb, int nb, float s, void* stream) {
  return dzdb_dispatch<true, false>(dy, nullptr, b, part, counters, dz, nullptr, M, N, r, R, mb, nb,
                                    s, stream);
}

extern "C" int epi_db_launch(const void* z, const void* dy, void* part, void* counters, void* db,
                             int M, int N, int r, int R, int mb, int nb, float s, void* stream) {
  return dzdb_dispatch<false, true>(dy, z, nullptr, part, counters, nullptr, db, M, N, r, R, mb, nb,
                                    s, stream);
}
