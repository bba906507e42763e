// Causal GQA flash-attention backward for Hopper (sm_90a), packed layout:
// three launches (prep, main, post), all in this file.
//
// Replaces phantom_vlb_tpu/ops/flash_attention.py:_dq_dkv_kernel (line 284),
// reached through _bwd_impl (:490) from _flash_packed_bwd (:754). It also
// computes what the split _dq_kernel (:177) + _dkv_kernel (:227) compute,
// which the reference takes for long kv: this design has no length limit.
// Same function, from the forward's saved (out, lse):
//   s  = q_s K^T + bias + causal,  p = exp(s - lse),  di = rowsum(o * do)
//   dv = sum_g p^T do,  dp = do V^T,  ds = p (dp - di),
//   dk = sum_g ds^T q_s,  dq = (ds K) * sm_scale
// where the causal mask is col > row + offset (the reference's causal_offset;
// 0 is plain causal attention; q tiles that see no key of a kv tile skip
// it, as the reference's tile skip :313 does), q_s = q * bf16(sm_scale)
// rounded once to bf16 (reference :509), the bias row added before the mask,
// kv rows past S masked, p from the saved lse with the difference taken
// before the log2(e) scaling, p and ds rounded to bf16 as product operands,
// every sum f32, GQA dk/dv summed over the group in f32 before one cast, and
// dq scaled by sm_scale once at the end (reference :351).
//
// 1. flash_bwd_prep_kernel reads q, o, do and lse once and writes q_s
//    (B, S, Hq*128) bf16, lse and di as (B, Hq, S_pad) f32 rows zero-padded
//    to S_pad = 64 * ceil(S / 64) (16-byte aligned rows a bulk copy can
//    fetch), and zeroes the f32 dq accumulator (B, Hq, S_pad, 128). A warp
//    per (batch, row, head) item, 4 elements a lane, on a grid of 8 blocks
//    an SM striding over the items. Bound by bytes.
// 2. flash_bwd_kernel: one block of 384 threads per (128-row kv tile, kv
//    head, batch), the kv tile slowest in launch order, so the longest tiles
//    (j = 0 sees every q tile) start first. Warpgroup 0 is the producer (24
//    registers a thread by setmaxnreg): one thread loads the block's K and V
//    once by TMA (128B-swizzled, resident for the whole block) and then keeps
//    a 2-stage ring of (Q_s, dO) 64-row tiles (TMA, zero-filled past S, which
//    makes every term of a padded row vanish) and their lse/di rows (bulk
//    copies) in flight, with mbarriers for full and empty stages. Each of the
//    two consumer warpgroups (240 registers a thread) owns 64 kv rows and
//    keeps their dK and dV (64 x 128 f32 each, 128 registers a thread) for the
//    whole block while it walks the group's q heads and, for each, the q
//    tiles at or below the diagonal. Per q tile, with wgmma:
//      S^T = K Q_s^T and dP^T = V dO^T   (A, B from shared memory, K-major)
//      dV += P^T dO and dK += dS^T Q_s   (A from registers: the converted
//                                          accumulators; B MN-major)
//      dQ  = dS K                         (dS^T stored once to shared memory
//                                          128B-swizzled; A and B MN-major;
//                                          each warpgroup 64 columns of d)
//    dS^T is double-buffered, handed over by mbarriers, and a tile's dQ is
//    computed after the next tile's dK: the two consumer warpgroups meet
//    only at a dS written a tile earlier, so they drift apart by up to a
//    tile and one's exponentials run beside the other's products. dQ's
//    64 x 128 f32 tile goes to shared memory, 128B-swizzled in four
//    32-column boxes (conflict-free stores); a thread of the producer
//    warpgroup adds it to the f32 accumulator by four TMA tensor reduce-adds
//    (cp.reduce.async.bulk.tensor .add) and frees the buffer once they have
//    read it: no scalar atomics, and no consumer waits on a reduce. The
//    accumulation order still varies from run to run.
//    One tile shape serves every length: at the ring's S_loc 512 the 128-row
//    kv tiles fill only 96 of 132 SMs, and a 64-row variant with twice the
//    blocks was slower there in bring-up.
//    Cost probes: built with FLASH_BWD_PROBE_NO_DQ_REDUCE (dq's reduce-adds
//    left out) or FLASH_BWD_PROBE_NO_EXP (the exponential left out), both
//    wrong on purpose, or FLASH_BWD_PROBE_GROUPED (blocks of one (batch, kv
//    head) adjacent, kv tile fastest), the main kernel says what that part
//    or that order costs; chip_smoke.py phase 11 times each against this one.
// 3. flash_bwd_post_kernel turns the f32 sums into dq: bf16(acc * sm_scale)
//    in the packed layout, or, in the ring's accumulate form,
//    dq_f32 += f32(bf16(acc * sm_scale)) with acc's rows below S zeroed for
//    the next step (the rows past S only ever receive exact zeros). Bound by
//    bytes.
//
// Bound at the training shape (B=3, S=2048, Hq=32, Hkv=8, D=128, causal):
// five products over the causal half, 10*B*Hq*D*S(S+1)/2 = 257.9 GFLOP
// -> 0.261 ms at 989 TFLOP/s (bf16 dense), against ~252 MB of traffic
// (q, k, v, o, do, dq, dk, dv once) -> 0.075 ms at 3.35 TB/s. Bound by
// operations; the main kernel's work. The design answers it with wgmma (the
// only route to the full tensor-core rate), operands that never pass
// through registers on their way in (TMA), K/V resident per block, and no
// atomics in the inner loop. Left on the table: overlap inside a warpgroup
// of one q tile's exponentials with the next tile's products (registers:
// dK and dV hold 128 of the 240), a persistent schedule, and the waits
// after each product group (every wgmma group is waited for at once).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                 // head dim
constexpr int BQ = 64;                 // q rows per tile
constexpr int NST = 2;                 // (Q, dO) stages in flight
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of flash_bwd_kernel, bytes from a 1024-aligned base. A
// 128B-swizzled tile of R rows x 128 columns is two R x 64 halves of R * 128
// bytes, as TMA writes them and as wgmma's descriptors read them.
constexpr int BK = 128;                // kv rows per block: two consumer warpgroups of 64
constexpr int NTHREADS = 384;          // producer warpgroup + two consumer warpgroups

struct Smem {
  static constexpr uint32_t KV_TILE = BK * 256;          // K or V, both halves
  static constexpr uint32_t Q_TILE = BQ * 256;           // Q_s or dO, both halves
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + KV_TILE;
  static constexpr uint32_t Q = V + KV_TILE;             // [NST]
  static constexpr uint32_t DO = Q + NST * Q_TILE;       // [NST]
  static constexpr uint32_t DS = DO + NST * Q_TILE;      // dS^T [2]: BK rows x 64 q, swizzled
  static constexpr uint32_t DQ = DS + 2 * BK * 128;      // dQ: 4 boxes of 64 rows x 32 f32
  static constexpr uint32_t LSE = DQ + BQ * D * 4;       // [NST][64] f32
  static constexpr uint32_t DI = LSE + NST * BQ * 4;     // [NST][64] f32
  // full[NST], empty[NST], kv, ds_full[2], ds_empty[2], dq_full, dq_empty
  static constexpr uint32_t BAR = DI + NST * BQ * 4;
  static constexpr uint32_t BYTES = BAR + 8 * (2 * NST + 7) + 1024;   // + alignment slack
  static constexpr uint32_t STAGE_TX = 2 * Q_TILE + 2 * BQ * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Returns once the phase of parity `parity` has completed. A wait longer
// than 20 s traps ("unspecified launch failure") rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && (n & 1023) == 1023) {
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 20000000000ull) __trap();
    }
  }
}

// A 3D box (columns, rows, batch) of a tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Adds a 2D box of shared memory into the tensor map's f32 elements.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and bulk copies.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory descriptor, 128B swizzle. K-major operands: 8-row
// groups 1024 B apart (sbo), lbo unused; a k16 slice is +32 B inside a
// 64-column half. MN-major operands: 8 k-rows 1024 B apart (sbo), 64-wide
// MN halves `lbo` apart; a k16 slice is +2048 B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// d[0..32) += A(smem) B(smem), m64n64k16, bf16 in, f32 sums.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[0..64) += A(registers) B(smem), m64n128k16, bf16 in, f32 sums.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nN accumulator as register A fragments of k16 slices: slice k is
// columns 16k..16k+15, elements 8k..8k+7.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 2], const float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,     // q_s (B, S, Hq*128)
                 const __grid_constant__ CUtensorMap tm_do,    // do  (B, S, Hq*128)
                 const __grid_constant__ CUtensorMap tm_k,     // k   (B, S, Hkv*128)
                 const __grid_constant__ CUtensorMap tm_v,     // v   (B, S, Hkv*128)
                 const __grid_constant__ CUtensorMap tm_dq,    // dq_acc (B*Hq*S_pad, 128) f32
                 const float* __restrict__ bias,               // (B, S) or null
                 const float* __restrict__ lse_p,              // (B, Hq, S_pad)
                 const float* __restrict__ di_p,               // (B, Hq, S_pad)
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv,
                 int B, int S, int Hq, int Hkv, int s_pad, int offset) {
  using L = Smem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::BAR, empty_bar = full_bar + 8 * NST,
                 kv_bar = full_bar + 16 * NST, ds_full = kv_bar + 8, ds_empty = kv_bar + 24,
                 dq_full = kv_bar + 40, dq_empty = kv_bar + 48;

  const int item = blockIdx.x;
#ifdef FLASH_BWD_PROBE_GROUPED
  const int n_tiles = (S + BK - 1) / BK;
  const int j = item % n_tiles;
  const int hkv = (item / n_tiles) % Hkv;
  const int b = item / (n_tiles * Hkv);
#else
  const int j = item / (Hkv * B);          // kv tile slowest: the longest start first
  const int hkv = item % Hkv;
  const int b = (item / Hkv) % B;
#endif
  const int G = Hq / Hkv;
  const int kv0 = j * BK;
  const int nq = (S + BQ - 1) / BQ;
  // q tiles whose last row does not reach kv0 never see the tile.
  const int need = kv0 - offset - (BQ - 1);
  const int i0 = need <= 0 ? 0 : min((need + BQ - 1) / BQ, nq);
  const int per_head = nq - i0;
  const int n_iter = G * per_head;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NTHREADS - 128);
    }
    mbar_init(kv_bar, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(ds_full + 8 * s, NTHREADS - 128);
      mbar_init(ds_empty + 8 * s, NTHREADS - 128);
    }
    mbar_init(dq_full, NTHREADS - 128);
    mbar_init(dq_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * L::KV_TILE);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        tma_load(base + L::K + half * BK * 128, &tm_k, hkv * D + half * 64, kv0, b, kv_bar);
        tma_load(base + L::V + half * BK * 128, &tm_v, hkv * D + half * 64, kv0, b, kv_bar);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % NST;
        if (it >= NST) mbar_wait(empty_bar + 8 * st, ((it / NST) - 1) & 1);
        const int h = hkv * G + it / per_head;
        const int qt = i0 + it % per_head;
        const uint32_t bar = full_bar + 8 * st;
        mbar_expect_tx(bar, L::STAGE_TX);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          tma_load(base + L::Q + st * L::Q_TILE + half * BQ * 128, &tm_q, h * D + half * 64,
                   qt * BQ, b, bar);
          tma_load(base + L::DO + st * L::Q_TILE + half * BQ * 128, &tm_do, h * D + half * 64,
                   qt * BQ, b, bar);
        }
        const size_t stat = (static_cast<size_t>(b) * Hq + h) * s_pad + qt * BQ;
        bulk_load(base + L::LSE + st * BQ * 4, lse_p + stat, BQ * 4, bar);
        bulk_load(base + L::DI + st * BQ * 4, di_p + stat, BQ * 4, bar);
      }
    } else if (threadIdx.x == 32) {
      // The dQ tiles' reduce-adds, in tile order, as the consumers finish them.
      for (int it = 0; it < n_iter; ++it) {
        mbar_wait(dq_full, it & 1);
        const int row0 = (b * Hq + hkv * G + it / per_head) * s_pad + (i0 + it % per_head) * BQ;
#ifdef FLASH_BWD_PROBE_NO_DQ_REDUCE
        (void)row0;
#else
#pragma unroll
        for (int box = 0; box < 4; ++box) {
          tma_reduce_add(&tm_dq, base + L::DQ + box * (BQ * 128), box * 32, row0);
        }
#endif
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(dq_empty);
      }
      bulk_wait_all();
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ct = threadIdx.x - 128;
    const int wg = ct >> 7;
    const int warp = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, tq = lane & 3;
    // Accumulator element i of an m64nN tile: row r_a (i & 2 == 0) or r_a + 8,
    // column 8 * (i / 4) + 2 * tq + (i & 1). Here rows are this tile's kv rows.
    const int r_a = wg * 64 + warp * 16 + g;
    float bias_r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kv = kv0 + r_a + 8 * e;
      bias_r[e] = kv >= S ? MASK_VALUE
                : (bias != nullptr ? bias[static_cast<size_t>(b) * S + kv] : 0.0f);
    }
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    mbar_wait(kv_bar, 0);
    // Tile it's products through dK, then tile it - 1's dQ: each warpgroup
    // meets the other only at tile it - 1's dS, a tile later, so the two
    // drift apart by up to a tile and one's exponentials run while the
    // other's products do.
    for (int it = 0; it <= n_iter; ++it) {
      if (it < n_iter) {
        const int st = it % NST;
        const int q0 = (i0 + it % per_head) * BQ;
        mbar_wait(full_bar + 8 * st, (it / NST) & 1);
        const uint32_t sq = base + L::Q + st * L::Q_TILE, sdo = base + L::DO + st * L::Q_TILE;

        // S^T = K Q_s^T and dP^T = V dO^T: 64 kv rows x 64 q columns each.
        // Accumulators start from zeros (not wgmma's scale-d = 0, on which
        // ptxas 12.9 crashed for this kernel).
        float s_acc[32], dp_acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s_acc[i] = dp_acc[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk >> 2) * (BK * 128) + wg * 8192 + (kk & 3) * 32;
          const uint32_t qoff = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
          wgmma_ss_n64<0, 0>(s_acc, smem_desc(base + L::K + koff, 16, 1024),
                             smem_desc(sq + qoff, 16, 1024));
          wgmma_ss_n64<0, 0>(dp_acc, smem_desc(base + L::V + koff, 16, 1024),
                             smem_desc(sdo + qoff, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s_acc);
        fence_regs(dp_acc);

        // p^T = exp(s^T + bias + causal - lse): the bias and mask added in the
        // reference's order; the difference taken before the log2(e) scaling.
        const float* ls = reinterpret_cast<const float*>(smem + L::LSE + st * BQ * 4);
        const float* ds_row = reinterpret_cast<const float*>(smem + L::DI + st * BQ * 4);
        const bool diag = kv0 + BK - 1 > q0 + offset;   // some key lies past some query's reach
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
          const int row = r_a + ((i & 2) << 2);
          float x = s_acc[i] + bias_r[(i >> 1) & 1];
          if (diag && kv0 + row > q0 + col + offset) x += MASK_VALUE;
#ifdef FLASH_BWD_PROBE_NO_EXP
          s_acc[i] = (x - ls[col]) * LOG2E;
#else
          s_acc[i] = exp2f((x - ls[col]) * LOG2E);
#endif
        }

        // dV += P^T dO (P bf16).
        uint32_t pa[16];
        acc_to_a<32>(pa, s_acc);
        wgmma_fence();
        fence_regs(dv_acc);
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) {
          wgmma_rs_n128<1>(dv_acc, pa + 4 * k, smem_desc(sdo + k * 2048, BQ * 128, 1024));
        }
        wgmma_commit();
        // dS^T = P^T (dP^T - di) in f32, while dV runs.
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
          s_acc[i] = s_acc[i] * (dp_acc[i] - ds_row[col]);
        }
        uint32_t da[16];
        acc_to_a<32>(da, s_acc);
        wgmma_wait_all();
        fence_regs(dv_acc);

        // dK += dS^T Q_s (dS bf16).
        wgmma_fence();
        fence_regs(dk_acc);
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) {
          wgmma_rs_n128<1>(dk_acc, da + 4 * k, smem_desc(sq + k * 2048, BQ * 128, 1024));
        }
        wgmma_commit();
        // dS^T to shared memory for dQ, 128B-swizzled as wgmma reads it:
        // row r's 16-byte chunk c sits at chunk c ^ (r & 7), and r & 7 = g.
        // Buffer it & 1, once both warpgroups' dQ of tile it - 2 has read it.
        if (it >= 2) mbar_wait(ds_empty + 8 * (it & 1), ((it >> 1) - 1) & 1);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          unsigned char* row =
              smem + L::DS + (it & 1) * (BK * 128) + r_a * 128 + ((c ^ g) << 4) + tq * 4;
          *reinterpret_cast<uint32_t*>(row) = da[2 * c];
          *reinterpret_cast<uint32_t*>(row + 8 * 128) = da[2 * c + 1];
        }
        fence_async_smem();
        mbar_arrive(ds_full + 8 * (it & 1));
        wgmma_wait_all();
        fence_regs(dk_acc);
        mbar_arrive(empty_bar + 8 * st);           // Q_s and dO of this stage are free
      }
      // dQ of tile pt = it - 1 = dS K: 64 q rows x 64 columns of d,
      // warpgroup wg taking half wg.
      if (it >= 1) {
        const int pt = it - 1;
        const int half = wg;
        mbar_wait(ds_full + 8 * (pt & 1), (pt >> 1) & 1);
        float q_acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) q_acc[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          wgmma_ss_n64<1, 1>(
              q_acc, smem_desc(base + L::DS + (pt & 1) * (BK * 128) + ks * 2048, BK * 128, 1024),
              smem_desc(base + L::K + half * BK * 128 + ks * 2048, BK * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(q_acc);
        mbar_arrive(ds_empty + 8 * (pt & 1));
        if (pt >= 1) mbar_wait(dq_empty, (pt - 1) & 1);   // tile pt - 1 has left shared memory
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int qr = warp * 16 + g + ((i & 2) << 2);
          const int col = half * 64 + 8 * (i >> 2) + 2 * tq;
          // Four boxes of 32 columns, each 64 rows x 128 B, 128B-swizzled
          // as the reduce reads them: conflict-free stores.
          *reinterpret_cast<float2*>(smem + L::DQ + (col >> 5) * (BQ * 128) + qr * 128
                                     + ((((col & 31) >> 2) ^ (qr & 7)) << 4) + (col & 3) * 4) =
              make_float2(q_acc[i], q_acc[i + 1]);
        }
        fence_async_smem();
        mbar_arrive(dq_full);
      }
    }

    // dk, dv: one cast to bf16 of the group's f32 sums.
    const size_t kv_stride = static_cast<size_t>(Hkv) * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kv = kv0 + r_a + 8 * e;
      if (kv < S) {
        const size_t off = (static_cast<size_t>(b) * S + kv) * kv_stride
                           + static_cast<size_t>(hkv) * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
              pack_bf16(dk_acc[4 * n + 2 * e], dk_acc[4 * n + 2 * e + 1]);
          *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
              pack_bf16(dv_acc[4 * n + 2 * e], dv_acc[4 * n + 2 * e + 1]);
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}

constexpr int ELEM_WARPS = 8;          // warps per block of the prep and post kernels
constexpr int ELEM_BLOCKS_PER_SM = 8;  // their grids: 64 warps an SM, each striding over items

// A warp per (batch, row < S_pad, head) item, striding over the items;
// lane l holds d = 4l .. 4l+3.
__global__ void __launch_bounds__(ELEM_WARPS * 32)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      __nv_bfloat16* __restrict__ q_s, float* __restrict__ lse_p,
                      float* __restrict__ di_p, float* __restrict__ dq_acc,
                      int B, int S, int Hq, int s_pad, float scale) {
  const int lane = threadIdx.x & 31;
  const size_t items = static_cast<size_t>(B) * s_pad * Hq;
  for (size_t w = static_cast<size_t>(blockIdx.x) * ELEM_WARPS + (threadIdx.x >> 5); w < items;
       w += static_cast<size_t>(gridDim.x) * ELEM_WARPS) {
    const int h = static_cast<int>(w % Hq);
    const int row = static_cast<int>((w / Hq) % s_pad);
    const int b = static_cast<int>(w / (static_cast<size_t>(Hq) * s_pad));
    const size_t stat = (static_cast<size_t>(b) * Hq + h) * s_pad + row;
    *reinterpret_cast<float4*>(dq_acc + stat * D + 4 * lane) = make_float4(0.f, 0.f, 0.f, 0.f);
    float di = 0.0f, l = 0.0f;
    if (row < S) {
      const size_t off = (static_cast<size_t>(b) * S + row) * Hq * D + static_cast<size_t>(h) * D + 4 * lane;
      float x[4], o[4], g[4];
      load4(q + off, x);
      load4(out + off, o);
      load4(dout + off, g);
      uint2 u;
      u.x = pack_bf16(x[0] * scale, x[1] * scale);     // q * bf16(sm_scale), one rounding
      u.y = pack_bf16(x[2] * scale, x[3] * scale);
      *reinterpret_cast<uint2*>(q_s + off) = u;
      float part = o[0] * g[0];
      part += o[1] * g[1];
      part += o[2] * g[2];
      part += o[3] * g[3];
      di = warp_sum(part);
      l = lse[(static_cast<size_t>(b) * Hq + h) * S + row];
    }
    if (lane == 0) {
      di_p[stat] = di;
      lse_p[stat] = l;
    }
  }
}

// A warp per (batch, row < S, head) item, striding over the items. dq16
// set: dq = bf16(acc * scale) in the packed layout; else dq32 +=
// f32(bf16(acc * scale)) and acc = 0.
__global__ void __launch_bounds__(ELEM_WARPS * 32)
flash_bwd_post_kernel(float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq16,
                      float* __restrict__ dq32, int B, int S, int Hq, int s_pad, float scale) {
  const int lane = threadIdx.x & 31;
  const size_t items = static_cast<size_t>(B) * S * Hq;
  for (size_t w = static_cast<size_t>(blockIdx.x) * ELEM_WARPS + (threadIdx.x >> 5); w < items;
       w += static_cast<size_t>(gridDim.x) * ELEM_WARPS) {
    const int h = static_cast<int>(w % Hq);
    const int row = static_cast<int>((w / Hq) % S);
    const int b = static_cast<int>(w / (static_cast<size_t>(Hq) * S));
    float* acc = dq_acc + ((static_cast<size_t>(b) * Hq + h) * s_pad + row) * D + 4 * lane;
    const float4 a = *reinterpret_cast<const float4*>(acc);
    const size_t off = (static_cast<size_t>(b) * S + row) * Hq * D + static_cast<size_t>(h) * D + 4 * lane;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * scale, a.w * scale);
    if (dq16 != nullptr) {
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dq16 + off) = u;
    } else {
      float4 d = *reinterpret_cast<const float4*>(dq32 + off);
      d.x += __low2float(lo);
      d.y += __high2float(lo);
      d.z += __low2float(hi);
      d.w += __high2float(hi);
      *reinterpret_cast<float4*>(dq32 + off) = d;
      *reinterpret_cast<float4*>(acc) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Tensor map of a (B, S, width) bf16 tensor: boxes of 64 columns x `rows`
// rows of one batch row, 128B-swizzled, zero-filled past S.
CUresult encode_rows(CUtensorMap* map, const void* ptr, int width, int S, int B, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(S) * width * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Tensor map of the f32 dq accumulator as (B*Hq*S_pad) rows of 128: boxes
// of 32 columns x 64 rows, 128B-swizzled, for the main kernel's reduce-adds.
CUresult encode_dq(CUtensorMap* map, void* ptr, size_t rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {D * 4};
  const cuuint32_t box[2] = {32, BQ};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides, box, elem,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Tensor-map encoding failures come back as this plus the CUresult.
constexpr int ENCODE_ERROR = 100000;

// Blocks for a striding elementwise grid over `warps` items on the current
// device: at most ELEM_BLOCKS_PER_SM an SM.
int elem_blocks(size_t warps, unsigned* blocks) {
  static int sms[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t most = static_cast<size_t>(sms[device]) * ELEM_BLOCKS_PER_SM;
  const size_t need = (warps + ELEM_WARPS - 1) / ELEM_WARPS;
  *blocks = static_cast<unsigned>(need < most ? (need > 0 ? need : 1) : most);
  return 0;
}

}  // namespace

// Plain-C launchers (bound with ctypes). Each launches on the caller's
// current device and stream and returns cudaGetLastError() after the launch.

// q_s, lse_p, di_p and a zeroed dq_acc for flash_bwd_launch; scale is
// sm_scale rounded to bf16.
extern "C" int flash_bwd_prep_launch(const void* q, const void* out, const void* dout,
                                     const void* lse, void* q_s, void* lse_p, void* di_p,
                                     void* dq_acc, int B, int S, int Hq, int s_pad, float scale,
                                     void* stream) {
  unsigned blocks = 0;
  const int err = elem_blocks(static_cast<size_t>(B) * s_pad * Hq, &blocks);
  if (err != 0) return err;
  flash_bwd_prep_kernel<<<blocks, ELEM_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(q_s), static_cast<float*>(lse_p), static_cast<float*>(di_p),
      static_cast<float*>(dq_acc), B, S, Hq, s_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv and dq_acc's f32 sums.
extern "C" int flash_bwd_launch(const void* q_s, const void* k, const void* v, const void* bias,
                                const void* dout, const void* lse_p, const void* di_p,
                                void* dq_acc, void* dk, void* dv, int B, int S, int Hq, int Hkv,
                                int s_pad, int offset, void* stream) {
  static bool smem_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Smem::BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  CUtensorMap tq, tdo, tk, tv, tdq;
  CUresult r = encode_rows(&tq, q_s, Hq * D, S, B, BQ);
  if (r == CUDA_SUCCESS) r = encode_rows(&tdo, dout, Hq * D, S, B, BQ);
  if (r == CUDA_SUCCESS) r = encode_rows(&tk, k, Hkv * D, S, B, BK);
  if (r == CUDA_SUCCESS) r = encode_rows(&tv, v, Hkv * D, S, B, BK);
  if (r == CUDA_SUCCESS) r = encode_dq(&tdq, dq_acc, static_cast<size_t>(B) * Hq * s_pad);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  const int tiles = (S + BK - 1) / BK;
  flash_bwd_kernel<<<tiles * Hkv * B, NTHREADS, Smem::BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tk, tv, tdq, static_cast<const float*>(bias), static_cast<const float*>(lse_p),
      static_cast<const float*>(di_p), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      B, S, Hq, Hkv, s_pad, offset);
  return static_cast<int>(cudaGetLastError());
}

// dq from dq_acc: into dq16 (bf16, packed) when it is given, else added to
// dq32 (f32, packed) with dq_acc's rows below S zeroed.
extern "C" int flash_bwd_post_launch(void* dq_acc, void* dq16, void* dq32, int B, int S, int Hq,
                                     int s_pad, float scale, void* stream) {
  unsigned blocks = 0;
  const int err = elem_blocks(static_cast<size_t>(B) * S * Hq, &blocks);
  if (err != 0) return err;
  flash_bwd_post_kernel<<<blocks, ELEM_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dq16), static_cast<float*>(dq32),
      B, S, Hq, s_pad, scale);
  return static_cast<int>(cudaGetLastError());
}
