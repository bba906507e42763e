// Fused ring attention forward for Hopper (sm_90a): one launch per rank owns
// the whole ring pass.
//
// Replaces phantom_vlb_tpu/ops/ring_fused.py:_ring_fwd_kernel (line 48),
// reached through ring_fwd_sharded (:218) and ring_flash_fused (:313). For
// rank `my` of n, with the sequence cut into n contiguous chunks of S_loc
// rows and chunk i on rank i, arrival step r brings the k/v chunk of rank
// src = (my - r) mod n:
//   s = q_s k_src^T + bias[r] (+ MASK_VALUE where col > row, if src == my)
// with chunks from later ranks (src > my) skipped whole (causal), and one
// online softmax over every chunk: m from -inf, l and acc in f32, P cast to
// bf16 for the PV product; out = acc * (l == 0 ? 1 : 1/l) in bf16 and
// lse = m + log(max(l, 1e-30)). q, out (B, S_loc, Hq*128) bf16 rows, k, v
// (B, S_loc, Hkv*128) bf16 rows (each with its own batch stride, so a rank
// may read and write its chunk of the global tensors in place), bias
// (B, n, S_loc) f32 additive in arrival order or null, lse (B, Hq, S_loc)
// f32 rows with a (b, h) stride. q is pre-scaled in bf16 (q*s rounded to
// bf16, as ring_fwd_sharded multiplies in the input dtype, :248). Bias first,
// then the mask, as the reference adds them.
//
// Transport. The TPU kernel drives its remote copies from its first grid
// cell and waits on DMA semaphores; carried over literally that deadlocks
// on a GPU, where nothing makes the blocks of two ranks resident at once.
// Here the host enqueues every copy (ring_send) on the sending rank's
// copy stream: at step 0 each rank's local k/v go into its right
// neighbour's slot 0; at step r >= 1 the rank forwards slot r-1 into the
// neighbour's slot r once the slot has landed (an event of the left
// neighbour's copy stream). Each send ends with cuStreamWriteValue32 of the
// pass's epoch into the receiver's flag for that slot, issued on the same
// copy stream after the data (with its default memory barrier), so no SM
// writes a flag. A block waits for flag r-1 (acquire load, system scope so
// the same code serves peer cards) before its first read of slot r-1. The
// sends depend only on each other and on k/v being ready, never on a
// kernel. Across cards they are copy-engine peer copies, so the ring makes
// progress however the n kernels are scheduled. Between two ranks of one
// card they are not: the driver runs a same-card cudaMemcpyAsync as a
// kernel that needs a free SM, and on an H100 such a copy waited until
// blocks spinning on its flag and holding every SM gave up. So the wrapper
// starts a rank whose left neighbour shares its card only once the slots it
// reads have landed (a stream wait; the flags are then already set), and
// only the ranks of a ring over distinct cards overlap their sends inside
// the kernel. Flags hold epochs and are never reset, so a pass never reads
// an earlier pass's flag as ready. A wait longer than 20 s traps rather
// than hang.
//
// Bound at the training shape (B=3, S=2048 as 4 x 512, Hq=32, Hkv=8, D=128):
// the causal work 4*B*Hq*D*S(S+1)/2 = 103.1 GFLOP -> 0.104 ms at 989
// TFLOP/s (tiles above each diagonal chunk's diagonal are skipped; the
// reference computes those chunks whole, 10 chunk pairs of S_loc^2, 128.8
// GFLOP), against ~88 MB of q, k, v, out, lse and bias -> 0.026 ms at 3.35
// TB/s. Bound by operations. On one card the 12 chunk sends move 75.5 MB of
// k and v more, read and written (0.045 ms at the HBM rate).
//
// Design (simple and right first): flash_fwd.cu's block, one per (64-row q
// tile, q head, batch row) of the rank's chunk; 4 warps x 16 rows, Q as
// mma.sync A fragments in registers, K/V tiles double-buffered in shared
// memory by cp.async, the online softmax in f32 registers across all the
// rank's chunks (which is what makes it the fused ring: m, l and acc never
// leave registers between chunks). The local chunk comes first, so across
// cards the sends land while it is computed. Left on the table: wgmma + TMA, a
// persistent schedule balancing ranks (rank my does my + 1 chunks), and the
// 6 of 12 sends whose chunks no rank reads (chunks travelling past rank
// n - 1), which the reference's chain also makes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int D = 128;                 // head dim
constexpr int BQ = 64;                 // q rows per block: 4 warps x 16
constexpr int BK = 64;                 // kv rows per tile (== BQ)
constexpr int NTHREADS = 128;
constexpr int SROW = D + 8;            // padded shared row, elements (272 B)
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_BYTES =
    2 * 2 * BK * SROW * sizeof(__nv_bfloat16) + 2 * BK * sizeof(float);
constexpr unsigned long long SPIN_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0 bytes read -> 16 bytes of zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

// c += a(16x16, row) * b(16x8, col); bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every thread that reads a slot acquires its flag itself: its later loads
// of the slot are then ordered after the send that the flag announces.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch) {
  if (ld_acquire(flag) >= epoch) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) < epoch) {
    __nanosleep(256);
    if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  }
}

__global__ void __launch_bounds__(NTHREADS)
ring_fwd_kernel(const __nv_bfloat16* __restrict__ q, long long q_bs,
                const __nv_bfloat16* __restrict__ k_loc,
                const __nv_bfloat16* __restrict__ v_loc, long long kv_bs,
                const __nv_bfloat16* __restrict__ k_slots,
                const __nv_bfloat16* __restrict__ v_slots,
                const unsigned* flags, unsigned epoch,
                const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, long long out_bs,
                float* __restrict__ lse, long long lse_hs,
                int S, int Hq, int Hkv, int n, int my, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16 (*)[BK][SROW]>(smem);
  auto Vs = reinterpret_cast<__nv_bfloat16 (*)[BK][SROW]>(
      smem + 2 * BK * SROW * sizeof(__nv_bfloat16));
  auto Bs = reinterpret_cast<float (*)[BK]>(
      smem + 4 * BK * SROW * sizeof(__nv_bfloat16));

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t slot_bs = static_cast<size_t>(S) * kv_stride;      // batch stride in a slot
  const size_t slot_stride = static_cast<size_t>(gridDim.z) * slot_bs;
  const int row_a = qi * BQ + warp * 16 + g;   // this thread's rows: row_a, row_a + 8

  // Tiles in arrival order: the local (diagonal) chunk's tiles up to the
  // diagonal, then every tile of the chunks of ranks my-1, ..., 0 (steps
  // r = 1..my). Chunks of later ranks (steps r > my) are wholly above the
  // causal diagonal and skipped.
  const int nk = (S + BK - 1) / BK;
  const int n_diag = min(qi + 1, nk);
  const int total = n_diag + my * nk;

  // Tile `it` (+ its bias row) into buffer `buf`.
  auto load_tile = [&](int it, int buf) {
    const int r = it < n_diag ? 0 : 1 + (it - n_diag) / nk;
    const int j = it < n_diag ? it : (it - n_diag) % nk;
    const __nv_bfloat16* kb = k_loc;
    const __nv_bfloat16* vb = v_loc;
    size_t bs = static_cast<size_t>(kv_bs);
    if (r > 0) {
      if (j == 0) wait_flag(flags + (r - 1), epoch);
      kb = k_slots + (r - 1) * slot_stride;
      vb = v_slots + (r - 1) * slot_stride;
      bs = slot_bs;
    }
#pragma unroll
    for (int i = 0; i < (BK * D / 8) / NTHREADS; ++i) {
      const int c = tid + i * NTHREADS;
      const int rr = c >> 4, col = (c & 15) * 8;
      const int kv = j * BK + rr;
      const bool ok = kv < S;
      const size_t off = static_cast<size_t>(b) * bs + static_cast<size_t>(ok ? kv : 0) * kv_stride
                         + static_cast<size_t>(hkv) * D + col;
      cp_async16(&Ks[buf][rr][col], kb + off, ok);
      cp_async16(&Vs[buf][rr][col], vb + off, ok);
    }
    if (tid < BK) {
      const int kv = j * BK + tid;
      Bs[buf][tid] = kv >= S ? MASK_VALUE
                   : (bias != nullptr ? bias[(static_cast<size_t>(b) * n + r) * S + kv] : 0.0f);
    }
  };

  load_tile(0, 0);
  cp_async_commit();

  // Q fragments for the 8 k-steps over d, pre-scaled in bf16.
  uint32_t qf[D / 16][4];
  {
    auto load_q = [&](int row, int col) -> uint32_t {
      if (row >= S) return 0u;
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          q + static_cast<size_t>(b) * q_bs + static_cast<size_t>(row) * q_stride
          + static_cast<size_t>(h) * D + col);
      const float2 f = __bfloat1622float2(x);
      return pack_bf16(f.x * scale, f.y * scale);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = load_q(row_a, kk * 16 + 2 * t);
      qf[kk][1] = load_q(row_a + 8, kk * 16 + 2 * t);
      qf[kk][2] = load_q(row_a, kk * 16 + 8 + 2 * t);
      qf[kk][3] = load_q(row_a + 8, kk * 16 + 8 + 2 * t);
    }
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};             // this thread's share of the row sums
  float o[D / 8][4];
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();                  // tile `it` has landed
    __syncthreads();

    // s = q K^T for this warp's 16 rows x 64 keys (as flash_fwd.cu).
    const int mat = lane >> 3, mr = lane & 7;
    float s[BK / 8][4];
#pragma unroll
    for (int nn = 0; nn < BK / 8; ++nn) s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[buf][np * 16 + (mat >> 1) * 8 + mr][kk * 16 + (mat & 1) * 8]);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // + bias, then + the in-chunk causal mask on the local chunk's diagonal
    // tile (the only tile of any chunk that holds keys after some query).
    const bool diag = it < n_diag && it == qi;
    const int j0 = (it < n_diag ? it : (it - n_diag) % nk) * BK;
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nn = 0; nn < BK / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nn * 8 + 2 * t + (e & 1);
        const int row = row_a + ((e >> 1) << 3);
        float x = s[nn][e] + Bs[buf][col];
        if (diag && j0 + col > row) x += MASK_VALUE;
        s[nn][e] = x;
        mc[e >> 1] = fmaxf(mc[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mc[rr] = fmaxf(mc[rr], __shfl_xor_sync(0xffffffffu, mc[rr], 1));
      mc[rr] = fmaxf(mc[rr], __shfl_xor_sync(0xffffffffu, mc[rr], 2));
      const float m_next = fmaxf(m_r[rr], mc[rr]);
      alpha[rr] = exp2f((m_r[rr] - m_next) * LOG2E);
      m_r[rr] = m_next;
      l_r[rr] *= alpha[rr];
    }
#pragma unroll
    for (int nn = 0; nn < BK / 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Subtract before scaling: MASK_VALUE * log2(e) would overflow.
        const float p = exp2f((s[nn][e] - m_r[e >> 1]) * LOG2E);
        s[nn][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      o[nn][0] *= alpha[0]; o[nn][1] *= alpha[0];
      o[nn][2] *= alpha[1]; o[nn][3] *= alpha[1];
    }

    // o += P V, P (bf16) straight from the s accumulators.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[buf][kk * 16 + (mat & 1) * 8 + mr][np * 16 + (mat >> 1) * 8]);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                       // buffer `buf` is refilled next iteration
  }

  // Epilogue: normalise, store out (bf16) and lse (f32).
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = (l == 0.0f) ? 1.0f : 1.0f / l;
    const int row = row_a + 8 * rr;
    if (row < S) {
      __nv_bfloat16* op = out + static_cast<size_t>(b) * out_bs + static_cast<size_t>(row) * q_stride
                          + static_cast<size_t>(h) * D + 2 * t;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        *reinterpret_cast<uint32_t*>(op + nn * 8) =
            pack_bf16(o[nn][2 * rr] * inv, o[nn][2 * rr + 1] * inv);
      }
      if (t == 0) {
        lse[(static_cast<size_t>(b) * Hq + h) * lse_hs + row] = m_r[rr] + logf(fmaxf(l, 1e-30f));
      }
    }
  }
}

// One send of the ring: `rows` rows of `row_bytes` of k and of v (source and
// destination pitches apart) from device src_dev to dst_dev, on the sender's
// copy stream, then the epoch into the receiver's flag on the same stream:
// cudaMemcpyAsync / cudaMemcpy2DAsync on one card (the driver's copy
// kernel), cudaMemcpyPeerAsync across cards (the copy engines), and
// cuStreamWriteValue32 (whose default barrier orders the flag after the
// data; no SM writes it). Returns a cudaError_t, or 100000 + a CUresult.
int ring_send(void* dst_k, void* dst_v, int dst_dev, const void* src_k, const void* src_v,
              int src_dev, int rows, size_t row_bytes, size_t src_pitch, size_t dst_pitch,
              void* flag, unsigned epoch, cudaStream_t st) {
  void* dsts[2] = {dst_k, dst_v};
  const void* srcs[2] = {src_k, src_v};
  for (int x = 0; x < 2; ++x) {
    cudaError_t err = cudaSuccess;
    if (dst_dev == src_dev) {         // one call per tensor: the host issues every send
      err = src_pitch == row_bytes && dst_pitch == row_bytes
                ? cudaMemcpyAsync(dsts[x], srcs[x], row_bytes * rows, cudaMemcpyDeviceToDevice, st)
                : cudaMemcpy2DAsync(dsts[x], dst_pitch, srcs[x], src_pitch, row_bytes, rows,
                                    cudaMemcpyDeviceToDevice, st);
    } else {
      for (int i = 0; i < rows && err == cudaSuccess; ++i) {
        err = cudaMemcpyPeerAsync(static_cast<char*>(dsts[x]) + i * dst_pitch, dst_dev,
                                  static_cast<const char*>(srcs[x]) + i * src_pitch, src_dev,
                                  row_bytes, st);
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const CUresult res = cuStreamWriteValue32(st, reinterpret_cast<CUdeviceptr>(flag), epoch,
                                            CU_STREAM_WRITE_VALUE_DEFAULT);
  if (res != CUDA_SUCCESS) return 100000 + static_cast<int>(res);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain-C launcher (bound with ctypes): one ring pass, every send and every
// rank's kernel, issued from here so that the host's part of a pass is one
// call. Per rank (arrays of n): its card; pointers q, k, v (its chunk, with
// batch strides q_bs / kv_bs in elements), its landing slots for k and v
// ((n - 1, B, S, Hkv*128) each), its flags, its bias in arrival order or 0,
// out (batch stride out_bs) and lse ((b, h) stride lse_hs); its compute and
// copy streams. The sends go step by step: at step 0 each rank's local
// k/v, at step r its slot r - 1 once that slot has landed (an event of the
// left neighbour's copy stream), into the right neighbour's slot r. A rank
// whose left neighbour shares its card is launched only after its last
// slot has landed (a stream wait), since its sends run on that card's SMs
// and its blocks must not hold them while they wait; other ranks launch
// first and wait on their flags inside the kernel. Returns cudaGetLastError()
// (or the first failure); 0 is success.
extern "C" int ring_pass_launch(int n, int B, int S, int Hq, int Hkv, float scale,
                                unsigned epoch, const int* dev,
                                const unsigned long long* ptr,      // n x 9
                                const long long* stride,             // n x 4
                                const unsigned long long* stream) {  // n x 2
  enum { Q, K, V, KS, VS, FLAGS, BIAS, OUT, LSE };
  enum { Q_BS, KV_BS, OUT_BS, LSE_HS };
  static bool smem_set[64] = {};
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t row_bytes = static_cast<size_t>(S) * Hkv * D * sizeof(__nv_bfloat16);
  const size_t slot_bytes = row_bytes * B;
  std::vector<cudaEvent_t> landed(static_cast<size_t>(n) * n, nullptr);   // [rank][step]
  auto P = [&](int i, int which) { return ptr[static_cast<size_t>(i) * 9 + which]; };
  auto launch = [&](int i) -> cudaError_t {
    cudaError_t e = cudaSetDevice(dev[i]);
    if (e != cudaSuccess) return e;
    if (dev[i] < 0 || dev[i] >= 64) return cudaErrorInvalidDevice;
    if (!smem_set[dev[i]]) {
      e = cudaFuncSetAttribute(ring_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
      if (e != cudaSuccess) return e;
      smem_set[dev[i]] = true;
    }
    const long long* st = stride + static_cast<size_t>(i) * 4;
    const dim3 grid((S + BQ - 1) / BQ, Hq, B);
    ring_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream[2 * i])>>>(
        reinterpret_cast<const __nv_bfloat16*>(P(i, Q)), st[Q_BS],
        reinterpret_cast<const __nv_bfloat16*>(P(i, K)),
        reinterpret_cast<const __nv_bfloat16*>(P(i, V)), st[KV_BS],
        reinterpret_cast<const __nv_bfloat16*>(P(i, KS)),
        reinterpret_cast<const __nv_bfloat16*>(P(i, VS)),
        reinterpret_cast<const unsigned*>(P(i, FLAGS)), epoch,
        reinterpret_cast<const float*>(P(i, BIAS)),
        reinterpret_cast<__nv_bfloat16*>(P(i, OUT)), st[OUT_BS],
        reinterpret_cast<float*>(P(i, LSE)), st[LSE_HS], S, Hq, Hkv, n, i, scale);
    return cudaGetLastError();
  };
  auto gated = [&](int i) { return i > 0 && dev[i - 1] == dev[i]; };
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    if (!gated(i)) err = launch(i);
  }
  for (int r = 0; r + 1 < n && err == cudaSuccess; ++r) {
    for (int i = 0; i < n && err == cudaSuccess; ++i) {
      const int right = (i + 1) % n;
      const cudaStream_t copy = reinterpret_cast<cudaStream_t>(stream[2 * i + 1]);
      err = cudaSetDevice(dev[i]);
      if (err == cudaSuccess && r > 0) err = cudaStreamWaitEvent(copy, landed[i * n + r - 1], 0);
      if (err != cudaSuccess) break;
      const bool local = r == 0;
      const size_t pitch = local ? static_cast<size_t>(stride[i * 4 + KV_BS]) * sizeof(__nv_bfloat16)
                                 : row_bytes;
      const unsigned long long src_k = local ? P(i, K) : P(i, KS) + (r - 1) * slot_bytes;
      const unsigned long long src_v = local ? P(i, V) : P(i, VS) + (r - 1) * slot_bytes;
      const int e = ring_send(reinterpret_cast<void*>(P(right, KS) + r * slot_bytes),
                              reinterpret_cast<void*>(P(right, VS) + r * slot_bytes), dev[right],
                              reinterpret_cast<const void*>(src_k), reinterpret_cast<const void*>(src_v),
                              dev[i], B, row_bytes, pitch, row_bytes,
                              reinterpret_cast<void*>(P(right, FLAGS) + 4 * r), epoch, copy);
      if (e != 0) {
        for (cudaEvent_t ev : landed) if (ev != nullptr) cudaEventDestroy(ev);
        cudaSetDevice(prev);
        return e;
      }
      cudaEvent_t& ev = landed[right * n + r];
      err = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
      if (err == cudaSuccess) err = cudaEventRecord(ev, copy);
    }
    if (err == cudaSuccess && gated(r + 1)) {
      err = cudaSetDevice(dev[r + 1]);
      if (err == cudaSuccess) {
        err = cudaStreamWaitEvent(reinterpret_cast<cudaStream_t>(stream[2 * (r + 1)]),
                                  landed[(r + 1) * n + r], 0);
      }
      if (err == cudaSuccess) err = launch(r + 1);
    }
  }
  // Destroying an event that waits are enqueued on is safe: its resources
  // go when it completes.
  for (cudaEvent_t ev : landed) {
    if (ev != nullptr) cudaEventDestroy(ev);
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

// Let device `dev` write into device `peer`'s memory (the flag writes of a
// ring over distinct cards); a pair already enabled is not an error.
extern "C" int ring_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}
