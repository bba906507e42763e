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
// (B, ., n, S_loc) f32 additive in arrival order (its batch stride given)
// or null, lse (B, Hq, S_loc) f32 rows with a (b, h) stride. q is
// pre-scaled in bf16 (q*s rounded to bf16, as ring_fwd_sharded multiplies
// in the input dtype, :248). Bias first, then the mask, as the reference
// adds them; keys past S_loc (the zero fill of a chunk's last tile) weigh
// exactly nothing.
//
// Transport. The TPU kernel drives its remote copies from its first grid
// cell and waits on DMA semaphores; carried over literally that deadlocks
// on a GPU, where nothing makes the blocks of two ranks resident at once.
// Here the host enqueues every copy (ring_send) on the sending rank's
// copy stream, and only the copies whose chunk some rank reads: at step r,
// rank i forwards the chunk of rank i - r to rank i + 1 (into its slot r)
// iff r <= i <= n - 2, n(n-1)/2 sends a pass (the plan comes from the
// caller, ops/ring_fused.py:ring_send_plan). At step 0 a rank sends its
// local k/v; at step r >= 1 it forwards its slot r - 1 once that slot has
// landed (an event of the left neighbour's copy stream). Each send ends
// with cuStreamWriteValue32 of the pass's epoch into the receiver's flag
// for that slot, issued on the same copy stream after the data (with its
// default memory barrier), so no SM writes a flag. The block's TMA thread
// acquires flag r-1 (system scope, so the same code serves peer cards) and
// then orders its async-proxy reads after that acquire
// (fence.proxy.async.global) before its first load of slot r-1. Across
// cards the sends are copy-engine peer copies, so the ring makes progress
// however the n kernels are scheduled. Between two ranks of one card they
// are not: the driver runs a same-card cudaMemcpyAsync as a kernel that
// needs a free SM, and on an H100 such a copy waited until blocks spinning
// on its flag and holding every SM gave up. So a rank whose left neighbour
// shares its card starts only once the slots it reads have landed (a stream
// wait; the flags are then already set), and only the ranks of a ring over
// distinct cards overlap their sends inside the kernel. Flags hold epochs
// and are never reset, so a pass never reads an earlier pass's flag as
// ready. A wait longer than 20 s traps rather than hang.
//
// The landing slots persist across passes (the caller keeps them per ring
// and shape), so a send into a slot waits for the previous pass's reader of
// that slot: every rank's copy stream ends a pass after its kernel, and a
// send waits for the receiver's copy stream's end of the previous pass.
// Events are made once per ring (ring_state_create).
//
// Bound at the training shape (B=3, S=2048 as 4 x 512, Hq=32, Hkv=8, D=128):
// the causal work 4*B*Hq*D*S(S+1)/2 = 103.1 GFLOP -> 0.104 ms at 989
// TFLOP/s (tiles above each diagonal chunk's diagonal are skipped; the
// reference computes those chunks whole, 10 chunk pairs of S_loc^2, 128.8
// GFLOP), against ~88 MB of q, k, v, out, lse and bias -> 0.026 ms at 3.35
// TB/s. Bound by operations. On one card the 6 chunk sends move 37.7 MB of
// k and v more, read and written (0.023 ms at the HBM rate).
//
// Design: the Hopper core of attn_fwd.cuh, as flash_fwd.cu runs it: a
// persistent grid walking the (128-row q tile, q head, batch row) items of
// the rank's chunk longest first; for each the producer walks the tiles in
// arrival order (the local chunk's tiles up to the diagonal, then every
// tile of the chunks of ranks my-1, ..., 0) and the consumers fold them all
// into one online softmax held in registers, which is what makes it the
// fused ring. The local chunk comes first, so across cards the sends land
// while it is computed. The producer warpgroup keeps 40 registers a thread
// and the consumers 232 (the flag waits and the walk over chunks spill at
// flash_fwd.cu's 24). Tensor maps: q, out, local k and v as rows of the
// global tensors with their batch strides; the landing slots as one 4-D map
// (columns, rows, batch, slot: k of slot s at 2s, v at 2s + 1), so the
// kernel takes a fixed number of parameters whatever n is. Left on the
// table: what flash_fwd.cu leaves, and a schedule balancing ranks (rank my
// folds my + 1 chunks; on one card the ranks run mostly one after another).

#include <vector>

#include "attn_fwd.cuh"

namespace {

using namespace attn_fwd;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Returns once the flag holds `epoch` or later (an acquire), or traps after 20 s.
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned epoch) {
  if (ld_acquire(flag) >= epoch) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) < epoch) {
    __nanosleep(256);
    if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
ring_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,      // q   (B, S, Hq*128), 64-row boxes
                const __grid_constant__ CUtensorMap tm_k,      // local k (B, S, Hkv*128), 128-row boxes
                const __grid_constant__ CUtensorMap tm_v,      // local v
                const __grid_constant__ CUtensorMap tm_slots,  // (2(n-1), B, S, Hkv*128)
                const __grid_constant__ CUtensorMap tm_o,      // out (B, S, Hq*128), 64-row boxes
                const unsigned* flags, unsigned epoch,
                const float* __restrict__ bias, long long bias_bs,
                float* __restrict__ lse, long long lse_hs,
                int B, int S, int Hq, int Hkv, int my, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Block blk = block_init(smem_raw);

  const int nq = (S + BM - 1) / BM;
  const int items = nq * Hq * B;
  // An item's tiles in arrival order: the local (diagonal) chunk's tiles up
  // to the diagonal, then every tile of the chunks of ranks my-1, ..., 0
  // (steps r = 1..my). Chunks of later ranks (steps r > my) are wholly above
  // the causal diagonal and skipped.
  const int nk = (S + BN - 1) / BN;
  auto n_diag = [&](int qi) { return min(qi + 1, nk); };

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    // 40 registers: the flag waits and the walk over chunks spill at 24.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int round = 0, w; (w = item_at(round)) < items; ++round) {
        const Item t = item_of(w, nq, Hq, B);
        const int nd = n_diag(t.qi), n = nd + my * nk, col0 = t.h / (Hq / Hkv) * D;
        // The item's first tiles go out while the consumers finish the
        // previous item; its Q once they have stored that item's output.
        const int pre = min(n, NST - 1);
        int r = 0, kt = 0;                           // step and kv tile of tile it
        for (int it = 0; it < n; ++it) {
          if (it == pre) {
            for (int wg = 0; wg < 2; ++wg) load_q(blk, wg, round, &tm_q, t.h * D, t.qi * BM + 64 * wg, t.b);
          }
          if (r > 0 && kt == 0) {
            // The slot's send has landed; order the copy engine's reads after it.
            wait_flag(flags + (r - 1), epoch);
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
          }
          const int st = claim_stage(blk, g + it);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (r == 0) {
              tma_load_3d(blk.k(st) + half * Smem::HALF, &tm_k, col0 + half * 64, kt * BN, t.b, blk.full(st));
              tma_load_3d(blk.v(st) + half * Smem::HALF, &tm_v, col0 + half * 64, kt * BN, t.b, blk.full(st));
            } else {
              tma_load_4d(blk.k(st) + half * Smem::HALF, &tm_slots, col0 + half * 64, kt * BN, t.b, 2 * r - 2,
                          blk.full(st));
              tma_load_4d(blk.v(st) + half * Smem::HALF, &tm_slots, col0 + half * 64, kt * BN, t.b, 2 * r - 1,
                          blk.full(st));
            }
          }
          if (++kt == (r == 0 ? nd : nk)) {
            ++r;
            kt = 0;
          }
        }
        if (pre == n) {
          for (int wg = 0; wg < 2; ++wg) load_q(blk, wg, round, &tm_q, t.h * D, t.qi * BM + 64 * wg, t.b);
        }
        g += n;
      }
    } else if ((threadIdx.x >> 5) == 1) {
      int g = 0;
      for (int round = 0, w; (w = item_at(round)) < items; ++round) {
        const Item t = item_of(w, nq, Hq, B);
        const int nd = n_diag(t.qi), n = nd + my * nk;
        const float* row = bias != nullptr ? bias + t.b * bias_bs : nullptr;
        int kt = 0;
        for (int it = 0; it < n; ++it) {
          put_bias(blk, g + it, row, kt * BN, S);
          if (++kt == (it < nd ? nd : nk)) {         // the next step's row
            kt = 0;
            if (row != nullptr) row += S;
          }
        }
        g += n;
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");   // 40 * 128 + 232 * 256 = 168 * 384
    const Consumer c;
    if (item_at(0) < items) seed_turns(c);           // every item has at least its diagonal tile
    int g = 0;
    for (int round = 0, w; (w = item_at(round)) < items; ++round) {
      const Item t = item_of(w, nq, Hq, B);
      const int nd = n_diag(t.qi), n = nd + my * nk;
      const int q_row0 = t.qi * BM + c.wg * 64;
      scale_q(blk, c, scale, round);
      Softmax sm;
      sm.init();
      // The local chunk's causal mask where a key may lie past the
      // warpgroup's first row; other chunks lie wholly before every row.
      run_tiles(blk, c, sm, g, n, item_at(round + 1) < items, q_row0, S, [&](int it) {
        const bool local = it < nd;
        const int key0 = (local ? it : (it - nd) % nk) * BN;
        return TileInfo{key0, local ? 0 : (1 << 30), (local && key0 + BN - 1 > q_row0) || key0 + BN > S};
      });
      finish(blk, c, sm, &tm_o, t.h * D, q_row0, t.b, lse + (static_cast<long long>(t.b) * Hq + t.h) * lse_hs,
             S);
      g += n;
    }
  }
}

// Events a ring keeps across passes, per rank: landed[rank * n + slot] (the
// send into that slot, on the sender's copy stream), ready (the caller's
// stream at the pass's start), ran (its kernel, on its compute stream) and
// done (its copy stream at the pass's end, after its kernel).
struct RingState {
  int n;
  std::vector<int> dev;
  std::vector<cudaEvent_t> landed, ready, ran, done;
};

// Error codes: a cudaError_t, or SEND_ERROR + a CUresult of a flag write,
// or ENCODE_ERROR + a CUresult of a tensor-map encode.
constexpr int SEND_ERROR = 200000;

// One copy of `rows` rows of `row_bytes` (source and destination pitches
// apart) from device src_dev to dst_dev on stream st: cudaMemcpyAsync /
// cudaMemcpy2DAsync on one card (the driver's copy kernel),
// cudaMemcpyPeerAsync across cards (the copy engines).
cudaError_t copy_rows(void* dst, int dst_dev, const void* src, int src_dev, int rows, size_t row_bytes,
                      size_t src_pitch, size_t dst_pitch, cudaStream_t st) {
  if (dst_dev == src_dev) {
    return src_pitch == row_bytes && dst_pitch == row_bytes
               ? cudaMemcpyAsync(dst, src, row_bytes * rows, cudaMemcpyDeviceToDevice, st)
               : cudaMemcpy2DAsync(dst, dst_pitch, src, src_pitch, row_bytes, rows,
                                   cudaMemcpyDeviceToDevice, st);
  }
  if (src_pitch == row_bytes && dst_pitch == row_bytes) {
    return cudaMemcpyPeerAsync(dst, dst_dev, src, src_dev, row_bytes * rows, st);
  }
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < rows && err == cudaSuccess; ++i) {
    err = cudaMemcpyPeerAsync(static_cast<char*>(dst) + i * dst_pitch, dst_dev,
                              static_cast<const char*>(src) + i * src_pitch, src_dev, row_bytes, st);
  }
  return err;
}

cudaError_t set_device(int d) {
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == d) return err;
  return cudaSetDevice(d);
}

}  // namespace

// The events of a ring of n ranks on cards dev[0..n), made once; *handle
// receives the state for ring_pass_launch and ring_state_destroy.
extern "C" int ring_state_create(int n, const int* dev, unsigned long long* handle) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  RingState* st = new RingState{n, std::vector<int>(dev, dev + n),
                                std::vector<cudaEvent_t>(static_cast<size_t>(n) * n, nullptr),
                                std::vector<cudaEvent_t>(n, nullptr), std::vector<cudaEvent_t>(n, nullptr),
                                std::vector<cudaEvent_t>(n, nullptr)};
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = cudaSetDevice(dev[i]);
    for (int s = 0; s < n && err == cudaSuccess; ++s) {
      err = cudaEventCreateWithFlags(&st->landed[static_cast<size_t>(i) * n + s], cudaEventDisableTiming);
    }
    for (auto* ev : {&st->ready[i], &st->ran[i], &st->done[i]}) {
      if (err == cudaSuccess) err = cudaEventCreateWithFlags(ev, cudaEventDisableTiming);
    }
  }
  const cudaError_t restore = cudaSetDevice(prev);
  *handle = reinterpret_cast<unsigned long long>(st);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

extern "C" int ring_state_destroy(unsigned long long handle) {
  RingState* st = reinterpret_cast<RingState*>(handle);
  if (st == nullptr) return 0;
  for (auto* evs : {&st->landed, &st->ready, &st->ran, &st->done}) {
    for (cudaEvent_t ev : *evs) {
      if (ev != nullptr) cudaEventDestroy(ev);      // safe while waits on it are pending
    }
  }
  delete st;
  return 0;
}

// Plain-C launcher (bound with ctypes): one ring pass, every send and every
// rank's kernel, issued from here so that the host's part of a pass is one
// call. Per rank (arrays of n): pointers q, k, v (its chunk, batch strides
// q_bs / kv_bs in elements), its landing slots ((n - 1, 2, B, S, Hkv*128):
// k then v of each slot), its flags, its bias in arrival order or 0 (batch
// stride bias_bs), out (batch stride out_bs) and lse ((b, h) stride
// lse_hs); its compute and copy streams and the caller's stream on its card.
// plan: n_sends (step, sender, slot) triples, in step order. The streams of
// every rank start after the caller's stream; a rank whose left neighbour
// shares its card is launched only after its last slot has landed (a
// stream wait), since its sends run on that card's SMs and its blocks must
// not hold them while they wait; other ranks launch first and wait on their
// flags inside the kernel. The caller's streams end after every rank's.
// *issued receives the sends enqueued whole (their copies and flag write).
// Returns 0, or the first failure (see SEND_ERROR, ENCODE_ERROR).
extern "C" int ring_pass_launch(unsigned long long handle, int n, int B, int S, int Hq, int Hkv,
                                float scale, unsigned epoch,
                                const unsigned long long* ptr,       // n x 8
                                const long long* stride,              // n x 5
                                const unsigned long long* stream,    // n x 3
                                int n_sends, const int* plan,        // n_sends x 3
                                int* issued) {
  enum { Q, K, V, SLOTS, FLAGS, BIAS, OUT, LSE };
  enum { Q_BS, KV_BS, OUT_BS, BIAS_BS, LSE_HS };
  enum { COMPUTE, COPY, CALLER };
  RingState& rs = *reinterpret_cast<RingState*>(handle);
  if (n != rs.n) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[64] = {};
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const std::vector<int>& dev = rs.dev;
  const int W = Hkv * D;
  const size_t row_bytes = static_cast<size_t>(S) * W * sizeof(__nv_bfloat16);   // one batch row
  const size_t slot_bytes = row_bytes * B;                                         // k or v of a slot
  const int nslots = n > 1 ? n - 1 : 1;
  auto P = [&](int i, int which) { return ptr[static_cast<size_t>(i) * 8 + which]; };
  auto T = [&](int i, int which) { return stride[static_cast<size_t>(i) * 5 + which]; };
  auto strm = [&](int i, int which) { return reinterpret_cast<cudaStream_t>(stream[3 * i + which]); };
  int code = 0;
  auto fail = [&](int c) { if (code == 0) code = c; return code; };
  *issued = 0;

  // Every rank's streams start after the caller's stream on its card: the
  // compute stream of a gated rank through its slots' landing, which comes
  // after the sender's copy stream's start.
  auto gated = [&](int i) { return i > 0 && dev[i - 1] == dev[i]; };
  for (int i = 0; i < n && !code; ++i) {
    if ((err = set_device(dev[i])) != cudaSuccess ||
        (err = cudaEventRecord(rs.ready[i], strm(i, CALLER))) != cudaSuccess ||
        (!gated(i) && (err = cudaStreamWaitEvent(strm(i, COMPUTE), rs.ready[i], 0)) != cudaSuccess) ||
        (err = cudaStreamWaitEvent(strm(i, COPY), rs.ready[i], 0)) != cudaSuccess) {
      fail(err);
    }
  }

  auto launch = [&](int i) -> int {
    cudaError_t e = set_device(dev[i]);
    if (e != cudaSuccess) return e;
    if (dev[i] < 0 || dev[i] >= 64) return cudaErrorInvalidDevice;
    if ((e = bind_context()) != cudaSuccess) return e;
    if (!smem_set[dev[i]]) {
      e = cudaFuncSetAttribute(ring_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Smem::BYTES));
      if (e != cudaSuccess) return e;
      smem_set[dev[i]] = true;
    }
    CUtensorMap tq, tk, tv, ts, to;
    CUresult r = encode_rows(&tq, reinterpret_cast<const void*>(P(i, Q)), Hq * D, S, B, T(i, Q_BS), 64);
    if (r == CUDA_SUCCESS) r = encode_rows(&tk, reinterpret_cast<const void*>(P(i, K)), W, S, B, T(i, KV_BS), BN);
    if (r == CUDA_SUCCESS) r = encode_rows(&tv, reinterpret_cast<const void*>(P(i, V)), W, S, B, T(i, KV_BS), BN);
    if (r == CUDA_SUCCESS) {
      r = encode_rows(&ts, reinterpret_cast<const void*>(P(i, SLOTS)), W, S, B,
                      static_cast<long long>(S) * W, BN, 2 * nslots, static_cast<long long>(B) * S * W);
    }
    if (r == CUDA_SUCCESS) r = encode_rows(&to, reinterpret_cast<const void*>(P(i, OUT)), Hq * D, S, B, T(i, OUT_BS), 64);
    if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
    int blocks = 0;
    if ((e = persistent_blocks((S + BM - 1) / BM * Hq * B, dev[i], &blocks)) != cudaSuccess) return e;
    ring_fwd_kernel<<<blocks, NTHREADS, Smem::BYTES, strm(i, COMPUTE)>>>(
        tq, tk, tv, ts, to, reinterpret_cast<const unsigned*>(P(i, FLAGS)), epoch,
        reinterpret_cast<const float*>(P(i, BIAS)), T(i, BIAS_BS),
        reinterpret_cast<float*>(P(i, LSE)), T(i, LSE_HS), B, S, Hq, Hkv, i, scale);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaEventRecord(rs.ran[i], strm(i, COMPUTE));
    return e;
  };
  for (int i = 0; i < n && !code; ++i) {
    if (!gated(i)) fail(launch(i));
  }

  for (int k = 0; k < n_sends && !code; ++k) {
    const int r = plan[3 * k], i = plan[3 * k + 1], slot = plan[3 * k + 2];
    const int right = (i + 1) % n;
    const cudaStream_t copy = strm(i, COPY);
    if ((err = set_device(dev[i])) != cudaSuccess) { fail(err); break; }
    // The chunk forwarded has landed here, and the receiver's slot is free:
    // its reader of the previous pass is done (before the first pass the
    // event was never recorded and the wait is a no-op).
    if ((r > 0 && (err = cudaStreamWaitEvent(copy, rs.landed[static_cast<size_t>(i) * n + r - 1], 0))
                      != cudaSuccess) ||
        (err = cudaStreamWaitEvent(copy, rs.done[right], 0)) != cudaSuccess) {
      fail(err);
      break;
    }
    char* dst = reinterpret_cast<char*>(P(right, SLOTS)) + 2 * slot * slot_bytes;
    if (r == 0) {                                 // the local k and v, rows a batch stride apart
      const size_t pitch = static_cast<size_t>(T(i, KV_BS)) * sizeof(__nv_bfloat16);
      err = copy_rows(dst, dev[right], reinterpret_cast<const void*>(P(i, K)), dev[i], B, row_bytes,
                      pitch, row_bytes, copy);
      if (err == cudaSuccess) {
        err = copy_rows(dst + slot_bytes, dev[right], reinterpret_cast<const void*>(P(i, V)), dev[i], B,
                        row_bytes, pitch, row_bytes, copy);
      }
    } else {                                      // slot r - 1's k and v, adjacent
      err = copy_rows(dst, dev[right], reinterpret_cast<const char*>(P(i, SLOTS)) + 2 * (r - 1) * slot_bytes,
                      dev[i], 1, 2 * slot_bytes, 2 * slot_bytes, 2 * slot_bytes, copy);
    }
    if (err != cudaSuccess) { fail(err); break; }
    // The epoch into the receiver's flag after the data; no SM writes it.
    const CUresult res = cuStreamWriteValue32(copy, static_cast<CUdeviceptr>(P(right, FLAGS) + 4 * slot),
                                              epoch, CU_STREAM_WRITE_VALUE_DEFAULT);
    if (res != CUDA_SUCCESS) { fail(SEND_ERROR + static_cast<int>(res)); break; }
    ++*issued;
    if ((err = cudaEventRecord(rs.landed[static_cast<size_t>(right) * n + slot], copy)) != cudaSuccess) {
      fail(err);
      break;
    }
    // A gated rank starts once the last slot it reads (slot right - 1) has landed.
    if (gated(right) && slot == right - 1) {
      if ((err = set_device(dev[right])) != cudaSuccess ||
          (err = cudaStreamWaitEvent(strm(right, COMPUTE), rs.landed[static_cast<size_t>(right) * n + slot], 0))
              != cudaSuccess) {
        fail(err);
        break;
      }
      fail(launch(right));
    }
  }

  // Each rank's copy stream ends the pass after its kernel; the caller's
  // streams wait for that end (which the next pass's sends into its slots
  // wait for too).
  for (int i = 0; i < n && !code; ++i) {
    if ((err = set_device(dev[i])) != cudaSuccess ||
        (err = cudaStreamWaitEvent(strm(i, COPY), rs.ran[i], 0)) != cudaSuccess ||
        (err = cudaEventRecord(rs.done[i], strm(i, COPY))) != cudaSuccess ||
        (err = cudaStreamWaitEvent(strm(i, CALLER), rs.done[i], 0)) != cudaSuccess) {
      fail(err);
    }
  }
  const cudaError_t restore = set_device(prev);
  return code != 0 ? code : static_cast<int>(restore);
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
