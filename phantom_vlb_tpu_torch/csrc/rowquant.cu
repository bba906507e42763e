// One-pass per-row int8 quantization for Hopper (sm_90a), plain or with a
// per-column pre-multiply.
//
// Replaces phantom_vlb_tpu/ops/rowquant.py:_row_quant_kernel (line 35) and
// _row_quant_scaled_kernel (:45), reached through _row_quant_2d (:67). One
// kernel, two entry points:
//   v = x            (row_quant_launch)
//   v = x * w_scale  (row_quant_scaled_launch; f32 product, w_scale (N,) f32)
//   s = max(max|v| / 127, 1e-12),  q = clip(rint(v / s), -127, 127)
// per row of x (rows, N), bf16 or f32; q int8 (rows, N), s f32 (rows) (the
// TPU's 128-lane scale padding is not copied).
//
// The same kernel in two more modes splits the quantization where a row's
// columns lie on several ranks of the tensor axis (the caller reduces the
// maxima over the ranks between the two launches):
//   row_absmax_launch:      m = max|v| per row of this rank's columns
//   row_quant_given_launch: q = clip(rint(v / s), -127, 127) with s given
// so q and s equal the one-card quantization of the whole row bit for bit. Division is IEEE (no fast
// math, no reciprocal multiply) and rint rounds half to even, so q and s
// equal the plain version (ops/rowquant.py:row_quant_plain) bit for bit.
// Any row count and any N: the TPU's rows % 8 and N % 128 limits are its
// own.
//
// Bound: bytes. A bf16 row of N moves 2N bytes in and N + 4 out: at
// (6144, 4096) 75.5 MB, 22.5 us at 3.35 TB/s; at (6144, 14336) 264 MB,
// 78.9 us.
//
// Design (simple and right first): one block of 256 threads per row. Pass 1
// reads the row from device memory once, 16 bytes a thread per step (when
// N and the pointers allow it, else element by element), keeps the raw row
// in shared memory (up to 46 KB; a longer row is read again in pass 2,
// from L2 in practice) and reduces max|v| through warp shuffles and one
// shared word per warp. Pass 2 quantizes from shared memory and writes q,
// 8 or 4 bytes a thread per step. Many rows are in flight on each SM, so
// the loads of one row overlap the arithmetic of others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
// A cached row and the block's few static words stay under the 48 KB that
// needs no opt-in.
constexpr int MAX_CACHED_BYTES = 46 * 1024;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ int8_t quant1(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// The E = 16 / sizeof(T) elements of one 16-byte piece as f32 (bf16 widens
// exactly by a shift), times w[col ..] in f32 when SCALED.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

template <typename T, bool SCALED>
__device__ __forceinline__ void piece_values(const uint4& raw, const float* __restrict__ w, int col,
                                             float (&v)[16 / sizeof(T)]) {
  constexpr int E = 16 / sizeof(T);
  unpack(raw, v);
  if (SCALED) {
    // w's piece in 16-byte loads (col is a multiple of E, w 16-byte aligned).
#pragma unroll
    for (int h = 0; h < E / 4; ++h) {
      const float4 ws = reinterpret_cast<const float4*>(w + col)[h];
      v[4 * h] = __fmul_rn(v[4 * h], ws.x);
      v[4 * h + 1] = __fmul_rn(v[4 * h + 1], ws.y);
      v[4 * h + 2] = __fmul_rn(v[4 * h + 2], ws.z);
      v[4 * h + 3] = __fmul_rn(v[4 * h + 3], ws.w);
    }
  }
}

// Four int8 codes in one word, element i in byte i.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float sc) {
  return static_cast<uint32_t>(static_cast<uint8_t>(quant1(a, sc))) |
         static_cast<uint32_t>(static_cast<uint8_t>(quant1(b, sc))) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(quant1(c, sc))) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(quant1(d, sc))) << 24;
}

// What a launch does: both passes (s written), pass 1 alone (the row's
// max|v| written to s, no q), or pass 2 alone with s read.
enum Mode { FULL = 0, ABSMAX = 1, GIVEN = 2 };

// Pass 1: max|v| over the row, valid in thread 0; the raw row kept in
// `cached` when `cache`.
template <typename T, bool SCALED>
__device__ __forceinline__ float row_absmax(const T* __restrict__ xr, const float* __restrict__ w,
                                            T* cached, float* warp_max, int N, bool vec, bool cache) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  float amax = 0.0f;
  if (vec) {
    const int pieces = N / E;
    for (int p = tid; p < pieces; p += NTHREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[p];
      if (cache) reinterpret_cast<uint4*>(cached)[p] = raw;
      float v[E];
      piece_values<T, SCALED>(raw, w, p * E, v);
#pragma unroll
      for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
  } else {
    for (int c = tid; c < N; c += NTHREADS) {
      const T e = xr[c];
      if (cache) cached[c] = e;
      const float v = SCALED ? __fmul_rn(to_f32(e), w[c]) : to_f32(e);
      amax = fmaxf(amax, fabsf(v));
    }
  }
  // max is exact in any order, so s is the plain version's to the bit.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  float m = warp_max[0];
#pragma unroll
  for (int i = 1; i < NTHREADS / 32; ++i) m = fmaxf(m, warp_max[i]);
  return m;
}

template <typename T, bool SCALED, int MODE>
__global__ void __launch_bounds__(NTHREADS)
row_quant_kernel(const T* __restrict__ x, const float* __restrict__ w, int8_t* __restrict__ q,
                 float* __restrict__ s, int N, bool vec, bool cache) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_max[NTHREADS / 32];
  __shared__ float row_scale;
  T* cached = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const T* xr = x + row * N;
  int8_t* qr = q + row * N;

  if (MODE == GIVEN) {
    if (tid == 0) row_scale = s[row];
  } else {
    const float m = row_absmax<T, SCALED>(xr, w, cached, warp_max, N, vec, cache);
    if (MODE == ABSMAX) {
      if (tid == 0) s[row] = m;
      return;
    }
    if (tid == 0) {
      const float sc = fmaxf(__fdiv_rn(m, 127.0f), 1e-12f);
      row_scale = sc;
      s[row] = sc;
    }
  }
  __syncthreads();
  const float sc = row_scale;

  const T* src = cache ? cached : xr;
  if (vec) {
    const int pieces = N / E;
    for (int p = tid; p < pieces; p += NTHREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[p];
      float v[E];
      piece_values<T, SCALED>(raw, w, p * E, v);
      const uint32_t lo = pack4(v[0], v[1], v[2], v[3], sc);
      if constexpr (E == 8) {
        reinterpret_cast<uint2*>(qr)[p] = make_uint2(lo, pack4(v[4], v[5], v[6], v[7], sc));
      } else {
        reinterpret_cast<uint32_t*>(qr)[p] = lo;
      }
    }
  } else {
    for (int c = tid; c < N; c += NTHREADS) {
      const float v = SCALED ? __fmul_rn(to_f32(src[c]), w[c]) : to_f32(src[c]);
      qr[c] = quant1(v, sc);
    }
  }
}

template <typename T, bool SCALED, int MODE>
int launch(const void* x, const float* w, void* q, void* s, int rows, int N, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  // 16-byte pieces need every row to start on 16 bytes (N % E == 0, an
  // aligned base) and the scales on 16 bytes too; q's rows then start on
  // E bytes.
  const bool vec = N % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (MODE == ABSMAX || reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                   (!SCALED || reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const size_t row_bytes = static_cast<size_t>(N) * sizeof(T);
  // Only a launch that makes both passes reads the row twice.
  const bool cache = MODE == FULL && row_bytes <= MAX_CACHED_BYTES;
  row_quant_kernel<T, SCALED, MODE><<<rows, NTHREADS, cache ? row_bytes : 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<int8_t*>(q), static_cast<float*>(s), N, vec, cache);
  return static_cast<int>(cudaGetLastError());
}

template <bool SCALED, int MODE>
int dispatch(const void* x, int dtype, const float* w, void* q, void* s, int rows, int N,
             void* stream) {
  if (rows <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<__nv_bfloat16, SCALED, MODE>(x, w, q, s, rows, N, st);
    case 1: return launch<float, SCALED, MODE>(x, w, q, s, rows, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE>
int dispatch_maybe_scaled(const void* x, int dtype, const void* w, void* q, void* s, int rows, int N,
                          void* stream) {
  const auto ws = static_cast<const float*>(w);
  return ws == nullptr ? dispatch<false, MODE>(x, dtype, nullptr, q, s, rows, N, stream)
                       : dispatch<true, MODE>(x, dtype, ws, q, s, rows, N, stream);
}

}  // namespace

// Plain-C launchers (bound with ctypes): the caller's current device and
// stream; x (rows, N) row-major, dtype 0 = bf16, 1 = f32; q (rows, N) int8
// and s (rows) f32 written. Each returns cudaGetLastError() after its
// launch.
extern "C" int row_quant_launch(const void* x, int dtype, void* q, void* s, int rows, int N,
                                void* stream) {
  return dispatch<false, FULL>(x, dtype, nullptr, q, s, rows, N, stream);
}

extern "C" int row_quant_scaled_launch(const void* x, int dtype, const void* w_scale, void* q,
                                       void* s, int rows, int N, void* stream) {
  return dispatch<true, FULL>(x, dtype, static_cast<const float*>(w_scale), q, s, rows, N, stream);
}

// The split quantization: amax (rows) f32 written with max|v| per row of x
// (times w_scale when it is not null); then q written from the scales s
// (rows) f32 that the caller made of the maxima reduced over the ranks.
extern "C" int row_absmax_launch(const void* x, int dtype, const void* w_scale, void* amax, int rows,
                                 int N, void* stream) {
  return dispatch_maybe_scaled<ABSMAX>(x, dtype, w_scale, nullptr, amax, rows, N, stream);
}

extern "C" int row_quant_given_launch(const void* x, int dtype, const void* w_scale, const void* s,
                                      void* q, int rows, int N, void* stream) {
  return dispatch_maybe_scaled<GIVEN>(x, dtype, w_scale, q, const_cast<void*>(s), rows, N, stream);
}
