// Dtype probe kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/probe_dtype.py:
//
//   bitcast_probe (:31, called at :40): pltpu.bitcast of an f32 (8, 128)
//     tile to int16 (16, 128). In interpret mode row 2r holds the low
//     halves of row r's words and row 2r+1 the high halves; this kernel
//     writes that layout for any [..., R, 128] f32 tensor. One thread takes
//     two neighbouring words and splits them in registers with __byte_perm
//     into one word of low halves and one of high halves (two 32-bit
//     stores). With a non-null `halves` it also writes which half of the
//     first word __nv_bfloat162.x and short2.x read.
//
//   rate_probe (:69, called at :96): per element, 8 streams
//     s_i = a + (b + b) * i, `iters` dependent steps of each, then the
//     streams summed in order (xor'ed for int16). Modes:
//       0 f32_fma      s = __fmaf_rn(s, b, s): one FFMA, rounded once (the
//                      sources build with -fmad=false, so `s * b + s`
//                      would be FMUL + FADD);
//       1 f32_select   s = (b > 0.5 ? s : b) + s: FSEL + FADD;
//       2 bf16_fma     __hfma2 on a __nv_bfloat162 pair;
//       3 bf16_select  the pair selected as one word by a mask word
//                      (__hgt2_mask(b, 0.5): bitwise, one LOP3), then
//                      __hadd2_rn;
//       4 i16_select   an int16 pair packed in one word: the same bitwise
//                      select by a mask word (__vcmpgts2(b, 0)), the add by
//                      __vadd2 (wrapping per half).
//     Every bf16 add and multiply rounds once (__hadd2_rn, __hmul2_rn), in
//     the set-up and the sum too; f32 set-up is FMUL then FADD, as the JAX
//     kernel writes it.
//
// What bounds it on this card: the rate modes are issue-bound by
// construction (8 independent chains a thread, no memory traffic inside
// the loop); the bitcast moves bytes. The design: one thread per 32-bit
// word (one f32, or one pair of 16-bit elements), so a (rows, 128) tile is
// rows x 128 threads for f32 and half as many words per row for 16-bit
// types; the caller fills the card by replicating the tile. `iters`, the
// mask and b are runtime values and the 8 chains stay live to the sum, so
// nothing folds; the main loop's body is kUnroll steps of the 8 chains,
// not unrolled further (tools/probe_dtype.py counts its SASS).
//
// rt_dtype_*_launch launch on the given stream and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kStreams = 8;
constexpr int kUnroll = 4;  // steps per main-loop body (rt_dtype_steps_per_body)
constexpr int kCols = 128;

enum Mode { kF32Fma = 0, kF32Select = 1, kBf16Fma = 2, kBf16Select = 3, kI16Select = 4 };

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 bf2_of(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}

// One step of one chain in mode kMode (init sets the loop invariants from
// b's word). f32 words are floats, 16-bit words hold a pair.
template <int kMode>
struct Chain;

template <>
struct Chain<kF32Fma> {
  using T = float;
  float b;
  __device__ __forceinline__ void init(uint32_t bw) { b = __uint_as_float(bw); }
  __device__ __forceinline__ float step(float s) const { return __fmaf_rn(s, b, s); }
};

template <>
struct Chain<kF32Select> {
  using T = float;
  float b;
  bool m;
  __device__ __forceinline__ void init(uint32_t bw) {
    b = __uint_as_float(bw);
    m = b > 0.5f;
  }
  __device__ __forceinline__ float step(float s) const { return (m ? s : b) + s; }
};

template <>
struct Chain<kBf16Fma> {
  using T = __nv_bfloat162;
  __nv_bfloat162 b;
  __device__ __forceinline__ void init(uint32_t bw) { b = bf2_of(bw); }
  __device__ __forceinline__ __nv_bfloat162 step(__nv_bfloat162 s) const {
    return __hfma2(s, b, s);
  }
};

template <>
struct Chain<kBf16Select> {
  using T = __nv_bfloat162;
  uint32_t b, m;
  __device__ __forceinline__ void init(uint32_t bw) {
    b = bw;
    m = __hgt2_mask(bf2_of(bw), __float2bfloat162_rn(0.5f));
  }
  __device__ __forceinline__ __nv_bfloat162 step(__nv_bfloat162 s) const {
    return __hadd2_rn(bf2_of((bits_of(s) & m) | (b & ~m)), s);
  }
};

template <>
struct Chain<kI16Select> {
  using T = uint32_t;
  uint32_t b, m;
  __device__ __forceinline__ void init(uint32_t bw) {
    b = bw;
    m = __vcmpgts2(bw, 0u);
  }
  __device__ __forceinline__ uint32_t step(uint32_t s) const {
    return __vadd2((s & m) | (b & ~m), s);
  }
};

// The 8 streams a + (b + b) * i of one word.
template <int kMode>
__device__ __forceinline__ void streams(uint32_t aw, uint32_t bw,
                                        typename Chain<kMode>::T (&s)[kStreams]) {
  if constexpr (kMode == kF32Fma || kMode == kF32Select) {
    const float a = __uint_as_float(aw), b = __uint_as_float(bw);
    const float bb = b + b;
#pragma unroll
    for (int i = 0; i < kStreams; ++i) s[i] = a + bb * static_cast<float>(i);
  } else if constexpr (kMode == kBf16Fma || kMode == kBf16Select) {
    const __nv_bfloat162 a = bf2_of(aw), b = bf2_of(bw);
    const __nv_bfloat162 bb = __hadd2_rn(b, b);
#pragma unroll
    for (int i = 0; i < kStreams; ++i)
      s[i] = __hadd2_rn(a, __hmul2_rn(bb, __float2bfloat162_rn(static_cast<float>(i))));
  } else {
    // int16 (b + b) * i wraps as i additions of b + b do.
    const uint32_t bb = __vadd2(bw, bw);
    s[0] = aw;
#pragma unroll
    for (int i = 1; i < kStreams; ++i) s[i] = __vadd2(s[i - 1], bb);
  }
}

template <int kMode>
__device__ __forceinline__ uint32_t reduce(const typename Chain<kMode>::T (&s)[kStreams]) {
  if constexpr (kMode == kF32Fma || kMode == kF32Select) {
    float acc = s[0];
#pragma unroll
    for (int i = 1; i < kStreams; ++i) acc = acc + s[i];
    return __float_as_uint(acc);
  } else if constexpr (kMode == kBf16Fma || kMode == kBf16Select) {
    __nv_bfloat162 acc = s[0];
#pragma unroll
    for (int i = 1; i < kStreams; ++i) acc = __hadd2_rn(acc, s[i]);
    return bits_of(acc);
  } else {
    uint32_t acc = s[0];
#pragma unroll
    for (int i = 1; i < kStreams; ++i) acc ^= s[i];
    return acc;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
rate_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
            uint32_t* __restrict__ out, int words, int iters) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  Chain<kMode> chain;
  chain.init(b[w]);
  typename Chain<kMode>::T s[kStreams];
  streams<kMode>(a[w], b[w], s);
  int k = 0;
#pragma unroll 1
  for (; k + kUnroll <= iters; k += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kStreams; ++i) s[i] = chain.step(s[i]);
    }
  }
#pragma unroll 1
  for (; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < kStreams; ++i) s[i] = chain.step(s[i]);
  }
  out[w] = reduce<kMode>(s);
}

// One thread per pair of neighbouring words (columns c, c + 1 of row r).
__global__ void __launch_bounds__(kThreads)
bitcast_kernel(const uint2* __restrict__ x, uint32_t* __restrict__ out,
               uint32_t* __restrict__ halves, int pairs) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const uint2 v = x[p];
  const int row = (2 * p) / kCols, c = (2 * p) % kCols;
  // int16 rows 2r (low halves) and 2r + 1 (high halves), columns c, c + 1.
  out[row * kCols + c / 2] = __byte_perm(v.x, v.y, 0x5410);
  out[row * kCols + kCols / 2 + c / 2] = __byte_perm(v.x, v.y, 0x7632);
  if (halves != nullptr && p == 0) {
    const __nv_bfloat162 h = bf2_of(v.x);
    short2 s2;
    memcpy(&s2, &v.x, 4);
    halves[0] = __bfloat16_as_ushort(h.x);
    halves[1] = static_cast<uint16_t>(s2.x);
  }
}

}  // namespace

// x: f32 [words] (rows of 128); out: int16 [2 * words]; halves: int32 [2]
// or null.
extern "C" int rt_dtype_bitcast_launch(const void* x, void* out, void* halves,
                                       int words, void* stream) {
  if (words <= 0 || words % kCols != 0) return (int)cudaErrorInvalidValue;
  const int pairs = words / 2;
  const int grid = (pairs + kThreads - 1) / kThreads;
  bitcast_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(x), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(halves), pairs);
  return (int)cudaGetLastError();
}

// a, b, out: [words] 32-bit words of the mode's type; mode 0 f32_fma,
// 1 f32_select, 2 bf16_fma, 3 bf16_select, 4 i16_select.
extern "C" int rt_dtype_rate_launch(const void* a, const void* b, void* out,
                                    int words, int mode, int iters,
                                    void* stream) {
  if (words <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const uint32_t* av = static_cast<const uint32_t*>(a);
  const uint32_t* bv = static_cast<const uint32_t*>(b);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (words + kThreads - 1) / kThreads;
  switch (mode) {
    case kF32Fma: rate_kernel<kF32Fma><<<grid, kThreads, 0, s>>>(av, bv, o, words, iters); break;
    case kF32Select: rate_kernel<kF32Select><<<grid, kThreads, 0, s>>>(av, bv, o, words, iters); break;
    case kBf16Fma: rate_kernel<kBf16Fma><<<grid, kThreads, 0, s>>>(av, bv, o, words, iters); break;
    case kBf16Select: rate_kernel<kBf16Select><<<grid, kThreads, 0, s>>>(av, bv, o, words, iters); break;
    case kI16Select: rate_kernel<kI16Select><<<grid, kThreads, 0, s>>>(av, bv, o, words, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Steps of every stream in one body of the rate kernel's main loop, for
// the SASS count per step.
extern "C" int rt_dtype_steps_per_body() { return kUnroll; }

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
