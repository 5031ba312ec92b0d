// Divide probe kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/probe_divide.py (:45, called at :50):
// the in-kernel reciprocal 1/x and quotient a/x, whose rounding error the
// cull gate's margins budget for (regen.cu's safe_inv is an IEEE divide).
// Four forms of the same function, one per mode:
//
//   0 ieee:    `1.0f / x` and `a / x` as nvcc compiles them without
//              fast-math (-prec-div=true: correctly rounded), the form
//              safe_inv and the megakernel use;
//   1 rn:      __frcp_rn(x) and __fdiv_rn(a, x), the round-to-nearest
//              intrinsics (the same results as ieee);
//   2 fast:    __fdividef(1, x) and __fdividef(a, x) (documented to return
//              0 for 2^126 < |x| < 2^128);
//   3 approx:  rcp.approx.f32 in inline PTX, and a * rcp for a / x.
//
// What bounds it on this card: at size, bytes (two floats in and two out
// per element, one division each, far below the FP32 rate); at the
// probe's 1,024 elements, the launch's latency and the host's work per
// call. The design: each thread moves one group of four elements an
// array through 16-byte loads and 16-byte streaming stores (__stcs: the
// outputs are not read again), over a grid that covers every group, so
// the probe's 1,024 elements are one CTA of 256 threads and the
// 16,777,216-element timing set keeps a whole SM's threads of 16-byte
// loads in flight (a grid-stride loop over 528 or 1,056 CTAs measured
// 4-8% slower on the card). The n % 4 last elements are a scalar tail.
// Where one of the four pointers is not 16-byte aligned (an input viewed
// at an offset) the same body runs one element a thread with 4-byte
// accesses. The wrapper (ops/divide.py) takes the outputs from two
// empty_like calls (measured cheaper on the host than one allocation cut
// in two); the allocator aligns each block, so the 16-byte body runs
// wherever x and num are 16-byte aligned too.
//
// rt_divide_launch launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum Mode { kIeee = 0, kRn = 1, kFast = 2, kApprox = 3 };

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int kMode>
__device__ __forceinline__ void divide1(float xv, float a, float& r,
                                        float& q) {
  if constexpr (kMode == kIeee) {
    r = 1.0f / xv;
    q = a / xv;
  } else if constexpr (kMode == kRn) {
    r = __frcp_rn(xv);
    q = __fdiv_rn(a, xv);
  } else if constexpr (kMode == kFast) {
    r = __fdividef(1.0f, xv);
    q = __fdividef(a, xv);
  } else {
    r = rcp_approx(xv);
    q = a * r;
  }
}

// kVec: thread i takes elements 4i .. 4i + 3 (one float4 an array); the
// first n % 4 threads of block 0 take the tail. Otherwise thread i takes
// element i.
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads)
divide(const float* __restrict__ x, const float* __restrict__ num,
       float* __restrict__ recip, float* __restrict__ quot, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kVec) {
    const int groups = n / 4;
    if (i < groups) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + i);
      const float4 a = __ldg(reinterpret_cast<const float4*>(num) + i);
      float4 r, q;
      divide1<kMode>(xv.x, a.x, r.x, q.x);
      divide1<kMode>(xv.y, a.y, r.y, q.y);
      divide1<kMode>(xv.z, a.z, r.z, q.z);
      divide1<kMode>(xv.w, a.w, r.w, q.w);
      __stcs(reinterpret_cast<float4*>(recip) + i, r);
      __stcs(reinterpret_cast<float4*>(quot) + i, q);
    }
    const int t = 4 * groups + i;
    if (blockIdx.x == 0 && t < n) divide1<kMode>(x[t], num[t], recip[t], quot[t]);
  } else {
    if (i < n) divide1<kMode>(x[i], num[i], recip[i], quot[i]);
  }
}

template <int kMode>
int launch(const float* x, const float* a, float* r, float* q, int n,
           cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(q);
  if (any % 4 != 0) return (int)cudaErrorMisalignedAddress;
  if (any % 16 == 0) {
    const int groups = n / 4;
    const int grid = groups > 0 ? (groups + kThreads - 1) / kThreads : 1;
    divide<kMode, true><<<grid, kThreads, 0, s>>>(x, a, r, q, n);
  } else {
    divide<kMode, false><<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        x, a, r, q, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, num, recip, quot: f32 [n], 4-byte aligned (the 16-byte body where all
// four are 16-byte aligned); mode 0 ieee, 1 rn, 2 fast, 3 approx.
extern "C" int rt_divide_launch(const void* x, const void* num, void* recip,
                                void* quot, int n, int mode, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const float* xv = static_cast<const float*>(x);
  const float* a = static_cast<const float*>(num);
  float* r = static_cast<float*>(recip);
  float* q = static_cast<float*>(quot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kIeee: return launch<kIeee>(xv, a, r, q, n, s);
    case kRn: return launch<kRn>(xv, a, r, q, n, s);
    case kFast: return launch<kFast>(xv, a, r, q, n, s);
    case kApprox: return launch<kApprox>(xv, a, r, q, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
