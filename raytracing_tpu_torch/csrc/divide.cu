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
// What bounds it on this card: bytes (two floats in and two out per
// element, one division each). The probe's 1,024 elements are one launch's
// worth of latency; the design is one thread an element.
//
// rt_divide_launch launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Mode { kIeee = 0, kRn = 1, kFast = 2, kApprox = 3 };

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
divide(const float* __restrict__ x, const float* __restrict__ num,
       float* __restrict__ recip, float* __restrict__ quot, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  const float a = num[i];
  if constexpr (kMode == kIeee) {
    recip[i] = 1.0f / xv;
    quot[i] = a / xv;
  } else if constexpr (kMode == kRn) {
    recip[i] = __frcp_rn(xv);
    quot[i] = __fdiv_rn(a, xv);
  } else if constexpr (kMode == kFast) {
    recip[i] = __fdividef(1.0f, xv);
    quot[i] = __fdividef(a, xv);
  } else {
    const float r = rcp_approx(xv);
    recip[i] = r;
    quot[i] = a * r;
  }
}

}  // namespace

// x, num, recip, quot: f32 [n]; mode 0 ieee, 1 rn, 2 fast, 3 approx.
extern "C" int rt_divide_launch(const void* x, const void* num, void* recip,
                                void* quot, int n, int mode, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const float* xv = static_cast<const float*>(x);
  const float* a = static_cast<const float*>(num);
  float* r = static_cast<float*>(recip);
  float* q = static_cast<float*>(quot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + kThreads - 1) / kThreads;
  switch (mode) {
    case kIeee: divide<kIeee><<<grid, kThreads, 0, s>>>(xv, a, r, q, n); break;
    case kRn: divide<kRn><<<grid, kThreads, 0, s>>>(xv, a, r, q, n); break;
    case kFast: divide<kFast><<<grid, kThreads, 0, s>>>(xv, a, r, q, n); break;
    case kApprox: divide<kApprox><<<grid, kThreads, 0, s>>>(xv, a, r, q, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
