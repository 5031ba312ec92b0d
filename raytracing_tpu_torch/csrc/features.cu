// Feature probe kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the four TPU feature probes of scripts/toolchain_watch.py, each
// a kernel that a TPU toolchain either lowers or refuses; on Hopper each is
// a plain instruction sequence. Modes, each on the probe's own shapes
// (replicated over `units` tiles to fill the card):
//
//   0 bf16_cmp      (_probe_bf16_vector_cmp :66, call :81): x > bf16(0.5)
//                   on a bf16 (8, 128) tile, as f32 0/1. Eight values a
//                   vector: one 16-byte load, four __hgt2, two 16-byte
//                   streaming stores (__stcs), one vector a thread (two
//                   a thread, both loads issued first, measured 11-17%
//                   slower on the card). Any 2-byte aligned x: the values
//                   before its first 16-byte boundary and after its last
//                   whole vector are a scalar head and tail; the wrapper
//                   places the output so that out + head is 16-byte
//                   aligned too.
//   1 i16_relayout  (_probe_i16_mask_relayout :89, call :108): the f32
//                   (8, 128) tile seen as int16 (16, 128) (rows 2r, 2r + 1
//                   the low and high halves of row r), per column rows
//                   8-15 where s[0, c] > 0 else rows 0-7, seen as f32
//                   (4, 128) again. Output word (q, c) is made of int16 rows
//                   2q, 2q + 1, whose halves come from f32 row 4 + q or q:
//                   one thread an output word selects both halves at once
//                   with the column's mask word (a bitwise select).
//   2 i16_hoisted   (_probe_i16_hoisted_mask :123, call :144): the same
//                   select with the probe's mask: m32 = 0 - ((s >> 1) & 1),
//                   seen as int16 halves, each < 0 (__vcmplts2 gives the
//                   per-half mask word).
//   3 dyn_gather    (_probe_dynamic_gather :151, call :169): out[r][c] =
//                   tab[idx[r][c]][c] for a (64, 128) f32 table and (8, 128)
//                   indices in [0, 64) (NaN for an index outside, with
//                   no read). One CTA a tile stages the table in
//                   shared memory (16-byte loads), then each lane loads its
//                   own row: lane c reads column c, so the 32 lanes of a
//                   warp hit 32 banks whatever the indices.
//
// What bounds it on this card: bytes (each tile read once, the result
// written once); the work per byte is a compare or a select. At the
// probes' few thousand tiles a call is a few tens of microseconds, so the
// host's work per launch (ops/features.py keeps it to an allocation and
// the ctypes call) matters as much as the body.
//
// rt_features_launch launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;
constexpr int kRows = 8;         // rows of the f32 / index tile
constexpr int kTabRows = 64;     // rows of the gather table

enum Mode { kBf16Cmp = 0, kI16Relayout = 1, kI16Hoisted = 2, kDynGather = 3 };

// x > 0.5 of the bf16 pair in word w, as two floats.
__device__ __forceinline__ float2 cmp2(uint32_t w) {
  __nv_bfloat162 v;
  memcpy(&v, &w, 4);
  return __bfloat1622float2(__hgt2(v, __float2bfloat162_rn(0.5f)));
}

// n values; x + head and out + head 16-byte aligned (head < 8). Thread v
// takes vector v (values head + 8v ..); block 0 also the head and the
// tail.
__global__ void __launch_bounds__(kThreads)
bf16_cmp(const __nv_bfloat16* __restrict__ x, float* __restrict__ out, int n,
         int head) {
  const int vecs = (n - head) / 8;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v < vecs) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(x + head) + v);
    const float2 a = cmp2(w.x), b = cmp2(w.y), c = cmp2(w.z), d = cmp2(w.w);
    float4* ov = reinterpret_cast<float4*>(out + head) + 2 * v;
    __stcs(ov, make_float4(a.x, a.y, b.x, b.y));
    __stcs(ov + 1, make_float4(c.x, c.y, d.x, d.y));
  }
  if (blockIdx.x == 0) {
    const __nv_bfloat16 half = __float2bfloat16_rn(0.5f);
    const int t = threadIdx.x, tail = head + 8 * vecs;
    if (t < head) out[t] = __hgt(x[t], half) ? 1.0f : 0.0f;
    if (tail + t < n) out[tail + t] = __hgt(x[tail + t], half) ? 1.0f : 0.0f;
  }
}

// One thread per output word (unit u, row q of 4, column c).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
i16_select(const uint32_t* __restrict__ x, const int32_t* __restrict__ s,
           uint32_t* __restrict__ out, int words) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  const int c = w % kCols, q = (w / kCols) % (kRows / 2), u = w / (kCols * kRows / 2);
  const uint32_t* tile = x + u * kRows * kCols;
  const int32_t sv = s[u * kCols + c];
  uint32_t m;
  if constexpr (kMode == kI16Relayout) {
    m = sv > 0 ? 0xFFFFFFFFu : 0u;  // the (1, 128) i1 mask on both halves
  } else {
    const uint32_t m32 = 0u - static_cast<uint32_t>((sv >> 1) & 1);
    m = __vcmplts2(m32, 0u);        // each int16 half of m32 < 0
  }
  const uint32_t hi = tile[(kRows / 2 + q) * kCols + c];  // int16 rows 8-15
  const uint32_t lo = tile[q * kCols + c];                // int16 rows 0-7
  out[w] = (hi & m) | (lo & ~m);
}

__global__ void __launch_bounds__(kThreads)
dyn_gather(const float4* __restrict__ tab, const int32_t* __restrict__ idx,
           float* __restrict__ out) {
  __shared__ float4 t[kTabRows * kCols / 4];
  const int u = blockIdx.x;
  const float4* src = tab + static_cast<size_t>(u) * kTabRows * kCols / 4;
  for (int k = threadIdx.x; k < kTabRows * kCols / 4; k += kThreads) t[k] = src[k];
  __syncthreads();
  const float* ts = reinterpret_cast<const float*>(t);
  const size_t base = static_cast<size_t>(u) * kRows * kCols;
  for (int k = threadIdx.x; k < kRows * kCols; k += kThreads) {
    const int c = k % kCols;
    const int r = idx[base + k];
    out[base + k] = (r >= 0 && r < kTabRows) ? ts[r * kCols + c] : __int_as_float(0x7fc00000);
  }
}

}  // namespace

// units tiles; mode 0 bf16_cmp (a: bf16 [units, 8, 128], 2-byte aligned;
// out: f32 of that shape, 16-byte aligned at the value where a is), 1
// i16_relayout and 2 i16_hoisted (a: f32 [units, 8, 128], b:
// int32 [units, 1, 128], out: f32 [units, 4, 128]), 3 dyn_gather (a: f32
// [units, 64, 128], 16-byte aligned, b: int32 [units, 8, 128] in [0, 64),
// out: f32 [units, 8, 128]).
extern "C" int rt_features_launch(const void* a, const void* b, void* out,
                                  int units, int mode, void* stream) {
  if (units <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBf16Cmp: {
      const int n = units * kRows * kCols;
      const uintptr_t xa = reinterpret_cast<uintptr_t>(a);
      const int head = static_cast<int>((16 - xa % 16) % 16 / 2);
      const uintptr_t oa = reinterpret_cast<uintptr_t>(out) + 4 * head;
      if (xa % 2 != 0 || oa % 16 != 0) return (int)cudaErrorMisalignedAddress;
      const int grid = ((n - head) / 8 + kThreads - 1) / kThreads;
      bf16_cmp<<<grid > 0 ? grid : 1, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<float*>(out), n,
          head);
      break;
    }
    case kI16Relayout:
    case kI16Hoisted: {
      const int words = units * kRows / 2 * kCols;
      const int grid = (words + kThreads - 1) / kThreads;
      const uint32_t* x = static_cast<const uint32_t*>(a);
      const int32_t* s = static_cast<const int32_t*>(b);
      uint32_t* o = static_cast<uint32_t*>(out);
      if (mode == kI16Relayout)
        i16_select<kI16Relayout><<<grid, kThreads, 0, st>>>(x, s, o, words);
      else
        i16_select<kI16Hoisted><<<grid, kThreads, 0, st>>>(x, s, o, words);
      break;
    }
    case kDynGather:
      dyn_gather<<<units, kThreads, 0, st>>>(static_cast<const float4*>(a),
                                             static_cast<const int32_t*>(b),
                                             static_cast<float*>(out));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
