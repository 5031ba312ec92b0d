// Standalone winner fetch for NVIDIA Hopper (sm_90a): the words of row
// sel[g] of an int32 table [n_rows, C], for every lane g, in three forms.
//
// Replaces the JAX package's fetch test kernel (tests/test_pallas.py:418,
// the radix fetch against the one-hot fetch, bit for bit) and its fetch
// probes (scripts/probe_mxu_gather.py:40, probe_mxu_chain.py:37,
// probe_mxu_loop.py:47, probe_fold.py:122,158), which ran _gather_cols
// (raytracing_tpu/ops/pallas/trace.py:1144) and _gather_mxu (:1225):
//
//   mode 0 "index":   an indexed load per lane;
//   mode 1 "radix":   the tournament of fetch.cuh, the routine regen.cu's
//                     RT_GATHER=radix route runs, on 32-bit words;
//   mode 3 "radix16": the same tournament on two 16-bit halves per
//                     register, selected with __byte_perm (probe_fold's
//                     i16 question on this card);
//   mode 2 "onehot":  float32-exact byte planes times a one-hot matrix on
//                     the tensor cores: mma.sync m16n8k16 bf16 with f32
//                     accumulation. A byte (0..255) is exact in bf16 and
//                     the one-hot entries are 0 or 1, so every sum holds
//                     one nonzero product and reproduces its byte; words
//                     are rebuilt as ((p3*256 + p2) << 16) | (p1*256 + p0)
//                     in int32, as _gather_mxu does.
//
// With iters > 1 the selection is fed back as probe_mxu_loop.py does:
// h ^= every word fetched; sel = (|h| + k) & (n_rows - 1); out holds the
// last fetch's words.
//
// What bounds it on this card: the index mode moves the selections, C
// words a lane and the table once (bytes). The radix and one-hot modes do
// O(n_rows) work per lane by design (n_rows * C selects, or n_rows / 16
// mma steps per 16 plane rows): they are bound by instruction throughput,
// and exist to hold the route and to measure it. The table stays in L1/L2
// (one row is read by every lane of a warp at once) and the one-hot mode
// stages bf16 plane chunks in shared memory, read conflict-free by the
// fragments.
//
// The kernel allocates nothing; rt_fetch_launch launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fetch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCols = 16;
// One-hot mode: table rows staged per chunk, and the bf16 row stride of
// the staged planes (8 extra halves keep fragment loads conflict-free).
constexpr int kChunk = 128;
constexpr int kPlaneStride = kChunk + 8;
constexpr int kTileStride = 33;  // f32 words per plane row of the output tile

// The next selection of the iterated fetch, in int32 arithmetic.
__device__ __forceinline__ int next_sel(int h, int k, int n_rows) {
  const uint32_t habs = h < 0 ? 0u - (uint32_t)h : (uint32_t)h;
  return (int)((habs + (uint32_t)k) & (uint32_t)(n_rows - 1));
}

__global__ void __launch_bounds__(kThreads)
fetch_index(const int* __restrict__ table, int n_rows, int cols,
            const int* __restrict__ sel, int g_count, int* __restrict__ out,
            int iters) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= g_count) return;
  int s = sel[g];
  int h = 0;
  for (int k = 0; k < iters; ++k) {
    const int* row = table + (size_t)s * cols;
    for (int c = 0; c < cols; ++c) {
      const int w = row[c];
      h ^= w;
      if (k == iters - 1) out[(size_t)c * g_count + g] = w;
    }
    s = next_sel(h, k, n_rows);
  }
}

template <int C, bool k16>
__global__ void __launch_bounds__(kThreads)
fetch_radix(const int* __restrict__ table, int n_rows,
            const int* __restrict__ sel, int g_count, int* __restrict__ out,
            int iters) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  // Ragged lanes run the loop too (on row 0), so every lane of a warp
  // reads the same row at the same time; they store nothing.
  const bool valid = g < g_count;
  int s = valid ? sel[g] : 0;
  int h = 0;
  auto get = [&](int i) {
    rtfetch::Words<C> w;
    const int* row = table + (size_t)i * C;
#pragma unroll
    for (int c = 0; c < C; ++c) w.v[c] = __ldg(row + c);
    return w;
  };
  rtfetch::Words<C> w;
  for (int k = 0; k < iters; ++k) {
    w = rtfetch::radix_select<C, k16>(n_rows, s, get);
#pragma unroll
    for (int c = 0; c < C; ++c) h ^= w.v[c];
    s = next_sel(h, k, n_rows);
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[(size_t)c * g_count + g] = w.v[c];
  }
}

// bf16 bit pattern of a byte value: float(b) has at most 8 significant
// bits, so its top 16 bits are the exact bf16.
__device__ __forceinline__ uint32_t bf16_of_byte(uint32_t b) {
  return __float_as_uint((float)b) >> 16;
}

// One-hot mode. A block of 4 warps serves 128 lanes, a warp 32 lanes as
// four n-tiles of 8. Per chunk of kChunk table rows the block stages the
// plane matrix A [16 * kMt, kChunk] (row 4c + b = byte b of column c) in
// bf16; each warp multiplies it by its one-hot B [kChunk, 8] per n-tile,
// built in registers from the lanes' selections, into f32 accumulators
// D [16 * kMt, 8]. At the end the accumulators go through shared memory
// so that each thread rebuilds the words of one lane.
template <int kMt>
__global__ void __launch_bounds__(kThreads)
fetch_onehot(const int* __restrict__ table, int n_rows, int cols,
             const int* __restrict__ sel, int g_count, int* __restrict__ out,
             int iters) {
  constexpr int kRows = 16 * kMt;
  __shared__ union {
    uint16_t planes[kRows][kPlaneStride];
    float tile[kThreads / 32][kRows][kTileStride];
  } sm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;  // groupID: A row, B column (n), D row
  const int tig = lane & 3;   // thread in group: A/B k pair, D column pair
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = g < g_count;
  int s = valid ? sel[g] : -1;  // -1 matches no row
  int h = 0;
  int words[kMaxCols];

  for (int k = 0; k < iters; ++k) {
    // Selections of this thread's B columns: lane grp of each n-tile.
    int sel_n[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) sel_n[nt] = __shfl_sync(0xFFFFFFFFu, s, nt * 8 + grp);
    float acc[kMt][4][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    for (int k0 = 0; k0 < n_rows; k0 += kChunk) {
      __syncthreads();  // the previous chunk (or tile) is no longer read
      // One word per (column, row); its four bytes go to four plane rows.
      // Columns past `cols` fill the last m-tile with zeros.
      for (int idx = threadIdx.x; idx < (kRows / 4) * kChunk;
           idx += kThreads) {
        const int c = idx / kChunk;
        const int kk = idx - c * kChunk;
        const int row = k0 + kk;
        uint32_t w = 0;
        if (c < cols && row < n_rows) {
          w = (uint32_t)__ldg(table + (size_t)row * cols + c);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sm.planes[4 * c + b][kk] = (uint16_t)bf16_of_byte((w >> (8 * b)) & 0xFFu);
        }
      }
      __syncthreads();
      for (int ks = 0; ks < kChunk; ks += 16) {
        uint32_t a[kMt][4];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          const int r0 = mt * 16 + grp;
          const int c0 = ks + 2 * tig;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(&sm.planes[r0][c0]);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(&sm.planes[r0 + 8][c0]);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(&sm.planes[r0][c0 + 8]);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(&sm.planes[r0 + 8][c0 + 8]);
        }
        const int kr = k0 + ks + 2 * tig;  // table rows of b0, b1 (+8: b2, b3)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t one = 0x3F80u;  // bf16 1.0
          const uint32_t b0 = (kr == sel_n[nt] ? one : 0u) |
                              ((kr + 1 == sel_n[nt] ? one : 0u) << 16);
          const uint32_t b1 = (kr + 8 == sel_n[nt] ? one : 0u) |
                              ((kr + 9 == sel_n[nt] ? one : 0u) << 16);
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};\n"
                : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]),
                  "+f"(acc[mt][nt][2]), "+f"(acc[mt][nt][3])
                : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]),
                  "r"(a[mt][3]), "r"(b0), "r"(b1));
          }
        }
      }
    }

    // D fragment: d0, d1 at (row grp, cols 2 tig, 2 tig + 1), d2, d3 at
    // row grp + 8; column n of n-tile nt is lane nt * 8 + n of the warp.
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r0 = mt * 16 + grp;
        const int n0 = nt * 8 + 2 * tig;
        sm.tile[warp][r0][n0] = acc[mt][nt][0];
        sm.tile[warp][r0][n0 + 1] = acc[mt][nt][1];
        sm.tile[warp][r0 + 8][n0] = acc[mt][nt][2];
        sm.tile[warp][r0 + 8][n0 + 1] = acc[mt][nt][3];
      }
    __syncwarp();
    for (int c = 0; c < cols; ++c) {
      const float p0 = sm.tile[warp][4 * c + 0][lane];
      const float p1 = sm.tile[warp][4 * c + 1][lane];
      const float p2 = sm.tile[warp][4 * c + 2][lane];
      const float p3 = sm.tile[warp][4 * c + 3][lane];
      const uint32_t hi = (uint32_t)(int)(p3 * 256.0f + p2);
      const uint32_t lo = (uint32_t)(int)(p1 * 256.0f + p0);
      words[c] = (int)((hi << 16) | lo);
      h ^= words[c];
    }
    if (valid) s = next_sel(h, k, n_rows);
  }
  if (valid) {
    for (int c = 0; c < cols; ++c) out[(size_t)c * g_count + g] = words[c];
  }
}

template <int C>
int launch_radix(const int* table, int n_rows, const int* sel, int g,
                 int* out, int iters, bool k16, cudaStream_t s) {
  const dim3 grid((g + kThreads - 1) / kThreads);
  if (k16) {
    fetch_radix<C, true><<<grid, kThreads, 0, s>>>(table, n_rows, sel, g,
                                                   out, iters);
  } else {
    fetch_radix<C, false><<<grid, kThreads, 0, s>>>(table, n_rows, sel, g,
                                                    out, iters);
  }
  return (int)cudaGetLastError();
}

int radix_cols(int cols, const int* table, int n_rows, const int* sel, int g,
               int* out, int iters, bool k16, cudaStream_t s) {
  switch (cols) {
#define RT_FETCH_COLS(C) \
  case C: return launch_radix<C>(table, n_rows, sel, g, out, iters, k16, s);
    RT_FETCH_COLS(1) RT_FETCH_COLS(2) RT_FETCH_COLS(3) RT_FETCH_COLS(4)
    RT_FETCH_COLS(5) RT_FETCH_COLS(6) RT_FETCH_COLS(7) RT_FETCH_COLS(8)
    RT_FETCH_COLS(9) RT_FETCH_COLS(10) RT_FETCH_COLS(11) RT_FETCH_COLS(12)
    RT_FETCH_COLS(13) RT_FETCH_COLS(14) RT_FETCH_COLS(15) RT_FETCH_COLS(16)
#undef RT_FETCH_COLS
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// table int32 [n_rows, cols] (n_rows a power of two, cols in [1, 16]),
// sel int32 [g] (values in [0, n_rows)), out int32 [cols, g]; mode 0
// index, 1 radix, 2 onehot, 3 radix16; iters >= 1.
extern "C" int rt_fetch_launch(const void* table, int n_rows, int cols,
                               const void* sel, int g, void* out, int mode,
                               int iters, void* stream) {
  if (n_rows < 1 || (n_rows & (n_rows - 1)) != 0 || cols < 1 ||
      cols > kMaxCols || g < 1 || iters < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int* t = static_cast<const int*>(table);
  const int* sl = static_cast<const int*>(sel);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((g + kThreads - 1) / kThreads);
  switch (mode) {
    case 0:
      fetch_index<<<grid, kThreads, 0, s>>>(t, n_rows, cols, sl, g, o, iters);
      return (int)cudaGetLastError();
    case 1:
    case 3:
      return radix_cols(cols, t, n_rows, sl, g, o, iters, mode == 3, s);
    case 2:
      switch ((4 * cols + 15) / 16) {
        case 1: fetch_onehot<1><<<grid, kThreads, 0, s>>>(t, n_rows, cols, sl, g, o, iters); break;
        case 2: fetch_onehot<2><<<grid, kThreads, 0, s>>>(t, n_rows, cols, sl, g, o, iters); break;
        case 3: fetch_onehot<3><<<grid, kThreads, 0, s>>>(t, n_rows, cols, sl, g, o, iters); break;
        default: fetch_onehot<4><<<grid, kThreads, 0, s>>>(t, n_rows, cols, sl, g, o, iters); break;
      }
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
