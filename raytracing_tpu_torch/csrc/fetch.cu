// Standalone winner fetch for NVIDIA Hopper (sm_90a): the words of row
// sel[g] of an int32 table [n_rows, C], for every lane g, in three forms.
//
// Replaces the JAX package's fetch test kernel (tests/test_pallas.py:418,
// the radix fetch against the one-hot fetch, bit for bit) and its fetch
// probes (scripts/probe_mxu_gather.py:40, probe_mxu_chain.py:37,
// probe_mxu_loop.py:47, probe_fold.py:122,158), which ran _gather_cols
// (raytracing_tpu/ops/pallas/trace.py:1144) and _gather_mxu (:1225) on a
// plane table _plane_table_int (:1400) built outside the kernel:
//
//   mode 0 "index":   an indexed load per lane. Bound by bytes: the
//                     selections, C words a lane and the table once.
//   mode 1 "radix":   fetch.cuh's warp exchange, the routine regen.cu's
//                     RT_GATHER=radix route runs: a warp walks the table
//                     in 32-row chunks, lane k reading row i0 + k, and each
//                     word moves by a shuffle from the lane that read the
//                     selected row. Bound by instruction issue: n_rows / 32
//                     chunks of C loads, C shuffles and C selects a lane
//                     (the TPU's sweep did n_rows * C). Ragged lanes
//                     (g >= count) return first and are not in the group.
//   mode 3 "radix16": the same exchange, kept as two 16-bit halves per
//                     register selected with __byte_perm (probe_fold's i16
//                     question on this card): the same instruction count.
//   mode 2 "onehot":  byte planes times a one-hot matrix on the tensor
//                     cores, as _gather_mxu does: a byte (0..255) is exact
//                     in bf16 and the one-hot entries are 0 or 1, so every
//                     f32 sum holds one nonzero product and reproduces its
//                     byte; words are rebuilt as
//                     ((p3*256 + p2) << 16) | (p1*256 + p0) in int32.
//
// The one-hot mode in two kernels. A prepass (fetch_planes, the
// counterpart of _plane_table_int) writes the bf16 planes B [K = rows
// rounded up to 128, N = 4C rounded up to 8] once per call into a scratch
// tensor, in the layout wgmma reads from shared memory (K-major 8x8 core
// matrices, no swizzle). The product (fetch_onehot) runs persistent CTAs
// of four warpgroups, about one a SM, each warpgroup walking 64-lane
// tiles: wgmma.mma_async m64nNk16 bf16 -> f32 with A, the one-hot, built
// in registers from the lanes' selections and B from shared memory
// through a descriptor, two batches of k16 steps in flight. The planes stay resident in shared memory while
// they fit (cover: 512 x 24 x 2 B = 24 KB); otherwise (stress:8192: 384
// KB) they stream in K chunks by TMA bulk copies into two buffers with
// mbarriers, the next chunk in flight while the warpgroups multiply this
// one, and the CTA's warpgroups walk their tiles in lock step so that each
// streamed chunk serves 512 lanes. The epilogue rebuilds each 16-bit half
// in the thread that holds its two byte columns and pairs the halves by a
// shuffle. What bounds it: the tensor cores' rate on rows x N x 2 FLOP a
// lane, and the one-hot build (a few integer instructions per 16 rows).
//
// With iters > 1 the selection is fed back as probe_mxu_loop.py does:
// h ^= every word fetched; sel = (|h| + k) & (n_rows - 1); out holds the
// last fetch's words. The one-hot mode runs the loop inside the tile with
// the planes resident (or streamed again per fetch).
//
// The kernels allocate nothing; the launch functions launch on the given
// stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fetch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCols = 16;
// One-hot mode: warpgroups a CTA, 64-lane tiles a warpgroup holds at a
// time, the planes' largest resident size and a streamed chunk's size.
constexpr int kOhGroups = 4;
constexpr int kOhThreads = 128 * kOhGroups;
constexpr int kOhTiles = 2;
constexpr int kOhResidentBytes = 160 * 1024;
constexpr int kOhChunkBytes = 32 * 1024;
constexpr int kOhBarBytes = 128;  // the two mbarriers, padded
// Plane rows are padded to whole pairs of batches of k16 steps (2 x 4 x 16).
constexpr int kOhKAlign = 128;

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

// Words [0, C) of table row i, in the widest loads the row's alignment
// allows (rows of C int32 words from a 16-byte aligned base).
template <int C>
__device__ __forceinline__ rtfetch::Words<C> load_row(const int* table,
                                                      int i) {
  rtfetch::Words<C> w;
  const int* row = table + (size_t)i * C;
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + c));
      w.v[c] = v.x;
      w.v[c + 1] = v.y;
      w.v[c + 2] = v.z;
      w.v[c + 3] = v.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(row + c));
      w.v[c] = v.x;
      w.v[c + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) w.v[c] = __ldg(row + c);
  }
  return w;
}

template <int C, bool k16>
__global__ void __launch_bounds__(kThreads)
fetch_radix(const int* __restrict__ table, int n_rows,
            const int* __restrict__ sel, int g_count, int* __restrict__ out,
            int iters) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= g_count) return;  // not in the last warp's group
  int s = sel[g];
  int h = 0;
  const auto get = [&](int i) { return load_row<C>(table, i); };
  rtfetch::Words<C> w;
  for (int k = 0; k < iters; ++k) {
    w = rtfetch::radix_select<C, k16>(n_rows, s, get);
#pragma unroll
    for (int c = 0; c < C; ++c) h ^= w.v[c];
    s = next_sel(h, k, n_rows);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)c * g_count + g] = w.v[c];
}

// ---------------------------------------------------------------------------
// One-hot mode: the plane prepass and the wgmma product
// ---------------------------------------------------------------------------

// bf16 bit pattern of a byte value: float(b) has at most 8 significant
// bits, so its top 16 bits are the exact bf16.
__device__ __forceinline__ uint32_t bf16_of_byte(uint32_t b) {
  return __float_as_uint((float)b) >> 16;
}

// Plane P[k][n] = byte n % 4 of table word [k][n / 4] as bf16 (0 past the
// table's rows and columns), stored as K-major core matrices: core (kb,
// nb) = rows 8nb.. of n by columns 8kb.. of k, 128 contiguous bytes at
// ((kb * N/8) + nb) * 128, its row n % 8 at 16-byte stride. A thread
// writes one 16-byte core row: 8 values of k for one n.
__global__ void __launch_bounds__(kThreads)
fetch_planes(const int* __restrict__ table, int n_rows, int cols, int n_pad,
             int k_pad, uint4* __restrict__ planes) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (k_pad / 8) * n_pad) return;
  const int kb = idx / n_pad;
  const int n = idx - kb * n_pad;
  const int c = n >> 2;
  const int shift = 8 * (n & 3);
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = 8 * kb + e;
    const uint32_t w =
        (c < cols && k < n_rows) ? (uint32_t)__ldg(table + (size_t)k * cols + c)
                                 : 0u;
    h[e] = bf16_of_byte((w >> shift) & 0xFFu);
  }
  planes[((size_t)kb * (n_pad / 8) + (n >> 3)) * 8 + (n & 7)] =
      make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                 h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Arm `bar` for `bytes` and copy them from global `src` to shared `dst`
// by the TMA unit (one thread).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Spins until the phase of `bar` with this parity has completed (the loop
// stays inside the asm, so the compiler sees no divergent path).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Pins accumulator registers around the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of B's k16 slice at `addr`: no swizzle, K-major
// core matrices, the next core along K (leading) 16 * N bytes on, along N
// (stride) 128 bytes on.
template <int N>
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((16 * N) >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// D[64, N] += A[64, 16] (bf16 registers) x B[16, N] (shared memory):
// wgmma.mma_async m64nNk16, f32 accumulators. One instruction text for
// every N: A's four registers, the descriptor and the scale-d flag come
// first (%0-%5, read-write so that their numbers do not depend on N),
// then the N / 2 accumulators from %6, listed four at a time.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

#define RT_D4(i0, i1, i2, i3) "%" #i0 ", %" #i1 ", %" #i2 ", %" #i3
#define RT_ACC_8 RT_D4(6, 7, 8, 9)
#define RT_ACC_16 RT_ACC_8 ", " RT_D4(10, 11, 12, 13)
#define RT_ACC_24 RT_ACC_16 ", " RT_D4(14, 15, 16, 17)
#define RT_ACC_32 RT_ACC_24 ", " RT_D4(18, 19, 20, 21)
#define RT_ACC_40 RT_ACC_32 ", " RT_D4(22, 23, 24, 25)
#define RT_ACC_48 RT_ACC_40 ", " RT_D4(26, 27, 28, 29)
#define RT_ACC_56 RT_ACC_48 ", " RT_D4(30, 31, 32, 33)
#define RT_ACC_64 RT_ACC_56 ", " RT_D4(34, 35, 36, 37)
#define RT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RT_OUT_8 RT_F4(0)
#define RT_OUT_16 RT_OUT_8, RT_F4(4)
#define RT_OUT_24 RT_OUT_16, RT_F4(8)
#define RT_OUT_32 RT_OUT_24, RT_F4(12)
#define RT_OUT_40 RT_OUT_32, RT_F4(16)
#define RT_OUT_48 RT_OUT_40, RT_F4(20)
#define RT_OUT_56 RT_OUT_48, RT_F4(24)
#define RT_OUT_64 RT_OUT_56, RT_F4(28)
#define RT_WGMMA_RS(N)                                                        \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_rs<N>(                                \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {             \
    uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3], scale_d = 1;         \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                           \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" RT_ACC_##N \
        "}, {%0, %1, %2, %3}, %4, p, 1, 1, 0;\n}\n"                            \
        : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+l"(desc), "+r"(scale_d),  \
          RT_OUT_##N);                                                        \
  }
RT_WGMMA_RS(8) RT_WGMMA_RS(16) RT_WGMMA_RS(24) RT_WGMMA_RS(32)
RT_WGMMA_RS(40) RT_WGMMA_RS(48) RT_WGMMA_RS(56) RT_WGMMA_RS(64)
#undef RT_WGMMA_RS

// A pair of one-hot bf16 entries (k, k + 1) of a row whose selection lies
// d rows past k: 1.0 in the half d names, else 0.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return d == 0 ? 0x3F80u : d == 1 ? 0x3F800000u : 0u;
}

// The product. Warpgroup wg of CTA b, in round r, holds the kOhTiles
// tiles from ((r * grid + b) * kOhGroups + wg) * kOhTiles. A thread of
// warp w holds the A and D rows 16w + grp and 16w + grp + 8 of each tile
// (grp = lane / 4), i.e. two lanes, and of D the columns 8j + 2 tig, + 1
// (tig = lane % 4) of each 8-column block j: word 2j + tig / 2, its low
// half (bytes 0, 1) where tig is even, its high half where it is odd.
// A lane's one-hot row is nonzero in one k16 step only: the thread keeps
// that step and the two A registers' values there, and builds each step's
// fragment with a compare and two selects a row. kStream: the planes
// stream in kc-row chunks through two buffers, else they are resident.
template <int N, bool kStream>
__global__ void __launch_bounds__(kOhThreads, 1)
fetch_onehot(const uint8_t* __restrict__ planes, int n_rows, int cols,
             int k_pad, int kc, const int* __restrict__ sel, int g_count,
             int* __restrict__ out, int iters) {
  constexpr int kBatch = N <= 32 ? 4 : N <= 48 ? 2 : 1;
  constexpr int kR = N / 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bar = smem_addr(smem);  // two mbarriers: bar, bar + 8
  const uint32_t buf0 = bar + kOhBarBytes;
  const int chunks = k_pad / kc;
  const uint32_t chunk_bytes = (uint32_t)kc * N * 2;
  const int steps = kc / 16;  // a multiple of 2 * kBatch
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long per_pass = (long long)kOhGroups * kOhTiles * 64 * gridDim.x;
  const int rounds = (int)((g_count + per_pass - 1) / per_pass);
  // Chunks loaded in all: the planes once, or every chunk per fetch.
  const int loads = kStream ? rounds * iters * chunks : 1;
  if (threadIdx.x == 0) bulk_load(buf0, planes, chunk_bytes, bar);
  if (!kStream) mbar_wait(bar, 0);
  int u = 0;  // streamed chunks consumed
  for (int r = 0; r < rounds; ++r) {
    const long long tile0 =
        (((long long)r * gridDim.x + blockIdx.x) * kOhGroups + wg) * kOhTiles;
    int lg[kOhTiles][2], s[kOhTiles][2], h[kOhTiles][2];
#pragma unroll
    for (int t = 0; t < kOhTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long l = (tile0 + t) * 64 + 16 * warp + grp + 8 * e;
        lg[t][e] = l < g_count ? (int)l : -1;
        s[t][e] = lg[t][e] >= 0 ? __ldg(sel + lg[t][e]) : -1;  // -1: no row
        h[t][e] = 0;
      }
    }
    for (int it = 0; it < iters; ++it) {
      // Each row's k16 step (-1: none) and its A values there.
      int step[kOhTiles][2];
      uint32_t lo[kOhTiles][2], hi[kOhTiles][2];
#pragma unroll
      for (int t = 0; t < kOhTiles; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          step[t][e] = s[t][e] >> 4;
          const int d = (s[t][e] & 15) - 2 * tig;
          lo[t][e] = onehot_pair(d);
          hi[t][e] = onehot_pair(d - 8);
        }
      }
      float acc[kOhTiles][kR];
#pragma unroll
      for (int t = 0; t < kOhTiles; ++t)
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[t][i] = 0.0f;
      uint32_t a0[kBatch][kOhTiles][4], a1[kBatch][kOhTiles][4];
      for (int ci = 0; ci < chunks; ++ci) {
        uint32_t buf = buf0;
        if constexpr (kStream) {
          if (threadIdx.x == 0 && u + 1 < loads) {
            const int v = u + 1;  // into the buffer chunk u - 1 freed
            bulk_load(buf0 + (v & 1) * chunk_bytes,
                      planes + (size_t)(v % chunks) * chunk_bytes,
                      chunk_bytes, bar + 8 * (v & 1));
          }
          mbar_wait(bar + 8 * (u & 1), (u >> 1) & 1);
          buf = buf0 + (u & 1) * chunk_bytes;
        }
        // Two batches of k16 steps in flight, on two sets of A registers:
        // a set is rebuilt only after wait_group 1 has retired the batch
        // before the latest one, the last to read it.
        const int ks0 = ci * steps;
        for (int ks = 0; ks < steps; ks += 2 * kBatch) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t(&a)[kBatch][kOhTiles][4] = half ? a1 : a0;
            wgmma_wait<1>();
            const int kh = ks + half * kBatch;
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              const int k = ks0 + kh + b;
#pragma unroll
              for (int t = 0; t < kOhTiles; ++t) {
                const bool m0 = k == step[t][0];
                const bool m1 = k == step[t][1];
                a[b][t][0] = m0 ? lo[t][0] : 0u;
                a[b][t][1] = m1 ? lo[t][1] : 0u;
                a[b][t][2] = m0 ? hi[t][0] : 0u;
                a[b][t][3] = m1 ? hi[t][1] : 0u;
              }
            }
#pragma unroll
            for (int t = 0; t < kOhTiles; ++t) fence_regs(acc[t]);
            wgmma_fence();
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              const uint64_t desc = plane_desc<N>(buf + (kh + b) * 32 * N);
#pragma unroll
              for (int t = 0; t < kOhTiles; ++t) {
                wgmma_rs<N>(acc[t], a[b][t], desc);
              }
            }
            wgmma_commit();
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int t = 0; t < kOhTiles; ++t) fence_regs(acc[t]);
        if constexpr (kStream) {
          __syncthreads();  // every warpgroup is done with buffer u & 1
          ++u;
        }
      }
      const bool last = it == iters - 1;
#pragma unroll
      for (int t = 0; t < kOhTiles; ++t) {
        int part[2] = {0, 0};
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int word = 2 * j + (tig >> 1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t half = (uint32_t)(int)(
                acc[t][4 * j + 2 * e + 1] * 256.0f + acc[t][4 * j + 2 * e]);
            const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, half, 1);
            const int w = (int)((tig & 1) ? (half << 16) | other
                                          : (other << 16) | half);
            part[e] ^= w;  // the padding words are 0
            if (last && (tig & 1) == e && word < cols && lg[t][e] >= 0) {
              out[(size_t)word * g_count + lg[t][e]] = w;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          h[t][e] ^= part[e] ^ __shfl_xor_sync(0xFFFFFFFFu, part[e], 2);
          if (lg[t][e] >= 0) s[t][e] = next_sel(h[t][e], it, n_rows);
        }
      }
    }
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

// The planes' rows (table rows rounded up to kOhKAlign) and columns (4C
// rounded up to wgmma's 8).
int plane_rows(int n_rows) { return n_rows < kOhKAlign ? kOhKAlign : n_rows; }
int plane_cols(int cols) { return (4 * cols + 7) / 8 * 8; }
// Whether the product streams the planes through shared memory in K
// chunks (TMA), rather than holding them resident.
bool plane_streams(int n_rows, int cols) {
  return plane_rows(n_rows) * plane_cols(cols) * 2 > kOhResidentBytes;
}

template <int N, bool kStream>
int launch_onehot_kernel(const uint8_t* planes, int n_rows, int cols,
                         int k_pad, int kc, const int* sel, int g, int* out,
                         int iters, cudaStream_t s) {
  const int smem = kOhBarBytes + (kStream ? 2 : 1) * kc * N * 2;
  const auto kern = fetch_onehot<N, kStream>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kOhThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  // About one CTA a SM (as many as fit), never more than the lanes need.
  const long long per_cta = (long long)kOhGroups * kOhTiles * 64;
  const long long need = (g + per_cta - 1) / per_cta;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(need < fit ? need : fit);
  kern<<<grid, kOhThreads, smem, s>>>(planes, n_rows, cols, k_pad, kc, sel, g,
                                      out, iters);
  return (int)cudaGetLastError();
}

// Resident planes where they fit, else the largest power-of-two chunk of
// at most kOhChunkBytes (a multiple of kOhKAlign rows that divides k_pad).
template <int N>
int launch_onehot(const uint8_t* planes, int n_rows, int cols, const int* sel,
                  int g, int* out, int iters, cudaStream_t s) {
  const int k_pad = plane_rows(n_rows);
  if (!plane_streams(n_rows, cols)) {
    return launch_onehot_kernel<N, false>(planes, n_rows, cols, k_pad, k_pad,
                                          sel, g, out, iters, s);
  }
  int kc = kOhKAlign;
  while (2 * kc * N * 2 <= kOhChunkBytes) kc *= 2;
  return launch_onehot_kernel<N, true>(planes, n_rows, cols, k_pad, kc, sel,
                                       g, out, iters, s);
}

}  // namespace

// The one-hot mode's planes: table int32 [n_rows, cols] (n_rows a power
// of two, cols in [1, 16]) into `planes`, plane_rows(n_rows) x
// plane_cols(cols) bf16 values in fetch_planes' layout.
extern "C" int rt_fetch_planes_launch(const void* table, int n_rows, int cols,
                                      void* planes, void* stream) {
  if (n_rows < 1 || (n_rows & (n_rows - 1)) != 0 || cols < 1 ||
      cols > kMaxCols || planes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_pad = plane_cols(cols);
  const int k_pad = plane_rows(n_rows);
  const int total = k_pad / 8 * n_pad;
  fetch_planes<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), n_rows, cols, n_pad, k_pad,
      static_cast<uint4*>(planes));
  return (int)cudaGetLastError();
}

// table int32 [n_rows, cols] (n_rows a power of two, cols in [1, 16]),
// sel int32 [g] (values in [0, n_rows)), out int32 [cols, g]; mode 0
// index, 1 radix, 2 onehot (planes: rt_fetch_planes_launch's output for
// this table, on the same stream), 3 radix16; iters >= 1.
extern "C" int rt_fetch_launch(const void* table, int n_rows, int cols,
                               const void* sel, int g, void* out, int mode,
                               int iters, const void* planes, void* stream) {
  if (n_rows < 1 || (n_rows & (n_rows - 1)) != 0 || cols < 1 ||
      cols > kMaxCols || g < 1 || iters < 1 ||
      (mode == 2 && planes == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int* t = static_cast<const int*>(table);
  const int* sl = static_cast<const int*>(sel);
  int* o = static_cast<int*>(out);
  const uint8_t* pl = static_cast<const uint8_t*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      fetch_index<<<(g + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          t, n_rows, cols, sl, g, o, iters);
      return (int)cudaGetLastError();
    case 1:
    case 3:
      return radix_cols(cols, t, n_rows, sl, g, o, iters, mode == 3, s);
    case 2:
      switch (plane_cols(cols)) {
#define RT_FETCH_N(N) \
  case N: return launch_onehot<N>(pl, n_rows, cols, sl, g, o, iters, s);
        RT_FETCH_N(8) RT_FETCH_N(16) RT_FETCH_N(24) RT_FETCH_N(32)
        RT_FETCH_N(40) RT_FETCH_N(48) RT_FETCH_N(56) RT_FETCH_N(64)
#undef RT_FETCH_N
        default: return (int)cudaErrorInvalidValue;
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launchers' choices, for checks that a path ran: 1 where the one-hot
// product of an n_rows x cols table streams its planes, else 0; and the
// largest table the radix modes sweep rather than exchange.
extern "C" int rt_fetch_plane_streams(int n_rows, int cols) {
  return plane_streams(n_rows, cols) ? 1 : 0;
}
extern "C" int rt_fetch_sweep_rows() { return rtfetch::kSweepRows; }

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
