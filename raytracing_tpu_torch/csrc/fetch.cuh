// The radix winner fetch for NVIDIA Hopper (sm_90a), shared by regen.cu
// (its RT_GATHER=radix route), segment_split.cu (its full_radix variant)
// and fetch.cu (the standalone fetch kernel).
//
// Replaces the tournament of raytracing_tpu/ops/pallas/trace.py:
// _fold_half, _fold8 and _fold_to_row inside _gather_cols, and the
// select over window blocks of _gather_cols / _collapse_window_blocked.
//
// The words of row `sel` of an n-row table, fetched without a per-lane
// address into the table: no lane's row address depends on its selection.
// The TPU had no way to move a value from one lane to another, so it swept
// every row past every lane (O(n) selects and row reads per lane). A warp
// exchanges registers natively, so here the lanes that reach the fetch
// together (the group: __activemask(), any subset of the warp, down to one
// lane) share the reads:
//
//   1. the table is walked in chunks of as many rows as the group has
//      lanes;
//   2. the lane of rank k in the group reads row i0 + k (clamped to the
//      last row), so neighbouring lanes read neighbouring rows: coalesced
//      in global memory, conflict-free in shared memory;
//   3. each word moves by __shfl_sync from the lane of rank sel - i0;
//   4. the lane keeps the word only where sel lies in the chunk.
//
// Tables of at most kSweepRows rows are swept (every lane reads every
// row). A row address depends on the lane's rank and the chunk (or on
// nothing), never on `sel`.
//
// Per lane that is n / group-size chunks of C loads, C shuffles and C
// selects, against n * C loads and selects for the sweep; only C loaded
// and C kept words are live at a time. The bound is instruction issue
// (the shuffles: one warp instruction per word per chunk), so the design
// cuts instructions. Lanes that have left (finished threads, ragged lanes
// past the end of an array) are not in the group and take no part.
//
// Words stay in integer registers: the packed material words can be
// subnormal (0x80008000) or NaN (0xFFFFFFFF) as float32 patterns, and a
// float move or a flush-to-zero build would corrupt them. A shuffle and a
// select of ints move every bit.

#pragma once

#include <stdint.h>

namespace rtfetch {

template <int C>
struct Words {
  int v[C];
};

// The lane of the set bit of rank k (from 0) in `mask` (k < popc(mask)):
// the largest lane with at most k set bits below it.
__device__ __forceinline__ int nth_lane(uint32_t mask, int k) {
  int lane = 0;
#pragma unroll
  for (int b = 16; b >= 1; b >>= 1) {
    if (__popc(mask & ((1u << (lane + b)) - 1u)) <= k) lane += b;
  }
  return lane;
}

// `got` where take, else `old`: a whole 32-bit word, or with k16 two
// 16-bit halves selected by __byte_perm (bytes 0-3 of the result from
// old, selector 0x3210, or from got, 0x7654).
template <bool k16>
__device__ __forceinline__ int keep(bool take, int old, int got) {
  if constexpr (k16) {
    return (int)__byte_perm((uint32_t)old, (uint32_t)got,
                            take ? 0x7654u : 0x3210u);
  } else {
    return take ? got : old;
  }
}

// Tables of at most this many rows are swept instead: every lane reads
// every row, at the same address in every lane, and keeps its own by a
// select. Below it the exchange's set-up costs more than the sweep (the
// 2-window key collapse of regen.cu's chunked body, 128 calls a winner).
constexpr int kSweepRows = 4;

// Row `sel` (in [0, n)) of the n-row table `get(i)` reads, by the exchange
// among the lanes that call it together. Every lane of the group must
// pass the same n; `get` is called with rows in [0, n) only. A lane whose
// `sel` lies outside [0, n) (e.g. -1) keeps zeros. The selected row's
// rank in its chunk is sel mod group size in every chunk, so the source
// lane is found once, not per chunk (a division only for a partial group
// on a table of more than one chunk).
template <int C, bool k16 = false, class Get>
__device__ __forceinline__ Words<C> radix_select(int n, int sel,
                                                 const Get& get) {
  Words<C> out;
#pragma unroll
  for (int c = 0; c < C; ++c) out.v[c] = 0;
  if (n <= kSweepRows) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const Words<C> w = get(i);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        out.v[c] = keep<k16>(i == sel, out.v[c], w.v[c]);
      }
    }
    return out;
  }
  const uint32_t group = __activemask();
  uint32_t lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  const int size = __popc(group);
  const int rank = __popc(group & ((1u << lane) - 1u));
  const bool full = group == 0xFFFFFFFFu;
  int k = sel;  // the selected row's rank in its chunk
  if (n > size) k = full ? sel & 31 : sel % size;
  const int src =
      full ? k & 31 : nth_lane(group, (uint32_t)k < (uint32_t)size ? k : 0);
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += size) {
    const Words<C> w = get(min(i0 + rank, n - 1));
    const bool mine = (uint32_t)(sel - i0) < (uint32_t)size;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out.v[c] = keep<k16>(mine, out.v[c], __shfl_sync(group, w.v[c], src));
    }
  }
  return out;
}

}  // namespace rtfetch
