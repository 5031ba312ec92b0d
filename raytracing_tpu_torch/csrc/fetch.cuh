// The radix winner fetch for NVIDIA Hopper (sm_90a), shared by regen.cu
// (its RT_GATHER=radix route) and fetch.cu (the standalone fetch kernel).
//
// Replaces the tournament of raytracing_tpu/ops/pallas/trace.py:
// _fold_half, _fold8 and _fold_to_row inside _gather_cols, and the
// select over window blocks of _gather_cols / _collapse_window_blocked.
//
// The words of row `sel` of an n-row table (n a power of two), fetched
// without a per-lane address into the table: every lane of a warp reads
// row i at the same time (a shared-memory broadcast, or one global
// transaction per warp), and each lane keeps its own row with
// bit-preserving selects keyed on its row id's bits. Rows are visited in
// leaves of kLeaf (2 or 4) consecutive rows; a leaf folds to the row its
// low bits name by a halving tournament (the TPU's _fold_half / _fold8),
// and a select keyed on the leaf index, the row id's other bits, keeps the
// lane's leaf (the TPU's select over window slices). O(n) selects and O(n) row reads per fetch, as on
// the TPU. _fold8's sublane rotations have no counterpart: a lane holds
// its own candidates in registers.
//
// Words stay in integer registers: the packed material words can be
// subnormal (0x80008000) or NaN (0xFFFFFFFF) as float32 patterns, and a
// float move or a flush-to-zero build would corrupt them. A select of
// ints is a register select, so every bit survives.

#pragma once

#include <stdint.h>

namespace rtfetch {

template <int C>
struct Words {
  int v[C];
};

// a, or b where take_b: whole 32-bit words.
template <int C>
__device__ __forceinline__ Words<C> pick(bool take_b, const Words<C>& a,
                                         const Words<C>& b) {
  Words<C> r;
#pragma unroll
  for (int c = 0; c < C; ++c) r.v[c] = take_b ? b.v[c] : a.v[c];
  return r;
}

// The same select on two 16-bit halves per register: __byte_perm takes
// bytes 0-1 and 2-3 of the result from a (selector nibbles 1,0 / 3,2) or
// from b (5,4 / 7,6).
template <int C>
__device__ __forceinline__ Words<C> pick16(bool take_b, const Words<C>& a,
                                           const Words<C>& b) {
  const uint32_t lo = take_b ? 0x54u : 0x10u;
  const uint32_t hi = take_b ? 0x7600u : 0x3200u;
  const uint32_t s = hi | lo;
  Words<C> r;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    r.v[c] = (int)__byte_perm((uint32_t)a.v[c], (uint32_t)b.v[c], s);
  }
  return r;
}

template <bool k16, int C>
__device__ __forceinline__ Words<C> select_words(bool take_b,
                                                 const Words<C>& a,
                                                 const Words<C>& b) {
  if constexpr (k16) {
    return pick16<C>(take_b, a, b);
  } else {
    return pick<C>(take_b, a, b);
  }
}

// Halving tournament over rows i0 .. i0 + kL - 1 (i0 a multiple of kL):
// the row `sel`'s low log2(kL) bits name. `get(i)` returns row i's words.
template <int kL, int C, bool k16, class Get>
__device__ __forceinline__ Words<C> fold(int i0, int sel, const Get& get) {
  if constexpr (kL == 1) {
    return get(i0);
  } else {
    const Words<C> lo = fold<kL / 2, C, k16>(i0, sel, get);
    const Words<C> hi = fold<kL / 2, C, k16>(i0 + kL / 2, sel, get);
    return select_words<k16, C>((sel & (kL / 2)) != 0, lo, hi);
  }
}

// Leaf rows: 4 for rows of one or two words, else 2. The fetch shares a
// kernel with the default route, whose register count is the kernel's
// peak: kLeaf * C candidate words are live at once, so wide rows take
// short leaves (and callers fetch wide rows a column group at a time).
template <int C>
__host__ __device__ constexpr int leaf_rows() {
  return C <= 2 ? 4 : 2;
}

// Row `sel` of the n-row table `get` reads (n a power of two, sel in
// [0, n)): every lane reads every row, in the same order. The leaf loop is
// not unrolled, so no more than one leaf of candidates is live.
template <int C, bool k16 = false, class Get>
__device__ __forceinline__ Words<C> radix_select(int n, int sel,
                                                 const Get& get) {
  constexpr int kL = leaf_rows<C>();
  Words<C> out;
#pragma unroll
  for (int c = 0; c < C; ++c) out.v[c] = 0;
  if (n < kL) {
    // Tables narrower than a leaf: one round per row.
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      out = select_words<k16, C>(i == sel, out, get(i));
    }
    return out;
  }
  const int leaf = sel & ~(kL - 1);
#pragma unroll 1
  for (int i0 = 0; i0 < n; i0 += kL) {
    out = select_words<k16, C>(i0 == leaf, out,
                               fold<kL, C, k16>(i0, sel, get));
  }
  return out;
}

}  // namespace rtfetch
