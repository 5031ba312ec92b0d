// Cull-scheduling probe kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/probe_worklist.py (make_kernel :92,
// _group_body :54, launched by build :208): the cost of the granularity at
// which a culled sweep skips work, on one sweep body over fixed votes.
//
// One unit is one CTA of 1,024 threads: 1,024 rays in 8 groups of 128
// lanes (group g's component c is rays[c * 8 + g], one thread a ray),
// against 8 blocks of 512 table rows (columns cx, cy, cz, -2cx, -2cy,
// -2cz, cm2). Per (block, group) the body is the megakernel's flat sweep
// (regen_core.cuh: sweep_ray, sweep_rows) with row-in-block ids: the key
// min of (bits(key) & ~511) | row, from _NOHIT each pass. The output is a
// wrapping int32 sum of each ray's key min over `reps` passes. The votes
// votes[b, g] are a table (the same for every unit), so every mode runs
// a fixed pass set:
//
//   0 static:    one CTA-wide vote per block (__syncthreads_or over the
//                groups' votes); when any group votes, all 32 warps sweep.
//                Sweeps more pairs than the votes ask when the table is not
//                conservative, so it equals the others only at 8/8.
//   1 conds:     a group's 4 warps sweep only if their group voted: a
//                warp-uniform branch.
//   2 worklist:  per block, a compacted list in shared memory of the
//                passing (group, quarter) items, 32 rays x 512 rows each;
//                warps pull items through a shared atomic counter, so a
//                warp's work is not tied to its own group. The rays and
//                their running minima sit in shared memory. Same result as
//                conds.
//
// Each visited block's 7 columns are staged in shared memory as sweep rows;
// every lane of a warp reads the same row at the same time (two 16-byte
// broadcasts).
//
// What bounds it on this card: FP32 work, 19 operations per (ray, row)
// pair swept, against 112 KB of table and 24 KB of rays per unit. The
// probe measures how each mode's idle warps show up in time.
//
// rt_worklist_launch launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "regen_core.cuh"

namespace {

using namespace rtcore;

constexpr int kBlk = 512;
constexpr int kNb = 8;
constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kUnit = kGroups * kLanes;
constexpr int kItems = kGroups * (kLanes / 32);

enum Mode { kStatic = 0, kConds = 1, kWorklist = 2 };

// One staged block of sweep rows (regen_core.cuh's SweepRow: cx, cy, cz,
// -, then -2cx, -2cy, -2cz, cm2).
struct BlockTable {
  SweepRow rows[kBlk];
};

__device__ __forceinline__ Ray ray_of(const float (*comp)[kUnit], int r) {
  return Ray{comp[0][r], comp[1][r], comp[2][r],
             comp[3][r], comp[4][r], comp[5][r]};
}

template <int kMode>
__global__ void __launch_bounds__(kUnit)
worklist(const float* __restrict__ tab, const float* __restrict__ rays,
         const int* __restrict__ votes, int reps, int* __restrict__ out) {
  __shared__ BlockTable bt;
  __shared__ float comp[6][kUnit];  // worklist: rays any warp may sweep
  __shared__ int carry_s[kUnit];    // worklist: running key minima
  __shared__ int items[kItems];
  __shared__ int n_items, next_item;

  const int t = threadIdx.x;
  const int g = t / kLanes;
  const int lane = t & 31;
  const float* ru = rays + (size_t)blockIdx.x * 6 * kUnit;
  Ray own;
  own.ox = ru[(0 * kGroups + g) * kLanes + t % kLanes];
  own.oy = ru[(1 * kGroups + g) * kLanes + t % kLanes];
  own.oz = ru[(2 * kGroups + g) * kLanes + t % kLanes];
  own.dx = ru[(3 * kGroups + g) * kLanes + t % kLanes];
  own.dy = ru[(4 * kGroups + g) * kLanes + t % kLanes];
  own.dz = ru[(5 * kGroups + g) * kLanes + t % kLanes];
  if constexpr (kMode == kWorklist) {
    comp[0][t] = own.ox;
    comp[1][t] = own.oy;
    comp[2][t] = own.oz;
    comp[3][t] = own.dx;
    comp[4][t] = own.dy;
    comp[5][t] = own.dz;
  }
  const SweepRay s = sweep_ray(own);
  const int nohit = __float_as_int(kBigF) & ~(kBlk - 1);

  uint32_t acc = 0;
  for (int rep = 0; rep < reps; ++rep) {
    int carry = nohit;
    if constexpr (kMode == kWorklist) carry_s[t] = nohit;
    for (int b = 0; b < kNb; ++b) {
      const bool vote = __ldg(votes + b * kGroups + g) > 0;
      // The CTA-wide vote; also the barrier after the previous block.
      if (!__syncthreads_or(vote)) continue;
      const float* src = tab + (size_t)b * kBlk * 7;
      for (int e = t; e < kBlk * 7; e += kUnit) {
        const int row = e / 7;
        const int col = e - row * 7;
        reinterpret_cast<float*>(&bt.rows[row])[col < 3 ? col : col + 1] =
            src[e];
      }
      if constexpr (kMode == kWorklist) {
        if (t == 0) {
          int n = 0;
          for (int gg = 0; gg < kGroups; ++gg) {
            if (__ldg(votes + b * kGroups + gg) > 0) {
              for (int q = 0; q < kLanes / 32; ++q) items[n++] = gg * 4 + q;
            }
          }
          n_items = n;
          next_item = 0;
        }
      }
      __syncthreads();
      if constexpr (kMode == kStatic) {
        carry = sweep_rows<true>(bt.rows, kBlk, 0, kBlk - 1, s, carry);
      } else if constexpr (kMode == kConds) {
        if (vote) {
          carry = sweep_rows<true>(bt.rows, kBlk, 0, kBlk - 1, s, carry);
        }
      } else {
        for (;;) {
          int it = 0;
          if (lane == 0) it = atomicAdd(&next_item, 1);
          it = __shfl_sync(0xFFFFFFFFu, it, 0);
          if (it >= n_items) break;
          const int gq = items[it];
          const int r = (gq >> 2) * kLanes + (gq & 3) * 32 + lane;
          carry_s[r] = sweep_rows<true>(bt.rows, kBlk, 0, kBlk - 1,
                                        sweep_ray(ray_of(comp, r)),
                                        carry_s[r]);
        }
      }
    }
    if constexpr (kMode == kWorklist) {
      __syncthreads();  // every item of the pass is swept
      carry = carry_s[t];
    }
    acc += (uint32_t)carry;
  }
  out[(size_t)blockIdx.x * kUnit + t] = (int)acc;
}

}  // namespace

// tab f32 [4096, 7]; rays f32 [units, 48, 128]; votes i32 [8, 8]; out i32
// [units, 8, 128]; mode 0 static, 1 conds, 2 worklist; reps >= 0.
extern "C" int rt_worklist_launch(const void* tab, const void* rays,
                                  const void* votes, int units, int reps,
                                  int mode, void* out, void* stream) {
  if (units <= 0 || reps < 0) return (int)cudaErrorInvalidValue;
  const float* tb = static_cast<const float*>(tab);
  const float* ry = static_cast<const float*>(rays);
  const int* vt = static_cast<const int*>(votes);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kStatic: worklist<kStatic><<<units, kUnit, 0, s>>>(tb, ry, vt, reps, o); break;
    case kConds: worklist<kConds><<<units, kUnit, 0, s>>>(tb, ry, vt, reps, o); break;
    case kWorklist: worklist<kWorklist><<<units, kUnit, 0, s>>>(tb, ry, vt, reps, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
