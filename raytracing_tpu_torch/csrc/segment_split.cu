// Segment-split probe kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/probe_segment_split.py (make_kernel
// :56, launched by run_variant :262): the cover scene's regeneration loop
// body run for a fixed number of steps with every lane live, so that the
// slope of two step counts is the cost of one segment with no dispatch
// floor, and variants that take one piece out split that cost:
//
//   0 full        the flat sweep, the indexed winner fetch, the exact root,
//                 the branchless shade and the camera regeneration;
//   1 nogather    the winner's columns made from its row id (no fetch);
//   2 nosweep     the key made from dy's bits (no sweep, no fetch);
//   3 base        the same code as nosweep (the JAX probe has both names);
//   4 full_radix  full, with the winner fetched by the radix exchange
//                 (fetch.cuh, the RT_GATHER=radix route) in place of the
//                 indexed load: the same words, so the same bits as full.
//
// It is the JAX probe's body op for op: draws through uniform01 (draw j of
// (sample = step, bounce = step)), the camera ray with the probe's own draw
// order (u0[2] as both lens draws first; j1 as the lens angle after), the
// flat sweep's packed key, the shade with the probe's eta (1 / max(ior,
// 1e-3) on front faces) and its sky. It runs the megakernel's own device
// code (regen_core.cuh: the counter hash, camera_ray_from, SharedTable
// and stage_table, sweep_rows with its miss select and four-row trips,
// mat_decode; fetch.cuh: radix_select), so its cycles a segment are the
// megakernel's sweep's.
//
// One thread owns one slot: the lane's index within its 1,024-lane tile
// (every tile traces the same 1,024 slots, pixels x = slot % 400, y =
// slot / 400, as the JAX probe's tiles do). The loop has a fixed trip count
// and no exit. Each block stages the table in shared memory once
// (stage_table, as the megakernel's staged body does).
//
// Outputs: rad [3, slots] (rr, rg, and rb + ox + dx so the last ray stays
// live), hits [slots] (steps whose key was a hit), and per warp the
// clock64() before and after the loop and the warp's SM id, from which the
// probe tool takes SM cycles per segment.
//
// What bounds it on this card: FP32 work. A segment of `full` is about
// 19 FP32 operations per table row (the sweep) plus about 240 for the shade
// and the camera, against a few hundred bytes of inputs per call. The
// design keeps the table in shared memory sized to it (every lane of a
// warp reads the same row: two 16-byte broadcasts) and the ray state in
// registers.
//
// rt_segment_split_launch launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fetch.cuh"
#include "regen_core.cuh"

namespace {

using namespace rtcore;

constexpr int kThreads = 256;
constexpr int kTileSlots = 1024;
constexpr int kGridCols = 400;

enum Variant { kFull = 0, kNoGather = 1, kNoSweep = 2, kBase = 3, kFullRadix = 4 };

__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
segment_split(const float* __restrict__ geom_h,
              const float* __restrict__ geom_c,
              const float* __restrict__ shade, int n_pad, int pack_mask,
              Camera cam, uint32_t seed, int steps, int slots,
              float* __restrict__ rad, int* __restrict__ hits,
              long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char staged_smem[];
  const SharedTable t = shared_table(staged_smem, n_pad);
  stage_table(t, geom_h, geom_c, shade, n_pad, 8);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // slots % 1024 == 0
  const int slot = i & (kTileSlots - 1);
  const float pxf = (float)(slot % kGridCols);
  const float pyf = (float)(slot / kGridCols);
  const uint32_t slot_h = (uint32_t)slot * kSlotMul + fmix32(seed + kGold);
  const int nohit = __float_as_int(kBigF) & ~pack_mask;

  const float u00 = uniform01(slot_h, 0, 0, 0u);
  const float u01 = uniform01(slot_h, 0, 0, 1u);
  const float u02 = uniform01(slot_h, 0, 0, 2u);
  Ray ray = camera_ray_from(cam, pxf, pyf, u00, u01, u02, u02);
  float tpr = 1.0f, tpg = 1.0f, tpb = 1.0f;
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
  int nhit = 0;

  const long long c0 = clock64();
  for (int it = 0; it < steps; ++it) {
    const float u1 = uniform01(slot_h, it, it, 0u);
    const float u2 = uniform01(slot_h, it, it, 1u);
    const float u3 = uniform01(slot_h, it, it, 2u);
    const SweepRay s = sweep_ray(ray);
    const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
    const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
    const float a = s.a;
    const float d_dot_o = s.ddo;

    int kmin;
    if constexpr (kVariant == kNoSweep || kVariant == kBase) {
      kmin = __float_as_int(dy);  // (kb & ~mask) | (kb & mask)
    } else {
      kmin = sweep_rows<true>(t.rows, n_pad, 0, pack_mask, s, nohit);
    }
    const bool hitm = kmin < nohit;
    const int imin = kmin & pack_mask;
    nhit += hitm ? 1 : 0;

    float cxb, cyb, czb, rb_, albr, albg, albb, param;
    if constexpr (kVariant == kFull || kVariant == kFullRadix) {
      int w1, w2;
      if constexpr (kVariant == kFull) {
        cxb = t.rows[imin].h.x;
        cyb = t.rows[imin].h.y;
        czb = t.rows[imin].h.z;
        rb_ = t.r[imin];
        w1 = t.w1[imin];
        w2 = t.w2[imin];
      } else {
        // A column group at a time, as the megakernel's staged body does.
        const rtfetch::Words<3> g0 = rtfetch::radix_select<3>(
            n_pad, imin, [&](int j) {
              return rtfetch::Words<3>{{__float_as_int(t.rows[j].h.x),
                                        __float_as_int(t.rows[j].h.y),
                                        __float_as_int(t.rows[j].h.z)}};
            });
        const rtfetch::Words<3> g1 = rtfetch::radix_select<3>(
            n_pad, imin, [&](int j) {
              return rtfetch::Words<3>{{__float_as_int(t.r[j]), t.w1[j],
                                        t.w2[j]}};
            });
        cxb = __int_as_float(g0.v[0]);
        cyb = __int_as_float(g0.v[1]);
        czb = __int_as_float(g0.v[2]);
        rb_ = __int_as_float(g1.v[0]);
        w1 = g1.v[1];
        w2 = g1.v[2];
      }
      const Material m = mat_decode(w1, w2);
      albr = m.albr;
      albg = m.albg;
      albb = m.albb;
      param = m.param;
    } else {
      // Synthetic winner columns from imin.
      const float f = (float)imin;
      cxb = f * 0.01f;
      cyb = f * -0.02f;
      czb = f * 0.005f;
      rb_ = f * 1e-4f + 0.2f;
      albr = f * 1e-5f + 0.3f;
      albg = albr;
      albb = albr;
      param = f * 1e-6f - 0.9f;
    }

    // Exact winner root and the branchless shade (the JAX probe's ops).
    const float hq = cxb * dx + cyb * dy + czb * dz - d_dot_o;
    const float ocx = ox - cxb;
    const float ocy = oy - cyb;
    const float ocz = oz - czb;
    const float cqw = ocx * ocx + ocy * ocy + ocz * ocz - rb_ * rb_;
    const float deltaw = clamp_min(hq * hq - a * cqw, 0.0f);
    const float sqw = sqrtf(deltaw);
    const float inv_a = 1.0f / a;
    const float t1 = (hq - sqw) * inv_a;
    const float t2 = (hq + sqw) * inv_a;
    const float tt = t1 > kTMin ? t1 : t2;
    const float t_safe = hitm ? tt : 0.0f;
    const float invrb = rb_ > 0.0f ? 1.0f / clamp_min(rb_, 1e-30f) : 0.0f;
    const float px = ox + t_safe * dx;
    const float py = oy + t_safe * dy;
    const float pz = oz + t_safe * dz;
    const float onx = (px - cxb) * invrb;
    const float ony = (py - cyb) * invrb;
    const float onz = (pz - czb) * invrb;
    const float d_dot_n = dx * onx + dy * ony + dz * onz;
    const bool front = d_dot_n < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    const float nx = onx * sgn;
    const float ny = ony * sgn;
    const float nz = onz * sgn;
    const float inv_len_d = rsqrtf(a);
    const float sky_t = 0.5f * (dy * inv_len_d + 1.0f);
    const float sky_r = 1.0f - sky_t + sky_t * 0.5f;
    const float sky_g = 1.0f - sky_t + sky_t * 0.7f;
    const float uz = 2.0f * u1 - 1.0f;
    const float us = sqrtf(clamp_min(1.0f - uz * uz, 0.0f));
    const float theta = kTwoPi * u2;
    const float ux = us * cosf(theta);
    const float uy = us * sinf(theta);
    float ldx = nx + ux;
    float ldy = ny + uy;
    float ldz = nz + uz;
    if (fabsf(ldx) < 1e-8f && fabsf(ldy) < 1e-8f && fabsf(ldz) < 1e-8f) {
      ldx = nx;
      ldy = ny;
      ldz = nz;
    }
    const float two_ddn = 2.0f * d_dot_n * sgn;
    const float rfx = dx - two_ddn * nx;
    const float rfy = dy - two_ddn * ny;
    const float rfz = dz - two_ddn * nz;
    const float inv_rf =
        rsqrtf(clamp_min(rfx * rfx + rfy * rfy + rfz * rfz, 1e-20f));
    const float mdx = rfx * inv_rf + param * ux;
    const float mdy = rfy * inv_rf + param * uy;
    const float mdz = rfz * inv_rf + param * uz;
    const bool met_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0f;
    const float iorb = param - 4.0f;
    const float eta = front ? 1.0f / clamp_min(iorb, 1e-3f) : iorb;
    const float udx = dx * inv_len_d;
    const float udy = dy * inv_len_d;
    const float udz = dz * inv_len_d;
    const float cos_t = clamp_max(-(udx * nx + udy * ny + udz * nz), 1.0f);
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = (eta * sin_t) > 1.0f;
    float r0 = (1.0f - eta) / (1.0f + eta);
    r0 = r0 * r0;
    const float omc = 1.0f - cos_t;
    const float omc2 = omc * omc;
    const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    const bool choose_reflect = cannot || (schlick > u3);
    const float two_udn = 2.0f * (udx * nx + udy * ny + udz * nz);
    const float rdx = udx - two_udn * nx;
    const float rdy = udy - two_udn * ny;
    const float rdz = udz - two_udn * nz;
    const float ppx = eta * (udx + cos_t * nx);
    const float ppy = eta * (udy + cos_t * ny);
    const float ppz = eta * (udz + cos_t * nz);
    const float k = 1.0f - (ppx * ppx + ppy * ppy + ppz * ppz);
    const float par = -sqrtf(fabsf(k));
    const float tdx = ppx + par * nx;
    const float tdy = ppy + par * ny;
    const float tdz = ppz + par * nz;
    const float ddx = choose_reflect ? rdx : tdx;
    const float ddy = choose_reflect ? rdy : tdy;
    const float ddz = choose_reflect ? rdz : tdz;
    const bool is_lam = param < -0.5f;
    const bool is_diel = param > 2.5f;
    const float ndx = is_lam ? ldx : (is_diel ? ddx : mdx);
    const float ndy = is_lam ? ldy : (is_diel ? ddy : mdy);
    const float ndz = is_lam ? ldz : (is_diel ? ddz : mdz);
    const float atr = is_diel ? 1.0f : albr;
    const float atg = is_diel ? 1.0f : albg;
    const float atb = is_diel ? 1.0f : albb;
    const bool scat_ok = hitm && !(!is_lam && !is_diel && !met_ok);

    const float missf = hitm ? 0.0f : 1.0f;
    rr = rr + missf * tpr * sky_r;
    rg = rg + missf * tpg * sky_g;
    rb = rb + missf * tpb * 1.0f;

    // Camera regeneration for dead lanes, every step.
    const float j1 = uniform01(slot_h, it + 1, 0, 0u);
    const float j2 = uniform01(slot_h, it + 1, 0, 1u);
    const float c3 = uniform01(slot_h, it + 1, 0, 2u);
    const Ray cr = camera_ray_from(cam, pxf, pyf, j1, j2, c3, j1);
    const float side = (ndx * nx + ndy * ny + ndz * nz) >= 0.0f ? 1.0f : -1.0f;
    const float eps = kSelfHitOffset * side;
    if (scat_ok) {
      ray = Ray{px + eps * nx, py + eps * ny, pz + eps * nz, ndx, ndy, ndz};
      tpr = tpr * atr;
      tpg = tpg * atg;
      tpb = tpb * atb;
    } else {
      ray = cr;
      tpr = 1.0f;
      tpg = 1.0f;
      tpb = 1.0f;
    }
  }
  const long long c1 = clock64();

  rad[i] = rr;
  rad[slots + i] = rg;
  rad[2 * slots + i] = rb + ray.ox + ray.dx;
  hits[i] = nhit;
  if ((threadIdx.x & 31) == 0) {
    const int w = i >> 5;
    clocks[3 * w + 0] = c0;
    clocks[3 * w + 1] = c1;
    clocks[3 * w + 2] = (long long)sm_id();
  }
}

template <int kVariant>
int launch(const float* gh, const float* gc, const float* sh, int n_pad,
           const Camera& cam, uint32_t seed, int steps, int slots, float* rad,
           int* hits, long long* clocks, cudaStream_t s) {
  segment_split<kVariant><<<slots / kThreads, kThreads, staged_bytes(n_pad),
                            s>>>(
      gh, gc, sh, n_pad, (1 << pack_bits(n_pad)) - 1, cam, seed, steps,
      slots, rad, hits, clocks);
  return (int)cudaGetLastError();
}

}  // namespace

// geom_h, geom_c, shade: the untextured sphere tables [n_pad, 8] (n_pad a
// power of two in [128, 1024]); camera: 20 host floats; slots a positive
// multiple of 1024; rad f32 [3, slots], hits i32 [slots], clocks i64
// [slots / 32, 3]; variant 0 full, 1 nogather, 2 nosweep, 3 base,
// 4 full_radix.
extern "C" int rt_segment_split_launch(
    const void* geom_h, const void* geom_c, const void* shade, int n_pad,
    const float* cam_host, unsigned int seed, int steps, int slots,
    int variant, void* rad, void* hits, void* clocks, void* stream) {
  if (n_pad < 128 || n_pad > kStageRows || (n_pad & (n_pad - 1)) != 0 ||
      slots <= 0 || slots % kTileSlots != 0 || steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Camera cam;
  for (int k = 0; k < 20; ++k) cam.v[k] = cam_host[k];
  const float* gh = static_cast<const float*>(geom_h);
  const float* gc = static_cast<const float*>(geom_c);
  const float* sh = static_cast<const float*>(shade);
  float* r = static_cast<float*>(rad);
  int* h = static_cast<int*>(hits);
  long long* c = static_cast<long long*>(clocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return launch<kFull>(gh, gc, sh, n_pad, cam, seed, steps, slots, r, h, c, s);
    case kNoGather: return launch<kNoGather>(gh, gc, sh, n_pad, cam, seed, steps, slots, r, h, c, s);
    case kNoSweep: return launch<kNoSweep>(gh, gc, sh, n_pad, cam, seed, steps, slots, r, h, c, s);
    case kBase: return launch<kBase>(gh, gc, sh, n_pad, cam, seed, steps, slots, r, h, c, s);
    case kFullRadix: return launch<kFullRadix>(gh, gc, sh, n_pad, cam, seed, steps, slots, r, h, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
