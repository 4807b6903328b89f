// Shared stencil body of the port's kernels: K.u at one output point.
//
// Used by B1/B2 and the r^2-cotangent (stencil_matvec.cu) and by B3-B5
// (mg_fused.cu), the counterpart of make_stencil_acc in
// pylatticedso_tpu/parallel/stencil_pallas.py, which the TPU kernels share
// the same way.  It computes the math of the gather form
// (pylatticedso_tpu_torch/parallel/structured.py apply_gather): for the
// output point q of class c and every template-edge side whose self class
// is c, form the six generalized strains e0..e5 from u(self, q), u(other,
// q + du) and r^2(q + dr), the internal forces with S = pi r^2, I = pi
// r^4 / 4, and add the side's force/moment row to acc.
//
// Layout: u is ghost-padded [nc, 6, Xp, Yp, Zp] and r^2 [n_e, Xp, Yp, Zp];
// q is the flat index of an INTERIOR point of the padded grid, so every
// shifted read stays in bounds and reads zeros outside the lattice.
// slab_acc is the one K.u body: a template over the compute type C and
// its side record (float with Side, double with SideD); loads of the
// storage type (float, __nv_bfloat16 or double) are widened to C and all
// arithmetic is C.  side_acc is its per-side arithmetic, which B5 also
// calls on values it keeps in registers and shared memory; the
// r^2-cotangent kernel keeps its own copy of the strain and row math
// (sharing one helper with side_acc moved B1's bits on an H100, PERF.md).
// Every kernel reads the one side table, with the launch grid's offsets
// written in (below, "slabs").  Sides are summed in table order
// (class_start[c] .. class_start[c + 1]) in registers: no atomics,
// bitwise-equal repeats.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct __align__(16) Side {
  int co;        // other endpoint's class
  int du;        // co * 6 * Fp + flat shift of the other endpoint
  int dr;        // ei * Fp + flat shift of the instance anchor (r^2 grid)
  int ei;        // template edge (row of r^2)
  int side;      // 0: self is endpoint A, 1: self is endpoint B
  float t[3], a1[3], a2[3];
  float invL;    // 1 / L
  float halfL;   // L / 2
};               // 64 bytes

static_assert(sizeof(Side) == 64, "Side must match the host table layout");

// the float64 instance's record: the same fields with a double frame
struct __align__(16) SideD {
  int co, du, dr, ei, side;
  int pad;
  double t[3], a1[3], a2[3];
  double invL, halfL;
};               // 112 bytes

static_assert(sizeof(SideD) == 112, "SideD must match the host table layout");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ double ld(const double* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(double* p, double v) { *p = v; }
// round to nearest even, as XLA's f32 -> bf16 convert
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One side's force/moment row added to acc, from the self values us, the
// other endpoint's values uo and the side's r^2: the arithmetic every kernel
// shares, whatever memory the values came from.
template <typename C, typename SideT>
__device__ __forceinline__ void side_acc(const SideT& sd, const C us[6],
                                         const C uo[6], C r2, C E, C kG,
                                         C G2, C acc[6]) {
  const C pi = (C)3.14159265358979323846;
  // uB - uA is (other - self) on side A and (self - other) on side B;
  // negating an IEEE difference is exact, so the sign form matches the
  // gather form bit for bit and keeps u in registers
  const C sg = sd.side ? (C)-1 : (C)1;
  const C t0 = sd.t[0], t1 = sd.t[1], t2 = sd.t[2];
  const C b0 = sd.a1[0], b1 = sd.a1[1], b2 = sd.a1[2];
  const C n0 = sd.a2[0], n1 = sd.a2[1], n2 = sd.a2[2];
  const C invL = sd.invL;

  const C du0 = sg * (uo[0] - us[0]), du1 = sg * (uo[1] - us[1]),
          du2 = sg * (uo[2] - us[2]);
  const C th0 = us[3] + uo[3], th1 = us[4] + uo[4], th2 = us[5] + uo[5];
  const C dt0 = sg * (uo[3] - us[3]), dt1 = sg * (uo[4] - us[4]),
          dt2 = sg * (uo[5] - us[5]);

  const C e0 = (du0 * t0 + du1 * t1 + du2 * t2) * invL;
  const C e1 = (du0 * b0 + du1 * b1 + du2 * b2) * invL
             - (th0 * n0 + th1 * n1 + th2 * n2) * (C)0.5;
  const C e2 = (du0 * n0 + du1 * n1 + du2 * n2) * invL
             + (th0 * b0 + th1 * b1 + th2 * b2) * (C)0.5;
  const C e3 = (dt0 * t0 + dt1 * t1 + dt2 * t2) * invL;
  const C e4 = (dt0 * b0 + dt1 * b1 + dt2 * b2) * invL;
  const C e5 = (dt0 * n0 + dt1 * n1 + dt2 * n2) * invL;

  const C S = pi * r2;
  const C I = pi * r2 * r2 * (C)0.25;
  const C s0 = (E * S) * e0, s1 = (kG * S) * e1, s2 = (kG * S) * e2;
  const C s3 = (G2 * I) * e3, s4 = (E * I) * e4, s5 = (E * I) * e5;

  const C fu0 = s0 * t0 + s1 * b0 + s2 * n0;
  const C fu1 = s0 * t1 + s1 * b1 + s2 * n1;
  const C fu2 = s0 * t2 + s1 * b2 + s2 * n2;
  const C hl = sd.halfL;
  const C ms0 = hl * (s2 * b0 - s1 * n0);
  const C ms1 = hl * (s2 * b1 - s1 * n1);
  const C ms2 = hl * (s2 * b2 - s1 * n2);
  const C md0 = s3 * t0 + s4 * b0 + s5 * n0;
  const C md1 = s3 * t1 + s4 * b1 + s5 * n1;
  const C md2 = s3 * t2 + s4 * b2 + s5 * n2;
  // side A: fA = [-fu, msh - mdf]; side B: fB = [fu, msh + mdf].  sf is
  // +-1, so sf * v is exact and fma(sf, v, a) is the rounded a -+ v: the
  // signed sum, with no branch or select per value
  const C sf = -sg;
  acc[0] = fma(sf, fu0, acc[0]);
  acc[1] = fma(sf, fu1, acc[1]);
  acc[2] = fma(sf, fu2, acc[2]);
  acc[3] += fma(sf, md0, ms0);
  acc[4] += fma(sf, md1, ms1);
  acc[5] += fma(sf, md2, ms2);
}

// ------------------------------------------------------------------ slabs
// B1 (stencil_matvec.cu), B3 and B4 (mg_fused.cu) run one block per slab:
// a run of `run` consecutive points of one padded x-plane, in the plane's
// flat (y, z) order, for every class, one thread per (class, point):
// thread t computes point t % run of the slab for class t / run, so a
// block holds nc * run threads.  The host picks run, the largest power of
// two with nc * run <= SLAB_THREADS (kernels/stencil.py slab_plan), and
// refuses a template of more than SLAB_THREADS classes.  Consecutive
// threads then read consecutive addresses for every operand, ghost
// columns included, and a block's classes share their neighbours in L1.
// The side table every kernel reads holds offsets for the launch's grid
// (the host writes them, StencilMatvec.tables): du = co * 6 * Fp + du is
// the other endpoint's first row from the output point, dr = ei * Fp + dr
// the side's r^2 from the point's own r^2 position, so each operand is
// one add and one load; the records are 16-byte aligned and load as four
// (seven) 16-byte words, the same address in every thread of a warp.
// Index arithmetic is 32-bit (the host refuses a grid whose rows pass
// 2^31 points).  A side's shift reaches at most SLAB_HALO points per
// axis, the ghost padding (the host refuses a template that reaches
// farther).
#define SLAB_HALO 1
#define SLAB_THREADS 128

// K.u at the padded point q (flat in the padded field, row stride Fp) of
// class c: self values at u + q, a side's other endpoint at u + q + du
// and its r^2 at r2q + dr (r2q = r^2 + q), the sides of class c in table
// order, each through side_acc.
template <typename C, typename SideT, typename T, typename TR>
__device__ __forceinline__ void slab_acc(
    const T* __restrict__ u, int Fp, int q, const TR* __restrict__ r2q,
    int c, const SideT* __restrict__ sides, int s_begin, int s_end, C E,
    C kG, C G2, C acc[6]) {
  C us[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) us[k] = ld(u + (c * 6 + k) * Fp + q);
  for (int s = s_begin; s < s_end; ++s) {
    const SideT& sd = sides[s];
    const T* ub = u + q + sd.du;
    C uo[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) uo[k] = ld(ub + k * Fp);
    const C r2 = ld(r2q + sd.dr);
    side_acc<C, SideT>(sd, us, uo, r2, E, kG, G2, acc);
  }
}

// a slab plan the kernels can run: a run of a power of two of points,
// every class of a point its own thread, at most SLAB_THREADS threads
__host__ inline bool slab_plan_ok(int run, int nc) {
  return run >= 1 && (run & (run - 1)) == 0 && nc >= 1
      && nc * run <= SLAB_THREADS;
}
