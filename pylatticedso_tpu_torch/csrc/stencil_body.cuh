// Shared stencil body of the port's kernels: K.u at one output point.
//
// Used by B1/B2 (stencil_matvec.cu) and by B3-B5 (mg_fused.cu), the
// counterpart of make_stencil_acc in pylatticedso_tpu/parallel/
// stencil_pallas.py, which the TPU kernels share the same way.  It computes
// the math of the gather form (pylatticedso_tpu_torch/parallel/structured.py
// apply_gather): for the output point q of class c and every template-edge
// side whose self class is c, form the six generalized strains e0..e5 from
// u(self, q), u(other, q + du) and r^2(q + dr), the internal forces with
// S = pi r^2, I = pi r^4 / 4, and add the side's force/moment row to acc.
//
// Layout: u is ghost-padded [nc, 6, Xp, Yp, Zp] and r^2 [n_e, Xp, Yp, Zp];
// q is the flat index of an INTERIOR point of the padded grid, so every
// shifted read stays in bounds and reads zeros outside the lattice.
// stencil_acc_t is a template over the compute type C and its side record
// (float with Side, double with SideD): loads of the storage type (float,
// __nv_bfloat16 or double) are widened to C and all arithmetic is C.
// stencil_acc is the float instance every float kernel uses; side_acc is
// the per-side arithmetic, which B5 also calls on values it keeps in
// registers and distributed shared memory.  Sides are
// summed in table order (class_start[c] .. class_start[c + 1]) in
// registers: no atomics, bitwise-equal repeats.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct Side {
  int co;        // other endpoint's class
  int du;        // flat shift of the other endpoint in the padded u grid
  int dr;        // flat shift of the instance anchor in the padded r^2 grid
  int ei;        // template edge (row of r^2)
  int side;      // 0: self is endpoint A, 1: self is endpoint B
  float t[3], a1[3], a2[3];
  float invL;    // 1 / L
  float halfL;   // L / 2
};               // 64 bytes

static_assert(sizeof(Side) == 64, "Side must match the host table layout");

// the float64 instance's record: the same fields with a double frame
struct SideD {
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
  if (sd.side == 0) {        // fA = [-fu, msh - mdf]
    acc[0] += -fu0; acc[1] += -fu1; acc[2] += -fu2;
    acc[3] += ms0 - md0; acc[4] += ms1 - md1; acc[5] += ms2 - md2;
  } else {                   // fB = [fu, msh + mdf]
    acc[0] += fu0; acc[1] += fu1; acc[2] += fu2;
    acc[3] += ms0 + md0; acc[4] += ms1 + md1; acc[5] += ms2 + md2;
  }
}

template <typename C, typename SideT, typename TU, typename TR>
__device__ __forceinline__ void stencil_acc_t(
    const TU* up, const TR* r2p, long long Fp, long long q, int c,
    const SideT* __restrict__ sides, int s_begin, int s_end,
    C E, C kG, C G2, C acc[6]) {
  C us[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) us[k] = ld(up + ((long long)c * 6 + k) * Fp + q);

  for (int s = s_begin; s < s_end; ++s) {
    const SideT& sd = sides[s];
    const TU* uo_base = up + (long long)sd.co * 6 * Fp + q + sd.du;
    C uo[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) uo[k] = ld(uo_base + k * Fp);
    const C r2 = ld(r2p + (long long)sd.ei * Fp + q + sd.dr);
    side_acc<C, SideT>(sd, us, uo, r2, E, kG, G2, acc);
  }
}

template <typename TU, typename TR>
__device__ __forceinline__ void stencil_acc(
    const TU* up, const TR* r2p, long long Fp, long long q, int c,
    const Side* __restrict__ sides, int s_begin, int s_end,
    float E, float kG, float G2, float acc[6]) {
  stencil_acc_t<float, Side>(up, r2p, Fp, q, c, sides, s_begin, s_end,
                             E, kG, G2, acc);
}

// (x, y, z) of the padded flat index q; true when q is an interior point
__device__ __forceinline__ bool interior(long long q, int X, int Y, int Z) {
  const int Yp = Y + 2, Zp = Z + 2;
  const int z = (int)(q % Zp);
  const int y = (int)((q / Zp) % Yp);
  const int x = (int)(q / ((long long)Yp * Zp));
  return x >= 1 && x <= X && y >= 1 && y <= Y && z >= 1 && z <= Z;
}
