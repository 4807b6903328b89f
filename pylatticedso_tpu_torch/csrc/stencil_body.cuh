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
// written in (below, "slabs").  The bf16-compute instances of B3-B5 run
// dense_acc (below, "dense form"): the TPU kernels' other formulation,
// bf16 arithmetic in their order of operations.  Sides are summed in table order
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

// ---------------------------------------------------------- warped sides
// A warped lattice (a node_transform moves the nodes, the grid topology
// stays) carries its frame and length per beam instance, not per template
// edge: the ghost-padded geometry field geo [n_e, 10, Xp, Yp, Zp] of the
// JAX gather form (pylatticedso_tpu/parallel/structured.py:354-374),
// rows 0-8 the frame (t, a1, a2 by xyz), row 9 the length, 1.0 in the
// padding.  A side reads them at its r^2 anchor, as the JAX gather form
// does (:560-565): row k of edge ei at the anchor is r2 position + 9 ei Fp
// + k Fp, since the table's dr already holds ei * Fp.  1 / L is an IEEE
// division in C, as JAX computes 1.0 / L in its dtype (the build has no
// --use_fast_math), and L / 2 is L * 0.5.
//
// SideFrame is what side_acc reads of a side record, held in registers,
// so a warped side goes through side_acc unchanged: the same strain,
// force and row arithmetic in the same order.
template <typename C>
struct SideFrame {
  int side;
  C t[3], a1[3], a2[3];
  C invL, halfL;
};

// the frame of the side whose row k of geometry lies at g + k * Fp
template <typename C, typename T>
__device__ __forceinline__ SideFrame<C> side_frame(const T* __restrict__ g,
                                                   int Fp, int side) {
  SideFrame<C> fr;
  fr.side = side;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    fr.t[k] = ld(g + k * Fp);
    fr.a1[k] = ld(g + (3 + k) * Fp);
    fr.a2[k] = ld(g + (6 + k) * Fp);
  }
  const C L = ld(g + 9 * Fp);
  fr.invL = (C)1 / L;
  fr.halfL = L * (C)0.5;
  return fr;
}

// slab_acc on a warped lattice: the sides of class c in table order, each
// with the frame read at its r^2 anchor (gq = geo + q)
template <typename C, typename SideT, typename T>
__device__ __forceinline__ void slab_acc_warped(
    const T* __restrict__ u, int Fp, int q, const T* __restrict__ r2q,
    const T* __restrict__ gq, int c, const SideT* __restrict__ sides,
    int s_begin, int s_end, C E, C kG, C G2, C acc[6]) {
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
    const SideFrame<C> fr =
        side_frame<C>(gq + sd.dr + 9 * sd.ei * Fp, Fp, sd.side);
    side_acc<C, SideFrame<C>>(fr, us, uo, r2, E, kG, G2, acc);
  }
}

// ------------------------------------------------------------- dense form
// The bf16-compute instances of B3-B5 (mg_fused.cu, PLDSO_MG_FUSED_COMPUTE
// =bf16) follow the TPU kernels' dense form, not the gather form above:
// make_stencil_acc with ct = bfloat16 (stencil_pallas.py:307, its dense
// branch :338-377), which works from a packed table of constant columns
// (_pack_dense_coefs :97).  Per side, from bf16 values of uA, uB and r^2:
//   K  = r2 c0 + (r2 r2) c1             (six stiffness rows)
//   d  = uB - uA,  p3 = uA[3:] + uB[3:]
//   E  = sum over the side's E terms, in order, of src_s col_s
//        (src: d0..d5, then p0..p2)
//   Sd = K E
//   acc[self] = acc[self] + sum over its row terms, in order, of Sd_s col_s
// with every product and sum rounded to bf16 on its own, and acc itself
// held in bf16 (widened to float only by the caller).  In bf16 every
// rounding point shows, so dense_acc repeats these operations in this
// order: the _rn intrinsics keep nvcc from contracting a multiply and an
// add into one fused multiply-add (which rounds once).  The six rows are
// three __nv_bfloat162 pairs, (0,1), (2,3), (4,5); a term is one scalar
// broadcast to a pair times a column.  The host packs each side's columns
// in bf16, rounded from the f32 table as the TPU kernel rounds them
// (kernels/fused.py DenseForm), one slot per source: a slot whose column
// the TPU table skips (all zero) holds zeros here and is summed all the
// same, branch-free.  That never changes acc's bits: a zero term (finite
// values times zeros) added to a partial sum leaves it as it is but for
// the sign of a zero, a zero's sign never reaches a nonzero product or
// sum, and acc, which starts at +0, is never -0, so acc + (-0) is acc.
// The first term of each sum (slot 0, the frame's x components) is never
// a zero column for an orthonormal frame; the host checks it.
#define DENSE_A 9     // E's term slots: d0..d5, p0..p2
#define DENSE_B 6     // the row's term slots: Sd0..Sd5
#define DENSE_COLS (2 + DENSE_A + DENSE_B)
#define DENSE_WORDS 52  // the columns' 51 bf16 pairs, padded to 16 bytes

struct __align__(16) DenseSide {
  // K's two columns, E's nine slots, the row's six; rows in pairs
  __nv_bfloat162 col[DENSE_COLS][3];
};                    // 208 bytes: 13 16-byte words

static_assert(sizeof(DenseSide) == 16 * (DENSE_WORDS / 4),
              "DenseSide must match the host table layout");

// a value of the storage type rounded to bf16 (exact for bf16 storage),
// as the TPU kernel casts its windows to the compute type
__device__ __forceinline__ __nv_bfloat16 ldh(const float* p) {
  return __float2bfloat16_rn(*p);
}
__device__ __forceinline__ __nv_bfloat16 ldh(const __nv_bfloat16* p) {
  return *p;
}

// rows 2i and 2i + 1 of a field with row stride Fp, as one pair
template <typename T>
__device__ __forceinline__ __nv_bfloat162 ldh2(const T* p, int Fp) {
  return __halves2bfloat162(ldh(p), ldh(p + Fp));
}

// a side's columns into registers: 13 16-byte loads, the same address in
// every thread of a warp, through the read-only path
__device__ __forceinline__ void dense_cols(const DenseSide* ds,
                                           __nv_bfloat162 c[DENSE_WORDS]) {
  const uint4* p = reinterpret_cast<const uint4*>(ds);
#pragma unroll
  for (int i = 0; i < DENSE_WORDS / 4; ++i) {
    const uint4 w = __ldg(p + i);
    c[4 * i] = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
    c[4 * i + 1] = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
    c[4 * i + 2] = *reinterpret_cast<const __nv_bfloat162*>(&w.z);
    c[4 * i + 3] = *reinterpret_cast<const __nv_bfloat162*>(&w.w);
  }
}

// One side's dense-form row, from its columns c (dense_cols), the self
// values us, the other endpoint's uo (pairs of rows) and the side's r^2.
__device__ __forceinline__ void dense_row(const __nv_bfloat162 c[DENSE_WORDS],
                                          int side,
                                          const __nv_bfloat162 us[3],
                                          const __nv_bfloat162 uo[3],
                                          __nv_bfloat16 r2,
                                          __nv_bfloat162 row[3]) {
  // side A: uA = self, uB = other; side B the other way round
  __nv_bfloat162 a[3], b[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a[i] = side ? uo[i] : us[i];
    b[i] = side ? us[i] : uo[i];
    d[i] = __hsub2_rn(b[i], a[i]);
  }
  // p3 = uA[3:] + uB[3:]: p0 is the high lane of pair (2,3)
  const __nv_bfloat162 q23 = __hadd2_rn(a[1], b[1]);
  const __nv_bfloat162 p12 = __hadd2_rn(a[2], b[2]);
  const __nv_bfloat162 rr = __bfloat162bfloat162(r2);
  const __nv_bfloat162 r4 = __bfloat162bfloat162(__hmul_rn(r2, r2));
  __nv_bfloat162 K[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    K[i] = __hadd2_rn(__hmul2_rn(rr, c[i]), __hmul2_rn(r4, c[3 + i]));
  const __nv_bfloat162 src[DENSE_A] = {
      __low2bfloat162(d[0]), __high2bfloat162(d[0]),
      __low2bfloat162(d[1]), __high2bfloat162(d[1]),
      __low2bfloat162(d[2]), __high2bfloat162(d[2]),
      __high2bfloat162(q23), __low2bfloat162(p12), __high2bfloat162(p12)};
  // the first term stands alone, every later one is added (col_accum)
  __nv_bfloat162 E[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) E[i] = __hmul2_rn(src[0], c[6 + i]);
#pragma unroll
  for (int s = 1; s < DENSE_A; ++s)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      E[i] = __hadd2_rn(E[i], __hmul2_rn(src[s], c[3 * (2 + s) + i]));
  __nv_bfloat162 Sd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Sd[i] = __hmul2_rn(K[i], E[i]);
  const __nv_bfloat162 sv[DENSE_B] = {
      __low2bfloat162(Sd[0]), __high2bfloat162(Sd[0]),
      __low2bfloat162(Sd[1]), __high2bfloat162(Sd[1]),
      __low2bfloat162(Sd[2]), __high2bfloat162(Sd[2])};
  const int r0 = 3 * (2 + DENSE_A);
#pragma unroll
  for (int i = 0; i < 3; ++i) row[i] = __hmul2_rn(sv[0], c[r0 + i]);
#pragma unroll
  for (int s = 1; s < DENSE_B; ++s)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      row[i] = __hadd2_rn(row[i], __hmul2_rn(sv[s], c[r0 + 3 * s + i]));
}

// One side's dense-form contribution added to acc: its row (dense_row),
// then the add
__device__ __forceinline__ void dense_acc(const __nv_bfloat162 c[DENSE_WORDS],
                                          int side,
                                          const __nv_bfloat162 us[3],
                                          const __nv_bfloat162 uo[3],
                                          __nv_bfloat16 r2,
                                          __nv_bfloat162 acc[3]) {
  __nv_bfloat162 row[3];
  dense_row(c, side, us, uo, r2, row);
#pragma unroll
  for (int i = 0; i < 3; ++i) acc[i] = __hadd2_rn(acc[i], row[i]);
}

// The dense form of K.u at the padded point q of class c (slab_acc's
// layout and side order), acc widened to float only at the end: bf16
// loads of u (storage T) and r^2 (storage TR), bf16 arithmetic.  Unrolled
// by two so that a side's loads overlap the previous side's arithmetic;
// the sides still add into acc one by one in table order.
template <typename T, typename TR>
__device__ __forceinline__ void slab_dense(
    const T* __restrict__ u, int Fp, int q, const TR* __restrict__ r2q,
    int c, const Side* __restrict__ sides,
    const DenseSide* __restrict__ dense, int s_begin, int s_end,
    float acc[6]) {
  __nv_bfloat162 us[3], a[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    us[i] = ldh2(u + (c * 6 + 2 * i) * Fp + q, Fp);
    a[i] = __float2bfloat162_rn(0.f);
  }
#pragma unroll 2
  for (int s = s_begin; s < s_end; ++s) {
    const Side& sd = sides[s];
    __nv_bfloat162 cols[DENSE_WORDS];
    dense_cols(dense + s, cols);
    const T* ub = u + q + sd.du;
    __nv_bfloat162 uo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) uo[i] = ldh2(ub + 2 * i * Fp, Fp);
    dense_acc(cols, sd.side, us, uo, ldh(r2q + sd.dr), a);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[2 * i] = __low2float(a[i]);
    acc[2 * i + 1] = __high2float(a[i]);
  }
}

// a slab plan the kernels can run: a run of a power of two of points,
// every class of a point its own thread, at most SLAB_THREADS threads
__host__ inline bool slab_plan_ok(int run, int nc) {
  return run >= 1 && (run & (run - 1)) == 0 && nc >= 1
      && nc * run <= SLAB_THREADS;
}
