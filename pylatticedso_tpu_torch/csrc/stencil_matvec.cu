// B1 and B2: structured Timoshenko stencil matvec K.u for Hopper (sm_90a),
// one template over the load/store type and the compute type.
//
// B1 (float loads and stores) replaces the TPU kernel of
// pylatticedso_tpu/parallel/stencil_pallas.py make_pallas_matvec ->
// make_call(jnp.float32); B2 (__nv_bfloat16 loads and stores, float
// arithmetic) replaces make_call(jnp.bfloat16), the apply.lo matvec of the
// multigrid's bf16-I/O smoother.  Both compute the math of the gather form
// (pylatticedso_tpu_torch/parallel/structured.py apply_gather), which is
// also their plain version; the per-point body is slab_acc in
// stencil_body.cuh, shared with the fused smoother kernels B3-B5.
//
// B1 has two instances: float (the main path's float32 operator) and
// double (the float64 operator; the JAX package runs float64 through its
// XLA gather form, structured.py:655, so this instance is the port's
// counterpart of that path).  The double instance reads its own side table
// (struct SideD, double frame) and takes double material constants, so
// every operation is float64 and it agrees with the float64 gather form to
// rounding.
//
// B1's VJP (kernels/stencil.py, a torch.autograd.Function, as the TPU
// kernel is a jax.custom_vjp at stencil_pallas.py:575-588): the
// u-cotangent is this same kernel launched on the cotangent g, since K is
// symmetric; the r^2-cotangent, which JAX takes from XLA's VJP of the
// gather form, is stencil_vjp_r2 below, written by hand as well:
//   gr[e, Q] = sum over the two sides of edge e that read r^2 at Q of
//              g(self, q) . dF_side(u(self, q), u(other, q + du)) / dr^2,
// with q = Q - dr the side's output point and dF/dr^2 the side's row with
// dS/dr^2 = pi and dI/dr^2 = pi r^2 / 2.  One thread per beam (edge,
// padded r^2 position) forms the beam's strains and derivative row once
// and dots it with g at both endpoints in a fixed order: no atomics,
// bitwise-equal repeats.  It moves u, g and r^2 in and gr out (4 * (24 +
// 24 + 24 + 24) F = 57.2 MB at 50^3 in float32 -> 17.1 us, bound by
// bytes); a thread loads 25 values (u and g at two endpoints, r^2) and
// forms the beam's strains once for both of its sides.
//
// Layout: u is ghost-padded [nc, 6, Xp, Yp, Zp] and r^2 [n_e, Xp, Yp, Zp]
// (Xp = X + 2, ...); every shifted read of an interior point stays in
// bounds and reads zeros outside the lattice.  B1's output is the
// unpadded [nc, 6, X, Y, Z] field, the r^2-cotangent's the padded [n_e,
// Xp, Yp, Zp] one.  The TPU kernel's flat 1-D tiles, prev/cur/next
// halo blocks, align8 rows and VMEM fit model are not carried over.
//
// Edge sides come from a device table (struct Side, built by
// pylatticedso_tpu_torch/kernels/stencil.py), sorted by self class with
// class_start[c]..class_start[c+1] the sides of class c, in the order of
// the gather form's accumulation, with the launch grid's offsets written
// in (stencil_body.cuh, "slabs"); the r^2-cotangent reads side A's record
// of each edge from the same table.  Nothing of the
// template is baked into the source, so one build serves every template
// (the 16-class hybrid too).
//
// Threads: one block per slab (stencil_body.cuh): a run of consecutive
// points of one padded x-plane, every class, one thread per (class,
// point): runs of 32 points for Octet's 4 classes, 128 threads a block.
// Each thread keeps its own 6 u values and 6 sums in registers and loops
// over its class's sides in table order.  No atomics and a fixed
// summation order: repeated runs are bitwise equal.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores),
// 50^3 Octet (nc = 4, 48 sides, F = 53^3 = 148,877 padded points,
// N = 51^3 = 132,651 interior points): operations ~ 110 * 48 * N =
// 0.70 GFLOP -> 10.5 us for both.  B1 moves 4 * (24 F + 24 F + 24 N) =
// 41.3 MB -> 12.3 us, so it is bound by bytes, barely; B2 moves half of
// that, 20.7 MB -> 6.2 us, so it is bound by operations.  What holds the
// kernel back on the card is neither: the side loop issues ~120
// instructions a side a thread (95 of them float32 arithmetic), its loads
// alone take ~32 us at 50^3 and its arithmetic alone ~36 us, and the two
// overlap only in part (PERF.md).  The slab keeps every warp's
// reads contiguous and shares a block's neighbours across its classes in
// L1; the layouts measured against it and dropped were a shared-memory
// tile of u per 3-D brick of output points (its staging and halo cost
// more than the L1 re-reads it saves, at 1.2-1.7x the slab's time) and
// 3-D brick blocks reading global memory (warps spanning two z-lines,
// 1.1-1.2x in float and bfloat16; in double faster than a slab build
// whose threads looped over classes, but ~1.1x this one, PERF.md).

// B1w, the warped variant (no TPU kernel: the JAX package's Pallas path
// declines warped lattices, stencil_pallas.py:88-92, and runs its XLA
// gather form with per-instance geometry fields, structured.py:354-374
// and :560-565; the port needs a kernel because a CUDA tensor at a kernel
// wrapper never takes the plain form).  The same slab plan, side table
// and side loop as B1 (slab_acc_warped in stencil_body.cuh), each side's
// frame and length read from the geometry field at its r^2 anchor, and
// the warped r^2-cotangent: stencil_vjp_r2_kernel with W, reading the
// beam's frame once at its anchor.  Bound on an H100 SXM at 50^3 Octet:
// the geometry alone is 10 rows of 24 padded edge fields, 143 MB in float
// (286 MB in double) against B1's 41 MB of u, r^2 and output, so B1w is
// bound by bytes: 184 MB -> ~0.055 ms in float, ~0.110 ms in double, if
// each geometry value is read once.  Each instance's frame is read by its
// two sides from two output points, so a simple slab kernel reads it up
// to twice (through L2 when the neighbour slab is near).  A layout that
// derives a1 and a2 from t on the device (4 rows, not 10) is a later
// redesign.
#include "stencil_body.cuh"

// One block per slab (stencil_body.cuh): blockIdx.y is the interior plane
// x, blockIdx.x the run of the padded plane's flat (y, z) points, thread
// t point t % run for class t / run; threads on ghost columns idle.
// `sides` holds the grid's offsets (du, dr).
template <typename T, typename C, typename SideT>
__global__ void __launch_bounds__(SLAB_THREADS)
stencil_matvec_kernel(const T* __restrict__ up, const T* __restrict__ r2p,
                      T* __restrict__ out, const SideT* __restrict__ sides,
                      const int* __restrict__ class_start, int run,
                      int X, int Y, int Z, C E, C kG, C G2) {
  const int Yp = Y + 2, Zp = Z + 2, Fp = (X + 2) * Yp * Zp;
  const int c = threadIdx.x / run;
  const int f = blockIdx.x * run + (threadIdx.x - c * run);
  const int x = blockIdx.y, y = f / Zp - 1, z = f - (y + 1) * Zp - 1;
  if (y < 0 || y >= Y || z < 0 || z >= Z) return;
  const int q = (x + 1) * Yp * Zp + f;
  const int N = X * Y * Z, pt = (x * Y + y) * Z + z;
  C acc[6] = {0, 0, 0, 0, 0, 0};
  slab_acc<C, SideT>(up, Fp, q, r2p + q, c, sides, class_start[c],
                     class_start[c + 1], E, kG, G2, acc);
#pragma unroll
  for (int k = 0; k < 6; ++k) st(out + (c * 6 + k) * N + pt, acc[k]);
}

// B1w: stencil_matvec_kernel on a warped lattice, the frames from the
// geometry field geo [n_e, 10, Xp, Yp, Zp] (stencil_body.cuh, "warped
// sides")
template <typename T, typename C, typename SideT>
__global__ void __launch_bounds__(SLAB_THREADS)
stencil_matvec_warped_kernel(const T* __restrict__ up,
                             const T* __restrict__ r2p,
                             const T* __restrict__ geo, T* __restrict__ out,
                             const SideT* __restrict__ sides,
                             const int* __restrict__ class_start, int run,
                             int X, int Y, int Z, C E, C kG, C G2) {
  const int Yp = Y + 2, Zp = Z + 2, Fp = (X + 2) * Yp * Zp;
  const int c = threadIdx.x / run;
  const int f = blockIdx.x * run + (threadIdx.x - c * run);
  const int x = blockIdx.y, y = f / Zp - 1, z = f - (y + 1) * Zp - 1;
  if (y < 0 || y >= Y || z < 0 || z >= Z) return;
  const int q = (x + 1) * Yp * Zp + f;
  const int N = X * Y * Z, pt = (x * Y + y) * Z + z;
  C acc[6] = {0, 0, 0, 0, 0, 0};
  slab_acc_warped<C, SideT>(up, Fp, q, r2p + q, geo + q, c, sides,
                            class_start[c], class_start[c + 1], E, kG, G2,
                            acc);
#pragma unroll
  for (int k = 0; k < 6; ++k) st(out + (c * 6 + k) * N + pt, acc[k]);
}

// The r^2-cotangent, one thread per beam: the beam of template edge e
// anchored at the padded r^2 position Q has endpoint A (class ca) at Q +
// oa and endpoint B (class cb) at Q + ob.  Its two sides see the same
// strains (side B's sign flip of an IEEE difference is exact), so the
// thread forms them once, from u at both endpoints, and the beam's
// r^2-derivative row (fu, ms, md: the force row with dS/dr^2 = pi and
// dI/dr^2 = pi r^2 / 2) once, and writes
//   gr[e, Q] = (gB - gA) . fu + (gA + gB) . ms + (gB - gA) . md
// over the translation (fu) and rotation (ms, md) components: side A's
// gA . [-fu, ms - md] plus side B's gB . [fu, ms + md].  A side whose
// output point is not interior adds nothing (the gather form drops it):
// its g is taken as zero.  An anchor with no interior
// endpoint writes 0; every anchor with an endpoint outside the padded
// grid is one of those (the reach is at most one point per axis), so no
// read leaves the padded grid.  The strain and row math is side_acc's
// (stencil_body.cuh), written out here for the beam's own orientation.
//
// beams[e] = (table row of side A, class A, packed offset oa, packed
// offset ob): bytes ox + 1, oy + 1, oz + 1 of each offset, built by the
// host (kernels/stencil.py beam_table).  Side A's record, with the grid's
// offsets, gives the rest: A's flat point is Q + e * Fp - dr, and u + qA +
// du is B's first row.
//
// One block per run of BEAM_RUN points of one padded plane (blockIdx.y
// the run, blockIdx.z the plane) and BEAM_EDGES edges (blockIdx.x, the
// fastest-varying: the blocks of one stretch of points run together and
// share u and g in L2): a warp per edge, lane l at point l of the run, so
// the edge's records are one address per warp and every load of a warp is
// contiguous.  Threads of 2 or 4 points (a lane's points BEAM_RUN apart)
// were measured and dropped: with the registers they take, neither was
// faster on an H100 in every run (PERF.md).  With W (a warped lattice)
// the beam's frame and length come from the geometry field at its anchor
// Q, rows e * 10 + k, read once for both sides (side_frame); otherwise
// from side A's record, and geo is not read.
#define BEAM_RUN 32
#define BEAM_EDGES (SLAB_THREADS / BEAM_RUN)

// true when the padded point (px, py, pz) shifted by the packed offset o
// is an interior point
__device__ __forceinline__ bool endpoint_interior(int px, int py, int pz,
                                                  int o, int X, int Y,
                                                  int Z) {
  return (unsigned)(px + (o & 0xff) - 2) < (unsigned)X
      && (unsigned)(py + ((o >> 8) & 0xff) - 2) < (unsigned)Y
      && (unsigned)(pz + ((o >> 16) & 0xff) - 2) < (unsigned)Z;
}

template <typename T, typename C, typename SideT, bool W>
__global__ void __launch_bounds__(SLAB_THREADS)
stencil_vjp_r2_kernel(const T* __restrict__ u, const T* __restrict__ g,
                      const T* __restrict__ r2, const T* __restrict__ geo,
                      T* __restrict__ out,
                      const SideT* __restrict__ sides,
                      const int4* __restrict__ beams, int n_e,
                      int X, int Y, int Z, C E, C kG, C G2) {
  const int Yp = Y + 2, Zp = Z + 2, P = Yp * Zp, Fp = (X + 2) * P;
  const int e = blockIdx.x * BEAM_EDGES + threadIdx.x / BEAM_RUN;
  const int f = blockIdx.y * BEAM_RUN + threadIdx.x % BEAM_RUN;
  if (e >= n_e || f >= P) return;
  const int px = blockIdx.z, py = f / Zp, pz = f - py * Zp;
  const int Q = px * P + f;
  const int4 bm = beams[e];
  const bool inA = endpoint_interior(px, py, pz, bm.z, X, Y, Z);
  const bool inB = endpoint_interior(px, py, pz, bm.w, X, Y, Z);
  T* o = out + (e * Fp + Q);
  if (!inA && !inB) {
    st(o, (C)0);
    return;
  }
  const SideT& sd = sides[bm.x];
  const int qA = Q + e * Fp - sd.dr;
  const T* uA = u + (bm.y * 6 * Fp + qA);
  const T* uB = u + (qA + sd.du);
  const T* gA = g + (bm.y * 6 * Fp + qA);
  const T* gB = g + (qA + sd.du);
  // both endpoints of a live beam lie in the padded grid: g is read at
  // both and a non-interior endpoint's value is dropped by a select (so
  // g's ghosts may hold anything)
  C a[6], b[6], la[6], lb[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a[k] = ld(uA + k * Fp);
    b[k] = ld(uB + k * Fp);
    const C ga = ld(gA + k * Fp), gb = ld(gB + k * Fp);
    la[k] = inA ? ga : (C)0;
    lb[k] = inB ? gb : (C)0;
  }
  const C r2v = ld(r2 + (e * Fp + Q));
  const C pi = (C)3.14159265358979323846;
  SideFrame<C> fr;
  if constexpr (W) {
    fr = side_frame<C>(geo + (e * 10 * Fp + Q), Fp, 0);
  } else {
    fr.side = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fr.t[k] = sd.t[k];
      fr.a1[k] = sd.a1[k];
      fr.a2[k] = sd.a2[k];
    }
    fr.invL = sd.invL;
    fr.halfL = sd.halfL;
  }
  const C t0 = fr.t[0], t1 = fr.t[1], t2 = fr.t[2];
  const C b0 = fr.a1[0], b1 = fr.a1[1], b2 = fr.a1[2];
  const C n0 = fr.a2[0], n1 = fr.a2[1], n2 = fr.a2[2];
  const C invL = fr.invL, hl = fr.halfL;
  const C du0 = b[0] - a[0], du1 = b[1] - a[1], du2 = b[2] - a[2];
  const C th0 = a[3] + b[3], th1 = a[4] + b[4], th2 = a[5] + b[5];
  const C dt0 = b[3] - a[3], dt1 = b[4] - a[4], dt2 = b[5] - a[5];
  const C e0 = (du0 * t0 + du1 * t1 + du2 * t2) * invL;
  const C e1 = (du0 * b0 + du1 * b1 + du2 * b2) * invL
             - (th0 * n0 + th1 * n1 + th2 * n2) * (C)0.5;
  const C e2 = (du0 * n0 + du1 * n1 + du2 * n2) * invL
             + (th0 * b0 + th1 * b1 + th2 * b2) * (C)0.5;
  const C e3 = (dt0 * t0 + dt1 * t1 + dt2 * t2) * invL;
  const C e4 = (dt0 * b0 + dt1 * b1 + dt2 * b2) * invL;
  const C e5 = (dt0 * n0 + dt1 * n1 + dt2 * n2) * invL;
  const C dI = (pi * (C)0.5) * r2v;
  const C s0 = (E * pi) * e0, s1 = (kG * pi) * e1, s2 = (kG * pi) * e2;
  const C s3 = G2 * dI * e3, s4 = E * dI * e4, s5 = E * dI * e5;
  const C fu0 = s0 * t0 + s1 * b0 + s2 * n0;
  const C fu1 = s0 * t1 + s1 * b1 + s2 * n1;
  const C fu2 = s0 * t2 + s1 * b2 + s2 * n2;
  const C ms0 = hl * (s2 * b0 - s1 * n0);
  const C ms1 = hl * (s2 * b1 - s1 * n1);
  const C ms2 = hl * (s2 * b2 - s1 * n2);
  const C md0 = s3 * t0 + s4 * b0 + s5 * n0;
  const C md1 = s3 * t1 + s4 * b1 + s5 * n1;
  const C md2 = s3 * t2 + s4 * b2 + s5 * n2;
  st(o, (lb[0] - la[0]) * fu0 + (lb[1] - la[1]) * fu1
            + (lb[2] - la[2]) * fu2 + (la[3] + lb[3]) * ms0
            + (la[4] + lb[4]) * ms1 + (la[5] + lb[5]) * ms2
            + (lb[3] - la[3]) * md0 + (lb[4] - la[4]) * md1
            + (lb[5] - la[5]) * md2);
}

template <typename T, typename C, typename SideT, bool W>
static int launch_vjp(const void* up, const void* gp, const void* r2p,
                      const void* geo, void* out, const void* sides,
                      const void* beams, int n_e, int X, int Y, int Z, C E,
                      C kG, C G2, void* stream) {
  if (n_e < 1 || (W && geo == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_e + BEAM_EDGES - 1) / BEAM_EDGES,
                  ((Y + 2) * (Z + 2) + BEAM_RUN - 1) / BEAM_RUN, X + 2);
  stencil_vjp_r2_kernel<T, C, SideT, W><<<grid, SLAB_THREADS, 0,
                                          (cudaStream_t)stream>>>(
      (const T*)up, (const T*)gp, (const T*)r2p, (const T*)geo, (T*)out,
      (const SideT*)sides, (const int4*)beams, n_e, X, Y, Z, E, kG, G2);
  return (int)cudaGetLastError();
}

template <typename T, typename C, typename SideT>
static int launch_warped(const void* up, const void* r2p, const void* geo,
                         void* out, const void* sides,
                         const void* class_start, int run, int nc, int X,
                         int Y, int Z, C E, C kG, C G2, void* stream) {
  if (!slab_plan_ok(run, nc) || geo == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(((Y + 2) * (Z + 2) + run - 1) / run, X);
  stencil_matvec_warped_kernel<T, C, SideT><<<grid, nc * run, 0,
                                              (cudaStream_t)stream>>>(
      (const T*)up, (const T*)r2p, (const T*)geo, (T*)out,
      (const SideT*)sides, (const int*)class_start, run, X, Y, Z, E, kG,
      G2);
  return (int)cudaGetLastError();
}

template <typename T, typename C, typename SideT>
static int launch(const void* up, const void* r2p, void* out,
                  const void* sides, const void* class_start, int run,
                  int nc, int X, int Y, int Z, C E, C kG, C G2,
                  void* stream) {
  if (!slab_plan_ok(run, nc)) return (int)cudaErrorInvalidValue;
  const dim3 grid(((Y + 2) * (Z + 2) + run - 1) / run, X);
  stencil_matvec_kernel<T, C, SideT><<<grid, nc * run, 0,
                                       (cudaStream_t)stream>>>(
      (const T*)up, (const T*)r2p, (T*)out, (const SideT*)sides,
      (const int*)class_start, run, X, Y, Z, E, kG, G2);
  return (int)cudaGetLastError();
}

// B1 and B2: u and r^2 ghost-padded [nc, 6, Xp, Yp, Zp] and [n_e, Xp, Yp,
// Zp] in the storage type, out [nc, 6, X, Y, Z]; sides and class_start the
// table with the grid's offsets (Side, or SideD for the float64
// instance); run as the host planned it (kernels/stencil.py slab_plan)
extern "C" int stencil_matvec_f32(const void* up, const void* r2p, void* out,
                                  const void* sides, const void* class_start,
                                  int run, int nc, int X, int Y, int Z,
                                  float E, float kG, float G2, void* stream) {
  return launch<float, float, Side>(up, r2p, out, sides, class_start, run,
                                    nc, X, Y, Z, E, kG, G2, stream);
}

extern "C" int stencil_matvec_bf16(const void* up, const void* r2p,
                                   void* out, const void* sides,
                                   const void* class_start, int run, int nc,
                                   int X, int Y, int Z, float E, float kG,
                                   float G2, void* stream) {
  return launch<__nv_bfloat16, float, Side>(up, r2p, out, sides, class_start,
                                            run, nc, X, Y, Z, E, kG, G2,
                                            stream);
}

extern "C" int stencil_matvec_f64(const void* up, const void* r2p, void* out,
                                  const void* sides, const void* class_start,
                                  int run, int nc, int X, int Y, int Z,
                                  double E, double kG, double G2,
                                  void* stream) {
  return launch<double, double, SideD>(up, r2p, out, sides, class_start, run,
                                       nc, X, Y, Z, E, kG, G2, stream);
}

// the r^2-cotangent: u ghost-padded [nc, 6, Xp, Yp, Zp] with zero ghosts,
// g [nc, 6, Xp, Yp, Zp] (its ghost values are dropped), r^2 and out [n_e,
// Xp, Yp, Zp]; sides the table with the grid's offsets (Side, or SideD
// for the float64 instance), beams the host's beam table
// (kernels/stencil.py beam_table)
extern "C" int stencil_vjp_r2_f32(const void* up, const void* gp,
                                  const void* r2p, void* out,
                                  const void* sides, const void* beams,
                                  int n_e, int X, int Y, int Z,
                                  float E, float kG, float G2, void* stream) {
  return launch_vjp<float, float, Side, false>(up, gp, r2p, nullptr, out,
                                               sides, beams, n_e, X, Y, Z,
                                               E, kG, G2, stream);
}

extern "C" int stencil_vjp_r2_f64(const void* up, const void* gp,
                                  const void* r2p, void* out,
                                  const void* sides, const void* beams,
                                  int n_e, int X, int Y, int Z,
                                  double E, double kG, double G2,
                                  void* stream) {
  return launch_vjp<double, double, SideD, false>(up, gp, r2p, nullptr, out,
                                                  sides, beams, n_e, X, Y, Z,
                                                  E, kG, G2, stream);
}

// B1w: B1's arguments with the geometry field geo [n_e, 10, Xp, Yp, Zp]
// (stencil_body.cuh, "warped sides") in the storage type after r^2
extern "C" int stencil_matvec_warped_f32(const void* up, const void* r2p,
                                         const void* geo, void* out,
                                         const void* sides,
                                         const void* class_start, int run,
                                         int nc, int X, int Y, int Z,
                                         float E, float kG, float G2,
                                         void* stream) {
  return launch_warped<float, float, Side>(up, r2p, geo, out, sides,
                                           class_start, run, nc, X, Y, Z, E,
                                           kG, G2, stream);
}

extern "C" int stencil_matvec_warped_f64(const void* up, const void* r2p,
                                         const void* geo, void* out,
                                         const void* sides,
                                         const void* class_start, int run,
                                         int nc, int X, int Y, int Z,
                                         double E, double kG, double G2,
                                         void* stream) {
  return launch_warped<double, double, SideD>(up, r2p, geo, out, sides,
                                              class_start, run, nc, X, Y, Z,
                                              E, kG, G2, stream);
}

// the warped r^2-cotangent: the r^2-cotangent's arguments with geo after
// r^2
extern "C" int stencil_vjp_r2_warped_f32(const void* up, const void* gp,
                                         const void* r2p, const void* geo,
                                         void* out, const void* sides,
                                         const void* beams, int n_e, int X,
                                         int Y, int Z, float E, float kG,
                                         float G2, void* stream) {
  return launch_vjp<float, float, Side, true>(up, gp, r2p, geo, out, sides,
                                              beams, n_e, X, Y, Z, E, kG, G2,
                                              stream);
}

extern "C" int stencil_vjp_r2_warped_f64(const void* up, const void* gp,
                                         const void* r2p, const void* geo,
                                         void* out, const void* sides,
                                         const void* beams, int n_e, int X,
                                         int Y, int Z, double E, double kG,
                                         double G2, void* stream) {
  return launch_vjp<double, double, SideD, true>(up, gp, r2p, geo, out,
                                                 sides, beams, n_e, X, Y, Z,
                                                 E, kG, G2, stream);
}

template <typename K>
static int occupancy(K kernel, int threads) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, threads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// blocks of B1 (dtype 0 float, 1 bfloat16, 2 double) or B1w (3 float, 4
// double) of `threads` threads that one SM holds at once on the current
// device; a negative value is -cudaError
extern "C" int stencil_matvec_occupancy(int dtype, int threads) {
  if (dtype == 0)
    return occupancy(stencil_matvec_kernel<float, float, Side>, threads);
  if (dtype == 1)
    return occupancy(stencil_matvec_kernel<__nv_bfloat16, float, Side>,
                     threads);
  if (dtype == 2)
    return occupancy(stencil_matvec_kernel<double, double, SideD>, threads);
  if (dtype == 3)
    return occupancy(stencil_matvec_warped_kernel<float, float, Side>,
                     threads);
  if (dtype == 4)
    return occupancy(stencil_matvec_warped_kernel<double, double, SideD>,
                     threads);
  return -(int)cudaErrorInvalidValue;
}

// blocks of the r^2-cotangent kernel (dtype 0 float, 2 double; warped: 3
// float, 4 double) that one SM holds at once on the current device; a
// negative value is -cudaError
extern "C" int stencil_vjp_r2_occupancy(int dtype) {
  if (dtype == 0)
    return occupancy(stencil_vjp_r2_kernel<float, float, Side, false>,
                     SLAB_THREADS);
  if (dtype == 2)
    return occupancy(stencil_vjp_r2_kernel<double, double, SideD, false>,
                     SLAB_THREADS);
  if (dtype == 3)
    return occupancy(stencil_vjp_r2_kernel<float, float, Side, true>,
                     SLAB_THREADS);
  if (dtype == 4)
    return occupancy(stencil_vjp_r2_kernel<double, double, SideD, true>,
                     SLAB_THREADS);
  return -(int)cudaErrorInvalidValue;
}
