// B3, B4, B5: the fused multigrid smoother kernels for Hopper (sm_90a).
//
// They replace the TPU kernels of pylatticedso_tpu/parallel/
// stencil_pallas.py's fused smoother (apply.fused), which fold the
// Chebyshev smoother's vector algebra (multigrid.py _chebyshev) into the
// stencil pass:
//   B3 mg_residual   <- _residual_call:  out = fm * (b - K x)
//   B4 mg_cheb_run   <- _cheb_run_call:  one Chebyshev step
//        x1 = x + d,  r1 = r - K d,  d1 = c1 d + (c2 inv_delta) r1 fd,
//        writing x1, r1, d1, or in the final variant only x1 + d1
//   B5 mg_cheb_full  <- _cheb_full_call: a whole smoother in one launch
//        (optional x0 residual, `degree` steps, x + d emitted once)
// Vectors are stored in float or __nv_bfloat16 (the storage dtype); all
// arithmetic is float, and the rounding points are the TPU kernels': every
// B3/B4 output is rounded once to the storage type, while B5 keeps x, r
// and d in float across all its steps and rounds only its output.  c1 and
// c2 are host floats (kernel arguments); 1/theta and 1/delta are read from
// the device pointer sc = [inv_theta, inv_delta], so no launch needs a
// host sync.  r1 is not masked by fm: non-free points carry r values that
// fd = 0 cancels, as in the TPU kernel.
//
// Each kernel has a bf16-compute instance (CB, the launchers' `compute`
// flag; the wrappers name them B3c, B4c, B5c), the TPU kernels' instance
// under PLDSO_MG_FUSED_COMPUTE=bf16 (make_stencil_acc(T, ct=bfloat16),
// stencil_pallas.py:724-729, :761-766, :812-817): K.x is the dense form
// in bf16 arithmetic (stencil_body.cuh dense_acc, from the sides' dense
// records), widened to float; everything else is the float instance's,
// with the Chebyshev update's operations each rounded on their own.  B5c
// keeps x, r and d in float as B5 does and reads d as bf16, rounded once
// when it is published (its own kernel, below).  Bounds as below, with
// the dense form's operations (28 +
// 12 for each term of E and of the row: 208 a side for Octet's 9 + 6
// terms) at the non-tensor bf16 rate, twice the float rate: B3c at 50^3,
// 1.32 GFLOP -> 9.9 us, is bound by bytes as B3 is.
//
// Layout: every vector is ghost-padded [nc, 6, Xp, Yp, Zp] (B1's layout,
// not the TPU kernels' align8 [rows, Fp] flats) and r^2 is
// [n_e, Xp, Yp, Zp].  B3, B4: one thread per (class, padded point) in
// B1's slabs (stencil_body.cuh) over the padded planes: interior threads
// run the shared stencil body (slab_acc) and update their own 6 values;
// ghost threads write zeros, so outputs can come from torch.empty and
// every neighbour read of the next launch sees zero ghosts.  Every kernel
// here reads the one side table, with the grid's offsets.  Sides are
// summed in table order: repeats are bitwise equal.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32), 50^3 Octet level 0
// (24 rows, F = 53^3 padded points, N = 51^3 interior, 48 sides), bf16
// storage, each input read once and each output written once:
//   B3: (4 inputs + 1 output) x 24 F x 2 B = 35.7 MB -> 10.7 us; operations
//       110 x 48 x N = 0.70 GFLOP -> 10.5 us: bound by bytes, barely.
//   B4: (5 inputs + 3 outputs) x 24 F x 2 B = 57.2 MB -> 17.1 us (final:
//       42.9 MB): bound by bytes.
//   B5: on the single levels (7^3, 4^3, 2^3 cells at 50^3) its whole work
//       bounds it at 0.12 us or less, below the cost of a launch: it is
//       bound by the latency of its `degree` dependent phases.
// B3 and B4 are B1's thread layout plus a pointwise epilogue on values the
// thread already holds, so they add no pass over memory around the
// stencil.  Re-reads of d (13 per value) go through L1, as in B1: a
// shared-memory tile of d per brick measured slower than B4's slabs on an
// H100 (PERF.md).  B5 spreads the level over a thread-block cluster (up
// to 16 SMs) so that each thread owns one to four interior items and
// keeps their x, r, d and fd in registers; d, the one vector that
// neighbours read, is exchanged through distributed shared memory with a
// cluster barrier between phases (see the B5 section below).

#include <cooperative_groups.h>

#include "stencil_body.cuh"

#define MAX_DEGREE 64

struct ChebCoefs {
  float c1[MAX_DEGREE];
  float c2[MAX_DEGREE];
};

struct Stencil {
  const Side* sides;
  const int* class_start;
  const DenseSide* dense;    // the sides' dense form, in the same order
  int nc, X, Y, Z;
  float E, kG, G2;
};

// The bf16-compute instances (CB) round every f32 operation of their
// pointwise update on its own, as the plain version and the TPU kernel
// compute it: d1 = c1 d + (c2i r) f, whose multiply and add nvcc would
// otherwise contract into one fused multiply-add
__device__ __forceinline__ float cheb_d_rn(float c1, float d, float c2i,
                                           float r, float f) {
  return __fadd_rn(__fmul_rn(c1, d), __fmul_rn(__fmul_rn(c2i, r), f));
}

// ------------------------------------------------------------------ B3
// One block per slab of PADDED points, as B4 (below): blockIdx.y is the
// padded plane, blockIdx.x the run of its flat (y, z) points, thread t
// point t % run for class t / run.  Interior points run the stencil on x
// and write fm (b - K x), rounded once to the storage type; ghost points
// write zeros, so out can come from torch.empty.  `sides` holds the
// grid's offsets.  CB: K x in the dense form's bf16 arithmetic
// (slab_dense), widened to float for the same update.
template <typename T, bool CB>
__global__ void __launch_bounds__(SLAB_THREADS)
mg_residual_kernel(const T* __restrict__ x, const T* __restrict__ b,
                   const T* __restrict__ fm, const T* __restrict__ r2,
                   T* __restrict__ out, Stencil s, int run) {
  const int Yp = s.Y + 2, Zp = s.Z + 2, Fp = (s.X + 2) * Yp * Zp;
  const int c = threadIdx.x / run;
  const int f = blockIdx.x * run + (threadIdx.x - c * run);
  if (f >= Yp * Zp) return;
  const int px = blockIdx.y, py = f / Zp, pz = f - py * Zp;
  const int q = px * Yp * Zp + f;
  if (px < 1 || px > s.X || py < 1 || py > s.Y || pz < 1 || pz > s.Z) {
#pragma unroll
    for (int k = 0; k < 6; ++k) st(out + (c * 6 + k) * Fp + q, 0.f);
    return;
  }
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (CB)
    slab_dense<T, T>(x, Fp, q, r2 + q, c, s.sides, s.dense,
                     s.class_start[c], s.class_start[c + 1], acc);
  else
    slab_acc<float, Side>(x, Fp, q, r2 + q, c, s.sides, s.class_start[c],
                          s.class_start[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int o = (c * 6 + k) * Fp + q;
    st(out + o, ld(fm + o) * (ld(b + o) - acc[k]));
  }
}

// ------------------------------------------------------------------ B4
// One block per slab of PADDED points (stencil_body.cuh): blockIdx.y is
// the padded plane, blockIdx.x the run of its flat (y, z) points, thread
// t point t % run for class t / run.  Interior points run the stencil on
// d and update their own values (x, r, fd and the centre d read once);
// ghost points write zeros, so outputs can come from torch.empty and
// every neighbour read of the next launch sees zero ghosts.  `sides`
// holds the grid's offsets.  CB: K d in the dense form's bf16 arithmetic
// (slab_dense on d rounded to bf16), the update in float on the stored d.
template <typename T, bool FINAL, bool CB>
__global__ void __launch_bounds__(SLAB_THREADS)
mg_cheb_run_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ d, const T* __restrict__ fd,
                   const float* __restrict__ sc, const T* __restrict__ r2,
                   T* __restrict__ x1o, T* __restrict__ r1o,
                   T* __restrict__ d1o, float c1, float c2, Stencil s,
                   int run) {
  const int Yp = s.Y + 2, Zp = s.Z + 2, Fp = (s.X + 2) * Yp * Zp;
  const int c = threadIdx.x / run;
  const int f = blockIdx.x * run + (threadIdx.x - c * run);
  if (f >= Yp * Zp) return;
  const int px = blockIdx.y, py = f / Zp, pz = f - py * Zp;
  const int q = px * Yp * Zp + f;
  if (px < 1 || px > s.X || py < 1 || py > s.Y || pz < 1 || pz > s.Z) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int o = (c * 6 + k) * Fp + q;
      st(x1o + o, 0.f);
      if (!FINAL) {
        st(r1o + o, 0.f);
        st(d1o + o, 0.f);
      }
    }
    return;
  }
  const float c2i = c2 * sc[1];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (CB)
    slab_dense<T, T>(d, Fp, q, r2 + q, c, s.sides, s.dense,
                     s.class_start[c], s.class_start[c + 1], acc);
  else
    slab_acc<float, Side>(d, Fp, q, r2 + q, c, s.sides, s.class_start[c],
                          s.class_start[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int o = (c * 6 + k) * Fp + q;
    const float dc = ld(d + o);
    const float x1 = ld(x + o) + dc;
    const float r1 = ld(r + o) - acc[k];
    const float d1 = CB ? cheb_d_rn(c1, dc, c2i, r1, ld(fd + o))
                        : c1 * dc + (c2i * r1) * ld(fd + o);
    if (FINAL) {
      st(x1o + o, x1 + d1);
    } else {
      st(x1o + o, x1);
      st(r1o + o, r1);
      st(d1o + o, d1);
    }
  }
}

// ------------------------------------------------------------------ B5
// One thread-block cluster per launch.  Block `rank` owns the interior
// items [rank * per_block, min((rank + 1) * per_block, n_items)) of the
// level's interior list `items` ((class << 22) | padded point, in ascending
// order, planned on the host); thread t owns the items rank * per_block + t
// + j * blockDim.x for j < ipt.  Each thread keeps x, r, d and fd of its
// items in registers across all steps.  The sides table, class_start and
// (where it fits) r^2 are staged in shared memory once per launch.  d, the
// one vector that neighbours read, lives in one of two layouts:
//   B5_BCAST:  every block keeps a full copy of d in its shared memory and
//              broadcasts its own updates into every block's copy with
//              distributed-shared-memory stores; stencil reads are local
//              (faster at every cluster size than reading a neighbour from
//              its owner's shared memory through cluster.map_shared_rank,
//              the layout it was measured against);
//   B5_GLOBAL: d in a float global scratch buffer (a level whose d does not
//              fit shared memory), written with st.cg and read with ld.cg.
// A cluster barrier separates the phases (__syncthreads for a cluster of
// one block).  Every item is computed by one thread with the same
// arithmetic whatever the cluster size or layout, so the result does not
// depend on either.
#define B5_MAX_THREADS 256
#define B5_MAX_IPT 4
#define B5_MAX_CLUSTER 16
#define B5_Q_BITS 22
enum { B5_BCAST = 0, B5_GLOBAL = 1 };

struct B5Plan {
  int cluster, threads, ipt, per_block, n_items, n_sides, n_e, r2_smem;
  int group, kmax;                // B5c only (B5: 1 and 0): G, and the
                                  // rows a lane computes per item
};

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// copy `bytes` from global to shared memory, 16 bytes a thread when src
// is 16-byte aligned (dst always is)
__device__ __forceinline__ void b5_stage(void* dst, const void* src,
                                         long long bytes) {
  const int t = threadIdx.x, nt = blockDim.x;
  long long done = 0;
  if ((((unsigned long long)src) & 15) == 0) {
    const long long n16 = bytes >> 4;
    for (long long i = t; i < n16; i += nt)
      ((uint4*)dst)[i] = ((const uint4*)src)[i];
    done = n16 << 4;
  }
  for (long long i = done + t; i < bytes; i += nt)
    ((unsigned char*)dst)[i] = ((const unsigned char*)src)[i];
}

// K.d at one item: self values from registers, neighbours from the
// layout.  Unrolled by two so that a side's loads and forces overlap the
// previous side's; the sides still add into acc one by one in table order.
template <int LAYOUT, typename TR>
__device__ __forceinline__ void b5_stencil(
    const float* d, const TR* r2, int Fp, int q, const float us[6],
    const Side* sides, int s_begin, int s_end, float E, float kG, float G2,
    float acc[6]) {
#pragma unroll 2
  for (int s = s_begin; s < s_end; ++s) {
    const Side& sd = sides[s];
    const int base = q + sd.du;
    float uo[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      uo[k] = LAYOUT == B5_GLOBAL ? __ldcg(d + base + k * Fp)
                                  : d[base + k * Fp];
    const float r2v = ld(r2 + q + sd.dr);
    side_acc<float, Side>(sd, us, uo, r2v, E, kG, G2, acc);
  }
}

// write a thread's new d value at flat offset o into the layout
template <int LAYOUT>
__device__ __forceinline__ void b5_put(float* d,
                                       cooperative_groups::cluster_group& cl,
                                       int ncl, int o, float v) {
  if (LAYOUT == B5_GLOBAL) {
    __stcg(d + o, v);
  } else if (ncl == 1) {
    d[o] = v;
  } else {
    for (int r = 0; r < ncl; ++r) cl.map_shared_rank(d, r)[o] = v;
  }
}

// the barrier between phases: the cluster's, or the block's when the
// cluster is one block (global writes are fenced first)
template <int LAYOUT>
__device__ __forceinline__ void b5_sync(cooperative_groups::cluster_group& cl,
                                        int ncl) {
  if (LAYOUT == B5_GLOBAL) __threadfence();
  if (ncl == 1)
    __syncthreads();
  else
    cl.sync();
}

template <typename T, bool WITH_X0, int LAYOUT>
__global__ void __launch_bounds__(B5_MAX_THREADS, 1)
mg_cheb_full_kernel(const T* __restrict__ b, const T* __restrict__ x0,
                    const T* __restrict__ fd, const float* __restrict__ sc,
                    const T* __restrict__ r2g, T* __restrict__ out,
                    float* __restrict__ dg, const int* __restrict__ items,
                    ChebCoefs cf, int degree, B5Plan p, Stencil s) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nc = s.nc;
  const int Fp = (s.X + 2) * (s.Y + 2) * (s.Z + 2);

  unsigned char* sp = smem;
  Side* sides = (Side*)sp;
  sp += align16((long long)p.n_sides * sizeof(Side));
  int* cstart = (int*)sp;
  sp += align16(4LL * (nc + 1));
  float* d = dg;
  if (LAYOUT == B5_BCAST) {
    d = (float*)sp;
    sp += align16(4LL * nc * 6 * Fp);
  }
  const T* r2 = p.r2_smem ? (const T*)sp : r2g;
  if (p.r2_smem) sp += align16((long long)sizeof(T) * p.n_e * Fp);
  // the host sized the dynamic shared memory (kernels/fused.py
  // b5_smem_bytes): a launch given less than this carve-up is a fault
  unsigned dyn_smem;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_smem));
  if (sp - smem > (long long)dyn_smem) __trap();

  b5_stage(sides, s.sides, (long long)p.n_sides * sizeof(Side));
  b5_stage(cstart, s.class_start, 4LL * (nc + 1));
  if (p.r2_smem)
    b5_stage((void*)r2, r2g, (long long)sizeof(T) * p.n_e * Fp);
  if (LAYOUT == B5_BCAST) {
    const int n = nc * 6 * Fp;          // zero d, ghosts included
    for (int i = tid; i < (n >> 2); i += nthr)
      ((float4*)d)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = ((n >> 2) << 2) + tid; i < n; i += nthr) d[i] = 0.f;
  }
  // zero ghosts of out (and of d in global scratch): this block's share of
  // the padded points, the one division per point of the launch
  const int Yp = s.Y + 2, Zp = s.Z + 2;
  for (int i = rank * nthr + tid; i < nc * Fp; i += p.cluster * nthr) {
    const int c = i / Fp, q = i - c * Fp;
    const int px = q / (Yp * Zp), f = q - px * (Yp * Zp);
    const int py = f / Zp, pz = f - py * Zp;
    if (px >= 1 && px <= s.X && py >= 1 && py <= s.Y && pz >= 1
        && pz <= s.Z)
      continue;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      st(out + (c * 6 + k) * Fp + q, 0.f);
      if (LAYOUT == B5_GLOBAL) __stcg(dg + (c * 6 + k) * Fp + q, 0.f);
    }
  }

  const float inv_theta = sc[0], inv_delta = sc[1];
  const int i0 = rank * p.per_block;
  const int i1 = min(i0 + p.per_block, p.n_items);
  bool have[B5_MAX_IPT];
  int qq[B5_MAX_IPT], cc[B5_MAX_IPT];
  float x[B5_MAX_IPT][6], r[B5_MAX_IPT][6], dv[B5_MAX_IPT][6],
      f[B5_MAX_IPT][6];
#pragma unroll
  for (int j = 0; j < B5_MAX_IPT; ++j) {
    const int i = i0 + tid + j * nthr;
    have[j] = j < p.ipt && i < i1;
    const int e = have[j] ? items[i] : 0;
    cc[j] = e >> B5_Q_BITS;
    qq[j] = e & ((1 << B5_Q_BITS) - 1);
  }
  // staged tables and zeroed d ready in every block; every block of the
  // cluster has started before any distributed-shared-memory access
  b5_sync<LAYOUT>(cl, p.cluster);

  // x = x0 (or 0), r = b - K x0 (or b), d = (r fd) inv_theta
#pragma unroll
  for (int j = 0; j < B5_MAX_IPT; ++j) {
    if (!have[j]) continue;
    const int c = cc[j], q = qq[j];
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (WITH_X0)
      slab_acc<float, Side>(x0, Fp, q, r2 + q, c, sides, cstart[c],
                            cstart[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int o = (c * 6 + k) * Fp + q;
      const float xv = WITH_X0 ? ld(x0 + o) : 0.f;
      const float rv = WITH_X0 ? ld(b + o) - acc[k] : ld(b + o);
      const float fv = ld(fd + o);
      x[j][k] = xv;
      r[j][k] = rv;
      f[j][k] = fv;
      dv[j][k] = (rv * fv) * inv_theta;
    }
  }

  for (int step = 0; step < degree; ++step) {
    // publish d, then every block reads its neighbours' d
#pragma unroll
    for (int j = 0; j < B5_MAX_IPT; ++j) {
      if (!have[j]) continue;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        b5_put<LAYOUT>(d, cl, p.cluster, (cc[j] * 6 + k) * Fp + qq[j],
                       dv[j][k]);
    }
    b5_sync<LAYOUT>(cl, p.cluster);
    // x += d, r -= K d, d = c1 d + (c2 inv_delta) r fd
    const float c1 = cf.c1[step];
    const float c2i = cf.c2[step] * inv_delta;
#pragma unroll
    for (int j = 0; j < B5_MAX_IPT; ++j) {
      if (!have[j]) continue;
      const int c = cc[j];
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      b5_stencil<LAYOUT>(d, r2, Fp, qq[j], dv[j], sides, cstart[c],
                         cstart[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        x[j][k] = x[j][k] + dv[j][k];
        r[j][k] = r[j][k] - acc[k];
        dv[j][k] = c1 * dv[j][k] + (c2i * r[j][k]) * f[j][k];
      }
    }
    // no block overwrites d before every block has read it
    if (step + 1 < degree) b5_sync<LAYOUT>(cl, p.cluster);
  }

#pragma unroll
  for (int j = 0; j < B5_MAX_IPT; ++j) {
    if (!have[j]) continue;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      st(out + (cc[j] * 6 + k) * Fp + qq[j], x[j][k] + dv[j][k]);
  }
}

// ----------------------------------------------------------------- B5c
// B5's bf16-compute instance (CB), laid out for the latency of the single
// levels: B5 runs 1-2 warps a scheduler there, each thread adding its
// class's 12 sides one after another, ~218 dependent bf16 instructions a
// side (PERF.md).  B5's plan (one cluster per launch, contiguous items per
// block, the same phases and barriers) with these changes:
//   side-parallel rows: an item is owned by a group of G consecutive lanes
//     of one warp (32 / G groups a warp; the lanes past them idle).  Lane j
//     computes the dense rows of sides s_begin + j, s_begin + j + G, ...
//     of the item's class (dense_row: dense_acc's operations, stopped at
//     the row) into a warp-private slice of shared memory; after
//     __syncwarp the lane that owns pair i of the item adds word i of the
//     rows into a bf16 zero in table order: the plain version's sum
//     (DenseForm.plain adds the rows one by one), with no block or cluster
//     barrier added;
//   d in bf16 pairs: the copy of d every block reads holds rows (2i, 2i+1)
//     as one bf16x2 word, [class, 3, Fp], rounded once, when the owner
//     publishes it.  The TPU kernel rounds its float d to the compute type
//     at every stencil read (make_stencil_acc(T_full, ct)), and a value
//     rounds the same whenever it is rounded.  It halves the broadcast
//     stores and turns a side's six loads and three conversions into three
//     loads; the global layout keeps the same words in its scratch;
//   the item's x, r, d and fd stay in float, in shared memory: pair i of
//     an item belongs to lane i % G of its group (slot i / G), which adds
//     its rows, updates and publishes it, so a thread's registers hold one
//     side's row, not four vectors of six per item;
//   the sides' dense records are staged in shared memory once per launch,
//     beside the side table.
// The plan (kernels/fused.py b5_plan) picks the cluster, G and the layout
// of d per level from a sweep on the card.  On an H100 (PERF.md §6) the
// 7^3 and 4^3 levels gain the most; the coarsest level's degree-24 sweep
// gains least: its 25 phases stay bound by the issue of ~220 instructions
// a row on one to eight SMs and by the cluster's barrier.  Every value has
// B5c's arithmetic whatever the cluster, layout or G, so all of them give
// the same bits.
#define B5C_MAX_THREADS 1024
#define B5C_MAX_GROUP 12

typedef unsigned int bf2w;          // the bits of one __nv_bfloat162

__device__ __forceinline__ bf2w b5c_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const bf2w*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 b5c_word(bf2w w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

// a word of d's copy: shared memory, or global scratch through L2
template <int LAYOUT>
__device__ __forceinline__ __nv_bfloat162 b5c_ld(const bf2w* d, int o) {
  return b5c_word(LAYOUT == B5_GLOBAL ? __ldcg(d + o) : d[o]);
}

template <int LAYOUT>
__device__ __forceinline__ void b5c_put(bf2w* d,
                                        cooperative_groups::cluster_group& cl,
                                        int ncl, int o, bf2w w) {
  if (LAYOUT == B5_GLOBAL) {
    __stcg(d + o, w);
  } else if (ncl == 1) {
    d[o] = w;
  } else {
    for (int r = 0; r < ncl; ++r) cl.map_shared_rank(d, r)[o] = w;
  }
}

// One side's row at the padded point q: the other endpoint from x0
// (storage T, six rows) or from d (bf16 pairs), the columns loaded from
// the staged record (13 16-byte loads).
template <bool FROM_X0, int LAYOUT, typename T>
__device__ __forceinline__ void b5c_row(const Side& sd,
                                        const DenseSide* rec,
                                        const bf2w* d, const T* x0,
                                        const T* r2, int q, int Fp,
                                        const __nv_bfloat162 us[3],
                                        __nv_bfloat162 row[3]) {
  __nv_bfloat162 uo[3];
  if (FROM_X0) {
    const T* ub = x0 + q + sd.du;
#pragma unroll
    for (int i = 0; i < 3; ++i) uo[i] = ldh2(ub + 2 * i * Fp, Fp);
  } else {
    const int base = q + sd.du - sd.co * 3 * Fp;
#pragma unroll
    for (int i = 0; i < 3; ++i) uo[i] = b5c_ld<LAYOUT>(d, base + i * Fp);
  }
  __nv_bfloat162 cols[DENSE_WORDS];
  const uint4* w = reinterpret_cast<const uint4*>(rec);
#pragma unroll
  for (int k = 0; k < DENSE_WORDS / 4; ++k) {
    const uint4 v = w[k];
    cols[4 * k] = b5c_word(v.x);
    cols[4 * k + 1] = b5c_word(v.y);
    cols[4 * k + 2] = b5c_word(v.z);
    cols[4 * k + 3] = b5c_word(v.w);
  }
  dense_row(cols, sd.side, us, uo, ldh(r2 + q + sd.dr), row);
}

// The group's K.u at its item, in the pairs the lane owns: lane j leaves
// the rows of sides s_begin + j + k G (k < kmax) in rows[k][3][nthr];
// after __syncwarp, for each of its pairs i = j + pp G < 3, it adds word
// i of every side's row, s_begin .. s_end - 1, into acc[pp], a bf16 zero.
// Every lane computes kmax rows with no branch, a side past s_end (or of
// an idle lane, whose q is an interior point) as the class's last side,
// whose row no lane reads: the rows of one lane then overlap.
template <bool FROM_X0, int LAYOUT, typename T>
__device__ __forceinline__ void b5c_sum(const Side* sides,
                                        const DenseSide* dense, const bf2w* d,
                                        const T* x0, const T* r2, int q,
                                        int Fp, const __nv_bfloat162 us[3],
                                        bool have, int s_begin, int s_end,
                                        int j, int G, int kmax, bf2w* rows,
                                        int tid, int lane0, int nthr,
                                        __nv_bfloat162 acc[3]) {
#pragma unroll 2
  for (int k = 0; k < kmax; ++k) {
    const int s = max(min(s_begin + k * G + j, s_end - 1), 0);
    __nv_bfloat162 row[3];
    b5c_row<FROM_X0, LAYOUT, T>(sides[s], dense + s, d, x0, r2, q, Fp, us,
                                row);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rows[(k * 3 + i) * nthr + tid] = b5c_bits(row[i]);
  }
  __syncwarp();
#pragma unroll
  for (int pp = 0; pp < 3; ++pp) {
    const int i = j + pp * G;
    acc[pp] = __float2bfloat162_rn(0.f);
    if (!have || i >= 3) continue;
    int k = 0, g = 0;
#pragma unroll 4
    for (int s = s_begin; s < s_end; ++s) {
      acc[pp] = __hadd2_rn(acc[pp],
                           b5c_word(rows[(k * 3 + i) * nthr + lane0 + g]));
      if (++g == G) {
        g = 0;
        ++k;
      }
    }
  }
  // no lane overwrites its rows before the group has read them
  __syncwarp();
}

template <typename T, bool WITH_X0, int LAYOUT>
__global__ void __launch_bounds__(B5C_MAX_THREADS, 1)
mg_cheb_full_dense_kernel(const T* __restrict__ b, const T* __restrict__ x0,
                          const T* __restrict__ fd,
                          const float* __restrict__ sc,
                          const T* __restrict__ r2g, T* __restrict__ out,
                          float* __restrict__ dgf,
                          const int* __restrict__ items, ChebCoefs cf,
                          int degree, B5Plan p, Stencil s) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nc = s.nc;
  const int Fp = (s.X + 2) * (s.Y + 2) * (s.Z + 2);
  bf2w* const dg = reinterpret_cast<bf2w*>(dgf);

  // the carve-up of kernels/fused.py b5_smem_bytes(compute="bf16")
  unsigned char* sp = smem;
  Side* sides = (Side*)sp;
  sp += align16((long long)p.n_sides * sizeof(Side));
  int* cstart = (int*)sp;
  sp += align16(4LL * (nc + 1));
  DenseSide* dense = (DenseSide*)sp;
  sp += align16((long long)p.n_sides * sizeof(DenseSide));
  bf2w* d = dg;
  if (LAYOUT == B5_BCAST) {
    d = (bf2w*)sp;
    sp += align16(4LL * nc * 3 * Fp);
  }
  // the items' state: x, r, d, fd, each [per_block, 3] float pairs
  float2* state = (float2*)sp;
  sp += align16(8LL * 4 * 3 * p.per_block);
  // each thread's rows: [kmax, 3, threads] words
  bf2w* rows = (bf2w*)sp;
  sp += align16(4LL * 3 * p.kmax * nthr);
  const T* r2 = p.r2_smem ? (const T*)sp : r2g;
  if (p.r2_smem) sp += align16((long long)sizeof(T) * p.n_e * Fp);
  unsigned dyn_smem;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn_smem));
  if (sp - smem > (long long)dyn_smem) __trap();

  b5_stage(sides, s.sides, (long long)p.n_sides * sizeof(Side));
  b5_stage(cstart, s.class_start, 4LL * (nc + 1));
  b5_stage(dense, s.dense, (long long)p.n_sides * sizeof(DenseSide));
  if (p.r2_smem)
    b5_stage((void*)r2, r2g, (long long)sizeof(T) * p.n_e * Fp);
  if (LAYOUT == B5_BCAST)
    for (int i = tid; i < nc * 3 * Fp; i += nthr) d[i] = 0u;
  // zero ghosts of out (and of d in global scratch), as B5
  const int Yp = s.Y + 2, Zp = s.Z + 2;
  for (int i = rank * nthr + tid; i < nc * Fp; i += p.cluster * nthr) {
    const int c = i / Fp, q = i - c * Fp;
    const int px = q / (Yp * Zp), f = q - px * (Yp * Zp);
    const int py = f / Zp, pz = f - py * Zp;
    if (px >= 1 && px <= s.X && py >= 1 && py <= s.Y && pz >= 1
        && pz <= s.Z)
      continue;
#pragma unroll
    for (int k = 0; k < 6; ++k) st(out + (c * 6 + k) * Fp + q, 0.f);
    if (LAYOUT == B5_GLOBAL) {
#pragma unroll
      for (int i2 = 0; i2 < 3; ++i2) __stcg(dg + (c * 3 + i2) * Fp + q, 0u);
    }
  }

  // the thread's group: lane j of group g (the lanes past 32 / G groups
  // of a warp own no item)
  const int G = p.group, gpw = 32 / G;
  const int lane = tid & 31, gi = lane / G, j = lane - gi * G;
  const int lane0 = (tid & ~31) + gi * G;
  const int ngroups = (nthr >> 5) * gpw;
  const int g = (tid >> 5) * gpw + gi;
  const int i0 = rank * p.per_block;
  const int i1 = min(i0 + p.per_block, p.n_items);
  const float inv_theta = sc[0], inv_delta = sc[1];
  const int pb = p.per_block;
  // an idle lane's item: class 0 at the first interior point, so that its
  // rows read inside the padded fields
  const int idle = (Yp + 1) * Zp + 1;
  // staged tables and zeroed d ready in every block; every block of the
  // cluster has started before any distributed-shared-memory access
  b5_sync<LAYOUT>(cl, p.cluster);
  int most = 0;
  for (int c = 0; c < nc; ++c) most = max(most, cstart[c + 1] - cstart[c]);
  if ((most + G - 1) / G > p.kmax) __trap();      // the rows' slice is short

  // x = x0 (or 0), r = b - K x0 (or b), d = (r fd) inv_theta
  for (int jj = 0; jj < p.ipt; ++jj) {
    const int sl = g + jj * ngroups;
    const bool have = gi < gpw && i0 + sl < i1;
    const int e = have ? items[i0 + sl] : idle;
    const int c = e >> B5_Q_BITS, q = e & ((1 << B5_Q_BITS) - 1);
    __nv_bfloat162 a[3];
    if (WITH_X0) {
      __nv_bfloat162 us[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        us[i] = have ? ldh2(x0 + (c * 6 + 2 * i) * Fp + q, Fp)
                     : __float2bfloat162_rn(0.f);
      b5c_sum<true, LAYOUT, T>(sides, dense, d, x0, r2, q, Fp, us, have,
                               cstart[c], cstart[c + 1], j, G, p.kmax,
                               rows, tid, lane0, nthr, a);
    }
    if (!have) continue;
#pragma unroll
    for (int pp = 0; pp < 3; ++pp) {
      const int i = j + pp * G;
      if (i >= 3) continue;
      const int o = (c * 6 + 2 * i) * Fp + q;
      float xv[2], rv[2], fv[2], dv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int oh = o + h * Fp;
        const float acc = WITH_X0 ? (h ? __high2float(a[pp])
                                       : __low2float(a[pp])) : 0.f;
        xv[h] = WITH_X0 ? ld(x0 + oh) : 0.f;
        rv[h] = WITH_X0 ? ld(b + oh) - acc : ld(b + oh);
        fv[h] = ld(fd + oh);
        dv[h] = (rv[h] * fv[h]) * inv_theta;
      }
      state[(0 * pb + sl) * 3 + i] = make_float2(xv[0], xv[1]);
      state[(1 * pb + sl) * 3 + i] = make_float2(rv[0], rv[1]);
      state[(2 * pb + sl) * 3 + i] = make_float2(dv[0], dv[1]);
      state[(3 * pb + sl) * 3 + i] = make_float2(fv[0], fv[1]);
    }
  }

  for (int step = 0; step < degree; ++step) {
    // publish d as bf16 pairs, then every block reads its neighbours'
    for (int jj = 0; jj < p.ipt; ++jj) {
      const int sl = g + jj * ngroups;
      if (gi >= gpw || i0 + sl >= i1) continue;
      const int e = items[i0 + sl];
      const int c = e >> B5_Q_BITS, q = e & ((1 << B5_Q_BITS) - 1);
      for (int i = j; i < 3; i += G) {
        const float2 dv = state[(2 * pb + sl) * 3 + i];
        b5c_put<LAYOUT>(d, cl, p.cluster, (c * 3 + i) * Fp + q,
                        b5c_bits(__floats2bfloat162_rn(dv.x, dv.y)));
      }
    }
    b5_sync<LAYOUT>(cl, p.cluster);
    // x += d, r -= K d, d = c1 d + (c2 inv_delta) r fd
    const float c1 = cf.c1[step];
    const float c2i = cf.c2[step] * inv_delta;
    for (int jj = 0; jj < p.ipt; ++jj) {
      const int sl = g + jj * ngroups;
      const bool have = gi < gpw && i0 + sl < i1;
      const int e = have ? items[i0 + sl] : idle;
      const int c = e >> B5_Q_BITS, q = e & ((1 << B5_Q_BITS) - 1);
      __nv_bfloat162 us[3], a[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        us[i] = have ? b5c_ld<LAYOUT>(d, (c * 3 + i) * Fp + q)
                     : __float2bfloat162_rn(0.f);
      b5c_sum<false, LAYOUT, T>(sides, dense, d, x0, r2, q, Fp, us, have,
                                cstart[c], cstart[c + 1], j, G, p.kmax,
                                rows, tid, lane0, nthr, a);
      if (!have) continue;
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) {
        const int i = j + pp * G;
        if (i >= 3) continue;
        float2 x = state[(0 * pb + sl) * 3 + i];
        float2 r = state[(1 * pb + sl) * 3 + i];
        float2 dv = state[(2 * pb + sl) * 3 + i];
        const float2 f = state[(3 * pb + sl) * 3 + i];
        x.x = x.x + dv.x;
        x.y = x.y + dv.y;
        r.x = r.x - __low2float(a[pp]);
        r.y = r.y - __high2float(a[pp]);
        dv.x = cheb_d_rn(c1, dv.x, c2i, r.x, f.x);
        dv.y = cheb_d_rn(c1, dv.y, c2i, r.y, f.y);
        state[(0 * pb + sl) * 3 + i] = x;
        state[(1 * pb + sl) * 3 + i] = r;
        state[(2 * pb + sl) * 3 + i] = dv;
      }
    }
    // no block overwrites d before every block has read it
    if (step + 1 < degree) b5_sync<LAYOUT>(cl, p.cluster);
  }

  for (int jj = 0; jj < p.ipt; ++jj) {
    const int sl = g + jj * ngroups;
    if (gi >= gpw || i0 + sl >= i1) continue;
    const int e = items[i0 + sl];
    const int c = e >> B5_Q_BITS, q = e & ((1 << B5_Q_BITS) - 1);
    for (int i = j; i < 3; i += G) {
      const float2 x = state[(0 * pb + sl) * 3 + i];
      const float2 dv = state[(2 * pb + sl) * 3 + i];
      const int o = (c * 6 + 2 * i) * Fp + q;
      st(out + o, x.x + dv.x);
      st(out + o + Fp, x.y + dv.y);
    }
  }
}

// --------------------------------------------------------------- launchers
// dtype: 0 float, 1 bfloat16 storage; compute: 0 float (the gather form),
// 1 bfloat16 (the dense form, `dense` the sides' dense records in the
// side table's order); any other value is refused.
static Stencil make_stencil(const void* sides, const void* class_start,
                            const void* dense, int nc, int X, int Y, int Z,
                            float E, float kG, float G2) {
  Stencil s;
  s.sides = (const Side*)sides;
  s.class_start = (const int*)class_start;
  s.dense = (const DenseSide*)dense;
  s.nc = nc; s.X = X; s.Y = Y; s.Z = Z;
  s.E = E; s.kG = kG; s.G2 = G2;
  return s;
}

static bool flags_ok(int dtype, int compute, const void* dense) {
  return (dtype == 0 || dtype == 1) && (compute == 0 || compute == 1)
      && (compute == 0 || dense != nullptr);
}

typedef __nv_bfloat16 bf;

template <typename T, bool CB>
static void residual(const dim3& grid, const void* x, const void* b,
                     const void* fm, const void* r2, void* out,
                     const Stencil& s, int run, cudaStream_t stream) {
  mg_residual_kernel<T, CB><<<grid, s.nc * run, 0, stream>>>(
      (const T*)x, (const T*)b, (const T*)fm, (const T*)r2, (T*)out, s, run);
}

// B3: vectors ghost-padded [nc, 6, Xp, Yp, Zp]; sides and class_start the
// table with the grid's offsets; run as the host planned it
// (kernels/stencil.py slab_plan)
extern "C" int mg_residual(int dtype, int compute, const void* x,
                           const void* b, const void* fm, const void* r2,
                           void* out, const void* sides,
                           const void* class_start, const void* dense,
                           int run, int nc, int X, int Y, int Z,
                           float E, float kG, float G2, void* stream) {
  if (!flags_ok(dtype, compute, dense) || !slab_plan_ok(run, nc))
    return (int)cudaErrorInvalidValue;
  const Stencil s = make_stencil(sides, class_start, dense, nc, X, Y, Z, E,
                                 kG, G2);
  const dim3 grid(((Y + 2) * (Z + 2) + run - 1) / run, X + 2);
  cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    compute ? residual<float, true>(grid, x, b, fm, r2, out, s, run, st_)
            : residual<float, false>(grid, x, b, fm, r2, out, s, run, st_);
  else
    compute ? residual<bf, true>(grid, x, b, fm, r2, out, s, run, st_)
            : residual<bf, false>(grid, x, b, fm, r2, out, s, run, st_);
  return (int)cudaGetLastError();
}

template <typename T, bool CB>
static int residual_occupancy(int threads) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, mg_residual_kernel<T, CB>, threads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// blocks of B3 of `threads` threads that one SM holds at once on the
// current device; a negative value is -cudaError
extern "C" int mg_residual_occupancy(int dtype, int compute, int threads) {
  if (!flags_ok(dtype, compute, (const void*)1))
    return -(int)cudaErrorInvalidValue;
  if (dtype == 0)
    return compute ? residual_occupancy<float, true>(threads)
                   : residual_occupancy<float, false>(threads);
  return compute ? residual_occupancy<bf, true>(threads)
                 : residual_occupancy<bf, false>(threads);
}

template <typename T, bool FINAL, bool CB>
static void cheb_run(const void* x, const void* r, const void* d,
                     const void* fd, const void* sc, const void* r2,
                     void* x1, void* r1, void* d1, float c1, float c2,
                     const Stencil& s, int run, cudaStream_t stream) {
  const dim3 grid(((s.Y + 2) * (s.Z + 2) + run - 1) / run, s.X + 2);
  mg_cheb_run_kernel<T, FINAL, CB><<<grid, s.nc * run, 0, stream>>>(
      (const T*)x, (const T*)r, (const T*)d, (const T*)fd, (const float*)sc,
      (const T*)r2, (T*)x1, (T*)r1, (T*)d1, c1, c2, s, run);
}

template <typename T, bool CB>
static void cheb_run_final(int final_, const void* x, const void* r,
                           const void* d, const void* fd, const void* sc,
                           const void* r2, void* x1, void* r1, void* d1,
                           float c1, float c2, const Stencil& s, int run,
                           cudaStream_t stream) {
  if (final_)
    cheb_run<T, true, CB>(x, r, d, fd, sc, r2, x1, r1, d1, c1, c2, s, run,
                          stream);
  else
    cheb_run<T, false, CB>(x, r, d, fd, sc, r2, x1, r1, d1, c1, c2, s, run,
                           stream);
}

// B4: vectors ghost-padded [nc, 6, Xp, Yp, Zp]; sides and class_start the
// table with the grid's offsets; run as the host planned it
// (kernels/stencil.py slab_plan)
extern "C" int mg_cheb_run(int dtype, int compute, int final_,
                           const void* x, const void* r, const void* d,
                           const void* fd, const void* sc, const void* r2,
                           void* x1, void* r1, void* d1, float c1, float c2,
                           const void* sides, const void* class_start,
                           const void* dense, int run, int nc, int X, int Y,
                           int Z, float E, float kG, float G2,
                           void* stream) {
  if (!flags_ok(dtype, compute, dense) || !slab_plan_ok(run, nc))
    return (int)cudaErrorInvalidValue;
  const Stencil s = make_stencil(sides, class_start, dense, nc, X, Y, Z, E,
                                 kG, G2);
  cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0 && compute)
    cheb_run_final<float, true>(final_, x, r, d, fd, sc, r2, x1, r1, d1, c1,
                                c2, s, run, st_);
  else if (dtype == 0)
    cheb_run_final<float, false>(final_, x, r, d, fd, sc, r2, x1, r1, d1,
                                 c1, c2, s, run, st_);
  else if (compute)
    cheb_run_final<bf, true>(final_, x, r, d, fd, sc, r2, x1, r1, d1, c1,
                             c2, s, run, st_);
  else
    cheb_run_final<bf, false>(final_, x, r, d, fd, sc, r2, x1, r1, d1, c1,
                              c2, s, run, st_);
  return (int)cudaGetLastError();
}

template <typename T, bool FINAL, bool CB>
static int cheb_run_occupancy(int threads) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, mg_cheb_run_kernel<T, FINAL, CB>, threads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, bool CB>
static int cheb_run_occupancy_final(int final_, int threads) {
  return final_ ? cheb_run_occupancy<T, true, CB>(threads)
                : cheb_run_occupancy<T, false, CB>(threads);
}

// blocks of B4 of `threads` threads that one SM holds at once on the
// current device; a negative value is -cudaError
extern "C" int mg_cheb_run_occupancy(int dtype, int compute, int final_,
                                     int threads) {
  if (!flags_ok(dtype, compute, (const void*)1))
    return -(int)cudaErrorInvalidValue;
  if (dtype == 0)
    return compute ? cheb_run_occupancy_final<float, true>(final_, threads)
                   : cheb_run_occupancy_final<float, false>(final_, threads);
  return compute ? cheb_run_occupancy_final<bf, true>(final_, threads)
                 : cheb_run_occupancy_final<bf, false>(final_, threads);
}

// largest dynamic shared memory one block may use on sm_90 (232,448 bytes)
static const int MAX_SMEM = 227 * 1024;
static const int MAX_DEVICES = 64;

// the kernel of B5 (CB false) or of B5c, storage T
template <typename T, bool WITH_X0, int LAYOUT, bool CB>
static auto cheb_full_fn() {
  if constexpr (CB)
    return mg_cheb_full_dense_kernel<T, WITH_X0, LAYOUT>;
  else
    return mg_cheb_full_kernel<T, WITH_X0, LAYOUT>;
}

// B5's function attributes, set once per device (they are per-device
// state), each call's return code checked
template <typename T, bool WITH_X0, int LAYOUT, bool CB>
static cudaError_t cheb_full_attrs() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  auto kern = cheb_full_fn<T, WITH_X0, LAYOUT, CB>();
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

struct ChebFullArgs {
  const void *b, *x0, *fd, *sc, *r2;
  void *out, *dg;
  const void* items;
};

static cudaLaunchConfig_t cluster_config(const B5Plan& p, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool WITH_X0, int LAYOUT, bool CB>
static int cheb_full(const ChebFullArgs& a, const ChebCoefs& cf, int degree,
                     const B5Plan& p, const Stencil& s, size_t smem,
                     cudaStream_t stream) {
  cudaError_t e = cheb_full_attrs<T, WITH_X0, LAYOUT, CB>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(p, smem, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, cheb_full_fn<T, WITH_X0, LAYOUT, CB>(),
                         (const T*)a.b, (const T*)a.x0, (const T*)a.fd,
                         (const float*)a.sc, (const T*)a.r2, (T*)a.out,
                         (float*)a.dg, (const int*)a.items, cf, degree, p,
                         s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the instance of B5 for (with_x0, layout, compute), storage T
template <typename T>
static int cheb_full_instance(int with_x0, int layout, int compute,
                              const ChebFullArgs& a, const ChebCoefs& cf,
                              int degree, const B5Plan& p, const Stencil& s,
                              size_t smem, cudaStream_t st) {
  const int k = (with_x0 ? 4 : 0) + (layout == B5_GLOBAL ? 2 : 0)
              + (compute ? 1 : 0);
  switch (k) {
    case 0: return cheb_full<T, false, B5_BCAST, false>(a, cf, degree, p, s,
                                                        smem, st);
    case 1: return cheb_full<T, false, B5_BCAST, true>(a, cf, degree, p, s,
                                                       smem, st);
    case 2: return cheb_full<T, false, B5_GLOBAL, false>(a, cf, degree, p, s,
                                                         smem, st);
    case 3: return cheb_full<T, false, B5_GLOBAL, true>(a, cf, degree, p, s,
                                                        smem, st);
    case 4: return cheb_full<T, true, B5_BCAST, false>(a, cf, degree, p, s,
                                                       smem, st);
    case 5: return cheb_full<T, true, B5_BCAST, true>(a, cf, degree, p, s,
                                                      smem, st);
    case 6: return cheb_full<T, true, B5_GLOBAL, false>(a, cf, degree, p, s,
                                                        smem, st);
    default: return cheb_full<T, true, B5_GLOBAL, true>(a, cf, degree, p, s,
                                                        smem, st);
  }
}

static B5Plan make_plan(int cluster, int threads, int ipt, int per_block,
                        int n_items, int n_sides, int n_e, int r2_smem,
                        int group, int kmax) {
  B5Plan p;
  p.cluster = cluster; p.threads = threads; p.ipt = ipt;
  p.per_block = per_block; p.n_items = n_items; p.n_sides = n_sides;
  p.n_e = n_e; p.r2_smem = r2_smem; p.group = group;
  p.kmax = kmax;
  return p;
}

// a plan the kernel can run: the partition covers n_items, the sizes are
// within the kernel's limits and the shared memory the host sized for it
// fits one block.  B5: one thread per item slot; B5c: whole warps, 32 / G
// groups of G lanes each, one item slot per group
static bool plan_ok(int layout, int compute, const B5Plan& p, int smem) {
  const bool common = (layout == B5_BCAST || layout == B5_GLOBAL)
      && p.cluster >= 1 && p.cluster <= B5_MAX_CLUSTER && p.threads >= 1
      && p.ipt >= 1 && p.ipt <= B5_MAX_IPT
      && (long long)p.per_block * p.cluster >= p.n_items
      && smem >= 0 && smem <= MAX_SMEM;
  if (!compute)
    return common && p.threads <= B5_MAX_THREADS
        && p.per_block <= p.threads * p.ipt && p.group == 1 && p.kmax == 0;
  return common && p.threads <= B5C_MAX_THREADS && p.threads % 32 == 0
      && p.group >= 1 && p.group <= B5C_MAX_GROUP
      && p.per_block <= (p.threads / 32) * (32 / p.group) * p.ipt
      && p.kmax >= 1;
}

// B5 (compute 0) and B5c (compute 1): plan fields as the host planned
// them (kernels/fused.py b5_plan; group and kmax B5c's, 1 and 0 for
// B5), smem the dynamic shared memory of one block (bytes, b5_smem_bytes
// there); c1, c2: host arrays of `degree` floats (<= MAX_DEGREE); dg:
// scratch of nc * 6 * Fp floats for B5, of nc * 3 * Fp 32-bit words for
// B5c (layout B5_GLOBAL only, else null); items: the interior list
extern "C" int mg_cheb_full(int dtype, int compute, int with_x0, int layout,
                            const void* b, const void* x0, const void* fd,
                            const void* sc, const void* r2, void* out,
                            void* dg, const void* items, const float* c1,
                            const float* c2, int degree,
                            int cluster, int threads, int ipt, int per_block,
                            int n_items, int n_sides, int n_e, int r2_smem,
                            int group, int kmax, int smem,
                            const void* sides,
                            const void* class_start, const void* dense,
                            int nc, int X, int Y, int Z, float E, float kG,
                            float G2, void* stream) {
  if (degree < 0 || degree > MAX_DEGREE || !flags_ok(dtype, compute, dense))
    return (int)cudaErrorInvalidValue;
  const B5Plan p = make_plan(cluster, threads, ipt, per_block, n_items,
                             n_sides, n_e, r2_smem, group, kmax);
  const long long Fp = (long long)(X + 2) * (Y + 2) * (Z + 2);
  if (!plan_ok(layout, compute, p, smem) || Fp >= (1 << B5_Q_BITS)
      || (layout == B5_GLOBAL && dg == nullptr))
    return (int)cudaErrorInvalidValue;
  ChebCoefs cf;
  for (int i = 0; i < degree; ++i) {
    cf.c1[i] = c1[i];
    cf.c2[i] = c2[i];
  }
  const Stencil s = make_stencil(sides, class_start, dense, nc, X, Y, Z, E,
                                 kG, G2);
  const ChebFullArgs a = {b, x0, fd, sc, r2, out, dg, items};
  cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    return cheb_full_instance<float>(with_x0, layout, compute, a, cf, degree,
                                     p, s, smem, st_);
  return cheb_full_instance<bf>(with_x0, layout, compute, a, cf, degree, p,
                                s, smem, st_);
}

template <typename T, bool WITH_X0, int LAYOUT, bool CB>
static int max_clusters(const B5Plan& p, size_t smem) {
  cudaError_t e = cheb_full_attrs<T, WITH_X0, LAYOUT, CB>();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(p, smem, 0, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, (void*)cheb_full_fn<T, WITH_X0, LAYOUT, CB>(), &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
static int max_clusters_instance(int with_x0, int layout, int compute,
                                 const B5Plan& p, size_t smem) {
  const int k = (with_x0 ? 4 : 0) + (layout == B5_GLOBAL ? 2 : 0)
              + (compute ? 1 : 0);
  switch (k) {
    case 0: return max_clusters<T, false, B5_BCAST, false>(p, smem);
    case 1: return max_clusters<T, false, B5_BCAST, true>(p, smem);
    case 2: return max_clusters<T, false, B5_GLOBAL, false>(p, smem);
    case 3: return max_clusters<T, false, B5_GLOBAL, true>(p, smem);
    case 4: return max_clusters<T, true, B5_BCAST, false>(p, smem);
    case 5: return max_clusters<T, true, B5_BCAST, true>(p, smem);
    case 6: return max_clusters<T, true, B5_GLOBAL, false>(p, smem);
    default: return max_clusters<T, true, B5_GLOBAL, true>(p, smem);
  }
}

// how many clusters of `cluster` blocks of `threads` threads and
// `smem` bytes of dynamic shared memory the card can hold at once (0: it
// cannot run one); a negative value is -cudaError
extern "C" int mg_cheb_full_max_clusters(int dtype, int compute, int with_x0,
                                         int layout, int cluster,
                                         int threads, int smem) {
  const B5Plan p = make_plan(cluster, threads, 1, threads, threads, 0, 0, 0,
                             1, compute ? 1 : 0);
  if (!plan_ok(layout, compute, p, smem)
      || !flags_ok(dtype, compute, (const void*)1))
    return -(int)cudaErrorInvalidValue;
  if (dtype == 0)
    return max_clusters_instance<float>(with_x0, layout, compute, p, smem);
  return max_clusters_instance<bf>(with_x0, layout, compute, p, smem);
}
