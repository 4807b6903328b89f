// B1 and B2: structured Timoshenko stencil matvec K.u for Hopper (sm_90a),
// one template over the load/store type.
//
// B1 (float loads and stores) replaces the TPU kernel of
// pylatticedso_tpu/parallel/stencil_pallas.py make_pallas_matvec ->
// make_call(jnp.float32); B2 (__nv_bfloat16 loads and stores, float
// arithmetic) replaces make_call(jnp.bfloat16), the apply.lo matvec of the
// multigrid's bf16-I/O smoother.  Both compute the math of the gather form
// (pylatticedso_tpu_torch/parallel/structured.py apply_gather), which is
// also their plain version; the per-point body is stencil_acc in
// stencil_body.cuh, shared with the fused smoother kernels B3-B5.
//
// Layout: u is ghost-padded [nc, 6, Xp, Yp, Zp] and r^2 [n_e, Xp, Yp, Zp]
// (Xp = X + 2, ...); every shifted read of an interior point stays in
// bounds and reads zeros outside the lattice.  The output is the unpadded
// [nc, 6, X, Y, Z] field.  The TPU kernel's flat 1-D tiles, prev/cur/next
// halo blocks, align8 rows and VMEM fit model are not carried over.
//
// Edge sides come from a device table (struct Side, built by
// pylatticedso_tpu_torch/kernels/stencil.py), sorted by self class with
// class_start[c]..class_start[c+1] the sides of class c, in the order of
// the gather form's accumulation.  Nothing of the template is baked into
// the source, so one build serves every template (the 16-class hybrid too).
//
// Threads: one thread per (class, interior point), z fastest.  Each thread
// keeps its own 6 u values and 6 sums in registers and loops over its
// class's sides in table order.  No atomics and a fixed summation order:
// repeated runs are bitwise equal.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores),
// 50^3 Octet (nc = 4, 48 sides, F = 53^3 = 148,877 padded points,
// N = 51^3 = 132,651 interior points): operations ~ 110 * 48 * N =
// 0.70 GFLOP -> 10.5 us for both.  B1 moves 4 * (24 F + 24 F + 24 N) =
// 41.3 MB -> 12.3 us, so it is bound by bytes, barely; B2 moves half of
// that, 20.7 MB -> 6.2 us, so it is bound by operations.  This first
// version relies on L1/L2 for the ~13x re-reads of each u value (each
// point's 12 neighbours per class) instead of staging tiles in shared
// memory; with ~110 flops per side per point in registers it trades some
// of the bound for simplicity.  Shared-memory tiles, TMA and fusing the
// masks around it are later work.

#include "stencil_body.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
stencil_matvec_kernel(const T* __restrict__ up, const T* __restrict__ r2p,
                      T* __restrict__ out, const Side* __restrict__ sides,
                      const int* __restrict__ class_start,
                      int nc, int X, int Y, int Z,
                      float E, float kG, float G2) {
  const int N = X * Y * Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nc * N) return;
  const int c = (int)(idx / N);
  const int pt = (int)(idx - (long long)c * N);
  const int z = pt % Z;
  const int y = (pt / Z) % Y;
  const int x = pt / (Y * Z);
  const int Yp = Y + 2, Zp = Z + 2;
  const long long Fp = (long long)(X + 2) * Yp * Zp;
  const long long q = ((long long)(x + 1) * Yp + (y + 1)) * Zp + (z + 1);

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  stencil_acc(up, r2p, Fp, q, c, sides, class_start[c], class_start[c + 1],
              E, kG, G2, acc);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    st(out + ((long long)c * 6 + k) * N + pt, acc[k]);
}

template <typename T>
static int launch(const void* up, const void* r2p, void* out,
                  const void* sides, const void* class_start,
                  int nc, int X, int Y, int Z, float E, float kG, float G2,
                  void* stream) {
  const long long total = (long long)nc * X * Y * Z;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil_matvec_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)up, (const T*)r2p, (T*)out, (const Side*)sides,
      (const int*)class_start, nc, X, Y, Z, E, kG, G2);
  return (int)cudaGetLastError();
}

extern "C" int stencil_matvec_f32(const void* up, const void* r2p, void* out,
                                  const void* sides, const void* class_start,
                                  int nc, int X, int Y, int Z,
                                  float E, float kG, float G2,
                                  void* stream) {
  return launch<float>(up, r2p, out, sides, class_start, nc, X, Y, Z,
                       E, kG, G2, stream);
}

extern "C" int stencil_matvec_bf16(const void* up, const void* r2p, void* out,
                                   const void* sides, const void* class_start,
                                   int nc, int X, int Y, int Z,
                                   float E, float kG, float G2,
                                   void* stream) {
  return launch<__nv_bfloat16>(up, r2p, out, sides, class_start, nc, X, Y, Z,
                               E, kG, G2, stream);
}
