// B1: structured Timoshenko stencil matvec K.u in float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel of pylatticedso_tpu/parallel/stencil_pallas.py:
// make_pallas_matvec -> make_call(jnp.float32) (kernel body make_kernel,
// shared arithmetic make_stencil_acc).  It computes the math of the gather
// form, pylatticedso_tpu_torch/parallel/structured.py apply_gather, which is
// also its plain version: for every output point p of class c and every
// template-edge side whose self class is c, form the six generalized
// strains e0..e5 from u(self, p), u(other, p + du) and r^2(p + dr), the
// internal forces with S = pi r^2, I = pi r^4 / 4, and add the side's
// force/moment row to the output.
//
// Layout: u is ghost-padded [nc, 6, Xp, Yp, Zp] and r^2 [n_e, Xp, Yp, Zp]
// (Xp = X + 2, ...); every shifted read of an interior point stays in
// bounds and reads zeros outside the lattice.  The output is the unpadded
// [nc, 6, X, Y, Z] field.  The TPU kernel's flat 1-D tiles, prev/cur/next
// halo blocks, align8 rows and VMEM fit model are not carried over.
//
// Edge sides come from a device table (struct Side below, built by
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
// N = 51^3 = 132,651 interior points): bytes = 4 * (24 F + 24 F + 24 N)
// = 41.3 MB -> 12.3 us; operations ~ 110 * 48 * N = 0.70 GFLOP -> 10.5 us.
// So it is bound by bytes, barely: the arithmetic sits within 20% of the
// byte bound.  This first version relies on L1/L2 for the ~13x re-reads of
// each u value (each point's 12 neighbours per class) instead of staging
// tiles in shared memory; with ~110 flops per side per point in registers
// it trades some of the byte bound for simplicity.  Shared-memory tiles,
// TMA and fusing the masks around it are later work.

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

__global__ void __launch_bounds__(256)
stencil_matvec_f32_kernel(const float* __restrict__ up,
                          const float* __restrict__ r2p,
                          float* __restrict__ out,
                          const Side* __restrict__ sides,
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

  float us[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) us[k] = up[(c * 6 + k) * Fp + q];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  const float pi = 3.14159265358979323846f;
  const int s_end = class_start[c + 1];
  for (int s = class_start[c]; s < s_end; ++s) {
    const Side& sd = sides[s];
    const float* uo_base = up + (long long)sd.co * 6 * Fp + q + sd.du;
    float uo[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) uo[k] = uo_base[k * Fp];
    const float r2 = r2p[(long long)sd.ei * Fp + q + sd.dr];

    // uB - uA is (other - self) on side A and (self - other) on side B;
    // negating an IEEE difference is exact, so the sign form matches the
    // gather form bit for bit and keeps u in registers
    const float sg = sd.side ? -1.f : 1.f;
    const float t0 = sd.t[0], t1 = sd.t[1], t2 = sd.t[2];
    const float b0 = sd.a1[0], b1 = sd.a1[1], b2 = sd.a1[2];
    const float n0 = sd.a2[0], n1 = sd.a2[1], n2 = sd.a2[2];
    const float invL = sd.invL;

    const float du0 = sg * (uo[0] - us[0]), du1 = sg * (uo[1] - us[1]),
                du2 = sg * (uo[2] - us[2]);
    const float th0 = us[3] + uo[3], th1 = us[4] + uo[4], th2 = us[5] + uo[5];
    const float dt0 = sg * (uo[3] - us[3]), dt1 = sg * (uo[4] - us[4]),
                dt2 = sg * (uo[5] - us[5]);

    const float e0 = (du0 * t0 + du1 * t1 + du2 * t2) * invL;
    const float e1 = (du0 * b0 + du1 * b1 + du2 * b2) * invL
                   - (th0 * n0 + th1 * n1 + th2 * n2) * 0.5f;
    const float e2 = (du0 * n0 + du1 * n1 + du2 * n2) * invL
                   + (th0 * b0 + th1 * b1 + th2 * b2) * 0.5f;
    const float e3 = (dt0 * t0 + dt1 * t1 + dt2 * t2) * invL;
    const float e4 = (dt0 * b0 + dt1 * b1 + dt2 * b2) * invL;
    const float e5 = (dt0 * n0 + dt1 * n1 + dt2 * n2) * invL;

    const float S = pi * r2;
    const float I = pi * r2 * r2 * 0.25f;
    const float s0 = (E * S) * e0, s1 = (kG * S) * e1, s2 = (kG * S) * e2;
    const float s3 = (G2 * I) * e3, s4 = (E * I) * e4, s5 = (E * I) * e5;

    const float fu0 = s0 * t0 + s1 * b0 + s2 * n0;
    const float fu1 = s0 * t1 + s1 * b1 + s2 * n1;
    const float fu2 = s0 * t2 + s1 * b2 + s2 * n2;
    const float hl = sd.halfL;
    const float ms0 = hl * (s2 * b0 - s1 * n0);
    const float ms1 = hl * (s2 * b1 - s1 * n1);
    const float ms2 = hl * (s2 * b2 - s1 * n2);
    const float md0 = s3 * t0 + s4 * b0 + s5 * n0;
    const float md1 = s3 * t1 + s4 * b1 + s5 * n1;
    const float md2 = s3 * t2 + s4 * b2 + s5 * n2;
    if (sd.side == 0) {        // fA = [-fu, msh - mdf]
      acc[0] += -fu0; acc[1] += -fu1; acc[2] += -fu2;
      acc[3] += ms0 - md0; acc[4] += ms1 - md1; acc[5] += ms2 - md2;
    } else {                   // fB = [fu, msh + mdf]
      acc[0] += fu0; acc[1] += fu1; acc[2] += fu2;
      acc[3] += ms0 + md0; acc[4] += ms1 + md1; acc[5] += ms2 + md2;
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) out[((long long)c * 6 + k) * N + pt] = acc[k];
}

extern "C" int stencil_matvec_f32(const void* up, const void* r2p, void* out,
                                  const void* sides, const void* class_start,
                                  int nc, int X, int Y, int Z,
                                  float E, float kG, float G2,
                                  void* stream) {
  const long long total = (long long)nc * X * Y * Z;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil_matvec_f32_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)up, (const float*)r2p, (float*)out, (const Side*)sides,
      (const int*)class_start, nc, X, Y, Z, E, kG, G2);
  return (int)cudaGetLastError();
}
