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
// Layout: every vector is ghost-padded [nc, 6, Xp, Yp, Zp] (B1's layout,
// not the TPU kernels' align8 [rows, Fp] flats) and r^2 is
// [n_e, Xp, Yp, Zp].  One thread per (class, padded point): interior
// threads run the shared stencil body (stencil_body.cuh) and update their
// own 6 values; ghost threads write zeros, so outputs can come from
// torch.empty and every neighbour read of the next launch sees zero ghosts.
// Sides are summed in table order: repeats are bitwise equal.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32), 50^3 Octet level 0
// (24 rows, F = 53^3 padded points, N = 51^3 interior, 48 sides), bf16
// storage, each input read once and each output written once:
//   B3: (4 inputs + 1 output) x 24 F x 2 B = 35.7 MB -> 10.7 us; operations
//       110 x 48 x N = 0.70 GFLOP -> 10.5 us: bound by bytes, barely.
//   B4: (5 inputs + 3 outputs) x 24 F x 2 B = 57.2 MB -> 17.1 us (final:
//       42.9 MB): bound by bytes.
//   B5: one thread block on one SM, on levels of at most 13^3 padded
//       points: bound by the latency of its `degree` dependent
//       stencil-then-update phases, not by bytes or operations.
// B3 and B4 are B1's thread layout plus a pointwise epilogue on values the
// thread already holds, so they add no pass over memory around the
// stencil.  Re-reads of d (13 per value) are left to L1/L2, as in B1;
// shared-memory tiles of d and TMA are later work.  B5 keeps d, the one
// vector that neighbours read, in shared memory when it fits (<= 227 KB:
// every Octet level up to 13^3 padded points) and otherwise in a float
// global scratch buffer, which stays in L2; x and r are read only by their
// own thread and live in a float global scratch buffer.  __syncthreads()
// separates the K.d phase from the update phase of every step.

#include "stencil_body.cuh"

#define MAX_DEGREE 64

struct ChebCoefs {
  float c1[MAX_DEGREE];
  float c2[MAX_DEGREE];
};

struct Stencil {
  const Side* sides;
  const int* class_start;
  int nc, X, Y, Z;
  float E, kG, G2;
};

__device__ __forceinline__ long long padded_points(const Stencil& s) {
  return (long long)(s.X + 2) * (s.Y + 2) * (s.Z + 2);
}

// ------------------------------------------------------------------ B3
template <typename T>
__global__ void __launch_bounds__(256)
mg_residual_kernel(const T* __restrict__ x, const T* __restrict__ b,
                   const T* __restrict__ fm, const T* __restrict__ r2,
                   T* __restrict__ out, Stencil s) {
  const long long Fp = padded_points(s);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)s.nc * Fp) return;
  const int c = (int)(idx / Fp);
  const long long q = idx - (long long)c * Fp;
  const long long row0 = (long long)c * 6 * Fp + q;
  if (!interior(q, s.X, s.Y, s.Z)) {
#pragma unroll
    for (int k = 0; k < 6; ++k) st(out + row0 + k * Fp, 0.f);
    return;
  }
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  stencil_acc(x, r2, Fp, q, c, s.sides, s.class_start[c],
              s.class_start[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const long long o = row0 + k * Fp;
    st(out + o, ld(fm + o) * (ld(b + o) - acc[k]));
  }
}

// ------------------------------------------------------------------ B4
template <typename T, bool FINAL>
__global__ void __launch_bounds__(256)
mg_cheb_run_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ d, const T* __restrict__ fd,
                   const float* __restrict__ sc, const T* __restrict__ r2,
                   T* __restrict__ x1o, T* __restrict__ r1o,
                   T* __restrict__ d1o, float c1, float c2, Stencil s) {
  const long long Fp = padded_points(s);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)s.nc * Fp) return;
  const int c = (int)(idx / Fp);
  const long long q = idx - (long long)c * Fp;
  const long long row0 = (long long)c * 6 * Fp + q;
  if (!interior(q, s.X, s.Y, s.Z)) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const long long o = row0 + k * Fp;
      st(x1o + o, 0.f);
      if (!FINAL) {
        st(r1o + o, 0.f);
        st(d1o + o, 0.f);
      }
    }
    return;
  }
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  stencil_acc(d, r2, Fp, q, c, s.sides, s.class_start[c],
              s.class_start[c + 1], s.E, s.kG, s.G2, acc);
  const float c2i = c2 * sc[1];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const long long o = row0 + k * Fp;
    const float dc = ld(d + o);
    const float x1 = ld(x + o) + dc;
    const float r1 = ld(r + o) - acc[k];
    const float d1 = c1 * dc + (c2i * r1) * ld(fd + o);
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
// One block.  xs, rs: float scratch [nc * 6 * Fp] each; dg: float scratch
// for d when it does not fit shared memory (use_smem == 0).
template <typename T, bool WITH_X0>
__global__ void __launch_bounds__(1024, 1)
mg_cheb_full_kernel(const T* __restrict__ b, const T* __restrict__ x0,
                    const T* __restrict__ fd, const float* __restrict__ sc,
                    const T* __restrict__ r2, T* __restrict__ out,
                    float* xs, float* rs, float* dg, int use_smem,
                    ChebCoefs cf, int degree, Stencil s) {
  extern __shared__ float smem[];
  float* d = use_smem ? smem : dg;
  const long long Fp = padded_points(s);
  const long long items = (long long)s.nc * Fp;
  const float inv_theta = sc[0];
  const float inv_delta = sc[1];

  // x = x0 (or 0), r = b - K x0 (or b), d = (r fd) inv_theta
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const int c = (int)(i / Fp);
    const long long q = i - (long long)c * Fp;
    const long long row0 = (long long)c * 6 * Fp + q;
    if (!interior(q, s.X, s.Y, s.Z)) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const long long o = row0 + k * Fp;
        xs[o] = 0.f; rs[o] = 0.f; d[o] = 0.f;
      }
      continue;
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (WITH_X0)
      stencil_acc(x0, r2, Fp, q, c, s.sides, s.class_start[c],
                  s.class_start[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const long long o = row0 + k * Fp;
      const float xv = WITH_X0 ? ld(x0 + o) : 0.f;
      const float rv = WITH_X0 ? ld(b + o) - acc[k] : ld(b + o);
      xs[o] = xv;
      rs[o] = rv;
      d[o] = (rv * ld(fd + o)) * inv_theta;
    }
  }
  __syncthreads();

  for (int step = 0; step < degree; ++step) {
    // x += d, r -= K d: every thread reads its neighbours' d, none writes d
    for (long long i = threadIdx.x; i < items; i += blockDim.x) {
      const int c = (int)(i / Fp);
      const long long q = i - (long long)c * Fp;
      if (!interior(q, s.X, s.Y, s.Z)) continue;
      const long long row0 = (long long)c * 6 * Fp + q;
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      stencil_acc((const float*)d, r2, Fp, q, c, s.sides, s.class_start[c],
                  s.class_start[c + 1], s.E, s.kG, s.G2, acc);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const long long o = row0 + k * Fp;
        xs[o] = xs[o] + d[o];
        rs[o] = rs[o] - acc[k];
      }
    }
    __syncthreads();
    // d = c1 d + (c2 inv_delta) r fd, on each thread's own points
    const float c1 = cf.c1[step];
    const float c2i = cf.c2[step] * inv_delta;
    for (long long i = threadIdx.x; i < items; i += blockDim.x) {
      const int c = (int)(i / Fp);
      const long long q = i - (long long)c * Fp;
      if (!interior(q, s.X, s.Y, s.Z)) continue;
      const long long row0 = (long long)c * 6 * Fp + q;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const long long o = row0 + k * Fp;
        d[o] = c1 * d[o] + (c2i * rs[o]) * ld(fd + o);
      }
    }
    __syncthreads();
  }

  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const int c = (int)(i / Fp);
    const long long q = i - (long long)c * Fp;
    const long long row0 = (long long)c * 6 * Fp + q;
    const bool in = interior(q, s.X, s.Y, s.Z);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const long long o = row0 + k * Fp;
      st(out + o, in ? xs[o] + d[o] : 0.f);
    }
  }
}

// --------------------------------------------------------------- launchers
static Stencil make_stencil(const void* sides, const void* class_start,
                            int nc, int X, int Y, int Z,
                            float E, float kG, float G2) {
  Stencil s;
  s.sides = (const Side*)sides;
  s.class_start = (const int*)class_start;
  s.nc = nc; s.X = X; s.Y = Y; s.Z = Z;
  s.E = E; s.kG = kG; s.G2 = G2;
  return s;
}

static unsigned blocks_for(const Stencil& s, int threads) {
  const long long items = (long long)s.nc * (s.X + 2) * (s.Y + 2) * (s.Z + 2);
  return (unsigned)((items + threads - 1) / threads);
}

// dtype: 0 float, 1 bfloat16
extern "C" int mg_residual(int dtype, const void* x, const void* b,
                           const void* fm, const void* r2, void* out,
                           const void* sides, const void* class_start,
                           int nc, int X, int Y, int Z,
                           float E, float kG, float G2, void* stream) {
  const Stencil s = make_stencil(sides, class_start, nc, X, Y, Z, E, kG, G2);
  const int threads = 256;
  cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0) {
    mg_residual_kernel<float><<<blocks_for(s, threads), threads, 0, st_>>>(
        (const float*)x, (const float*)b, (const float*)fm,
        (const float*)r2, (float*)out, s);
  } else {
    typedef __nv_bfloat16 bf;
    mg_residual_kernel<bf><<<blocks_for(s, threads), threads, 0, st_>>>(
        (const bf*)x, (const bf*)b, (const bf*)fm, (const bf*)r2, (bf*)out,
        s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static void cheb_run(int final_, const void* x, const void* r, const void* d,
                     const void* fd, const void* sc, const void* r2,
                     void* x1, void* r1, void* d1, float c1, float c2,
                     const Stencil& s, cudaStream_t stream) {
  const int threads = 256;
  if (final_) {
    mg_cheb_run_kernel<T, true><<<blocks_for(s, threads), threads, 0,
                                  stream>>>(
        (const T*)x, (const T*)r, (const T*)d, (const T*)fd,
        (const float*)sc, (const T*)r2, (T*)x1, nullptr, nullptr, c1, c2, s);
  } else {
    mg_cheb_run_kernel<T, false><<<blocks_for(s, threads), threads, 0,
                                   stream>>>(
        (const T*)x, (const T*)r, (const T*)d, (const T*)fd,
        (const float*)sc, (const T*)r2, (T*)x1, (T*)r1, (T*)d1, c1, c2, s);
  }
}

extern "C" int mg_cheb_run(int dtype, int final_, const void* x,
                           const void* r, const void* d, const void* fd,
                           const void* sc, const void* r2, void* x1,
                           void* r1, void* d1, float c1, float c2,
                           const void* sides, const void* class_start,
                           int nc, int X, int Y, int Z,
                           float E, float kG, float G2, void* stream) {
  const Stencil s = make_stencil(sides, class_start, nc, X, Y, Z, E, kG, G2);
  if (dtype == 0)
    cheb_run<float>(final_, x, r, d, fd, sc, r2, x1, r1, d1, c1, c2, s,
                    (cudaStream_t)stream);
  else
    cheb_run<__nv_bfloat16>(final_, x, r, d, fd, sc, r2, x1, r1, d1, c1, c2,
                            s, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// largest dynamic shared memory one block may use on sm_90 (232,448 bytes)
static const int MAX_SMEM = 227 * 1024;

template <typename T, bool WITH_X0>
static int cheb_full(const void* b, const void* x0, const void* fd,
                     const void* sc, const void* r2, void* out, void* xs,
                     void* rs, void* dg, const ChebCoefs& cf, int degree,
                     const Stencil& s, cudaStream_t stream) {
  auto kern = mg_cheb_full_kernel<T, WITH_X0>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long dbytes =
      4LL * s.nc * 6 * (s.X + 2) * (s.Y + 2) * (s.Z + 2);
  const int use_smem = dbytes <= MAX_SMEM;
  kern<<<1, 1024, use_smem ? (size_t)dbytes : 0, stream>>>(
      (const T*)b, (const T*)x0, (const T*)fd, (const float*)sc,
      (const T*)r2, (T*)out, (float*)xs, (float*)rs, (float*)dg, use_smem,
      cf, degree, s);
  return (int)cudaGetLastError();
}

// c1, c2: host arrays of `degree` floats (<= MAX_DEGREE); dg may be null
// when d fits shared memory (mg_cheb_full_smem_bytes() says how much fits)
extern "C" int mg_cheb_full(int dtype, int with_x0, const void* b,
                            const void* x0, const void* fd, const void* sc,
                            const void* r2, void* out, void* xs, void* rs,
                            void* dg, const float* c1, const float* c2,
                            int degree, const void* sides,
                            const void* class_start, int nc, int X, int Y,
                            int Z, float E, float kG, float G2,
                            void* stream) {
  if (degree < 0 || degree > MAX_DEGREE) return (int)cudaErrorInvalidValue;
  ChebCoefs cf;
  for (int i = 0; i < degree; ++i) {
    cf.c1[i] = c1[i];
    cf.c2[i] = c2[i];
  }
  const Stencil s = make_stencil(sides, class_start, nc, X, Y, Z, E, kG, G2);
  cudaStream_t st_ = (cudaStream_t)stream;
  if (dtype == 0)
    return with_x0
        ? cheb_full<float, true>(b, x0, fd, sc, r2, out, xs, rs, dg, cf,
                                 degree, s, st_)
        : cheb_full<float, false>(b, x0, fd, sc, r2, out, xs, rs, dg, cf,
                                  degree, s, st_);
  typedef __nv_bfloat16 bf;
  return with_x0
      ? cheb_full<bf, true>(b, x0, fd, sc, r2, out, xs, rs, dg, cf, degree,
                            s, st_)
      : cheb_full<bf, false>(b, x0, fd, sc, r2, out, xs, rs, dg, cf, degree,
                             s, st_);
}

extern "C" int mg_cheb_full_smem_bytes() { return MAX_SMEM; }
extern "C" int mg_cheb_full_max_degree() { return MAX_DEGREE; }
