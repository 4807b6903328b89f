// P1 and P2: the counterparts of the JAX package's two TPU probe kernels,
// for Hopper (sm_90a).
//
// P1 probe_chain replaces scripts/probe_1d_density.py make(kind) (the
// pl.pallas_call at :41): on one (8, 3072) float block, a chain of K = 200
// dependent v = v * 1.0001 + 0.5, repeated REPS = 100 times in one launch
// (the TPU grid of 100 programs on the same block).  Kind "1d" runs the
// chain on row 0 and broadcasts it to all 8 rows; kind "2d" runs it on all
// 8 rows.  The probe measured the TPU VPU's sublane density, which means
// nothing on an H100; the counterpart is the same arithmetic with its rate
// recorded.  The multiply and the add are rounded separately (__fmul_rn,
// __fadd_rn: nvcc would otherwise contract them into one FMA), so the
// result is bitwise equal to the plain torch loop, which rounds each op.
// Threads: one per computed element (3,072 for "1d", 24,576 for "2d"),
// blockIdx.y is the repeat; every repeat writes the same values.  Bound by
// operations: 100 x 200 x 2 flops per element, no memory traffic to speak
// of (196,608 bytes in and out), and a chain of 400 dependent instructions
// per thread, so latency-bound unless enough warps hide it.
//
// P2 probe_scale replaces the inline kernel k of scripts/tpu_harvest_r5.sh
// :25 (r6.sh:27, r7.sh:22, r8.sh:19): o = x * 2.0 on an (8, 128) float
// array, one launch of one block, bitwise equal to x * 2 (a multiply by 2
// is exact).  A liveness probe: bound by the launch itself.

#include <cuda_runtime.h>

#define P1_K 200

__global__ void __launch_bounds__(256)
probe_chain_kernel(const float* __restrict__ x, float* __restrict__ o,
                   int rows, int cols, int out_rows) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * cols) return;
  float v = x[idx];
#pragma unroll 8
  for (int k = 0; k < P1_K; ++k) v = __fadd_rn(__fmul_rn(v, 1.0001f), 0.5f);
  if (rows == out_rows) {
    o[idx] = v;
  } else {                       // "1d": broadcast row 0 to every row
    for (int r = 0; r < out_rows; ++r) o[r * cols + idx] = v;
  }
}

__global__ void probe_scale_kernel(const float* __restrict__ x,
                                   float* __restrict__ o, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) o[idx] = __fmul_rn(x[idx], 2.0f);
}

// kind_2d: 0 for "1d" (chain on row 0 only), 1 for "2d"
extern "C" int probe_chain(const void* x, void* o, int rows, int cols,
                           int kind_2d, int reps, void* stream) {
  const int computed = kind_2d ? rows * cols : cols;
  const int threads = 256;
  const dim3 grid((computed + threads - 1) / threads, reps);
  probe_chain_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)o, kind_2d ? rows : 1, cols, rows);
  return (int)cudaGetLastError();
}

extern "C" int probe_chain_length() { return P1_K; }

extern "C" int probe_scale(const void* x, void* o, int n, void* stream) {
  const int threads = 1024;
  probe_scale_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>((const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}
