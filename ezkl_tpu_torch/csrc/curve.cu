// Point kernels of the port: K3 (complete projective add) and K9 (doubling)
// over BN254 G1, y^2 = x^3 + 3, projective (X:Y:Z) with identity (0:1:0).
//
// K3 ez_point_add replaces the TPU kernel `_add_call` of
// ezkl_tpu/kernels/pcurve.py (entry `add`); K9 ez_point_dbl replaces
// `_dbl_call` (entry `dbl`). Same formulas and schedule (RCB15 algorithms 7
// and 9, a = 0, b3 = 9), the same lazy < 2p residues inside, canonical stores,
// so the projective outputs equal `ezkl_tpu.fieldmath.curve.add/dbl` bit for
// bit.
//
// Bound on the H100: compute. An add reads 6 x 32 and writes 3 x 32 bytes per
// lane but runs 12 Montgomery products (12 x 264 32-bit multiply-adds) plus
// ~26 lazy adds; a doubling runs 8 products over 6 x 32 bytes. Design: one
// thread per lane with every coordinate and temporary in registers (ptxas:
// 106 registers for the add, 80 for the doubling, no spills, so two blocks
// of 256 threads fit on an SM), limb-major coalesced loads and stores, no
// shared memory.
// On the MSM's narrow sequential steps the launch, not the arithmetic, sets
// the pace; fusing the step loops into one kernel is the next slice (K4-K8).

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    point_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                     const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                     const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                     uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe X3, Y3, Z3;
  complete_add<Fq>(load(x1, n, j), load(y1, n, j), load(z1, n, j), load(x2, n, j),
                   load(y2, n, j), load(z2, n, j), X3, Y3, Z3);
  store(ox, n, j, reduce<Fq>(X3));
  store(oy, n, j, reduce<Fq>(Y3));
  store(oz, n, j, reduce<Fq>(Z3));
}

__global__ void __launch_bounds__(kThreads)
    point_dbl_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                     uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe X3, Y3, Z3;
  dbl<Fq>(load(x, n, j), load(y, n, j), load(z, n, j), X3, Y3, Z3);
  store(ox, n, j, reduce<Fq>(X3));
  store(oy, n, j, reduce<Fq>(Y3));
  store(oz, n, j, reduce<Fq>(Z3));
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int ez_point_add(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                            const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                            void* stream) {
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

extern "C" int ez_point_dbl(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                            void* stream) {
  point_dbl_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, y, z, ox, oy, oz, n);
  return (int)cudaGetLastError();
}
