// Point kernels of the fused MSM (`kernels/msm.py:msm_multi`) over BN254 G1,
// y^2 = x^3 + 3, projective (X:Y:Z) with identity (0:1:0). Each kernel keeps a
// sequential chain of point operations inside one launch, one thread per lane
// with the accumulator in registers, where the unfused MSM issued one K3 or
// K9 launch per step.
//
//   K4 ez_scan_packed  replaces `_scan_call_packed` (ezkl_tpu/kernels/pcurve.py,
//                      entry `prefix_scan_packed`): per lane, the inclusive
//                      prefix over S steps of affine points, y negated where
//                      the sign plane is set, by mixed adds (RCB15 alg. 8).
//                      One departure: the pair (0, 1), on no curve
//                      y^2 = x^3 + 3, is how the identity lanes of
//                      `pad_msm_inputs` reach an affine scan; it counts as the
//                      identity (the accumulator starts at (0:1:0), or is left
//                      as it is), where the TPU kernel adds it as a point and
//                      the MSM's sum comes out wrong. Other inputs give the
//                      TPU kernel's words.
//   K5 ez_scan_steps   replaces `_scan_call` (entry `prefix_scan_steps`): the
//                      same prefix over projective points by complete adds
//                      (alg. 7, identities allowed) or over affine (x, y) by
//                      mixed adds (no identities).
//   K6 ez_fold_lanes   replaces `_fold_call` (entry `fold_lanes`): per group,
//                      lane l sums chunks 0..chunks-1 and stores once.
//   K7 ez_dbl_pow2     replaces `_dbln_call` (entry `dbl_pow2`): 2^c * P by c
//                      doublings (alg. 9).
//   K8 ez_horner       replaces `_horner_call` (entry `horner_combine`):
//                      acc = 2^c * acc + V_w over the windows, MSB first,
//                      from the identity.
//
// The formulas and their lazy < 2p residues are those of the TPU kernels
// (bn254.cuh); every value that leaves a kernel is reduced to canonical, so
// the outputs equal the reference's bit for bit.
//
// Bound on the H100. K4, K5 and K6 are bound by operations: a step is 11
// (mixed) or 12 (complete) Montgomery products of 264 32-bit IMADs each
// against 2 or 3 loads and 3 stores of 32 bytes per lane. K7 and K8 run at
// widths of C*W and C lanes (a few hundred and at most 16 at k = 14): far too
// few threads to fill the card, so each is bound by the latency of its
// dependent chain (K8 at k = 14: 26 windows x (10 doublings + 1 add)).
// Design, for this first version: one thread per lane, the whole step loop
// inside the kernel so the carried point never leaves registers, and narrow
// blocks so that the few thousand lanes of a k = 14 scan spread over all
// SMs. Step-major layouts (8, S, m) -- element (limb i, step s, lane l) at
// (i * S + s) * m + l -- make the lanes of one step contiguous, so the loads
// and stores of a warp coalesce; the MSM's gather writes that layout directly.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kScanThreads = 64;
constexpr int kChainThreads = 32;

__device__ __forceinline__ Fe fq_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = Fq::one(i);
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  return r;
}

// p - y by a raw subtraction, as the TPU kernel (`pcurve.py:347-349`): in
// (0, p] for y < p, which the lazy domain accepts.
__device__ __forceinline__ Fe neg_raw(const Fe& y) {
  Fe p;
#pragma unroll
  for (int i = 0; i < 8; ++i) p.v[i] = Fq::p(i);
  uint32_t borrow;
  return sub_limbs(p, y, borrow);
}

__device__ __forceinline__ void store_point(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                            uint32_t* __restrict__ oz, long long stride,
                                            long long j, const Fe& X, const Fe& Y, const Fe& Z) {
  store(ox, stride, j, reduce<Fq>(X));
  store(oy, stride, j, reduce<Fq>(Y));
  store(oz, stride, j, reduce<Fq>(Z));
}

// acc += (X2, Y2[, Z2]) by the complete (alg. 7) or the mixed (alg. 8) add
template <bool Mixed>
__device__ __forceinline__ void accumulate(Fe& X, Fe& Y, Fe& Z, const Fe& X2, const Fe& Y2,
                                           const Fe& Z2) {
  Fe X3, Y3, Z3;
  if (Mixed)
    mixed_add<Fq>(X, Y, Z, X2, Y2, X3, Y3, Z3);
  else
    complete_add<Fq>(X, Y, Z, X2, Y2, Z2, X3, Y3, Z3);
  X = X3;
  Y = Y3;
  Z = Z3;
}

__device__ __forceinline__ bool is_pad_pair(const Fe& x, const Fe& y) {
  bool pad = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) pad &= (x.v[i] == 0u) & (y.v[i] == Fq::one(i));
  return pad;
}

// K4 (Signed) and K5: inputs and outputs step-major (8, S, m). Step 0 loads
// the first point (z = 1 for affine inputs); each later step adds the next;
// every step's prefix is stored.
template <bool Mixed, bool Signed>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                const uint32_t* __restrict__ z, const int32_t* __restrict__ sn,
                uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                long long m, int steps) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= m) return;
  const long long stride = m * steps;
  Fe X, Y, Z;
  for (int s = 0; s < steps; ++s) {
    const long long j = (long long)s * m + l;
    const Fe X2 = load(x, stride, j);
    Fe Y2 = load(y, stride, j);
    const bool pad = Signed && is_pad_pair(X2, Y2);
    if (Signed && sn[j] != 0) Y2 = neg_raw(Y2);
    const Fe Z2 = Mixed ? fq_one() : load(z, stride, j);
    if (s == 0) {
      X = X2;
      Y = Y2;
      Z = pad ? fe_zero() : Z2;
    } else if (!pad) {
      accumulate<Mixed>(X, Y, Z, X2, Y2, Z2);
    }
    store_point(ox, oy, oz, stride, j, X, Y, Z);
  }
}

// K6: input (8, G, chunks, blk), output (8, G, blk); thread t = g * blk + l.
template <bool Mixed>
__global__ void __launch_bounds__(kScanThreads)
    fold_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long groups,
                int chunks, int blk) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lanes = groups * blk;
  if (t >= lanes) return;
  const long long stride = lanes * chunks;
  const long long base = (t / blk) * chunks * blk + t % blk;
  Fe X, Y, Z;
  for (int j = 0; j < chunks; ++j) {
    const long long e = base + (long long)j * blk;
    const Fe X2 = load(x, stride, e);
    const Fe Y2 = load(y, stride, e);
    const Fe Z2 = Mixed ? fq_one() : load(z, stride, e);
    if (j == 0) {
      X = X2;
      Y = Y2;
      Z = Z2;
    } else {
      accumulate<Mixed>(X, Y, Z, X2, Y2, Z2);
    }
  }
  store_point(ox, oy, oz, lanes, t, X, Y, Z);
}

__device__ __forceinline__ void dbl_n(Fe& X, Fe& Y, Fe& Z, int c) {
  for (int k = 0; k < c; ++k) {
    Fe X3, Y3, Z3;
    dbl<Fq>(X, Y, Z, X3, Y3, Z3);
    X = X3;
    Y = Y3;
    Z = Z3;
  }
}

// K7: (8, n) -> (8, n), c >= 1 doublings.
__global__ void __launch_bounds__(kChainThreads)
    dbl_pow2_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n, int c) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe X = load(x, n, j), Y = load(y, n, j), Z = load(z, n, j);
  dbl_n(X, Y, Z, c);
  store_point(ox, oy, oz, n, j, X, Y, Z);
}

// K8: v (8, W, width), MSB window first -> (8, width).
__global__ void __launch_bounds__(kChainThreads)
    horner_kernel(const uint32_t* __restrict__ vx, const uint32_t* __restrict__ vy,
                  const uint32_t* __restrict__ vz, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int windows, int c,
                  long long width) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const long long stride = (long long)windows * width;
  Fe X = fe_zero(), Y = fq_one(), Z = fe_zero();
  for (int w = 0; w < windows; ++w) {
    dbl_n(X, Y, Z, c);
    const long long e = (long long)w * width + j;
    accumulate<false>(X, Y, Z, load(vx, stride, e), load(vy, stride, e), load(vz, stride, e));
  }
  store_point(ox, oy, oz, width, j, X, Y, Z);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// Every entry returns cudaGetLastError() after its launch.
extern "C" int ez_scan_packed(const uint32_t* px, const uint32_t* py, const int32_t* sn,
                              uint32_t* ox, uint32_t* oy, uint32_t* oz, long long m, int steps,
                              void* stream) {
  scan_kernel<true, true><<<blocks_for(m, kScanThreads), kScanThreads, 0,
                            (cudaStream_t)stream>>>(px, py, nullptr, sn, ox, oy, oz, m, steps);
  return (int)cudaGetLastError();
}

// mixed: 0 = projective inputs (x, y, z) by complete adds, 1 = affine (x, y)
extern "C" int ez_scan_steps(int mixed, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                             uint32_t* ox, uint32_t* oy, uint32_t* oz, long long m, int steps,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = blocks_for(m, kScanThreads);
  if (mixed)
    scan_kernel<true, false><<<b, kScanThreads, 0, s>>>(x, y, nullptr, nullptr, ox, oy, oz, m,
                                                        steps);
  else
    scan_kernel<false, false><<<b, kScanThreads, 0, s>>>(x, y, z, nullptr, ox, oy, oz, m, steps);
  return (int)cudaGetLastError();
}

extern "C" int ez_fold_lanes(int mixed, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                             uint32_t* ox, uint32_t* oy, uint32_t* oz, long long groups,
                             int chunks, int blk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = blocks_for(groups * blk, kScanThreads);
  if (mixed)
    fold_kernel<true><<<b, kScanThreads, 0, s>>>(x, y, nullptr, ox, oy, oz, groups, chunks, blk);
  else
    fold_kernel<false><<<b, kScanThreads, 0, s>>>(x, y, z, ox, oy, oz, groups, chunks, blk);
  return (int)cudaGetLastError();
}

extern "C" int ez_dbl_pow2(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                           uint32_t* oy, uint32_t* oz, long long n, int c, void* stream) {
  dbl_pow2_kernel<<<blocks_for(n, kChainThreads), kChainThreads, 0, (cudaStream_t)stream>>>(
      x, y, z, ox, oy, oz, n, c);
  return (int)cudaGetLastError();
}

extern "C" int ez_horner(const uint32_t* vx, const uint32_t* vy, const uint32_t* vz,
                         uint32_t* ox, uint32_t* oy, uint32_t* oz, int windows, int c,
                         long long width, void* stream) {
  horner_kernel<<<blocks_for(width, kChainThreads), kChainThreads, 0, (cudaStream_t)stream>>>(
      vx, vy, vz, ox, oy, oz, windows, c, width);
  return (int)cudaGetLastError();
}
