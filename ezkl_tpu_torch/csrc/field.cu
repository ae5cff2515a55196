// Field kernels of the port: K1 (Montgomery multiply) and K2 (NTT butterfly).
//
// K1 ez_mont_mul replaces the TPU kernel `_pl_mul_call` of
// ezkl_tpu/fieldmath/limbs.py (entry `_mont_mul_pallas`): elementwise
// a * b * 2^-256 mod p over Fr or Fq, canonical in and out. b may be a
// broadcast operand: element j of the (8, n) output reads b[(j / b_rep) % b_n]
// of an (8, b_n) table (a constant: b_n = 1; a row repeated over a batch:
// b_n = row width; one value per row: b_rep = row width), so scalar-by-vector
// products read the constant from L2 instead of a materialised (8, n) copy.
// K2 ez_bfly replaces `_bfly_call` of ezkl_tpu/kernels/pntt.py (entry `bfly`):
// one radix-2 stage (a + b*w, a - b*w) over a field.
//
// Bound on the H100: both are memory-bound streams at large n. K1 moves
// 3 x 32 bytes per element against 264 32-bit multiply-adds (8x8 words for
// the product, 8x8 for the reduction, two IMADs per 64-bit product), which
// the SMs retire faster than HBM delivers 96 bytes; K2 moves 2 x 32 bytes per
// element (plus the stage's twiddle table, read through L2) against one
// product per pair. Design: one thread per element (per pair for K2), limbs
// in registers, limb-major loads that coalesce across a warp;
// K2 reads a stage's twiddle w[j mod half] from a table of `half` entries
// instead of a broadcast array, and works on the whole (8, n) array in one
// launch per stage, so a stage is one read and one write of the data.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 256;

template <class F>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long n, long long b_n, long long b_rep) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long jb = (b_n == n && b_rep == 1) ? j : (j / b_rep) % b_n;
  store(out, n, j, mul<F>(load(a, n, j), load(b, b_n, jb)));
}

// x: (8, n) with n a multiple of 2 * half; w: (8, half). Butterfly t pairs
// positions i0 = (t / half) * 2 * half + t % half and i1 = i0 + half.
template <class F>
__global__ void __launch_bounds__(kThreads)
    bfly_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                uint32_t* __restrict__ out, long long n, int log_half) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n >> 1)) return;
  const long long half = 1LL << log_half;
  const long long j = t & (half - 1);
  const long long i0 = ((t >> log_half) << (log_half + 1)) + j;
  const long long i1 = i0 + half;
  Fe a = load(x, n, i0);
  Fe b = load(x, n, i1);
  Fe tw = load(w, half, j);
  Fe bw = mul<F>(b, tw);
  store(out, n, i0, add<F>(a, bw));
  store(out, n, i1, sub<F>(a, bw));
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// field: 0 = Fr, 1 = Fq. Every entry returns cudaGetLastError() after launch.
extern "C" int ez_mont_mul(int field, const uint32_t* a, const uint32_t* b, uint32_t* out,
                           long long n, long long b_n, long long b_rep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    mont_mul_kernel<Fr><<<blocks_for(n), kThreads, 0, s>>>(a, b, out, n, b_n, b_rep);
  else
    mont_mul_kernel<Fq><<<blocks_for(n), kThreads, 0, s>>>(a, b, out, n, b_n, b_rep);
  return (int)cudaGetLastError();
}

extern "C" int ez_bfly(int field, const uint32_t* x, const uint32_t* w, uint32_t* out,
                       long long n, int log_half, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long pairs = n >> 1;
  if (field == 0)
    bfly_kernel<Fr><<<blocks_for(pairs), kThreads, 0, s>>>(x, w, out, n, log_half);
  else
    bfly_kernel<Fq><<<blocks_for(pairs), kThreads, 0, s>>>(x, w, out, n, log_half);
  return (int)cudaGetLastError();
}
