// Field kernels of the port: K1 (Montgomery multiply, elementwise and in
// product chains) and K2 (NTT butterfly).
//
// K1 replaces the TPU kernel `_pl_mul_call` of ezkl_tpu/fieldmath/limbs.py
// (entry `_mont_mul_pallas`), in three forms over Fr or Fq, canonical in and
// out:
//   ez_mont_mul   elementwise a * b * 2^-256 mod p. b may be a broadcast
//                 operand: element j of the (8, n) output reads
//                 b[(j / b_rep) % b_n] of an (8, b_n) table (a constant:
//                 b_n = 1; a row repeated over a batch: b_n = row width; one
//                 value per row: b_rep = row width), so scalar-by-vector
//                 products read the constant from L2 instead of a
//                 materialised (8, n) copy.
//   ez_mont_pow   a^e per element for a static exponent 1 <= e < 2^256, by a
//                 sliding window of 4 bits: a Fermat inverse a^(p-2) takes
//                 309 products in Fr (8 for the table, 252 squarings, 49
//                 windows) and 308 in Fq, where the JAX package's
//                 `pow_static` runs 379 and 362 by square-and-multiply, a
//                 `lax.scan` of products inside one compiled program.
//   ez_mont_scan  the inclusive prefix product along the last axis of an
//                 (8, rows, steps) array: the sequential block scan of the JAX
//                 package's `prefix_scan_mul`, also a `lax.scan`.
// K2 ez_bfly replaces `_bfly_call` of ezkl_tpu/kernels/pntt.py (entry `bfly`):
// one radix-2 stage (a + b*w, a - b*w) over a field.
//
// Bound on the H100: ez_mont_mul and ez_bfly are memory-bound streams at large
// n. K1 moves 3 x 32 bytes per element against 264 32-bit multiply-adds (8x8
// words for the product, 8x8 for the reduction, two IMADs per 64-bit
// product), which the SMs retire faster than HBM delivers 96 bytes; K2 moves
// 2 x 32 bytes per element (plus the stage's twiddle table, read through L2)
// against one product per pair. Design: one thread per element (per pair for
// K2), limbs in registers, limb-major loads that coalesce across a warp; K2
// reads a stage's twiddle w[j mod half] from a table of `half` entries instead
// of a broadcast array, and works on the whole (8, n) array in one launch per
// stage, so a stage is one read and one write of the data.
//
// The chain forms run where the prover's chains are narrow: an inversion of 1
// to 8 elements (308-309 dependent products) or a scan block of
// 16 to 512 rows of 32 steps. There the card is bound by neither bytes nor
// operations but by the latency of one thread's dependent products, and a
// launch per product (as a chain of ez_mont_mul calls) costs ~2 us of device
// time and a pass through the host wrapper each. Design: the whole chain in
// one launch, one thread per element (per row), the accumulator in registers
// under the lazy < 2p contract of the MSM kernels, reduced to canonical once
// per stored value; narrow blocks of 32 threads, so that 2^14 chains spread
// over all SMs. The canonical value of a product chain is unique, so the
// words equal those of a chain of ez_mont_mul launches (or of square-and-
// multiply, for the power).

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 256;
constexpr int kChainThreads = 32;

// ez_mont_pow's sliding window of 4 bits over a static exponent (the host's
// `limbs.pow_schedule`): the table holds the odd powers x, x^3, ..., x^15;
// acc = table[first], then per window `sq` squarings and a product by
// table[dig], then `trailing` squarings. A window and the zeros before the
// next span at least 4 bits, so an exponent < 2^256 has at most 64 windows.
constexpr int kPowTable = 8;
constexpr int kPowMaxWindows = 64;

struct PowSchedule {
  uint8_t sq[kPowMaxWindows];
  uint8_t dig[kPowMaxWindows];
  int windows, first, trailing;
};

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

// out = a^e elementwise over (8, n), e by its window schedule. The table
// stays in local memory (a runtime index), read once per window. Products
// by `mul_lazy`, which ran a little faster than `mul_cc` in this dependent
// chain on the H100.
template <class F>
__global__ void __launch_bounds__(kChainThreads)
    mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n,
                    PowSchedule sc) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe table[kPowTable];
  table[0] = load(a, n, j);
  const Fe x2 = mul_lazy<F>(table[0], table[0]);
#pragma unroll
  for (int i = 1; i < kPowTable; ++i) table[i] = mul_lazy<F>(table[i - 1], x2);
  Fe acc = table[sc.first];
  for (int k = 0; k < sc.windows; ++k) {
    for (int s = 0; s < sc.sq[k]; ++s) acc = mul_lazy<F>(acc, acc);
    acc = mul_lazy<F>(acc, table[sc.dig[k]]);
  }
  for (int s = 0; s < sc.trailing; ++s) acc = mul_lazy<F>(acc, acc);
  store(out, n, j, reduce<F>(acc));
}

// Inclusive prefix product along the last axis of v (8, rows, steps): element
// (limb i, row r, step s) at (i * rows + r) * steps + s; one thread per row.
template <class F>
__global__ void __launch_bounds__(kChainThreads)
    mont_scan_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ out, long long rows,
                     int steps) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long n = rows * steps, base = r * steps;
  Fe acc = load(v, n, base);
  store(out, n, base, acc);
  for (int s = 1; s < steps; ++s) {
    acc = mul_cc<F>(acc, load(v, n, base + s));
    store(out, n, base + s, reduce_cc<F>(acc));
  }
}

inline unsigned blocks_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

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

// The window schedule of `limbs.pow_schedule`: `windows` (<= 64) pairs of
// squarings sq[k] and table index dig[k] (< 8), on the host.
extern "C" int ez_mont_pow(int field, const uint32_t* a, uint32_t* out, long long n,
                           const uint8_t* sq, const uint8_t* dig, int windows, int first,
                           int trailing, void* stream) {
  if (windows < 0 || windows > kPowMaxWindows || first < 0 || first >= kPowTable)
    return (int)cudaErrorInvalidValue;
  PowSchedule sc;
  for (int k = 0; k < windows; ++k) {
    if (dig[k] >= kPowTable) return (int)cudaErrorInvalidValue;
    sc.sq[k] = sq[k];
    sc.dig[k] = dig[k];
  }
  sc.windows = windows;
  sc.first = first;
  sc.trailing = trailing;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = blocks_for(n, kChainThreads);
  if (field == 0)
    mont_pow_kernel<Fr><<<b, kChainThreads, 0, s>>>(a, out, n, sc);
  else
    mont_pow_kernel<Fq><<<b, kChainThreads, 0, s>>>(a, out, n, sc);
  return (int)cudaGetLastError();
}

extern "C" int ez_mont_scan(int field, const uint32_t* v, uint32_t* out, long long rows,
                            int steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = blocks_for(rows, kChainThreads);
  if (field == 0)
    mont_scan_kernel<Fr><<<b, kChainThreads, 0, s>>>(v, out, rows, steps);
  else
    mont_scan_kernel<Fq><<<b, kChainThreads, 0, s>>>(v, out, rows, steps);
  return (int)cudaGetLastError();
}
