// Field kernels of the port: K1 (Montgomery multiply, elementwise and in
// product chains) and K2 (NTT butterfly stages).
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
// K2 ez_ntt_stages replaces `_bfly_call` of ezkl_tpu/kernels/pntt.py (entry
// `bfly`), which ran one radix-2 stage (a + b*w, a - b*w) per launch: it runs
// r consecutive stages of a bit-reversed-input DIT transform in one launch.
//
// Bound on the H100: ez_mont_mul moves 3 x 32 bytes per element against
// 264 32-bit multiply-adds, so the bytes bound counts; but with its operands
// in L2 it still takes 1.4x that bound at 2^17 elements: the product's ~500
// instructions, 128 of them high halves of 32 x 32-bit products, set the
// pace beside HBM, and at the prove's 2^14 the latency of one load ->
// product -> store does. Design: one element per thread, kMontMulThreads =
// 64 a block, so that 2^14 elements still reach every SM (64, 128 and 256
// threads tied in the H100 sweep, PERF.md); the product by `mul_wide`
// (64-bit word products whose halves two carry-flag chains add: 496 SASS
// instructions against the 624 of `mul_cc`, and faster at both widths in
// the H100 sweep) and `reduce_cc`; limb-major accesses that coalesce across
// a warp. b's broadcast form is a template parameter that the entry picks
// from (n, b_n, b_rep) (bcast.cuh): dense (b_n = n), constant (b_n = 1:
// every thread reads the same 8 words), row (b_rep = 1: j mod b_n) and
// general ((j / b_rep) mod b_n). Indices are 32-bit (n < 2^31), and each
// division by b_n or b_rep is a multiply-high by a magic number the entry
// computes on the host: the SM has no integer divider.
// Two or four elements per thread (vector accesses) and a grid-stride loop
// that loads the next element before the product lost at both widths
// (PERF.md).
//
// A transform of 2^k points is k stages of one product per pair: as one
// launch per stage it read and wrote the whole array k times, and at 2^14 a
// stage was 8,192 threads and a ~2.7 us launch against a ~0.3 us byte bound.
// ez_ntt_stages runs stages s0+1 .. s0+r (r <= 10) on every column of an
// (8, cols, 2^k) array. The elements those stages connect -- a group, the
// 2^r indices that agree on every bit outside [s0, s0 + r) -- are loaded once
// into shared memory, the r stages run there with a block barrier between
// them, and the group is stored once: a transform is ceil(k / 10) reads and
// writes of the data (`pntt.pass_split`). A block holds gb groups, at most
// 1024 elements (32 KB of static shared memory, word-major: word i of tile
// element t at tile[i][t]). In the first pass (s0 = 0) a group is a
// contiguous run; in a later one its elements lie 2^s0 apart, and the block
// takes gb adjacent groups, so that a warp's loads of one word are gb
// consecutive words. Stage s reads its twiddle w_{2^s}^j from the one master
// table [w^0 .. w^(2^(k-1) - 1)] at j * 2^(k-s). Inside a launch the values
// are lazy (< 2p: `mul_cc`, `add2p_cc`, `sub2p_cc`, the teams' carry-flag
// arithmetic) and each is reduced once as it is stored; a stage's canonical
// output is unique, so the words are those of one launch per stage.
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

#include "bcast.cuh"
#include "bn254.cuh"

using namespace bcast;
using namespace bn254;

namespace {

constexpr int kThreads = 256;
constexpr int kMontMulThreads = 64;
constexpr int kChainThreads = 32;
// elements of ez_ntt_stages' tile: 32 KB of shared memory; 2^10, the largest
// group of stages one launch runs
constexpr int kNttTile = 1024;
constexpr int kNttMaxStages = 10;

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

// out[j] = a[j] * b[(j / rep) % period], one element per thread; n < 2^31.
template <int Form, class F>
__global__ void __launch_bounds__(kMontMulThreads)
    mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, uint32_t n, Divisor period, Divisor rep) {
  const uint32_t j = blockIdx.x * kMontMulThreads + threadIdx.x;
  if (j >= n) return;
  const Fe y = load(b, period.d, b_index<Form>(j, period, rep));
  store(out, n, j, reduce_cc<F>(mul_wide<F>(load(a, n, j), y)));
}

// Stages s0+1 .. s0+r over x: (8, total) = (8, cols, 2^k), into out (which
// may be x: a block reads and writes only its own tile). Group G (of
// total / 2^r) holds the elements at ((G >> s0) << (s0 + r)) | (e << s0) |
// (G mod 2^s0) for e < 2^r; block b holds groups b * gb .. b * gb + gb - 1,
// gb = 2^log_gb. Tile position of (group gl of the block, element e):
// gl * 2^r + e when s0 = 0 (the tile is one contiguous run), e * gb + gl
// otherwise (adjacent groups side by side). tw: the master table (8, 2^(k-1)).
// x canonical; the tile holds values < 2p; out canonical. Every thread takes
// every barrier: no thread leaves early.
template <class F>
__global__ void __launch_bounds__(kThreads)
    ntt_stages_kernel(const uint32_t* x, const uint32_t* __restrict__ tw, uint32_t* out,
                      long long total, int k, int s0, int r, int log_gb) {
  __shared__ uint32_t tile[8][kNttTile];
  const int tile_n = 1 << (r + log_gb), gb = 1 << log_gb;
  const long long lo_mask = (1LL << s0) - 1;
  const long long g0 = (long long)blockIdx.x << log_gb;
  const long long tw_n = 1LL << (k - 1);
  const auto pos = [&](int gl, int e) { return s0 == 0 ? (gl << r) | e : (e << log_gb) | gl; };
  const auto flat = [&](int t) {
    const int gl = s0 == 0 ? t >> r : t & (gb - 1);
    const long long e = s0 == 0 ? t & ((1 << r) - 1) : t >> log_gb;
    const long long G = g0 + gl;
    return ((G >> s0) << (s0 + r)) | (e << s0) | (G & lo_mask);
  };
  for (int t = threadIdx.x; t < tile_n; t += blockDim.x) {
    const long long j = flat(t);
#pragma unroll
    for (int i = 0; i < 8; ++i) tile[i][t] = x[i * total + j];
  }
  __syncthreads();
  for (int st = 0; st < r; ++st) {
    const int h = 1 << st, shift = k - (s0 + st + 1);
    for (int q = threadIdx.x; q < tile_n / 2; q += blockDim.x) {
      const int gl = s0 == 0 ? q >> (r - 1) : q & (gb - 1);
      const int pe = s0 == 0 ? q & ((1 << (r - 1)) - 1) : q >> log_gb;
      const int e0 = ((pe >> st) << (st + 1)) | (pe & (h - 1));
      const long long j = ((long long)(pe & (h - 1)) << s0) | ((g0 + gl) & lo_mask);
      const int t0 = pos(gl, e0), t1 = pos(gl, e0 + h);
      Fe a, b;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a.v[i] = tile[i][t0];
        b.v[i] = tile[i][t1];
      }
      const Fe bw = mul_cc<F>(b, load(tw, tw_n, j << shift));
      const Fe hi = add2p_cc<F>(a, bw), lo = sub2p_cc<F>(a, bw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        tile[i][t0] = hi.v[i];
        tile[i][t1] = lo.v[i];
      }
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < tile_n; t += blockDim.x) {
    Fe a;
#pragma unroll
    for (int i = 0; i < 8; ++i) a.v[i] = tile[i][t];
    store(out, total, flat(t), reduce_cc<F>(a));
  }
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

template <int Form, class F>
void launch_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, uint32_t n,
                const Divisor& period, const Divisor& rep, cudaStream_t s) {
  mont_mul_kernel<Form, F><<<blocks_for(n, kMontMulThreads), kMontMulThreads, 0, s>>>(
      a, b, out, n, period, rep);
}

template <class F>
void launch_mul_form(Form form, const uint32_t* a, const uint32_t* b, uint32_t* out, uint32_t n,
                     const Divisor& period, const Divisor& rep, cudaStream_t s) {
  if (form == kDense)
    launch_mul<kDense, F>(a, b, out, n, period, rep, s);
  else if (form == kConst)
    launch_mul<kConst, F>(a, b, out, n, period, rep, s);
  else if (form == kRow)
    launch_mul<kRow, F>(a, b, out, n, period, rep, s);
  else
    launch_mul<kGeneral, F>(a, b, out, n, period, rep, s);
}

}  // namespace

// field: 0 = Fr, 1 = Fq. Every entry returns cudaGetLastError() after launch.

// 1 <= n < 2^31; b is (8, b_n), read at (j / b_rep) % b_n, b_n * b_rep <= n.
extern "C" int ez_mont_mul(int field, const uint32_t* a, const uint32_t* b, uint32_t* out,
                           long long n, long long b_n, long long b_rep, void* stream) {
  if (n < 1 || n >= (1LL << 31) || b_n < 1 || b_rep < 1 || b_n * b_rep > n)
    return (int)cudaErrorInvalidValue;
  const Form form = form_of(n, b_n, b_rep);
  const Divisor period = divisor((uint32_t)b_n), rep = divisor((uint32_t)b_rep);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    launch_mul_form<Fr>(form, a, b, out, (uint32_t)n, period, rep, s);
  else
    launch_mul_form<Fq>(form, a, b, out, (uint32_t)n, period, rep, s);
  return (int)cudaGetLastError();
}

// Stages s0+1 .. s0+r (1 <= r <= 10, s0 + r <= k) of the DIT transform over
// each of `cols` columns of 2^k elements, gb = 2^log_gb groups per block
// (gb * 2^r <= 1024; gb <= 2^s0 when s0 > 0; `pntt.groups_per_block`
// chooses). out may be x.
extern "C" int ez_ntt_stages(int field, const uint32_t* x, const uint32_t* tw, uint32_t* out,
                             long long cols, int k, int s0, int r, int log_gb, void* stream) {
  if (r < 1 || r > kNttMaxStages || s0 < 0 || s0 + r > k || log_gb < 0 ||
      (1 << (r + log_gb)) > kNttTile || (s0 > 0 && log_gb > s0) || log_gb > k - r || cols < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = cols << k;
  const unsigned blocks = (unsigned)(total >> (r + log_gb));
  const int half_tile = 1 << (r + log_gb - 1);
  const int threads = half_tile < kThreads ? half_tile : kThreads;
  if (field == 0)
    ntt_stages_kernel<Fr><<<blocks, threads, 0, s>>>(x, tw, out, total, k, s0, r, log_gb);
  else
    ntt_stages_kernel<Fq><<<blocks, threads, 0, s>>>(x, tw, out, total, k, s0, r, log_gb);
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
