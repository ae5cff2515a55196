// BN254 Montgomery arithmetic for Hopper (sm_90a), shared by the port's
// hand-written kernels (field.cu, curve.cu, msm.cu).
//
// Layout: a field element is eight little-endian 32-bit limbs in Montgomery
// form with R = 2^256 -- the same Montgomery integers as the JAX package's
// sixteen 16-bit limbs (`ezkl_tpu/fieldmath/limbs.py`). Arrays are limb-major
// (8, n): limb i of element j sits at [i * n + j], so the 32 threads of a warp
// that load limb i of 32 consecutive elements read 128 contiguous bytes.
//
// The TPU split every 16x16 product into 16-bit pieces because its vector
// unit has no widening multiply (limbs.py:10-12). Hopper has one (IMAD.WIDE),
// so the product here is the textbook 8x8-word CIOS Montgomery multiply with
// 64-bit accumulators; the TPU's shear sums and Kogge-Stone carries are not
// carried over.
//
// Value domains. BN254 has 4p < 2^256, so:
//   mont_mul(a, b) with a, b < 2p returns (ab + mp) / R < 2p  (lazy domain);
//   one conditional subtraction of p makes a value < 2p canonical.
// The m of CIOS is the unique m in [0, R) with ab + mp = 0 mod R, the same m
// as the JAX package's separated reduction (`_mont_mul_l`), so the lazy
// values -- and the canonical ones -- are identical to the reference's.

#pragma once

#include <cstdint>

namespace bn254 {

struct Fr {
  static constexpr uint32_t INV = 0xefffffffu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ uint32_t p(int i) {
    constexpr uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  static __device__ __forceinline__ uint32_t p2(int i) {
    constexpr uint32_t P2[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                                0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return P2[i];
  }
};

struct Fq {
  static constexpr uint32_t INV = 0xe4866389u;  // -p^-1 mod 2^32
  static __device__ __forceinline__ uint32_t p(int i) {
    constexpr uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  static __device__ __forceinline__ uint32_t p2(int i) {
    constexpr uint32_t P2[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                                0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return P2[i];
  }
  // R mod p, the Montgomery form of 1
  static __device__ __forceinline__ uint32_t one(int i) {
    constexpr uint32_t ONE[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return ONE[i];
  }
};

struct Fe {
  uint32_t v[8];
};

__device__ __forceinline__ Fe load(const uint32_t* __restrict__ base, long long n, long long j) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = base[i * n + j];
  return r;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ base, long long n, long long j,
                                      const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) base[i * n + j] = a.v[i];
}

// a - m if a >= m else a, for m given limb by limb; `m` is p or 2p.
template <class M>
__device__ __forceinline__ Fe sub_if_ge(const Fe& a, M m) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)a.v[i] - m(i) - borrow;
    d.v[i] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = borrow ? a.v[i] : d.v[i];
  return r;
}

// canonical (< p) from a value < 2p
template <class F>
__device__ __forceinline__ Fe reduce(const Fe& a) {
  return sub_if_ge(a, [](int i) { return F::p(i); });
}

// CIOS Montgomery product, inputs < 2p, output < 2p (not reduced).
template <class F>
__device__ __forceinline__ Fe mul_lazy(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * F::INV;
    c = ((uint64_t)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * F::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return r;
}

// ---- arithmetic on the carry flag (the teams', K1's and K2's) -------------
//
// `mul_cc` is the CIOS of `mul_lazy` -- the same m per row, so the same
// words -- written with PTX's carry-chained multiply-adds: a row is four
// chains, the low and the high halves of a_j * b_i, then of m * p_j. Nine
// words hold the accumulator: with a, b < 2p and p < 2^254,
// T + a * b_i + m * p < (a + p)(2^32 + 1) < 2^288 at every row. ptxas makes
// each step an IMAD or IMAD.HI and an IADD3.X that keeps the flag in a
// predicate; in K4's teams of two it ran 12-16% faster than `mul_lazy`, in K8
// within 3% of it (PERF.md). `add2p_cc`, `sub2p_cc`, `xb3_cc` and
// `reduce_cc` are the lazy add, sub, x * 9 and the final reduction the same
// way, at one instruction a word per chain where a 64-bit emulation of the
// carry takes about three.
//
// Each helper below is one `asm volatile` statement, so the statements keep
// their order and the flag flows from one to the next. Off the device (the
// kernels compiled by g++ in `tools/emulate_msm_kernels.py`) `cf` carries
// the flag instead.

__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  const uint64_t s = (uint64_t)(a * b) + c;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  const uint64_t s = (uint64_t)(a * b) + c + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// the last of a chain: no carry out (the callers' sums fit)
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + cf);
#endif
}

__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  return a + b + cf;
#endif
}

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  const uint64_t s = (uint64_t)a + b;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  const uint64_t s = (uint64_t)a + b + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// with the flag as the borrow
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  cf = a < b;
  return a - b;
#endif
}

__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  const uint64_t x = (uint64_t)a - b - cf;
  cf = (uint32_t)(x >> 63);
  return (uint32_t)x;
#endif
}

// 0 - 0 - borrow: all ones where the chain borrowed
__device__ __forceinline__ uint32_t borrow_mask(uint32_t& cf) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(d));
  return d;
#else
  return 0u - cf;
#endif
}

// t[0..8] += x * y[0..7] (t[8] takes the carries; the sum fits in 9 words)
__device__ __forceinline__ void mad_row(uint32_t (&t)[9], uint32_t x, const uint32_t (&y)[8]) {
  uint32_t cf = 0;
  t[0] = mad_lo_cc(y[0], x, t[0], cf);
#pragma unroll
  for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(y[j], x, t[j], cf);
  t[8] = addc(t[8], 0u, cf);
  t[1] = mad_hi_cc(y[0], x, t[1], cf);
#pragma unroll
  for (int j = 1; j < 7; ++j) t[j + 1] = madc_hi_cc(y[j], x, t[j + 1], cf);
  t[8] = madc_hi(y[7], x, t[8], cf);
}

// CIOS Montgomery product on the carry flag: inputs < 2p, output < 2p, the
// words of `mul_lazy`.
template <class F>
__device__ __forceinline__ Fe mul_cc(const Fe& a, const Fe& b) {
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = F::p(j);
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mad_row(t, b.v[i], a.v);
    mad_row(t, t[0] * F::INV, p);  // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  return r;
}

// t[0..8] += x * y[0..7] as mad_row, each word product one 64-bit multiply
// (IMAD.WIDE.U32), its low halves added by one carry chain and its high
// halves by another
__device__ __forceinline__ void mad_row_w(uint32_t (&t)[9], uint32_t x, const uint32_t (&y)[8]) {
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t p = (uint64_t)y[j] * x;
    lo[j] = (uint32_t)p;
    hi[j] = (uint32_t)(p >> 32);
  }
  uint32_t cf = 0;
  t[0] = add_cc(t[0], lo[0], cf);
#pragma unroll
  for (int j = 1; j < 8; ++j) t[j] = addc_cc(t[j], lo[j], cf);
  t[8] = addc(t[8], 0u, cf);
  t[1] = add_cc(t[1], hi[0], cf);
#pragma unroll
  for (int j = 1; j < 7; ++j) t[j + 1] = addc_cc(t[j + 1], hi[j], cf);
  t[8] = addc(t[8], hi[7], cf);
}

// `mul_cc` with the rows of `mad_row_w`: the same CIOS and words, 496 SASS
// instructions in K1 against 624, where ptxas makes each `mad_row` step an
// IMAD and an IMAD.HI. Where many independent products fill the card (K1)
// it ran faster than `mul_cc`; in the teams' short dependent levels
// `mul_cc` stays (PERF.md).
template <class F>
__device__ __forceinline__ Fe mul_wide(const Fe& a, const Fe& b) {
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = F::p(j);
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mad_row_w(t, b.v[i], a.v);
    mad_row_w(t, t[0] * F::INV, p);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  return r;
}

// The lazy add, sub and x * 9 (< 2p in, < 2p out) and the final reduction,
// the values of the TPU kernels' `_add`, `_sub`, `_xb3` and `_canon`
// (ezkl_tpu/kernels/pcurve.py:41-70): one instruction a word for each chain.
template <class F>
__device__ __forceinline__ Fe add2p_cc(const Fe& a, const Fe& b) {
  uint32_t cf = 0, s[8], d[8];
  s[0] = add_cc(a.v[0], b.v[0], cf);
#pragma unroll
  for (int j = 1; j < 7; ++j) s[j] = addc_cc(a.v[j], b.v[j], cf);
  s[7] = addc(a.v[7], b.v[7], cf);  // < 4p < 2^256
  d[0] = sub_cc(s[0], F::p2(0), cf);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(s[j], F::p2(j), cf);
  const uint32_t keep = borrow_mask(cf);  // s < 2p: keep s
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = (s[j] & keep) | (d[j] & ~keep);
  return r;
}

template <class F>
__device__ __forceinline__ Fe sub2p_cc(const Fe& a, const Fe& b) {
  uint32_t cf = 0, d[8];
  d[0] = sub_cc(a.v[0], b.v[0], cf);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a.v[j], b.v[j], cf);
  const uint32_t add = borrow_mask(cf);  // a < b: add 2p
  Fe r;
  r.v[0] = add_cc(d[0], F::p2(0) & add, cf);
#pragma unroll
  for (int j = 1; j < 7; ++j) r.v[j] = addc_cc(d[j], F::p2(j) & add, cf);
  r.v[7] = addc(d[7], F::p2(7) & add, cf);
  return r;
}

// canonical (< p) from a value < 2p, the value of `reduce`
template <class F>
__device__ __forceinline__ Fe reduce_cc(const Fe& a) {
  uint32_t cf = 0, d[8];
  d[0] = sub_cc(a.v[0], F::p(0), cf);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a.v[j], F::p(j), cf);
  const uint32_t keep = borrow_mask(cf);  // a < p: keep a
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = (a.v[j] & keep) | (d[j] & ~keep);
  return r;
}

template <class F>
__device__ __forceinline__ Fe xb3_cc(const Fe& a) {
  const Fe t2 = add2p_cc<F>(a, a);
  const Fe t4 = add2p_cc<F>(t2, t2);
  const Fe t8 = add2p_cc<F>(t4, t4);
  return add2p_cc<F>(t8, a);
}

// ---- teams: T threads of one warp carry one point chain -------------------
//
// RCB15's formulas have their products in two levels of independent
// products: alg. 7 (complete add) 6 then 6, alg. 8 (mixed add) 5 then 6,
// alg. 9 (doubling) 4 then 4. A team of T = 2, 4 or 8 threads, aligned
// inside one warp (so `__syncwarp` of the team is its only barrier), holds
// the point in every thread and evaluates each level side by side: in round
// k thread `rank` computes product k * T + rank with `mul_cc` and writes it
// to the team's slots in shared memory; after the team's barrier every
// thread reads all of the level's products back and runs the adds, subs and
// `xb3` up to the next level itself. A point operation's critical path is
// ceil(K1 / T) + ceil(K2 / T) products instead of K1 + K2; the adds run in
// all T threads. Every product keeps the lazy contract (< 2p in, < 2p out)
// and the values are those of RCB15's schedules as the plain versions
// run them (`kernels/pcurve.py`: `_complete_add_w`, `_mixed_add_w`,
// `_dbl_w`), so the canonical outputs equal theirs.
//
// Slots: level 1 of every formula uses half 0, level 2 half 1. A thread
// writes half h only after the team's barrier of the level in between,
// which every thread reaches only after it has read half h, so one barrier
// per level suffices.

constexpr int kSlots = 8;  // per half: a level's K products plus the idle ranks' writes

// Threads per block of a kernel of teams of T: 128 for teams of 2, one
// warp for teams of 4 and 8, so that a few thousand lanes still spread
// over the 132 SMs (measured for K3, K4 and K9, PERF.md).
template <int T>
__host__ __device__ constexpr int team_block() {
  return T == 2 ? 128 : 32;
}

template <int T>
struct Team {
  static_assert(T == 2 || T == 4 || T == 8, "a team is 2, 4 or 8 threads");
  unsigned mask;  // the team's lanes in its warp
  int rank;       // 0 .. T-1
  uint4* lo;      // slot i's words 0-3 at lo[i * stride], 4-7 at hi[i * stride]
  uint4* hi;
  int stride;
};

// Shared memory for the teams of a block of `Teams` teams of T: a slot's two
// 16-byte halves in two arrays, slot-major, the teams of a slot side by side
// and padded to a stride = 8 / T (mod 8), so that the 8 threads of a quarter
// warp touch 8 different 16-byte bank groups both when they read (a slot of
// 8 / T teams, the same address in a team) and when they write (T slots of
// 8 / T teams).
template <int T, int Teams>
struct TeamSlots {
  static constexpr int kStride = Teams + ((8 / T - Teams % 8) % 8 + 8) % 8;
  uint4 lo[2 * kSlots * kStride];
  uint4 hi[2 * kSlots * kStride];
};

// The team of thread `threadIdx.x`: threads t with equal t / T, so a block
// holds blockDim.x / T teams.
template <int T, int Teams>
__device__ __forceinline__ Team<T> make_team(TeamSlots<T, Teams>& sm) {
  const int lane = threadIdx.x & 31, team = threadIdx.x / T;
  Team<T> tm;
  tm.rank = lane & (T - 1);
  tm.mask = ((1u << T) - 1u) << (lane & ~(T - 1));
  tm.lo = sm.lo + team;
  tm.hi = sm.hi + team;
  tm.stride = TeamSlots<T, Teams>::kStride;
  return tm;
}

// One level of K independent products out[i] = a[i] * b[i] (lazy), spread
// over the team: in round k thread `rank` computes product k * T + rank. A
// rank past K computes a spare product and writes it to a spare slot, so
// that the rounds have no branch between them and the compiler can
// interleave their products. The operands are picked by selects, not by a
// runtime index, which would move the arrays to local memory.
template <class F, int Half, int T, int K>
__device__ __forceinline__ void team_level(const Team<T>& tm, const Fe (&a)[K], const Fe (&b)[K],
                                           Fe (&out)[K]) {
  constexpr int R = (K + T - 1) / T;
  static_assert(R * T <= kSlots, "level too wide");
  const int base = Half * kSlots;
  Fe r[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = k * T + tm.rank;
    Fe x = a[k * T], y = b[k * T];
#pragma unroll
    for (int j = k * T + 1; j < K && j < (k + 1) * T; ++j) {
      if (i == j) {
        x = a[j];
        y = b[j];
      }
    }
    r[k] = mul_cc<F>(x, y);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int e = (base + k * T + tm.rank) * tm.stride;
    tm.lo[e] = make_uint4(r[k].v[0], r[k].v[1], r[k].v[2], r[k].v[3]);
    tm.hi[e] = make_uint4(r[k].v[4], r[k].v[5], r[k].v[6], r[k].v[7]);
  }
  __syncwarp(tm.mask);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint4 lo = tm.lo[(base + i) * tm.stride], hi = tm.hi[(base + i) * tm.stride];
    out[i] = Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  }
}

// Level 2 and the last adds of alg. 7 and alg. 8, which share them, from
// 3 * t0, t1 - t2, t3, t4, xb3(Y3) and t1 + t2 of `_complete_add_w`. The
// operands are paired so that each round of a team of two shares one.
template <class F, int T>
__device__ __forceinline__ void team_add_tail(const Team<T>& tm, const Fe& t0, const Fe& t1,
                                              const Fe& t3, const Fe& t4, const Fe& y3,
                                              const Fe& z3, Fe& X3, Fe& Y3, Fe& Z3) {
  const Fe a2[6] = {y3, y3, z3, z3, t3, t3};
  const Fe b2[6] = {t0, t4, t1, t4, t1, t0};
  Fe q[6];
  team_level<F, 1>(tm, a2, b2, q);  // Y3, X3, t1, Z3, t2, t0 of complete_add
  X3 = sub2p_cc<F>(q[4], q[1]);
  Y3 = add2p_cc<F>(q[2], q[0]);
  Z3 = add2p_cc<F>(q[3], q[5]);
}

// RCB15 alg. 7 by a team: the values of `_complete_add_w`.
template <class F, int T>
__device__ __forceinline__ void team_complete_add(const Team<T>& tm, const Fe& X1, const Fe& Y1,
                                                  const Fe& Z1, const Fe& X2, const Fe& Y2,
                                                  const Fe& Z2, Fe& X3, Fe& Y3, Fe& Z3) {
  const Fe a1[6] = {X1, Y1, Z1, add2p_cc<F>(X1, Y1), add2p_cc<F>(Y1, Z1),
                    add2p_cc<F>(X1, Z1)};
  const Fe b1[6] = {X2, Y2, Z2, add2p_cc<F>(X2, Y2), add2p_cc<F>(Y2, Z2),
                    add2p_cc<F>(X2, Z2)};
  Fe p[6];
  team_level<F, 0>(tm, a1, b1, p);  // t0, t1, t2, t3, t4, X3 of complete_add
  const Fe t0 = p[0], t1 = p[1], t2 = xb3_cc<F>(p[2]);
  const Fe t3 = sub2p_cc<F>(p[3], add2p_cc<F>(t0, t1));
  const Fe t4 = sub2p_cc<F>(p[4], add2p_cc<F>(t1, p[2]));
  const Fe y3 = xb3_cc<F>(sub2p_cc<F>(p[5], add2p_cc<F>(t0, p[2])));
  const Fe t0x3 = add2p_cc<F>(add2p_cc<F>(t0, t0), t0);
  const Fe z3 = add2p_cc<F>(t1, t2);
  team_add_tail<F>(tm, t0x3, sub2p_cc<F>(t1, t2), t3, t4, y3, z3, X3, Y3, Z3);
}

// RCB15 alg. 8 by a team: the values of `_mixed_add_w`.
template <class F, int T>
__device__ __forceinline__ void team_mixed_add(const Team<T>& tm, const Fe& X1, const Fe& Y1,
                                               const Fe& Z1, const Fe& X2, const Fe& Y2, Fe& X3,
                                               Fe& Y3, Fe& Z3) {
  const Fe a1[5] = {X2, X2, Y2, Y2, add2p_cc<F>(X2, Y2)};
  const Fe b1[5] = {X1, Z1, Y1, Z1, add2p_cc<F>(X1, Y1)};
  Fe p[5];
  team_level<F, 0>(tm, a1, b1, p);  // t0, Y3, t1, t4, t3 of mixed_add
  const Fe t0 = p[0], t1 = p[2], t2 = xb3_cc<F>(Z1);
  const Fe t3 = sub2p_cc<F>(p[4], add2p_cc<F>(t0, t1));
  const Fe t4 = add2p_cc<F>(p[3], Y1);
  const Fe y3 = xb3_cc<F>(add2p_cc<F>(p[1], X1));
  const Fe t0x3 = add2p_cc<F>(add2p_cc<F>(t0, t0), t0);
  const Fe z3 = add2p_cc<F>(t1, t2);
  team_add_tail<F>(tm, t0x3, sub2p_cc<F>(t1, t2), t3, t4, y3, z3, X3, Y3, Z3);
}

// RCB15 alg. 9 by a team: the values of `_dbl_w`.
template <class F, int T>
__device__ __forceinline__ void team_dbl(const Team<T>& tm, const Fe& X, const Fe& Y, const Fe& Z,
                                         Fe& X3, Fe& Y3, Fe& Z3) {
  const Fe a1[4] = {Y, Y, Z, X};
  const Fe b1[4] = {Y, Z, Z, Y};
  Fe p[4];
  team_level<F, 0>(tm, a1, b1, p);  // t0, t1, t2 and X * Y of dbl
  const Fe t0 = p[0];
  Fe z3 = add2p_cc<F>(t0, t0);
  z3 = add2p_cc<F>(z3, z3);
  z3 = add2p_cc<F>(z3, z3);
  const Fe t2 = xb3_cc<F>(p[2]);
  const Fe y3 = add2p_cc<F>(t0, t2);
  const Fe t0b = sub2p_cc<F>(t0, add2p_cc<F>(add2p_cc<F>(t2, t2), t2));
  const Fe a2[4] = {t2, p[1], t0b, t0b};
  const Fe b2[4] = {z3, z3, y3, p[3]};
  Fe q[4];
  team_level<F, 1>(tm, a2, b2, q);  // X3, Z3, Y3 and the last X3 of dbl
  Y3 = add2p_cc<F>(q[0], q[2]);
  X3 = add2p_cc<F>(q[3], q[3]);
  Z3 = q[1];
}

// The limbs of `a` that thread `rank` of a team of T stores: limbs
// rank, rank + T, ... (none for rank >= 8).
template <int T>
__device__ __forceinline__ void team_store(const Team<T>& tm, uint32_t* __restrict__ base,
                                           long long n, long long j, const Fe& a) {
#pragma unroll
  for (int q = 0; q < 8; q += T) {
    uint32_t w = a.v[q];
#pragma unroll
    for (int u = 1; u < T && q + u < 8; ++u)
      if (tm.rank == u) w = a.v[q + u];
    if (q + tm.rank < 8) base[(q + tm.rank) * n + j] = w;
  }
}

// Lane j of (8, stride) point arrays, reduced to canonical, each thread of
// the team storing its limbs.
template <int T>
__device__ __forceinline__ void team_store_point(const Team<T>& tm, uint32_t* __restrict__ ox,
                                                 uint32_t* __restrict__ oy,
                                                 uint32_t* __restrict__ oz, long long stride,
                                                 long long j, const Fe& X, const Fe& Y,
                                                 const Fe& Z) {
  team_store(tm, ox, stride, j, reduce_cc<Fq>(X));
  team_store(tm, oy, stride, j, reduce_cc<Fq>(Y));
  team_store(tm, oz, stride, j, reduce_cc<Fq>(Z));
}

// K7's and K9's lane: c >= 1 doublings (alg. 9) of point j of the (8, n)
// arrays x, y, z by the team, stored once.
template <int T>
__device__ __forceinline__ void team_dbl_lane(const Team<T>& tm, const uint32_t* __restrict__ x,
                                              const uint32_t* __restrict__ y,
                                              const uint32_t* __restrict__ z,
                                              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                              uint32_t* __restrict__ oz, long long n, long long j,
                                              int c) {
  Fe X = load(x, n, j), Y = load(y, n, j), Z = load(z, n, j);
  for (int k = 0; k < c; ++k) {
    Fe X3, Y3, Z3;
    team_dbl<Fq>(tm, X, Y, Z, X3, Y3, Z3);
    X = X3;
    Y = Y3;
    Z = Z3;
  }
  team_store_point(tm, ox, oy, oz, n, j, X, Y, Z);
}

}  // namespace bn254
