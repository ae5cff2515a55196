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

// a + m limb by limb, carry out of the top dropped (the callers' sums fit).
template <class M>
__device__ __forceinline__ Fe add_limbs(const Fe& a, M m) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] + m(i);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// a - b, returning the borrow out of the top limb.
__device__ __forceinline__ Fe sub_limbs(const Fe& a, const Fe& b, uint32_t& borrow) {
  Fe d;
  borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  return d;
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

// ---- canonical domain (< p in, < p out) -----------------------------------

template <class F>
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  return reduce<F>(mul_lazy<F>(a, b));
}

template <class F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  Fe s = add_limbs(a, [&](int i) { return b.v[i]; });  // < 2p < 2^256
  return reduce<F>(s);
}

template <class F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  uint32_t borrow;
  Fe d = sub_limbs(a, b, borrow);
  Fe f = add_limbs(d, [](int i) { return F::p(i); });
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = borrow ? f.v[i] : d.v[i];
  return r;
}

// ---- lazy domain (< 2p in, < 2p out), as pcurve.py:41-62 -------------------

template <class F>
__device__ __forceinline__ Fe add2p(const Fe& a, const Fe& b) {
  Fe s = add_limbs(a, [&](int i) { return b.v[i]; });  // < 4p < 2^256
  return sub_if_ge(s, [](int i) { return F::p2(i); });
}

template <class F>
__device__ __forceinline__ Fe sub2p(const Fe& a, const Fe& b) {
  uint32_t borrow;
  Fe d = sub_limbs(a, b, borrow);
  Fe f = add_limbs(d, [](int i) { return F::p2(i); });
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = borrow ? f.v[i] : d.v[i];
  return r;
}

// x * 3b = x * 9 by a doubling chain (9 = 8 + 1), as pcurve._xb3
template <class F>
__device__ __forceinline__ Fe xb3(const Fe& a) {
  Fe t2 = add2p<F>(a, a);
  Fe t4 = add2p<F>(t2, t2);
  Fe t8 = add2p<F>(t4, t4);
  return add2p<F>(t8, a);
}

// RCB15 algorithm 7 (a = 0, b3 = 9), the schedule of pcurve._complete_add_l.
// Lazy inside; the caller reduces the three outputs.
template <class F>
__device__ __forceinline__ void complete_add(const Fe& X1, const Fe& Y1, const Fe& Z1,
                                             const Fe& X2, const Fe& Y2, const Fe& Z2,
                                             Fe& X3, Fe& Y3, Fe& Z3) {
  Fe t0 = mul_lazy<F>(X1, X2);
  Fe t1 = mul_lazy<F>(Y1, Y2);
  Fe t2 = mul_lazy<F>(Z1, Z2);
  Fe t3 = add2p<F>(X1, Y1);
  Fe t4 = add2p<F>(X2, Y2);
  t3 = mul_lazy<F>(t3, t4);
  t4 = add2p<F>(t0, t1);
  t3 = sub2p<F>(t3, t4);
  t4 = add2p<F>(Y1, Z1);
  X3 = add2p<F>(Y2, Z2);
  t4 = mul_lazy<F>(t4, X3);
  X3 = add2p<F>(t1, t2);
  t4 = sub2p<F>(t4, X3);
  X3 = add2p<F>(X1, Z1);
  Y3 = add2p<F>(X2, Z2);
  X3 = mul_lazy<F>(X3, Y3);
  Y3 = add2p<F>(t0, t2);
  Y3 = sub2p<F>(X3, Y3);
  X3 = add2p<F>(t0, t0);
  t0 = add2p<F>(X3, t0);
  t2 = xb3<F>(t2);
  Z3 = add2p<F>(t1, t2);
  t1 = sub2p<F>(t1, t2);
  Y3 = xb3<F>(Y3);
  X3 = mul_lazy<F>(t4, Y3);
  t2 = mul_lazy<F>(t3, t1);
  X3 = sub2p<F>(t2, X3);
  Y3 = mul_lazy<F>(Y3, t0);
  t1 = mul_lazy<F>(t1, Z3);
  Y3 = add2p<F>(t1, Y3);
  t0 = mul_lazy<F>(t0, t3);
  Z3 = mul_lazy<F>(Z3, t4);
  Z3 = add2p<F>(Z3, t0);
}

// RCB15 algorithm 8 (a = 0, b3 = 9), the schedule of pcurve._mixed_add_l:
// (X1:Y1:Z1) projective (identity allowed) plus the affine (X2, Y2), which
// must not be the identity. 11 products. Lazy inside, as complete_add.
template <class F>
__device__ __forceinline__ void mixed_add(const Fe& X1, const Fe& Y1, const Fe& Z1,
                                          const Fe& X2, const Fe& Y2, Fe& X3, Fe& Y3, Fe& Z3) {
  Fe t0 = mul_lazy<F>(X1, X2);
  Fe t1 = mul_lazy<F>(Y1, Y2);
  Fe t3 = add2p<F>(X2, Y2);
  Fe t4 = add2p<F>(X1, Y1);
  t3 = mul_lazy<F>(t3, t4);
  t4 = add2p<F>(t0, t1);
  t3 = sub2p<F>(t3, t4);
  t4 = mul_lazy<F>(Y2, Z1);
  t4 = add2p<F>(t4, Y1);
  Y3 = mul_lazy<F>(X2, Z1);
  Y3 = add2p<F>(Y3, X1);
  X3 = add2p<F>(t0, t0);
  t0 = add2p<F>(X3, t0);
  Fe t2 = xb3<F>(Z1);
  Z3 = add2p<F>(t1, t2);
  t1 = sub2p<F>(t1, t2);
  Y3 = xb3<F>(Y3);
  X3 = mul_lazy<F>(t4, Y3);
  t2 = mul_lazy<F>(t3, t1);
  X3 = sub2p<F>(t2, X3);
  Y3 = mul_lazy<F>(Y3, t0);
  t1 = mul_lazy<F>(t1, Z3);
  Y3 = add2p<F>(t1, Y3);
  t0 = mul_lazy<F>(t0, t3);
  Z3 = mul_lazy<F>(Z3, t4);
  Z3 = add2p<F>(Z3, t0);
}

// RCB15 algorithm 9 (a = 0, b3 = 9), the schedule of pcurve._dbl_l.
template <class F>
__device__ __forceinline__ void dbl(const Fe& X, const Fe& Y, const Fe& Z,
                                    Fe& X3, Fe& Y3, Fe& Z3) {
  Fe t0 = mul_lazy<F>(Y, Y);
  Z3 = add2p<F>(t0, t0);
  Z3 = add2p<F>(Z3, Z3);
  Z3 = add2p<F>(Z3, Z3);
  Fe t1 = mul_lazy<F>(Y, Z);
  Fe t2 = mul_lazy<F>(Z, Z);
  t2 = xb3<F>(t2);
  X3 = mul_lazy<F>(t2, Z3);
  Y3 = add2p<F>(t0, t2);
  Z3 = mul_lazy<F>(t1, Z3);
  t1 = add2p<F>(t2, t2);
  t2 = add2p<F>(t1, t2);
  t0 = sub2p<F>(t0, t2);
  Y3 = mul_lazy<F>(t0, Y3);
  Y3 = add2p<F>(X3, Y3);
  t1 = mul_lazy<F>(X, Y);
  X3 = mul_lazy<F>(t0, t1);
  X3 = add2p<F>(X3, X3);
}

}  // namespace bn254
