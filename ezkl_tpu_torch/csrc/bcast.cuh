// The broadcast operand of ez_mont_mul (field.cu): element j of the (8, n)
// output reads b[(j / rep) % period] of an (8, period) table. The entry picks
// the form and each divisor's magic on the host, once per launch; the kernel
// maps j on the device with 32-bit multiply-highs instead of divisions. Plain
// C++ beside `__device__` and `__umulhi`, so that a host compiler with
// tools/cuda_emu can check the map against `//` and `%`
// (tests/test_torch_field.py).

#pragma once

#include <stdint.h>

namespace bcast {

// dense (period = n): j; constant (period = 1): 0; row (rep = 1):
// j mod period; general: (j / rep) mod period
enum Form { kDense, kConst, kRow, kGeneral };

inline Form form_of(long long n, long long period, long long rep) {
  return period == n ? kDense : period == 1 ? kConst : rep == 1 ? kRow : kGeneral;
}

// A divisor d < 2^31 and, for d >= 2, its magic: x / d = umulhi(x, m) >> s
// for every x < 2^31, with l = ceil(log2 d), m = ceil(2^(31 + l) / d) < 2^32
// and s = l - 1 (Granlund and Montgomery, "Division by invariant integers
// using multiplication", 1994, thm. 4.2). No form divides by d = 1.
struct Divisor {
  uint32_t d, m;
  int s;
};

inline Divisor divisor(uint32_t d) {
  Divisor v{d, 0, 0};
  if (d < 2) return v;
  int l = 0;
  while ((1ull << l) < d) ++l;
  v.m = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
  v.s = l - 1;
  return v;
}

__device__ __forceinline__ uint32_t div_by(uint32_t x, const Divisor& v) {
  return __umulhi(x, v.m) >> v.s;
}

// The element of b that output j < 2^31 reads in form F.
template <int F>
__device__ __forceinline__ uint32_t b_index(uint32_t j, const Divisor& period,
                                            const Divisor& rep) {
  if constexpr (F == kConst) {
    return 0;
  } else if constexpr (F == kRow) {
    return j - div_by(j, period) * period.d;
  } else if constexpr (F == kGeneral) {
    const uint32_t q = div_by(j, rep);
    return q - div_by(q, period) * period.d;
  }
  return j;
}

}  // namespace bcast
