// Point kernels of the fused MSM (`kernels/msm.py:msm_multi`) over BN254 G1,
// y^2 = x^3 + 3, projective (X:Y:Z) with identity (0:1:0). Each kernel keeps a
// sequential chain of point operations inside one launch, a team of threads
// per lane with the accumulator in registers, where the unfused MSM issued
// one K3 or K9 launch per step.
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
// dependent chain (K7 at k = 14: 9 doublings; K8: 26 windows x (10
// doublings + 1 add)), and so are K4-K6 at one column.
// Design: the whole step loop inside the kernel, so the carried point never
// leaves registers, and a team of threads per lane or column (bn254.cuh,
// "teams"): the products of each level of a formula side by side on the
// carry flag, so a chain's critical path is 2-6 products per point operation
// instead of 8-12. A team repeats the adds between the levels in each of its
// threads, so K4, K5 and K6 take a smaller team where many lanes already fill
// the card (`pcurve.lane_team`); K7's few hundred lanes take teams of 4
// (kDblTeam), a warp of teams per block; K8's few columns take teams of 8,
// one per block. Step-major layouts (8, S, m) -- element (limb i,
// step s, lane l) at (i * S + s) * m + l -- make the lanes of one step
// contiguous, so the loads and stores of a warp coalesce; the MSM's gather
// writes that layout directly.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

// K7's team: alg. 9 has two levels of 4 products, so teams of 4 have the
// critical path of teams of 8 with half the threads (teams of 8 measured as
// fast, of 2 twice as slow; PERF.md).
constexpr int kDblTeam = 4;
constexpr int kHornerTeam = 8;

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
  uint32_t cf = 0;
  Fe r;
  r.v[0] = sub_cc(Fq::p(0), y.v[0], cf);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.v[i] = subc_cc(Fq::p(i), y.v[i], cf);
  return r;
}

__device__ __forceinline__ bool is_pad_pair(const Fe& x, const Fe& y) {
  bool pad = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) pad &= (x.v[i] == 0u) & (y.v[i] == Fq::one(i));
  return pad;
}

// K5: inputs and outputs step-major (8, S, m); a team of T threads per lane,
// team_block<T>() / T lanes per block, as K4. Step 0 loads the first point
// (z = 1 for affine inputs); each later step adds the next with the team, by
// complete adds (alg. 7, identities allowed) or mixed adds (alg. 8, affine
// inputs, no identities); every step's canonical prefix is stored, each
// thread its limbs.
template <bool Mixed, int T>
__global__ void __launch_bounds__(team_block<T>())
    scan_steps_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                      const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                      uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long m,
                      int steps) {
  constexpr int kTeams = team_block<T>() / T;
  __shared__ TeamSlots<T, kTeams> slots;
  const long long l = (long long)blockIdx.x * kTeams + threadIdx.x / T;
  if (l >= m) return;  // the whole team: l is the same in its threads
  const Team<T> tm = make_team(slots);
  const long long stride = m * steps;
  Fe X, Y, Z;
  for (int s = 0; s < steps; ++s) {
    const long long j = (long long)s * m + l;
    const Fe X2 = load(x, stride, j);
    const Fe Y2 = load(y, stride, j);
    if (s == 0) {
      X = X2;
      Y = Y2;
      Z = Mixed ? fq_one() : load(z, stride, j);
    } else {
      Fe X3, Y3, Z3;
      if (Mixed)
        team_mixed_add<Fq>(tm, X, Y, Z, X2, Y2, X3, Y3, Z3);
      else
        team_complete_add<Fq>(tm, X, Y, Z, X2, Y2, load(z, stride, j), X3, Y3, Z3);
      X = X3;
      Y = Y3;
      Z = Z3;
    }
    team_store_point(tm, ox, oy, oz, stride, j, X, Y, Z);
  }
}

// K4: px, py, sn and the outputs step-major (8, S, m); a team of T threads
// per lane, team_block<T>() / T lanes per block. Every thread of the team
// loads the step's point (the team's loads of one word are one broadcast),
// runs the mixed add with the team and stores its limbs of the canonical
// prefix. A pad pair is the identity: Z = 0 at step 0; later the add is
// computed and dropped, so that the team's threads stay in step.
template <int T>
__global__ void __launch_bounds__(team_block<T>())
    scan_packed_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                       const int32_t* __restrict__ sn, uint32_t* __restrict__ ox,
                       uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long m,
                       int steps) {
  constexpr int kTeams = team_block<T>() / T;
  __shared__ TeamSlots<T, kTeams> slots;
  const long long l = (long long)blockIdx.x * kTeams + threadIdx.x / T;
  if (l >= m) return;  // the whole team: l is the same in its threads
  const Team<T> tm = make_team(slots);
  const long long stride = m * steps;
  Fe X, Y, Z;
  for (int s = 0; s < steps; ++s) {
    const long long j = (long long)s * m + l;
    const Fe X2 = load(px, stride, j);
    Fe Y2 = load(py, stride, j);
    const bool pad = is_pad_pair(X2, Y2);
    if (sn[j] != 0) Y2 = neg_raw(Y2);
    if (s == 0) {
      X = X2;
      Y = Y2;
      Z = pad ? fe_zero() : fq_one();
    } else {
      Fe X3, Y3, Z3;
      team_mixed_add<Fq>(tm, X, Y, Z, X2, Y2, X3, Y3, Z3);
      if (!pad) {
        X = X3;
        Y = Y3;
        Z = Z3;
      }
    }
    team_store_point(tm, ox, oy, oz, stride, j, X, Y, Z);
  }
}

// The point at element e of a (8, ...) batch of `stride` elements per limb
// (z = 1 for affine inputs).
template <bool Mixed>
__device__ __forceinline__ void load_point(const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ y,
                                           const uint32_t* __restrict__ z, long long stride,
                                           long long e, Fe& X, Fe& Y, Fe& Z) {
  X = load(x, stride, e);
  Y = load(y, stride, e);
  Z = Mixed ? fq_one() : load(z, stride, e);
}

// K6: input (8, G, chunks, blk), output (8, G, blk); a team of T threads per
// lane l = g * blk + i, team_block<T>() / T lanes per block, as K4 and K5.
// The team sums chunks 0 .. chunks-1 in order, by complete adds (alg. 7,
// identities allowed) or mixed adds (alg. 8, affine inputs, no identities);
// chunk j+1's point is loaded before chunk j's add, so that its load does
// not wait on the chain. One canonical store, each thread its limbs.
template <bool Mixed, int T>
__global__ void __launch_bounds__(team_block<T>())
    fold_lanes_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                      const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                      uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long groups,
                      int chunks, int blk) {
  constexpr int kTeams = team_block<T>() / T;
  __shared__ TeamSlots<T, kTeams> slots;
  const long long l = (long long)blockIdx.x * kTeams + threadIdx.x / T;
  const long long lanes = groups * blk;
  if (l >= lanes) return;  // the whole team: l is the same in its threads
  const Team<T> tm = make_team(slots);
  const long long stride = lanes * chunks;
  const long long base = (l / blk) * chunks * blk + l % blk;
  Fe X, Y, Z, X2, Y2, Z2;
  load_point<Mixed>(x, y, z, stride, base, X, Y, Z);
  if (chunks > 1) load_point<Mixed>(x, y, z, stride, base + blk, X2, Y2, Z2);
  for (int j = 1; j < chunks; ++j) {
    const Fe Xj = X2, Yj = Y2, Zj = Z2;
    if (j + 1 < chunks)
      load_point<Mixed>(x, y, z, stride, base + (long long)(j + 1) * blk, X2, Y2, Z2);
    Fe X3, Y3, Z3;
    if (Mixed)
      team_mixed_add<Fq>(tm, X, Y, Z, Xj, Yj, X3, Y3, Z3);
    else
      team_complete_add<Fq>(tm, X, Y, Z, Xj, Yj, Zj, X3, Y3, Z3);
    X = X3;
    Y = Y3;
    Z = Z3;
  }
  team_store_point(tm, ox, oy, oz, lanes, l, X, Y, Z);
}

// K7: (8, n) -> (8, n), c >= 1 doublings; a team of kDblTeam threads per
// lane, a warp of 32 / kDblTeam teams per block.
__global__ void __launch_bounds__(team_block<kDblTeam>())
    dbl_pow2_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n, int c) {
  constexpr int kTeams = team_block<kDblTeam>() / kDblTeam;
  __shared__ TeamSlots<kDblTeam, kTeams> slots;
  const long long j = (long long)blockIdx.x * kTeams + threadIdx.x / kDblTeam;
  if (j >= n) return;  // the whole team
  team_dbl_lane(make_team(slots), x, y, z, ox, oy, oz, n, j, c);
}

// K8: v (8, W, width), MSB window first -> (8, width); one team of
// kHornerTeam threads per column, one column per block, so that no two
// chains share a warp.
__global__ void __launch_bounds__(kHornerTeam)
    horner_kernel(const uint32_t* __restrict__ vx, const uint32_t* __restrict__ vy,
                  const uint32_t* __restrict__ vz, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int windows, int c,
                  long long width) {
  __shared__ TeamSlots<kHornerTeam, 1> slots;
  const long long j = blockIdx.x;
  const Team<kHornerTeam> tm = make_team(slots);
  const long long stride = (long long)windows * width;
  Fe X = fe_zero(), Y = fq_one(), Z = fe_zero();
  for (int w = 0; w < windows; ++w) {
    for (int k = 0; k < c; ++k) {
      Fe X3, Y3, Z3;
      team_dbl<Fq>(tm, X, Y, Z, X3, Y3, Z3);
      X = X3;
      Y = Y3;
      Z = Z3;
    }
    const long long e = (long long)w * width + j;
    Fe X3, Y3, Z3;
    team_complete_add<Fq>(tm, X, Y, Z, load(vx, stride, e), load(vy, stride, e),
                          load(vz, stride, e), X3, Y3, Z3);
    X = X3;
    Y = Y3;
    Z = Z3;
  }
  team_store_point(tm, ox, oy, oz, width, j, X, Y, Z);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <bool Mixed, int T>
void launch_scan_steps(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                       uint32_t* oy, uint32_t* oz, long long m, int steps, cudaStream_t s) {
  scan_steps_kernel<Mixed, T><<<blocks_for(m, team_block<T>() / T), team_block<T>(), 0, s>>>(
      x, y, z, ox, oy, oz, m, steps);
}

template <int T>
void launch_scan_packed(const uint32_t* px, const uint32_t* py, const int32_t* sn, uint32_t* ox,
                        uint32_t* oy, uint32_t* oz, long long m, int steps, cudaStream_t s) {
  scan_packed_kernel<T><<<blocks_for(m, team_block<T>() / T), team_block<T>(), 0, s>>>(
      px, py, sn, ox, oy, oz, m, steps);
}

template <bool Mixed, int T>
void launch_fold(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                 uint32_t* oy, uint32_t* oz, long long groups, int chunks, int blk,
                 cudaStream_t s) {
  fold_lanes_kernel<Mixed, T><<<blocks_for(groups * blk, team_block<T>() / T), team_block<T>(),
                                0, s>>>(x, y, z, ox, oy, oz, groups, chunks, blk);
}

}  // namespace

// Every entry returns cudaGetLastError() after its launch.

// team: threads per lane, 2 or 8 (`pcurve.lane_team` chooses)
extern "C" int ez_scan_packed(const uint32_t* px, const uint32_t* py, const int32_t* sn,
                              uint32_t* ox, uint32_t* oy, uint32_t* oz, long long m, int steps,
                              int team, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (team == 2)
    launch_scan_packed<2>(px, py, sn, ox, oy, oz, m, steps, s);
  else if (team == 8)
    launch_scan_packed<8>(px, py, sn, ox, oy, oz, m, steps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// mixed: 0 = projective inputs (x, y, z) by complete adds, 1 = affine (x, y);
// team: threads per lane, 2 or 8 (`pcurve.lane_team` chooses)
extern "C" int ez_scan_steps(int mixed, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                             uint32_t* ox, uint32_t* oy, uint32_t* oz, long long m, int steps,
                             int team, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (team != 2 && team != 8) return (int)cudaErrorInvalidValue;
  if (mixed && team == 2)
    launch_scan_steps<true, 2>(x, y, nullptr, ox, oy, oz, m, steps, s);
  else if (mixed)
    launch_scan_steps<true, 8>(x, y, nullptr, ox, oy, oz, m, steps, s);
  else if (team == 2)
    launch_scan_steps<false, 2>(x, y, z, ox, oy, oz, m, steps, s);
  else
    launch_scan_steps<false, 8>(x, y, z, ox, oy, oz, m, steps, s);
  return (int)cudaGetLastError();
}

// mixed as ez_scan_steps; team: threads per lane, 2 or 8
// (`pcurve.lane_team` chooses)
extern "C" int ez_fold_lanes(int mixed, const uint32_t* x, const uint32_t* y, const uint32_t* z,
                             uint32_t* ox, uint32_t* oy, uint32_t* oz, long long groups,
                             int chunks, int blk, int team, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (team != 2 && team != 8) return (int)cudaErrorInvalidValue;
  if (mixed && team == 2)
    launch_fold<true, 2>(x, y, nullptr, ox, oy, oz, groups, chunks, blk, s);
  else if (mixed)
    launch_fold<true, 8>(x, y, nullptr, ox, oy, oz, groups, chunks, blk, s);
  else if (team == 2)
    launch_fold<false, 2>(x, y, z, ox, oy, oz, groups, chunks, blk, s);
  else
    launch_fold<false, 8>(x, y, z, ox, oy, oz, groups, chunks, blk, s);
  return (int)cudaGetLastError();
}

extern "C" int ez_dbl_pow2(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                           uint32_t* oy, uint32_t* oz, long long n, int c, void* stream) {
  constexpr int kBlock = team_block<kDblTeam>();
  dbl_pow2_kernel<<<blocks_for(n, kBlock / kDblTeam), kBlock, 0, (cudaStream_t)stream>>>(
      x, y, z, ox, oy, oz, n, c);
  return (int)cudaGetLastError();
}

extern "C" int ez_horner(const uint32_t* vx, const uint32_t* vy, const uint32_t* vz,
                         uint32_t* ox, uint32_t* oy, uint32_t* oz, int windows, int c,
                         long long width, void* stream) {
  horner_kernel<<<(unsigned)width, kHornerTeam, 0, (cudaStream_t)stream>>>(vx, vy, vz, ox, oy, oz,
                                                                         windows, c, width);
  return (int)cudaGetLastError();
}
