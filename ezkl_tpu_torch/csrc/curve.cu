// Point kernels of the port: K3 (complete projective add, and its tree form)
// and K9 (doubling) over BN254 G1, y^2 = x^3 + 3, projective (X:Y:Z) with
// identity (0:1:0).
//
// K3 ez_point_add replaces the TPU kernel `_add_call` of
// ezkl_tpu/kernels/pcurve.py (entry `add`); ez_point_reduce is K3 run as the
// halving tree of `reduce_pairwise` (pcurve.py:523), which the TPU ran as one
// `_add_call` per level. K9 ez_point_dbl replaces `_dbl_call` (entry `dbl`).
// Same formulas and schedule (RCB15 algorithms 7 and 9, a = 0, b3 = 9), the
// same lazy < 2p residues inside, canonical stores, so the projective outputs
// equal `ezkl_tpu.fieldmath.curve.add/dbl` bit for bit.
//
// Bound on the H100: compute. An add reads 6 x 32 and writes 3 x 32 bytes per
// lane but runs 12 Montgomery products (12 x 264 32-bit multiply-adds) plus
// ~26 lazy adds; a doubling runs 8 products over 6 x 32 bytes. K9 runs at
// 2^k lanes in `gen_srs` (2^14 at k = 14) and at 26 and 1 lanes in the
// unfused MSM's doublings: there the card idles and a doubling's chain of
// 8 products sets the time. So K9 runs `team_dbl_lane` (bn254.cuh, shared
// with K7) on a team of 4 threads per lane up to 2^13 lanes (one warp a
// block) and of 2 above (blocks of 128), picked by `pcurve.dbl_team` from
// the H100 sweep (PERF.md). The fused MSM launches K3
// at 26 to ~10^5 lanes, one add deep, where one thread's chain of 12
// dependent products, not the arithmetic, sets the time: the add runs on a
// team of threads (bn254.cuh, "teams": each level of independent products
// side by side on the carry flag), 8 threads a lane in blocks of 32 up to
// 4,096 lanes and 2 in blocks of 128 above, as K4 and K5
// (`pcurve.point_add_team`). One thread per lane lost to one of the two at
// every width the prove launches (H100 sweep, PERF.md).
//
// ez_point_reduce sums w partials per group by log2(w) halving levels -- lane
// j plus lane j + half, the first half the left operand, as `reduce_pairwise`
// pairs them, so the projective words are the same -- in one launch instead
// of one per level, which also drops the host's slices and copies between
// levels. One block per group holds the group's partials in shared memory
// (word-major, 24 KB at w = 256); each level's adds run on the block's teams
// of 8 with a block barrier between levels.

#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

namespace {

// ez_point_reduce: partials per group held in shared memory, and the teams
// of 8 that run each level's adds, 32 to a block
constexpr int kTreeMax = 256;
constexpr int kTreeTeam = 8;
constexpr int kTreeThreads = 256;
constexpr int kTreeTeams = kTreeThreads / kTreeTeam;

template <int T>
__global__ void __launch_bounds__(team_block<T>())
    point_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                     const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                     const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                     uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                     uint32_t* __restrict__ oz, long long n) {
  constexpr int kTeams = team_block<T>() / T;
  __shared__ TeamSlots<T, kTeams> slots;
  const long long j = (long long)blockIdx.x * kTeams + threadIdx.x / T;
  if (j >= n) return;  // the whole team: j is the same in its threads
  const Team<T> tm = make_team(slots);
  Fe X3, Y3, Z3;
  team_complete_add<Fq>(tm, load(x1, n, j), load(y1, n, j), load(z1, n, j), load(x2, n, j),
                        load(y2, n, j), load(z2, n, j), X3, Y3, Z3);
  team_store(tm, ox, n, j, reduce_cc<Fq>(X3));
  team_store(tm, oy, n, j, reduce_cc<Fq>(Y3));
  team_store(tm, oz, n, j, reduce_cc<Fq>(Z3));
}

__device__ __forceinline__ Fe load_tile(const uint32_t (&t)[8][kTreeMax], int j) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i][j];
  return r;
}

// (8, groups, w) -> (8, groups), w a power of two <= kTreeMax; block g sums
// group g. Level by level (half = w/2, w/4, .., 1), team t runs the adds
// a = t, t + 32, .. < half: lane a = lane a + lane a + half. Within a level
// an add writes only its own left lane, which no other add reads; a team
// with no add left idles to the level's block barrier (its team barriers
// are its own).
__global__ void __launch_bounds__(kTreeThreads)
    point_reduce_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                        const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                        uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                        long long groups, int w) {
  __shared__ uint32_t sx[8][kTreeMax], sy[8][kTreeMax], sz[8][kTreeMax];
  __shared__ TeamSlots<kTreeTeam, kTreeTeams> slots;
  const long long g = blockIdx.x, n = groups * w;
  for (int t = threadIdx.x; t < w; t += kTreeThreads) {
    const long long e = g * w + t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sx[i][t] = x[i * n + e];
      sy[i][t] = y[i * n + e];
      sz[i][t] = z[i * n + e];
    }
  }
  __syncthreads();
  const Team<kTreeTeam> tm = make_team(slots);
  for (int half = w / 2; half >= 1; half /= 2) {
    for (int a = threadIdx.x / kTreeTeam; a < half; a += kTreeTeams) {
      const int b = a + half;
      Fe X3, Y3, Z3;
      team_complete_add<Fq>(tm, load_tile(sx, a), load_tile(sy, a), load_tile(sz, a),
                            load_tile(sx, b), load_tile(sy, b), load_tile(sz, b), X3, Y3, Z3);
      team_store(tm, &sx[0][0], kTreeMax, a, reduce_cc<Fq>(X3));
      team_store(tm, &sy[0][0], kTreeMax, a, reduce_cc<Fq>(Y3));
      team_store(tm, &sz[0][0], kTreeMax, a, reduce_cc<Fq>(Z3));
    }
    __syncthreads();
  }
  if (threadIdx.x < 8) {
    const int i = threadIdx.x;
    ox[i * groups + g] = sx[i][0];
    oy[i * groups + g] = sy[i][0];
    oz[i * groups + g] = sz[i][0];
  }
}

// K9: one doubling per lane of (8, n), a team of T threads per lane,
// team_block<T>() / T lanes per block.
template <int T>
__global__ void __launch_bounds__(team_block<T>())
    point_dbl_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                     uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n) {
  constexpr int kTeams = team_block<T>() / T;
  __shared__ TeamSlots<T, kTeams> slots;
  const long long j = (long long)blockIdx.x * kTeams + threadIdx.x / T;
  if (j >= n) return;  // the whole team: j is the same in its threads
  team_dbl_lane(make_team(slots), x, y, z, ox, oy, oz, n, j, 1);
}

inline unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

template <int T>
void launch_dbl(const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                uint32_t* oy, uint32_t* oz, long long n, cudaStream_t s) {
  point_dbl_kernel<T><<<blocks_for(n, team_block<T>() / T), team_block<T>(), 0, s>>>(
      x, y, z, ox, oy, oz, n);
}

template <int T>
void launch_add(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1, const uint32_t* x2,
                const uint32_t* y2, const uint32_t* z2, uint32_t* ox, uint32_t* oy,
                uint32_t* oz, long long n, cudaStream_t s) {
  point_add_kernel<T><<<blocks_for(n, team_block<T>() / T), team_block<T>(), 0, s>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
}

}  // namespace

// team: threads per lane, 2 or 8 (`pcurve.point_add_team` chooses)
extern "C" int ez_point_add(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                            const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n, int team,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (team == 2)
    launch_add<2>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, s);
  else if (team == 8)
    launch_add<8>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// (8, groups, w) partials -> (8, groups) sums; w a power of two, 2 <= w <= 256
extern "C" int ez_point_reduce(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz, long long groups, int w,
                               void* stream) {
  if (w < 2 || w > kTreeMax || (w & (w - 1)) || groups < 1) return (int)cudaErrorInvalidValue;
  point_reduce_kernel<<<(unsigned)groups, kTreeThreads, 0, (cudaStream_t)stream>>>(
      x, y, z, ox, oy, oz, groups, w);
  return (int)cudaGetLastError();
}

// team: threads per lane, 2 or 4 (`pcurve.dbl_team` chooses)
extern "C" int ez_point_dbl(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n, int team,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (team == 2)
    launch_dbl<2>(x, y, z, ox, oy, oz, n, s);
  else if (team == 4)
    launch_dbl<4>(x, y, z, ox, oy, oz, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
