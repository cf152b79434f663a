// Kernel K5: the ELL rows of the hash-defined G(n, p), built on the card
// from the graph's definition, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package generates the same graph
// only as a bit-packed adjacency (mcmc_colorer_tpu/ops/hashgen.py) and
// lays an ELL out from a host CSR; at ER(10^6, 0.001) the packed A is
// about 125 GB and host sampling takes tens of seconds, so the port
// writes the neighbour lists directly.  The graph (ops/hashgen.py):
//
//   edge(i, j) := mix32(seed, min(i, j), max(i, j)) < t,  i != j,
//                 t = floor(p * 2**32)
//   mix32(s, lo, hi): h = (lo ^ s ^ GOLD) * C1; h ^= h >> 13;
//                     h = (h ^ hi) * C2; h ^= h >> 16; h *= C3; h ^= h >> 15
//
// all in uint32.  Two passes test the same pairs in the same order:
//
//   count (neighbors null): degrees[i] = |{ j < n : edge(i, j) }|, and 0
//                           on the phantom rows n <= i < n_pad;
//   fill:  neighbors[i, 0 .. deg) = those j in ascending order, then the
//          sentinel n_pad up to d_pad; phantom rows hold n_pad throughout.
//          A row whose fill finds another count than degrees[i], or more
//          ids than d_pad, sets *status (no slot past d_pad is written),
//          so a row is never cut short without the caller knowing.
//
// What bounds it: the pair tests.  n(n - 1) / 2 pairs, each the part of
// mix32 that depends on both ends plus the compare (8 int32 operations):
// 4e12 at n = 10^6, against 4.6 GB of ELL written once (1.4 ms at 3.35
// TB/s).  CUDA lists 64 integer add, logic, shift or multiply results a
// clock an SM for sm_90: about 1.7e13 a second on the H100 SXM.
//
// Design: one warp a row, 8 rows a block, no shared memory.  Lane l tests
// the 8 consecutive ids [s + 8 l, s + 8 l + 8) of a step s, the warp 256
// ids a step, and folds them into an 8-bit mask.  Where j > i the first
// half of mix32 depends on i alone and is computed once a row; where
// j < i it is computed a pair.  Both passes test every pair from both of
// its rows (n² tests a pass): a row's ids are then its own to order, with
// no atomics and no sort.  The count pass adds the masks' popcounts, then
// one warp sum.  In the fill pass a step where any lane has a bit (about
// one in four at p = 0.001) takes an inclusive warp scan (shuffles) of
// the lanes' popcounts, and each lane writes its ids at the row's running
// count plus the lanes before it: the row comes out ascending, exact and
// the same on every run.  Row offsets are 64-bit (n_pad * d_pad is about
// 1.15e9 at n = 10^6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kC3 = 0x27D4EB2Fu;
constexpr int kPerLane = 8;               // consecutive ids a lane tests a step
constexpr int kStep = 32 * kPerLane;      // ids a warp tests a step
constexpr int kWarps = 8;                 // rows a block

// the first half of mix32: the part that depends on the lower end alone
__device__ __forceinline__ uint32_t low_half(uint32_t lo, uint32_t seed_gold) {
  const uint32_t h = (lo ^ seed_gold) * kC1;
  return h ^ (h >> 13);
}

// the rest of mix32 and the compare, from low_half(lo) ^ hi
__device__ __forceinline__ bool is_edge(uint32_t a, uint32_t t) {
  uint32_t h = a * kC2;
  h ^= h >> 16;
  h *= kC3;
  h ^= h >> 15;
  return h < t;
}

// bit k: edge(i, j0 + k).  kWhere 0: every id below i; 1: every id above
// i; 2: the step that holds i
template <int kWhere>
__device__ __forceinline__ uint32_t lane_bits(uint32_t i, uint32_t half_i, uint32_t j0,
                                              uint32_t seed_gold, uint32_t t) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const uint32_t j = j0 + k;
    bool e;
    if (kWhere == 0) {
      e = is_edge(low_half(j, seed_gold) ^ i, t);
    } else if (kWhere == 1) {
      e = is_edge(half_i ^ j, t);
    } else {
      e = j != i && is_edge(j < i ? low_half(j, seed_gold) ^ i : half_i ^ j, t);
    }
    bits |= static_cast<uint32_t>(e) << k;
  }
  return bits;
}

template <bool kFill>
__global__ void __launch_bounds__(kWarps * 32)
hash_ell_kernel(int n, int n_pad, int d_pad, uint32_t seed_gold, uint32_t t,
                int* __restrict__ degrees, int* __restrict__ neighbors,
                int* __restrict__ status) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_pad) return;  // a whole warp
  int* out = kFill ? neighbors + static_cast<int64_t>(row) * d_pad : nullptr;
  // count pass: this lane's hits; fill pass: the row's so far, in every lane
  int count = 0;
  if (row < n) {
    const uint32_t i = static_cast<uint32_t>(row);
    const uint32_t half_i = low_half(i, seed_gold);
    const uint32_t i_step = i / kStep * kStep;
    const uint32_t un = static_cast<uint32_t>(n);
    for (uint32_t s = 0; s < un; s += kStep) {
      const uint32_t j0 = s + lane * kPerLane;
      uint32_t bits = s < i_step   ? lane_bits<0>(i, half_i, j0, seed_gold, t)
                      : s > i_step ? lane_bits<1>(i, half_i, j0, seed_gold, t)
                                   : lane_bits<2>(i, half_i, j0, seed_gold, t);
      if (s + kStep > un) {  // the last step: the ids from n on are no vertices
        const int left = n - static_cast<int>(j0);
        bits &= left >= kPerLane ? 0xffu : (left <= 0 ? 0u : (1u << left) - 1u);
      }
      if (!kFill) {
        count += __popc(bits);
        continue;
      }
      if (!__any_sync(kFull, bits)) continue;
      const int c = __popc(bits);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      int pos = count + incl - c;
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        if (pos < d_pad) out[pos] = static_cast<int>(j0) + k;
        ++pos;
      }
      count += __shfl_sync(kFull, incl, 31);
    }
  }
  if (!kFill) {
    count = __reduce_add_sync(kFull, count);
    if (lane == 0) degrees[row] = count;
    return;
  }
  if (lane == 0 && (count != degrees[row] || count > d_pad)) atomicOr(status, 1);
  for (int k = count + lane; k < d_pad; k += 32) out[k] = n_pad;
}

}  // namespace

extern "C" {

// Launches K5 on `stream`; returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for sizes it does not take: n < 0,
// n_pad < max(n, 1), or a fill with d_pad < 1.  degrees is [n_pad] int32:
// written by the count pass (neighbors null), read by the fill pass,
// which writes neighbors [n_pad, d_pad] int32 and ORs 1 into *status
// (int32, zeroed by the caller) where a row's fill disagrees with its
// degree or does not fit d_pad.  `seed` is the graph seed's low 32 bits,
// `t` the threshold floor(p * 2**32).  Pointers are device pointers.
int hash_ell_launch(int n, int n_pad, int d_pad, unsigned seed, unsigned t, void* degrees,
                    void* neighbors, void* status, void* stream) {
  const bool fill = neighbors != nullptr;
  if (n < 0 || n_pad < 1 || n_pad < n || (fill && (d_pad < 1 || status == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n_pad + kWarps - 1) / kWarps;
  const uint32_t seed_gold = static_cast<uint32_t>(seed) ^ kGold;
  auto s = static_cast<cudaStream_t>(stream);
  if (fill) {
    hash_ell_kernel<true><<<grid, kWarps * 32, 0, s>>>(
        n, n_pad, d_pad, seed_gold, t, static_cast<int*>(degrees),
        static_cast<int*>(neighbors), static_cast<int*>(status));
  } else {
    hash_ell_kernel<false><<<grid, kWarps * 32, 0, s>>>(
        n, n_pad, 0, seed_gold, t, static_cast<int*>(degrees), nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hash_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
