// Kernel K6: the bit-packed adjacency of the hash-defined G(n, p) and its
// degrees, built on the card from the graph's definition in one launch, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package generates the packed A in jnp
// ops (mcmc_colorer_tpu/ops/hashgen.py: er_packed_on_device, 32 bit-planes a
// band of rows); the port's plain version (ops/hashgen.py:_plain_band) does
// the same in ~28 int32 torch ops a bit-plane, each a pass of a band
// temporary through device memory, then a second pass over A for the
// degrees.  The words (ops/hashgen.py, ops/dense_adj.py):
//
//   word w of row i, bit b  =  column j = (w / 128) * 4096 + b * 128 + w % 128
//   edge(i, j) := mix32(seed, min(i, j), max(i, j)) < t,  i != j,  i, j < n,
//                 t = floor(p * 2**32)
//   mix32(s, lo, hi): h = (lo ^ s ^ GOLD) * C1; h ^= h >> 13;
//                     h = (h ^ hi) * C2; h ^= h >> 16; h *= C3; h ^= h >> 15
//
// all in uint32; 0 on the phantom rows i >= n and on the columns j >= n.
// A launch writes any window of rows [r0, r0 + rows): the whole A, a
// rank's strip or a band, and optionally each row's degree (the popcount of
// its words) beside them.
//
// What bounds it: the pair tests.  rows * words * 32 of them (1.03e10 for
// the whole A at ER(100,000, 0.01), n_pad 100,352, 3,200 words a row), each
// the part of mix32 that depends on both ends plus the compare (about 8
// int32 operations), against the words written once (1.28 GB there, 0.38 ms
// at 3.35 TB/s).  CUDA lists 64 integer add, logic, shift or multiply
// results a clock an SM for sm_90, about 1.7e13 a second on the H100 SXM:
// ~5 ms of tests, so the operations and not the bytes bound it.
//
// Design: one thread a word, its 32 tests unrolled into a register; the 128
// threads of a row's window write 512 contiguous bytes.  A block owns a tile
// of kRows rows across every window, two rows at a time, so each row's
// degree is summed in shared memory (a warp sum, then one shared add a warp)
// and written once: no global atomics, no memset, the same on every run.
// The first half of mix32 depends on the lower end alone: a row keeps
// low_half(i) in a register, and for each 4096-column window the block
// stages low_half(j) of the window's columns in shared memory (16 KB), only
// where some row of the tile lies above the window's first column.  A test
// then costs mix32's second half and the compare whichever end is lower.
// Whether a window lies all above a row, all below it, or holds its
// diagonal is decided once a (row, window), the same in every lane of a
// warp; the diagonal and the columns past n are masked once a word.  Each
// pair is tested from both of its rows (twice the least tests), so every
// word is its thread's own.  Row offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kC3 = 0x27D4EB2Fu;
constexpr int kLanes = 128;              // words a row a window
constexpr int kWindow = kLanes * 32;     // columns a window
constexpr int kThreads = 2 * kLanes;     // two rows of a window at a time
constexpr int kRows = 32;                // rows a block

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

// bit b: the test of (i, j0 + 128 b), j0 = the window's first column plus
// the lane; lh = the staged low halves plus the lane.  kWhere 0: every
// column above i; 1: every column below i; 2: the window holds i (its own
// bit is masked by the caller)
template <int kWhere>
__device__ __forceinline__ uint32_t word_bits(uint32_t i, uint32_t half_i, uint32_t j0,
                                              const uint32_t* lh, uint32_t t) {
  uint32_t bits = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t j = j0 + b * kLanes;
    uint32_t a;
    if (kWhere == 0) {
      a = half_i ^ j;
    } else if (kWhere == 1) {
      a = lh[b * kLanes] ^ i;
    } else {
      a = j < i ? lh[b * kLanes] ^ i : half_i ^ j;
    }
    bits |= static_cast<uint32_t>(is_edge(a, t)) << b;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
hash_packed_kernel(int r0, int rows, int n, int words, uint32_t seed_gold, uint32_t t,
                   int* __restrict__ out, int* __restrict__ degrees) {
  __shared__ uint32_t lh[kWindow];
  __shared__ int deg[kRows];
  const int lane = threadIdx.x % kLanes;   // the word within the window
  const int pair = threadIdx.x / kLanes;   // which of the two rows
  const int tile = blockIdx.x * kRows;     // the block's first row, within the launch
  const int tile_rows = min(kRows, rows - tile);
  const uint32_t un = static_cast<uint32_t>(n);
  // the tile's largest real vertex (-1: none)
  const int64_t last = static_cast<int64_t>(r0) + tile + tile_rows - 1;
  const int64_t i_max = last < n ? last : static_cast<int64_t>(n) - 1;
  if (static_cast<int>(threadIdx.x) < kRows) deg[threadIdx.x] = 0;
  __syncthreads();
  const int windows = words / kLanes;
  for (int win = 0; win < windows; ++win) {
    const uint32_t w0 = static_cast<uint32_t>(win) * kWindow;
    // a row of the tile lies above the window's first column: its tests of
    // the columns below it read their low halves from shared memory (the
    // same decision in every thread of the block)
    if (static_cast<int64_t>(w0) < i_max) {
      __syncthreads();  // the previous window's readers are done
      for (int k = threadIdx.x; k < kWindow; k += kThreads) lh[k] = low_half(w0 + k, seed_gold);
      __syncthreads();
    }
    for (int rr = pair; rr < tile_rows; rr += 2) {
      const uint32_t i = static_cast<uint32_t>(r0 + tile + rr);
      uint32_t word = 0;
      if (i < un && w0 < un) {
        const uint32_t j0 = w0 + lane;
        const uint32_t half_i = low_half(i, seed_gold);
        if (w0 > i) {
          word = word_bits<0>(i, half_i, j0, lh + lane, t);
        } else if (w0 + kWindow <= i) {
          word = word_bits<1>(i, half_i, j0, lh + lane, t);
        } else {
          word = word_bits<2>(i, half_i, j0, lh + lane, t);
          if ((i - w0) % kLanes == static_cast<uint32_t>(lane)) word &= ~(1u << ((i - w0) / kLanes));
        }
        if (w0 + kWindow > un) {  // the last window: the columns from n on are no vertices
          const uint32_t left = un > j0 ? (un - j0 + kLanes - 1) / kLanes : 0;
          word &= left >= 32 ? kFull : (1u << left) - 1u;
        }
      }
      if (out != nullptr) {
        out[static_cast<int64_t>(tile + rr) * words + win * kLanes + lane] =
            static_cast<int>(word);
      }
      if (degrees != nullptr) {
        const int c = __reduce_add_sync(kFull, __popc(word));  // a warp shares its row
        if ((threadIdx.x & 31) == 0) atomicAdd(&deg[rr], c);
      }
    }
  }
  if (degrees == nullptr) return;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < tile_rows) degrees[tile + threadIdx.x] = deg[threadIdx.x];
}

}  // namespace

extern "C" {

// Launches K6 on `stream`; returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for what it does not take: r0 < 0,
// rows < 1, n < 0, words not a positive multiple of 128, words * 32 < n
// (a vertex with no column), r0 + rows past 2**31 - 1, or neither output.
// out is [rows, words] int32, row k holding vertex r0 + k; degrees is
// [rows] int32; either may be null.  `seed` is the graph seed's low 32
// bits, `t` the threshold floor(p * 2**32).  Pointers are device pointers.
int hash_packed_launch(int r0, int rows, int n, int words, unsigned seed, unsigned t, void* out,
                       void* degrees, void* stream) {
  if (r0 < 0 || rows < 1 || n < 0 || words < kLanes || words % kLanes != 0 ||
      static_cast<int64_t>(words) * 32 < n ||
      static_cast<int64_t>(r0) + rows > 2147483647LL ||
      (out == nullptr && degrees == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (rows + kRows - 1) / kRows;
  const uint32_t seed_gold = static_cast<uint32_t>(seed) ^ kGold;
  hash_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r0, rows, n, words, seed_gold, t, static_cast<int*>(out), static_cast<int*>(degrees));
  return static_cast<int>(cudaGetLastError());
}

const char* hash_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
