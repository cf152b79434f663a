// Kernel K1: bit-packed neighbour-colour counts for Hopper (sm_90a).
//
// Replaces the Pallas kernel mcmc_colorer_tpu/ops/pallas_bitmatmul.py
// (packed_nc_pallas / _kernel), which unpacks the bit-packed adjacency to
// int8 tiles and runs int8 products on the TPU's matrix unit.  Same
// function, different form:
//
//   NC[i, c] = #{ j : A[i, j] = 1 and colors[j] = c },   0 <= c < n_col_pad
//
// A is [n_rows, words] uint32 in the packed_bit_coords order: column jl
// of each 4096-column window lives in word jl % 128 at bit jl / 128.
// colors16 is the caller's colour vector as uint16, one per packed column
// (words * 32), with 0xFFFF wherever the colour lies outside
// [0, n_col_pad): such columns count nowhere.
//
// What bounds it (ER(100k, 0.01): n_pad = 100,352, 3,200 words a row,
// n_col_pad = 1152, ~1e8 set bits): reading A, 1.285 GB, and writing NC,
// 0.462 GB: 0.521 ms at the H100's 3.35 TB/s.  Per set bit it looks up a
// colour and adds one to a histogram.  The first version of this kernel
// looked each colour up in device memory (400 KB of int32, past an SM's
// L1), one 16-byte load of A per lane, and ran at 41 % of the bound.
// The matrix-unit form would be n_pad^2 * n_col_pad ~ 1.16e13 int8 MACs,
// about 12 ms at the card's dense int8 peak.  What holds this design is
// measured with `mode` 1 and 2 (PERF.md): the stream and the
// staging alone take ~0.6 ms, the bit walk ~0.25 ms more, the histogram
// atomics the rest.
//
// Design: a block of rows_per_block (at most 8) warps, one warp per row,
// walks its rows window by window.  The window's 4096 colours (8 KB as
// uint16) are staged into shared memory with cp.async in a ring of three
// windows: window k + 2 is on its way while window k is counted, and one
// __syncthreads a window hands the ring over.  A lane's share of a
// window is one 16-byte vector of A (4 words), loaded kPrefetch windows
// ahead with the streaming hint.  The lane pops one set bit a step, looks
// its colour up in shared memory and adds it into the row's histogram in
// shared memory with an integer atomic.  The histogram holds 16-bit
// counts, two to a word, so a block's shared memory is small (42 KB at
// 1152 colours) and five blocks fit an SM (registers capped to match):
// the walk is a chain of dependent shared-memory operations, and more
// warps an SM hide more of it.  A count reaches 2**16 only in a row of
// 2**16 set bits or more: such a row (the warp sums its bits) is counted
// again from device memory with 32-bit atomics on the output.  The
// histogram is written out whole as int32 with 16-byte streaming stores,
// so the output needs no zero fill.  Integer atomics make the result
// exact and the same on every run.  The wrapper picks rows_per_block so
// that the ring and the histograms fit the 227 KB a block may use.
//
// The chain axis.  An ensemble's chains share one A (JAX vmaps the
// packed-NC product over them: models/mcmc_resident.py:287,303,311,
// parallel/chains.py:105-143).  Here the chain is the grid's y index:
// block (x, c) counts chain c's colours colors16[c * words * 32, ...)
// into out[c * n_rows * n_col_pad, ...).  Each chain's blocks read A
// again (C reads of A a launch): streaming A once for all chains is later
// work.  C = 1 is the one-chain launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindowCols = 4096;  // 128 words of 32 bits
constexpr int kWindowBytes = kWindowCols * static_cast<int>(sizeof(uint16_t));
constexpr int kDepth = 2;          // windows of colours staged ahead
constexpr int kRing = kDepth + 1;
constexpr int kPrefetch = 2;       // windows of A in flight per lane
constexpr int kMaxRows = 8;        // rows (warps) a block at most
constexpr int kMinBlocks = 5;      // blocks an SM: registers capped at 51

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy window k's 4096 colours (8 KB) into `dst`, 16 bytes a thread
__device__ __forceinline__ void stage_window(uint16_t* dst,
                                             const uint16_t* __restrict__ colors16,
                                             int k) {
  const uint16_t* src = colors16 + static_cast<size_t>(k) * kWindowCols;
  for (int i = threadIdx.x; i < kWindowCols / 8; i += blockDim.x) {
    cp_async16(dst + 8 * i, src + 8 * i);
  }
}

// one more neighbour of colour c: count c lives in half c & 1 of word c / 2
__device__ __forceinline__ void count(unsigned c, uint32_t* hist, int n_col_pad) {
  if (c < static_cast<unsigned>(n_col_pad)) atomicAdd(hist + (c >> 1), 1u << ((c & 1) << 4));
}

// The set bits of a lane's four words of one window, one bit a step: the
// lowest bit of the first word that has one.  Word t of the lane is
// window word 4 * lane + t, and bit b of window word w is column
// b * 128 + w of the window.  (Popping one bit of each of the four words
// a step issued four lookups and four atomics a step, most of them on idle
// lanes at ~0.3 set bits a word; a warp-wide list of the bits, filled
// through a warp scan, was no faster.)  MODE 2 looks the colours up and
// sums them instead of counting them (a measurement).
template <int MODE>
__device__ __forceinline__ void count_window(uint4 v, const uint16_t* win, int lane,
                                             uint32_t* hist, int n_col_pad,
                                             unsigned& sink) {
  const uint16_t* base = win + 4 * lane;
  uint32_t x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
  while (x0 | x1 | x2 | x3) {
    const int t = x0 ? 0 : (x1 ? 1 : (x2 ? 2 : 3));
    const uint32_t x = x0 ? x0 : (x1 ? x1 : (x2 ? x2 : x3));
    const unsigned c = base[((__ffs(x) - 1) << 7) + t];
    if (t == 0) x0 &= x0 - 1;
    else if (t == 1) x1 &= x1 - 1;
    else if (t == 2) x2 &= x2 - 1;
    else x3 &= x3 - 1;
    if (MODE == 2) sink += c;
    else count(c, hist, n_col_pad);
  }
}

// a row with 2**16 set bits or more, counted from device memory into its
// output row with 32-bit atomics
__device__ void count_row_wide(const uint4* __restrict__ src, int words,
                               const uint16_t* __restrict__ colors16, int* dst,
                               int n_col_pad, int lane) {
  for (int c = lane; c < n_col_pad; c += 32) dst[c] = 0;
  __syncwarp();
  for (int q = lane; q < (words >> 2); q += 32) {
    const uint4 v = __ldg(src + q);
    const uint32_t xs[4] = {v.x, v.y, v.z, v.w};
    for (int t = 0; t < 4; ++t) {
      const int w = 4 * q + t;
      const int base = (w >> 7) * kWindowCols + (w & 127);
      for (uint32_t x = xs[t]; x; x &= x - 1) {
        const unsigned c = __ldg(colors16 + base + ((__ffs(x) - 1) << 7));
        if (c < static_cast<unsigned>(n_col_pad)) atomicAdd(dst + c, 1);
      }
    }
  }
}

// MODE 0 counts; 1 (only streams A and stages colours) and 2 (also walks
// the bits and looks the colours up, without counting) are measurements
// of what the count costs, and write no defined output
template <int MODE>
__global__ void __launch_bounds__(32 * kMaxRows, kMinBlocks)
    packed_nc_kernel(const uint4* __restrict__ packed, const uint16_t* __restrict__ colors16,
                     int* __restrict__ out, int n_rows, int words, int n_col_pad) {
  extern __shared__ int4 smem[];
  colors16 += static_cast<size_t>(blockIdx.y) * words * 32;
  out += static_cast<size_t>(blockIdx.y) * n_rows * n_col_pad;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  // a warp past the last row still stages colours and meets every barrier
  const bool active = row < n_rows;

  const int hist_words = n_col_pad >> 1;  // two 16-bit counts a word
  uint32_t* hist =
      reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(smem) + kRing * kWindowBytes) +
      static_cast<size_t>(warp) * hist_words;
  for (int c = lane; c < (hist_words >> 2); c += 32) {
    reinterpret_cast<uint4*>(hist)[c] = make_uint4(0, 0, 0, 0);  // n_col_pad % 128 == 0
  }

  const int n_win = words >> 7;  // words is a multiple of 128
  // this lane's vector of window k is src[32 * k]
  const uint4* row_src = packed + static_cast<size_t>(active ? row : 0) * (words >> 2);
  const uint4* src = row_src + lane;
  // one copy group per window, empty past the last, so that "all but the
  // newest kDepth groups done" always means "window k + 1 has landed"
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    if (k < n_win) stage_window(ring + k * kWindowCols, colors16, k);
    cp_async_commit();
  }
  uint4 a[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    a[i] = (active && i < n_win) ? __ldcs(src + 32 * i) : make_uint4(0, 0, 0, 0);
  }
  cp_async_wait<kDepth - 1>();
  __syncthreads();

  unsigned bits = 0, sink = 0;
  for (int k0 = 0; k0 < n_win; k0 += kPrefetch) {
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int k = k0 + i;
      if (k >= n_win) break;  // uniform across the block
      if (k + kDepth < n_win) {
        stage_window(ring + ((k + kDepth) % kRing) * kWindowCols, colors16, k + kDepth);
      }
      cp_async_commit();
      const uint4 v = a[i];
      if (active && k + kPrefetch < n_win) a[i] = __ldcs(src + 32 * (k + kPrefetch));
      bits += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      if (MODE != 1) {
        count_window<MODE>(v, ring + (k % kRing) * kWindowCols, lane, hist, n_col_pad, sink);
      }
      cp_async_wait<kDepth - 1>();  // window k + 1 has landed
      __syncthreads();              // for every thread, and window k is free again
    }
  }

  if (!active) return;
  int* dst_row = out + static_cast<size_t>(row) * n_col_pad;
  if (MODE != 0) {
    if (lane == 0) dst_row[0] = static_cast<int>(bits + sink);  // keeps the work live
    return;
  }
  if (__reduce_add_sync(0xffffffffu, bits) >= (1u << 16)) {  // uniform across the warp
    count_row_wide(row_src, words, colors16, dst_row, n_col_pad, lane);
    return;
  }
  int4* dst = reinterpret_cast<int4*>(dst_row);
  const uint2* h2 = reinterpret_cast<const uint2*>(hist);
  for (int c = lane; c < (n_col_pad >> 2); c += 32) {
    const uint2 h = h2[c];
    __stcs(dst + c, make_int4(static_cast<int>(h.x & 0xFFFFu), static_cast<int>(h.x >> 16),
                              static_cast<int>(h.y & 0xFFFFu), static_cast<int>(h.y >> 16)));
  }
}

template <int MODE>
int launch(const void* packed, const void* colors16, void* out, int n_rows,
           int words, int n_col_pad, int rows_per_block, int n_chains, cudaStream_t stream) {
  const size_t smem = kRing * kWindowBytes +
                      static_cast<size_t>(rows_per_block) * n_col_pad * sizeof(uint16_t);
  if (rows_per_block > kMaxRows || n_chains < 1 || n_chains > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = packed_nc_kernel<MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  kernel<<<dim3(grid, n_chains), 32 * rows_per_block, smem, stream>>>(
      static_cast<const uint4*>(packed), static_cast<const uint16_t*>(colors16),
      static_cast<int*>(out), n_rows, words, n_col_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K1 on `stream`; returns cudaGetLastError() of the launch
// (0 on success), or cudaErrorInvalidValue for a `mode` other than 0, 1
// or 2, more than kMaxRows rows a block, or a chain count outside 1 to
// 65535.  Pointers are device pointers, 16-byte aligned; out is
// [n_chains, n_rows, n_col_pad], colors16 [n_chains, words * 32].  mode 0
// is K1; 1 and 2 are the measurements described at packed_nc_kernel.
int packed_nc_launch(const void* packed, const void* colors16, void* out,
                     int n_rows, int words, int n_col_pad, int rows_per_block,
                     int n_chains, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define K1_ARGS packed, colors16, out, n_rows, words, n_col_pad, rows_per_block, n_chains, s
  switch (mode) {
    case 0: return launch<0>(K1_ARGS);
    case 1: return launch<1>(K1_ARGS);
    case 2: return launch<2>(K1_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_ARGS
}

const char* packed_nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
