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
// colors is padded by the caller to words * 32 entries; entries outside
// [0, n_col_pad) (phantoms are -1) count nowhere.
//
// What bounds it (ER(100k, 0.01): n_pad = 100,352, 3,200 words a row,
// n_col_pad = 1152, ~1e8 set bits):
//   - reading A: 1.28 GB, about 0.4 ms at the H100's 3.35 TB/s;
//   - writing NC: 0.46 GB;
//   - one gather of colors[col] (400 KB, resident in L2) and one
//     shared-memory atomic per set bit.
// The matrix-unit form would be n_pad^2 * n_col_pad ~ 1.16e13 int8 MACs,
// about 12 ms at the card's dense int8 peak, so at this density the
// sparse walk is bound by memory and atomics, far below the MAC form.
//
// Design: one warp per row, ROWS_PER_BLOCK rows per block.  Lanes read
// consecutive 16-byte groups of words (coalesced), walk the set bits of
// each word with __ffs / x &= x - 1, gather the neighbour's colour and
// count it into the row's histogram in shared memory with an integer
// atomic.  The histogram row is then written out whole, so the output
// needs no zero fill.  Integer atomics make the result exact and the same
// on every run.  Shared memory holds rows_per_block * n_col_pad ints; the
// wrapper picks rows_per_block so that fits the 227 KB a block may use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void count_word(
    uint32_t x, int word, const int* __restrict__ colors, int* hist,
    int n_col_pad) {
  const int base = (word >> 7) * 4096 + (word & 127);
  while (x) {
    const int b = __ffs(x) - 1;
    x &= x - 1;
    const int c = __ldg(colors + base + (b << 7));
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n_col_pad)) {
      atomicAdd(hist + c, 1);
    }
  }
}

__global__ void packed_nc_kernel(
    const uint32_t* __restrict__ packed, const int* __restrict__ colors,
    int* __restrict__ out, int n_rows, int words, int n_col_pad) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;  // uniform across the warp

  int* hist = reinterpret_cast<int*>(smem) + warp * n_col_pad;
  int4* hist4 = reinterpret_cast<int4*>(hist);
  const int n4 = n_col_pad >> 2;  // n_col_pad is a multiple of 128
  for (int c = lane; c < n4; c += 32) hist4[c] = make_int4(0, 0, 0, 0);
  __syncwarp();

  const uint4* src =
      reinterpret_cast<const uint4*>(packed + static_cast<size_t>(row) * words);
  const int q4 = words >> 2;  // words is a multiple of 128
  for (int q = lane; q < q4; q += 32) {
    const uint4 v = __ldg(src + q);
    const int w = q << 2;
    count_word(v.x, w, colors, hist, n_col_pad);
    count_word(v.y, w + 1, colors, hist, n_col_pad);
    count_word(v.z, w + 2, colors, hist, n_col_pad);
    count_word(v.w, w + 3, colors, hist, n_col_pad);
  }
  __syncwarp();

  int4* dst = reinterpret_cast<int4*>(out + static_cast<size_t>(row) * n_col_pad);
  for (int c = lane; c < n4; c += 32) dst[c] = hist4[c];
}

}  // namespace

extern "C" {

// Launches K1 on `stream`; returns cudaGetLastError() of the launch
// (0 on success).  Pointers are device pointers; out is [n_rows, n_col_pad].
int packed_nc_launch(const void* packed, const void* colors, void* out,
                     int n_rows, int words, int n_col_pad,
                     int rows_per_block, void* stream) {
  const size_t smem =
      static_cast<size_t>(rows_per_block) * n_col_pad * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_nc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  packed_nc_kernel<<<grid, 32 * rows_per_block, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int*>(colors),
      static_cast<int*>(out), n_rows, words, n_col_pad);
  return static_cast<int>(cudaGetLastError());
}

const char* packed_nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
