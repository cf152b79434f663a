// Kernel K3: masked first fit for Hopper (sm_90a).
//
// Replaces the Pallas kernel mcmc_colorer_tpu/ops/pallas_firstfit.py
// (pallas_first_fit / _kernel / _kernel_chunked).  Per row r:
//
//   out[r] = min { c < n_colors : no nc[r, k] == c, allow[c], c != cur[r] }
//
// or -1 when no colour qualifies.  nc is [rows, d_pad] int32 neighbour
// colours (-1 = padding; anything outside [0, n_colors) counts nowhere),
// allow is packed to bits by the caller (bit c of word c / 32; bits past
// n_colors are 0), cur is [rows] int32 or null.
//
// What bounds it (config 3, ER(1M, 0.001): ~1M rows, d_pad 1280, ~1170
// colours): reading nc, 5.2 GB, about 1.6 ms at the H100's 3.35 TB/s.
// The per-row work is one shared-memory atomicOr per neighbour and a
// scan of ceil(n_colors / 32) words, both far below the read.
//
// Design: one warp per row, rows_per_block rows per block.  Each row
// owns an occupancy bitmask of n_words = ceil(n_colors / 32) words in
// shared memory.  Lanes read the row's nc coalesced and set bits with
// atomicOr; after __syncwarp, lane l scans words l, l + 32, ... for
// ~occ & allow & ~cur_bit, and a warp ballot with __ffs picks the first
// word that has a candidate, whose lowest set bit is the answer.  The
// TPU kernel walked palettes above 3072 colours in 1024-colour chunks to
// bound VMEM; here one design serves every palette whose bitmask fits
// the 232,448 bytes of shared memory a block may use (1,859,584
// colours for one row a block); the wrapper picks rows_per_block and
// refuses wider palettes.  All of it is integer work: the result is
// exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void first_fit_kernel(
    const int* __restrict__ nc, const uint32_t* __restrict__ allow_bits,
    const int* __restrict__ cur, int* __restrict__ out, int n_rows,
    int d_pad, int n_colors, int n_words) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;  // uniform across the warp

  uint32_t* occ = smem + static_cast<size_t>(warp) * n_words;
  for (int w = lane; w < n_words; w += 32) occ[w] = 0u;
  __syncwarp();

  const int* src = nc + static_cast<size_t>(row) * d_pad;
  for (int k = lane; k < d_pad; k += 32) {
    const int c = __ldg(src + k);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n_colors)) {
      atomicOr(occ + (c >> 5), 1u << (c & 31));
    }
  }
  __syncwarp();

  const int own = cur != nullptr ? __ldg(cur + row) : -1;
  const bool own_ok = static_cast<unsigned>(own) < static_cast<unsigned>(n_colors);
  int result = -1;
  for (int w0 = 0; w0 < n_words; w0 += 32) {
    const int w = w0 + lane;
    uint32_t cand = 0u;
    if (w < n_words) {
      cand = ~occ[w] & __ldg(allow_bits + w);
      if (own_ok && (own >> 5) == w) cand &= ~(1u << (own & 31));
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cand != 0u);
    if (ballot != 0u) {
      const int src_lane = __ffs(ballot) - 1;
      const uint32_t word = __shfl_sync(0xffffffffu, cand, src_lane);
      result = (w0 + src_lane) * 32 + (__ffs(word) - 1);
      break;
    }
  }
  if (lane == 0) out[row] = result;
}

}  // namespace

extern "C" {

// Launches K3 on `stream`; returns cudaGetLastError() of the launch
// (0 on success).  Pointers are device pointers; cur may be null.
int first_fit_launch(const void* nc, const void* allow_bits, const void* cur,
                     void* out, int n_rows, int d_pad, int n_colors,
                     int rows_per_block, void* stream) {
  const int n_words = (n_colors + 31) / 32;
  const size_t smem =
      static_cast<size_t>(rows_per_block) * n_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        first_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  first_fit_kernel<<<grid, 32 * rows_per_block, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nc), static_cast<const uint32_t*>(allow_bits),
      static_cast<const int*>(cur), static_cast<int*>(out), n_rows, d_pad,
      n_colors, n_words);
  return static_cast<int>(cudaGetLastError());
}

const char* first_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
