// Kernel K3: masked first fit over gathered neighbour colours, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel mcmc_colorer_tpu/ops/pallas_firstfit.py
// (pallas_first_fit / _kernel / _kernel_chunked), with the neighbour
// gather that the JAX package leaves to XLA in front of it.  Per row r of
// a band of ELL rows:
//
//   out[r] = min { c < n_colors : c not in { ext[neighbors[r, k]] },
//                  allow[c], c != cur[r] }
//
// or -1 when no colour qualifies.  ext is colors with one sentinel slot of
// -1 appended: an id outside [0, n_ids) (the ELL's padding id n_pad)
// counts nowhere, and so does a colour outside [0, n_colors).  allow is
// packed to bits by the caller (bit c of word c / 32; bits past n_colors
// are 0), cur is [rows] int32 or null.
//
// What bounds it (config 3, ER(1M, 0.001): a band of 104,832 rows, d_pad
// 1280, ~1170 colours): reading the ids, 537 MB, 0.160 ms at the H100's
// 3.35 TB/s, and ~1.05e8 lookups of colors[id] into a 4 MB vector that
// stays in the 50 MB L2 but not in an SM's L1.  Each lookup is then an L2
// request for a sector of its own, and the card serves those at about
// 1e11 a second (torch's index_select gather of the same band runs at
// the same rate): ~1 ms a band.  Folded into 64 KB the same lookups hit
// L1 and the kernel takes about a third of that (PERF.md).
//
// Design: one warp per row, rows_per_block rows a block.  Each lane loads
// its ids two 16-byte vectors at a time with the streaming hint (evict
// first: the ids are read once, the colours stay in L2), then issues the
// eight colour lookups with __ldg before it uses any of them (a row whose
// d_pad is no multiple of 4 is read 8 single ids a lane at a time).  The
// occupancy bitmask of a row has `copies` interleaved copies of its
// n_words = ceil(n_colors / 32) words in shared memory, word w of copy j
// at w * copies + j; lane l sets its bits in copy l % copies, so lanes
// that share a word seldom meet in one atomicOr (a single mask put 32
// lanes on 37 words).  The scan ORs the copies of word w in lane w % 32,
// starting at copy l so the lanes read different banks, and keeps the
// ballot / __ffs search for ~occ & allow & ~cur_bit.  Wide palettes take
// fewer copies (down to one) so a row still fits: one design serves every
// palette whose bitmask fits the 232,448 bytes of shared memory a block
// may use.  All of it is integer work: the result is exact.
//
// The chain axis.  An ensemble's tailcut runs one first fit a chain over
// one shared ELL (JAX vmaps _tailcut_body, and so pallas_first_fit:
// parallel/chains.py:173-177 -> models/mcmc.py:1205).  Here the chain is
// the grid's y index: block (x, c) reads chain c's colours
// colors[c * n_ids, ...) and its cur[c * n_rows, ...) and writes
// out[c * n_rows, ...); neighbors and allow are shared.  C = 1 is the
// one-chain launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mark(uint32_t* occ_lane, int copies, int c,
                                     int n_colors) {
  if (static_cast<unsigned>(c) < static_cast<unsigned>(n_colors)) {
    atomicOr(occ_lane + (c >> 5) * copies, 1u << (c & 31));
  }
}

__device__ __forceinline__ int gather(const int* __restrict__ colors, int id,
                                      int n_ids) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(n_ids)
             ? __ldg(colors + id)
             : -1;
}

// VEC: d_pad % 4 == 0, so a row is whole 16-byte vectors
template <bool VEC, int UNROLL>
__global__ void first_fit_kernel(
    const int* __restrict__ neighbors, const int* __restrict__ colors,
    int n_ids, const uint32_t* __restrict__ allow_bits,
    const int* __restrict__ cur, int* __restrict__ out, int n_rows,
    int d_pad, int n_colors, int n_words, int copies) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;  // uniform across the warp
  const size_t chain = blockIdx.y;
  colors += chain * n_ids;
  if (cur != nullptr) cur += chain * n_rows;
  out += chain * n_rows;

  const int row_words = n_words * copies;
  uint32_t* occ = smem + static_cast<size_t>(warp) * row_words;
  for (int w = lane; w < row_words; w += 32) occ[w] = 0u;
  __syncwarp();

  uint32_t* occ_lane = occ + (lane & (copies - 1));
  const int* src = neighbors + static_cast<size_t>(row) * d_pad;
  if (VEC) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    const int q4 = d_pad >> 2;
    for (int q0 = 0; q0 < q4; q0 += 32 * UNROLL) {
      int4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = q0 + u * 32 + lane;
        v[u] = q < q4 ? __ldcs(src4 + q) : make_int4(-1, -1, -1, -1);
      }
      int c[4 * UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        c[4 * u + 0] = gather(colors, v[u].x, n_ids);
        c[4 * u + 1] = gather(colors, v[u].y, n_ids);
        c[4 * u + 2] = gather(colors, v[u].z, n_ids);
        c[4 * u + 3] = gather(colors, v[u].w, n_ids);
      }
#pragma unroll
      for (int i = 0; i < 4 * UNROLL; ++i) mark(occ_lane, copies, c[i], n_colors);
    }
  } else {
    for (int k0 = 0; k0 < d_pad; k0 += 32 * UNROLL) {
      int c[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + u * 32 + lane;
        c[u] = k < d_pad ? gather(colors, __ldcs(src + k), n_ids) : -1;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mark(occ_lane, copies, c[u], n_colors);
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
      uint32_t used = 0u;
      const uint32_t* word = occ + static_cast<size_t>(w) * copies;
      for (int j = 0; j < copies; ++j) used |= word[(j + lane) & (copies - 1)];
      cand = ~used & __ldg(allow_bits + w);
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

template <bool VEC, int UNROLL>
int launch(const void* neighbors, const void* colors, int n_ids,
           const void* allow_bits, const void* cur, void* out, int n_rows,
           int d_pad, int n_colors, int rows_per_block, int copies, int n_chains,
           cudaStream_t stream) {
  const int n_words = (n_colors + 31) / 32;
  const size_t smem = static_cast<size_t>(rows_per_block) * n_words * copies *
                      sizeof(uint32_t);
  auto kernel = first_fit_kernel<VEC, UNROLL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  kernel<<<dim3(grid, n_chains), 32 * rows_per_block, smem, stream>>>(
      static_cast<const int*>(neighbors), static_cast<const int*>(colors),
      n_ids, static_cast<const uint32_t*>(allow_bits),
      static_cast<const int*>(cur), static_cast<int*>(out), n_rows, d_pad,
      n_colors, n_words, copies);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3 on `stream`; returns cudaGetLastError() of the launch
// (0 on success), or cudaErrorInvalidValue for a `copies` that is not a
// power of two up to 32 or a chain count outside 1 to 65535.  Pointers
// are device pointers; cur may be null.  neighbors is [n_rows, d_pad],
// 16-byte aligned when d_pad % 4 == 0 (its rows are then read as 16-byte
// vectors); colors is [n_chains, n_ids]; cur and out are [n_chains,
// n_rows].
int first_fit_launch(const void* neighbors, const void* colors, int n_ids,
                     const void* allow_bits, const void* cur, void* out,
                     int n_rows, int d_pad, int n_colors, int rows_per_block,
                     int copies, int n_chains, void* stream) {
  if (copies < 1 || copies > 32 || (copies & (copies - 1)) != 0 || n_chains < 1 ||
      n_chains > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return (d_pad & 3) == 0
             ? launch<true, 2>(neighbors, colors, n_ids, allow_bits, cur, out, n_rows, d_pad,
                               n_colors, rows_per_block, copies, n_chains, s)
             : launch<false, 8>(neighbors, colors, n_ids, allow_bits, cur, out, n_rows, d_pad,
                                n_colors, rows_per_block, copies, n_chains, s);
}

const char* first_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
