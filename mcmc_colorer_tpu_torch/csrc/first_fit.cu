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
//
// The tailcut instance (TAILCUT = true, first_fit_tailcut_launch).  A
// round of the ELL tailcut needs, besides each row's first fit over every
// colour, whether some neighbour holds the row's own colour (flag) and
// each chain's count of such pairs towards a higher id (the conflict
// edges of the colouring the round starts from).  Both come from the
// colours the warp looks up for the occupancy mask anyway, so the round
// reads its ids once: each lane compares its looked-up colours with the
// row's own, colors[c, row0 + row], the warp ORs the flags and sums the
// counts (__reduce_add_sync), and lane 0 adds a non-zero sum to count[c]
// with one atomic.  The rows are ids row0 .. row0 + n_rows - 1 of the
// colour vector (a flat ELL at row0 = 0, or one rectangle of the
// degree-bucketed layout), so out and flag are [n_chains, n_ids] and
// written at row0 + row; cur and allow_bits are not read: every colour
// below n_colors is allowed.  The greedy instance (TAILCUT = false)
// compiles to the code it had before (the same registers).
//
// lower_movable_kernel: the round's second pass.  lower[c, v] = movable[c,
// v] and some neighbour u < v has movable[c, u].  A warp takes 32
// consecutive rows, reads their 32 movable bytes in one ballot and scans
// the ids of the movable rows only (after the chain they are few), each
// with the whole warp, stopping at the first movable lower neighbour;
// lane l then writes row l's answer.

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

// the tailcut's test of one looked-up colour c of neighbour id against
// the row's own colour
__device__ __forceinline__ void same_color(int c, int id, int own, int vid, bool& hit,
                                           int& cnt) {
  if (c == own) {
    hit = true;
    cnt += id > vid;
  }
}

// VEC: d_pad % 4 == 0, so a row is whole 16-byte vectors.  TAILCUT: the
// tailcut instance (the header): flag and count beside the first fit.
template <bool VEC, int UNROLL, bool TAILCUT>
__global__ void first_fit_kernel(
    const int* __restrict__ neighbors, const int* __restrict__ colors,
    int n_ids, const uint32_t* __restrict__ allow_bits,
    const int* __restrict__ cur, int* __restrict__ out, int n_rows,
    int d_pad, int n_colors, int n_words, int copies, int row0,
    uint8_t* __restrict__ flag, unsigned long long* __restrict__ count) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;  // uniform across the warp
  const size_t chain = blockIdx.y;
  colors += chain * n_ids;
  int own = -1, vid = 0, cnt = 0;  // the tailcut's: own colour, id, count
  bool hit = false;
  if constexpr (TAILCUT) {
    vid = row0 + row;
    own = __ldg(colors + vid);
    out += chain * n_ids + row0;
    flag += chain * n_ids + row0;
  } else {
    if (cur != nullptr) cur += chain * n_rows;
    out += chain * n_rows;
  }

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
      if constexpr (TAILCUT) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (q0 + u * 32 + lane < q4) {
            same_color(c[4 * u + 0], v[u].x, own, vid, hit, cnt);
            same_color(c[4 * u + 1], v[u].y, own, vid, hit, cnt);
            same_color(c[4 * u + 2], v[u].z, own, vid, hit, cnt);
            same_color(c[4 * u + 3], v[u].w, own, vid, hit, cnt);
          }
        }
      }
    }
  } else {
    for (int k0 = 0; k0 < d_pad; k0 += 32 * UNROLL) {
      int c[UNROLL];
      int id[UNROLL];  // the tailcut's
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + u * 32 + lane;
        if constexpr (TAILCUT) {
          id[u] = k < d_pad ? __ldcs(src + k) : -1;
          c[u] = k < d_pad ? gather(colors, id[u], n_ids) : -1;
        } else {
          c[u] = k < d_pad ? gather(colors, __ldcs(src + k), n_ids) : -1;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mark(occ_lane, copies, c[u], n_colors);
      if constexpr (TAILCUT) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (k0 + u * 32 + lane < d_pad) same_color(c[u], id[u], own, vid, hit, cnt);
        }
      }
    }
  }
  __syncwarp();

  if constexpr (TAILCUT) {
    hit = __any_sync(0xffffffffu, hit);
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) {
      flag[row] = hit;
      if (cnt != 0) atomicAdd(count + chain, static_cast<unsigned long long>(cnt));
    }
  }
  // the colour the first fit bars: cur's (the tailcut's first fit bars none)
  const int bar = !TAILCUT && cur != nullptr ? __ldg(cur + row) : -1;
  const bool bar_ok = static_cast<unsigned>(bar) < static_cast<unsigned>(n_colors);
  int result = -1;
  for (int w0 = 0; w0 < n_words; w0 += 32) {
    const int w = w0 + lane;
    uint32_t cand = 0u;
    if (w < n_words) {
      uint32_t used = 0u;
      const uint32_t* word = occ + static_cast<size_t>(w) * copies;
      for (int j = 0; j < copies; ++j) used |= word[(j + lane) & (copies - 1)];
      uint32_t allowed;
      if constexpr (TAILCUT) {  // every colour below n_colors
        const int tail = n_colors & 31;
        allowed = (w == n_words - 1 && tail) ? (1u << tail) - 1u : 0xffffffffu;
      } else {
        allowed = __ldg(allow_bits + w);
      }
      cand = ~used & allowed;
      if (bar_ok && (bar >> 5) == w) cand &= ~(1u << (bar & 31));
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

__global__ void lower_movable_kernel(const int* __restrict__ neighbors,
                                     const uint8_t* __restrict__ movable, int n_ids,
                                     uint8_t* __restrict__ lower, int n_rows, int d_pad,
                                     int row0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;
  if (first >= n_rows) return;  // uniform across the warp
  const size_t chain = blockIdx.y;
  movable += chain * n_ids;
  lower += chain * n_ids + row0;
  const int row = first + lane;
  unsigned todo = __ballot_sync(0xffffffffu, row < n_rows && __ldg(movable + row0 + row));
  unsigned found = 0u;
  while (todo != 0u) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1u;
    const int vid = row0 + first + l;
    const int* src = neighbors + static_cast<size_t>(first + l) * d_pad;
    for (int k0 = 0; k0 < d_pad; k0 += 32) {
      const int k = k0 + lane;
      bool m = false;
      if (k < d_pad) {
        const int id = __ldcs(src + k);
        m = static_cast<unsigned>(id) < static_cast<unsigned>(vid) && __ldg(movable + id);
      }
      if (__any_sync(0xffffffffu, m)) {
        found |= 1u << l;
        break;
      }
    }
  }
  if (row < n_rows) lower[row] = (found >> lane) & 1u;
}

template <bool VEC, int UNROLL, bool TAILCUT>
int launch(const void* neighbors, const void* colors, int n_ids,
           const void* allow_bits, const void* cur, void* out, int n_rows,
           int d_pad, int n_colors, int rows_per_block, int copies, int n_chains,
           int row0, void* flag, void* count, cudaStream_t stream) {
  const int n_words = (n_colors + 31) / 32;
  const size_t smem = static_cast<size_t>(rows_per_block) * n_words * copies *
                      sizeof(uint32_t);
  auto kernel = first_fit_kernel<VEC, UNROLL, TAILCUT>;
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
      n_colors, n_words, copies, row0, static_cast<uint8_t*>(flag),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int copies, int n_chains) {
  return copies < 1 || copies > 32 || (copies & (copies - 1)) != 0 || n_chains < 1 ||
         n_chains > 65535;
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
  if (bad_shape(copies, n_chains)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return (d_pad & 3) == 0
             ? launch<true, 2, false>(neighbors, colors, n_ids, allow_bits, cur, out, n_rows,
                                      d_pad, n_colors, rows_per_block, copies, n_chains, 0,
                                      nullptr, nullptr, s)
             : launch<false, 8, false>(neighbors, colors, n_ids, allow_bits, cur, out, n_rows,
                                       d_pad, n_colors, rows_per_block, copies, n_chains, 0,
                                       nullptr, nullptr, s);
}

// Launches K3's tailcut instance: rows row0 .. row0 + n_rows - 1 of the
// colour vector, whose ids are neighbors [n_rows, d_pad]; colors, out
// (int32) and flag (bytes) are [n_chains, n_ids], count [n_chains]
// uint64 and added to; every colour below n_colors is allowed.
int first_fit_tailcut_launch(const void* neighbors, const void* colors, int n_ids,
                             void* out, void* flag, void* count, int n_rows, int d_pad,
                             int n_colors, int rows_per_block, int copies, int n_chains,
                             int row0, void* stream) {
  if (bad_shape(copies, n_chains) || row0 < 0 || n_rows > n_ids - row0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return (d_pad & 3) == 0
             ? launch<true, 2, true>(neighbors, colors, n_ids, nullptr, nullptr, out, n_rows,
                                     d_pad, n_colors, rows_per_block, copies, n_chains, row0,
                                     flag, count, s)
             : launch<false, 8, true>(neighbors, colors, n_ids, nullptr, nullptr, out, n_rows,
                                      d_pad, n_colors, rows_per_block, copies, n_chains, row0,
                                      flag, count, s);
}

// Launches the lower-movable kernel on `stream` over rows row0 .. row0 +
// n_rows - 1 of the colour vector, whose ids are neighbors [n_rows,
// d_pad]; movable and lower are [n_chains, n_ids] bytes.
int lower_movable_launch(const void* neighbors, const void* movable, int n_ids, void* lower,
                         int n_rows, int d_pad, int row0, int n_chains, void* stream) {
  if (n_chains < 1 || n_chains > 65535 || row0 < 0 || n_rows > n_ids - row0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kWarps = 8;
  const int grid = (n_rows + 32 * kWarps - 1) / (32 * kWarps);
  lower_movable_kernel<<<dim3(grid, n_chains), 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(neighbors), static_cast<const uint8_t*>(movable), n_ids,
      static_cast<uint8_t*>(lower), n_rows, d_pad, row0);
  return static_cast<int>(cudaGetLastError());
}

const char* first_fit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
