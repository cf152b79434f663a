// Kernel K2: the fused resample sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel mcmc_colorer_tpu/ops/pallas_resample.py
// (pallas_sweep / _kernel / _kernel_chunked / _proposal_sample_chunked /
// _occ_chunk).  Per row r, given the gathered neighbour colours nc[r, :]
// (-1 = padding) and neighbour ids neighbors[r, :]:
//
//   conf[r]   = #{k : nc[r, k] == cur[r] and neighbors[r, k] > self_ids[r]}
//   occ       = the set of colours in nc[r, :] inside [0, n_colors)
//   q[c]      = the proposal of models/mcmc.py:_proposal_q for `kind`
//   chosen    = the first c whose prefix sum of q reaches unif[r]
//               (n_colors - 1 if none does); qstar = q[chosen]
//   taboo[r] > 0: keep cur with probability 1 - (n_colors - 1) * eps and
//               count the taboo down; else arm it when chosen == cur.
//
// What bounds it (config 3, ER(1M, 0.001): ~1M rows, d_pad 1280, ~1170
// colours): reading nc and neighbors, 10.4 GB, about 3.1 ms at the
// H100's 3.35 TB/s.  The palette work per row (two passes over
// ceil(n_colors / 32) warp-steps, a p_eff read per occupied colour and a
// five-step warp scan per 32 colours) is a few hundred instructions a
// warp, below the read.
//
// Design: one warp per row, rows_per_block rows per block, as K3.  The
// row's occupancy is a bitmask of ceil(n_colors / 32) words in shared
// memory, filled with atomicOr from coalesced reads of nc; the same read
// loop counts conflicts (neighbors is read beside nc).  Then two passes
// over the palette, 32 colours a step:
//   1. aggregates: zn = |occ| by popcount, violating = occ[cur], and
//      reminder = sum over occupied c of (p_eff[c] - eps), each lane over
//      its words, then warp sums (xor butterflies: every lane ends with
//      the same value);
//   2. the CDF walk: q for the step's 32 colours, a warp inclusive scan
//      (__shfl_up_sync) plus the running prefix carried across steps,
//      and for DECREASE_* the running free-colour count j (ballot and
//      popcount).  The first lane whose cdf reaches u gives chosen, and
//      its q is qstar, so the TPU's third pass is not needed.
// The TPU kernel walked palettes above 3072 colours in 1024-colour chunks
// to bound VMEM; here one design serves every palette whose bitmask fits
// the 232,448 bytes of shared memory a block may use.  exp is expf (no
// fast math).  The float sums run in another order than torch's, so a
// sampled colour may differ from the plain version's where the uniform
// lies on a CDF step; the integer outputs are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStandard = 0;
constexpr int kBalance = 1;   // BALANCE_LINE / _EXP / _DYNAMIC
constexpr int kDecrease = 2;  // DECREASE_LINE / _EXP

__device__ __forceinline__ int warp_sum(int v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ bool bit_of(const uint32_t* occ, int c) {
  return (occ[c >> 5] >> (c & 31)) & 1u;
}

__global__ void resample_kernel(
    const int* __restrict__ nc, const int* __restrict__ neighbors,
    const int* __restrict__ cur, const int* __restrict__ taboo,
    const int* __restrict__ self_ids, const float* __restrict__ unif,
    const float* __restrict__ p_eff, const float* __restrict__ eps_ptr,
    int* __restrict__ star, float* __restrict__ qstar,
    int* __restrict__ new_taboo, int* __restrict__ conf, int n_rows,
    int d_pad, int n_colors, int n_words, int kind, float lam,
    int lam_zero, int taboo_iterations) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n_rows) return;  // uniform across the warp

  uint32_t* occ = smem + static_cast<size_t>(warp) * n_words;
  for (int w = lane; w < n_words; w += 32) occ[w] = 0u;
  __syncwarp();

  const int own = __ldg(cur + row);
  const int sid = __ldg(self_ids + row);
  const size_t base = static_cast<size_t>(row) * d_pad;
  int n_conf = 0;
  for (int k = lane; k < d_pad; k += 32) {
    const int c = __ldg(nc + base + k);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n_colors)) {
      atomicOr(occ + (c >> 5), 1u << (c & 31));
    }
    if (c == own && __ldg(neighbors + base + k) > sid) ++n_conf;
  }
  n_conf = warp_sum(n_conf);
  __syncwarp();

  const float eps = __ldg(eps_ptr);
  const float keep_hi = 1.0f - static_cast<float>(n_colors - 1) * eps;
  const int tab = __ldg(taboo + row);
  if (tab > 0) {  // taboo: keep the current colour, count down
    if (lane == 0) {
      conf[row] = n_conf;
      star[row] = own;
      qstar[row] = keep_hi;
      new_taboo[row] = tab - 1;
    }
    return;
  }

  // ---- pass 1: aggregates ----
  int zn = 0;
  float reminder = 0.0f;
  for (int w = lane; w < n_words; w += 32) {
    const uint32_t o = occ[w];
    zn += __popc(o);
    if (kind != kStandard) {
      uint32_t x = o;
      while (x) {
        const int b = __ffs(x) - 1;
        x &= x - 1;
        reminder += __ldg(p_eff + w * 32 + b) - eps;
      }
    }
  }
  zn = warp_sum(zn);
  reminder = warp_sum(reminder);
  const int zp = n_colors - zn;
  const float zp_f = static_cast<float>(zp > 1 ? zp : 1);
  const bool own_ok = static_cast<unsigned>(own) < static_cast<unsigned>(n_colors);
  const bool move = own_ok && bit_of(occ, own) && zp > 0;
  const float move_std = (1.0f - eps * static_cast<float>(zn)) / zp_f;
  const float add_bal = reminder / zp_f;
  float denom_r = zp_f;
  if (kind == kDecrease && !lam_zero) {
    denom_r = (1.0f - expf(-lam * zp_f)) / (1.0f - expf(-lam));
  }

  // ---- pass 2: the CDF walk ----
  const float u = __ldg(unif + row);
  float prefix = 0.0f;
  int free_before = 0;
  int chosen = -1;
  float q_chosen = 0.0f;
  float q_last = 0.0f;
  const unsigned le_mask = kFull >> (31 - lane);
  for (int c0 = 0; c0 < n_colors; c0 += 32) {
    const int c = c0 + lane;
    const bool valid = c < n_colors;
    const bool is_free = valid && !bit_of(occ, valid ? c : 0);
    const unsigned free_bits = __ballot_sync(kFull, is_free);
    float q = 0.0f;
    if (valid) {
      if (zp == 0) {
        q = c == own ? 1.0f : 0.0f;
      } else if (!move) {
        q = c == own ? keep_hi : eps;
      } else if (!is_free) {
        q = eps;
      } else if (kind == kStandard) {
        q = move_std;
      } else if (kind == kBalance) {
        q = __ldg(p_eff + c) + add_bal;
      } else {
        const float j = static_cast<float>(free_before + __popc(free_bits & le_mask)) - 1.0f;
        const float w = lam_zero ? 1.0f / denom_r : expf(-lam * j) / denom_r;
        q = __ldg(p_eff + c) + reminder * w;
      }
    }
    float s = q;
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += t;
    }
    const float cdf = prefix + s;
    const unsigned hit = __ballot_sync(kFull, valid && !(cdf < u));
    if (hit) {
      const int l = __ffs(hit) - 1;
      chosen = c0 + l;
      q_chosen = __shfl_sync(kFull, q, l);
      break;
    }
    const int last = n_colors - 1 - c0;
    q_last = __shfl_sync(kFull, q, last < 31 ? last : 31);
    prefix = __shfl_sync(kFull, cdf, 31);
    free_before += __popc(free_bits);
  }
  if (chosen < 0) {  // overflow: the last colour (_standard.cu:50-58)
    chosen = n_colors - 1;
    q_chosen = q_last;
  }
  if (lane == 0) {
    conf[row] = n_conf;
    star[row] = chosen;
    qstar[row] = q_chosen;
    new_taboo[row] = chosen == own ? taboo_iterations : 0;
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`; returns cudaGetLastError() of the launch
// (0 on success).  Pointers are device pointers; outputs are [n_rows].
int resample_launch(const void* nc, const void* neighbors, const void* cur,
                    const void* taboo, const void* self_ids, const void* unif,
                    const void* p_eff, const void* eps, void* star,
                    void* qstar, void* new_taboo, void* conf, int n_rows,
                    int d_pad, int n_colors, int kind, float lam,
                    int lam_zero, int taboo_iterations, int rows_per_block,
                    void* stream) {
  const int n_words = (n_colors + 31) / 32;
  const size_t smem =
      static_cast<size_t>(rows_per_block) * n_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  resample_kernel<<<grid, 32 * rows_per_block, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nc), static_cast<const int*>(neighbors),
      static_cast<const int*>(cur), static_cast<const int*>(taboo),
      static_cast<const int*>(self_ids), static_cast<const float*>(unif),
      static_cast<const float*>(p_eff), static_cast<const float*>(eps),
      static_cast<int*>(star), static_cast<float*>(qstar),
      static_cast<int*>(new_taboo), static_cast<int*>(conf), n_rows, d_pad,
      n_colors, n_words, kind, lam, lam_zero, taboo_iterations);
  return static_cast<int>(cudaGetLastError());
}

const char* resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
