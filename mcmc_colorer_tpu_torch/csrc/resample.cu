// Kernel K2: the resample sweep over neighbour ids, for Hopper (sm_90a).
//
// Replaces the Pallas kernel mcmc_colorer_tpu/ops/pallas_resample.py
// (pallas_sweep / _kernel / _kernel_chunked / _proposal_sample_chunked /
// _occ_chunk), with the neighbour gather that the JAX package leaves to
// XLA in front of it (ops/neighbor.py:neighbor_colors).  Per row r of a
// band of ELL rows, whose own vertex id sid(r) is row0 + r, or self_ids[r]
// when the rows are a frontier's (models/mcmc_active.py; JAX passes
// self_ids=active_ids, mcmc_active.py:430-441):
//
//   col(id)   = colors[id] for id in [0, n_ids), else -1: the ELL's
//               padding id n_pad counts nowhere
//   conf[r]   = #{k : col(neighbors[r, k]) == cur[r] and
//                     neighbors[r, k] > sid(r)}
//   occ       = the set of colours col(neighbors[r, k]) in [0, n_colors)
//   q[c]      = the proposal of models/mcmc.py:_proposal_q for `kind`
//   chosen    = the first c whose prefix sum of q reaches unif[r]
//               (n_colors - 1 if none does); qstar = q[chosen]
//   taboo[r] > 0: keep cur with probability 1 - (n_colors - 1) * eps and
//               count the taboo down; else arm it when chosen == cur.
//
// What bounds it.  Two regimes, chosen by shape alone
// (ops/resample.py:sweep_shape):
// - L2, when the colour vector does not fit shared memory (config 3,
//   ER(1M, 0.001): 1M rows of d_pad 1280, ~1170 colours).  The ids, 537
//   MB a 104,832-row band, take 0.16 ms at the H100's 3.35 TB/s; the
//   band's ~1.05e8 colour lookups go into a 4 MB vector that stays in the
//   50 MB L2 but in no SM's L1, one L2 request a lookup, and L2 serves
//   those at ~1.06e11 a second (PERF.md, PR 3): ~1 ms a band.
// - staged, when it fits (ER(100k, 0.01): 100,000 vertices, d_pad 1152,
//   1150 colours).  The ids, ~461 MB a sweep, take 0.14 ms; the ~1e8
//   lookups are shared-memory reads, off L2.
// The palette work of a row (two passes over ceil(n_colors / 32)
// warp-steps, the second ending where the CDF reaches the uniform) is a
// few hundred instructions a warp.
//
// Design.  One warp per row.  Each lane loads its ids two 16-byte vectors
// at a time with the streaming hint and looks up their eight colours
// before it uses any (a row whose d_pad is no multiple of 4 is read 8
// single ids a lane at a time): K3's scheme (csrc/first_fit.cu).  The
// conflict test uses the id already in a register, so neighbors is read
// once.  A row's occupancy bitmask has `copies` interleaved copies of its
// n_words = ceil(n_colors / 32) words in shared memory, word w of copy j
// at w * copies + j, lane l setting its bits in copy l % copies (a single
// mask put 32 lanes on one atomicOr word); the first palette pass ORs the
// copies of word w into copy 0 in lane w % 32.
// - staged: one persistent block an SM, with as many warps (8 to 32) as
//   the shared memory left after staging allows; the warps walk the rows
//   in a grid-stride loop.  Once a launch, the block stages p_eff and the
//   colour vector, converted to uint16 as it loads (0xFFFF for -1 and for
//   any colour outside [0, 65535): such a lookup reads the int32 vector
//   instead, so every input gives the exact colour).
// - L2: 8 warps a block, a row a warp; colours read with __ldg.
// Then two passes over the palette, 32 colours a step:
//   1. aggregates: zn = |occ| by popcount and reminder = sum over
//      occupied c of (p_eff[c] - eps), each lane over its words, then
//      warp sums (xor butterflies: every lane ends with the same value);
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
//
// The chain axis.  An ensemble of C independent chains sweeps one shared
// ELL (JAX vmaps pallas_sweep over its chains: parallel/chains.py:145-153).
// Here the chain is the grid's y index: block (x, c) serves chain c, whose
// colour vector is colors[c * n_ids, ...), whose per-row vectors (cur,
// taboo, unif and the four outputs) are [c * n_rows, ...) and whose p_eff
// is p_eff[c * n_colors, ...); neighbors, self_ids and eps are shared.
// In the staged regime each block stages its own chain's vector, and the
// wrapper gives each chain SMs / C persistent blocks (at least one), so a
// launch is still about one block an SM.  C = 1 is the one-chain launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStandard = 0;
constexpr int kBalance = 1;   // BALANCE_LINE / _EXP / _DYNAMIC
constexpr int kDecrease = 2;  // DECREASE_LINE / _EXP
constexpr unsigned kNo16 = 0xffffu;  // a staged colour outside [0, 65535)
constexpr int kMaxWarps = 32;
constexpr size_t kSmemMax = 232448;

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// A neighbour's colour: from the staged uint16 copy or from L2.
template <bool STAGED>
struct Colors {
  const uint16_t* s;
  const int* g;
  int n_ids;
  __device__ __forceinline__ int operator()(int id) const {
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(n_ids)) return -1;
    if (!STAGED) return __ldg(g + id);
    const unsigned c = s[id];
    return c != kNo16 ? static_cast<int>(c) : __ldg(g + id);
  }
};

// p_eff[c]: staged beside the colours, or from L2.
template <bool STAGED>
struct PEff {
  const float* s;
  const float* g;
  __device__ __forceinline__ float operator[](int c) const {
    return STAGED ? s[c] : __ldg(g + c);
  }
};

__device__ __forceinline__ unsigned to16(int v) {
  return static_cast<unsigned>(v) < kNo16 ? static_cast<unsigned>(v) : kNo16;
}

__device__ __forceinline__ uint2 pack4(int4 v) {
  return make_uint2(to16(v.x) | (to16(v.y) << 16), to16(v.z) | (to16(v.w) << 16));
}

// The block's uint16 copy of colors[0, n_ids): 16-byte loads four deep
// when the vector is 16-byte aligned, single ids for the rest.
__device__ void stage_colors(uint16_t* s_col, const int* __restrict__ colors, int n_ids) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int start = 0;
  if ((reinterpret_cast<uintptr_t>(colors) & 15) == 0) {
    const int n4 = n_ids >> 2;
    const int4* c4 = reinterpret_cast<const int4*>(colors);
    uint2* s2 = reinterpret_cast<uint2*>(s_col);
    int q = tid;
    for (; q + 3 * nt < n4; q += 4 * nt) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(c4 + q + u * nt);
#pragma unroll
      for (int u = 0; u < 4; ++u) s2[q + u * nt] = pack4(v[u]);
    }
    for (; q < n4; q += nt) s2[q] = pack4(__ldg(c4 + q));
    start = n4 << 2;
  }
  for (int i = start + tid; i < n_ids; i += nt) {
    s_col[i] = static_cast<uint16_t>(to16(__ldg(colors + i)));
  }
}

__device__ __forceinline__ int visit(uint32_t* occ_lane, int copies, int n_colors,
                                     int c, int id, int own, int sid) {
  if (static_cast<unsigned>(c) < static_cast<unsigned>(n_colors)) {
    atomicOr(occ_lane + (c >> 5) * copies, 1u << (c & 31));
  }
  return (c == own) & (id > sid);
}

// Streams one row's ids, fills its occupancy copies and returns the
// lane's conflict count.
template <bool VEC, int UNROLL, bool STAGED>
__device__ __forceinline__ int stream_row(const int* __restrict__ src, int d_pad,
                                          int lane, const Colors<STAGED>& col,
                                          uint32_t* occ_lane, int copies,
                                          int n_colors, int own, int sid) {
  constexpr int K = VEC ? 4 * UNROLL : UNROLL;
  int n_conf = 0;
  const int n_steps = VEC ? d_pad >> 2 : d_pad;
  for (int k0 = 0; k0 < n_steps; k0 += 32 * UNROLL) {
    int ids[K];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * 32 + lane;
      if (VEC) {
        const int4 v = k < n_steps ? __ldcs(reinterpret_cast<const int4*>(src) + k)
                                   : make_int4(-1, -1, -1, -1);
        ids[4 * u + 0] = v.x;
        ids[4 * u + 1] = v.y;
        ids[4 * u + 2] = v.z;
        ids[4 * u + 3] = v.w;
      } else {
        ids[u] = k < n_steps ? __ldcs(src + k) : -1;
      }
    }
    int c[K];
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = col(ids[i]);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      n_conf += visit(occ_lane, copies, n_colors, c[i], ids[i], own, sid);
    }
  }
  return n_conf;
}

template <bool STAGED, bool VEC, int UNROLL>
__global__ void __launch_bounds__(kMaxWarps * 32) resample_kernel(
    const int* __restrict__ neighbors, const int* __restrict__ colors, int n_ids,
    const int* __restrict__ cur, const int* __restrict__ taboo,
    const float* __restrict__ unif, const float* __restrict__ p_eff,
    const float* __restrict__ eps_ptr, int* __restrict__ star,
    float* __restrict__ qstar, int* __restrict__ new_taboo,
    int* __restrict__ conf, int n_rows, int d_pad, int row0,
    const int* __restrict__ self_ids, int n_colors, int n_words, int copies,
    int kind, float lam, int lam_zero, int taboo_iterations) {
  extern __shared__ __align__(16) unsigned char smem[];
  {  // this block's chain: offset every per-chain array to its slice
    const size_t chain = blockIdx.y;
    colors += chain * n_ids;
    cur += chain * n_rows;
    taboo += chain * n_rows;
    unif += chain * n_rows;
    p_eff += chain * n_colors;
    star += chain * n_rows;
    qstar += chain * n_rows;
    new_taboo += chain * n_rows;
    conf += chain * n_rows;
  }
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_words = n_words * copies;
  const size_t mask_bytes = round16(static_cast<size_t>(warps) * row_words * 4);
  uint32_t* occ = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * row_words;
  uint32_t* occ_lane = occ + (lane & (copies - 1));

  PEff<STAGED> pe{nullptr, p_eff};
  Colors<STAGED> col{nullptr, colors, n_ids};
  if (STAGED) {
    float* s_pe = reinterpret_cast<float*>(smem + mask_bytes);
    uint16_t* s_col = reinterpret_cast<uint16_t*>(
        smem + mask_bytes + round16(static_cast<size_t>(n_colors) * 4));
    for (int i = threadIdx.x; i < n_colors; i += blockDim.x) s_pe[i] = __ldg(p_eff + i);
    stage_colors(s_col, colors, n_ids);
    __syncthreads();
    pe.s = s_pe;
    col.s = s_col;
  }

  const float eps = __ldg(eps_ptr);
  const float keep_hi = 1.0f - static_cast<float>(n_colors - 1) * eps;
  const unsigned le_mask = kFull >> (31 - lane);
  for (int row = blockIdx.x * warps + warp; row < n_rows; row += gridDim.x * warps) {
    __syncwarp();  // the previous row's reads of occ are done
    for (int w = lane; w < row_words; w += 32) occ[w] = 0u;
    __syncwarp();

    const int own = __ldg(cur + row);
    const int sid = self_ids != nullptr ? __ldg(self_ids + row) : row0 + row;
    const int* src = neighbors + static_cast<size_t>(row) * d_pad;
    const int n_conf = warp_sum(
        stream_row<VEC, UNROLL>(src, d_pad, lane, col, occ_lane, copies, n_colors, own, sid));
    __syncwarp();

    const int tab = __ldg(taboo + row);
    if (tab > 0) {  // taboo: keep the current colour, count down
      if (lane == 0) {
        conf[row] = n_conf;
        star[row] = own;
        qstar[row] = keep_hi;
        new_taboo[row] = tab - 1;
      }
      continue;
    }

    // ---- pass 1: aggregates; the copies of each word folded into copy 0 ----
    int zn = 0;
    float reminder = 0.0f;
    for (int w = lane; w < n_words; w += 32) {
      uint32_t* word = occ + static_cast<size_t>(w) * copies;
      uint32_t o = 0u;
      for (int j = 0; j < copies; ++j) o |= word[(j + lane) & (copies - 1)];
      word[0] = o;
      zn += __popc(o);
      if (kind != kStandard) {
        while (o) {
          const int b = __ffs(o) - 1;
          o &= o - 1;
          reminder += pe[w * 32 + b] - eps;
        }
      }
    }
    zn = warp_sum(zn);
    reminder = warp_sum(reminder);
    __syncwarp();
    // bit c of the folded mask
    auto occupied = [&](int c) { return (occ[(c >> 5) * copies] >> (c & 31)) & 1u; };
    const int zp = n_colors - zn;
    const float zp_f = static_cast<float>(zp > 1 ? zp : 1);
    const bool own_ok = static_cast<unsigned>(own) < static_cast<unsigned>(n_colors);
    const bool move = own_ok && occupied(own) && zp > 0;
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
    for (int c0 = 0; c0 < n_colors; c0 += 32) {
      const int c = c0 + lane;
      const bool valid = c < n_colors;
      const bool is_free = valid && !occupied(valid ? c : 0);
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
          q = pe[c] + add_bal;
        } else {
          const float j = static_cast<float>(free_before + __popc(free_bits & le_mask)) - 1.0f;
          const float w = lam_zero ? 1.0f / denom_r : expf(-lam * j) / denom_r;
          q = pe[c] + reminder * w;
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
}

template <bool STAGED, bool VEC, int UNROLL>
int launch(const void* neighbors, const void* colors, int n_ids, const void* cur,
           const void* taboo, const void* unif, const void* p_eff, const void* eps,
           void* star, void* qstar, void* new_taboo, void* conf, int n_rows,
           int d_pad, int row0, const void* self_ids, int n_colors, int n_words,
           int copies, int kind, float lam, int lam_zero, int taboo_iterations, int warps, int grid,
           int n_chains, size_t smem, cudaStream_t stream) {
  auto kernel = resample_kernel<STAGED, VEC, UNROLL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(grid, n_chains), 32 * warps, smem, stream>>>(
      static_cast<const int*>(neighbors), static_cast<const int*>(colors), n_ids,
      static_cast<const int*>(cur), static_cast<const int*>(taboo),
      static_cast<const float*>(unif), static_cast<const float*>(p_eff),
      static_cast<const float*>(eps), static_cast<int*>(star),
      static_cast<float*>(qstar), static_cast<int*>(new_taboo),
      static_cast<int*>(conf), n_rows, d_pad, row0, static_cast<const int*>(self_ids),
      n_colors, n_words, copies, kind, lam, lam_zero, taboo_iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 on `stream`; returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take:
// `copies` a power of two up to 32, 1 to 32 warps a block, 1 to 65535
// chains, the staged regime with fewer than 65535 colours, and shared
// memory within a block's 232,448 bytes.  Pointers are device pointers;
// outputs are [n_chains, n_rows].  neighbors is [n_rows, d_pad], 16-byte
// aligned when d_pad % 4 == 0 (its rows are then read as 16-byte vectors);
// colors is [n_chains, n_ids]; cur, taboo and unif are [n_chains, n_rows];
// p_eff is [n_chains, n_colors]; self_ids is [n_rows] or null (the own ids
// are then row0 on); `grid` is the blocks of one chain.
int resample_launch(const void* neighbors, const void* colors, int n_ids,
                    const void* cur, const void* taboo, const void* unif,
                    const void* p_eff, const void* eps, void* star, void* qstar,
                    void* new_taboo, void* conf, int n_rows, int d_pad, int row0,
                    const void* self_ids, int n_colors, int kind, float lam, int lam_zero,
                    int taboo_iterations, int staged, int warps, int copies,
                    int grid, int n_chains, void* stream) {
  const int n_words = (n_colors + 31) / 32;
  size_t smem = round16(static_cast<size_t>(warps) * n_words * copies * 4);
  if (staged) {
    smem += round16(static_cast<size_t>(n_colors) * 4) + round16(static_cast<size_t>(n_ids) * 2);
  }
  if (copies < 1 || copies > 32 || (copies & (copies - 1)) != 0 || warps < 1 ||
      warps > kMaxWarps || grid < 1 || n_chains < 1 || n_chains > 65535 || smem > kSmemMax ||
      (staged && n_colors >= static_cast<int>(kNo16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = (d_pad & 3) == 0;
#define K2_ARGS                                                                   \
  neighbors, colors, n_ids, cur, taboo, unif, p_eff, eps, star, qstar, new_taboo, \
      conf, n_rows, d_pad, row0, self_ids, n_colors, n_words, copies, kind, lam,  \
      lam_zero, taboo_iterations, warps, grid, n_chains, smem, s
  if (staged) {
    return vec ? launch<true, true, 2>(K2_ARGS) : launch<true, false, 8>(K2_ARGS);
  }
  return vec ? launch<false, true, 2>(K2_ARGS) : launch<false, false, 8>(K2_ARGS);
#undef K2_ARGS
}

const char* resample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
