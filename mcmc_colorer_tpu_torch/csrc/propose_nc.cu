// Kernel K4: the proposal over neighbour-colour counts, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package computes this step in jnp
// ops that XLA fuses (mcmc_colorer_tpu/models/mcmc.py: _proposal_q,
// _sample_cdf, and _sweep_matmul's block loop); the port ran it as some
// forty torch launches a row block, each a full pass over a [block,
// n_col_pad] temporary (models/mcmc.py:_propose on NC > 0).  K4 reads
// each NC row once.  Per chain c and row i of NC [C, n_rows, n_col_pad]
// int32, with own = cur[c, i]:
//
//   occ[x]     = NC[i, x] > 0 for every colour x < n_colors
//   zn         = |occ|, zp = n_colors - zn
//   reminder   = sum over occupied x of (p_eff[x] - eps)
//                (read by BALANCE_* and DECREASE_*)
//   violating  = own in [0, n_colors) and NC[i, own] > 0
//   q[x]       = models/mcmc.py:_proposal_q's q for `kind`, 0 past n_colors
//   chosen     = the first colour whose float32 prefix sum of q reaches
//                unif[c, i], n_colors - 1 if none does; qstar = q[chosen]
//   taboo > 0: chosen = own, qstar = 1 - (n_colors - 1) * eps, the taboo
//              counts down; else it is armed where chosen == own
//   star       = chosen on real rows, own elsewhere; qstar 1 off real rows
//   conf2[c]  += NC[i, own] (own in [0, n_colors)), over every row
//
// which is models/mcmc.py:_propose on the occupancy NC > 0, with the real
// mask of ops/propose_nc.py:propose_nc_plain, and _at_color(nc, cur).sum(1).
// The columns from n_colors on are K1's padding, 0 in every row, and are
// not read: the kernel reads the first n_colors of each row, rounded up to
// a 16-byte vector.
//
// What bounds it: reading those columns once, 460 MB at ER(100k, 0.01)
// and nCol 1150 (100,352 rows, 1,152 columns read), 231 MB at nCol 575
// and 116 MB at 287: 0.14, 0.069 and 0.035 ms at the H100's 3.35 TB/s,
// plus 25 bytes of per-row vectors.  A row's palette work is a few
// hundred instructions a warp, under its memory time if enough rows are
// in flight.
//
// Design: one warp a row, up to 8 warps a block, as many blocks as fit the
// card at once, in a grid-stride loop over the rows (the chain is the
// grid's y index).  A warp copies its row into its slot of shared memory
// with cp.async (16 bytes a lane, the warp 512 contiguous bytes a step,
// the whole row in flight at once), so few registers hold a row and many
// warps keep the memory busy.  Lane l then owns the W = n_col_pad / 32
// contiguous colours [l W, l W + W) (a lane's slot is padded by 4 words
// where W % 8 == 0, so 16-byte reads of eight lanes hit distinct banks);
// the block's p_eff is staged once in the same layout, zero past n_colors.
// Where two such slots do not fit a block's shared memory (n_col_pad above
// 29,056), the warps read their rows in place, from global memory through
// L1 and L2, in the same lane layout; only p_eff is staged (n_col_pad up to
// 57,984).  The launch picks between the two from n_col_pad alone.
//   1. aggregates, each lane over its colours, then warp sums (xor
//      butterflies): zn, the reminder, NC[i, own]; and the lane's free
//      colours and their p_eff sum;
//   2. the lane's share of the CDF: q is affine in those sums for every
//      kind but DECREASE_* (STANDARD: free colours at one q, BALANCE_*:
//      p_eff plus one q), which sums q colour by colour; a warp scan of
//      the shares and a ballot find the first lane whose CDF reaches u;
//   3. that lane's colours, 32 a step across the warp: q, a warp scan
//      from the CDF before the lane, a ballot for the chosen colour.
// A row under taboo stops after pass 1.  The sums run in another order
// than torch's, so a sampled colour may differ from the plain version's
// where the uniform lies on a CDF step (a lane's share summed two ways
// differs by rounding: where u lies there, the lane's last colour or the
// next lane's first is taken); a lane's sums carry their rounding error
// (Kahan), so they stay within a few ulps however many colours the lane
// holds.  The integer outputs are exact.  conf2 is
// summed a block in shared memory and added with one 64-bit integer
// atomic a block: exact and the same on every run.  exp is expf (no fast
// math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStandard = 0;
constexpr int kBalance = 1;   // BALANCE_LINE / _EXP / _DYNAMIC
constexpr int kDecrease = 2;  // DECREASE_LINE / _EXP
constexpr int kMaxWarps = 8;  // rows in flight a block
constexpr size_t kSmemMax = 232448 - kMaxWarps * sizeof(unsigned long long);  // beside s_conf

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// A float32 sum with its rounding error carried (Kahan): a lane adds up to
// n_col_pad / 32 terms in a row, and a plain running sum of many drifts from
// torch's by more than the CDF-boundary rule allows.  No multiply, so no
// contraction into an FMA changes it.
struct CompensatedSum {
  float sum = 0.0f, err = 0.0f;
  __device__ __forceinline__ void add(float x) {
    const float y = x - err;
    const float t = sum + y;
    err = (t - sum) - y;
    sum = t;
  }
};

// What a row's q needs, fixed once pass 1 is done.
struct RowState {
  int kind;
  float eps;
  float keep_hi;     // 1 - (n_colors - 1) * eps
  float lam;
  bool lam_zero;
  int own;
  int zp;
  bool move;         // violating and zp > 0
  float move_std;    // STANDARD's q of a free colour
  float add_bal;     // BALANCE's reminder / zp
  float reminder;
  float denom_r;     // DECREASE's normaliser
};

// q of colour x (x < n_colors) from its occupancy, its p_eff and, for
// DECREASE_*, its index j among the free colours (_proposal_q).
__device__ __forceinline__ float q_of(const RowState& s, int x, bool occupied, float j,
                                      float p) {
  if (s.zp == 0) return x == s.own ? 1.0f : 0.0f;
  if (!s.move) return x == s.own ? s.keep_hi : s.eps;
  if (occupied) return s.eps;
  if (s.kind == kStandard) return s.move_std;
  if (s.kind == kBalance) return p + s.add_bal;
  const float w = s.lam_zero ? 1.0f / s.denom_r : expf(-s.lam * j) / s.denom_r;
  return p + s.reminder * w;
}

// kStaged: each warp copies its row into shared memory; otherwise it reads
// the row in place.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * 32) propose_nc_kernel(
    const int* __restrict__ nc, const int* __restrict__ cur, const int* __restrict__ taboo,
    const float* __restrict__ unif, const uint8_t* __restrict__ real,
    const float* __restrict__ p_eff, const float* __restrict__ eps_ptr,
    int* __restrict__ star, int* __restrict__ new_taboo, float* __restrict__ qstar,
    unsigned long long* __restrict__ conf2, int n_rows, int n_col_pad, int n_colors,
    int slot, int kind, float lam, int lam_zero, int taboo_iterations) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_conf[kMaxWarps];
  {  // this block's chain: offset every per-chain array to its slice
    const size_t chain = blockIdx.y;
    nc += chain * n_rows * static_cast<size_t>(n_col_pad);
    cur += chain * n_rows;
    taboo += chain * n_rows;
    unif += chain * n_rows;
    star += chain * n_rows;
    new_taboo += chain * n_rows;
    qstar += chain * n_rows;
    conf2 += chain;
    if (p_eff != nullptr) p_eff += chain * n_colors;
  }
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int W = n_col_pad >> 5;  // a lane's colours
  // shared memory: p_eff, then (kStaged) a row a warp; colour x at
  // (x / W) * slot + x % W.  A row read in place has it at x.
  float* pe_s = reinterpret_cast<float*>(smem);
  int* row_s = reinterpret_cast<int*>(smem) + static_cast<size_t>(32 + 32 * warp) * slot;
  const int rslot = kStaged ? slot : W;  // words from a lane's colours to the next lane's
  for (int i = threadIdx.x; i < 32 * slot; i += blockDim.x) {
    const int off = i % slot, x = (i / slot) * W + off;
    pe_s[i] = off < W && x < n_colors && p_eff != nullptr ? __ldg(p_eff + x) : 0.0f;
  }
  __syncthreads();

  RowState s;
  s.kind = kind;
  s.eps = __ldg(eps_ptr);
  s.keep_hi = 1.0f - static_cast<float>(n_colors - 1) * s.eps;
  s.lam = lam;
  s.lam_zero = lam_zero != 0;
  const float eps = s.eps;
  const int x0 = lane * W;  // this lane's first colour
  const int mine = lane * slot, mine_r = lane * rslot;
  int n_valid = n_colors - x0;  // this lane's colours in the palette
  n_valid = n_valid < 0 ? 0 : (n_valid > W ? W : n_valid);
  const int n_read = (n_valid + 3) & ~3;  // ... in whole 16-byte vectors
  const int n_copy = (n_colors + 3) & ~3;  // a row's columns read
  const unsigned le_mask = kFull >> (31 - lane);
  // where this lane's 16-byte copies land: colour x = 4 lane + 128 k goes to
  // (x / W) * slot + x % W, stepped without a division a copy
  const int seg0 = 4 * lane / W, off0 = 4 * lane % W, dseg = 128 / W, doff = 128 % W;
  unsigned long long conf = 0;
  for (int row = blockIdx.x * warps + warp; row < n_rows; row += gridDim.x * warps) {
    const int* src = nc + static_cast<size_t>(row) * n_col_pad;
    const int* rowp = kStaged ? row_s : src;  // the row, lane l's colours at l * rslot
    if (kStaged) {
      __syncwarp();  // the previous row's reads of the slot are done
      for (int x = 4 * lane, seg = seg0, off = off0; x < n_copy; x += 128) {
        cp_async16(row_s + seg * slot + off, src + x);
        seg += dseg;
        off += doff;
        if (off >= W) {
          off -= W;
          ++seg;
        }
      }
    }
    const int own = __ldg(cur + row);
    const int tab = __ldg(taboo + row);
    const float u = __ldg(unif + row);
    const bool is_real = real[row] != 0;
    if (kStaged) {
      cp_async_wait_all();
      __syncwarp();
    }

    // ---- pass 1: aggregates, NC[i, own], the lane's free colours ----
    int zn = 0, nc_own = 0, n_free = 0;
    CompensatedSum rem_sum, free_sum;
    for (int j = 0; j < n_read; j += 4) {
      const int4 c4 = *reinterpret_cast<const int4*>(rowp + mine_r + j);
      const float4 p4 = *reinterpret_cast<const float4*>(pe_s + mine + j);
      const int c[4] = {c4.x, c4.y, c4.z, c4.w};
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (j + i >= n_valid) break;  // past the palette
        const int x = x0 + j + i;
        const bool occ = c[i] > 0;
        zn += occ;
        if (x == own) nc_own = c[i];
        if (occ) {
          rem_sum.add(p[i] - eps);
        } else {
          ++n_free;
          free_sum.add(p[i]);
        }
      }
    }
    const float free_pe = free_sum.sum;
    zn = warp_sum(zn);
    const float reminder = warp_sum(rem_sum.sum);
    nc_own = warp_sum(nc_own);  // one lane holds column own, or none does
    conf += nc_own;
    if (tab > 0) {  // taboo: keep the current colour, count down
      if (lane == 0) {
        star[row] = own;
        qstar[row] = is_real ? s.keep_hi : 1.0f;
        new_taboo[row] = tab - 1;
      }
      continue;
    }
    const int zp = n_colors - zn;
    const float zp_f = static_cast<float>(zp > 1 ? zp : 1);
    s.own = own;
    s.zp = zp;
    s.move = nc_own > 0 && zp > 0;
    s.move_std = (1.0f - eps * static_cast<float>(zn)) / zp_f;
    s.add_bal = reminder / zp_f;
    s.reminder = reminder;
    s.denom_r = zp_f;
    if (kind == kDecrease && !s.lam_zero) {
      s.denom_r = (1.0f - expf(-lam * zp_f)) / (1.0f - expf(-lam));
    }

    // ---- pass 2: each lane's share of the CDF ----
    int free_before = 0, n_free_all = 0;  // DECREASE_*'s free colours before the lane, in all
    if (kind == kDecrease) {
      const int incl = warp_inclusive_scan(n_free, lane);
      free_before = incl - n_free;
      n_free_all = __shfl_sync(kFull, incl, 31);
    }
    const bool own_here = own >= x0 && own < x0 + n_valid;
    float share;
    if (zp == 0) {
      share = own_here ? 1.0f : 0.0f;
    } else if (!s.move) {
      share = own_here ? static_cast<float>(n_valid - 1) * eps + s.keep_hi
                       : static_cast<float>(n_valid) * eps;
    } else if (kind == kStandard) {
      share = static_cast<float>(n_free) * s.move_std + static_cast<float>(n_valid - n_free) * eps;
    } else if (kind == kBalance) {
      share = free_pe + static_cast<float>(n_free) * s.add_bal +
              static_cast<float>(n_valid - n_free) * eps;
    } else {
      CompensatedSum q_sum;
      int f = free_before;
      for (int j = 0; j < n_valid; ++j) {
        const bool occ = rowp[mine_r + j] > 0;
        f += !occ;
        q_sum.add(q_of(s, x0 + j, occ, static_cast<float>(f) - 1.0f, pe_s[mine + j]));
      }
      share = q_sum.sum;
    }
    const float incl = warp_inclusive_scan(share, lane);
    const unsigned hit = __ballot_sync(kFull, n_valid > 0 && !(incl < u));

    // ---- pass 3: the chosen colour inside the first lane that reaches u ----
    int chosen;
    float q_chosen;
    if (hit) {
      const int lw = __ffs(hit) - 1;
      const float before = __shfl_sync(kFull, incl, lw > 0 ? lw - 1 : 0);
      float cdf0 = lw > 0 ? before : 0.0f;
      int f = __shfl_sync(kFull, free_before, lw);
      const int xw = lw * W;
      const int nv = n_colors - xw < W ? n_colors - xw : W;
      const int* rw = rowp + lw * rslot;
      const float* pw = pe_s + lw * slot;
      chosen = -1;
      q_chosen = 0.0f;
      float q_last = 0.0f;
      for (int t = 0; t < nv; t += 32) {
        const int j = t + lane;
        const bool in = j < nv;
        const bool occ = in && rw[j] > 0;
        float jf = 0.0f;
        if (kind == kDecrease) {
          const unsigned fm = __ballot_sync(kFull, in && !occ);
          jf = static_cast<float>(f + __popc(fm & le_mask)) - 1.0f;
          f += __popc(fm);
        }
        const float q = in ? q_of(s, xw + j, occ, jf, pw[j]) : 0.0f;
        const float cdf = cdf0 + warp_inclusive_scan(q, lane);
        const unsigned h = __ballot_sync(kFull, in && !(cdf < u));
        if (h) {
          const int l = __ffs(h) - 1;
          chosen = xw + t + l;
          q_chosen = __shfl_sync(kFull, q, l);
          break;
        }
        const int last = nv - 1 - t;
        q_last = __shfl_sync(kFull, q, last < 31 ? last : 31);
        cdf0 = __shfl_sync(kFull, cdf, 31);
      }
      if (chosen < 0) {  // the lane's share reached u, its walk fell short by rounding
        chosen = xw + nv - 1;
        q_chosen = q_last;
      }
    } else {  // overflow: the last colour (_standard.cu:50-58)
      chosen = n_colors - 1;
      const int seg = chosen / W, off = chosen % W;
      q_chosen = q_of(s, chosen, rowp[seg * rslot + off] > 0,
                      static_cast<float>(n_free_all) - 1.0f, pe_s[seg * slot + off]);
    }
    if (lane == 0) {
      star[row] = is_real ? chosen : own;
      qstar[row] = is_real ? q_chosen : 1.0f;
      new_taboo[row] = chosen == own ? taboo_iterations : 0;
    }
  }
  if (lane == 0) s_conf[warp] = conf;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < warps; ++w) total += s_conf[w];
    if (total) atomicAdd(conf2, total);
  }
}

}  // namespace

extern "C" {

// Launches K4 on `stream`; returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not
// take: n_col_pad not a positive multiple of 128, n_colors outside [1,
// n_col_pad], 1 to 65535 chains, or p_eff's slots not in a block's shared
// memory (n_col_pad above 57,984).  Rows are staged in shared memory where
// two rows' slots fit beside p_eff's (n_col_pad up to 28,800), else read
// in place.  Pointers are device pointers.  nc is [n_chains,
// n_rows, n_col_pad] int32, 16-byte aligned; cur, taboo, unif and the
// outputs star, new_taboo, qstar are [n_chains, n_rows]; real is [n_rows]
// bytes (0 or 1); p_eff is [n_chains, n_colors] float32, or null for
// STANDARD; eps is one float32; conf2 is [n_chains] int64, zeroed by the
// caller, to which the launch adds.
int propose_nc_launch(const void* nc, const void* cur, const void* taboo, const void* unif,
                      const void* real, const void* p_eff, const void* eps, void* star,
                      void* new_taboo, void* qstar, void* conf2, int n_rows, int n_col_pad,
                      int n_colors, int kind, float lam, int lam_zero, int taboo_iterations,
                      int n_chains, void* stream) {
  const int w = n_col_pad / 32;
  const int slot = w % 8 == 0 ? w + 4 : w;  // words a lane's colours take
  const size_t row_bytes = static_cast<size_t>(32) * slot * sizeof(int);
  const size_t fit = row_bytes > 0 ? kSmemMax / row_bytes : 0;  // p_eff and the rows
  if (n_rows < 0 || n_col_pad <= 0 || n_col_pad % 128 != 0 || n_colors < 1 ||
      n_colors > n_col_pad || n_chains < 1 || n_chains > 65535 || fit < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const bool staged = fit >= 2;
  const int warps = !staged || fit - 1 >= static_cast<size_t>(kMaxWarps)
                        ? kMaxWarps : static_cast<int>(fit - 1);
  const size_t smem = row_bytes * (staged ? 1 + warps : 1);
  auto kernel = staged ? propose_nc_kernel<true> : propose_nc_kernel<false>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave of blocks over all chains, each chain its share
  const int need = (n_rows + warps - 1) / warps;
  int grid = sms * (per_sm > 0 ? per_sm : 1) / n_chains;
  grid = grid < 1 ? 1 : (grid > need ? need : grid);
  kernel<<<dim3(grid, n_chains), warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nc), static_cast<const int*>(cur),
      static_cast<const int*>(taboo), static_cast<const float*>(unif),
      static_cast<const uint8_t*>(real), static_cast<const float*>(p_eff),
      static_cast<const float*>(eps), static_cast<int*>(star), static_cast<int*>(new_taboo),
      static_cast<float*>(qstar), static_cast<unsigned long long*>(conf2), n_rows, n_col_pad,
      n_colors, slot, kind, lam, lam_zero, taboo_iterations);
  return static_cast<int>(cudaGetLastError());
}

const char* propose_nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
