// Frozen copy of mvae_torch/kernels/csrc/tail_grid.cuh as it stood at commit
// b875f52: the tail kernels' previous design (every product on the
// warp-a-component geometry, each tile serial on one thread), built beside
// the package's kernels to hold them bit for bit and time them in turns
// (chip_smoke.py, scripts/torch_tail_turns.py, tests). Not part of the
// package.
//
// The launch geometry of the tail kernels (tail_fwd.cu, tail_bwd.cu), which
// the tail's I/O skeleton (roofline_probes.cu) takes as well. A warp runs
// one component for 32 batch rows, a row per lane, so a tile's kind and
// dimension are uniform across the warp, and a row's components run side
// by side in warps of their own: the row's chain is its longest tile
// instead of the sum of its tiles.
//  - The forward's grid: a block holds TAIL_ROWS = 32 rows, its warp w the
//    rows' components w, w + warps, ... (warps = min(nc, TAIL_MAX_WARPS)),
//    so that the sums over the components (sum log q, sum log p) go
//    through the block's shared memory in component order.
//  - The backward's grid (below): a block holds up to TAIL_GROUPS warps of
//    one component (blockIdx.y). It has no sum over the components; its
//    fold of the curvature gradients over the batch goes through shared
//    memory in a fixed order, and across blocks only above 256 rows.
//
// Every kernel of this geometry is a sequence of per-thread phases
// separated by __syncthreads(); each phase is a device function of (block,
// thread) and the block's shared memory, so the host harness of
// tests/test_torch_csrc_host.py runs a block by calling each phase for
// every thread in turn. No warp-level collective is used.

#pragma once

#include "tail_tiles.cuh"

#define TAIL_ROWS 32
#define TAIL_MAX_WARPS 8
#define TAIL_THREADS (TAIL_ROWS * TAIL_MAX_WARPS)

// Warps of a forward block for nc components
static inline __host__ __device__ int tail_warps(int nc) {
  return nc < TAIL_MAX_WARPS ? nc : TAIL_MAX_WARPS;
}

static inline __host__ __device__ int tail_blocks(int B) {
  return (B + TAIL_ROWS - 1) / TAIL_ROWS;
}

// The dimension class of a product: D when every component that holds
// vectors (wrapped on h, d/p/u or s) has dimension D in {2, 3, 6}, else 0
// (the generic instantiation). The normal and vMF tiles take any.
static inline int tail_dim_class(const TailTable& t) {
  int d = -1;
  for (int i = 0; i < t.nc; ++i) {
    if (t.kind[i] == KIND_NORMAL || t.kind[i] == KIND_VMF_S2) continue;
    if (d == -1) {
      d = t.dim[i];
    } else if (d != t.dim[i]) {
      return 0;
    }
  }
  if (d == -1) d = 2;  // no vector tile: any instantiation serves
  return (d == 2 || d == 3 || d == 6) ? d : 0;
}

// One component's forward tile for one row, by the table's kind: z, and kl,
// log q, log p
template <int D>
__device__ __forceinline__ void fwd_tile(const TailTable& t, int i,
                                         const float* r, const float* e,
                                         float k, float* z, float* kl,
                                         float* q, float* p) {
  const int n = t.dim[i], ns = t.nscale[i];
  switch (t.kind[i]) {
    case KIND_NORMAL:
      tile_normal(r, e, n, ns, z, kl, q, p);
      break;
    case KIND_WRAPPED_H: {
      HSaved<D> s;
      tile_wrapped_h<D>(r, e, n, ns, k, z, kl, q, p, s);
      break;
    }
    case KIND_VMF_S2: {
      VmfSaved s;
      tile_vmf_s2(r, e, k, z, kl, q, p, s);
      break;
    }
    case KIND_WRAPPED_STEREO: {
      StereoHead<D> h;
      StereoSaved<D> s;
      tile_wrapped_stereo<D>(r, e, n, ns, t.sign[i], t.wraps[i], k, z, kl, q,
                             p, h, s);
      break;
    }
    default: {
      SphSaved<D> s;
      tile_wrapped_sphere<D>(r, e, n, ns, t.wraps[i], k, z, kl, q, p, s);
    }
  }
}

// The backward's grid: a block holds TAIL_GROUPS groups of 32 rows of one
// component (blockIdx.y), a warp a group. The backward has no sum across
// components, so its fold of the per-row curvature gradients over the
// batch stays inside one block at the training batch (B <= 256).
#define TAIL_GROUPS 8

static inline __host__ __device__ int tail_bwd_blocks(int B) {
  return (B + TAIL_GROUPS * TAIL_ROWS - 1) / (TAIL_GROUPS * TAIL_ROWS);
}

static inline __host__ __device__ int tail_bwd_threads(int B) {
  const int groups = tail_blocks(B);
  return TAIL_ROWS * (groups < TAIL_GROUPS ? groups : TAIL_GROUPS);
}

// The fold over the batch, in a fixed order: each group of 32 rows summed
// in row order (tail_fold_groups), then the groups' sums in group order.
// With one block a component the block's thread 0 takes the second sum
// (tail_fold_direct); with more, every block publishes its groups' sums,
// fences and takes a ticket on its component's counter (tail_fold_publish,
// tail_fold_ticket), and the component's last block takes the second sum
// and sets the counter back to 0 for the next call or graph replay
// (tail_fold_last). `sh` holds (TAIL_GROUPS, TAIL_ROWS) per-row values,
// `gs` the block's group sums, `part` (groups, nc).
__device__ __forceinline__ void tail_fold_groups(int B, int bx, int tid,
                                                 const float* sh, float* gs) {
  const int g = bx * TAIL_GROUPS + tid;
  if (tid >= TAIL_GROUPS || g * TAIL_ROWS >= B) return;
  const int rows = min(TAIL_ROWS, B - g * TAIL_ROWS);
  float s = sh[tid * TAIL_ROWS];
  for (int r = 1; r < rows; ++r) s = s + sh[tid * TAIL_ROWS + r];
  gs[tid] = s;
}

__device__ __forceinline__ void tail_fold_direct(int B, int c, int tid,
                                                 const float* gs, float* out) {
  if (tid != 0) return;
  float s = gs[0];
  for (int w = 1; w < tail_blocks(B); ++w) s = s + gs[w];
  out[c] = s;
}

__device__ __forceinline__ void tail_fold_publish(int B, int nc, int c,
                                                  int bx, int tid,
                                                  const float* gs,
                                                  float* part) {
  const int g = bx * TAIL_GROUPS + tid;
  if (tid >= TAIL_GROUPS || g * TAIL_ROWS >= B) return;
  part[(size_t)g * nc + c] = gs[tid];
  __threadfence();
}

__device__ __forceinline__ bool tail_fold_ticket(unsigned* counter,
                                                 int blocks) {
  return atomicAdd(counter, 1u) == (unsigned)(blocks - 1);
}

__device__ __forceinline__ void tail_fold_last(int B, int nc, int c, int tid,
                                               const float* part, float* out,
                                               unsigned* counter) {
  if (tid != 0) return;
  float s = __ldcg(&part[c]);
  for (int g = 1; g < tail_blocks(B); ++g)
    s = s + __ldcg(&part[(size_t)g * nc + c]);
  out[c] = s;
  counter[c] = 0u;
}
