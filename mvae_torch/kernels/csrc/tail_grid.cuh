// The launch geometry of the tail kernels (tail_fwd.cu, tail_bwd.cu), which
// the tail's I/O skeleton (roofline_probes.cu) takes as well.
//
// A product of normal, wrapped-hyperboloid and vMF components (the
// flagship's kinds): a warp runs one component for 32 batch rows, a row per
// lane, so a tile's kind and dimension are uniform across the warp, and a
// row's components run side by side in warps of their own: the row's chain
// is its longest tile instead of the sum of its tiles.
//  - The forward's grid: a block holds TAIL_ROWS = 32 rows, its warp w the
//    rows' components w, w + warps, ... (warps = min(nc, TAIL_MAX_WARPS)),
//    so that the sums over the components (sum log q, sum log p) go
//    through the block's shared memory in component order.
//  - The backward's grid (below): a block holds up to TAIL_GROUPS warps of
//    one component (blockIdx.y). It has no sum over the components; its
//    fold of the curvature gradients over the batch goes through shared
//    memory in a fixed order, and across blocks only above 256 rows.
//
// A product with a stereographic (d/p/u) or embedded-sphere (s) component,
// whose tile is one long chain of transcendentals a row, takes the split
// geometry: TAIL_LANES threads a row, TAIL_SPLIT_ROWS rows a block, a row's
// work spread over its threads in phases (tail_tiles.cuh: split_coord, the
// mean head, the owner's draw, split_lq_prep, split_branch_fwd), the values
// handed over through the block's shared memory.
//  - The forward: a block holds every component of its rows. Phase 0 runs
//    every other component's whole tile and, of every split component, its
//    coordinates and its mean head, an item a thread; phase 1 each split
//    component's owner (the draw) beside its drawn-radius sum's inputs;
//    phase 2 the sums' terms; phase 3 (item 0 of a row) the log-sum-exps
//    and the sums over the components in order.
//  - The backward: a block holds one component (blockIdx.y) of its rows,
//    grid (ceil(B / TAIL_SPLIT_ROWS), nc), in seven phases (tail_bwd.cu);
//    the other components' blocks run the warp-a-component rows above
//    (those past their rows return). A split component's fold goes
//    through the ticket: its last block sums the rows' curvature gradients
//    from dk_rows in the same fixed order.
//
// Every kernel of this geometry is a sequence of per-thread phases
// separated by __syncthreads(); each phase is a device function of (block,
// thread) and the block's shared memory (in the split backward also of the
// owner's saved intermediates, which a thread keeps in registers from one
// phase to the next), so the host harness of tests/test_torch_csrc_host.py
// runs a block by calling each phase for every thread in turn. No
// warp-level collective is used.

#pragma once

#include "tail_tiles.cuh"

#define TAIL_ROWS 32
#define TAIL_MAX_WARPS 8
#define TAIL_THREADS (TAIL_ROWS * TAIL_MAX_WARPS)
#define TAIL_LANES 16
#define TAIL_SPLIT_ROWS (TAIL_THREADS / TAIL_LANES)

// Whether a product takes the split geometry
static inline __host__ __device__ bool tail_any_split(const TailTable& t) {
  return t.nsplit > 0;
}

static inline __host__ __device__ int tail_split_blocks(int B) {
  return (B + TAIL_SPLIT_ROWS - 1) / TAIL_SPLIT_ROWS;
}

// Thread tid of a split block serves the block's row tid % TAIL_SPLIT_ROWS
// and runs that row's work items it, it + TAIL_LANES, ... from it =
// tail_split_item(tid): item i on slot tid / TAIL_SPLIT_ROWS = (i % 8) 2 +
// i / 8, so a warp holds two slots of all the block's rows and a row's
// first 8 items (its owners, its first 8 branches) run in 8 warps
__device__ __forceinline__ int tail_split_row(int tid) {
  return tid % TAIL_SPLIT_ROWS;
}

__device__ __forceinline__ int tail_split_item(int tid) {
  const int slot = tid / TAIL_SPLIT_ROWS;
  return (slot % 2) * (TAIL_LANES / 2) + slot / 2;
}

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

// One component's forward tile for one row, by the table's kind (the
// kinds that run a row on one thread): z, and kl, log q, log p
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
    default: {
      VmfSaved s;
      tile_vmf_s2(r, e, k, z, kl, q, p, s);
    }
  }
}

// The component of work item `it` in a table's item prefix `off`
__device__ __forceinline__ int tail_item_comp(const int* off, int it) {
  int i = 0;
  while (it >= off[i + 1]) ++i;
  return i;
}

// --- the split forward (B1): phases of a block of TAIL_SPLIT_ROWS rows ------
// Thread tid serves row g = tail_split_row(tid), whose floats start at sh +
// g t.row_floats, from item tail_split_item(tid) on. A split component's
// floats start at its soff: coordinates (CO_FWD a coordinate), the owner's
// staged inputs, the mean head, the branch area.
__device__ __forceinline__ float* split_in(float* base, int n, int cf) {
  return base + cf * n;
}
__device__ __forceinline__ float* split_hd(float* base, int n, int cf) {
  return base + (cf + 2) * n;
}
__device__ __forceinline__ float* split_br(float* base, int n, int cf) {
  return base + (cf + 2) * n + HD_N;
}

// Phase 0: every other component's whole tile (kl into aux, log q and log
// p into the row's floats), every split component's coordinates (each
// coordinate's lane staging the owner's inputs at it) and its mean head
template <int D>
__device__ __forceinline__ void fwd_split_coords(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, float* __restrict__ z,
    float* __restrict__ aux, int B, int W, int E, int Z, const TailTable& t,
    int block, int tid, float* sh) {
  const int g = tail_split_row(tid), row = block * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  const int nc = t.nc;
  float* rs = sh + g * t.row_floats;
  for (int it = tail_split_item(tid); it < t.item0[nc]; it += TAIL_LANES) {
    const int i = tail_item_comp(t.item0, it);
    const float* r = raw + (size_t)row * W + t.raw_off[i];
    if (!t.split[i]) {
      float kl, q, p;
      fwd_tile<D>(t, i, r, eps + (size_t)row * E + t.eps_off[i], kvec[i],
                  z + (size_t)row * Z + t.z_off[i], &kl, &q, &p);
      aux[(size_t)row * (nc + 2) + i] = kl;
      rs[i] = q;
      rs[nc + i] = p;
      continue;
    }
    const int n = t.dim[i], j = it - t.item0[i];
    float* base = rs + t.soff[i];
    if (j == n) {
      if (t.kind[i] == KIND_WRAPPED_STEREO)
        stereo_head(r, n, t.sign[i], kvec[i], split_hd(base, n, CO_FWD));
      else
        sphere_head(r, n, kvec[i], split_hd(base, n, CO_FWD));
      continue;
    }
    float* in = split_in(base, n, CO_FWD);
    in[j] = r[j];
    in[n + j] = eps[(size_t)row * E + t.eps_off[i] + j];
    split_coord(t.kind[i], t.sign[i], r, n, t.nscale[i], kvec[i], j, CO_FWD,
                base);
  }
}

// Phase 1: item o < nsplit the owner of the o-th split component, which
// draws z (and, where the sums do not split, sums them: log q and log p
// into the row's floats); item nsplit + o that component's drawn-radius
// sum inputs (split_lq_prep)
template <int D>
__device__ __forceinline__ void fwd_split_owners(
    const float* __restrict__ kvec, float* __restrict__ z, int B, int Z,
    const TailTable& t, int block, int tid, float* sh) {
  const int g = tail_split_row(tid), row = block * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  const int nc = t.nc;
  float* rs = sh + g * t.row_floats;
  for (int o = tail_split_item(tid); o < 2 * t.nsplit; o += TAIL_LANES) {
    const int i = t.owner[o % t.nsplit], n = t.dim[i];
    float* base = rs + t.soff[i];
    const float* mt = split_in(base, n, CO_FWD);
    const bool stereo = t.kind[i] == KIND_WRAPPED_STEREO;
    if (o >= t.nsplit) {
      split_lq_prep(n, tail_branch_sign(t, i), t.wraps[i],
                    stereo ? kvec[i] : fmaxf(kvec[i], TINY), base, mt + n,
                    split_br(base, n, CO_FWD));
      continue;
    }
    float* zr = z + (size_t)row * Z + t.z_off[i];
    float q, p;
    if (stereo) {
      StereoHead<D> h;
      StereoSaved<D> s;
      stereo_owner_fwd<D>(mt, mt + n, n, t.sign[i], kvec[i], base,
                          split_hd(base, n, CO_FWD), zr,
                          split_br(base, n, CO_FWD), h, s);
      if (tail_branches(t, i)) continue;
      stereo_owner_sums<D>(n, t.sign[i], t.wraps[i], kvec[i], s, &q, &p);
    } else {
      SphSaved<D> s;
      sphere_owner_fwd<D>(mt, mt + n, n, kvec[i], base,
                          split_hd(base, n, CO_FWD), zr,
                          split_br(base, n, CO_FWD), s);
      if (tail_branches(t, i)) continue;
      sphere_owner_sums<D>(n, t.wraps[i], s, &q, &p);
    }
    rs[i] = q;
    rs[nc + i] = p;
  }
}

// Phase 2: the terms of the split sums, a term a lane
__device__ __forceinline__ void fwd_split_branches(int B, const TailTable& t,
                                                   int block, int tid,
                                                   float* sh) {
  const int g = tail_split_row(tid), row = block * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  float* rs = sh + g * t.row_floats;
  for (int it = tail_split_item(tid); it < t.item2[t.nc]; it += TAIL_LANES) {
    const int i = tail_item_comp(t.item2, it), n = t.dim[i];
    split_branch_fwd(n, tail_branch_sign(t, i), t.wraps[i], it - t.item2[i],
                     split_br(rs + t.soff[i], n, CO_FWD));
  }
}

// Phase 3, item 0 of a row: the split sums and kl of each split component,
// and sum log q, sum log p over the components in order (the plain
// version's lq = lq + q)
__device__ __forceinline__ void fwd_split_sums(float* __restrict__ aux, int B,
                                               const TailTable& t, int block,
                                               int tid, const float* sh) {
  const int g = tail_split_row(tid), row = block * TAIL_SPLIT_ROWS + g;
  if (tail_split_item(tid) != 0 || row >= B) return;
  const int nc = t.nc;
  const float* rs = sh + g * t.row_floats;
  float* ar = aux + (size_t)row * (nc + 2);
  float lq = 0.f, lp = 0.f;
  for (int i = 0; i < nc; ++i) {
    float q = rs[i], p = rs[nc + i];
    if (tail_branches(t, i))
      split_sums(tail_branch_sign(t, i), t.wraps[i],
                 rs + t.soff[i] + (CO_FWD + 2) * t.dim[i] + HD_N, &q, &p);
    if (t.split[i]) ar[i] = q - p;
    lq = lq + q;
    lp = lp + p;
  }
  ar[nc] = lq;
  ar[nc + 1] = lp;
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

// The split component's fold, by its last block, TAIL_FOLD_CHUNK rows at a
// time from r0: the chunk's dk_rows staged in shared memory `buf` (every
// thread loading rows at once), each group of 32 rows summed in row order
// by a thread of its own (in place, at the group's first row), then the
// groups added in order to the running sum `total` (the first group of the
// first chunk starting it), which the last chunk writes to dk[c] and whose
// counter it resets: the order of tail_fold_groups / tail_fold_direct
#define TAIL_FOLD_CHUNK (TAIL_THREADS * TAIL_GROUPS * 2)

__device__ __forceinline__ void tail_split_fold_stage(
    int B, int nc, int c, int r0, int tid, const float* dk_rows, float* buf) {
  const int rows = min(TAIL_FOLD_CHUNK, B - r0);
  for (int r = tid; r < rows; r += TAIL_THREADS)
    buf[r] = __ldcg(&dk_rows[(size_t)(r0 + r) * nc + c]);
}

__device__ __forceinline__ void tail_split_fold_groups(int B, int r0, int tid,
                                                       float* buf) {
  const int rows = min(TAIL_FOLD_CHUNK, B - r0), g0 = tid * TAIL_ROWS;
  if (g0 >= rows) return;
  const int n = min(TAIL_ROWS, rows - g0);
  float v[TAIL_ROWS];  // the group's values loaded at once, then added
  #pragma unroll
  for (int r = 0; r < TAIL_ROWS; ++r) v[r] = r < n ? buf[g0 + r] : 0.f;
  float s = v[0];
  #pragma unroll
  for (int r = 1; r < TAIL_ROWS; ++r)
    if (r < n) s = s + v[r];
  buf[g0] = s;
}

__device__ __forceinline__ void tail_split_fold_total(int B, int c, int r0,
                                                      int tid,
                                                      const float* buf,
                                                      float* total, float* dk,
                                                      unsigned* counter) {
  if (tid != 0) return;
  const int rows = min(TAIL_FOLD_CHUNK, B - r0);
  float s = r0 == 0 ? buf[0] : *total + buf[0];
  for (int g0 = TAIL_ROWS; g0 < rows; g0 += TAIL_ROWS) s = s + buf[g0];
  *total = s;
  if (r0 + rows >= B) {
    dk[c] = s;
    counter[c] = 0u;
  }
}
