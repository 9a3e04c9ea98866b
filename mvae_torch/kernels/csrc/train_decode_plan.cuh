// Tile plan and index math of the training decode kernel (train_decode.cu),
// shared by its launcher and the host-side test; the Python mirror is
// decoder_kernels.train_tile_plan.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define TD_BM 16      // batch rows per block
#define TD_BN 32      // pixels per block
#define TD_WS 40      // shared row of W2 and of a partial tile: 32 + 8 words
#define TD_KC 16      // hidden units per W2 stage: two 8-deep mma steps
#define TD_WARPS 4    // warp w takes the mma steps k with k % 4 == w
#define TD_NT (32 * TD_WARPS)
#define TD_RING 4     // W2 stages in flight when a whole slice does not fit
#define TD_SMEM_LIMIT 232320  // a block's 232,448 bytes, 128 kept for static

// How a block gets W2's slice: every stage resident, by the Tensor Memory
// Accelerator (D % 4 == 0, whole 16-byte rows) or by cp.async copies; or a
// ring of TD_RING stages by cp.async copies.
enum { TD_FETCH_TMA = 0, TD_FETCH_COPY = 1, TD_FETCH_RING = 2 };

struct TdPlan {
  int row_tiles, pixel_tiles, stages, slots, hp, fetch;
  size_t smem, part;
};

// The row stride of h in shared memory: the stages' hidden units, made an
// odd number of 16-byte words, so that the 8 rows of an mma fragment's
// load fall in 8 distinct bank quads.
static inline __host__ __device__ int td_hp(int H) {
  const int q = (H + TD_KC - 1) / TD_KC * TD_KC / 4;
  return 4 * (q | 1);
}

// Dynamic shared memory (bytes) with `slots` W2 stages resident: the
// stages, h for the block's rows, the z tile, and the 4 warps' partial
// tiles.
static inline __host__ __device__ size_t td_smem(int Z, int H, int slots) {
  return sizeof(float) *
         ((size_t)slots * TD_KC * TD_WS + (size_t)TD_BM * td_hp(H) +
          (size_t)Z * TD_BM + (size_t)TD_WARPS * TD_BM * TD_WS);
}

// The launch of (B, Z, H, D): every W2 stage resident when the slice
// fits, otherwise a ring of TD_RING stages. Returns 0 when even the ring
// does not fit (or a width is 0).
static inline __host__ __device__ int td_plan(int B, int Z, int H, int D,
                                              TdPlan* p) {
  if (B < 0 || Z < 1 || H < 1 || D < 1) return 0;
  p->stages = (H + TD_KC - 1) / TD_KC;
  p->slots = td_smem(Z, H, p->stages) <= TD_SMEM_LIMIT ? p->stages : TD_RING;
  p->hp = td_hp(H);
  p->smem = td_smem(Z, H, p->slots);
  p->row_tiles = (B + TD_BM - 1) / TD_BM;
  p->pixel_tiles = (D + TD_BN - 1) / TD_BN;
  p->fetch = p->slots < p->stages ? TD_FETCH_RING
             : D % 4 == 0         ? TD_FETCH_TMA
                                  : TD_FETCH_COPY;
  p->part = (size_t)p->row_tiles * p->pixel_tiles * TD_BM;
  return p->smem <= TD_SMEM_LIMIT;
}

// The share of a row tile's h (its `rows` x H block, contiguous in global
// memory) that pixel tile `pt` of `npt` stores: entries [lo, hi), in
// chunks that are a multiple of 4 entries, so a float4 never straddles two
// shares when H % 4 == 0.
static inline __host__ __device__ void td_share(int rows, int H, int npt,
                                                int pt, int* lo, int* hi) {
  const int total = rows * H;
  const int chunk = ((total + npt - 1) / npt + 3) / 4 * 4;
  const int a = pt * chunk, b = a + chunk;
  *lo = a < total ? a : total;
  *hi = b < total ? b : total;
}
