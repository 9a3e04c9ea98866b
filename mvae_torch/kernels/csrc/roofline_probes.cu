// Roofline probes: the kernels that measure what this card can reach, and
// the floors of the port's memory-bound kernels, for kernels/roofline.py.
//
// Replace the TPU kernels of mvae_tpu/kernels/roofline.py:
//   probe_triad_kernel      _calibrate_once.triad (_triad_kernel)   B8b
//   probe_fma_kernel        _elementwise_call(_fma_kernel)          B8a
//   probe_tanh_kernel       _elementwise_call(_tanh_kernel)         B8a
//   probe_reduce_kernel     _elementwise_call(_reduce_kernel)       B8a
//   probe_transpose_kernel  _elementwise_call(_transpose_kernel)    B8a
//   skel_dist_kernel        _skel_dist ("rowstore", "block")        B8c
//   skel_reparam_kernel     _skel_reparam                           B8d
//   twin_stereo_resident_kernel, twin_stereo_kernel
//                           _twin_stereo (resident; streaming)      B8e
//   twin_reparam_kernel     _twin_reparam                           B8f
// and one probe the TPU harness has no counterpart of:
//   skel_tail_fwd_kernel    the tail's I/O skeleton, the floor of B1
//   skel_tail_bwd_kernel    the same for B3
// Each computes what its TPU probe computes, with two deliberate
// differences. The FMA and tanh probes take an integer `repeat` that runs
// their chain block `repeat` times before the store: at repeat = 1 (the TPU
// function) the FMA probe does 16 FLOP a byte, below this card's FP32
// balance point (67 TFLOP/s over 3.35 TB/s = 20), so it would measure the
// memory. The distance skeleton folds every word it reads into its row's
// output: a TPU block copy moves the whole block whatever the body reads,
// but nvcc deletes a load whose value is unused, so a skeleton that read
// one word would time an empty launch.
//
// Bound: triad, reduce, transpose and the skeletons by bytes (they do one
// operation a word or less); fma and tanh by operations at repeat >= 2; the
// resident stereographic twin by operations (it reads one 2 MB tile and
// does ~500 FMA issue slots a row: 3 n Gram FMAs and a tail whose sqrt,
// reciprocals and exp are priced at the SASS instructions of their common
// path); the
// streaming twin and the reparam twin by bytes (the reparam twin's ~1.4 us
// of operations at the production chunk are a third of its 4.3 us of
// bytes). Each probe is timed whole: its launch time, not a per-block
// cost, is the floor it stands for.
//
// Design: 16-byte loads throughout. The FMA and tanh probes stride a grid of
// eight 256-thread blocks per SM over float4 words. The triad keeps
// TRIAD_UNROLL words of each input in flight a thread, with streaming cache
// hints, a block a tile of 1024 words (the rate must come from bytes in
// flight: it prices every bytes floor of the port; a grid of 1, 2 or 4 full
// waves that strides over the tiles reads 2-4% slower on the H100). The row
// probes take the launch shape of the kernel they price: the distance kernels'
// (manifold_dist.cu: 256 threads, one warp per row, float4 loads, xor
// butterfly sums, lane 0 stores) for reduce, the distance skeleton and the
// streaming stereographic twin; reparam_stereo.cu's (128 threads, one per
// example and 1 or 2 samples, the example index fastest, z written into rows
// z_off.. of an (S, Z, B) buffer, the noise read at eps_stride) for the
// reparam skeleton and twin. The resident stereographic twin takes the shape
// that runs a row's arithmetic fastest (its note below). The transpose probe
// stages a (256, 8) tile of each block's rows through shared memory, padded
// to 9 columns so that the transposed reads hit 32 different banks, eight
// times (one relayout for each of the TPU probe's eight). The tail skeleton
// takes the tail kernels' grid and their scalar loads and stores
// (tail_grid.cuh), so it is timed with the same launch, the same rows per
// block and the same fold: the split geometry for a product with a d/p/u or
// s component (a row's component on one thread of its 16, the split fold
// from dk_rows), or on request the warp-a-component one every product took
// before. Built without --fmad=false: the FMA probe times
// FFMA.
//
// Entry points (plain C, loaded with ctypes; each returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for a shape it does not take):
//   int probe_triad_launch(x, y, o, n, stream)                 n % 4 == 0
//   int probe_fma_launch(x, o, n, repeat, stream)              n % 4 == 0
//   int probe_tanh_launch(x, o, n, repeat, stream)             n % 4 == 0
//   int probe_reduce_launch(x, o (rows, cols), rows, cols, stream)
//   int probe_transpose_launch(x, o (rows, cols), rows, cols, stream)
//   int skel_dist_launch(x, y, out (rows,), rows, n, variant, stream)
//   int twin_stereo_launch(x, y, out (rows,), rows, n, resident, stream)
//   int skel_reparam_launch(eps, eps_stride, mu, sigma, hoist (3, B), k, zt,
//                           z_off, lq, lp, S, B, n, Z, spt, stream)
//   int twin_reparam_launch(the same arguments)
//   int skel_tail_launch(raw, eps, kvec, dz, daux, out, out_c, dk, part,
//                        counter, B, W, E, Z, nc, bwd, warp, table, stream):
//     with bwd = 0 the arguments of tail_fwd_launch (out = z, out_c = aux;
//     dz, daux, dk, part and counter unused), with bwd = 1 those of
//     tail_bwd_launch (out = draw, out_c = dk_rows); warp = 1 takes the
//     warp-a-component geometry whatever the product
// Row probes take cols % 4 == 0 (and cols >= 8 for transpose) with 16-byte
// aligned bases; the distance skeleton and twin read rows of any width.

#include <cuda_runtime.h>
#include <math.h>

#include "tail_grid.cuh"

#define ELEM_THREADS 256
#define ELEM_BLOCKS_PER_SM 8
#define ROW_THREADS 256
#define ROW_WARPS (ROW_THREADS / 32)
#define REP_THREADS 128   // reparam_stereo.cu's REPARAM_THREADS
#define REP_MAX_DIM 32
#define RESIDENT_ROWS 2048
#define TP_ROWS 256
#define TP_PAD 9

// Threads of a reparam probe's chunk: one per example and spt samples
__host__ __device__ inline long long rep_threads(int S, int B, int spt) {
  return (long long)((S + spt - 1) / spt) * B;
}

__device__ __forceinline__ float probe_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- elementwise probes ---------------------------------------------------

// 8 independent chains of 8 fused multiply-adds, `repeat` times, summed in
// the TPU probe's order
__device__ __forceinline__ float fma_word(float x, int repeat) {
  float a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = x + (float)j;
  for (int r = 0; r < repeat; ++r) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = fmaf(a[j], 1.0000001f, x);
    }
  }
  float acc = a[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) acc += a[j];
  return acc;
}

// 4 independent chains of 4 accurate tanh, `repeat` times
__device__ __forceinline__ float tanh_word(float x, int repeat) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = x + (float)j;
  for (int r = 0; r < repeat; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = tanhf(a[j]);
    }
  }
  return ((a[0] + a[1]) + a[2]) + a[3];
}

// --- triad (B8b) ---
// Each thread holds TRIAD_UNROLL 16-byte words of x and of y in flight before
// its first add: a block takes tiles of ELEM_THREADS * TRIAD_UNROLL words,
// word u of thread t at t + u * ELEM_THREADS (each load instruction of a warp
// covers 512 contiguous bytes), grid-stride over the tiles (the launcher gives
// a block a tile); it reads and writes with the evict-first cache hint
// (ld.global.cs / st.global.cs: every word is touched once, and the
// calibration's 1.6 GB rotates through the 50 MB L2 anyway). TRIAD_UNROLL
// exists to measure it (scripts/torch_reparam_phases.py).
#ifndef TRIAD_UNROLL
#define TRIAD_UNROLL 4
#endif

__global__ void __launch_bounds__(ELEM_THREADS)
probe_triad_kernel(const float4* __restrict__ x, const float4* __restrict__ y,
                   float4* __restrict__ o, long long n4) {
  const long long tile = (long long)ELEM_THREADS * TRIAD_UNROLL;
  for (long long base = (long long)blockIdx.x * tile + threadIdx.x;
       base < n4; base += (long long)gridDim.x * tile) {
    float4 a[TRIAD_UNROLL], b[TRIAD_UNROLL];
#pragma unroll
    for (int u = 0; u < TRIAD_UNROLL; ++u) {
      const long long i = base + (long long)u * ELEM_THREADS;
      if (i < n4) {
        a[u] = __ldcs(x + i);
        b[u] = __ldcs(y + i);
      }
    }
#pragma unroll
    for (int u = 0; u < TRIAD_UNROLL; ++u) {
      const long long i = base + (long long)u * ELEM_THREADS;
      if (i < n4) {
        float4 r;
        r.x = a[u].x + b[u].x;
        r.y = a[u].y + b[u].y;
        r.z = a[u].z + b[u].z;
        r.w = a[u].w + b[u].w;
        __stcs(o + i, r);
      }
    }
  }
}
// --- end triad ---

__global__ void __launch_bounds__(ELEM_THREADS)
probe_fma_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                 long long n4, int repeat) {
  const long long step = (long long)gridDim.x * ELEM_THREADS;
  for (long long i = (long long)blockIdx.x * ELEM_THREADS + threadIdx.x;
       i < n4; i += step) {
    const float4 a = x[i];
    float4 r;
    r.x = fma_word(a.x, repeat);
    r.y = fma_word(a.y, repeat);
    r.z = fma_word(a.z, repeat);
    r.w = fma_word(a.w, repeat);
    o[i] = r;
  }
}

__global__ void __launch_bounds__(ELEM_THREADS)
probe_tanh_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                  long long n4, int repeat) {
  const long long step = (long long)gridDim.x * ELEM_THREADS;
  for (long long i = (long long)blockIdx.x * ELEM_THREADS + threadIdx.x;
       i < n4; i += step) {
    const float4 a = x[i];
    float4 r;
    r.x = tanh_word(a.x, repeat);
    r.y = tanh_word(a.y, repeat);
    r.z = tanh_word(a.z, repeat);
    r.w = tanh_word(a.w, repeat);
    o[i] = r;
  }
}

// --- row probes (the distance kernels' launch shape) ----------------------

// 8 independent row sums of x + i, tree-added, broadcast over the row
__global__ void __launch_bounds__(ROW_THREADS)
probe_reduce_kernel(const float* __restrict__ x, float* __restrict__ o,
                    long long rows, int cols) {
  const long long row = (long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float4* xr = reinterpret_cast<const float4*>(x + row * cols);
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
  for (int j = lane; j < cols / 4; j += 32) {
    const float4 a = xr[j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float fi = (float)i;
      s[i] += ((a.x + fi) + (a.y + fi)) + ((a.z + fi) + (a.w + fi));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = probe_warp_sum(s[i]);
  float4 v;
  v.x = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  v.y = v.x;
  v.z = v.x;
  v.w = v.x;
  float4* orow = reinterpret_cast<float4*>(o + row * cols);
  for (int j = lane; j < cols / 4; j += 32) orow[j] = v;
}

// Every element of row r becomes sum_c sum_i (x[r, c] + i) over the first
// 8 columns (= 8 sum_c x[r, c] + 224), through eight relayouts of the
// block's (TP_ROWS, 8) tile in shared memory
__global__ void __launch_bounds__(TP_ROWS)
probe_transpose_kernel(const float* __restrict__ x, float* __restrict__ o,
                       long long rows, int cols) {
  __shared__ float tile[TP_ROWS * TP_PAD];
  __shared__ float val[TP_ROWS];
  const long long row0 = (long long)blockIdx.x * TP_ROWS;
  const int t = threadIdx.x;
  // two threads a row, one float4 (four of the eight columns) each
  float4 p[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t / 2 + h * (TP_ROWS / 2);
    if (row0 + r < rows) {
      p[h] = reinterpret_cast<const float4*>(x + (row0 + r) * cols)[t % 2];
    } else {
      p[h].x = p[h].y = p[h].z = p[h].w = 0.f;
    }
  }
  float a[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float fi = (float)i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = tile + (t / 2 + h * (TP_ROWS / 2)) * TP_PAD + 4 * (t % 2);
      dst[0] = p[h].x + fi;
      dst[1] = p[h].y + fi;
      dst[2] = p[h].z + fi;
      dst[3] = p[h].w + fi;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c) a[i][c] = tile[t * TP_PAD + c];
    __syncthreads();
  }
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    v += ((a[0][c] + a[1][c]) + (a[2][c] + a[3][c]))
         + ((a[4][c] + a[5][c]) + (a[6][c] + a[7][c]));
  val[t] = v;
  __syncthreads();
  // broadcast: warp w stores rows w, w + 8, ... with 16-byte stores
  const int lane = t % 32;
  for (int r = t / 32; r < TP_ROWS; r += TP_ROWS / 32) {
    if (row0 + r >= rows) break;
    float4 w;
    w.x = w.y = w.z = w.w = val[r];
    float4* orow = reinterpret_cast<float4*>(o + (row0 + r) * cols);
    for (int j = lane; j < cols / 4; j += 32) orow[j] = w;
  }
}

// The bytes floor of stereo_dist_kernel (variant 0, the TPU's "rowstore")
// and lorentz_dist_kernel (variant 1, "block"): the same reads and one
// store a row, each word folded with one add; variant 1 also re-reads
// x[r, 0] and y[r, 0] in lane 0, as the Lorentz kernel does
__global__ void __launch_bounds__(ROW_THREADS)
skel_dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, long long rows, int n, int vec4,
                 int variant) {
  const long long row = (long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* xr = x + row * n;
  const float* yr = y + row * n;
  float acc = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    for (int j = lane; j < n / 4; j += 32) {
      const float4 a = x4[j], b = y4[j];
      acc += a.x;
      acc += a.y;
      acc += a.z;
      acc += a.w;
      acc += b.x;
      acc += b.y;
      acc += b.z;
      acc += b.w;
    }
  } else {
    for (int j = lane; j < n; j += 32) {
      acc += xr[j];
      acc += yr[j];
    }
  }
  acc = probe_warp_sum(acc);
  if (lane == 0) out[row] = variant ? (acc + xr[0]) + yr[0] : acc;
}

// --- the stereographic twin (B8e) -------------------------------------------

// The tail's three transcendental steps, as the reference's chains take them
__host__ __device__ __forceinline__ float twin_sqrt_step(float t) {
  return sqrtf(fabsf(t) + 1e-6f);
}
__host__ __device__ __forceinline__ float twin_rcp_step(float t) {
  return 1.f / (fabsf(t) + 1.f);
}
__host__ __device__ __forceinline__ float twin_exp_step(float t) {
  return expf(-fabsf(t) * 1e-3f);
}

// Each step alone, built beside the probes only to count in SASS the
// instructions it takes (roofline.transcendental_instructions): a loop of
// 16 steps a trip and one of 32, so that the difference of the two loops'
// executed instructions over 16 is one step's, the loops' own counter and
// branch cancelling (never launched)
#define TWIN_PRICE(NAME, STEP)                                         \
  __global__ void NAME(float* o, int repeat) {                         \
    float t = o[threadIdx.x];                                          \
    _Pragma("unroll 1") for (int r = 0; r < repeat; ++r) {             \
      _Pragma("unroll") for (int j = 0; j < 16; ++j) t = STEP(t);      \
    }                                                                  \
    _Pragma("unroll 1") for (int r = 0; r < repeat; ++r) {             \
      _Pragma("unroll") for (int j = 0; j < 32; ++j) t = STEP(t);      \
    }                                                                  \
    o[threadIdx.x] = t;                                                \
  }
TWIN_PRICE(price_sqrt_kernel, twin_sqrt_step)
TWIN_PRICE(price_rcp_kernel, twin_rcp_step)
TWIN_PRICE(price_exp_kernel, twin_exp_step)

// The accurate sinf, cosf and logf the tail kernels' tiles take, priced the
// same way (roofline.tail_transcendental_prices): the steps keep their
// arguments where the common path runs (|t| <= 1, a normal log argument)
__host__ __device__ __forceinline__ float price_sin_step(float t) {
  return sinf(t);
}
__host__ __device__ __forceinline__ float price_cos_step(float t) {
  return cosf(t);
}
__host__ __device__ __forceinline__ float price_log_step(float t) {
  return logf(fabsf(t) + 2.f);
}
TWIN_PRICE(price_sin_kernel, price_sin_step)
TWIN_PRICE(price_cos_kernel, price_cos_step)
TWIN_PRICE(price_log_kernel, price_log_step)
#undef TWIN_PRICE

// The stereographic twin's scalar tail from a row's three Gram sums: the
// TPU probe's lower-bound op volume (_STWIN_PREFIX_OPS = 9, three chains
// of _STWIN_CHAIN_OPS = 18 with one sqrt, recip / exp each,
// _STWIN_MERGE_OPS = 4)
__host__ __device__ __forceinline__ float twin_stereo_tail(float r1,
                                                           float r2,
                                                           float r3) {
  float t = (r1 + r2 * 1.0000001f) + r3;
#pragma unroll
  for (int j = 0; j < 9; ++j) t = t * 1.0000001f + 0.1f;
  float ta = t, tb = t + 1.f, tc = t + 2.f;
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    if (j == 5) {
      ta = twin_sqrt_step(ta);
      tb = twin_sqrt_step(tb);
      tc = twin_sqrt_step(tc);
    } else if (j == 12) {
      ta = twin_rcp_step(ta);
      tb = twin_exp_step(tb);
      tc = twin_rcp_step(tc);
    } else {
      ta = ta * 1.0000001f + 0.1f;
      tb = tb * 1.0000002f + 0.1f;
      tc = tc * 1.0000003f + 0.1f;
    }
  }
  t = ta + tb * tc;
#pragma unroll
  for (int j = 0; j < 4; ++j) t = t * 1.0000001f + 0.1f;
  return t;
}

// The streaming twin, the compute floor of stereo_dist_kernel at its launch
// shape: a warp a row, three row Gram sums, the tail on lane 0. resident = 1
// reads row (r mod RESIDENT_ROWS) for output row r: the launcher takes it so
// only for rows wider than the resident kernel holds
__global__ void __launch_bounds__(ROW_THREADS)
twin_stereo_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, long long rows, int n, int vec4,
                   int resident) {
  const long long row = (long long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long src = resident ? row % RESIDENT_ROWS : row;
  const float* xr = x + src * n;
  const float* yr = y + src * n;
  float x2 = 0.f, y2 = 0.f, xy = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    for (int j = lane; j < n / 4; j += 32) {
      const float4 a = x4[j], b = y4[j];
      x2 += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
      y2 += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
      xy += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  } else {
    for (int j = lane; j < n; j += 32) {
      const float a = xr[j], b = yr[j];
      x2 += a * a;
      y2 += b * b;
      xy += a * b;
    }
  }
  x2 = probe_warp_sum(x2);
  y2 = probe_warp_sum(y2);
  xy = probe_warp_sum(xy);
  if (lane == 0) out[row] = twin_stereo_tail(x2, y2, xy);
}

// The resident twin, _twin_stereo(resident=True) of the TPU harness: the
// compute floor of stereo_dist_kernel. Bound: operations (per output row 3 n
// Gram FMAs and the tail, ~500 FMA issue slots at n = 128, against one 2 MB
// tile read and 4 bytes written). It prices the arithmetic of a distance row
// alone, so it takes the launch shape that runs that arithmetic fastest, not
// the distance kernel's: the previous design (a warp a row) re-read its tile
// row from L2 for every output row (1.07 GB a launch at 2^20 rows), spent 15
// shuffles a row on three butterfly sums and ran the tail on one lane in 32. A
// block stages TWIN_TILE consecutive rows of the 2048-row tile (x and y, at
// most 8 KB) in shared memory once, each row twin_stride(n) words apart so
// that the lanes' reads of it hit 32 different banks; each of its warps holds
// them in registers, TWIN_LANES lanes a row and cpl columns a lane (lane q of
// a row's group holds columns q, q + 4, q + 8, ..., zeros past n), and
// computes every output
// row src + 2048 m that reads them, TWIN_LANES copies m at a time, the block's
// warps taking turns over m. For each copy a lane forms its columns' three Gram
// sums (3 cpl FMAs), the group's four lanes reduce-scatter the copies' sums in
// two shuffle levels, so that lane q holds copy q's three row sums, and every
// lane runs the tail of its own output row: per lane and TWIN_LANES copies, one
// row's Gram FMAs and one tail. Each copy's sums start from zero * m, zero a
// kernel argument (0.0f) that the compiler cannot fold: no two output rows
// share a result, which the per-row loop's SASS instruction count shows
// (roofline.twin_row_instructions).
#define TWIN_LANES 4
#define TWIN_TILE (32 / TWIN_LANES)   // tile rows a block (and a warp) holds
#define TWIN_MAX_CPL 32
#define TWIN_MAX_STRIDE (TWIN_LANES * TWIN_MAX_CPL + TWIN_LANES)

// Columns a lane holds for rows of n <= TWIN_LANES * TWIN_MAX_CPL columns:
// the resident kernel's instantiations
__host__ __device__ inline int twin_cpl(int n) {
  return n <= 8 ? 2 : n <= 32 ? 8 : TWIN_MAX_CPL;
}

// Column i of lane q's columns (past n: a zero)
__host__ __device__ inline int twin_col(int q, int i) {
  return q + TWIN_LANES * i;
}

// Words between two staged rows of n columns: a multiple of 32 plus
// TWIN_LANES, so that lane (g, q) of a warp reads column q + 4 i of row g
// from bank 4 g + q + 4 i (mod 32): one bank a lane, no conflict (a row
// stride of 128 put all 32 lanes on one bank)
__host__ __device__ inline int twin_stride(int n) {
  return 32 * ((n + 31) / 32) + TWIN_LANES;
}

// Output rows that read tile row src: src + 2048 m for m < twin_copies
// (rows < 2^42)
__host__ __device__ inline int twin_copies(long long rows, int src) {
  return src < rows ? (int)((rows - 1 - src) / RESIDENT_ROWS + 1) : 0;
}

// Word i of a block's staged tile rows src0 .. src0 + TWIN_TILE - 1 of x
// (n words a row; zeros past the tile's rows)
__host__ __device__ inline float twin_staged(const float* x, int src0,
                                             long long tile, int n, int i) {
  const long long at = (long long)src0 * n + i;
  return at < tile * n ? x[at] : 0.f;
}

// Lane q's columns of a staged row (xr, yr: n words each)
template <int CPL>
__host__ __device__ inline void twin_lane_load(const float* xr,
                                               const float* yr, int n, int q,
                                               float* xv, float* yv) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = twin_col(q, i);
    xv[i] = c < n ? xr[c] : 0.f;
    yv[i] = c < n ? yr[c] : 0.f;
  }
}

// A lane's three Gram sums x.x, y.y, x.y over its columns, from z0
template <int CPL>
__host__ __device__ inline void twin_lane_gram(const float* xv,
                                               const float* yv, float z0,
                                               float* p) {
  float a = z0, b = z0, c = z0;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    a = fmaf(xv[i], xv[i], a);
    b = fmaf(yv[i], yv[i], b);
    c = fmaf(xv[i], yv[i], c);
  }
  p[0] = a;
  p[1] = b;
  p[2] = c;
}

// One level of the group's reduce-scatter: of a pair of partial sums the
// lane keeps the upper one if `upper`, else the lower, and gives its
// partner the other
__host__ __device__ inline void twin_split(bool upper, float lo, float hi,
                                           float* keep, float* give) {
  *keep = upper ? hi : lo;
  *give = upper ? lo : hi;
}

// The group's reduce-scatter: p[j] are lane q's partial sums of copy j;
// level 1 (partner q ^ 2) keeps copies (q & 2) + h, level 2 (partner q ^ 1)
// copy q. s = copy q's row sums, (p_0 + p_2) + (p_1 + p_3) over the group's
// lanes' partials, each pair in some order. shfl(v, mask) is lane
// q ^ mask's v
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Shfl>
__host__ __device__ __forceinline__ void twin_group_sums(float (*p)[3], int q,
                                                         Shfl& shfl,
                                                         float* s) {
  float a[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float keep, give;
      twin_split(q & 2, p[h][k], p[2 + h][k], &keep, &give);
      a[h][k] = keep + shfl(give, 2);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float keep, give;
    twin_split(q & 1, a[0][k], a[1][k], &keep, &give);
    s[k] = keep + shfl(give, 1);
  }
}

// A block's staging of its tile rows src0 .. src0 + TWIN_TILE - 1 into sx,
// sy (twin_stride(n) words a row): thread tid of `threads` takes words tid,
// tid + threads, ...
__host__ __device__ inline void twin_stage(const float* x, const float* y,
                                           float* sx, float* sy, int src0,
                                           long long tile, int n, int tid,
                                           int threads) {
  const int stride = twin_stride(n);
  for (int i = tid; i < TWIN_TILE * n; i += threads) {
    const int r = i / n, at = r * stride + i - r * n;
    sx[at] = twin_staged(x, src0, tile, n, i);
    sy[at] = twin_staged(y, src0, tile, n, i);
  }
}

// Lane `lane` of warp w of a block whose staged tile rows (from src0) are
// sx, sy: the lane's columns of its tile row, then the warp's turns over
// the copies, each a Gram sum of four copies, the group's reduce-scatter
// (shfl) and the tail of the lane's own output row, stored if that row
// exists
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int CPL, class Shfl>
__host__ __device__ __forceinline__ void twin_warp_rows(
    const float* sx, const float* sy, int n, int src0, long long rows, int w,
    int lane, float zero, float* out, Shfl& shfl) {
  const int stride = twin_stride(n);
  const int g = lane / TWIN_LANES, q = lane % TWIN_LANES;
  const int src = src0 + g;
  float xv[CPL], yv[CPL];
  twin_lane_load<CPL>(sx + g * stride, sy + g * stride, n, q, xv, yv);
  const int mine = twin_copies(rows, src), most = twin_copies(rows, src0);
  for (int m0 = w * TWIN_LANES; m0 < most; m0 += ROW_WARPS * TWIN_LANES) {
    float p[TWIN_LANES][3];
#pragma unroll
    for (int j = 0; j < TWIN_LANES; ++j)
      twin_lane_gram<CPL>(xv, yv, zero * (float)(m0 + j), p[j]);
    float s[3];
    twin_group_sums(p, q, shfl, s);
    const float v = twin_stereo_tail(s[0], s[1], s[2]);
    if (m0 + q < mine) out[src + (long long)RESIDENT_ROWS * (m0 + q)] = v;
  }
}

// The card's lane exchange for twin_warp_rows
struct TwinWarpShfl {
  __device__ __forceinline__ float operator()(float v, int mask) const {
    return __shfl_xor_sync(0xffffffffu, v, mask);
  }
};

// The resident twin (above); a block of ROW_THREADS takes tile rows
// TWIN_TILE * blockIdx.x .. + TWIN_TILE - 1
template <int CPL>
__global__ void __launch_bounds__(ROW_THREADS, 2)
twin_stereo_resident_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            float* __restrict__ out, long long rows, int n,
                            float zero) {
  __shared__ float sx[TWIN_TILE * TWIN_MAX_STRIDE];
  __shared__ float sy[TWIN_TILE * TWIN_MAX_STRIDE];
  const int src0 = blockIdx.x * TWIN_TILE;
  const long long tile = rows < RESIDENT_ROWS ? rows : RESIDENT_ROWS;
  twin_stage(x, y, sx, sy, src0, tile, n, threadIdx.x, ROW_THREADS);
  __syncthreads();
  TwinWarpShfl shfl;
  twin_warp_rows<CPL>(sx, sy, n, src0, rows, threadIdx.x / 32,
                      threadIdx.x % 32, zero, out, shfl);
}

// --- reparam probes (reparam_stereo.cu's launch shape) --------------------

// Both reparam probes take the TPU probes' hoisted per-example inputs as one
// (3, B) array `hoist`: sum log sigma, min sigma and |mu|^2, computed once
// per example by the caller (roofline.reparam_scalars), not once per sample.

// Both take reparam_stereo.cu's launch shape: a thread per example and spt
// consecutive samples (the caller passes what reparam_stereo_spt gives at
// the shape), REP_THREADS a block (its REPARAM_THREADS); the per-example
// words are read once a thread, the last group of a chunk whose S is not a
// multiple of spt stores nothing for its samples past S - 1.

// The bytes floor of reparam_stereo_kernel: z = eps copied into its rows of
// the (S, Z, B) buffer, log q = log p = the example's words of mu and sigma
// folded with one add each, then its hoisted scalars and k. It is a
// template on the kernel's dimension class N (2, 3, 6: the loops unrolled
// as the kernel's are; 0: n at run time) and samples a thread SPT
template <int N, int SPT>
__global__ void __launch_bounds__(REP_THREADS)
skel_reparam_kernel(const float* __restrict__ eps, long long eps_stride,
                    const float* __restrict__ mu,
                    const float* __restrict__ sigma,
                    const float* __restrict__ hoist,
                    const float* __restrict__ kptr, float* __restrict__ zt,
                    int z_off, float* __restrict__ lq,
                    float* __restrict__ lp, int S, int B, int n, int Z) {
  const long long idx = (long long)blockIdx.x * REP_THREADS + threadIdx.x;
  if (idx >= rep_threads(S, B, SPT)) return;
  const int nn = N > 0 ? N : n;
  const int b = (int)(idx % B);
  const int s0 = (int)(idx / B) * SPT;
  const float* m = mu + (size_t)b * nn;
  const float* sg = sigma + (size_t)b * nn;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < nn; ++j) {
    acc += m[j];
    acc += sg[j];
  }
  const float c = (((acc + hoist[b]) + hoist[B + b]) + hoist[2 * B + b])
                  + kptr[0];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = s0 + i;
    if (s >= S) break;
    const long long pt = (long long)s * B + b;
    const float* ep = eps + eps_stride * pt;
    float* zr = zt + ((size_t)s * Z + z_off) * B + b;
#pragma unroll
    for (int j = 0; j < nn; ++j) zr[(size_t)j * B] = ep[j];
    lq[pt] = c;
    lp[pt] = c;
  }
}

// The reparam twin, _twin_reparam of the TPU harness: the compute floor of
// reparam_stereo_kernel, the TPU probe's counted op volume (_TWIN_FULL_OPS
// = 9 full-width passes, a _TWIN_PREFIX_OPS = 40 prefix, two
// _TWIN_CHAIN_OPS = 40 chains, an exp every _TWIN_TRANSC_EVERY = 12) in
// generic multiply-adds for every sample; it reads what the TPU twin reads:
// eps, mu_0, sigma_0, the hoisted scalars and k. Bound: bytes (at the
// production chunk its ~1.4 us of operations are a third of its 4.3 us of
// bytes), so it has to move them as B5 does: it takes B5's launch shape,
// reads the noise and writes z as B5 does, and is instantiated as B5 and
// the skeleton are, on the dimension class N (2, 3, 6: every coordinate in
// registers; 0: n at run time) and samples a thread SPT: a thread's
// samples are independent chains the scheduler interleaves, the last group
// of a chunk whose S is not a multiple of SPT computes sample S - 1 again
// and stores nothing for it. Each coordinate's nine passes run as soon as
// its noise word is in, so no instantiation keeps a per-thread array (the
// previous design's two arrays of REP_MAX_DIM, indexed by run-time loops,
// sat in a 272-byte stack frame, and the twin took 3.1x B5's time)
template <int N, int SPT>
__global__ void __launch_bounds__(REP_THREADS)
twin_reparam_kernel(const float* __restrict__ eps, long long eps_stride,
                    const float* __restrict__ mu,
                    const float* __restrict__ sigma,
                    const float* __restrict__ hoist,
                    const float* __restrict__ kptr, float* __restrict__ zt,
                    int z_off, float* __restrict__ lq,
                    float* __restrict__ lp, int S, int B, int n, int Z) {
  const long long idx = (long long)blockIdx.x * REP_THREADS + threadIdx.x;
  if (idx >= rep_threads(S, B, SPT)) return;
  const int nn = N > 0 ? N : n;
  const int b = (int)(idx % B);
  const int s0 = (int)(idx / B) * SPT;
  const float r = ((hoist[b] + hoist[B + b]) + hoist[2 * B + b]) + kptr[0];
  const float m0 = mu[(size_t)b * nn], sg0 = sigma[(size_t)b * nn];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const bool store = s0 + i < S;
    const int s = store ? s0 + i : S - 1;
    const long long pt = (long long)s * B + b;
    const float* ep = eps + eps_stride * pt;
    float* zr = zt + ((size_t)s * Z + z_off) * B + b;
    float z0 = 0.f;
#pragma unroll
    for (int j = 0; j < nn; ++j) {
      const float e = ep[j];
      float z = e;
#pragma unroll
      for (int p = 0; p < 9; ++p) z = z * 1.0000001f + e;
      if (store) zr[(size_t)j * B] = z;
      if (j == 0) z0 = z;
    }
    float t = (z0 + m0) + sg0;
#pragma unroll
    for (int q = 0; q < 40; ++q)
      t = (q % 12 == 11) ? expf(-fabsf(t) * 1e-3f) : t * 1.0000001f + r;
    float tq = t, tp = t + 1.f;
#pragma unroll
    for (int q = 0; q < 40; ++q) {
      if (q % 12 == 11) {
        tq = expf(-fabsf(tq) * 1e-3f);
        tp = expf(-fabsf(tp) * 1e-3f);
      } else {
        tq = tq * 1.0000001f + r;
        tp = tp * 1.0000002f + r;
      }
    }
    if (store) {
      lq[pt] = tq;
      lp[pt] = tp;
    }
  }
}

// --- the tail's I/O skeleton ------------------------------------------------

// The bytes floor of the tail kernels (tail_fwd.cu, tail_bwd.cu) at their
// grids (tail_grid.cuh): thread (row, component i) reads every word of its
// component's slices (k, the head, the noise; in the backward also dz and
// daux) and folds them into s: k, then each slice's 8-word chunks (zeros
// past its end) summed by halves and added in order, then daux[:, i],
// daux[:, nc], daux[:, nc + 1]; it writes s to every word of its outputs.
// The forward (B1's grid: 32 rows a block, a warp a component) writes z and
// aux[:, i] and, by the block's first warp, aux[:, nc] = aux[:, nc + 1] = the row's s summed over the
// components in order; the backward (B3's grid: up to 8 warps of 32 rows
// of one component a block) writes draw and dk_rows[:, i] and folds
// dk_rows over the batch into dk as tail_bwd.cu does.
// Widths of component i's slices of raw, eps and z (from the next offset)
__device__ __forceinline__ void tail_widths(const TailTable& t, int i, int W,
                                            int E, int Z, int* rw, int* ew,
                                            int* zw) {
  const bool last = i + 1 == t.nc;
  *rw = (last ? W : t.raw_off[i + 1]) - t.raw_off[i];
  *ew = (last ? E : t.eps_off[i + 1]) - t.eps_off[i];
  *zw = (last ? Z : t.z_off[i + 1]) - t.z_off[i];
}

// Up to SKEL_CHUNK words of p from word j0 on (j0 + j < w), 0 past w
#define SKEL_CHUNK 8
__device__ __forceinline__ void skel_load(const float* __restrict__ p, int w,
                                          int j0, float* v) {
  #pragma unroll
  for (int j = 0; j < SKEL_CHUNK; ++j) v[j] = j0 + j < w ? p[j0 + j] : 0.f;
}

// The sum of a chunk by halves: v[j] + v[j + 4], then + 2, then + 1
__device__ __forceinline__ float skel_tree(const float* v) {
  const float a0 = v[0] + v[4], a1 = v[1] + v[5], a2 = v[2] + v[6],
              a3 = v[3] + v[7];
  return (a0 + a2) + (a1 + a3);
}

// s plus the chunk sums of the w words of p in order: the first two chunks
// already in v, the rest loaded a chunk at a time
__device__ __forceinline__ float skel_add(const float* __restrict__ p, int w,
                                          const float* v, float s) {
  s = s + skel_tree(v);
  if (w > SKEL_CHUNK) s = s + skel_tree(v + SKEL_CHUNK);
  for (int j0 = 2 * SKEL_CHUNK; j0 < w; j0 += SKEL_CHUNK) {
    float u[SKEL_CHUNK];
    skel_load(p, w, j0, u);
    s = s + skel_tree(u);
  }
  return s;
}

// The loads of a row's first two chunks of every slice are all issued
// before the first add, so a component of up to 16 words a slice waits on
// memory once, and the chunk sums keep the chain of adds short
__device__ __forceinline__ float skel_tail_sum(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, const float* __restrict__ dz,
    const float* __restrict__ daux, int W, int E, int Z, int bwd,
    const TailTable& t, int row, int i, int* rw, int* zw) {
  int ew;
  tail_widths(t, i, W, E, Z, rw, &ew, zw);
  const int nc = t.nc;
  const float* r = raw + (size_t)row * W + t.raw_off[i];
  const float* e = eps + (size_t)row * E + t.eps_off[i];
  const float* g = dz + (size_t)row * Z + t.z_off[i];
  const float* ga = daux + (size_t)row * (nc + 2);
  float vr[2 * SKEL_CHUNK], ve[2 * SKEL_CHUNK], vg[2 * SKEL_CHUNK];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const float k = kvec[i];
  for (int c = 0; c < 2; ++c) {
    skel_load(r, *rw, c * SKEL_CHUNK, vr + c * SKEL_CHUNK);
    skel_load(e, ew, c * SKEL_CHUNK, ve + c * SKEL_CHUNK);
  }
  if (bwd) {
    skel_load(g, *zw, 0, vg);
    skel_load(g, *zw, SKEL_CHUNK, vg + SKEL_CHUNK);
    a0 = ga[i];
    a1 = ga[nc];
    a2 = ga[nc + 1];
  }
  float s = skel_add(r, *rw, vr, k);
  s = skel_add(e, ew, ve, s);
  if (bwd) {
    s = skel_add(g, *zw, vg, s);
    s = s + a0;
    s = s + a1;
    s = s + a2;
  }
  return s;
}

// B1's grid, phase 1: z and aux[:, i] of the thread's row and components
__device__ __forceinline__ void skel_tail_fwd_rows(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, float* __restrict__ z,
    float* __restrict__ aux, int B, int W, int E, int Z, const TailTable& t,
    int block, int tid, float* sh) {
  const int lane = tid % TAIL_ROWS, row = block * TAIL_ROWS + lane;
  if (row >= B) return;
  const int nc = t.nc, warps = tail_warps(nc);
  for (int i = tid / TAIL_ROWS; i < nc; i += warps) {
    int rw, zw;
    const float s = skel_tail_sum(raw, eps, kvec, raw, raw, W, E, Z, 0, t,
                                  row, i, &rw, &zw);
    float* o = z + (size_t)row * Z + t.z_off[i];
    for (int j = 0; j < zw; ++j) o[j] = s;
    aux[(size_t)row * (nc + 2) + i] = s;
    sh[i * TAIL_ROWS + lane] = s;
  }
}

// B1's grid, phase 2: the row's sum over the components in order
__device__ __forceinline__ void skel_tail_fwd_sums(float* __restrict__ aux,
                                                   int B, int nc, int block,
                                                   int tid, const float* sh) {
  const int row = block * TAIL_ROWS + tid;
  if (tid >= TAIL_ROWS || row >= B) return;
  float s = 0.f;
  for (int i = 0; i < nc; ++i) s = s + sh[i * TAIL_ROWS + tid];
  aux[(size_t)row * (nc + 2) + nc] = s;
  aux[(size_t)row * (nc + 2) + nc + 1] = s;
}

// B3's grid, phase 1: draw and dk_rows[:, c] of the thread's row
__device__ __forceinline__ void skel_tail_bwd_rows(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, const float* __restrict__ dz,
    const float* __restrict__ daux, float* __restrict__ draw,
    float* __restrict__ dk_rows, int B, int W, int E, int Z,
    const TailTable& t, int c, int bx, int tid, float* sh) {
  const int w = tid / TAIL_ROWS, lane = tid % TAIL_ROWS;
  const int row = (bx * TAIL_GROUPS + w) * TAIL_ROWS + lane;
  if (row >= B) return;
  int rw, zw;
  const float s = skel_tail_sum(raw, eps, kvec, dz, daux, W, E, Z, 1, t, row,
                                c, &rw, &zw);
  float* o = draw + (size_t)row * W + t.raw_off[c];
  for (int j = 0; j < rw; ++j) o[j] = s;
  dk_rows[(size_t)row * t.nc + c] = s;
  sh[w * TAIL_ROWS + lane] = s;
}

__global__ void __launch_bounds__(TAIL_THREADS)
skel_tail_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ eps,
                     const float* __restrict__ kvec, float* __restrict__ z,
                     float* __restrict__ aux, int B, int W, int E, int Z,
                     TailTable t) {
  __shared__ float sh[MAX_COMPS * TAIL_ROWS];
  skel_tail_fwd_rows(raw, eps, kvec, z, aux, B, W, E, Z, t, blockIdx.x,
                     threadIdx.x, sh);
  __syncthreads();
  skel_tail_fwd_sums(aux, B, t.nc, blockIdx.x, threadIdx.x, sh);
}

__global__ void __launch_bounds__(TAIL_THREADS)
skel_tail_bwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ eps,
                     const float* __restrict__ kvec,
                     const float* __restrict__ dz,
                     const float* __restrict__ daux, float* __restrict__ draw,
                     float* __restrict__ dk_rows, float* __restrict__ dk,
                     float* __restrict__ part, unsigned* __restrict__ counter,
                     int B, int W, int E, int Z, TailTable t) {
  __shared__ float sh[TAIL_GROUPS * TAIL_ROWS];
  __shared__ float gs[TAIL_GROUPS];
  __shared__ bool last;
  const int bx = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  skel_tail_bwd_rows(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t,
                     c, bx, tid, sh);
  __syncthreads();
  tail_fold_groups(B, bx, tid, sh, gs);
  __syncthreads();
  if (gridDim.x == 1) {
    tail_fold_direct(B, c, tid, gs, dk);
    return;
  }
  tail_fold_publish(B, t.nc, c, bx, tid, gs, part);
  __syncthreads();
  if (tid == 0) last = tail_fold_ticket(counter + c, gridDim.x);
  __syncthreads();
  if (last) {
    __threadfence();
    tail_fold_last(B, t.nc, c, tid, part, dk, counter);
  }
}

// The split geometry, forward, phase 1: thread (row, item i < nc) of the
// row's components
__device__ __forceinline__ void skel_tail_fwd_split_rows(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, float* __restrict__ z,
    float* __restrict__ aux, int B, int W, int E, int Z, const TailTable& t,
    int block, int tid, float* sh) {
  const int g = tail_split_row(tid), row = block * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  const int nc = t.nc;
  for (int i = tail_split_item(tid); i < nc; i += TAIL_LANES) {
    int rw, zw;
    const float s = skel_tail_sum(raw, eps, kvec, raw, raw, W, E, Z, 0, t,
                                  row, i, &rw, &zw);
    float* o = z + (size_t)row * Z + t.z_off[i];
    for (int j = 0; j < zw; ++j) o[j] = s;
    aux[(size_t)row * (nc + 2) + i] = s;
    sh[i * TAIL_SPLIT_ROWS + g] = s;
  }
}

// The split geometry, forward, phase 2: item 0 of a row sums its components
// in order
__device__ __forceinline__ void skel_tail_fwd_split_sums(
    float* __restrict__ aux, int B, int nc, int block, int tid,
    const float* sh) {
  const int g = tail_split_row(tid), row = block * TAIL_SPLIT_ROWS + g;
  if (tail_split_item(tid) != 0 || row >= B) return;
  float s = 0.f;
  for (int i = 0; i < nc; ++i) s = s + sh[i * TAIL_SPLIT_ROWS + g];
  aux[(size_t)row * (nc + 2) + nc] = s;
  aux[(size_t)row * (nc + 2) + nc + 1] = s;
}

// The split geometry, backward: item 0 of a row of split component c
__device__ __forceinline__ void skel_tail_bwd_split_rows(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, const float* __restrict__ dz,
    const float* __restrict__ daux, float* __restrict__ draw,
    float* __restrict__ dk_rows, int B, int W, int E, int Z,
    const TailTable& t, int c, int bx, int tid) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (tail_split_item(tid) != 0 || row >= B) return;
  int rw, zw;
  const float s = skel_tail_sum(raw, eps, kvec, dz, daux, W, E, Z, 1, t, row,
                                c, &rw, &zw);
  float* o = draw + (size_t)row * W + t.raw_off[c];
  for (int j = 0; j < rw; ++j) o[j] = s;
  dk_rows[(size_t)row * t.nc + c] = s;
  __threadfence();
}

__global__ void __launch_bounds__(TAIL_THREADS)
skel_tail_fwd_kernel_split(const float* __restrict__ raw,
                           const float* __restrict__ eps,
                           const float* __restrict__ kvec,
                           float* __restrict__ z, float* __restrict__ aux,
                           int B, int W, int E, int Z, TailTable t) {
  __shared__ float sh[MAX_COMPS * TAIL_SPLIT_ROWS];
  skel_tail_fwd_split_rows(raw, eps, kvec, z, aux, B, W, E, Z, t, blockIdx.x,
                           threadIdx.x, sh);
  __syncthreads();
  skel_tail_fwd_split_sums(aux, B, t.nc, blockIdx.x, threadIdx.x, sh);
}

// grid (tail_split_blocks(B), nc) as tail_bwd_kernel_split: a component
// that runs a row on one thread takes its first tail_bwd_blocks(B) blocks
__global__ void __launch_bounds__(TAIL_THREADS)
skel_tail_bwd_kernel_split(const float* __restrict__ raw,
                           const float* __restrict__ eps,
                           const float* __restrict__ kvec,
                           const float* __restrict__ dz,
                           const float* __restrict__ daux,
                           float* __restrict__ draw,
                           float* __restrict__ dk_rows, float* __restrict__ dk,
                           float* __restrict__ part,
                           unsigned* __restrict__ counter, int B, int W,
                           int E, int Z, TailTable t) {
  __shared__ float sh[TAIL_GROUPS * TAIL_ROWS];
  __shared__ float gs[TAIL_GROUPS], buf[TAIL_FOLD_CHUNK], total;
  __shared__ bool last;
  const int bx = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  if (!t.split[c]) {
    const int blocks = tail_bwd_blocks(B);
    if (bx >= blocks) return;
    skel_tail_bwd_rows(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t,
                       c, bx, tid, sh);
    __syncthreads();
    tail_fold_groups(B, bx, tid, sh, gs);
    __syncthreads();
    if (blocks == 1) {
      tail_fold_direct(B, c, tid, gs, dk);
      return;
    }
    tail_fold_publish(B, t.nc, c, bx, tid, gs, part);
    __syncthreads();
    if (tid == 0) last = tail_fold_ticket(counter + c, blocks);
    __syncthreads();
    if (last) {
      __threadfence();
      tail_fold_last(B, t.nc, c, tid, part, dk, counter);
    }
    return;
  }
  skel_tail_bwd_split_rows(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E,
                           Z, t, c, bx, tid);
  __syncthreads();
  if (tid == 0) last = tail_fold_ticket(counter + c, gridDim.x);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r0 = 0; r0 < B; r0 += TAIL_FOLD_CHUNK) {
    tail_split_fold_stage(B, t.nc, c, r0, tid, dk_rows, buf);
    __syncthreads();
    tail_split_fold_groups(B, r0, tid, buf);
    __syncthreads();
    tail_split_fold_total(B, c, r0, tid, buf, &total, dk, counter);
    __syncthreads();
  }
}

// --- launchers ------------------------------------------------------------

// A grid of at most per_sm blocks per SM (8: a full SM's 2048 threads), or
// of one block a tile of `tile` words when per_sm is 0; fewer when the words
// run out first
static inline cudaError_t elem_blocks(long long n4, long long tile,
                                      int per_sm, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long nb = (n4 + tile - 1) / tile;
  const long long cap = per_sm > 0 ? (long long)sms * per_sm : nb;
  if (cap > 2147483647LL) return cudaErrorInvalidValue;
  *blocks = (unsigned)(nb < cap ? nb : cap);
  return cudaSuccess;
}

static inline int aligned16(const void* p) { return ((size_t)p % 16) == 0; }

static inline bool row_grid(long long rows, long long per_block,
                            unsigned* blocks) {
  if (rows < 0) return false;
  const long long nb = (rows + per_block - 1) / per_block;
  if (nb > 2147483647LL) return false;
  *blocks = (unsigned)nb;
  return true;
}

extern "C" int probe_triad_launch(const float* x, const float* y, float* o,
                                  long long n, void* stream) {
  unsigned blocks = 0;
  if (n < 0 || n % 4 || !aligned16(x) || !aligned16(y) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    // a block a tile: on the H100 a capped grid striding over the tiles
    // read 2-4% slower (scripts/torch_reparam_phases.py)
    const cudaError_t err = elem_blocks(
        n / 4, (long long)ELEM_THREADS * TRIAD_UNROLL, 0, &blocks);
    if (err != cudaSuccess) return (int)err;
    probe_triad_kernel<<<blocks, ELEM_THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
        reinterpret_cast<float4*>(o), n / 4);
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_fma_launch(const float* x, float* o, long long n,
                                int repeat, void* stream) {
  unsigned blocks = 0;
  if (n < 0 || n % 4 || repeat < 1 || !aligned16(x) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const cudaError_t err = elem_blocks(n / 4, ELEM_THREADS,
                                           ELEM_BLOCKS_PER_SM, &blocks);
    if (err != cudaSuccess) return (int)err;
    probe_fma_kernel<<<blocks, ELEM_THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o),
        n / 4, repeat);
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_tanh_launch(const float* x, float* o, long long n,
                                 int repeat, void* stream) {
  unsigned blocks = 0;
  if (n < 0 || n % 4 || repeat < 1 || !aligned16(x) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const cudaError_t err = elem_blocks(n / 4, ELEM_THREADS,
                                           ELEM_BLOCKS_PER_SM, &blocks);
    if (err != cudaSuccess) return (int)err;
    probe_tanh_kernel<<<blocks, ELEM_THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o),
        n / 4, repeat);
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_reduce_launch(const float* x, float* o, long long rows,
                                   int cols, void* stream) {
  unsigned blocks;
  if (cols < 4 || cols % 4 || !aligned16(x) || !aligned16(o)
      || !row_grid(rows, ROW_WARPS, &blocks))
    return (int)cudaErrorInvalidValue;
  if (rows > 0)
    probe_reduce_kernel<<<blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
        x, o, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int probe_transpose_launch(const float* x, float* o,
                                      long long rows, int cols,
                                      void* stream) {
  unsigned blocks;
  if (cols < 8 || cols % 4 || !aligned16(x) || !aligned16(o)
      || !row_grid(rows, TP_ROWS, &blocks))
    return (int)cudaErrorInvalidValue;
  if (rows > 0)
    probe_transpose_kernel<<<blocks, TP_ROWS, 0, (cudaStream_t)stream>>>(
        x, o, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int skel_dist_launch(const float* x, const float* y, float* out,
                                long long rows, int n, int variant,
                                void* stream) {
  unsigned blocks;
  if (n < 1 || variant < 0 || variant > 1
      || !row_grid(rows, ROW_WARPS, &blocks))
    return (int)cudaErrorInvalidValue;
  const int vec4 = n % 4 == 0 && aligned16(x) && aligned16(y);
  if (rows > 0)
    skel_dist_kernel<<<blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, out, rows, n, vec4, variant);
  return (int)cudaGetLastError();
}

extern "C" int twin_stereo_launch(const float* x, const float* y, float* out,
                                  long long rows, int n, int resident,
                                  void* stream) {
  unsigned blocks;
  if (n < 1 || resident < 0 || resident > 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (resident && n <= TWIN_LANES * TWIN_MAX_CPL) {
    const long long tile = rows < RESIDENT_ROWS ? rows : RESIDENT_ROWS;
    blocks = (unsigned)((tile + TWIN_TILE - 1) / TWIN_TILE);
#define TWIN_GO(C)                                                    \
  twin_stereo_resident_kernel<C><<<blocks, ROW_THREADS, 0, st>>>(x, y, out, \
                                                                 rows, n, 0.f)
    switch (twin_cpl(n)) {
      case 2: TWIN_GO(2); break;
      case 8: TWIN_GO(8); break;
      default: TWIN_GO(TWIN_MAX_CPL);
    }
#undef TWIN_GO
    return (int)cudaGetLastError();
  }
  if (!row_grid(rows, ROW_WARPS, &blocks)) return (int)cudaErrorInvalidValue;
  const int vec4 = n % 4 == 0 && aligned16(x) && aligned16(y);
  twin_stereo_kernel<<<blocks, ROW_THREADS, 0, st>>>(x, y, out, rows, n, vec4,
                                                     resident);
  return (int)cudaGetLastError();
}

static inline bool reparam_grid(int S, int B, int n, int Z, int z_off,
                                int spt, unsigned* blocks) {
  if (S < 0 || B < 0 || n < 1 || n > REP_MAX_DIM || z_off < 0
      || z_off + n > Z || spt < 1 || spt > 2)
    return false;
  return row_grid(rep_threads(S, B, spt), REP_THREADS, blocks);
}

extern "C" int skel_reparam_launch(const float* eps, long long eps_stride,
                                   const float* mu, const float* sigma,
                                   const float* hoist, const float* k,
                                   float* zt, int z_off,
                                   float* lq, float* lp, int S, int B, int n,
                                   int Z, int spt, void* stream) {
  unsigned blocks;
  if (!reparam_grid(S, B, n, Z, z_off, spt, &blocks))
    return (int)cudaErrorInvalidValue;
  if (rep_threads(S, B, spt) > 0) {
    cudaStream_t st = (cudaStream_t)stream;
#define SKEL_GO(D)                                                            \
  (spt == 2 ? skel_reparam_kernel<D, 2> : skel_reparam_kernel<D, 1>)         \
      <<<blocks, REP_THREADS, 0, st>>>(eps, eps_stride, mu, sigma, hoist, k, \
                                       zt, z_off, lq, lp, S, B, n, Z)
    switch (n) {
      case 2: SKEL_GO(2); break;
      case 3: SKEL_GO(3); break;
      case 6: SKEL_GO(6); break;
      default: SKEL_GO(0);
    }
#undef SKEL_GO
  }
  return (int)cudaGetLastError();
}

extern "C" int twin_reparam_launch(const float* eps, long long eps_stride,
                                   const float* mu, const float* sigma,
                                   const float* hoist, const float* k,
                                   float* zt, int z_off,
                                   float* lq, float* lp, int S, int B, int n,
                                   int Z, int spt, void* stream) {
  unsigned blocks;
  if (!reparam_grid(S, B, n, Z, z_off, spt, &blocks))
    return (int)cudaErrorInvalidValue;
  if (rep_threads(S, B, spt) > 0) {
    cudaStream_t st = (cudaStream_t)stream;
#define TWIN_GO(D)                                                            \
  (spt == 2 ? twin_reparam_kernel<D, 2> : twin_reparam_kernel<D, 1>)         \
      <<<blocks, REP_THREADS, 0, st>>>(eps, eps_stride, mu, sigma, hoist, k, \
                                       zt, z_off, lq, lp, S, B, n, Z)
    switch (n) {
      case 2: TWIN_GO(2); break;
      case 3: TWIN_GO(3); break;
      case 6: TWIN_GO(6); break;
      default: TWIN_GO(0);
    }
#undef TWIN_GO
  }
  return (int)cudaGetLastError();
}

extern "C" int skel_tail_launch(const float* raw, const float* eps,
                                const float* kvec, const float* dz,
                                const float* daux, float* out, float* out_c,
                                float* dk, float* part, unsigned* counter,
                                int B, int W, int E, int Z, int nc, int bwd,
                                int warp, const int* table, void* stream) {
  TailTable t;
  if (!tail_table_from(table, nc, &t) || B < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool split = !warp && tail_any_split(t);
  if (B > 0 && bwd && split)
    skel_tail_bwd_kernel_split<<<dim3(tail_split_blocks(B), nc), TAIL_THREADS,
                                 0, s>>>(raw, eps, kvec, dz, daux, out, out_c,
                                         dk, part, counter, B, W, E, Z, t);
  else if (B > 0 && bwd)
    skel_tail_bwd_kernel<<<dim3(tail_bwd_blocks(B), nc), tail_bwd_threads(B),
                           0, s>>>(raw, eps, kvec, dz, daux, out, out_c, dk,
                                   part, counter, B, W, E, Z, t);
  else if (B > 0 && split)
    skel_tail_fwd_kernel_split<<<tail_split_blocks(B), TAIL_THREADS, 0, s>>>(
        raw, eps, kvec, out, out_c, B, W, E, Z, t);
  else if (B > 0)
    skel_tail_fwd_kernel<<<tail_blocks(B), TAIL_ROWS * tail_warps(nc), 0,
                           s>>>(raw, eps, kvec, out, out_c, B, W, E, Z, t);
  return (int)cudaGetLastError();
}
