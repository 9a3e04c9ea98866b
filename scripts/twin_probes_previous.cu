// The compute twins' previous design, as they stood at commit d0b48cb of
// mvae_torch/kernels/csrc/roofline_probes.cu (below, their code unchanged:
// the constants, helpers and launchers they use, the stereographic twin's
// tail, both kernels). It is not part of the package: chip_smoke.py (phase
// 20) builds it beside the package's kernels and times each twin in turns
// with it at the roofline shapes.
//
// twin_stereo_kernel (B8e): the distance kernels' launch shape, a warp an
// output row, three 5-level butterfly sums, the tail on lane 0; resident
// = 1 reads row (r mod 2048) for output row r from L2.
// twin_reparam_kernel (B8f): one generic kernel over a run-time n and
// samples a thread, the point's coordinates in per-thread arrays of
// REP_MAX_DIM indexed by run-time loops.
//
// Entry points (plain C, loaded with ctypes; the package's signatures):
//   int twin_stereo_launch(x, y, out (rows,), rows, n, resident, stream)
//   int twin_reparam_launch(eps, eps_stride, mu, sigma, hoist (3, B), k, zt,
//                           z_off, lq, lp, S, B, n, Z, spt, stream)

#include <cuda_runtime.h>
#include <math.h>

#define ROW_THREADS 256
#define ROW_WARPS (ROW_THREADS / 32)
#define REP_THREADS 128   // reparam_stereo.cu's REPARAM_THREADS
#define REP_MAX_DIM 32
#define RESIDENT_ROWS 2048

// Threads of a reparam probe's chunk: one per example and spt samples
__host__ __device__ inline long long rep_threads(int S, int B, int spt) {
  return (long long)((S + spt - 1) / spt) * B;
}

__device__ __forceinline__ float probe_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The stereographic twin's scalar tail from a row's three Gram sums: the
// TPU probe's lower-bound op volume (_STWIN_PREFIX_OPS = 9, three chains
// of _STWIN_CHAIN_OPS = 18 with one sqrt, recip / exp each,
// _STWIN_MERGE_OPS = 4)
__device__ __forceinline__ float twin_stereo_tail(float r1, float r2,
                                                  float r3) {
  float t = (r1 + r2 * 1.0000001f) + r3;
  for (int j = 0; j < 9; ++j) t = t * 1.0000001f + 0.1f;
  float ta = t, tb = t + 1.f, tc = t + 2.f;
  for (int j = 0; j < 18; ++j) {
    if (j == 5) {
      ta = sqrtf(fabsf(ta) + 1e-6f);
      tb = sqrtf(fabsf(tb) + 1e-6f);
      tc = sqrtf(fabsf(tc) + 1e-6f);
    } else if (j == 12) {
      ta = 1.f / (fabsf(ta) + 1.f);
      tb = expf(-fabsf(tb) * 1e-3f);
      tc = 1.f / (fabsf(tc) + 1.f);
    } else {
      ta = ta * 1.0000001f + 0.1f;
      tb = tb * 1.0000002f + 0.1f;
      tc = tc * 1.0000003f + 0.1f;
    }
  }
  t = ta + tb * tc;
  for (int j = 0; j < 4; ++j) t = t * 1.0000001f + 0.1f;
  return t;
}

// The compute floor of stereo_dist_kernel: three row Gram sums, then the
// tail. resident = 1 reads row (r mod RESIDENT_ROWS) for output row r, so
// the input stays in L2 and the time is the arithmetic's
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

// The compute floor of reparam_stereo_kernel: the TPU probe's counted op
// volume (_TWIN_FULL_OPS = 9 full-width passes, a _TWIN_PREFIX_OPS = 40
// prefix, two _TWIN_CHAIN_OPS = 40 chains, an exp every
// _TWIN_TRANSC_EVERY = 12) in generic multiply-adds for every sample; it
// reads what the TPU twin reads: eps, mu_0, sigma_0, the hoisted scalars
// and k
__global__ void __launch_bounds__(REP_THREADS)
twin_reparam_kernel(const float* __restrict__ eps, long long eps_stride,
                    const float* __restrict__ mu,
                    const float* __restrict__ sigma,
                    const float* __restrict__ hoist,
                    const float* __restrict__ kptr, float* __restrict__ zt,
                    int z_off, float* __restrict__ lq,
                    float* __restrict__ lp, int S, int B, int n, int Z,
                    int spt) {
  const long long idx = (long long)blockIdx.x * REP_THREADS + threadIdx.x;
  if (idx >= rep_threads(S, B, spt)) return;
  const int b = (int)(idx % B);
  const int s0 = (int)(idx / B) * spt;
  const float r = ((hoist[b] + hoist[B + b]) + hoist[2 * B + b]) + kptr[0];
  const float m0 = mu[(size_t)b * n], sg0 = sigma[(size_t)b * n];
  for (int i = 0; i < spt; ++i) {
    const int s = s0 + i;
    if (s >= S) break;
    const long long pt = (long long)s * B + b;
    const float* ep = eps + eps_stride * pt;
    float e[REP_MAX_DIM], z[REP_MAX_DIM];
    for (int j = 0; j < n; ++j) z[j] = e[j] = ep[j];
    for (int p = 0; p < 9; ++p)
      for (int j = 0; j < n; ++j) z[j] = z[j] * 1.0000001f + e[j];
    float* zr = zt + ((size_t)s * Z + z_off) * B + b;
    for (int j = 0; j < n; ++j) zr[(size_t)j * B] = z[j];
    float t = (z[0] + m0) + sg0;
    for (int q = 0; q < 40; ++q)
      t = (q % 12 == 11) ? expf(-fabsf(t) * 1e-3f) : t * 1.0000001f + r;
    float tq = t, tp = t + 1.f;
    for (int q = 0; q < 40; ++q) {
      if (q % 12 == 11) {
        tq = expf(-fabsf(tq) * 1e-3f);
        tp = expf(-fabsf(tp) * 1e-3f);
      } else {
        tq = tq * 1.0000001f + r;
        tp = tp * 1.0000002f + r;
      }
    }
    lq[pt] = tq;
    lp[pt] = tp;
  }
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

extern "C" int twin_stereo_launch(const float* x, const float* y, float* out,
                                  long long rows, int n, int resident,
                                  void* stream) {
  unsigned blocks;
  if (n < 1 || resident < 0 || resident > 1
      || !row_grid(rows, ROW_WARPS, &blocks))
    return (int)cudaErrorInvalidValue;
  const int vec4 = n % 4 == 0 && aligned16(x) && aligned16(y);
  if (rows > 0)
    twin_stereo_kernel<<<blocks, ROW_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, out, rows, n, vec4, resident);
  return (int)cudaGetLastError();
}

static inline bool reparam_grid(int S, int B, int n, int Z, int z_off,
                                int spt, unsigned* blocks) {
  if (S < 0 || B < 0 || n < 1 || n > REP_MAX_DIM || z_off < 0
      || z_off + n > Z || spt < 1 || spt > 2)
    return false;
  return row_grid(rep_threads(S, B, spt), REP_THREADS, blocks);
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
  if (rep_threads(S, B, spt) > 0)
    twin_reparam_kernel<<<blocks, REP_THREADS, 0, (cudaStream_t)stream>>>(
        eps, eps_stride, mu, sigma, hoist, k, zt, z_off, lq, lp, S, B, n, Z,
        spt);
  return (int)cudaGetLastError();
}
