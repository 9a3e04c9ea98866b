// Geodesic distance between rows of two (B, n) point sets, two kernels:
//
//   stereo_dist   d = 2 arctan_K(|(-x) (+)_K y|) on the kappa-stereographic
//                 family (Poincare ball, projected sphere, universal), any
//                 sign of K, from the three Gram values |x|^2, |y|^2, <x, y>
//                 of a row: no vector of the Mobius sum is formed;
//   lorentz_dist  d = R acosh(1 + c |y - x|_L^2 / 2) on the hyperboloid,
//                 c = -K, the Lorentzian square in the difference form
//                 sum_i d_i^2 - 2 d_0^2, which does not cancel for nearby
//                 points.
//
// Replace the TPU kernels
// mvae_tpu/kernels/manifold_kernels.py::_stereo_dist_fwd_pallas (body
// _stereo_dist_kernel) and ::_lorentz_dist_fwd_pallas (body
// _lorentz_dist_kernel). Forward only, as there: the backward of both is
// autograd through the plain library ops.
//
// Bound: bytes. A row reads 2 n floats and writes one (1,028 bytes at
// n = 128) against ~4 n flops and one transcendental tail, ~0.5 flop per
// byte, far below the card's balance point.
//
// Design: one warp per row, so that a warp's loads are whole contiguous
// rows: 16 bytes a lane (float4) where n is a multiple of 4 and both bases
// are 16-byte aligned, else 4 bytes a lane; the lanes stride the columns.
// The Gram values are reduced across the warp by shuffles (xor butterfly:
// every lane ends with the same sum), lane 0 does the scalar tail and the
// store. The ragged last block is masked by the row index; nothing is
// padded. The TPU kernel's packed (B, 3) -> (3, B) relayout and its row-block
// output layout are not carried over.
//
// Entry points (plain C, loaded with ctypes):
//   int stereo_dist_launch(x (B, n), y (B, n), k (1,), out (B,), B, n, stream)
//   int lorentz_dist_launch(x (B, n), y (B, n), k (1,), out (B,), B, n, stream)
// Each returns cudaGetLastError() after the launch.

#include "tail_tiles.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The scalar tail of the stereographic distance from a row's Gram values
__device__ float stereo_dist_tail(float k, float x2, float y2, float xy) {
  const float a = 1.f + 2.f * k * xy - k * y2;  // coefficient of -x
  const float b = 1.f + k * x2;                 // coefficient of y
  float den = 1.f + 2.f * k * xy + k * k * x2 * y2;
  den = (fabsf(den) < 1e-6f) ? 1e-6f : den;
  float w2 = (a * a * x2 + b * b * y2 - 2.f * a * b * xy) / (den * den);
  w2 = fmaxf(w2, 0.f);
  return 2.f * sqrtf(w2 + 1e-30f) * arctandiv_u(k * w2, 0);
}

// The scalar tail of the hyperboloid distance from the Lorentzian square
__device__ float lorentz_dist_tail(float k, float dsq) {
  const float c = fmaxf(-k, 1e-30f);
  const float e = fmaxf(c * dsq / 2.f, 0.f) + 1e-30f;
  return acosh_1p(e) / sqrtf(c);
}

__global__ void __launch_bounds__(THREADS)
stereo_dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ kptr, float* __restrict__ out,
                   long long B, int n, int vec4) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= B) return;
  const int lane = threadIdx.x % 32;
  const float* xr = x + row * n;
  const float* yr = y + row * n;
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
  x2 = warp_sum(x2);
  y2 = warp_sum(y2);
  xy = warp_sum(xy);
  if (lane == 0) out[row] = stereo_dist_tail(kptr[0], x2, y2, xy);
}

__global__ void __launch_bounds__(THREADS)
lorentz_dist_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ kptr, float* __restrict__ out,
                    long long B, int n, int vec4) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= B) return;
  const int lane = threadIdx.x % 32;
  const float* xr = x + row * n;
  const float* yr = y + row * n;
  float ss = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    for (int j = lane; j < n / 4; j += 32) {
      const float4 a = x4[j], b = y4[j];
      const float d0 = b.x - a.x, d1 = b.y - a.y, d2 = b.z - a.z,
                  d3 = b.w - a.w;
      ss += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
    }
  } else {
    for (int j = lane; j < n; j += 32) {
      const float d = yr[j] - xr[j];
      ss += d * d;
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) {
    const float d0 = yr[0] - xr[0];
    out[row] = lorentz_dist_tail(kptr[0], ss - 2.f * d0 * d0);
  }
}

// Rows of n floats can be read as float4 when n is a multiple of 4 and both
// bases are 16-byte aligned
static inline int rows_vec4(const float* x, const float* y, int n) {
  return n % 4 == 0 && ((size_t)x % 16) == 0 && ((size_t)y % 16) == 0;
}

static inline bool dist_grid(long long B, int n, unsigned* blocks) {
  if (B < 0 || n < 1) return false;
  const long long nb = (B + WARPS - 1) / WARPS;
  if (nb > 2147483647LL) return false;
  *blocks = (unsigned)nb;
  return true;
}

extern "C" int stereo_dist_launch(const float* x, const float* y,
                                  const float* k, float* out, long long B,
                                  int n, void* stream) {
  unsigned blocks;
  if (!dist_grid(B, n, &blocks)) return (int)cudaErrorInvalidValue;
  if (B > 0)
    stereo_dist_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, y, k, out, B, n, rows_vec4(x, y, n));
  return (int)cudaGetLastError();
}

extern "C" int lorentz_dist_launch(const float* x, const float* y,
                                   const float* k, float* out, long long B,
                                   int n, void* stream) {
  unsigned blocks;
  if (!dist_grid(B, n, &blocks)) return (int)cudaErrorInvalidValue;
  if (B > 0)
    lorentz_dist_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        x, y, k, out, B, n, rows_vec4(x, y, n));
  return (int)cudaGetLastError();
}
