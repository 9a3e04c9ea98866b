// IWAE chunk reparameterization of one wrapped-normal component on the
// kappa-stereographic family (kinds d/p/u): for every importance sample s
// and example b,
//   z    = mu_b (+)_K exp_0(sigma_b * eps_sb)
//   logq = WrappedNormal(mu_b, sigma_b).log_prob(z)  (drawn-radius branch sum)
//   logp = WrappedNormal(mu0, 1).log_prob(z)         (prior, one wrap pair)
// Forward only: the IWAE estimate has no backward.
//
// Replaces the TPU kernel
// mvae_tpu/kernels/manifold_kernels.py::wrapped_reparam_stereo_t (body
// _make_reparam_kernel).
//
// Bound: operations. Per (sample, example) it reads n noise values and
// writes n coordinates and two log-densities (4 (2 n + 2) bytes; mu and sigma
// are read once per example), against ~15 (sign -1) to ~45 (wraps = 1)
// accurate transcendentals; at an IWAE chunk (S = 125, B = 512, n = 2) that
// is ~1.5 MB, so the launch and the transcendental chains dominate, not the
// memory.
//
// Design: a thread per example and SPT consecutive samples, the
// example index fastest, so a warp writes 32 neighbouring floats of each z
// row and of log q / log p. The thread reads its example's mu and sigma
// once and computes the per-example scalars once (stereo_example: |mu|^2
// and sum log sigma, n logf; ball_smax(k)), then draws each of its samples
// with stereo_draw_at of tail_tiles.cuh: the same device functions the
// fused tail's stereographic tile runs, so kernel, tile and plain version
// evaluate one set of expressions (compiled with --fmad=false like the tail
// kernels) and the kernel is bit-equal to the one-thread-a-point generic
// draw. The samples of a thread are independent chains the scheduler can
// interleave; the last group of a chunk whose S is not a multiple of
// SPT repeats sample S - 1 and stores nothing for it. The kernel is
// a template on the dimension N: for N = 2, 3 and 6 (the supported specs'
// d/p/u dimensions) every vector lives in registers; N = 0 is the generic
// instantiation, n taken at run time up to MAX_DIM and the vectors in local
// memory. It is also a template on the samples a thread (the launcher takes
// 1 while a thread a point fits on the card at once, else 2) and on the
// component's static curvature sign, which drops the branches the sign
// cannot take. z goes straight into rows z_off .. z_off + n of the (S, Z, B)
// buffer the IWAE decode kernel reads, so no concatenation or transpose
// follows. The noise is read where it lies: the component's columns of the
// product's (S, B, E) block, addressed by its row stride. The TPU kernel's
// (n, 8, L) packing and its padding of S and B are not carried over.
//
// Entry point (plain C, loaded with ctypes):
//   int reparam_stereo_launch(eps, eps_stride, mu (B, n), sigma (B, n),
//                             k (1,), zt (S, Z, B), z_off, lq (S, B),
//                             lp (S, B), S, B, n, Z, sign, wraps, stream)
// eps points at the component's first column of sample 0, example 0; the
// noise of (s, b) starts eps_stride * (s * B + b) floats further. Returns
// cudaGetLastError() after the launch.

#include "tail_tiles.cuh"

#define REPARAM_THREADS 128

// Threads of a chunk: one per example and group of spt samples
__host__ __device__ inline long long reparam_threads(int S, int B, int spt) {
  return (long long)((S + spt - 1) / spt) * B;
}

// One (sample, example) point on the example's scalars: the draw, z into
// its rows of the (S, Z, B) buffer, log q and log p
template <int N>
__device__ __forceinline__ void reparam_point(
    int n, int sign, int wraps, float k, float smax, float x2, float ls,
    const float* m, const float* sg, const float* ep, bool store, float* zr,
    int B, float* lq, float* lp) {
  const int nn = TAIL_DIM(N, n);
  float e[TAIL_ARR(N)];
  #pragma unroll
  for (int j = 0; j < nn; ++j) e[j] = ep[j];
  StereoSaved<N> sv;
  float q, p;
  stereo_draw_at<N>(n, sign, wraps, k, smax, x2, ls, m, sg, e, &q, &p, sv);
  if (!store) return;
  #pragma unroll
  for (int j = 0; j < nn; ++j) zr[(size_t)j * B] = sv.z[j];
  *lq = q;
  *lp = p;
}

// (minimum one block an SM: without it ptxas held <2, 2, 0> to 40
// registers and spilled 16 bytes)
template <int N, int SPT, int SIGN>
__global__ void __launch_bounds__(REPARAM_THREADS, 1)
reparam_stereo_kernel(const float* __restrict__ eps, long long eps_stride,
                      const float* __restrict__ mu,
                      const float* __restrict__ sigma,
                      const float* __restrict__ kptr, float* __restrict__ zt,
                      int z_off, float* __restrict__ lq,
                      float* __restrict__ lp, int S, int B, int n, int Z,
                      int wraps) {
  const long long idx = (long long)blockIdx.x * REPARAM_THREADS + threadIdx.x;
  if (idx >= reparam_threads(S, B, SPT)) return;
  const int nn = TAIL_DIM(N, n);
  const int b = (int)(idx % B);
  const int s0 = (int)(idx / B) * SPT;
  float m[TAIL_ARR(N)], sg[TAIL_ARR(N)];
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    m[j] = mu[(size_t)b * nn + j];
    sg[j] = sigma[(size_t)b * nn + j];
  }
  const float k = kptr[0];
  const float smax = ball_smax(k);
  float x2, ls;
  stereo_example<N>(n, m, sg, &x2, &ls);
  #pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = s0 + i < S ? s0 + i : S - 1;
    const long long pt = (long long)s * B + b;
    reparam_point<N>(n, SIGN, wraps, k, smax, x2, ls, m, sg,
                     eps + eps_stride * pt, s0 + i < S,
                     zt + ((size_t)s * Z + z_off) * B + b, B, lq + pt,
                     lp + pt);
  }
}

// --- launchers --------------------------------------------------------------

#define REPARAM_K(D, SPT, SG) (const void*)reparam_stereo_kernel<D, SPT, SG>
#define REPARAM_SIGNS(D, SPT) \
  {REPARAM_K(D, SPT, -1), REPARAM_K(D, SPT, 0), REPARAM_K(D, SPT, 1)}
#define REPARAM_DIM(D) {REPARAM_SIGNS(D, 1), REPARAM_SIGNS(D, 2)}
// [dimension class 0, 2, 3, 6][samples a thread - 1][sign + 1]
static const void* const reparam_kernels[4][2][3] = {
    REPARAM_DIM(0), REPARAM_DIM(2), REPARAM_DIM(3), REPARAM_DIM(6)};

// The row of reparam_kernels that draws dimension n
static inline int reparam_dim_row(int n) {
  return n == 2 ? 1 : n == 3 ? 2 : n == 6 ? 3 : 0;
}

// Threads of the a-sample-a-thread instantiation the card runs at once
// (blocks an SM by the occupancy API x SMs x REPARAM_THREADS), asked once
// per device and instantiation: the answer depends on nothing else. Two
// threads asking at once both store the same value.
#define REPARAM_DEVICES 64
static long long reparam_resident[REPARAM_DEVICES][4][3];

static cudaError_t reparam_resident_threads(int dev, int d, int sign,
                                            long long* out) {
  long long* slot =
      dev >= 0 && dev < REPARAM_DEVICES ? &reparam_resident[dev][d][sign + 1]
                                        : nullptr;
  if (slot && *slot > 0) {
    *out = *slot;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reparam_kernels[d][0][sign + 1], REPARAM_THREADS, 0);
  if (err != cudaSuccess) return err;
  *out = (long long)per_sm * sms * REPARAM_THREADS;
  if (slot) *slot = *out;
  return cudaSuccess;
}

// Samples a thread: 1 while a thread per point fits on the card at once
// (the chains then have every thread there is to hide their latency), 2
// when it does not (the per-example scalars are then shared and the chunk
// takes one wave)
static cudaError_t reparam_spt(int S, int B, int n, int sign, int* spt) {
  int dev = 0;
  long long resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = reparam_resident_threads(dev, reparam_dim_row(n), sign, &resident);
  if (err != cudaSuccess) return err;
  *spt = (long long)S * B > resident ? 2 : 1;
  return cudaSuccess;
}

// The samples a thread the launcher takes at (S, B, n, sign), or
// -cudaError_t
extern "C" int reparam_stereo_spt(int S, int B, int n, int sign) {
  if (n < 1 || n > MAX_DIM || sign < -1 || sign > 1)
    return -(int)cudaErrorInvalidValue;
  int spt = 0;
  const cudaError_t err = reparam_spt(S, B, n, sign, &spt);
  return err == cudaSuccess ? spt : -(int)err;
}

extern "C" int reparam_stereo_launch(const float* eps, long long eps_stride,
                                     const float* mu, const float* sigma,
                                     const float* k, float* zt, int z_off,
                                     float* lq, float* lp, int S, int B, int n,
                                     int Z, int sign, int wraps,
                                     void* stream) {
  if (n < 1 || n > MAX_DIM || z_off < 0 || z_off + n > Z || sign < -1
      || sign > 1 || wraps < 0 || S < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  int spt = 1;
  const cudaError_t err = reparam_spt(S, B, n, sign, &spt);
  if (err != cudaSuccess) return (int)err;
  const long long total = reparam_threads(S, B, spt);
  if (total > 0) {
    const long long blocks = (total + REPARAM_THREADS - 1) / REPARAM_THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    void* args[] = {&eps, &eps_stride, &mu, &sigma, &k, &zt, &z_off, &lq,
                    &lp,  &S,          &B,  &n,     &Z, &wraps};
    return (int)cudaLaunchKernel(reparam_kernels[reparam_dim_row(n)][spt - 1]
                                                [sign + 1],
                                 dim3((unsigned)blocks), dim3(REPARAM_THREADS),
                                 args, 0, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
