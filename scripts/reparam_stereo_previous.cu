// The IWAE chunk reparam kernel's previous design, as it stood at commit
// 832a68d of mvae_torch/kernels/csrc/reparam_stereo.cu (below, unchanged
// from its first line): a thread per (sample, example), the generic draw
// stereo_draw<0> with every vector in local memory, the per-example
// scalars recomputed for every sample, the sign taken at run time. It is
// not part of the package: chip_smoke.py (phase 13) and
// scripts/torch_reparam_phases.py build it beside the package's kernel, hold
// the kernel to it bit for bit and time the two in turns. Built against the
// package's tail_tiles.cuh, whose stereo_draw evaluates the same
// expressions in the same order (stereo_example then stereo_draw_at).
//
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
// Bound: bytes on paper. Per (sample, example) it reads n noise values and
// writes n coordinates and two log-densities (4 (2 n + 2) bytes; mu and sigma
// are read once per example), against ~40 transcendentals with wraps = 1;
// at an IWAE chunk (S = 125, B = 512, n = 2) that is ~1.5 MB, so the launch
// and the transcendental chain dominate, not the memory.
//
// Design: one thread per (sample, example), the example index fastest, so a
// warp writes 32 neighbouring floats of each z row and of log q / log p. The
// draw is stereo_draw of tail_tiles.cuh: the same device function the fused
// tail's stereographic tile runs, so kernel, tile and plain version evaluate
// one set of expressions (compiled with --fmad=false like the tail kernels).
// z goes straight into rows z_off .. z_off + n of the (S, Z, B) buffer the
// IWAE decode kernel reads, so no concatenation or transpose follows. The
// noise is read where it lies: the component's columns of the product's
// (S, B, E) block, addressed by its row stride. The TPU kernel's (n, 8, L)
// packing, its padding of S and B and its hoisted per-example rows are not
// carried over.
//
// Entry point (plain C, loaded with ctypes):
//   int reparam_stereo_launch(eps, eps_stride, mu (B, n), sigma (B, n),
//                             k (1,), zt (S, Z, B), z_off, lq (S, B),
//                             lp (S, B), S, B, n, Z, sign, wraps, stream)
// eps points at the component's first column of sample 0, example 0; the
// noise of (s, b) starts eps_stride * (s * B + b) floats further. Returns
// cudaGetLastError() after the launch.

#include "tail_tiles.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
reparam_stereo_kernel(const float* __restrict__ eps, long long eps_stride,
                      const float* __restrict__ mu,
                      const float* __restrict__ sigma,
                      const float* __restrict__ kptr, float* __restrict__ zt,
                      int z_off, float* __restrict__ lq,
                      float* __restrict__ lp, int S, int B, int n, int Z,
                      int sign, int wraps) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)S * B) return;
  const int b = (int)(idx % B);
  const int s = (int)(idx / B);
  float m[MAX_DIM], sg[MAX_DIM], e[MAX_DIM];
  const float* ep = eps + eps_stride * idx;
  for (int j = 0; j < n; ++j) {
    m[j] = mu[(size_t)b * n + j];
    sg[j] = sigma[(size_t)b * n + j];
    e[j] = ep[j];
  }
  StereoSaved<0> sv;
  float q, p;
  stereo_draw<0>(n, sign, wraps, kptr[0], m, sg, e, &q, &p, sv);
  float* zr = zt + ((size_t)s * Z + z_off) * B + b;
  for (int j = 0; j < n; ++j) zr[(size_t)j * B] = sv.z[j];
  lq[idx] = q;
  lp[idx] = p;
}

extern "C" int reparam_stereo_launch(const float* eps, long long eps_stride,
                                     const float* mu, const float* sigma,
                                     const float* k, float* zt, int z_off,
                                     float* lq, float* lp, int S, int B, int n,
                                     int Z, int sign, int wraps,
                                     void* stream) {
  if (n < 1 || n > MAX_DIM || z_off < 0 || z_off + n > Z || sign < -1
      || sign > 1 || wraps < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)S * B;
  if (total > 0) {
    const long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    reparam_stereo_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
        eps, eps_stride, mu, sigma, k, zt, z_off, lq, lp, S, B, n, Z, sign,
        wraps);
  }
  return (int)cudaGetLastError();
}
