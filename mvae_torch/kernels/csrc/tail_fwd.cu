// Fused forward tail of the product latent: head activations, draws, exact
// log q / log p and the per-component KL, for every component at once.
//
// Replaces the TPU kernel mvae_tpu/kernels/tail_kernels.py::_fwd_pallas
// (its tiles _tile_normal, _tile_wrapped_lorentz, _tile_vmf,
// _tile_wrapped_stereo and _tile_wrapped_sphere).
//
// Bound: bytes. Per batch row the kernel reads W head pre-activations and
// E noise values and writes Z latent coordinates and nc + 2 aux values
// (31 floats at the h2,s2,e2 flagship) and does a few hundred flops, far
// below the card's ~20 flops per byte balance point; at eval batch sizes
// (B = 512) the launch itself dominates.
//
// Design: one thread per batch row, the whole product unrolled by a small
// component table passed by value (kind, dim, scale width, offsets into
// raw / eps / z). A row's vectors have at most 32 entries and live in
// registers or local memory. The tiles are in tail_tiles.cuh, shared with
// the backward kernel tail_bwd.cu. The TPU kernel's lane padding and (B, nc)
// curvature broadcast are not carried over: the grid masks the ragged edge
// and the curvature is one scalar per component. The expressions are the
// tile's own (exp-based cosh/sinh clipped at 85, the series window at
// |u| < 1e-2, the vMF cosine clip, the Householder degeneracy guard), in
// the order of the plain version tail_kernels.tail_forward_ref, with
// reductions over a row's coordinates summed in index order. The file is
// compiled without fast math and with --fmad=false, so kernel and plain
// version round alike.
//
// Entry point (plain C, loaded with ctypes):
//   int tail_fwd_launch(raw (B, W), eps (B, E), kvec (nc,), z (B, Z),
//                       aux (B, nc + 2), B, W, E, Z, nc, table, stream)
// `table` is a host array of nc rows (kind, dim, n_scale, raw_off,
// eps_off, z_off, sign, wraps). Returns cudaGetLastError() after the launch.

#include "tail_tiles.cuh"

#define THREADS 128

// The stereographic tile with its intermediates, kept out of line so that
// products without such a component run the code they ran before it existed.
__device__ __noinline__ void stereo_tile_fwd(const float* raw,
                                             const float* eps, int n, int ns,
                                             int sign, int wraps, float k,
                                             float* z, float* kl, float* lq,
                                             float* lp) {
  StereoHead h;
  StereoSaved s;
  tile_wrapped_stereo(raw, eps, n, ns, sign, wraps, k, z, kl, lq, lp, h, s);
}

// The embedded-sphere tile with its intermediates, out of line likewise.
__device__ __noinline__ void sphere_tile_fwd(const float* raw,
                                             const float* eps, int n, int ns,
                                             int wraps, float k, float* z,
                                             float* kl, float* lq,
                                             float* lp) {
  SphSaved s;
  tile_wrapped_sphere(raw, eps, n, ns, wraps, k, z, kl, lq, lp, s);
}

__global__ void __launch_bounds__(THREADS)
tail_fwd_kernel(const float* __restrict__ raw, const float* __restrict__ eps,
                const float* __restrict__ kvec, float* __restrict__ z,
                float* __restrict__ aux, int B, int W, int E, int Z,
                TailTable t) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= B) return;
  const float* r = raw + (size_t)row * W;
  const float* e = eps + (size_t)row * E;
  float* zr = z + (size_t)row * Z;
  float* ar = aux + (size_t)row * (t.nc + 2);
  float lq = 0.f, lp = 0.f;
  for (int i = 0; i < t.nc; ++i) {
    float kl, q, p;
    const float* ri = r + t.raw_off[i];
    const float* ei = e + t.eps_off[i];
    float* zi = zr + t.z_off[i];
    if (t.kind[i] == KIND_NORMAL) {
      tile_normal(ri, ei, t.dim[i], t.nscale[i], zi, &kl, &q, &p);
    } else if (t.kind[i] == KIND_WRAPPED_H) {
      HSaved s;
      tile_wrapped_h(ri, ei, t.dim[i], t.nscale[i], kvec[i], zi, &kl, &q, &p,
                     s);
    } else if (t.kind[i] == KIND_VMF_S2) {
      VmfSaved s;
      tile_vmf_s2(ri, ei, kvec[i], zi, &kl, &q, &p, s);
    } else if (t.kind[i] == KIND_WRAPPED_STEREO) {
      stereo_tile_fwd(ri, ei, t.dim[i], t.nscale[i], t.sign[i], t.wraps[i],
                      kvec[i], zi, &kl, &q, &p);
    } else {
      sphere_tile_fwd(ri, ei, t.dim[i], t.nscale[i], t.wraps[i], kvec[i], zi,
                      &kl, &q, &p);
    }
    ar[i] = kl;
    lq = lq + q;
    lp = lp + p;
  }
  ar[t.nc] = lq;
  ar[t.nc + 1] = lp;
}

extern "C" int tail_fwd_launch(const float* raw, const float* eps,
                               const float* kvec, float* z, float* aux, int B,
                               int W, int E, int Z, int nc, const int* table,
                               void* stream) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int blocks = (B + THREADS - 1) / THREADS;
    tail_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        raw, eps, kvec, z, aux, B, W, E, Z, t);
  }
  return (int)cudaGetLastError();
}
