// IWAE chunk reparameterization of the components the tail's one-row tiles
// cover: the normal on e, the wrapped normal on the hyperboloid h and the
// vMF on S^2 (m = 3). For every importance sample s and example b, and every
// component of its table, in one launch:
//   z_c    = the component's draw from its posterior at (s, b)
//   lq     = sum_c log q_c(z_c | x_b)        (the posterior's density)
//   lp     = sum_c log p_c(z_c)              (the prior's)
// Forward only: the IWAE estimate has no backward.
//
// Replaces no TPU kernel: the reference draws these kinds for the IWAE
// chunk in plain jnp (mvae_tpu/models/vae.py::_reparam_chunk_t), which XLA
// fuses on the TPU. The port drew them in plain PyTorch, dozens of small
// kernels a component and a chunk.
//
// Bound: operations and latency. Per (sample, example) point it reads the
// noise (E floats: 7 at the flagship h2,s2,e2) and writes the coordinates (8)
// and two log-densities, 68 bytes; the head pre-activations are read once
// an example. At an IWAE chunk (S = 125, B = 512) that is 4.35 MB, 1.3 us at
// 3.35 TB/s, against a dependent chain of ~15 accurate transcendentals a
// point, so the launch and the chains dominate, not the memory.
//
// Math: the tiles of tail_tiles.cuh (tile_normal, tile_wrapped_h,
// tile_vmf_s2), called as the fused tail's forward (tail_fwd.cu) calls
// them on a row, and the sums over the components in table order from 0,
// as its fwd_sums, so a point equals B1's row on the same head and noise
// bit for bit. Compiled with --fmad=false like the tail kernels.
//
// Design (B5's, csrc/reparam_stereo.cu, at one sample a thread): a thread
// per point, the example index fastest, so a warp writes 32 neighbouring
// floats of each z row and of log q / log p. The thread walks the table's
// components in order, runs each one's tile and adds its log q and log p to
// its running sums. The kernel is a template on the dimension class D of
// the table: 2 when every normal and hyperboloid component has dimension 2
// (every vector in registers), else 0, the generic instantiation (n up to
// MAX_DIM, the vectors in local memory). z goes straight into the
// component's rows of the (S, Z, B) buffer the IWAE decode kernel reads, so
// no concatenation or transpose follows. The noise is read where it lies:
// the component's columns of the product's (S, B, E) block, addressed by
// its row stride; the head pre-activations are the fused head GEMM's
// (B, W) output, each component at its offset.
//
// Entry point (plain C, loaded with ctypes):
//   int reparam_chunk_launch(eps, eps_stride, raw (B, W), W, k (nc,),
//                            zt (S, Z, B), lq (S, B), lp (S, B), S, B, Z,
//                            nc, table, stream)
// eps points at sample 0, example 0 of the noise block; the noise of (s, b)
// starts eps_stride * (s * B + b) floats further. `table` is a host array
// of nc rows (kind, dim, n_scale, raw_off, eps_off, z_off); row c draws with
// curvature k[c]. Returns cudaGetLastError() after the launch.

#include "tail_tiles.cuh"

#define CHUNK_THREADS 128
#define CHUNK_COLS 6

struct ChunkTable {
  int nc;
  int kind[MAX_COMPS];
  int dim[MAX_COMPS];
  int nscale[MAX_COMPS];
  int raw_off[MAX_COMPS];
  int eps_off[MAX_COMPS];
  int z_off[MAX_COMPS];
};

// Fill a ChunkTable from the host rows; false when a row is out of range
// or of a kind the kernel does not draw
static inline bool chunk_table_from(const int* table, int nc, int W, int Z,
                                    long long eps_stride, ChunkTable* t) {
  if (nc < 1 || nc > MAX_COMPS) return false;
  t->nc = nc;
  for (int i = 0; i < nc; ++i) {
    const int* row = table + CHUNK_COLS * i;
    const int kind = row[0], n = row[1], ns = row[2];
    if (kind != KIND_NORMAL && kind != KIND_WRAPPED_H && kind != KIND_VMF_S2)
      return false;
    if (n < 1 || n > MAX_DIM || (kind == KIND_VMF_S2 && n != 2)) return false;
    if (ns != 1 && !(ns == n && kind != KIND_VMF_S2)) return false;
    const int ambient = kind == KIND_NORMAL ? n : n + 1;
    const int noise = kind == KIND_VMF_S2 ? n + 1 : n;
    if (row[3] < 0 || row[3] + n + ns > W || row[4] < 0
        || row[4] + noise > eps_stride || row[5] < 0 || row[5] + ambient > Z)
      return false;
    t->kind[i] = kind;
    t->dim[i] = n;
    t->nscale[i] = ns;
    t->raw_off[i] = row[3];
    t->eps_off[i] = row[4];
    t->z_off[i] = row[5];
  }
  return true;
}

// The dimension class of a table: 2 when every normal and hyperboloid
// component has dimension 2 (the vMF holds no vector), else 0
static inline int chunk_dim_class(const ChunkTable& t) {
  for (int i = 0; i < t.nc; ++i)
    if (t.kind[i] != KIND_VMF_S2 && t.dim[i] != 2) return 0;
  return 2;
}

// One component's tile at one point: z (its ambient coordinates), log q
// and log p, by the table's kind
template <int D>
__device__ __forceinline__ int chunk_tile(const ChunkTable& t, int c,
                                          const float* r, const float* e,
                                          float k, float* z, float* q,
                                          float* p) {
  const int n = TAIL_DIM(D, t.dim[c]), ns = t.nscale[c];
  float kl;
  switch (t.kind[c]) {
    case KIND_NORMAL:
      tile_normal(r, e, n, ns, z, &kl, q, p);
      return n;
    case KIND_WRAPPED_H: {
      HSaved<D> s;
      tile_wrapped_h<D>(r, e, n, ns, k, z, &kl, q, p, s);
      return n + 1;
    }
    default: {
      VmfSaved s;
      tile_vmf_s2(r, e, k, z, &kl, q, p, s);
      return 3;
    }
  }
}

// (minimum one block an SM, as B5)
template <int D>
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
reparam_chunk_kernel(const float* __restrict__ eps, long long eps_stride,
                     const float* __restrict__ raw, int W,
                     const float* __restrict__ kvec, float* __restrict__ zt,
                     float* __restrict__ lq, float* __restrict__ lp, int S,
                     int B, int Z, ChunkTable t) {
  const long long pt = (long long)blockIdx.x * CHUNK_THREADS + threadIdx.x;
  if (pt >= (long long)S * B) return;
  const int b = (int)(pt % B), s = (int)(pt / B);
  const float* row = raw + (size_t)b * W;
  const float* e = eps + eps_stride * pt;
  float* zs = zt + (size_t)s * Z * B + b;
  float q = 0.f, p = 0.f;
  for (int c = 0; c < t.nc; ++c) {
    float z[TAIL_ARR(D) + 1], tq, tp;
    const int amb = chunk_tile<D>(t, c, row + t.raw_off[c],
                                  e + t.eps_off[c], kvec[c], z, &tq, &tp);
    #pragma unroll
    for (int j = 0; j < TAIL_ARR(D) + 1; ++j)
      if (j < amb) zs[(size_t)(t.z_off[c] + j) * B] = z[j];
    q = q + tq;
    p = p + tp;
  }
  lq[pt] = q;
  lp[pt] = p;
}

// --- launchers --------------------------------------------------------------

extern "C" int reparam_chunk_launch(const float* eps, long long eps_stride,
                                    const float* raw, int W, const float* k,
                                    float* zt, float* lq, float* lp, int S,
                                    int B, int Z, int nc, const int* table,
                                    void* stream) {
  ChunkTable t;
  if (S < 0 || B < 0 || eps_stride < 1
      || !chunk_table_from(table, nc, W, Z, eps_stride, &t))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)S * B;
  if (total > 0) {
    const long long blocks = (total + CHUNK_THREADS - 1) / CHUNK_THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const void* kernel = chunk_dim_class(t) == 2
                             ? (const void*)reparam_chunk_kernel<2>
                             : (const void*)reparam_chunk_kernel<0>;
    void* args[] = {&eps, &eps_stride, &raw, &W, &k,  &zt,
                    &lq,  &lp,         &S,   &B, &Z, &t};
    return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks),
                                 dim3(CHUNK_THREADS), args, 0,
                                 (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
