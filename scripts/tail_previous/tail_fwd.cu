// Frozen copy of mvae_torch/kernels/csrc/tail_fwd.cu as it stood at commit
// b875f52: the tail kernels' previous design (every product on the
// warp-a-component geometry, each tile serial on one thread), built beside
// the package's kernels to hold them bit for bit and time them in turns
// (chip_smoke.py, scripts/torch_tail_turns.py, tests). Not part of the
// package.
//
// Fused forward tail of the product latent: head activations, draws, exact
// log q / log p and the per-component KL, for every component at once.
//
// Replaces the TPU kernel mvae_tpu/kernels/tail_kernels.py::_fwd_pallas
// (:704, over _tail_tile :646 and its tiles _tile_normal :232,
// _tile_wrapped_lorentz :245, _tile_wrapped_sphere :301, _tile_vmf :386,
// _tile_wrapped_stereo :462 with _logq_drawn_rows :540 and
// _logp_prior_rows :610).
//
// Bound: neither bytes nor operations. Per batch row the kernel reads W head
// pre-activations and E noise values and writes Z latent coordinates and
// nc + 2 aux values (31 floats at the h2,s2,e2 flagship), and does a few
// hundred operations (a few thousand with a d/p/u or s tile): at B = 512
// the data sheet prices that at ~0.02 us, the card's own I/O skeleton of
// the tail (roofline_probes.cu, skel_tail_*_kernel) at the launch it cannot
// avoid. What is left is latency: each row is one long dependent chain of
// transcendentals per component.
//
// Design (launch geometry in tail_grid.cuh): one warp per component and 32
// rows a block, so the components of a row run side by side and the row's
// chain is its longest tile; up to 16 blocks at the eval batch of 512.
// The tiles (tail_tiles.cuh) are templates on the component dimension: the
// kernel is instantiated for the dimension class of the product (2, 3, 6,
// every vector in registers, or 0, the generic instantiation for any other
// mix of n <= 32, its vectors in local memory), and the launcher picks the
// instantiation from the table. The sums log q and log p over the
// components go through shared memory in component order, the order of the
// plain version tail_kernels.tail_forward_ref, so every output equals the
// plain version's bit for bit: the tiles' expressions are the plain
// version's (exp-based cosh/sinh clipped at 85, the series window at
// |u| < 1e-2, the vMF cosine clip, the Householder degeneracy guard) with
// a row's coordinates summed in index order, and the file is compiled
// without fast math and with --fmad=false.
//
// Entry point (plain C, loaded with ctypes):
//   int tail_fwd_launch(raw (B, W), eps (B, E), kvec (nc,), z (B, Z),
//                       aux (B, nc + 2), B, W, E, Z, nc, table, stream)
// `table` is a host array of nc rows (kind, dim, n_scale, raw_off,
// eps_off, z_off, sign, wraps). Returns cudaGetLastError() after the launch.

#include "tail_grid.cuh"

// Phase 1, thread `tid` of block `block`: the tiles of its row and warp's
// components; kl into aux, log q and log p into sh (2, nc, TAIL_ROWS)
template <int D>
__device__ __forceinline__ void fwd_rows(const float* __restrict__ raw,
                                         const float* __restrict__ eps,
                                         const float* __restrict__ kvec,
                                         float* __restrict__ z,
                                         float* __restrict__ aux, int B, int W,
                                         int E, int Z, const TailTable& t,
                                         int block, int tid, float* sh) {
  const int lane = tid % TAIL_ROWS, row = block * TAIL_ROWS + lane;
  if (row >= B) return;
  const int nc = t.nc, warps = tail_warps(nc);
  for (int i = tid / TAIL_ROWS; i < nc; i += warps) {
    float kl, q, p;
    fwd_tile<D>(t, i, raw + (size_t)row * W + t.raw_off[i],
                eps + (size_t)row * E + t.eps_off[i], kvec[i],
                z + (size_t)row * Z + t.z_off[i], &kl, &q, &p);
    aux[(size_t)row * (nc + 2) + i] = kl;
    sh[i * TAIL_ROWS + lane] = q;
    sh[(nc + i) * TAIL_ROWS + lane] = p;
  }
}

// Phase 2, the block's first warp: sum log q and sum log p of its row over
// the components in order (the plain version's lq = lq + q)
__device__ __forceinline__ void fwd_sums(float* __restrict__ aux, int B, int nc,
                                         int block, int tid, const float* sh) {
  const int row = block * TAIL_ROWS + tid;
  if (tid >= TAIL_ROWS || row >= B) return;
  float lq = 0.f, lp = 0.f;
  for (int i = 0; i < nc; ++i) {
    lq = lq + sh[i * TAIL_ROWS + tid];
    lp = lp + sh[(nc + i) * TAIL_ROWS + tid];
  }
  aux[(size_t)row * (nc + 2) + nc] = lq;
  aux[(size_t)row * (nc + 2) + nc + 1] = lp;
}

template <int D>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
tail_fwd_kernel(const float* __restrict__ raw, const float* __restrict__ eps,
                const float* __restrict__ kvec, float* __restrict__ z,
                float* __restrict__ aux, int B, int W, int E, int Z,
                TailTable t) {
  __shared__ float sh[2 * MAX_COMPS * TAIL_ROWS];
  fwd_rows<D>(raw, eps, kvec, z, aux, B, W, E, Z, t, blockIdx.x, threadIdx.x,
              sh);
  __syncthreads();
  fwd_sums(aux, B, t.nc, blockIdx.x, threadIdx.x, sh);
}

extern "C" int tail_fwd_launch(const float* raw, const float* eps,
                               const float* kvec, float* z, float* aux, int B,
                               int W, int E, int Z, int nc, const int* table,
                               void* stream) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid(tail_blocks(B)), block(TAIL_ROWS * tail_warps(nc));
    cudaStream_t s = (cudaStream_t)stream;
    switch (tail_dim_class(t)) {
      case 2:
        tail_fwd_kernel<2><<<grid, block, 0, s>>>(raw, eps, kvec, z, aux, B,
                                                  W, E, Z, t);
        break;
      case 3:
        tail_fwd_kernel<3><<<grid, block, 0, s>>>(raw, eps, kvec, z, aux, B,
                                                  W, E, Z, t);
        break;
      case 6:
        tail_fwd_kernel<6><<<grid, block, 0, s>>>(raw, eps, kvec, z, aux, B,
                                                  W, E, Z, t);
        break;
      default:
        tail_fwd_kernel<0><<<grid, block, 0, s>>>(raw, eps, kvec, z, aux, B,
                                                  W, E, Z, t);
    }
  }
  return (int)cudaGetLastError();
}
