// Fused MLP decoder + Bernoulli log-likelihood for the training step:
//
//   h  = relu(z W1 + b1)                         (B, H), kept for the wgrads
//   l  = h W2 + b2                               (never leaves the chip)
//   ll = sum_d x l - softplus(l)                 (B,)
//   gl = x - sigmoid(l) = d ll / d l             (B, D)
//
// so that the backward is four matrix products and two bias sums.
//
// Replaces the TPU kernel mvae_tpu/kernels/decoder_kernels.py::
// _train_decode_fwd_pallas (_train_decode_kernel).
//
// Bound: operations. At the flagship step (B = 128, Z = 8, H = 400,
// D = 784) one call does 2 B (Z H + H D) = 81.1 MFLOP, 1.21 us at the FP32
// rate, on ~2.3 MB of traffic (0.68 us at the HBM rate); at that size the
// launch dominates.
//
// Design: the IWAE decode kernel's (decode_bce.cu), batch-major. One block
// owns (ROWS = 64 batch rows, TD = 64 pixels): it computes h for its rows
// into dynamic shared memory (H x 64 floats, 100 KB at H = 400), stages W2
// through shared memory KC = 16 hidden units at a time, and each of the
// 16 x 16 threads accumulates a 4 x 4 (pixel x row) block of logits in
// registers; the epilogue writes gl with 16-byte stores along the pixels
// and sums x l - softplus(l) (stable form) per row. A batch of 128 gives
// only 2 row tiles, so D is split over the grid as well (13 pixel tiles at
// D = 784): every block recomputes its rows' h (cheap at Z = 8), the first
// pixel tile writes it out, and each block writes a partial ll per (row,
// pixel tile). A second small kernel sums the partials of a row in a fixed
// order. No atomics: results are deterministic.
//
// Precision: plain FP32 FMA (no TF32, no tensor cores); the TPU kernel's
// bf16 casts were its matrix unit's default, not a requirement.
//
// Entry point (plain C, loaded with ctypes):
//   int train_decode_launch(z (B, Z), x (B, D), w1 (Z, H), b1 (H,),
//                           w2 (H, D), b2 (D,), ll (B,), h (B, H),
//                           gl (B, D), part (B, ceil(D / 64)), B, Z, H, D,
//                           stream)
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// when H and Z need more shared memory than a block can have.

#include <cuda_runtime.h>
#include <math.h>

// Must match decoder_kernels.py (_COLS, _TD, _KC, _SMEM_LIMIT).
#define ROWS 64
#define TD 64
#define KC 16
#define TX 16
#define TY 16
#define NT (TX * TY)
#define SMEM_LIMIT 232448

static size_t smem_bytes(int Z, int H) {
  return sizeof(float) * ((size_t)H * ROWS + (size_t)Z * ROWS + KC * TD +
                          TX * ROWS);
}

__global__ void __launch_bounds__(NT)
train_decode_kernel(const float* __restrict__ z, const float* __restrict__ x,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ h, float* __restrict__ gl,
                    float* __restrict__ part, int B, int Z, int H, int D) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;               // H x ROWS hidden activations
  float* zs = hs + H * ROWS;      // Z x ROWS latent tile
  float* ws = zs + Z * ROWS;      // KC x TD stage of W2
  float* red = ws + KC * TD;      // TX x ROWS per-row partial sums

  const int nt = gridDim.x;
  const int d0 = blockIdx.x * TD;
  const int b0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int tx = tid % TX;   // pixels d0 + 4 tx + i
  const int ty = tid / TX;   // rows b0 + 4 ty + c

  for (int i = tid; i < Z * ROWS; i += NT) {
    const int k = i / ROWS, c = i % ROWS, b = b0 + c;
    zs[i] = (b < B) ? z[(size_t)b * Z + k] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < H * ROWS; i += NT) {
    const int j = i / ROWS, c = i % ROWS;
    float acc = 0.f;
    for (int k = 0; k < Z; ++k) acc = fmaf(zs[k * ROWS + c], w1[k * H + j], acc);
    hs[i] = fmaxf(acc + b1[j], 0.f);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int i = tid; i < ROWS * H; i += NT) {
      const int c = i / H, j = i % H, b = b0 + c;
      if (b < B) h[(size_t)b * H + j] = hs[j * ROWS + c];
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int j0 = 0; j0 < H; j0 += KC) {
    for (int i = tid; i < KC * TD; i += NT) {
      const int jj = i / TD, dd = i % TD;
      const int j = j0 + jj, d = d0 + dd;
      ws[i] = (j < H && d < D) ? w2[(size_t)j * D + d] : 0.f;
    }
    __syncthreads();
    const int kmax = min(KC, H - j0);
#pragma unroll 4
    for (int jj = 0; jj < kmax; ++jj) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[jj * TD + tx * 4]);
      const float4 hv =
          *reinterpret_cast<const float4*>(&hs[(j0 + jj) * ROWS + ty * 4]);
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wr[i], hr[c], acc[i][c]);
    }
    __syncthreads();
  }

  const int dbase = d0 + tx * 4;
  const bool vec = (D % 4 == 0) && (dbase + 3 < D);
  float rowsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int b = b0 + ty * 4 + c;
    if (b >= B) continue;
    const size_t off = (size_t)b * D + dbase;
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec) {
      const float4 x4 = *reinterpret_cast<const float4*>(&x[off]);
      xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
    } else {
      for (int i = 0; i < 4; ++i)
        if (dbase + i < D) xv[i] = x[off + i];
    }
    float g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g[i] = 0.f;
      if (dbase + i < D) {
        const float l = acc[i][c] + b2[dbase + i];
        const float sp = fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
        rowsum[c] += xv[i] * l - sp;
        g[i] = xv[i] - 1.f / (1.f + expf(-l));
      }
    }
    if (vec) {
      *reinterpret_cast<float4*>(&gl[off]) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
      for (int i = 0; i < 4; ++i)
        if (dbase + i < D) gl[off + i] = g[i];
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) red[tx * ROWS + ty * 4 + c] = rowsum[c];
  __syncthreads();
  if (tid < ROWS) {
    float t = 0.f;
    for (int q = 0; q < TX; ++q) t += red[q * ROWS + tid];
    const int b = b0 + tid;
    if (b < B) part[(size_t)b * nt + blockIdx.x] = t;
  }
}

// ll[b] = sum over pixel tiles of part[b, :], in tile order
__global__ void ll_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ ll, int B, int nt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float t = 0.f;
  for (int q = 0; q < nt; ++q) t += part[(size_t)b * nt + q];
  ll[b] = t;
}

extern "C" int train_decode_launch(const float* z, const float* x,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2, float* ll,
                                   float* h, float* gl, float* part, int B,
                                   int Z, int H, int D, void* stream) {
  const size_t smem = smem_bytes(Z, H);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      train_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (D + TD - 1) / TD;
  const dim3 grid(nt, (B + ROWS - 1) / ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  train_decode_kernel<<<grid, NT, smem, s>>>(z, x, w1, b1, w2, b2, h, gl,
                                             part, B, Z, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_reduce_kernel<<<(B + 127) / 128, 128, 0, s>>>(part, ll, B, nt);
  return (int)cudaGetLastError();
}
