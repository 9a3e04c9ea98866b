// Fused forward tail of the product latent: head activations, draws, exact
// log q / log p and the per-component KL, for every component at once.
//
// Replaces the TPU kernel mvae_tpu/kernels/tail_kernels.py::_fwd_pallas
// (its tiles _tile_normal, _tile_wrapped_lorentz and _tile_vmf).
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
// registers or local memory. The TPU kernel's lane padding and (B, nc)
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
// eps_off, z_off). Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_COMPS 16
#define MAX_DIM 32
#define THREADS 128

enum { KIND_NORMAL = 0, KIND_WRAPPED_H = 1, KIND_VMF_S2 = 2 };

struct TailTable {
  int nc;
  int kind[MAX_COMPS];
  int dim[MAX_COMPS];
  int nscale[MAX_COMPS];
  int raw_off[MAX_COMPS];
  int eps_off[MAX_COMPS];
  int z_off[MAX_COMPS];
};

// f32 constants rounded from their double values, as PyTorch rounds a
// Python float scalar against a float32 tensor
#define F(x) ((float)(x))
#define LOG_2PI 1.8378770664093453
#define LOG_4PI 2.5310242469692907
#define PI 3.141592653589793
#define TINY 1e-15f
#define EPS 1e-6f
#define CUTOFF 1e-2f

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Horner form of 1 + c1 u + c2 u^2 + c3 u^3 + c4 u^4 (stable._poly)
__device__ __forceinline__ float poly4(float u, float c1, float c2, float c3,
                                       float c4) {
  float acc = 0.f;
  acc = u * (acc + c4);
  acc = u * (acc + c3);
  acc = u * (acc + c2);
  acc = u * (acc + c1);
  return 1.f + acc;
}

// stable._sindiv_u_kernel
__device__ float sindiv_u(float u) {
  if (fabsf(u) < CUTOFF)
    return poly4(u, F(-1.0 / 6), F(1.0 / 120), F(-1.0 / 5040), F(1.0 / 362880));
  float su = sqrtf(fabsf(u));
  if (u > 0.f) return sinf(su) / su;
  float sc = fminf(fmaxf(su, -85.f), 85.f);
  float sh = 0.5f * (expf(sc) - expf(-sc));
  return sh / su;
}

// stable._cos_u_sgn with sign < 0 (cosh through exp) or sign > 0 (cos)
__device__ float cos_u_sgn(float u, int sign) {
  if (fabsf(u) < CUTOFF)
    return poly4(u, F(-1.0 / 2), F(1.0 / 24), F(-1.0 / 720), F(1.0 / 40320));
  float x = sqrtf(fabsf(u));
  if (sign > 0) return cosf(x);
  float xc = fminf(fmaxf(x, 0.f), 85.f);
  return 0.5f * (expf(xc) + expf(-xc));
}

// stable._log_sindiv_u_sgn with sign < 0
__device__ float log_sindiv_u_neg(float u) {
  if (fabsf(u) < CUTOFF) {
    float us = u;
    float sd = us * (F(-1.0 / 6) + us * (F(1.0 / 120) + us * (F(-1.0 / 5040)
                                                   + us * F(1.0 / 362880))));
    return log1pf(sd);
  }
  float su = sqrtf(fabsf(u));
  return su + log1pf(-expf(-2.f * su)) - logf(2.f * su);
}

// stable._acosh_1p
__device__ __forceinline__ float acosh_1p(float u) {
  return log1pf(u + sqrtf(fmaxf(u, 0.f) * (u + 2.f)));
}

// tail_kernels._tile_normal
__device__ void tile_normal(const float* raw, const float* eps, int n, int ns,
                            float* z, float* kl, float* lq, float* lp) {
  float q = 0.f, p = 0.f, k2 = 0.f;
  for (int j = 0; j < n; ++j) {
    float mu = raw[j];
    float sig = softplus_f(raw[n + (ns == 1 ? 0 : j)]);
    float e = eps[j];
    float zj = mu + sig * e;
    z[j] = zj;
    float ls = logf(sig);
    float tq = -0.5f * (e * e + F(LOG_2PI)) - ls;
    float tp = -0.5f * (zj * zj + F(LOG_2PI));
    float tk = sig * sig + mu * mu - 1.f - 2.f * ls;
    q = (j == 0) ? tq : q + tq;
    p = (j == 0) ? tp : p + tp;
    k2 = (j == 0) ? tk : k2 + tk;
  }
  *lq = q;
  *lp = p;
  *kl = 0.5f * k2;
}

// tail_kernels._tile_wrapped_lorentz: wrapped normal on the hyperboloid
// (K < 0 pinned); log q at the drawn tangent, log p at the acosh_1p radius
__device__ void tile_wrapped_h(const float* raw, const float* eps, int n,
                               int ns, float k, float* z, float* kl, float* lq,
                               float* lp) {
  float mu_sp[MAX_DIM], v[MAX_DIM], u_sp[MAX_DIM];
  const float c = fmaxf(-k, TINY);
  const float inv_sqrt_c = rsqrtf(c);

  float r2m = 0.f;
  for (int j = 0; j < n; ++j) {
    float t = raw[j] * raw[j];
    r2m = (j == 0) ? t : r2m + t;
  }
  const float sdm = sindiv_u(k * r2m);
  float sp2 = 0.f;
  for (int j = 0; j < n; ++j) {
    mu_sp[j] = sdm * raw[j];
    float t = mu_sp[j] * mu_sp[j];
    sp2 = (j == 0) ? t : sp2 + t;
  }
  const float mu_t = sqrtf(1.f / c + sp2);

  float sv = 0.f, rv2 = 0.f, lqs = 0.f;
  for (int j = 0; j < n; ++j) {
    float sig = softplus_f(raw[n + (ns == 1 ? 0 : j)]);
    float e = eps[j];
    v[j] = sig * e;
    float t = mu_sp[j] * v[j];
    sv = (j == 0) ? t : sv + t;
    float t2 = v[j] * v[j];
    rv2 = (j == 0) ? t2 : rv2 + t2;
    float tq = -0.5f * (e * e + F(LOG_2PI)) - logf(sig);
    lqs = (j == 0) ? tq : lqs + tq;
  }
  // PT_{mu0->mu}((0, v)) with e = alpha - 1 in the difference form
  const float d_t = mu_t - inv_sqrt_c;
  const float e_a = fmaxf(c * (sp2 - d_t * d_t), 0.f) / 2.f;
  const float coef = c * sv / (2.f + e_a);
  const float u_t = coef * (inv_sqrt_c + mu_t);
  float usp2 = 0.f;
  for (int j = 0; j < n; ++j) {
    u_sp[j] = v[j] + coef * mu_sp[j];
    float t = u_sp[j] * u_sp[j];
    usp2 = (j == 0) ? t : usp2 + t;
  }
  // z = exp_map(mu, u), then project() recomputes the time coordinate
  const float usq = fmaxf(usp2 - u_t * u_t, 0.f);
  const float tt = -c * usq;
  const float cu = cos_u_sgn(tt, -1);
  const float sd = sindiv_u(tt);
  float zsp2 = 0.f;
  for (int j = 0; j < n; ++j) {
    float zj = cu * mu_sp[j] + sd * u_sp[j];
    z[1 + j] = zj;
    float t = zj * zj;
    zsp2 = (j == 0) ? t : zsp2 + t;
  }
  const float z_t = sqrtf(1.f / c + zsp2);
  z[0] = z_t;

  const float q = lqs - F(n - 1.0) * log_sindiv_u_neg(k * rv2);
  const float dz_t = z_t - inv_sqrt_c;
  const float e0 = fmaxf(c * (zsp2 - dz_t * dz_t), 0.f) / 2.f + TINY;
  const float r0 = acosh_1p(e0) * inv_sqrt_c;
  const float r02 = r0 * r0;
  const float p = -0.5f * r02 - F(0.5 * n * LOG_2PI)
                  - F(n - 1.0) * log_sindiv_u_neg(k * r02);
  *lq = q;
  *lp = p;
  *kl = q - p;
}

// tail_kernels._tile_vmf: vMF on S^2 (m = 3): inverse-CDF cosine,
// Householder reflection to mu, closed-form log C_3 and A_3
__device__ void tile_vmf_s2(const float* raw, const float* eps, float k,
                            float* z, float* kl, float* lq, float* lp) {
  const float m = 3.f;
  const float kk = fmaxf(k, TINY);
  const float sqrt_k = sqrtf(kk);
  const float r = 1.f / sqrt_k;
  const float mt0 = raw[0], mt1 = raw[1];
  const float kap = softplus_f(raw[2]) + 1.f;

  // mu = exp_map_mu0 on the sphere; project() renormalizes to radius R
  const float r2m = mt0 * mt0 + mt1 * mt1;
  const float t_m = kk * r2m;
  const float m_t = cos_u_sgn(t_m, 1) * r;
  const float sdm = sindiv_u(t_m);
  const float ms0 = sdm * mt0, ms1 = sdm * mt1;
  const float mnorm = sqrtf(m_t * m_t + (ms0 * ms0 + ms1 * ms1) + TINY);
  const float scale = r / mnorm;
  const float mu_t = m_t * scale * sqrt_k;
  const float mu0s = ms0 * scale * sqrt_k, mu1s = ms1 * scale * sqrt_k;

  // cosine via the exact inverse CDF
  const float u_eps = eps[0];
  const float kap_s = fmaxf(kap, F(1e-6));
  float w = 1.f + log1pf((1.f - u_eps) * (expf(-2.f * kap_s) - 1.f)) / kap_s;
  w = fminf(fmaxf(w, F(-1.0 + 1e-7)), F(1.0 - 1e-7));
  const float g0 = eps[1], g1 = eps[2];
  const float gn = sqrtf((g0 * g0 + g1 * g1) + TINY);
  const float sin_w = sqrtf(fmaxf(1.f - w * w, TINY));
  const float zp0 = sin_w * (g0 / gn), zp1 = sin_w * (g1 / gn);

  // Householder e1 -> mu_unit (degenerate at mu ~ e1 -> identity)
  const float uh_t = 1.f - mu_t;
  const float uh0 = -mu0s, uh1 = -mu1s;
  const float un = sqrtf(uh_t * uh_t + (uh0 * uh0 + uh1 * uh1) + TINY);
  const float inv_un = 1.f / fmaxf(un, EPS);
  const float uht = uh_t * inv_un, uhs0 = uh0 * inv_un, uhs1 = uh1 * inv_un;
  const float dotu = uht * w + (uhs0 * zp0 + uhs1 * zp1);
  float zu_t = w - 2.f * dotu * uht;
  float zu0 = zp0 - 2.f * dotu * uhs0;
  float zu1 = zp1 - 2.f * dotu * uhs1;
  if (un < EPS) {
    zu_t = w;
    zu0 = zp0;
    zu1 = zp1;
  }
  z[0] = zu_t * r;
  z[1] = zu0 * r;
  z[2] = zu1 * r;

  // log C_3(kappa) with log I_{1/2}(x) e^{-x}
  //   = 0.5 log(2/(pi x)) + log1p(-e^{-2x}) - log 2
  const float log_ive_nu = 0.5f * logf(2.f / (F(PI) * kap))
                           + log1pf(-expf(-2.f * kap)) - F(0.6931471805599453);
  const float a_m = 1.f / tanhf(kap) - 1.f / kap;
  const float log_cm = F(m / 2.0 - 1.0) * logf(kap) - F(1.5 * LOG_2PI)
                       - (log_ive_nu + kap);
  const float cosv = mu_t * zu_t + (mu0s * zu0 + mu1s * zu1);
  const float area = 1.f * logf(kk);
  *lq = log_cm + kap * cosv + area;
  *lp = F(-LOG_4PI) + area;
  *kl = kap * a_m + log_cm + F(LOG_4PI);
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
      tile_wrapped_h(ri, ei, t.dim[i], t.nscale[i], kvec[i], zi, &kl, &q, &p);
    } else {
      tile_vmf_s2(ri, ei, kvec[i], zi, &kl, &q, &p);
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
  if (nc < 1 || nc > MAX_COMPS) return (int)cudaErrorInvalidValue;
  TailTable t;
  t.nc = nc;
  for (int i = 0; i < nc; ++i) {
    t.kind[i] = table[6 * i + 0];
    t.dim[i] = table[6 * i + 1];
    t.nscale[i] = table[6 * i + 2];
    t.raw_off[i] = table[6 * i + 3];
    t.eps_off[i] = table[6 * i + 4];
    t.z_off[i] = table[6 * i + 5];
    if (t.dim[i] < 1 || t.dim[i] > MAX_DIM) return (int)cudaErrorInvalidValue;
  }
  if (B > 0) {
    const int blocks = (B + THREADS - 1) / THREADS;
    tail_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        raw, eps, kvec, z, aux, B, W, E, Z, t);
  }
  return (int)cudaGetLastError();
}
