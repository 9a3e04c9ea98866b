// Frozen copy of mvae_torch/kernels/csrc/tail_tiles.cuh as it stood at commit
// b875f52: the tail kernels' previous design (every product on the
// warp-a-component geometry, each tile serial on one thread), built beside
// the package's kernels to hold them bit for bit and time them in turns
// (chip_smoke.py, scripts/torch_tail_turns.py, tests). Not part of the
// package.
//
// The fused tail's forward tiles, shared by the forward kernel (tail_fwd.cu)
// and the backward kernel (tail_bwd.cu), which recomputes each row's
// forward with these same expressions before its reverse sweep.
//
// Port of the tiles of mvae_tpu/kernels/tail_kernels.py (_tile_normal :232,
// _tile_wrapped_lorentz :245, _tile_vmf :386, _tile_wrapped_stereo :462 with
// _logq_drawn_rows :540 and _logp_prior_rows :610, _tile_wrapped_sphere
// :301) in the order of the plain version
// mvae_torch/kernels/tail_kernels.py::tail_forward_ref: the exp-based
// cosh/sinh clipped at 85, the series window at |u| < 1e-2, the vMF cosine
// clip, the Householder degeneracy guard, and reductions over a row's
// coordinates summed in index order. Both kernels are compiled without fast
// math and with --fmad=false, so they round like the plain version's
// separate PyTorch ops and the backward's recomputed intermediates equal the
// forward kernel's bit for bit.
//
// Register-resident tiles: every tile that holds a row's vectors is a
// template on the component dimension N. For N > 0 (the kernels instantiate
// 2, 3 and 6, the dimensions of the supported specs) the coordinate loops
// unroll fully and every vector lives in registers; N = 0 is the generic
// instantiation, the dimension n taken at run time up to MAX_DIM and the
// vectors in local memory. The normal and vMF tiles hold no vectors.
//
// The wrapped and vMF tiles record their intermediates in a struct (HSaved,
// VmfSaved, StereoSaved, SphSaved) for the backward; the forward kernel
// discards them.
//
// The stereographic tile (kinds d/p/u) takes the component's static
// curvature sign (-1, +1, or 0 for the universal kind, whose branch follows
// the run-time sign of K per row) and its count of wrap-image pairs from the
// table. Its draw, stereo_draw, is stereo_example (the per-example scalars
// |mu|^2 and sum log sigma) followed by stereo_draw_at (the rest, on those
// scalars); the IWAE chunk reparam kernel (reparam_stereo.cu) calls the two
// itself, once per example and once per sample, so tile and kernel evaluate
// the same expressions. At wraps = 1 (the default) the drawn-radius sum
// evaluates its 9 branches once, unrolled and independent of one another,
// and keeps them (LqCommon.t) for the log-sum-exp and the reverse sweep;
// at other wraps it loops over them as the plain version does.
//
// The embedded-sphere tile (kind s, K > 0 pinned) shares the sigma cap, the
// drawn-radius sum logq_drawn and the prior pair logp_prior with the
// stereographic tile. Its ambient point has dim + 1 <= MAX_DIM + 1
// coordinates: the time coordinate is a scalar of its own and every array
// holds the dim spatial ones.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define MAX_COMPS 16
#define MAX_DIM 32

enum {
  KIND_NORMAL = 0,
  KIND_WRAPPED_H = 1,
  KIND_VMF_S2 = 2,
  KIND_WRAPPED_STEREO = 3,
  KIND_WRAPPED_S = 4
};
#define TABLE_COLS 8

// The vectors of a tile instantiated on N: N entries, or MAX_DIM for the
// generic instantiation (N = 0), whose dimension is the run-time n
#define TAIL_ARR(N) ((N) > 0 ? (N) : MAX_DIM)
#define TAIL_DIM(N, n) ((N) > 0 ? (N) : (n))

struct TailTable {
  int nc;
  int kind[MAX_COMPS];
  int dim[MAX_COMPS];
  int nscale[MAX_COMPS];
  int raw_off[MAX_COMPS];
  int eps_off[MAX_COMPS];
  int z_off[MAX_COMPS];
  int sign[MAX_COMPS];
  int wraps[MAX_COMPS];
};

// Fill a TailTable from the host array of nc rows (kind, dim, n_scale,
// raw_off, eps_off, z_off, sign, wraps); false when a row is out of range.
static inline bool tail_table_from(const int* table, int nc, TailTable* t) {
  if (nc < 1 || nc > MAX_COMPS) return false;
  t->nc = nc;
  for (int i = 0; i < nc; ++i) {
    const int* row = table + TABLE_COLS * i;
    t->kind[i] = row[0];
    t->dim[i] = row[1];
    t->nscale[i] = row[2];
    t->raw_off[i] = row[3];
    t->eps_off[i] = row[4];
    t->z_off[i] = row[5];
    t->sign[i] = row[6];
    t->wraps[i] = row[7];
    if (t->dim[i] < 1 || t->dim[i] > MAX_DIM) return false;
    if (t->kind[i] < KIND_NORMAL || t->kind[i] > KIND_WRAPPED_S)
      return false;
    if (t->sign[i] < -1 || t->sign[i] > 1 || t->wraps[i] < 0) return false;
  }
  return true;
}

// f32 constants rounded from their double values, as PyTorch rounds a
// Python float scalar against a float32 tensor
#define F(x) ((float)(x))
#define LOG_2PI 1.8378770664093453
#define LOG_4PI 2.5310242469692907
#define PI 3.141592653589793
#define TINY 1e-15f
#define EPS 1e-6f
#define CUTOFF 1e-2f
#define SHELL_DELTA 1e-3f
#define ONE_M_EPS F(1.0 - 1e-6)
#define DEAD_TERM -1e30f

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

// sindiv_u - 1 inside the series window (stable._log_sindiv_series)
__device__ __forceinline__ float sindiv_m1_series(float us) {
  return us * (F(-1.0 / 6) + us * (F(1.0 / 120) + us * (F(-1.0 / 5040)
                                                 + us * F(1.0 / 362880))));
}

// stable._log_sindiv_u_sgn with sign < 0
__device__ float log_sindiv_u_neg(float u) {
  if (fabsf(u) < CUTOFF) return log1pf(sindiv_m1_series(u));
  float su = sqrtf(fabsf(u));
  return su + log1pf(-expf(-2.f * su)) - logf(2.f * su);
}

// stable._acosh_1p
__device__ __forceinline__ float acosh_1p(float u) {
  return log1pf(u + sqrtf(fmaxf(u, 0.f) * (u + 2.f)));
}

// tail_kernels._tile_normal
__device__ __forceinline__ void tile_normal(const float* raw, const float* eps,
                                            int n, int ns, float* z, float* kl,
                                            float* lq, float* lp) {
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

// Intermediates of one row of the hyperboloid tile (names as in the plain
// version; *_in is a clamp's input)
template <int N>
struct HSaved {
  float c, inv_sqrt_c, inv_c, r2m, sdm, sp2, mu_t, sv, rv2, d_t, ea_in, e_a,
      coef, u_t, usp2, usq_in, usq, tt, cu, sd, zsp2, z_t, dz_t, e0_in, e0,
      r0a, r0, r02;
  float mu_sp[TAIL_ARR(N)], sig[TAIL_ARR(N)], v[TAIL_ARR(N)],
      u_sp[TAIL_ARR(N)], z_sp[TAIL_ARR(N)];
};

// tail_kernels._tile_wrapped_lorentz: wrapped normal on the hyperboloid
// (K < 0 pinned); log q at the drawn tangent, log p at the acosh_1p radius
template <int N>
__device__ __forceinline__ void tile_wrapped_h(const float* raw,
                                               const float* eps, int n, int ns,
                                               float k, float* z, float* kl,
                                               float* lq, float* lp,
                                               HSaved<N>& s) {
  const int nn = TAIL_DIM(N, n);
  s.c = fmaxf(-k, TINY);
  s.inv_sqrt_c = rsqrtf(s.c);

  float r2m = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    float t = raw[j] * raw[j];
    r2m = (j == 0) ? t : r2m + t;
  }
  s.r2m = r2m;
  s.sdm = sindiv_u(k * r2m);
  float sp2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.mu_sp[j] = s.sdm * raw[j];
    float t = s.mu_sp[j] * s.mu_sp[j];
    sp2 = (j == 0) ? t : sp2 + t;
  }
  s.sp2 = sp2;
  s.inv_c = 1.f / s.c;
  s.mu_t = sqrtf(s.inv_c + sp2);

  float sv = 0.f, rv2 = 0.f, lqs = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    float sig = softplus_f(raw[n + (ns == 1 ? 0 : j)]);
    float e = eps[j];
    s.sig[j] = sig;
    s.v[j] = sig * e;
    float t = s.mu_sp[j] * s.v[j];
    sv = (j == 0) ? t : sv + t;
    float t2 = s.v[j] * s.v[j];
    rv2 = (j == 0) ? t2 : rv2 + t2;
    float tq = -0.5f * (e * e + F(LOG_2PI)) - logf(sig);
    lqs = (j == 0) ? tq : lqs + tq;
  }
  s.sv = sv;
  s.rv2 = rv2;
  // PT_{mu0->mu}((0, v)) with e = alpha - 1 in the difference form
  s.d_t = s.mu_t - s.inv_sqrt_c;
  s.ea_in = s.c * (sp2 - s.d_t * s.d_t);
  s.e_a = fmaxf(s.ea_in, 0.f) / 2.f;
  s.coef = s.c * sv / (2.f + s.e_a);
  s.u_t = s.coef * (s.inv_sqrt_c + s.mu_t);
  float usp2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.u_sp[j] = s.v[j] + s.coef * s.mu_sp[j];
    float t = s.u_sp[j] * s.u_sp[j];
    usp2 = (j == 0) ? t : usp2 + t;
  }
  s.usp2 = usp2;
  // z = exp_map(mu, u), then project() recomputes the time coordinate
  s.usq_in = usp2 - s.u_t * s.u_t;
  s.usq = fmaxf(s.usq_in, 0.f);
  s.tt = -s.c * s.usq;
  s.cu = cos_u_sgn(s.tt, -1);
  s.sd = sindiv_u(s.tt);
  float zsp2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    float zj = s.cu * s.mu_sp[j] + s.sd * s.u_sp[j];
    s.z_sp[j] = zj;
    z[1 + j] = zj;
    float t = zj * zj;
    zsp2 = (j == 0) ? t : zsp2 + t;
  }
  s.zsp2 = zsp2;
  s.z_t = sqrtf(1.f / s.c + zsp2);
  z[0] = s.z_t;

  const float q = lqs - F(nn - 1.0) * log_sindiv_u_neg(k * rv2);
  s.dz_t = s.z_t - s.inv_sqrt_c;
  s.e0_in = s.c * (zsp2 - s.dz_t * s.dz_t);
  s.e0 = fmaxf(s.e0_in, 0.f) / 2.f + TINY;
  s.r0a = acosh_1p(s.e0);
  s.r0 = s.r0a * s.inv_sqrt_c;
  s.r02 = s.r0 * s.r0;
  const float p = -0.5f * s.r02 - F(0.5 * nn * LOG_2PI)
                  - F(nn - 1.0) * log_sindiv_u_neg(k * s.r02);
  *lq = q;
  *lp = p;
  *kl = q - p;
}

// Intermediates of one row of the vMF tile
struct VmfSaved {
  float kk, sqrt_k, r, kap, r2m, t_m, cm, m_t, sdm, ms0, ms1, mnorm, scale,
      a_t, a0, a1, mu_t, mu0s, mu1s, kap_s, ex, arg, lg, w_in, w, gd0, gd1,
      omw, sin_w, zp0, zp1, uh_t, uh0, uh1, un, inv_un, uht, uhs0, uhs1,
      dotu, zu_t, zu0, zu1, th, a_m, cosv;
};

// tail_kernels._tile_vmf: vMF on S^2 (m = 3): inverse-CDF cosine,
// Householder reflection to mu, closed-form log C_3 and A_3
__device__ __forceinline__ void tile_vmf_s2(const float* raw, const float* eps,
                                            float k, float* z, float* kl,
                                            float* lq, float* lp, VmfSaved& s) {
  const float m = 3.f;
  s.kk = fmaxf(k, TINY);
  s.sqrt_k = sqrtf(s.kk);
  s.r = 1.f / s.sqrt_k;
  const float mt0 = raw[0], mt1 = raw[1];
  s.kap = softplus_f(raw[2]) + 1.f;

  // mu = exp_map_mu0 on the sphere; project() renormalizes to radius R
  s.r2m = mt0 * mt0 + mt1 * mt1;
  s.t_m = s.kk * s.r2m;
  s.cm = cos_u_sgn(s.t_m, 1);
  s.m_t = s.cm * s.r;
  s.sdm = sindiv_u(s.t_m);
  s.ms0 = s.sdm * mt0;
  s.ms1 = s.sdm * mt1;
  s.mnorm = sqrtf(s.m_t * s.m_t + (s.ms0 * s.ms0 + s.ms1 * s.ms1) + TINY);
  s.scale = s.r / s.mnorm;
  s.a_t = s.m_t * s.scale;
  s.a0 = s.ms0 * s.scale;
  s.a1 = s.ms1 * s.scale;
  s.mu_t = s.a_t * s.sqrt_k;
  s.mu0s = s.a0 * s.sqrt_k;
  s.mu1s = s.a1 * s.sqrt_k;

  // cosine via the exact inverse CDF
  const float u_eps = eps[0];
  s.kap_s = fmaxf(s.kap, F(1e-6));
  s.ex = expf(-2.f * s.kap_s);
  s.arg = (1.f - u_eps) * (s.ex - 1.f);
  s.lg = log1pf(s.arg);
  s.w_in = 1.f + s.lg / s.kap_s;
  s.w = fminf(fmaxf(s.w_in, F(-1.0 + 1e-7)), F(1.0 - 1e-7));
  const float g0 = eps[1], g1 = eps[2];
  const float gn = sqrtf((g0 * g0 + g1 * g1) + TINY);
  s.gd0 = g0 / gn;
  s.gd1 = g1 / gn;
  s.omw = 1.f - s.w * s.w;
  s.sin_w = sqrtf(fmaxf(s.omw, TINY));
  s.zp0 = s.sin_w * s.gd0;
  s.zp1 = s.sin_w * s.gd1;

  // Householder e1 -> mu_unit (degenerate at mu ~ e1 -> identity)
  s.uh_t = 1.f - s.mu_t;
  s.uh0 = -s.mu0s;
  s.uh1 = -s.mu1s;
  s.un = sqrtf(s.uh_t * s.uh_t + (s.uh0 * s.uh0 + s.uh1 * s.uh1) + TINY);
  s.inv_un = 1.f / fmaxf(s.un, EPS);
  s.uht = s.uh_t * s.inv_un;
  s.uhs0 = s.uh0 * s.inv_un;
  s.uhs1 = s.uh1 * s.inv_un;
  s.dotu = s.uht * s.w + (s.uhs0 * s.zp0 + s.uhs1 * s.zp1);
  s.zu_t = s.w - 2.f * s.dotu * s.uht;
  s.zu0 = s.zp0 - 2.f * s.dotu * s.uhs0;
  s.zu1 = s.zp1 - 2.f * s.dotu * s.uhs1;
  if (s.un < EPS) {
    s.zu_t = s.w;
    s.zu0 = s.zp0;
    s.zu1 = s.zp1;
  }
  z[0] = s.zu_t * s.r;
  z[1] = s.zu0 * s.r;
  z[2] = s.zu1 * s.r;

  // log C_3(kappa) with log I_{1/2}(x) e^{-x}
  //   = 0.5 log(2/(pi x)) + log1p(-e^{-2x}) - log 2
  const float kap = s.kap;
  const float log_ive_nu = 0.5f * logf(2.f / (F(PI) * kap))
                           + log1pf(-expf(-2.f * kap)) - F(0.6931471805599453);
  s.th = tanhf(kap);
  s.a_m = 1.f / s.th - 1.f / kap;
  const float log_cm = F(m / 2.0 - 1.0) * logf(kap) - F(1.5 * LOG_2PI)
                       - (log_ive_nu + kap);
  s.cosv = s.mu_t * s.zu_t + (s.mu0s * s.zu0 + s.mu1s * s.zu1);
  const float area = 1.f * logf(s.kk);
  *lq = log_cm + kap * s.cosv + area;
  *lp = F(-LOG_4PI) + area;
  *kl = kap * s.a_m + log_cm + F(LOG_4PI);
}

// --- the stereographic family (kinds d/p/u) --------------------------------------

// Horner form of 1 + c1 u + ... + c5 u^5 (stable._poly)
__device__ __forceinline__ float poly5(float u, float c1, float c2, float c3,
                                       float c4, float c5) {
  float acc = 0.f;
  acc = u * (acc + c5);
  acc = u * (acc + c4);
  acc = u * (acc + c3);
  acc = u * (acc + c2);
  acc = u * (acc + c1);
  return 1.f + acc;
}

#define TANDIV_C F(1.0 / 3), F(2.0 / 15), F(17.0 / 315), F(62.0 / 2835), \
                 F(1382.0 / 155925)
#define ARCTANDIV_C F(-1.0 / 3), F(1.0 / 5), F(-1.0 / 7), F(1.0 / 9), \
                    F(-1.0 / 11)

// stable._tandiv_u_sgn: tan(sqrt u) / sqrt u, tanh for u < 0; a pinned sign
// drops the branch it cannot take
__device__ float tandiv_u(float u, int sign) {
  if (fabsf(u) < CUTOFF) return poly5(u, TANDIV_C);
  const float su = sqrtf(fabsf(u));
  if (sign > 0 || (sign == 0 && u > 0.f)) return tanf(su) / su;
  return tanhf(su) / su;
}

// stable.atanh_clamped
__device__ __forceinline__ float atanh_clamped(float x) {
  x = fminf(fmaxf(x, F(-1.0 + 1e-6)), ONE_M_EPS);
  return 0.5f * log1pf(2.f * x / (1.f - x));
}

// stable._arctandiv_u_sgn: atan(sqrt w) / sqrt w, artanh for w < 0
__device__ float arctandiv_u(float w, int sign) {
  if (fabsf(w) < CUTOFF) return poly5(w, ARCTANDIV_C);
  if (sign > 0 || (sign == 0 && w > 0.f)) {
    const float sw = sqrtf(fmaxf(w, TINY));
    return atanf(sw) / sw;
  }
  const float sw =
      sqrtf(fminf(fmaxf(-w, TINY), F((1.0 - 1e-6) * (1.0 - 1e-6))));
  return atanh_clamped(sw) / sw;
}

// stable.log_abs_sin_soft: log|sin x| floored near the zeros of sin at
// m pi, m >= 1, by d = delta min(taper / pi, 1)^3, from sn = sin x (the
// wrap branches share x and take sin x once)
__device__ __forceinline__ float log_abs_sin_soft_at(float sn, float taper) {
  const float t = fminf(taper * F(1.0 / PI), 1.f);
  const float d = SHELL_DELTA * t * t * t;
  return 0.5f * logf(sn * sn + d * d);
}

// the same from x itself (sn = sin x)
__device__ __forceinline__ float log_abs_sin_soft(float x, float taper) {
  return log_abs_sin_soft_at(sinf(x), taper);
}

// stable._log_sindiv_u_sgn_soft
__device__ float log_sindiv_u_soft(float u, int sign) {
  if (sign < 0 || (sign == 0 && !(u > 0.f)) || fabsf(u) < CUTOFF)
    return log_sindiv_u_neg(u);
  const float su = sqrtf(fabsf(u));
  return log_abs_sin_soft(su, su) - logf(fmaxf(su, EPS));
}

// The ball radius (1 - eps) / sqrt(-min(K, -tiny)) of a K < 0 component
__device__ __forceinline__ float ball_smax(float k) {
  return ONE_M_EPS * rsqrtf(-fminf(k, -TINY));
}

// tail_kernels._ball_scale: the factor of stereographic.project
__device__ __forceinline__ float ball_scale(float k, float smax, float xn2) {
  if (!(k < 0.f)) return 1.f;
  return fminf(smax * rsqrtf(fmaxf(xn2, TINY)), 1.f);
}

// The branches of the drawn-radius sum kept at wraps = 1: m = -4 .. 4
#define LQ_BRANCHES 9

// The scalars every branch of the drawn-radius sum shares (sn = sin x_red,
// which every wrap branch takes) and, at wraps = 1, the branches themselves
struct LqCommon {
  float vsq_g, r, quad, c0, kpos, sqk, period, fl, d, rp, u0, x_red, sn;
  int pos;   // the positive-curvature branch is taken (static or K > 0)
  float t[LQ_BRANCHES];  // branch m at m + 4 (wraps = 1)
  int live;              // bit m + 4 set where branch m is live (wraps = 1)
};

__device__ __forceinline__ void lq_common(int n, int sign, float k, float vsq,
                                          float s2, LqCommon& c) {
  c.vsq_g = vsq + TINY;
  c.r = sqrtf(c.vsq_g);
  c.quad = s2 / c.vsq_g;
  c.c0 = F(0.5 * n * LOG_2PI);
  c.kpos = fmaxf(k, 1e-20f);
  c.sqk = sqrtf(c.kpos);
  c.period = F(2.0 * PI) / c.sqk;
  c.fl = floorf(c.r / c.period + 0.5f);
  c.d = c.r - c.period * c.fl;
  c.pos = sign > 0 || k > 0.f;
  c.rp = c.pos ? fabsf(c.d) : c.r;
  c.u0 = c.pos ? c.kpos * c.rp * c.rp : k * c.vsq_g;
  c.x_red = c.sqk * c.rp;
}

// Branch m of the drawn-radius sum: log N(rb v_hat; 0, sigma) - logdet(rb)
// at rb = rp + m T; false (and DEAD_TERM) for a wrap image that carries no
// mass (K <= 0, or a z-score that would overflow)
__device__ __forceinline__ bool lq_term(int n, int sign, float ls,
                                        const LqCommon& c, int m, float* rb_out,
                                        float* t_out) {
  const float nm1 = F(n - 1.0);
  float rb = c.rp + (float)m * c.period;
  float logdet;
  if (m == 0) {
    logdet = nm1 * log_sindiv_u_soft(c.u0, sign);
  } else {
    const bool live = c.pos && (rb * rb * c.quad < 1e30f);
    if (!live) {
      *rb_out = c.rp;
      *t_out = DEAD_TERM;
      return false;
    }
    const float xb = c.sqk * fabsf(rb);
    logdet = nm1 * (log_abs_sin_soft_at(c.sn, xb) - logf(fmaxf(xb, TINY)));
  }
  *rb_out = rb;
  *t_out = -0.5f * rb * rb * c.quad - ls - c.c0 - logdet;
  return true;
}

// tail_kernels._logq_drawn_rows; `mx` and `acc` are the shift and the sum of
// the log-sum-exp (1 term: mx is the term and acc 1)
__device__ __forceinline__ float logq_drawn(int n, int wraps, int sign, float k,
                                            float vsq, float s2, float ls,
                                            LqCommon& c, float* mx_out,
                                            float* acc_out) {
  *mx_out = 0.f;
  *acc_out = 1.f;
  if (sign < 0)  // pinned negative curvature never wraps
    return -0.5f * s2 - ls - F(0.5 * n * LOG_2PI)
           - F(n - 1.0) * log_sindiv_u_soft(k * (vsq + TINY), sign);
  lq_common(n, sign, k, vsq, s2, c);
  float rb, t;
  if (wraps == 0) {
    lq_term(n, sign, ls, c, 0, &rb, &t);
    *mx_out = t;
    return t;
  }
  c.sn = sinf(c.x_red);
  float mx = 0.f;
  if (wraps == 1) {  // 9 independent branches, each evaluated once, kept
    c.live = 0;
#pragma unroll
    for (int i = 0; i < LQ_BRANCHES; ++i) {
      if (lq_term(n, sign, ls, c, i - 4, &rb, &c.t[i])) c.live |= 1 << i;
      mx = (i == 0) ? c.t[i] : fmaxf(mx, c.t[i]);
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < LQ_BRANCHES; ++i) acc = acc + expf(c.t[i] - mx);
    *mx_out = mx;
    *acc_out = acc;
    return mx + logf(acc);
  }
  const int M = wraps + 3;
  for (int m = -M; m <= M; ++m) {
    lq_term(n, sign, ls, c, m, &rb, &t);
    mx = (m == -M) ? t : fmaxf(mx, t);
  }
  float acc = 0.f;
  for (int m = -M; m <= M; ++m) {
    lq_term(n, sign, ls, c, m, &rb, &t);
    acc = acc + expf(t - mx);
  }
  *mx_out = mx;
  *acc_out = acc;
  return mx + logf(acc);
}

// The prior's branches: the principal one and the nearest wrap-image pair
struct LpSaved {
  float r02, up, kp, sqk0, period, t[3], rb[3], mx, acc;
  int live[3], wrapped;
};

// tail_kernels._logp_prior_rows
__device__ __forceinline__ float logp_prior(int n, int wraps, int sign, float k,
                                            float r0, LpSaved& s) {
  const float nm1 = F(n - 1.0);
  const float c0 = F(0.5 * n * LOG_2PI);
  s.r02 = r0 * r0;
  s.up = k * s.r02;
  s.t[0] = -0.5f * s.r02 - c0 - nm1 * log_sindiv_u_soft(s.up, sign);
  s.wrapped = wraps > 0 && sign >= 0;
  if (!s.wrapped) return s.t[0];
  s.kp = fmaxf(k, 1e-20f);
  s.sqk0 = sqrtf(s.kp);
  s.period = F(2.0 * PI) / s.sqk0;
  const float sn0 = sinf(s.sqk0 * r0);
#pragma unroll
  for (int i = 1; i <= 2; ++i) {
    const float rb_raw = r0 + (i == 1 ? 1.f : -1.f) * s.period;
    s.live[i] = k > 0.f && fabsf(rb_raw) < 1e15f;
    s.rb[i] = s.live[i] ? rb_raw : r0;
    const float rb = s.rb[i];
    const float logn = -0.5f * rb * rb - c0;
    const float lsk = log_abs_sin_soft_at(sn0, s.sqk0 * fabsf(rb))
                      - logf(s.sqk0);
    const float logd = nm1 * (lsk - logf(fmaxf(fabsf(rb), TINY)));
    s.t[i] = s.live[i] ? logn - logd : DEAD_TERM;
  }
  s.mx = fmaxf(fmaxf(s.t[0], s.t[1]), s.t[2]);
  s.acc = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) s.acc = s.acc + expf(s.t[i] - s.mx);
  return s.mx + logf(s.acc);
}

// Intermediates of one stereographic draw (names as in the plain version;
// *0 is a value before its ball clamp or guard)
template <int N>
struct StereoSaved {
  float smax, x2, ls, vsq, xv, s2, ug, g0, bsg, g, gxv, g2v, a, b, den0, inv,
      p, q, zn2pre, bsz, zn2m, zn2, sq, w, ad, r0, lq_mx, lq_acc;
  LqCommon lqc;
  LpSaved lp;
  float v[TAIL_ARR(N)], zpre[TAIL_ARR(N)], z[TAIL_ARR(N)];
};

// The per-example scalars of a draw, each summed in coordinate order:
// |mu|^2 and sum log sigma (tail_kernels._stereo_draw's x2 and ls)
template <int N>
__device__ __forceinline__ void stereo_example(int n, const float* mu,
                                               const float* sig, float* x2_out,
                                               float* ls_out) {
  const int nn = TAIL_DIM(N, n);
  float x2 = 0.f, ls = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    const float t0 = mu[j] * mu[j], t1 = logf(fmaxf(sig[j], TINY));
    x2 = (j == 0) ? t0 : x2 + t0;
    ls = (j == 0) ? t1 : ls + t1;
  }
  *x2_out = x2;
  *ls_out = ls;
}

// tail_kernels._stereo_draw on an example's hoisted scalars: smax =
// ball_smax(k) and x2, ls from stereo_example, so that a caller drawing
// several samples of one example computes them once (the IWAE chunk
// reparam); the same expressions as stereo_draw, bit for bit
template <int N>
__device__ __forceinline__ void stereo_draw_at(int n, int sign, int wraps,
                                               float k, float smax, float x2,
                                               float ls, const float* mu,
                                               const float* sig,
                                               const float* eps, float* lq,
                                               float* lp, StereoSaved<N>& s) {
  const int nn = TAIL_DIM(N, n);
  s.smax = smax;
  s.x2 = x2;
  s.ls = ls;
  float vsq = 0.f, xv = 0.f, s2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    const float vj = sig[j] * eps[j];
    s.v[j] = vj;
    const float t2 = vj * vj, t3 = mu[j] * vj, t4 = eps[j] * eps[j];
    vsq = (j == 0) ? t2 : vsq + t2;
    xv = (j == 0) ? t3 : xv + t3;
    s2 = (j == 0) ? t4 : s2 + t4;
  }
  s.vsq = vsq;
  s.xv = xv;
  s.s2 = s2;

  s.ug = k * vsq / 4.f;
  s.g0 = 0.5f * tandiv_u(s.ug, sign);
  s.bsg = (sign <= 0) ? ball_scale(k, s.smax, s.g0 * s.g0 * vsq) : 1.f;
  s.g = (sign <= 0) ? s.g0 * s.bsg : s.g0;
  s.gxv = s.g * xv;
  s.g2v = s.g * s.g * vsq;
  s.a = 1.f - 2.f * k * s.gxv - k * s.g2v;
  s.b = (1.f + k * x2) * s.g;
  s.den0 = 1.f - 2.f * k * s.gxv + k * k * x2 * s.g2v;
  const float den = (fabsf(s.den0) < 1e-6f) ? 1e-6f : s.den0;
  s.inv = 1.f / den;
  s.p = s.a * s.inv;
  s.q = s.b * s.inv;
  float zn2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.zpre[j] = s.p * mu[j] + s.q * s.v[j];
    const float t = s.zpre[j] * s.zpre[j];
    zn2 = (j == 0) ? t : zn2 + t;
  }
  s.zn2pre = zn2;
  if (sign <= 0) {
    s.bsz = ball_scale(k, s.smax, zn2);
    #pragma unroll
    for (int j = 0; j < nn; ++j) s.z[j] = s.zpre[j] * s.bsz;
    s.zn2m = zn2 * s.bsz * s.bsz;
    s.zn2 = fmaxf(s.zn2m, 0.f);
  } else {
    s.bsz = 1.f;
    #pragma unroll
    for (int j = 0; j < nn; ++j) s.z[j] = s.zpre[j];
    s.zn2m = zn2;
    s.zn2 = zn2;
  }

  *lq = logq_drawn(n, wraps, sign, k, vsq, s2, ls, s.lqc, &s.lq_mx,
                   &s.lq_acc);
  // the prior's preimage radius straight from z (isotropic sigma = 1)
  s.sq = sqrtf(s.zn2 + TINY);
  s.w = k * s.zn2;
  s.ad = arctandiv_u(s.w, sign);
  s.r0 = 2.f * s.sq * s.ad;
  *lp = logp_prior(n, wraps, sign, k, s.r0, s.lp);
}

// tail_kernels._stereo_draw: z = mu (+)_K exp_0(sig eps) by per-row Gram
// coefficients, log q by the drawn-radius branch sum, the prior's log p
template <int N>
__device__ __forceinline__ void stereo_draw(int n, int sign, int wraps,
                                            float k, const float* mu,
                                            const float* sig, const float* eps,
                                            float* lq, float* lp,
                                            StereoSaved<N>& s) {
  float x2, ls;
  stereo_example<N>(n, mu, sig, &x2, &ls);
  stereo_draw_at<N>(n, sign, wraps, k, ball_smax(k), x2, ls, mu, sig, eps, lq,
                    lp, s);
}

// components.cap_sigma_positive_k for one coordinate: the scale saturating
// at capr = pi / sqrt(max(K, 1e-12)); records the intermediates
__device__ __forceinline__ float sigma_cap(float sig0, float capr, float* tq,
                                           float* tc, float* w6, float* pw) {
  *tq = sig0 / capr;
  *tc = fminf(*tq, 8.f);
  const float tc2 = *tc * *tc;
  *w6 = 1.f + tc2 * tc2 * tc2;
  *pw = powf(*w6, F(-1.0 / 6.0));
  return capr * *tc * *pw;
}

// The head of the stereographic tile: the scale with its cap and the mean
template <int N>
struct StereoHead {
  float kc, capr, r2m, um, gm, bsm, smax;
  float sig0[TAIL_ARR(N)], tq[TAIL_ARR(N)], tc[TAIL_ARR(N)],
      w6[TAIL_ARR(N)], pw[TAIL_ARR(N)], sig[TAIL_ARR(N)], mu0[TAIL_ARR(N)],
      mu[TAIL_ARR(N)];
};

// tail_kernels._tile_wrapped_stereo: wrapped normal on d/p/u
template <int N>
__device__ __forceinline__ void tile_wrapped_stereo(
    const float* raw, const float* eps, int n, int ns, int sign, int wraps,
    float k, float* z, float* kl, float* lq, float* lp, StereoHead<N>& h,
    StereoSaved<N>& s) {
  const int nn = TAIL_DIM(N, n);
  // sigma saturates at the positive-K injectivity radius pi / sqrt(K)
  // (components.cap_sigma_positive_k)
  h.kc = fmaxf(k, 1e-12f);
  h.capr = F(PI) * rsqrtf(h.kc);
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    h.sig0[j] = softplus_f(raw[n + (ns == 1 ? 0 : j)]);
    if (sign >= 0) {
      h.sig[j] = sigma_cap(h.sig0[j], h.capr, &h.tq[j], &h.tc[j], &h.w6[j],
                           &h.pw[j]);
    } else {
      h.sig[j] = h.sig0[j];
    }
  }
  // mu = exp_map_mu0(mu_tan) = project(0.5 tandiv mu_tan)
  float r2m = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    const float t = raw[j] * raw[j];
    r2m = (j == 0) ? t : r2m + t;
  }
  h.r2m = r2m;
  h.um = k * r2m / 4.f;
  h.gm = 0.5f * tandiv_u(h.um, sign);
  h.smax = ball_smax(k);
  h.bsm = (sign <= 0) ? ball_scale(k, h.smax, h.gm * h.gm * r2m) : 1.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    h.mu0[j] = h.gm * raw[j];
    h.mu[j] = (sign <= 0) ? h.mu0[j] * h.bsm : h.mu0[j];
  }
  float q, p;
  stereo_draw(n, sign, wraps, k, h.mu, h.sig, eps, &q, &p, s);
  #pragma unroll
  for (int j = 0; j < nn; ++j) z[j] = s.z[j];
  *lq = q;
  *lp = p;
  *kl = q - p;
}

// --- the embedded sphere (kind s) -------------------------------------------------

#define ARCSINDIV_C F(1.0 / 6), F(3.0 / 40), F(15.0 / 336), F(105.0 / 3456)

// stable._arcsindiv_u_pos: asin(sqrt w) / sqrt w for w >= 0, asin spelled
// atan(x / sqrt(1 - x^2)) with x clamped inside the domain
__device__ float arcsindiv_u_pos(float w) {
  if (fabsf(w) < CUTOFF) return poly4(w, ARCSINDIV_C);
  const float pw = fminf(fmaxf(w, TINY), ONE_M_EPS);
  const float sw = sqrtf(pw);
  return atanf(sw * rsqrtf(fmaxf(1.f - pw, EPS))) / sw;
}

// Intermediates of one row of the embedded-sphere tile (names as in the plain
// version; *_in is a clamp's input, *0 a value before its renormalization)
template <int N>
struct SphSaved {
  float kk, sqrt_k, r, kc, capr, r2m, t_m, cm, sdm, m_t, sp2_m, mnorm, sc,
      mu_t, sp2, vsq, s2, ls, smv, d_t, chord2, alpha, den_in, den, coef, w_t,
      nv, nw, pin, u_t, usq, tt, cu, sd, zt0, zn, zsc, z_t, dz_t, chord0, hs,
      half_in, hcap, half, wa, asd, r0, lq_mx, lq_acc;
  LqCommon lqc;
  LpSaved lp;
  float sig0[TAIL_ARR(N)], tq[TAIL_ARR(N)], tc[TAIL_ARR(N)],
      w6[TAIL_ARR(N)], pw[TAIL_ARR(N)], sig[TAIL_ARR(N)], m_sp[TAIL_ARR(N)],
      mu_sp[TAIL_ARR(N)], v[TAIL_ARR(N)], w_sp[TAIL_ARR(N)],
      u_sp[TAIL_ARR(N)], zs0[TAIL_ARR(N)], z_sp[TAIL_ARR(N)];
};

// tail_kernels._tile_wrapped_sphere: wrapped normal on the embedded sphere
// S^n (K > 0 pinned): capped scale, exp_map_mu0 mean head, chord-form
// parallel transport mu0 -> mu with its norm pinned to |v|, exp at mu with
// the renormalizing projection; log q by the drawn-radius sum, log p at the
// chord-form arcsin distance from mu0. z has n + 1 coordinates.
template <int N>
__device__ __forceinline__ void tile_wrapped_sphere(
    const float* raw, const float* eps, int n, int ns, int wraps, float k,
    float* z, float* kl, float* lq, float* lp, SphSaved<N>& s) {
  const int nn = TAIL_DIM(N, n);
  s.kk = fmaxf(k, TINY);
  s.sqrt_k = sqrtf(s.kk);
  s.r = 1.f / s.sqrt_k;
  s.kc = fmaxf(k, 1e-12f);
  s.capr = F(PI) * rsqrtf(s.kc);

  // mu = exp_map_mu0(mu_tan); project() renormalizes to radius R
  float r2m = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    const float t = raw[j] * raw[j];
    r2m = (j == 0) ? t : r2m + t;
  }
  s.r2m = r2m;
  s.t_m = s.kk * r2m;
  s.cm = cos_u_sgn(s.t_m, 1);
  s.m_t = s.cm * s.r;
  s.sdm = sindiv_u(s.t_m);
  float sp2_m = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.m_sp[j] = s.sdm * raw[j];
    const float t = s.m_sp[j] * s.m_sp[j];
    sp2_m = (j == 0) ? t : sp2_m + t;
  }
  s.sp2_m = sp2_m;
  s.mnorm = sqrtf(s.m_t * s.m_t + sp2_m + TINY);
  s.sc = s.r / s.mnorm;
  s.mu_t = s.m_t * s.sc;
  s.sp2 = sp2_m * s.sc * s.sc;

  float vsq = 0.f, s2 = 0.f, ls = 0.f, smv = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.mu_sp[j] = s.m_sp[j] * s.sc;
    s.sig0[j] = softplus_f(raw[n + (ns == 1 ? 0 : j)]);
    s.sig[j] = sigma_cap(s.sig0[j], s.capr, &s.tq[j], &s.tc[j], &s.w6[j],
                         &s.pw[j]);
    s.v[j] = s.sig[j] * eps[j];
    const float t0 = s.v[j] * s.v[j], t1 = eps[j] * eps[j],
                t2 = logf(fmaxf(s.sig[j], TINY)), t3 = s.mu_sp[j] * s.v[j];
    vsq = (j == 0) ? t0 : vsq + t0;
    s2 = (j == 0) ? t1 : s2 + t1;
    ls = (j == 0) ? t2 : ls + t2;
    smv = (j == 0) ? t3 : smv + t3;
  }
  s.vsq = vsq;
  s.s2 = s2;
  s.ls = ls;
  s.smv = smv;

  // PT_{mu0->mu}((0, v)): chord-form alpha, norm pinned to |v|
  s.d_t = s.mu_t - s.r;
  s.chord2 = s.d_t * s.d_t + s.sp2;
  s.alpha = 1.f - s.kk * s.chord2 / 2.f;
  s.den_in = 1.f + s.alpha;
  s.den = fmaxf(s.den_in, EPS);
  s.coef = s.kk * smv / s.den;
  s.w_t = -s.coef * (s.r + s.mu_t);
  float wsp2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.w_sp[j] = s.v[j] - s.coef * s.mu_sp[j];
    const float t = s.w_sp[j] * s.w_sp[j];
    wsp2 = (j == 0) ? t : wsp2 + t;
  }
  s.nv = sqrtf(vsq + TINY);
  s.nw = sqrtf(s.w_t * s.w_t + wsp2 + TINY);
  s.pin = s.nv / s.nw;
  s.u_t = s.w_t * s.pin;
  float usp2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.u_sp[j] = s.w_sp[j] * s.pin;
    const float t = s.u_sp[j] * s.u_sp[j];
    usp2 = (j == 0) ? t : usp2 + t;
  }

  // z = exp_map(mu, u); project() renormalizes
  s.usq = s.u_t * s.u_t + usp2;
  s.tt = s.kk * s.usq;
  s.cu = cos_u_sgn(s.tt, 1);
  s.sd = sindiv_u(s.tt);
  s.zt0 = s.cu * s.mu_t + s.sd * s.u_t;
  float zs02 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.zs0[j] = s.cu * s.mu_sp[j] + s.sd * s.u_sp[j];
    const float t = s.zs0[j] * s.zs0[j];
    zs02 = (j == 0) ? t : zs02 + t;
  }
  s.zn = sqrtf(s.zt0 * s.zt0 + zs02 + TINY);
  s.zsc = s.r / s.zn;
  s.z_t = s.zt0 * s.zsc;
  z[0] = s.z_t;
  float zsp2 = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    s.z_sp[j] = s.zs0[j] * s.zsc;
    z[1 + j] = s.z_sp[j];
    const float t = s.z_sp[j] * s.z_sp[j];
    zsp2 = (j == 0) ? t : zsp2 + t;
  }

  const float q = logq_drawn(n, wraps, 1, s.kk, vsq, s2, ls, s.lqc, &s.lq_mx,
                             &s.lq_acc);

  // log p: r0 = 2R asin(|z - mu0| / 2R), the chord form of sphere.distance
  s.dz_t = s.z_t - s.r;
  s.chord0 = s.dz_t * s.dz_t + zsp2;
  s.hs = sqrtf(s.chord0 + TINY);
  s.half_in = s.hs / 2.f;
  s.hcap = ONE_M_EPS * s.r;
  s.half = fminf(s.half_in, s.hcap);
  s.wa = s.kk * s.half * s.half;
  s.asd = arcsindiv_u_pos(s.wa);
  s.r0 = 2.f * s.half * s.asd;
  const float p = logp_prior(n, wraps, 1, s.kk, s.r0, s.lp);
  *lq = q;
  *lp = p;
  *kl = q - p;
}
