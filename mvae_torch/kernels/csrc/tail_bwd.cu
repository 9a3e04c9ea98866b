// Backward of the fused tail: the vector-Jacobian product of the forward
// tail (tail_fwd.cu) with respect to the raw head pre-activations and the
// curvatures, from the cotangents of z and of aux = [KL per component,
// sum log q, sum log p]. The noise gets no gradient.
//
// Replaces the TPU kernel mvae_tpu/kernels/tail_kernels.py::_bwd_pallas,
// which recomputes the tile under jax.vjp inside the kernel. CUDA has no
// autodiff, so the reverse sweep of each tile (_tile_normal,
// _tile_wrapped_lorentz, _tile_vmf) is derived here by hand, following the
// conventions of the plain version, torch.autograd through
// tail_kernels.tail_forward_ref:
//  - a clamp passes the whole gradient when its input equals the bound
//    (torch.clamp), not half of it (jnp.maximum at a tie);
//  - each side of a series window is differentiated as written: the
//    polynomial inside |u| < 1e-2, the closed form (through the same sqrt,
//    sin/cos or clipped exp) outside, never a closed-form derivative that
//    cancels near 0;
//  - the clips (exp at 85, the vMF cosine at +-(1 - 1e-7), the softplus
//    branch at 0, the Householder degeneracy guard) gate the gradient
//    exactly where the forward's branch is taken.
//
// Bound: bytes. Per row it reads W + E + Z + nc + 2 floats and writes
// W + nc (45 floats at the h2,s2,e2 flagship, ~23 KB at batch 128) and does
// a few hundred flops; the launch dominates.
//
// Design: one thread per batch row. The row's forward is recomputed in
// registers and local memory by the forward tiles of tail_tiles.cuh (the
// same expressions as tail_fwd.cu, compiled with the same --fmad=false and
// no fast math, so the recomputed intermediates equal the forward kernel's
// bit for bit), then the reverse sweep runs in local memory (vectors of at
// most 32 entries). The per-row curvature gradients are written out as
// (B, nc); the sum over the batch is left to the caller, as the TPU kernel
// leaves it to XLA. No atomics: results are deterministic.
//
// Entry point (plain C, loaded with ctypes):
//   int tail_bwd_launch(raw (B, W), eps (B, E), kvec (nc,), dz (B, Z),
//                       daux (B, nc + 2), draw (B, W), dk_rows (B, nc),
//                       B, W, E, Z, nc, table, stream)
// `table` as for tail_fwd_launch. Returns cudaGetLastError() after the
// launch.

#include "tail_tiles.cuh"

#define THREADS 128

// --- derivatives of the scalar helpers -----------------------------------------

__device__ __forceinline__ float sgn_f(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// d softplus_f / dx as autograd takes it through max(x, 0) + log1p(e^-|x|)
__device__ __forceinline__ float d_softplus(float x) {
  const float e = expf(-fabsf(x));
  return (x >= 0.f ? 1.f : 0.f) - sgn_f(x) * (e / (1.f + e));
}

// d/du of poly4
__device__ __forceinline__ float dpoly4(float u, float c1, float c2, float c3,
                                        float c4) {
  return c1 + u * (2.f * c2 + u * (3.f * c3 + u * (4.f * c4)));
}

// d sindiv_u / du
__device__ float d_sindiv_u(float u) {
  if (fabsf(u) < CUTOFF)
    return dpoly4(u, F(-1.0 / 6), F(1.0 / 120), F(-1.0 / 5040),
                  F(1.0 / 362880));
  const float su = sqrtf(fabsf(u));
  float gsu;
  if (u > 0.f) {
    gsu = cosf(su) / su - sinf(su) / (su * su);
  } else {
    const float sc = fminf(fmaxf(su, -85.f), 85.f);
    const float e1 = expf(sc), e2 = expf(-sc);
    gsu = -(0.5f * (e1 - e2)) / (su * su);
    if (su <= 85.f) gsu = gsu + 0.5f * (e1 + e2) / su;
  }
  return gsu * sgn_f(u) / (2.f * su);
}

// d cos_u_sgn / du
__device__ float d_cos_u_sgn(float u, int sign) {
  if (fabsf(u) < CUTOFF)
    return dpoly4(u, F(-1.0 / 2), F(1.0 / 24), F(-1.0 / 720),
                  F(1.0 / 40320));
  const float x = sqrtf(fabsf(u));
  float gx;
  if (sign > 0) {
    gx = -sinf(x);
  } else {
    const float xc = fminf(fmaxf(x, 0.f), 85.f);
    gx = (x <= 85.f) ? 0.5f * (expf(xc) - expf(-xc)) : 0.f;
  }
  return gx * sgn_f(u) / (2.f * x);
}

// d log_sindiv_u_neg / du
__device__ float d_log_sindiv_u_neg(float u) {
  if (fabsf(u) < CUTOFF)
    return dpoly4(u, F(-1.0 / 6), F(1.0 / 120), F(-1.0 / 5040),
                  F(1.0 / 362880)) / (1.f + sindiv_m1_series(u));
  const float su = sqrtf(fabsf(u));
  const float em = expf(-2.f * su);
  const float gsu = 1.f + 2.f * em / (1.f - em) - 1.f / su;
  return gsu * sgn_f(u) / (2.f * su);
}

// d acosh_1p / du
__device__ float d_acosh_1p(float u) {
  const float w = fmaxf(u, 0.f);
  const float s = sqrtf(w * (u + 2.f));
  const float gy = 1.f / (1.f + (u + s));
  const float gp = gy / (2.f * s);
  float g = gy + gp * w;
  if (u >= 0.f) g = g + gp * (u + 2.f);
  return g;
}

// --- per-tile reverse sweeps ----------------------------------------------------

// _tile_normal: writes the tile's head gradients into draw[0 : n + ns]
__device__ void tile_normal_bwd(const float* raw, const float* eps, int n,
                                int ns, const float* dz, float gkl, float glq,
                                float glp, float* draw) {
  float gsum = 0.f;  // scalar scale head: gradients summed over the dims
  for (int j = 0; j < n; ++j) {
    const int si = n + (ns == 1 ? 0 : j);
    const float mu = raw[j];
    const float sig = softplus_f(raw[si]);
    const float e = eps[j];
    const float zj = mu + sig * e;
    const float gz = dz[j] - glp * zj;
    draw[j] = gz + gkl * mu;
    const float gsig = gz * e + gkl * sig + (-glq - gkl) / sig;
    if (ns == 1) {
      gsum = (j == 0) ? gsig : gsum + gsig;
    } else {
      draw[si] = gsig * d_softplus(raw[si]);
    }
  }
  if (ns == 1) draw[n] = gsum * d_softplus(raw[n]);
}

// _tile_wrapped_lorentz: draw[0 : n + ns] and the returned dL/dk
__device__ float tile_wrapped_h_bwd(const float* raw, const float* eps, int n,
                                    int ns, float k, const float* dz,
                                    float gkl, float glq, float glp,
                                    float* draw) {
  HSaved s;
  float zbuf[MAX_DIM + 1], kl, q, p;
  tile_wrapped_h(raw, eps, n, ns, k, zbuf, &kl, &q, &p, s);
  const float c = s.c, isc = s.inv_sqrt_c;
  const float nm1 = F(n - 1.0);

  float gmsp[MAX_DIM], gusp[MAX_DIM], gv[MAX_DIM], gsig[MAX_DIM];
  const float gq = glq + gkl;  // kl = lq - lp
  const float gp = glp - gkl;
  float gk = 0.f, gc = 0.f, gisc = 0.f, ginv_c = 0.f;

  // lp = -r02 / 2 - n log(2 pi) / 2 - (n - 1) log_sindiv(k r02)
  const float a3 = k * s.r02;
  float gr02 = -0.5f * gp;
  const float ga3 = -nm1 * gp * d_log_sindiv_u_neg(a3);
  gk += ga3 * s.r02;
  gr02 += ga3 * k;
  const float gr0 = gr02 * 2.f * s.r0;
  gisc += gr0 * s.r0a;
  const float ge0 = gr0 * isc * d_acosh_1p(s.e0);
  const float ge0_in = (s.e0_in >= 0.f) ? ge0 / 2.f : 0.f;
  gc += ge0_in * (s.zsp2 - s.dz_t * s.dz_t);
  float gzsp2 = ge0_in * c;
  const float gdzt = -2.f * ge0_in * c * s.dz_t;
  const float gzt = dz[0] + gdzt;
  gisc -= gdzt;

  // lq = sum(-(eps^2 + log 2 pi) / 2 - log sig) - (n - 1) log_sindiv(k rv2)
  const float a2 = k * s.rv2;
  const float ga2 = -nm1 * gq * d_log_sindiv_u_neg(a2);
  gk += ga2 * s.rv2;
  const float grv2 = ga2 * k;
  for (int j = 0; j < n; ++j) {
    gsig[j] = -gq / s.sig[j];
    gv[j] = grv2 * 2.f * s.v[j];
  }

  // z_t = sqrt(1 / c + zsp2); z_sp = cu mu_sp + sd u_sp
  const float gq2 = gzt / (2.f * s.z_t);
  ginv_c += gq2;
  gzsp2 += gq2;
  float gcu = 0.f, gsd = 0.f;
  for (int j = 0; j < n; ++j) {
    const float gzj = dz[1 + j] + gzsp2 * 2.f * s.z_sp[j];
    gcu += gzj * s.mu_sp[j];
    gsd += gzj * s.u_sp[j];
    gmsp[j] = gzj * s.cu;
    gusp[j] = gzj * s.sd;
  }
  const float gtt = gcu * d_cos_u_sgn(s.tt, -1) + gsd * d_sindiv_u(s.tt);
  gc += -gtt * s.usq;
  const float gusq = -gtt * c;
  const float gusq_in = (s.usq_in >= 0.f) ? gusq : 0.f;
  const float gut = -2.f * gusq_in * s.u_t;

  // u_sp = v + coef mu_sp; u_t = coef (1 / sqrt c + mu_t)
  float gcoef = 0.f;
  for (int j = 0; j < n; ++j) {
    gusp[j] += gusq_in * 2.f * s.u_sp[j];
    gv[j] += gusp[j];
    gcoef += gusp[j] * s.mu_sp[j];
    gmsp[j] += gusp[j] * s.coef;
  }
  gcoef += gut * (isc + s.mu_t);
  gisc += gut * s.coef;
  float gmu_t = gut * s.coef;

  // coef = c sv / (2 + e_a); e_a = max(c (sp2 - d_t^2), 0) / 2
  const float den = 2.f + s.e_a;
  const float gnum = gcoef / den;
  const float gden = -gcoef * s.coef / den;
  gc += gnum * s.sv;
  const float gsv = gnum * c;
  const float gea_in = (s.ea_in >= 0.f) ? gden / 2.f : 0.f;
  gc += gea_in * (s.sp2 - s.d_t * s.d_t);
  float gsp2 = gea_in * c;
  const float gdt = -2.f * gea_in * c * s.d_t;
  gmu_t += gdt;
  gisc -= gdt;
  for (int j = 0; j < n; ++j) {
    gmsp[j] += gsv * s.v[j];
    gv[j] += gsv * s.mu_sp[j];
    gsig[j] += gv[j] * eps[j];
  }

  // mu_t = sqrt(1 / c + sp2); mu_sp = sindiv(k r2m) mu_tan
  const float gq1 = gmu_t / (2.f * s.mu_t);
  ginv_c += gq1;
  gsp2 += gq1;
  float gsdm = 0.f;
  for (int j = 0; j < n; ++j) {
    gmsp[j] += gsp2 * 2.f * s.mu_sp[j];
    gsdm += gmsp[j] * raw[j];
  }
  const float a1 = k * s.r2m;
  const float ga1 = gsdm * d_sindiv_u(a1);
  gk += ga1 * s.r2m;
  const float gr2m = ga1 * k;
  float gsum = 0.f;
  for (int j = 0; j < n; ++j) {
    draw[j] = gmsp[j] * s.sdm + gr2m * 2.f * raw[j];
    if (ns == 1) {
      gsum = (j == 0) ? gsig[j] : gsum + gsig[j];
    } else {
      draw[n + j] = gsig[j] * d_softplus(raw[n + j]);
    }
  }
  if (ns == 1) draw[n] = gsum * d_softplus(raw[n]);

  // 1 / sqrt c, 1 / c, c = max(-k, tiny)
  gc += -0.5f * gisc * isc * isc * isc;
  gc += -ginv_c * s.inv_c * s.inv_c;
  if (-k >= TINY) gk -= gc;
  return gk;
}

// _tile_vmf (m = 3): draw[0 : 3] and the returned dL/dk
__device__ float tile_vmf_s2_bwd(const float* raw, const float* eps, float k,
                                 const float* dz, float gkl, float glq,
                                 float glp, float* draw) {
  VmfSaved s;
  float zbuf[3], kl, q, p;
  tile_vmf_s2(raw, eps, k, zbuf, &kl, &q, &p, s);
  const float kap = s.kap, r = s.r;
  const float u_eps = eps[0];

  // kl = kap A_3 + log C_3 + log 4 pi; lq = log C_3 + kap cos + area;
  // lp = -log 4 pi + area, area = log kk
  float gkap = gkl * s.a_m;
  const float ga_m = gkl * kap;
  const float glcm = gkl + glq;
  const float garea = glp + glq;
  gkap += glq * s.cosv;
  const float gcos = glq * kap;
  float gkk = garea / s.kk;
  float gmu_t = gcos * s.zu_t;
  float gmu0 = gcos * s.zu0;
  float gmu1 = gcos * s.zu1;
  const float gzu_t = gcos * s.mu_t + dz[0] * r;
  const float gzu0 = gcos * s.mu0s + dz[1] * r;
  const float gzu1 = gcos * s.mu1s + dz[2] * r;
  float gr = dz[0] * s.zu_t + dz[1] * s.zu0 + dz[2] * s.zu1;
  // log C_3 = log(kap) / 2 - 3 log(2 pi) / 2 - (log_ive + kap),
  // log_ive = log(2 / (pi kap)) / 2 + log1p(-e^{-2 kap}) - log 2,
  // A_3 = 1 / tanh(kap) - 1 / kap
  gkap += glcm * 0.5f / kap - glcm;
  const float e2k = expf(-2.f * kap);
  gkap += -glcm * (-0.5f / kap + 2.f * e2k / (1.f - e2k));
  const float ith = 1.f / s.th, ik = 1.f / kap;
  gkap += ga_m * (-(ith * ith) * (1.f - s.th * s.th) + ik * ik);

  // Householder reflection (identity where degenerate)
  float gw = gzu_t, gzp0 = gzu0, gzp1 = gzu1;
  if (!(s.un < EPS)) {
    const float t2 = 2.f * s.dotu;
    const float gt2 = -(gzu_t * s.uht + gzu0 * s.uhs0 + gzu1 * s.uhs1);
    float guht = -gzu_t * t2;
    float guhs0 = -gzu0 * t2;
    float guhs1 = -gzu1 * t2;
    const float gdotu = 2.f * gt2;
    guht += gdotu * s.w;
    gw += gdotu * s.uht;
    guhs0 += gdotu * s.zp0;
    guhs1 += gdotu * s.zp1;
    gzp0 += gdotu * s.uhs0;
    gzp1 += gdotu * s.uhs1;
    float guh_t = guht * s.inv_un;
    float guh0 = guhs0 * s.inv_un;
    float guh1 = guhs1 * s.inv_un;
    const float ginv = guht * s.uh_t + guhs0 * s.uh0 + guhs1 * s.uh1;
    const float gun = (s.un >= EPS) ? -ginv * s.inv_un * s.inv_un : 0.f;
    const float gsq = gun / (2.f * s.un);
    guh_t += gsq * 2.f * s.uh_t;
    guh0 += gsq * 2.f * s.uh0;
    guh1 += gsq * 2.f * s.uh1;
    gmu_t -= guh_t;
    gmu0 -= guh0;
    gmu1 -= guh1;
  }

  // zp = sin_w g / |g|; w = clip(1 + log1p((1 - u)(e^{-2 kap_s} - 1)) / kap_s)
  const float gsin = gzp0 * s.gd0 + gzp1 * s.gd1;
  const float gomw = (s.omw >= TINY) ? gsin / (2.f * s.sin_w) : 0.f;
  gw += -2.f * gomw * s.w;
  const bool w_free = s.w_in >= F(-1.0 + 1e-7) && s.w_in <= F(1.0 - 1e-7);
  const float gw0 = w_free ? gw : 0.f;
  const float glg = gw0 / s.kap_s;
  float gkap_s = -gw0 * s.lg / (s.kap_s * s.kap_s);
  const float garg = glg / (1.f + s.arg);
  gkap_s += garg * (1.f - u_eps) * s.ex * -2.f;
  if (kap >= F(1e-6)) gkap += gkap_s;

  // mu = (m scale) sqrt_k; scale = r / mnorm; m = (cos(.) r, sindiv(.) mu_tan)
  float gsqk = gmu_t * s.a_t + gmu0 * s.a0 + gmu1 * s.a1;
  const float ga_t = gmu_t * s.sqrt_k, ga0 = gmu0 * s.sqrt_k,
              ga1 = gmu1 * s.sqrt_k;
  float gm_t = ga_t * s.scale;
  float gms0 = ga0 * s.scale;
  float gms1 = ga1 * s.scale;
  const float gscale = ga_t * s.m_t + ga0 * s.ms0 + ga1 * s.ms1;
  gr += gscale / s.mnorm;
  const float gmn = -gscale * s.scale / s.mnorm;
  const float gmsq = gmn / (2.f * s.mnorm);
  gm_t += gmsq * 2.f * s.m_t;
  gms0 += gmsq * 2.f * s.ms0;
  gms1 += gmsq * 2.f * s.ms1;
  const float gsdm = gms0 * raw[0] + gms1 * raw[1];
  const float gcm = gm_t * r;
  gr += gm_t * s.cm;
  const float gtm = gcm * d_cos_u_sgn(s.t_m, 1) + gsdm * d_sindiv_u(s.t_m);
  gkk += gtm * s.r2m;
  const float gr2m = gtm * s.kk;
  draw[0] = gms0 * s.sdm + gr2m * 2.f * raw[0];
  draw[1] = gms1 * s.sdm + gr2m * 2.f * raw[1];
  draw[2] = gkap * d_softplus(raw[2]);

  // r = 1 / sqrt_k, sqrt_k = sqrt(kk), kk = max(k, tiny)
  gsqk += -gr * r * r;
  gkk += gsqk / (2.f * s.sqrt_k);
  return (k >= TINY) ? gkk : 0.f;
}

__global__ void __launch_bounds__(THREADS)
tail_bwd_kernel(const float* __restrict__ raw, const float* __restrict__ eps,
                const float* __restrict__ kvec, const float* __restrict__ dz,
                const float* __restrict__ daux, float* __restrict__ draw,
                float* __restrict__ dk_rows, int B, int W, int E, int Z,
                TailTable t) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= B) return;
  const int nc = t.nc;
  const float* r = raw + (size_t)row * W;
  const float* e = eps + (size_t)row * E;
  const float* gz = dz + (size_t)row * Z;
  const float* ga = daux + (size_t)row * (nc + 2);
  float* dr = draw + (size_t)row * W;
  float* dk = dk_rows + (size_t)row * nc;
  const float glq = ga[nc], glp = ga[nc + 1];
  for (int i = 0; i < nc; ++i) {
    const float* ri = r + t.raw_off[i];
    const float* ei = e + t.eps_off[i];
    const float* gzi = gz + t.z_off[i];
    float* dri = dr + t.raw_off[i];
    if (t.kind[i] == KIND_NORMAL) {
      tile_normal_bwd(ri, ei, t.dim[i], t.nscale[i], gzi, ga[i], glq, glp,
                      dri);
      dk[i] = 0.f;
    } else if (t.kind[i] == KIND_WRAPPED_H) {
      dk[i] = tile_wrapped_h_bwd(ri, ei, t.dim[i], t.nscale[i], kvec[i], gzi,
                                 ga[i], glq, glp, dri);
    } else {
      dk[i] = tile_vmf_s2_bwd(ri, ei, kvec[i], gzi, ga[i], glq, glp, dri);
    }
  }
}

extern "C" int tail_bwd_launch(const float* raw, const float* eps,
                               const float* kvec, const float* dz,
                               const float* daux, float* draw, float* dk_rows,
                               int B, int W, int E, int Z, int nc,
                               const int* table, void* stream) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int blocks = (B + THREADS - 1) / THREADS;
    tail_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t);
  }
  return (int)cudaGetLastError();
}
