// Frozen copy of mvae_torch/kernels/csrc/tail_bwd.cu as it stood at commit
// b875f52: the tail kernels' previous design (every product on the
// warp-a-component geometry, each tile serial on one thread), built beside
// the package's kernels to hold them bit for bit and time them in turns
// (chip_smoke.py, scripts/torch_tail_turns.py, tests). Not part of the
// package.
//
// Backward of the fused tail: the vector-Jacobian product of the forward
// tail (tail_fwd.cu) with respect to the raw head pre-activations and the
// curvatures, from the cotangents of z and of aux = [KL per component,
// sum log q, sum log p]. The noise gets no gradient.
//
// Replaces the TPU kernel mvae_tpu/kernels/tail_kernels.py::_bwd_pallas
// (:735), which recomputes the tiles of _tail_tile (:646) under jax.vjp
// inside the kernel. CUDA has no autodiff, so the reverse sweep of each tile
// (_tile_normal :232, _tile_wrapped_lorentz :245, _tile_wrapped_sphere :301,
// _tile_vmf :386, _tile_wrapped_stereo :462 with :540 and :610) is derived
// here by hand, following the conventions
// of the plain version, torch.autograd through
// tail_kernels.tail_forward_ref:
//  - a clamp passes the whole gradient when its input equals the bound
//    (torch.clamp), not half of it (jnp.maximum at a tie);
//  - each side of a series window is differentiated as written: the
//    polynomial inside |u| < 1e-2, the closed form (through the same sqrt,
//    sin/cos or clipped exp) outside, never a closed-form derivative that
//    cancels near 0;
//  - the clips (exp at 85, the vMF cosine at +-(1 - 1e-7), the softplus
//    branch at 0, the Householder degeneracy guard) gate the gradient
//    exactly where the forward's branch is taken;
//  - in the stereographic tile: floor() has no gradient; a branch of the
//    drawn-radius sum gets its softmax weight when it is live and nothing
//    when it is masked (the shift of the log-sum-exp is a constant); the
//    universal kind (sign 0) follows the branch its row's K selects; the
//    sigma cap, the wrap period and the ball radius carry their curvature
//    gradients, each gated where its max / min floor is taken;
//  - in the embedded-sphere tile: the transport's denominator
//    max(1 + alpha, eps) (taken at the antipode of mu0) and the half
//    chord's cap (1 - eps) R gate likewise; where the cap is taken the
//    gradient goes to the curvature through the cap, not to the chord.
//
// Bound: neither bytes nor operations. Per row it reads W + E + Z + nc + 2
// floats and writes W + nc (45 floats at the h2,s2,e2 flagship, ~23 KB at
// batch 128) and does a few hundred operations (a few thousand with a d/p/u
// or s tile): the card's I/O skeleton of the tail at this grid
// (roofline_probes.cu, skel_tail_*_kernel) is the launch and one fenced fold.
// What is left is latency: per row and component, one dependent chain
// through the tile's forward and back through its reverse sweep.
//
// Design (launch geometry in tail_grid.cuh): a block holds up to 8 warps of
// one component, a warp 32 rows, so a row's components run side by side in
// blocks of their own and the row's chain is its longest tile (at the
// training batch of 128: nc blocks of 4 warps). The tiles and their
// reverse sweeps are templates on the component dimension (2, 3, 6 with
// every vector in registers; 0 the generic instantiation, n <= 32 in local
// memory), instantiated per dimension class of the product as in
// tail_fwd.cu. Each
// row's forward is recomputed by the forward tiles of tail_tiles.cuh (the
// same expressions as tail_fwd.cu, compiled with the same --fmad=false and
// no fast math, so the recomputed intermediates equal the forward kernel's
// bit for bit), then the reverse sweep runs on them; at wraps = 1 the
// reverse sweep of the drawn-radius sum reuses the 9 branches the forward
// kept instead of evaluating them again, and every branch shares one sine
// and one cosine. The per-row curvature gradients are written out as
// (B, nc) and folded over the batch in the same launch, in a fixed order
// (32-row groups in row order, then the groups in order): at B <= 256
// inside the component's one block; above, as B6 folds (each block
// publishes its groups' sums, fences and takes a ticket on its component's
// counter; the last block sums them in order and resets the counter). So
// graph replays are bit-equal, the caller needs no sum, and no atomics
// touch the sums' values.
//
// Entry point (plain C, loaded with ctypes):
//   int tail_bwd_launch(raw (B, W), eps (B, E), kvec (nc,), dz (B, Z),
//                       daux (B, nc + 2), draw (B, W), dk_rows (B, nc),
//                       dk (nc,), part (ceil(B / 32), nc), counter (nc
//                       unsigned, zero), B, W, E, Z, nc, table, stream)
// `table` as for tail_fwd_launch; `part` is scratch, `counter` is left at
// zero. Returns cudaGetLastError() after the launch.

#include "tail_grid.cuh"

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

// d/du of poly5
__device__ __forceinline__ float dpoly5(float u, float c1, float c2, float c3,
                                        float c4, float c5) {
  return c1 + u * (2.f * c2 + u * (3.f * c3 + u * (4.f * c4
                                                  + u * (5.f * c5))));
}

// d tandiv_u / du
__device__ float d_tandiv_u(float u, int sign) {
  if (fabsf(u) < CUTOFF) return dpoly5(u, TANDIV_C);
  const float su = sqrtf(fabsf(u));
  float gsu;
  if (sign > 0 || (sign == 0 && u > 0.f)) {
    const float tn = tanf(su);
    gsu = (1.f + tn * tn) / su - tn / (su * su);
  } else {
    const float th = tanhf(su);
    gsu = (1.f - th * th) / su - th / (su * su);
  }
  return gsu * sgn_f(u) / (2.f * su);
}

// d arctandiv_u / dw
__device__ float d_arctandiv_u(float w, int sign) {
  if (fabsf(w) < CUTOFF) return dpoly5(w, ARCTANDIV_C);
  if (sign > 0 || (sign == 0 && w > 0.f)) {
    if (!(w >= TINY)) return 0.f;
    const float sw = sqrtf(w);
    const float gsw = 1.f / ((1.f + sw * sw) * sw) - atanf(sw) / (sw * sw);
    return gsw / (2.f * sw);
  }
  const float q_hi = F((1.0 - 1e-6) * (1.0 - 1e-6));
  const float q = fminf(fmaxf(-w, TINY), q_hi);
  const float sw = sqrtf(q);
  // atanh_clamped(x) = log1p(2 x / (1 - x)) / 2 with x clipped at 1 - eps
  const float x = fminf(sw, ONE_M_EPS);
  const float y = 2.f * x / (1.f - x);
  float gx = 0.5f / (1.f + y)
             * (2.f / (1.f - x) + 2.f * x / ((1.f - x) * (1.f - x)));
  if (!(sw <= ONE_M_EPS)) gx = 0.f;
  const float gsw = gx / sw - atanh_clamped(sw) / (sw * sw);
  if (!(-w >= TINY && -w <= q_hi)) return 0.f;
  return -gsw / (2.f * sw);
}

// Gradients of log_abs_sin_soft(x, taper) with respect to x and taper, from
// sn = sin x and cs = cos x
__device__ __forceinline__ void d_log_abs_sin_soft_at(float sn, float cs,
                                                      float taper, float* gx,
                                                      float* gtaper) {
  const float tt = taper * F(1.0 / PI);
  const float t = fminf(tt, 1.f);
  const float d = SHELL_DELTA * t * t * t;
  const float gS = 0.5f / (sn * sn + d * d);
  *gx = gS * 2.f * sn * cs;
  const float gt = gS * 2.f * d * SHELL_DELTA * 3.f * t * t;
  *gtaper = (tt <= 1.f) ? gt * F(1.0 / PI) : 0.f;
}

// d log_sindiv_u_soft / du
__device__ float d_log_sindiv_u_soft(float u, int sign) {
  if (sign < 0 || (sign == 0 && !(u > 0.f)) || fabsf(u) < CUTOFF)
    return d_log_sindiv_u_neg(u);
  const float su = sqrtf(fabsf(u));
  float gx, gtaper;
  d_log_abs_sin_soft_at(sinf(su), cosf(su), su, &gx, &gtaper);
  float gsu = gx + gtaper;
  if (su >= EPS) gsu = gsu - 1.f / su;
  return gsu * sgn_f(u) / (2.f * su);
}

// d arcsindiv_u_pos / dw
__device__ float d_arcsindiv_u_pos(float w) {
  if (fabsf(w) < CUTOFF) return dpoly4(w, ARCSINDIV_C);
  if (!(w >= TINY && w <= ONE_M_EPS)) return 0.f;
  const float sw = sqrtf(w);
  const float q_in = 1.f - w;
  const float q = fmaxf(q_in, EPS);
  const float rq = rsqrtf(q);
  const float a = sw * rq;
  // a = sw rsqrt(q): da/dw = rq / (2 sw) + sw (rq^3 / 2) where q = 1 - w
  float ga = rq / (2.f * sw);
  if (q_in >= EPS) ga = ga + sw * 0.5f * rq * rq * rq;
  return ga / ((1.f + a * a) * sw) - atanf(a) / (sw * sw) / (2.f * sw);
}

// Reverse of sigma_cap for one coordinate: from the gradient of the capped
// scale, the gradient of the softplus scale; adds to the gradient of capr
__device__ __forceinline__ float sigma_cap_bwd(float gsig, float capr,
                                               float tq, float tc, float w6,
                                               float pw, float* gcapr) {
  const float tc2 = tc * tc;
  *gcapr += gsig * tc * pw;
  const float gpw = gsig * capr * tc;
  const float gw6 = gpw * F(-1.0 / 6.0) * powf(w6, F(-7.0 / 6.0));
  const float gtc = gsig * capr * pw + gw6 * 3.f * tc2 * tc2 * 2.f * tc;
  const float gtq = (tq <= 8.f) ? gtc : 0.f;
  *gcapr -= gtq * tq / capr;
  return gtq / capr;
}

// --- per-tile reverse sweeps ----------------------------------------------------

// _tile_normal: writes the tile's head gradients into draw[0 : n + ns]
__device__ __forceinline__ void tile_normal_bwd(const float* raw,
                                                const float* eps, int n, int ns,
                                                const float* dz, float gkl,
                                                float glq, float glp,
                                                float* draw) {
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
template <int N>
__device__ __forceinline__ float tile_wrapped_h_bwd(
    const float* raw, const float* eps, int n, int ns, float k, const float* dz,
    float gkl, float glq, float glp, float* draw) {
  const int nn = TAIL_DIM(N, n);
  HSaved<N> s;
  float zbuf[TAIL_ARR(N) + 1], kl, q, p;
  tile_wrapped_h<N>(raw, eps, n, ns, k, zbuf, &kl, &q, &p, s);
  const float c = s.c, isc = s.inv_sqrt_c;
  const float nm1 = F(nn - 1.0);

  float gmsp[TAIL_ARR(N)], gusp[TAIL_ARR(N)], gv[TAIL_ARR(N)],
      gsig[TAIL_ARR(N)];
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
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gsig[j] = -gq / s.sig[j];
    gv[j] = grv2 * 2.f * s.v[j];
  }

  // z_t = sqrt(1 / c + zsp2); z_sp = cu mu_sp + sd u_sp
  const float gq2 = gzt / (2.f * s.z_t);
  ginv_c += gq2;
  gzsp2 += gq2;
  float gcu = 0.f, gsd = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
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
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
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
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gmsp[j] += gsv * s.v[j];
    gv[j] += gsv * s.mu_sp[j];
    gsig[j] += gv[j] * eps[j];
  }

  // mu_t = sqrt(1 / c + sp2); mu_sp = sindiv(k r2m) mu_tan
  const float gq1 = gmu_t / (2.f * s.mu_t);
  ginv_c += gq1;
  gsp2 += gq1;
  float gsdm = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gmsp[j] += gsp2 * 2.f * s.mu_sp[j];
    gsdm += gmsp[j] * raw[j];
  }
  const float a1 = k * s.r2m;
  const float ga1 = gsdm * d_sindiv_u(a1);
  gk += ga1 * s.r2m;
  const float gr2m = ga1 * k;
  float gsum = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
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
__device__ __forceinline__ float tile_vmf_s2_bwd(const float* raw,
                                                 const float* eps, float k,
                                                 const float* dz, float gkl,
                                                 float glq, float glp,
                                                 float* draw) {
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

// Reverse of s = ball_scale(k, smax, xn2): adds to the gradients of smax
// and xn2
__device__ __forceinline__ void ball_scale_bwd(float k, float smax, float xn2,
                                               float gs, float* gsmax,
                                               float* gxn2) {
  if (!(k < 0.f)) return;
  const float q = fmaxf(xn2, TINY);
  const float rs = rsqrtf(q);
  if (!(smax * rs <= 1.f)) return;
  *gsmax += gs * rs;
  if (xn2 >= TINY) *gxn2 += gs * smax * (-0.5f * rs / q);
}

// The gradients the branches of the drawn-radius sum accumulate
struct LqGrads {
  float rp, quad, period, sqk, kpos, xred, vsq_g, ls, k;
};

// Reverse of branch m (live, at radius rb) of the drawn-radius sum, whose
// cotangent is gt; cs = cos x_red
__device__ __forceinline__ void lq_term_bwd(int n, int sign, float k,
                                            const LqCommon& c, float cs, int m,
                                            float rb, float gt, LqGrads& a) {
  const float nm1 = F(n - 1.0);
  float grb = -gt * rb * c.quad;
  a.quad += -0.5f * gt * rb * rb;
  a.ls -= gt;
  if (m == 0) {
    const float gu0 = -gt * nm1 * d_log_sindiv_u_soft(c.u0, sign);
    if (c.pos) {
      a.kpos += gu0 * c.rp * c.rp;
      a.rp += gu0 * c.kpos * 2.f * c.rp;
    } else {
      a.k += gu0 * c.vsq_g;
      a.vsq_g += gu0 * k;
    }
  } else {
    const float gsph = -gt * nm1;
    const float arb = fabsf(rb);
    const float xb = c.sqk * arb;
    float gx, gtaper;
    d_log_abs_sin_soft_at(c.sn, cs, xb, &gx, &gtaper);
    a.xred += gsph * gx;
    float gxb = gsph * gtaper;
    if (xb >= TINY) gxb -= gsph / xb;
    a.sqk += gxb * arb;
    grb += gxb * c.sqk * sgn_f(rb);
    a.period += grb * (float)m;
  }
  a.rp += grb;
}

// Reverse of logq_drawn: from glq, adds to the gradients of vsq, ls and k.
// Each live branch of the sum gets its softmax weight; a dead branch none.
// At wraps = 1 the branches are the ones the forward kept (LqCommon.t).
__device__ __forceinline__ void logq_drawn_bwd(int n, int wraps, int sign,
                                               float k, float vsq, float s2,
                                               float ls, const LqCommon& c,
                                               float mx, float acc, float g,
                                               float* gvsq, float* gls,
                                               float* gk) {
  const float nm1 = F(n - 1.0);
  if (sign < 0) {
    const float vsq_g = vsq + TINY;
    const float gu = -nm1 * g * d_log_sindiv_u_soft(k * vsq_g, sign);
    *gls -= g;
    *gvsq += gu * k;
    *gk += gu * vsq_g;
    return;
  }
  LqGrads a = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float cs = wraps > 0 ? cosf(c.x_red) : 0.f;
  if (wraps == 1) {
#pragma unroll
    for (int i = 0; i < LQ_BRANCHES; ++i) {
      if (!((c.live >> i) & 1)) continue;
      const int m = i - 4;
      lq_term_bwd(n, sign, k, c, cs, m, c.rp + (float)m * c.period,
                  g * (expf(c.t[i] - mx) / acc), a);
    }
  } else {
    const int M = (wraps == 0) ? 0 : wraps + 3;
    for (int m = -M; m <= M; ++m) {
      float rb, t;
      if (!lq_term(n, sign, ls, c, m, &rb, &t)) continue;
      lq_term_bwd(n, sign, k, c, cs, m, rb,
                  (M == 0) ? g : g * (expf(t - mx) / acc), a);
    }
  }
  *gls += a.ls;
  *gk += a.k;
  float gsqk = a.sqk, grp = a.rp, gperiod = a.period, gr = 0.f;
  // x_red = sqk rp; rp = |r - period floor(r / period + 1/2)| or r
  gsqk += a.xred * c.rp;
  grp += a.xred * c.sqk;
  if (c.pos) {
    const float gd = grp * sgn_f(c.d);
    gr += gd;
    gperiod -= gd * c.fl;
  } else {
    gr += grp;
  }
  // period = 2 pi / sqk, sqk = sqrt(kpos), kpos = max(k, 1e-20)
  gsqk -= gperiod * c.period / c.sqk;
  const float gkpos = a.kpos + gsqk / (2.f * c.sqk);
  if (k >= 1e-20f) *gk += gkpos;
  // quad = s2 / vsq_g, r = sqrt(vsq_g), vsq_g = vsq + tiny
  float gvsq_g = a.vsq_g;
  gvsq_g -= a.quad * c.quad / c.vsq_g;
  gvsq_g += gr / (2.f * c.r);
  *gvsq += gvsq_g;
}

// Reverse of logp_prior: from glp, returns the gradient of r0 and adds to
// the gradient of k
__device__ __forceinline__ float logp_prior_bwd(int n, int sign, float k,
                                                float r0, const LpSaved& s,
                                                float g, float* gk) {
  const float nm1 = F(n - 1.0);
  const float g0 = s.wrapped ? g * (expf(s.t[0] - s.mx) / s.acc) : g;
  const float gup = -g0 * nm1 * d_log_sindiv_u_soft(s.up, sign);
  *gk += gup * s.r02;
  const float gr02 = -0.5f * g0 + gup * k;
  float gr0 = gr02 * 2.f * r0;
  if (!s.wrapped) return gr0;
  float gsqk0 = 0.f, gperiod = 0.f;
  const float x0 = s.sqk0 * r0, sn0 = sinf(x0), cs0 = cosf(x0);
  for (int i = 1; i <= 2; ++i) {
    if (!s.live[i]) continue;
    const float gt = g * (expf(s.t[i] - s.mx) / s.acc);
    const float rb = s.rb[i], arb = fabsf(rb);
    float grb = -gt * rb;
    const float glsk = -gt * nm1;
    if (arb >= TINY) grb += gt * nm1 / arb * sgn_f(rb);
    gsqk0 -= glsk / s.sqk0;
    const float xb = s.sqk0 * arb;
    float gx, gtaper;
    d_log_abs_sin_soft_at(sn0, cs0, xb, &gx, &gtaper);
    gsqk0 += glsk * gx * r0;
    gr0 += glsk * gx * s.sqk0;
    gsqk0 += glsk * gtaper * arb;
    grb += glsk * gtaper * s.sqk0 * sgn_f(rb);
    gr0 += grb;
    gperiod += (i == 1) ? grb : -grb;
  }
  gsqk0 -= gperiod * s.period / s.sqk0;
  if (k >= 1e-20f) *gk += gsqk0 / (2.f * s.sqk0);
  return gr0;
}

// Reverse of stereo_draw: from dz and the cotangents of log q and log p,
// the gradients of mu and sig, the gradient of k added to *gk
template <int N>
__device__ __forceinline__ void stereo_draw_bwd(int n, int sign, int wraps,
                                                float k, const float* mu,
                                                const float* sig,
                                                const float* eps,
                                                const StereoSaved<N>& s,
                                                const float* dz, float gq,
                                                float gp, float* gmu,
                                                float* gsig, float* gk) {
  const int nn = TAIL_DIM(N, n);
  float gsmax = 0.f;
  // lp from r0 = 2 sqrt(zn2 + tiny) arctandiv(k zn2)
  const float gr0 = logp_prior_bwd(n, sign, k, s.r0, s.lp, gp, gk);
  const float gsq = gr0 * 2.f * s.ad;
  const float gw = gr0 * 2.f * s.sq * d_arctandiv_u(s.w, sign);
  *gk += gw * s.zn2;
  const float gzn2 = gw * k + gsq / (2.f * s.sq);

  // the final ball clamp: z = zpre bsz, zn2 = max(zn2pre bsz^2, 0)
  float gzpre[TAIL_ARR(N)];
  float gzn2pre;
  if (sign <= 0) {
    const float gm = (s.zn2m >= 0.f) ? gzn2 : 0.f;
    gzn2pre = gm * s.bsz * s.bsz;
    float gbsz = gm * 2.f * s.zn2pre * s.bsz;
    #pragma unroll
    for (int j = 0; j < nn; ++j) {
      gbsz += dz[j] * s.zpre[j];
      gzpre[j] = dz[j] * s.bsz;
    }
    ball_scale_bwd(k, s.smax, s.zn2pre, gbsz, &gsmax, &gzn2pre);
  } else {
    gzn2pre = gzn2;
    #pragma unroll
    for (int j = 0; j < nn; ++j) gzpre[j] = dz[j];
  }

  // zpre = p mu + q v with p = a / den, q = b / den
  float gpp = 0.f, gqq = 0.f;
  float gv[TAIL_ARR(N)];
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gzpre[j] += gzn2pre * 2.f * s.zpre[j];
    gpp += gzpre[j] * mu[j];
    gqq += gzpre[j] * s.v[j];
    gmu[j] = gzpre[j] * s.p;
    gv[j] = gzpre[j] * s.q;
  }
  const float ga = gpp * s.inv, gb = gqq * s.inv;
  const float ginv = gpp * s.a + gqq * s.b;
  const float gden0 =
      (fabsf(s.den0) < 1e-6f) ? 0.f : -ginv * s.inv * s.inv;
  // den0 = 1 - 2 k gxv + k^2 x2 g2v; a = 1 - 2 k gxv - k g2v;
  // b = (1 + k x2) g
  const float ggxv = (gden0 + ga) * (-2.f * k);
  float gg2v = gden0 * k * k * s.x2 - ga * k;
  float gx2 = gden0 * k * k * s.g2v + gb * k * s.g;
  *gk += gden0 * (-2.f * s.gxv + 2.f * k * s.x2 * s.g2v)
         + ga * (-2.f * s.gxv - s.g2v) + gb * s.x2 * s.g;
  // gxv = g xv; g2v = g^2 vsq
  float gg = gb * (1.f + k * s.x2) + ggxv * s.xv + gg2v * 2.f * s.g * s.vsq;
  const float gxv = ggxv * s.g;
  float gvsq = gg2v * s.g * s.g;
  // g = g0 ball_scale(g0^2 vsq); g0 = tandiv(k vsq / 4) / 2
  float gg0 = gg;
  if (sign <= 0) {
    gg0 = gg * s.bsg;
    float gxn2 = 0.f;
    ball_scale_bwd(k, s.smax, s.g0 * s.g0 * s.vsq, gg * s.g0, &gsmax, &gxn2);
    gg0 += gxn2 * 2.f * s.g0 * s.vsq;
    gvsq += gxn2 * s.g0 * s.g0;
  }
  const float gug = 0.5f * gg0 * d_tandiv_u(s.ug, sign);
  *gk += gug * s.vsq / 4.f;
  gvsq += gug * k / 4.f;

  float gls = 0.f;
  logq_drawn_bwd(n, wraps, sign, k, s.vsq, s.s2, s.ls, s.lqc, s.lq_mx,
                 s.lq_acc, gq, &gvsq, &gls, gk);

  #pragma unroll

  for (int j = 0; j < nn; ++j) {
    gv[j] += gvsq * 2.f * s.v[j] + gxv * mu[j];
    gmu[j] += gxv * s.v[j] + gx2 * 2.f * mu[j];
    gsig[j] = gv[j] * eps[j];
    if (sig[j] >= TINY) gsig[j] += gls / sig[j];
  }
  // smax = (1 - eps) rsqrt(-min(k, -tiny))
  if (k <= -TINY) *gk += gsmax * 0.5f * s.smax / (-k);
}

// _tile_wrapped_stereo: draw[0 : n + ns] and the returned dL/dk
template <int N>
__device__ __forceinline__ float tile_wrapped_stereo_bwd(
    const float* raw, const float* eps, int n, int ns, int sign, int wraps,
    float k, const float* dz, float gkl, float glq, float glp, float* draw) {
  const int nn = TAIL_DIM(N, n);
  StereoHead<N> h;
  StereoSaved<N> s;
  float zbuf[TAIL_ARR(N)], kl, q, p;
  tile_wrapped_stereo<N>(raw, eps, n, ns, sign, wraps, k, zbuf, &kl, &q, &p, h,
                      s);
  float gmu[TAIL_ARR(N)], gsig[TAIL_ARR(N)];
  float gk = 0.f;
  stereo_draw_bwd(n, sign, wraps, k, h.mu, h.sig, eps, s, dz, glq + gkl,
                  glp - gkl, gmu, gsig, &gk);

  // mu = gm mu_tan ball_scale(gm^2 r2m), gm = tandiv(k r2m / 4) / 2
  float ggm = 0.f, gr2m = 0.f, gsmax = 0.f;
  if (sign <= 0) {
    float gbs = 0.f;
    #pragma unroll
    for (int j = 0; j < nn; ++j) {
      gbs += gmu[j] * h.mu0[j];
      gmu[j] = gmu[j] * h.bsm;
    }
    float gxn2 = 0.f;
    ball_scale_bwd(k, h.smax, h.gm * h.gm * h.r2m, gbs, &gsmax, &gxn2);
    ggm += gxn2 * 2.f * h.gm * h.r2m;
    gr2m += gxn2 * h.gm * h.gm;
    if (k <= -TINY) gk += gsmax * 0.5f * h.smax / (-k);
  }
  #pragma unroll
  for (int j = 0; j < nn; ++j) ggm += gmu[j] * raw[j];
  const float gum = 0.5f * ggm * d_tandiv_u(h.um, sign);
  gk += gum * h.r2m / 4.f;
  gr2m += gum * k / 4.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) draw[j] = gmu[j] * h.gm + gr2m * 2.f * raw[j];

  // sig = capr tc (1 + tc^6)^(-1/6), tc = min(sig0 / capr, 8),
  // capr = pi rsqrt(max(k, 1e-12)); sig0 = softplus(raw)
  float gcapr = 0.f, gsum = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    float gs0 = gsig[j];
    if (sign >= 0)
      gs0 = sigma_cap_bwd(gsig[j], h.capr, h.tq[j], h.tc[j], h.w6[j], h.pw[j],
                          &gcapr);
    if (ns == 1) {
      gsum = (j == 0) ? gs0 : gsum + gs0;
    } else {
      draw[n + j] = gs0 * d_softplus(raw[n + j]);
    }
  }
  if (ns == 1) draw[n] = gsum * d_softplus(raw[n]);
  if (sign >= 0 && k >= 1e-12f) gk += gcapr * (-0.5f) * h.capr / h.kc;
  return gk;
}

// _tile_wrapped_sphere: draw[0 : n + ns] and the returned dL/dk; dz has
// n + 1 entries.
template <int N>
__device__ __forceinline__ float tile_wrapped_sphere_bwd(
    const float* raw, const float* eps, int n, int ns, int wraps, float k,
    const float* dz, float gkl, float glq, float glp, float* draw) {
  const int nn = TAIL_DIM(N, n);
  SphSaved<N> s;
  float zbuf[TAIL_ARR(N) + 1], kl, q, p;
  tile_wrapped_sphere<N>(raw, eps, n, ns, wraps, k, zbuf, &kl, &q, &p, s);
  const float gq = glq + gkl;  // kl = lq - lp
  const float gp = glp - gkl;
  float gkk = 0.f, gsqk = 0.f, gr = 0.f;
  float gmsp[TAIL_ARR(N)], gusp[TAIL_ARR(N)], gv[TAIL_ARR(N)],
      gwsp[TAIL_ARR(N)];

  // lp from r0 = 2 half arcsindiv(kk half^2), half = min(sqrt(chord0 + tiny)
  // / 2, (1 - eps) r), chord0 = (z_t - r)^2 + |z_sp|^2
  const float gr0 = logp_prior_bwd(n, 1, s.kk, s.r0, s.lp, gp, &gkk);
  float ghalf = gr0 * 2.f * s.asd;
  const float gwa = gr0 * 2.f * s.half * d_arcsindiv_u_pos(s.wa);
  gkk += gwa * s.half * s.half;
  ghalf += gwa * s.kk * 2.f * s.half;
  float gchord0 = 0.f;
  if (s.half_in <= s.hcap) {
    gchord0 = ghalf / 2.f / (2.f * s.hs);
  } else {
    gr += ghalf * ONE_M_EPS;
  }
  const float gdzt = gchord0 * 2.f * s.dz_t;
  gr -= gdzt;
  const float gz_t = dz[0] + gdzt;

  // lq = logq_drawn(kk, vsq, s2, ls)
  float gvsq = 0.f, gls = 0.f;
  logq_drawn_bwd(n, wraps, 1, s.kk, s.vsq, s.s2, s.ls, s.lqc, s.lq_mx,
                 s.lq_acc, gq, &gvsq, &gls, &gkk);

  // z = z0 zsc, zsc = r / zn, zn = sqrt(zt0^2 + |zs0|^2 + tiny);
  // z0 = cu mu + sd u
  float gzsc = gz_t * s.zt0;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    const float gzj = dz[1 + j] + gchord0 * 2.f * s.z_sp[j];
    gzsc += gzj * s.zs0[j];
    gusp[j] = gzj * s.zsc;  // the gradient of zs0, for now
  }
  gr += gzsc / s.zn;
  const float gzn2 = -gzsc * s.zsc / s.zn / (2.f * s.zn);
  const float gzt0 = gz_t * s.zsc + gzn2 * 2.f * s.zt0;
  float gcu = gzt0 * s.mu_t, gsd = gzt0 * s.u_t;
  float gmu_t = gzt0 * s.cu;
  float gu_t = gzt0 * s.sd;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    const float gz0 = gusp[j] + gzn2 * 2.f * s.zs0[j];
    gcu += gz0 * s.mu_sp[j];
    gsd += gz0 * s.u_sp[j];
    gmsp[j] = gz0 * s.cu;
    gusp[j] = gz0 * s.sd;
  }
  // tt = kk usq, usq = u_t^2 + |u_sp|^2
  const float gtt = gcu * d_cos_u_sgn(s.tt, 1) + gsd * d_sindiv_u(s.tt);
  gkk += gtt * s.usq;
  const float gusq = gtt * s.kk;
  gu_t += gusq * 2.f * s.u_t;

  // u = w pin, pin = nv / nw, nv = sqrt(vsq + tiny),
  // nw = sqrt(w_t^2 + |w_sp|^2 + tiny)
  float gpin = gu_t * s.w_t;
  float gw_t = gu_t * s.pin;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gusp[j] += gusq * 2.f * s.u_sp[j];
    gpin += gusp[j] * s.w_sp[j];
    gwsp[j] = gusp[j] * s.pin;
  }
  gvsq += gpin / s.nw / (2.f * s.nv);
  const float gnw2 = -gpin * s.pin / s.nw / (2.f * s.nw);
  gw_t += gnw2 * 2.f * s.w_t;

  // w_t = -coef (r + mu_t); w_sp = v - coef mu_sp
  float gcoef = -gw_t * (s.r + s.mu_t);
  gr -= gw_t * s.coef;
  gmu_t -= gw_t * s.coef;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gwsp[j] += gnw2 * 2.f * s.w_sp[j];
    gcoef -= gwsp[j] * s.mu_sp[j];
    gv[j] = gwsp[j];
    gmsp[j] -= gwsp[j] * s.coef;
  }
  // coef = kk smv / den, den = max(1 + alpha, eps),
  // alpha = 1 - kk chord2 / 2, chord2 = (mu_t - r)^2 + sp2
  const float gnum = gcoef / s.den;
  gkk += gnum * s.smv;
  const float gsmv = gnum * s.kk;
  const float galpha = (s.den_in >= EPS) ? -gcoef * s.coef / s.den : 0.f;
  gkk -= galpha * s.chord2 / 2.f;
  const float gchord2 = -galpha * s.kk / 2.f;
  const float gdt = gchord2 * 2.f * s.d_t;
  gmu_t += gdt;
  gr -= gdt;

  // v = sig eps; mu = m sc with sc = r / mnorm, sp2 = sp2_m sc^2
  float gsc = gmu_t * s.m_t + gchord2 * s.sp2_m * 2.f * s.sc;
  float gsp2_m = gchord2 * s.sc * s.sc;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gmsp[j] += gsmv * s.v[j];
    gv[j] += gsmv * s.mu_sp[j] + gvsq * 2.f * s.v[j];
    gsc += gmsp[j] * s.m_sp[j];
    gmsp[j] = gmsp[j] * s.sc;  // the gradient of m_sp from here on
  }
  gr += gsc / s.mnorm;
  const float gmn2 = -gsc * s.sc / s.mnorm / (2.f * s.mnorm);
  const float gm_t = gmu_t * s.sc + gmn2 * 2.f * s.m_t;
  gsp2_m += gmn2;
  // m_t = cos_u(t_m) r; m_sp = sindiv(t_m) mu_tan; t_m = kk r2m
  float gsdm = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    gmsp[j] += gsp2_m * 2.f * s.m_sp[j];
    gsdm += gmsp[j] * raw[j];
  }
  gr += gm_t * s.cm;
  const float gtm = gm_t * s.r * d_cos_u_sgn(s.t_m, 1)
                    + gsdm * d_sindiv_u(s.t_m);
  gkk += gtm * s.r2m;
  const float gr2m = gtm * s.kk;
  #pragma unroll
  for (int j = 0; j < nn; ++j)
    draw[j] = gmsp[j] * s.sdm + gr2m * 2.f * raw[j];

  // sig = sigma_cap(softplus(raw), capr), capr = pi rsqrt(max(k, 1e-12))
  float gcapr = 0.f, gsum = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    float gsig = gv[j] * eps[j];
    if (s.sig[j] >= TINY) gsig += gls / s.sig[j];
    const float gs0 = sigma_cap_bwd(gsig, s.capr, s.tq[j], s.tc[j], s.w6[j],
                                    s.pw[j], &gcapr);
    if (ns == 1) {
      gsum = (j == 0) ? gs0 : gsum + gs0;
    } else {
      draw[n + j] = gs0 * d_softplus(raw[n + j]);
    }
  }
  if (ns == 1) draw[n] = gsum * d_softplus(raw[n]);

  // r = 1 / sqrt_k, sqrt_k = sqrt(kk), kk = max(k, tiny)
  gsqk -= gr * s.r * s.r;
  gkk += gsqk / (2.f * s.sqrt_k);
  float gk = (k >= TINY) ? gkk : 0.f;
  if (k >= 1e-12f) gk += gcapr * (-0.5f) * s.capr / s.kc;
  return gk;
}

// One component's backward tile for one row, by the table's kind: the
// tile's head gradients into draw and the returned dL/dk
template <int D>
__device__ __forceinline__ float bwd_tile(const TailTable& t, int i,
                                          const float* r, const float* e,
                                          float k, const float* gz, float gkl,
                                          float glq, float glp, float* dr) {
  const int n = t.dim[i], ns = t.nscale[i];
  switch (t.kind[i]) {
    case KIND_NORMAL:
      tile_normal_bwd(r, e, n, ns, gz, gkl, glq, glp, dr);
      return 0.f;
    case KIND_WRAPPED_H:
      return tile_wrapped_h_bwd<D>(r, e, n, ns, k, gz, gkl, glq, glp, dr);
    case KIND_VMF_S2:
      return tile_vmf_s2_bwd(r, e, k, gz, gkl, glq, glp, dr);
    case KIND_WRAPPED_STEREO:
      return tile_wrapped_stereo_bwd<D>(r, e, n, ns, t.sign[i], t.wraps[i], k,
                                        gz, gkl, glq, glp, dr);
    default:
      return tile_wrapped_sphere_bwd<D>(r, e, n, ns, t.wraps[i], k, gz, gkl,
                                        glq, glp, dr);
  }
}

// Phase 1, thread `tid` of block (bx, c): the backward tile of component c
// for its row; dL/dk into dk_rows and into sh (TAIL_GROUPS, TAIL_ROWS)
template <int D>
__device__ __forceinline__ void bwd_rows(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, const float* __restrict__ dz,
    const float* __restrict__ daux, float* __restrict__ draw,
    float* __restrict__ dk_rows, int B, int W, int E, int Z,
    const TailTable& t, int c, int bx, int tid, float* sh) {
  const int w = tid / TAIL_ROWS, lane = tid % TAIL_ROWS;
  const int row = (bx * TAIL_GROUPS + w) * TAIL_ROWS + lane;
  if (row >= B) return;
  const int nc = t.nc;
  const float* ga = daux + (size_t)row * (nc + 2);
  const float dk = bwd_tile<D>(
      t, c, raw + (size_t)row * W + t.raw_off[c],
      eps + (size_t)row * E + t.eps_off[c], kvec[c],
      dz + (size_t)row * Z + t.z_off[c], ga[c], ga[nc], ga[nc + 1],
      draw + (size_t)row * W + t.raw_off[c]);
  dk_rows[(size_t)row * nc + c] = dk;
  sh[w * TAIL_ROWS + lane] = dk;
}

template <int D>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
tail_bwd_kernel(const float* __restrict__ raw, const float* __restrict__ eps,
                const float* __restrict__ kvec, const float* __restrict__ dz,
                const float* __restrict__ daux, float* __restrict__ draw,
                float* __restrict__ dk_rows, float* __restrict__ dk,
                float* __restrict__ part, unsigned* __restrict__ counter,
                int B, int W, int E, int Z, TailTable t) {
  __shared__ float sh[TAIL_GROUPS * TAIL_ROWS];
  __shared__ float gs[TAIL_GROUPS];
  __shared__ bool last;
  const int bx = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  bwd_rows<D>(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t, c, bx,
              tid, sh);
  __syncthreads();
  tail_fold_groups(B, bx, tid, sh, gs);
  __syncthreads();
  if (gridDim.x == 1) {
    tail_fold_direct(B, c, tid, gs, dk);
    return;
  }
  tail_fold_publish(B, t.nc, c, bx, tid, gs, part);
  __syncthreads();
  if (tid == 0) last = tail_fold_ticket(counter + c, gridDim.x);
  __syncthreads();
  if (last) {
    __threadfence();
    tail_fold_last(B, t.nc, c, tid, part, dk, counter);
  }
}

extern "C" int tail_bwd_launch(const float* raw, const float* eps,
                               const float* kvec, const float* dz,
                               const float* daux, float* draw, float* dk_rows,
                               float* dk, float* part, unsigned* counter,
                               int B, int W, int E, int Z, int nc,
                               const int* table, void* stream) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const dim3 grid(tail_bwd_blocks(B), nc), block(tail_bwd_threads(B));
    cudaStream_t s = (cudaStream_t)stream;
    switch (tail_dim_class(t)) {
      case 2:
        tail_bwd_kernel<2><<<grid, block, 0, s>>>(
            raw, eps, kvec, dz, daux, draw, dk_rows, dk, part, counter, B, W,
            E, Z, t);
        break;
      case 3:
        tail_bwd_kernel<3><<<grid, block, 0, s>>>(
            raw, eps, kvec, dz, daux, draw, dk_rows, dk, part, counter, B, W,
            E, Z, t);
        break;
      case 6:
        tail_bwd_kernel<6><<<grid, block, 0, s>>>(
            raw, eps, kvec, dz, daux, draw, dk_rows, dk, part, counter, B, W,
            E, Z, t);
        break;
      default:
        tail_bwd_kernel<0><<<grid, block, 0, s>>>(
            raw, eps, kvec, dz, daux, draw, dk_rows, dk, part, counter, B, W,
            E, Z, t);
    }
  }
  return (int)cudaGetLastError();
}
