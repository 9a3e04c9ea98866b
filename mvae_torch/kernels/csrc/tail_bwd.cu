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
// Design (launch geometry in tail_grid.cuh): for the flagship's kinds a
// block holds up to 8 warps of one component, a warp 32 rows, so a row's
// components run side by side in blocks of their own and the row's chain
// is its longest tile (at the training batch of 128: nc blocks of 4
// warps). A product with a d/p/u or s component runs split
// (tail_bwd_kernel_split): 16 threads a row, 16 rows of one component a
// block, in seven phases: the row's coordinates and the mean head with
// their derivative factors (a thread each); the owner's recomputed draw
// beside the drawn-radius sum's inputs; the sums' terms and the reverse's
// derivative factors (a thread each); the branches' records of the
// log-sum-exps; the owner's reverse sweep, which only adds and multiplies
// what the other threads evaluated (the transcendentals and most
// divisions ran on them); each coordinate's reverse through the sigma cap
// beside the owner's mean head; the owner's sums. The owner keeps its
// inputs and saved intermediates in registers across the barriers, and
// every record is added in the serial sweep's order, so the results equal
// the serial tiles' (scripts/tail_previous) bit for bit. (At B = 128 the
// serial tiles ran a u6 product on one SM: 4 warps, each row one chain of
// ~12 log / sin evaluations and ~40 divisions.) The tiles and their
// reverse sweeps are templates on the component dimension (2, 3, 6 with
// every vector in registers; 0 the generic instantiation, n <= 32 in local
// memory), instantiated per dimension class of the product as in
// tail_fwd.cu. Each row's forward is recomputed by the forward tiles of
// tail_tiles.cuh (the same expressions as tail_fwd.cu, compiled with the
// same --fmad=false and no fast math, so the recomputed intermediates equal
// the forward kernel's bit for bit), then the reverse sweep runs on them.
// The per-row curvature gradients are written out as (B, nc) and folded
// over the batch in the same launch, in a fixed order (32-row groups in
// row order, then the groups in order): for the flagship's kinds at B <=
// 256 inside the component's one block, above as B6 folds (each block
// publishes its groups' sums, fences and takes a ticket on its component's
// counter; the last block sums them in order and resets the counter); for
// a split component every block fences its rows' values and takes the
// ticket, and the last block stages dk_rows in shared memory and sums it
// in the same order. So graph replays are bit-equal, the caller needs no
// sum, and no atomics touch the sums' values.
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
// (the two terms it adds also into c1, c2). pw7 = powf(w6, -7/6), computed
// with the coordinate (split_coord).
__device__ __forceinline__ float sigma_cap_bwd(float gsig, float capr,
                                               float tq, float tc, float pw,
                                               float pw7, float* gcapr,
                                               float* c1, float* c2) {
  const float tc2 = tc * tc;
  *c1 = gsig * tc * pw;
  *gcapr += *c1;
  const float gpw = gsig * capr * tc;
  const float gw6 = gpw * F(-1.0 / 6.0) * pw7;
  const float gtc = gsig * capr * pw + gw6 * 3.f * tc2 * tc2 * 2.f * tc;
  const float gtq = (tq <= 8.f) ? gtc : 0.f;
  *c2 = gtq * tq / capr;
  *gcapr -= *c2;
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

// The factors the reverse of ball_scale(k, smax, xn2) takes: rs = rsqrt(q)
// and -rs / (2 q), q = max(xn2, tiny)
__device__ __forceinline__ void ball_factors(float xn2, float* rs, float* f) {
  const float q = fmaxf(xn2, TINY);
  *rs = rsqrtf(q);
  *f = -0.5f * *rs / q;
}

// Reverse of s = ball_scale(k, smax, xn2) on its factors (ball_factors):
// adds to the gradients of smax and xn2
__device__ __forceinline__ void ball_scale_bwd(float k, float smax, float xn2,
                                               float rs, float f, float gs,
                                               float* gsmax, float* gxn2) {
  if (!(k < 0.f)) return;
  if (!(smax * rs <= 1.f)) return;
  *gsmax += gs * rs;
  if (xn2 >= TINY) *gxn2 += gs * smax * f;
}

// The gradients the branches of the drawn-radius sum accumulate
struct LqGrads {
  float rp, quad, period, sqk, kpos, xred, vsq_g, ls, k;
};

// A live branch's record of what its reverse adds to LqGrads (LQ_REC
// floats): quad, ls (subtracted), then at m = 0 kpos and rp (K > 0 side) or
// k and vsq_g, else xred, sqk and period, and last rp
#define LQ_REC 6

// Reverse of branch m (live, at radius rb) of the drawn-radius sum, whose
// cotangent is gt, as its record r; cs = cos x_red
__device__ __forceinline__ void lq_term_rec(int n, int sign, float k,
                                            const LqCommon& c, float cs, int m,
                                            float rb, float gt, float* r) {
  const float nm1 = F(n - 1.0);
  float grb = -gt * rb * c.quad;
  r[0] = -0.5f * gt * rb * rb;
  r[1] = gt;
  r[4] = 0.f;
  if (m == 0) {
    const float gu0 = -gt * nm1 * d_log_sindiv_u_soft(c.u0, sign);
    r[2] = c.pos ? gu0 * c.rp * c.rp : gu0 * c.vsq_g;
    r[3] = c.pos ? gu0 * c.kpos * 2.f * c.rp : gu0 * k;
  } else {
    const float gsph = -gt * nm1;
    const float arb = fabsf(rb);
    const float xb = c.sqk * arb;
    float gx, gtaper;
    d_log_abs_sin_soft_at(c.sn, cs, xb, &gx, &gtaper);
    r[2] = gsph * gx;
    float gxb = gsph * gtaper;
    if (xb >= TINY) gxb -= gsph / xb;
    r[3] = gxb * arb;
    grb += gxb * c.sqk * sgn_f(rb);
    r[4] = grb * (float)m;
  }
  r[5] = grb;
}

// Branch m's record added to the sum's gradients
__device__ __forceinline__ void lq_acc(LqGrads& a, const float* r, int m,
                                       int pos) {
  a.quad += r[0];
  a.ls -= r[1];
  if (m == 0) {
    if (pos) {
      a.kpos += r[2];
      a.rp += r[3];
    } else {
      a.k += r[2];
      a.vsq_g += r[3];
    }
  } else {
    a.xred += r[2];
    a.sqk += r[3];
    a.period += r[4];
  }
  a.rp += r[5];
}

// The branch records in a split component's branch area (after BR_FWD):
// the drawn-radius branches' (LQ_REC each), then the prior's: its principal
// branch's (the gradient of k it adds first, and gr0 so far), and each wrap
// image's (LP_REC: the three terms gsqk0 takes, the two gr0 takes, and
// gperiod's)
#define BR_REC BR_FWD
#define LP_REC 6
#define BR_PREC (BR_REC + LQ_BRANCHES * LQ_REC)
// the reverse sweep's hand-over to the coordinates' lanes (split_sigma_rev):
// the gradient of each v_j and of sum log sigma, and back from the lanes
// each coordinate's softplus-scale gradient and its two terms of the cap
// radius's gradient
#define RV_GV (BR_PREC + 2 + 2 * LP_REC)
#define RV_GLS (RV_GV + MAX_DIM)
#define RV_GS0 (RV_GLS + 1)
#define RV_C1 (RV_GS0 + MAX_DIM)
#define RV_C2 (RV_C1 + MAX_DIM)
#define BR_BWD (RV_C2 + MAX_DIM)

// The backward's derivative factors in BR_DF, each at a value of the
// owner's forward (BR_DI) or the sums' inputs, on lanes of their own: d/p/u
// d tandiv(ug), d arctandiv(w), the ball factors of zn2pre and of g0^2
// vsq, d log_sindiv(k vsq_g) of the closed-form drawn-radius term; the
// sphere d arcsindiv(wa), d cos_u(tt), d sindiv(tt)
#define DF_DUG 0
#define DF_DW 1
#define DF_ZRS 2
#define DF_ZF 3
#define DF_GRS 4
#define DF_GF 5
#define DF_DLS 6

// Reverse of logq_drawn: from glq, adds to the gradients of vsq, ls and k.
// Each live branch of the sum gets its softmax weight; a dead branch none.
// With a split component's branch area `sa`, from the terms' records
// (split_branch_rec) added in branch order, and the closed form's
// derivative factor (DF_DLS).
__device__ __forceinline__ void logq_drawn_bwd(int n, int wraps, int sign,
                                               float k, float vsq, float s2,
                                               float ls, const LqCommon& c,
                                               float mx, float acc, float g,
                                               float* gvsq, float* gls,
                                               float* gk, const float* sa) {
  const float nm1 = F(n - 1.0);
  if (sign < 0) {
    const float vsq_g = vsq + TINY;
    const float gu =
        -nm1 * g
        * (sa ? sa[BR_DF + DF_DLS] : d_log_sindiv_u_soft(k * vsq_g, sign));
    *gls -= g;
    *gvsq += gu * k;
    *gk += gu * vsq_g;
    return;
  }
  LqGrads a = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (sa) {
    const int nq = split_lq_terms(sign, wraps);
#pragma unroll
    for (int i = 0; i < LQ_BRANCHES; ++i)
      if ((nq > 1 || i == 4) && sa[BR_LIVE + i] != 0.f)
        lq_acc(a, sa + BR_REC + LQ_REC * i, i - 4, c.pos);
  } else {
    const float cs = wraps > 0 ? cosf(c.x_red) : 0.f;
    const int M = (wraps == 0) ? 0 : wraps + 3;
    for (int m = -M; m <= M; ++m) {
      float rb, t, r[LQ_REC];
      if (!lq_term(n, sign, ls, c, m, &rb, &t)) continue;
      lq_term_rec(n, sign, k, c, cs, m, rb,
                  (M == 0) ? g : g * (expf(t - mx) / acc), r);
      lq_acc(a, r, m, c.pos);
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

// The prior's wrap image i (live, at radius rb, cotangent gt) reversed, as
// its record r (LP_REC); sn0, cs0 = sin, cos of sqk0 r0
__device__ __forceinline__ void lp_wrap_rec(int n, float r0, float sqk0,
                                            float sn0, float cs0, int i,
                                            float rb, float gt, float* r) {
  const float nm1 = F(n - 1.0);
  const float arb = fabsf(rb);
  float grb = -gt * rb;
  const float glsk = -gt * nm1;
  if (arb >= TINY) grb += gt * nm1 / arb * sgn_f(rb);
  r[0] = glsk / sqk0;
  const float xb = sqk0 * arb;
  float gx, gtaper;
  d_log_abs_sin_soft_at(sn0, cs0, xb, &gx, &gtaper);
  r[1] = glsk * gx * r0;
  r[3] = glsk * gx * sqk0;
  r[2] = glsk * gtaper * arb;
  grb += glsk * gtaper * sqk0 * sgn_f(rb);
  r[4] = grb;
  r[5] = (i == 1) ? grb : -grb;
}

// Reverse of logp_prior: from glp, returns the gradient of r0 and adds to
// the gradient of k; with a split component's branch area `sa`, from its
// terms' records (split_branch_rec), in branch order
__device__ __forceinline__ float logp_prior_bwd(int n, int wraps, int sign,
                                                float k, float r0,
                                                const LpSaved& s, float g,
                                                float* gk, const float* sa) {
  float gr0, gsqk0 = 0.f, gperiod = 0.f, sqk0, period;
  float r[2 + 2 * LP_REC];
  const float* rec = r;
  int live[3];
  if (sa) {
    rec = sa + BR_PREC;
    *gk += rec[0];
    gr0 = rec[1];
    if (!(wraps > 0 && sign >= 0)) return gr0;
    live[1] = sa[BR_LIVE + LQ_BRANCHES + 1] != 0.f;
    live[2] = sa[BR_LIVE + LQ_BRANCHES + 2] != 0.f;
    sqk0 = sa[BR_SQK0];
    period = sa[BR_PERIOD];
  } else {
    const float nm1 = F(n - 1.0);
    const float g0 = s.wrapped ? g * (expf(s.t[0] - s.mx) / s.acc) : g;
    const float gup = -g0 * nm1 * d_log_sindiv_u_soft(s.up, sign);
    *gk += gup * s.r02;
    const float gr02 = -0.5f * g0 + gup * k;
    gr0 = gr02 * 2.f * r0;
    if (!s.wrapped) return gr0;
    sqk0 = s.sqk0;
    period = s.period;
    const float x0 = sqk0 * r0, sn0 = sinf(x0), cs0 = cosf(x0);
    for (int i = 1; i <= 2; ++i) {
      live[i] = s.live[i];
      if (live[i])
        lp_wrap_rec(n, r0, sqk0, sn0, cs0, i, s.rb[i],
                    g * (expf(s.t[i] - s.mx) / s.acc),
                    r + 2 + LP_REC * (i - 1));
    }
  }
  for (int i = 1; i <= 2; ++i) {
    if (!live[i]) continue;
    const float* w = rec + 2 + LP_REC * (i - 1);
    gsqk0 -= w[0];
    gsqk0 += w[1];
    gr0 += w[3];
    gsqk0 += w[2];
    gr0 += w[4];
    gperiod += w[5];
  }
  gsqk0 -= gperiod * period / sqk0;
  if (k >= 1e-20f) *gk += gsqk0 / (2.f * sqk0);
  return gr0;
}

// Term b of a split component's sums reversed on a thread of its own: its
// record into the branch area `a` from the cotangents gq of log q and gp of
// log p, each branch of a log-sum-exp weighted by its softmax weight (the
// log-sum-exp taken again in branch order, as the forward took it); for the
// closed-form drawn-radius term, its derivative factor (DF_DLS)
__device__ __forceinline__ void split_branch_rec(int n, int sign, int wraps,
                                                 int b, float gq, float gp,
                                                 float* a) {
  const float k = a[BI_K], r0 = a[BI_R0];
  const int nq = split_lq_terms(sign, wraps);
  float mx, acc;
  if (b < nq) {
    LqCommon c;
    if (nq == 1) {
      if (sign < 0) {
        a[BR_DF + DF_DLS] = d_log_sindiv_u_soft(k * a[BI_VSQG], sign);
        return;
      }
      split_lq_common(n, a, false, c);
      a[BR_LIVE + 4] = 1.f;
      lq_term_rec(n, sign, k, c, 0.f, 0, c.rp + (float)0 * c.period, gq,
                  a + BR_REC + LQ_REC * 4);
      return;
    }
    if (a[BR_LIVE + b] == 0.f) return;
    split_lse(a + BR_T, LQ_BRANCHES, &mx, &acc);
    split_lq_common(n, a, true, c);
    const int m = b - 4;
    lq_term_rec(n, sign, k, c, a[BI_CS], m, c.rp + (float)m * c.period,
                gq * (expf(a[BR_T + b] - mx) / acc),
                a + BR_REC + LQ_REC * b);
    return;
  }
  const int i = b - nq;
  const bool wrapped = split_lp_terms(sign, wraps) > 1;
  if (wrapped) split_lse(a + BR_T + LQ_BRANCHES, 3, &mx, &acc);
  const float t = a[BR_T + LQ_BRANCHES + i];
  if (i == 0) {  // lp_term0's r02 and up
    const float r02 = r0 * r0, up = k * r02;
    const float g0 = wrapped ? gp * (expf(t - mx) / acc) : gp;
    const float gup = -g0 * F(n - 1.0) * d_log_sindiv_u_soft(up, sign);
    a[BR_PREC] = gup * r02;
    const float gr02 = -0.5f * g0 + gup * k;
    a[BR_PREC + 1] = gr02 * 2.f * r0;
    return;
  }
  if (a[BR_LIVE + LQ_BRANCHES + i] == 0.f) return;
  lp_wrap_rec(n, r0, a[BR_SQK0], a[BR_SN0], a[BR_CS0], i, a[BR_RB + i - 1],
              gp * (expf(t - mx) / acc), a + BR_PREC + 2 + LP_REC * (i - 1));
}

// The backward's derivative factors of a split row taken at the owner's
// draw, one a lane (BR_DF, at BR_DI): d/p/u d arctandiv(w) and the ball
// factors of zn2pre; the sphere d arcsindiv(wa), then d cos_u(tt) and d
// sindiv(tt) on one lane

__device__ __forceinline__ void split_deriv(int kind, int sign, int d,
                                            float* a) {
  const float* di = a + BR_DI;
  float* df = a + BR_DF;
  if (kind == KIND_WRAPPED_STEREO) {
    if (d == 0) {
      df[DF_DW] = d_arctandiv_u(di[1], sign);
    } else {
      ball_factors(di[2], df + DF_ZRS, df + DF_ZF);
    }
  } else if (d == 0) {
    df[DF_DUG] = d_arcsindiv_u_pos(di[0]);
  } else {
    df[DF_DW] = d_cos_u_sgn(di[1], 1);
    df[DF_ZRS] = d_sindiv_u(di[1]);
  }
}

// The stereographic draw's factors that |v|^2 alone sets, on a lane of its
// own beside the owner (split phase 1): d tandiv(ug) at ug = k vsq / 4 and
// the ball factors of g0^2 vsq, g0 = tandiv(ug) / 2 (as stereo_draw_z)
__device__ __forceinline__ void split_vsq_deriv(int n, int sign, float k,
                                                const float* co,
                                                const float* e, float* a) {
  float vsq = 0.f;
  for (int j = 0; j < n; ++j) {
    const float vj = co[CO_SIG * n + j] * e[j];
    const float t2 = vj * vj;
    vsq = (j == 0) ? t2 : vsq + t2;
  }
  const float ug = k * vsq / 4.f;
  const float g0 = 0.5f * tandiv_u(ug, sign);
  float* df = a + BR_DF;
  df[DF_DUG] = d_tandiv_u(ug, sign);
  ball_factors(g0 * g0 * vsq, df + DF_GRS, df + DF_GF);
}

// Which term (0 .. SPLIT_BRANCHES - 1: split_branch_fwd's b) or derivative
// factor (split_deriv's d) item `it` of the backward's term phases takes:
// a warp holds items w and w + 8, so the table pairs work of one code on a
// warp: the drawn-radius branches m and -m (items 0-4, 8-11), the m = 0
// branch beside the prior's principal branch (4, 12: both log_sindiv),
// the prior's wrap pair (5, 13), a derivative factor alone (6, 7); with
// one term a sum, those at 4 and 12. -1: no work.
__device__ __forceinline__ int split_term_of(int it, int nq) {
  if (nq == 1) return it == 4 ? 0 : (it == 12 ? 1 : -1);
  if (it <= 4) return it;
  if (it >= 8 && it <= 11) return 16 - it;
  return it == 12 ? LQ_BRANCHES : (it == 5 ? LQ_BRANCHES + 1
                                           : (it == 13 ? LQ_BRANCHES + 2 : -1));
}

__device__ __forceinline__ int split_deriv_of(int it) {
  return (it == 6 || it == 7) ? it - 6 : -1;
}

// The mean head's derivative factors (with the head, split phase 0): d/p/u
// d tandiv(um) and the ball factors of gm^2 r2m; the sphere d cos_u(t_m),
// d sindiv(t_m)
__device__ __forceinline__ void split_head_deriv(int kind, int sign,
                                                 float* hd) {
  if (kind == KIND_WRAPPED_STEREO) {
    hd[HD_DUM] = d_tandiv_u(hd[HD_UM], sign);
    ball_factors(hd[HD_GM] * hd[HD_GM] * hd[HD_R2M], hd + HD_RS, hd + HD_F);
  } else {
    hd[HD_DUM] = d_cos_u_sgn(hd[HD_UM], 1);
    hd[HD_RS] = d_sindiv_u(hd[HD_UM]);
  }
}

// Reverse of stereo_draw: from dz and the cotangents of log q and log p,
// the gradients of mu and of each v_j = sig_j eps_j (into the branch area's
// RV_GV) and of sum log sigma (RV_GLS), the gradient of k added to *gk; the
// derivative factors from the branch area `sa` (split_deriv), the sums'
// records where `sums` (null: the serial sums)
template <int N>
__device__ __forceinline__ void stereo_draw_bwd(int n, int sign, int wraps,
                                                float k, const float* mu,
                                                const StereoSaved<N>& s,
                                                const float* dz, float gq,
                                                float gp, float* gmu,
                                                float* gk, float* sa,
                                                const float* sums) {
  const int nn = TAIL_DIM(N, n);
  const float* df = sa + BR_DF;
  float gsmax = 0.f;
  // lp from r0 = 2 sqrt(zn2 + tiny) arctandiv(k zn2)
  const float gr0 = logp_prior_bwd(n, wraps, sign, k, s.r0, s.lp, gp, gk,
                                   sums);
  const float gsq = gr0 * 2.f * s.ad;
  const float gw = gr0 * 2.f * s.sq * df[DF_DW];
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
    ball_scale_bwd(k, s.smax, s.zn2pre, df[DF_ZRS], df[DF_ZF], gbsz, &gsmax,
                   &gzn2pre);
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
    ball_scale_bwd(k, s.smax, s.g0 * s.g0 * s.vsq, df[DF_GRS], df[DF_GF],
                   gg * s.g0, &gsmax, &gxn2);
    gg0 += gxn2 * 2.f * s.g0 * s.vsq;
    gvsq += gxn2 * s.g0 * s.g0;
  }
  const float gug = 0.5f * gg0 * df[DF_DUG];
  *gk += gug * s.vsq / 4.f;
  gvsq += gug * k / 4.f;

  float gls = 0.f;
  LqCommon c = s.lqc;
  if (sums) split_lq_common(n, sums, false, c);
  logq_drawn_bwd(n, wraps, sign, k, s.vsq, s.s2, s.ls, c, s.lq_mx, s.lq_acc,
                 gq, &gvsq, &gls, gk, sums);

  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    sa[RV_GV + j] = gv[j] + (gvsq * 2.f * s.v[j] + gxv * mu[j]);
    gmu[j] += gxv * s.v[j] + gx2 * 2.f * mu[j];
  }
  sa[RV_GLS] = gls;
  // smax = (1 - eps) rsqrt(-min(k, -tiny))
  if (k <= -TINY) *gk += gsmax * 0.5f * s.smax / (-k);
}

// Coordinate j's part of a split row's reverse sweep, on its own lane: the
// scale's gradient from v_j's and sum log sigma's (the branch area `sa`'s
// RV_GV, RV_GLS), through the cap (sigma_cap_bwd, where the component can
// wrap) to the softplus scale's: draw[n + j] written (ns > 1), or the
// coordinate's share kept for the owner's sum (ns = 1); its two terms of
// the cap radius's gradient kept for the owner
__device__ __forceinline__ void split_sigma_rev(int kind, int sign, int n,
                                                int ns, float k, int j,
                                                const float* co,
                                                const float* e, float* sa,
                                                float* draw) {
  const float sig = co[CO_SIG * n + j];
  float gsig = sa[RV_GV + j] * e[j];
  if (sig >= TINY) gsig += sa[RV_GLS] / sig;
  float gs0 = gsig, gcapr = 0.f;
  if (kind == KIND_WRAPPED_S || sign >= 0) {
    gs0 = sigma_cap_bwd(gsig, F(PI) * rsqrtf(fmaxf(k, 1e-12f)),
                        co[CO_TQ * n + j], co[CO_TC * n + j],
                        co[CO_PW * n + j], co[CO_PW7 * n + j], &gcapr,
                        sa + RV_C1 + j, sa + RV_C2 + j);
  }
  if (ns == 1) {
    sa[RV_GS0 + j] = gs0;
  } else {
    draw[n + j] = gs0 * co[CO_DSP * n + j];
  }
}

// The owner's last step: the scale gradients' sum (ns = 1) into draw[n] and
// the cap radius's gradient (its coordinates' terms in coordinate order)
// added to the returned dL/dk
template <int N>
__device__ __forceinline__ float split_owner_final(int kind, int sign, int n,
                                                   int ns, float k, float gk,
                                                   const float* co,
                                                   const float* sa,
                                                   float* draw) {
  const int nn = TAIL_DIM(N, n);
  const bool cap = kind == KIND_WRAPPED_S || sign >= 0;
  float gcapr = 0.f, gsum = 0.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    if (cap) {
      gcapr += sa[RV_C1 + j];
      gcapr -= sa[RV_C2 + j];
    }
    if (ns == 1) gsum = (j == 0) ? sa[RV_GS0 + j] : gsum + sa[RV_GS0 + j];
  }
  if (ns == 1) draw[n] = gsum * co[CO_DSP * n];
  const float kc = fmaxf(k, 1e-12f);
  if (cap && k >= 1e-12f) gk += gcapr * (-0.5f) * (F(PI) * rsqrtf(kc)) / kc;
  return gk;
}

// _tile_wrapped_stereo reversed by the row's owner, on the intermediates
// its stereo_owner_fwd saved (h, s), up to the mean: gmu and dL/dk so far
// kept for stereo_head_rev, v's and sum log sigma's gradients into the
// branch area `sa` (split_sigma_rev takes them), the sums' records where
// `sums`
template <int N>
__device__ __forceinline__ void stereo_owner_rev(
    int n, int sign, int wraps, float k, const float* dz, float gkl,
    float glq, float glp, const StereoHead<N>& h, const StereoSaved<N>& s,
    float* sa, const float* sums, float* gmu, float* gk) {
  *gk = 0.f;
  stereo_draw_bwd(n, sign, wraps, k, h.mu, s, dz, glq + gkl, glp - gkl, gmu,
                  gk, sa, sums);
}

// The mean head's reverse by the owner (mu = gm mu_tan ball_scale(gm^2
// r2m), gm = tandiv(k r2m / 4) / 2, on the head's factors `hd`):
// draw[0 : n], and dL/dk so far
template <int N>
__device__ __forceinline__ float stereo_head_rev(int n, int sign, float k,
                                                 const float* mt,
                                                 const StereoHead<N>& h,
                                                 const float* hd, float* gmu,
                                                 float gk, float* draw) {
  const int nn = TAIL_DIM(N, n);
  float ggm = 0.f, gr2m = 0.f, gsmax = 0.f;
  if (sign <= 0) {
    float gbs = 0.f;
    #pragma unroll
    for (int j = 0; j < nn; ++j) {
      gbs += gmu[j] * h.mu0[j];
      gmu[j] = gmu[j] * h.bsm;
    }
    float gxn2 = 0.f;
    ball_scale_bwd(k, h.smax, h.gm * h.gm * h.r2m, hd[HD_RS], hd[HD_F], gbs,
                   &gsmax, &gxn2);
    ggm += gxn2 * 2.f * h.gm * h.r2m;
    gr2m += gxn2 * h.gm * h.gm;
    if (k <= -TINY) gk += gsmax * 0.5f * h.smax / (-k);
  }
  #pragma unroll
  for (int j = 0; j < nn; ++j) ggm += gmu[j] * mt[j];
  const float gum = 0.5f * ggm * hd[HD_DUM];
  gk += gum * h.r2m / 4.f;
  gr2m += gum * k / 4.f;
  #pragma unroll
  for (int j = 0; j < nn; ++j) draw[j] = gmu[j] * h.gm + gr2m * 2.f * mt[j];
  return gk;
}

// _tile_wrapped_sphere reversed by the row's owner, on the intermediates
// its sphere_owner_fwd saved, the head's derivative factors `hd` and the
// branch area `sa` (as stereo_owner_rev): draw[0 : n], v's and sum log
// sigma's gradients into `sa` (split_sigma_rev takes them), and the
// returned dL/dk but for the cap radius's share (split_owner_final); dz
// has n + 1 entries.
template <int N>
__device__ __forceinline__ float sphere_owner_rev(
    const float* mt, int n, int wraps, float k, const float* dz, float gkl,
    float glq, float glp, float* draw, const SphSaved<N>& s, const float* hd,
    float* sa, const float* sums) {
  const float* df = sa + BR_DF;
  const int nn = TAIL_DIM(N, n);
  const float gq = glq + gkl;  // kl = lq - lp
  const float gp = glp - gkl;
  float gkk = 0.f, gsqk = 0.f, gr = 0.f;
  float gmsp[TAIL_ARR(N)], gusp[TAIL_ARR(N)], gv[TAIL_ARR(N)],
      gwsp[TAIL_ARR(N)];

  // lp from r0 = 2 half arcsindiv(kk half^2), half = min(sqrt(chord0 + tiny)
  // / 2, (1 - eps) r), chord0 = (z_t - r)^2 + |z_sp|^2
  const float gr0 = logp_prior_bwd(n, wraps, 1, s.kk, s.r0, s.lp, gp, &gkk,
                                   sums);
  float ghalf = gr0 * 2.f * s.asd;
  const float gwa = gr0 * 2.f * s.half * df[DF_DUG];
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
  LqCommon c = s.lqc;
  if (sums) split_lq_common(n, sums, false, c);
  logq_drawn_bwd(n, wraps, 1, s.kk, s.vsq, s.s2, s.ls, c, s.lq_mx, s.lq_acc,
                 gq, &gvsq, &gls, &gkk, sums);

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
  const float gtt = gcu * df[DF_DW] + gsd * df[DF_ZRS];
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
    gsdm += gmsp[j] * mt[j];
  }
  gr += gm_t * s.cm;
  const float gtm = gm_t * s.r * hd[HD_DUM] + gsdm * hd[HD_RS];
  gkk += gtm * s.r2m;
  const float gr2m = gtm * s.kk;
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    draw[j] = gmsp[j] * s.sdm + gr2m * 2.f * mt[j];
    sa[RV_GV + j] = gv[j];
  }
  sa[RV_GLS] = gls;

  // r = 1 / sqrt_k, sqrt_k = sqrt(kk), kk = max(k, tiny)
  gsqk -= gr * s.r * s.r;
  gkk += gsqk / (2.f * s.sqrt_k);
  return (k >= TINY) ? gkk : 0.f;
}

// One component's backward tile for one row, by the table's kind (the
// kinds that run a row on one thread): the tile's head gradients into draw
// and the returned dL/dk
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
    default:
      return tile_vmf_s2_bwd(r, e, k, gz, gkl, glq, glp, dr);
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

// --- the split backward: phases of a block of TAIL_SPLIT_ROWS rows of one
// split component c. Thread tid serves row g = tail_split_row(tid), whose
// floats start at sh + g TAIL_BWD_ROW (an odd stride: a warp's 16 rows
// fall in 16 banks): the component's coordinates (CO_BWD a coordinate),
// the owner's staged inputs, the mean head and the branch area (BR_BWD).
// The row's owner (item 0) keeps its inputs and its forward's saved
// intermediates in registers from phase 0 to phase 6 (SplitStereo,
// SplitSphere).
#define TAIL_BWD_ROW (((CO_BWD + 2) * MAX_DIM + HD_N + BR_BWD) | 1)

// What the owner of a row reads of device memory, loaded in phase 0 so that
// no later phase waits on it: z's cotangent and the aux cotangents (kl,
// sum log q, sum log p)
template <int N>
struct SplitIn {
  float gz[TAIL_ARR(N) + 1], ga[3];
};

template <int N>
struct SplitStereo {
  SplitIn<N> in;
  StereoHead<N> h;
  StereoSaved<N> s;
  float gmu[TAIL_ARR(N)], gk;
};

template <int N>
struct SplitSphere {
  SplitIn<N> in;
  SphSaved<N> s;
  float gk;
};

// Phase 0: coordinate j of the row on item j (staging the owner's inputs at
// j), the mean head and its derivative factors on item n; the owner (item
// 0) loads its cotangents (and hands the sums' on to the term phases)
template <int D, class S>
__device__ __forceinline__ void bwd_split_coords(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, const float* __restrict__ dz,
    const float* __restrict__ daux, int B, int W, int E, int Z,
    const TailTable& t, int c, int bx, int tid, float* sh, S& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  const int n = t.dim[c], nn = TAIL_DIM(D, n), item = tail_split_item(tid);
  const float* r = raw + (size_t)row * W + t.raw_off[c];
  float* base = sh + g * TAIL_BWD_ROW;
  if (item == 0) {
    const float* gz = dz + (size_t)row * Z + t.z_off[c];
    const float* ga = daux + (size_t)row * (t.nc + 2);
    const int nz = t.kind[c] == KIND_WRAPPED_S ? nn + 1 : nn;
    #pragma unroll
    for (int j = 0; j < TAIL_ARR(D) + 1; ++j)
      if (j < nz) st.in.gz[j] = gz[j];
    st.in.ga[0] = ga[c];
    st.in.ga[1] = ga[t.nc];
    st.in.ga[2] = ga[t.nc + 1];
    // kl = lq - lp: the cotangents of log q and log p, for the term phases
    float* a = split_br(base, n, CO_BWD);
    a[BR_GQ] = st.in.ga[1] + st.in.ga[0];
    a[BR_GP] = st.in.ga[2] - st.in.ga[0];
  }
  for (int j = item; j <= n; j += TAIL_LANES) {
    float* hd = split_hd(base, n, CO_BWD);
    if (j == n) {
      if (t.kind[c] == KIND_WRAPPED_STEREO)
        stereo_head(r, n, t.sign[c], kvec[c], hd);
      else
        sphere_head(r, n, kvec[c], hd);
      split_head_deriv(t.kind[c], t.sign[c], hd);
      continue;
    }
    float* in = split_in(base, n, CO_BWD);
    in[j] = r[j];
    in[n + j] = eps[(size_t)row * E + t.eps_off[c] + j];
    split_coord(t.kind[c], t.sign[c], r, n, t.nscale[c], kvec[c], j, CO_BWD,
                base);
  }
}

// Phase 1: the owner (item 0) recomputes the row's draw (and, where the sums
// do not split, sums them serially); item 1 the drawn-radius sum's inputs;
// for d/p/u item 2 the factors |v|^2 sets (split_vsq_deriv)
template <int D>
__device__ __forceinline__ void bwd_split_owner(const float* __restrict__ kvec,
                                                int B, const TailTable& t,
                                                int c, int bx, int tid,
                                                float* sh, SplitStereo<D>& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  const int item = tail_split_item(tid), n = t.dim[c];
  if (item > 2 || row >= B) return;
  float* base = sh + g * TAIL_BWD_ROW;
  const float* mt = split_in(base, n, CO_BWD);
  if (item == 1) {
    split_lq_prep(n, t.sign[c], t.wraps[c], kvec[c], base, mt + n,
                  split_br(base, n, CO_BWD));
    return;
  }
  if (item == 2) {
    split_vsq_deriv(n, t.sign[c], kvec[c], base, mt + n,
                    split_br(base, n, CO_BWD));
    return;
  }
  float zbuf[TAIL_ARR(D)], q, p;
  stereo_owner_fwd<D>(mt, mt + n, n, t.sign[c], kvec[c], base,
                      split_hd(base, n, CO_BWD), zbuf,
                      split_br(base, n, CO_BWD), st.h, st.s);
  if (!tail_branches(t, c))
    stereo_owner_sums<D>(n, t.sign[c], t.wraps[c], kvec[c], st.s, &q, &p);
}

template <int D>
__device__ __forceinline__ void bwd_split_owner(const float* __restrict__ kvec,
                                                int B, const TailTable& t,
                                                int c, int bx, int tid,
                                                float* sh, SplitSphere<D>& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  const int item = tail_split_item(tid), n = t.dim[c];
  if (item > 1 || row >= B) return;
  float* base = sh + g * TAIL_BWD_ROW;
  const float* mt = split_in(base, n, CO_BWD);
  if (item == 1) {
    split_lq_prep(n, 1, t.wraps[c], fmaxf(kvec[c], TINY), base, mt + n,
                  split_br(base, n, CO_BWD));
    return;
  }
  float zbuf[TAIL_ARR(D) + 1], q, p;
  sphere_owner_fwd<D>(mt, mt + n, n, kvec[c], base, split_hd(base, n, CO_BWD),
                      zbuf, split_br(base, n, CO_BWD), st.s);
  if (!tail_branches(t, c)) sphere_owner_sums<D>(n, t.wraps[c], st.s, &q, &p);
}

// Phase 2: the sums' terms (where they split: a log-sum-exp's branches, or
// a lone term's record) and the derivative factors, an item a lane as
// split_term_of and split_deriv_of place them
__device__ __forceinline__ void bwd_split_branches(int B, const TailTable& t,
                                                   int c, int bx, int tid,
                                                   float* sh) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  const int n = t.dim[c], sign = tail_branch_sign(t, c), wraps = t.wraps[c];
  const int nq = split_lq_terms(sign, wraps), it = tail_split_item(tid);
  float* a = split_br(sh + g * TAIL_BWD_ROW, n, CO_BWD);
  const int d = split_deriv_of(it);
  if (d >= 0) {
    split_deriv(t.kind[c], t.sign[c], d, a);
    return;
  }
  const int b = tail_branches(t, c) ? split_term_of(it, nq) : -1;
  if (b < 0) return;
  if (nq > 1) {
    split_branch_fwd(n, sign, wraps, b, a);
  } else {
    split_branch_rec(n, sign, wraps, b, a[BR_GQ], a[BR_GP], a);
  }
}

// Phase 3: the log-sum-exps' branch records, a branch a lane as
// split_term_of places them
__device__ __forceinline__ void bwd_split_records(int B, const TailTable& t,
                                                  int c, int bx, int tid,
                                                  float* sh) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  const int n = t.dim[c], sign = tail_branch_sign(t, c), wraps = t.wraps[c];
  const int nq = split_lq_terms(sign, wraps);
  if (row >= B || !tail_branches(t, c) || nq == 1) return;
  const int b = split_term_of(tail_split_item(tid), nq);
  if (b < 0) return;
  float* a = split_br(sh + g * TAIL_BWD_ROW, n, CO_BWD);
  split_branch_rec(n, sign, wraps, b, a[BR_GQ], a[BR_GP], a);
}

// Phase 4, the owner: the reverse sweep up to the mean head (the sphere's
// through it)
template <int D>
__device__ __forceinline__ void bwd_split_reverse(
    const float* __restrict__ kvec, float* __restrict__ draw, int B, int W,
    const TailTable& t, int c, int bx, int tid, float* sh,
    SplitStereo<D>& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (tail_split_item(tid) != 0 || row >= B) return;
  const int n = t.dim[c];
  float* a = split_br(sh + g * TAIL_BWD_ROW, n, CO_BWD);
  const float* ga = st.in.ga;
  stereo_owner_rev<D>(n, t.sign[c], t.wraps[c], kvec[c], st.in.gz, ga[0],
                      ga[1], ga[2], st.h, st.s, a,
                      tail_branches(t, c) ? a : nullptr, st.gmu, &st.gk);
}

template <int D>
__device__ __forceinline__ void bwd_split_reverse(
    const float* __restrict__ kvec, float* __restrict__ draw, int B, int W,
    const TailTable& t, int c, int bx, int tid, float* sh,
    SplitSphere<D>& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (tail_split_item(tid) != 0 || row >= B) return;
  const int n = t.dim[c];
  float* base = sh + g * TAIL_BWD_ROW;
  float* a = split_br(base, n, CO_BWD);
  const float* ga = st.in.ga;
  st.gk = sphere_owner_rev<D>(split_in(base, n, CO_BWD), n, t.wraps[c],
                              kvec[c], st.in.gz, ga[0], ga[1], ga[2],
                              draw + (size_t)row * W + t.raw_off[c], st.s,
                              split_hd(base, n, CO_BWD), a,
                              tail_branches(t, c) ? a : nullptr);
}

// The owner's share of phase 5: the stereographic mean head's reverse (the
// sphere's ran with the rest of its sweep)
template <int D>
__device__ __forceinline__ void bwd_split_head(float k, int n, int sign,
                                               float* base, float* dr,
                                               SplitStereo<D>& st) {
  st.gk = stereo_head_rev<D>(n, sign, k, split_in(base, n, CO_BWD), st.h,
                             split_hd(base, n, CO_BWD), st.gmu, st.gk, dr);
}

template <int D>
__device__ __forceinline__ void bwd_split_head(float, int, int, float*,
                                               float*, SplitSphere<D>&) {}

// Phase 5: coordinate j's reverse on item j % 15 + 1 (split_sigma_rev);
// the owner the stereographic mean head's
template <int D, class S>
__device__ __forceinline__ void bwd_split_sigma(const float* __restrict__ kvec,
                                                float* __restrict__ draw,
                                                int B, int W,
                                                const TailTable& t, int c,
                                                int bx, int tid, float* sh,
                                                S& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (row >= B) return;
  const int n = t.dim[c], item = tail_split_item(tid);
  float* base = sh + g * TAIL_BWD_ROW;
  float* dr = draw + (size_t)row * W + t.raw_off[c];
  if (item == 0) {
    bwd_split_head<D>(kvec[c], n, t.sign[c], base, dr, st);
    return;
  }
  for (int j = item - 1; j < n; j += TAIL_LANES - 1)
    split_sigma_rev(t.kind[c], t.sign[c], n, t.nscale[c], kvec[c], j, base,
                    split_in(base, n, CO_BWD) + n,
                    split_br(base, n, CO_BWD), dr);
}

// Phase 6, the owner: the scales' sum and the cap radius's share; dL/dk
// into dk_rows, fenced for the fold's last block
template <int D, class S>
__device__ __forceinline__ void bwd_split_final(const float* __restrict__ kvec,
                                                float* __restrict__ draw,
                                                float* __restrict__ dk_rows,
                                                int B, int W,
                                                const TailTable& t, int c,
                                                int bx, int tid,
                                                const float* sh, S& st) {
  const int g = tail_split_row(tid), row = bx * TAIL_SPLIT_ROWS + g;
  if (tail_split_item(tid) != 0 || row >= B) return;
  const int n = t.dim[c];
  const float* base = sh + g * TAIL_BWD_ROW;
  dk_rows[(size_t)row * t.nc + c] = split_owner_final<D>(
      t.kind[c], t.sign[c], n, t.nscale[c], kvec[c], st.gk, base,
      base + (CO_BWD + 2) * n + HD_N, draw + (size_t)row * W + t.raw_off[c]);
  __threadfence();
}

// --- launchers

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

// One split component's rows (the phases above, the owner's saved
// intermediates `st` in registers across the barriers)
template <int D, class S>
__device__ __forceinline__ void bwd_split_rows(
    const float* __restrict__ raw, const float* __restrict__ eps,
    const float* __restrict__ kvec, const float* __restrict__ dz,
    const float* __restrict__ daux, float* __restrict__ draw,
    float* __restrict__ dk_rows, int B, int W, int E, int Z,
    const TailTable& t, int c, int bx, int tid, float* sh, S& st) {
  bwd_split_coords<D>(raw, eps, kvec, dz, daux, B, W, E, Z, t, c, bx, tid,
                      sh, st);
  __syncthreads();
  bwd_split_owner<D>(kvec, B, t, c, bx, tid, sh, st);
  __syncthreads();
  bwd_split_branches(B, t, c, bx, tid, sh);
  __syncthreads();
  bwd_split_records(B, t, c, bx, tid, sh);
  __syncthreads();
  bwd_split_reverse<D>(kvec, draw, B, W, t, c, bx, tid, sh, st);
  __syncthreads();
  bwd_split_sigma<D>(kvec, draw, B, W, t, c, bx, tid, sh, st);
  __syncthreads();
  bwd_split_final<D>(kvec, draw, dk_rows, B, W, t, c, bx, tid, sh, st);
}

// The split geometry: grid (tail_split_blocks(B), nc), TAIL_THREADS a block.
// A split component's blocks run its rows split; another component's first
// tail_bwd_blocks(B) blocks run its rows as tail_bwd_kernel does.
template <int D>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
tail_bwd_kernel_split(const float* __restrict__ raw,
                      const float* __restrict__ eps,
                      const float* __restrict__ kvec,
                      const float* __restrict__ dz,
                      const float* __restrict__ daux, float* __restrict__ draw,
                      float* __restrict__ dk_rows, float* __restrict__ dk,
                      float* __restrict__ part, unsigned* __restrict__ counter,
                      int B, int W, int E, int Z, TailTable t) {
  __shared__ float sh[TAIL_SPLIT_ROWS * TAIL_BWD_ROW];
  __shared__ float gs[TAIL_GROUPS], total;
  __shared__ bool last;
  const int bx = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  if (!t.split[c]) {
    const int blocks = tail_bwd_blocks(B);
    if (bx >= blocks) return;
    bwd_rows<D>(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t, c, bx,
                tid, sh);
    __syncthreads();
    tail_fold_groups(B, bx, tid, sh, gs);
    __syncthreads();
    if (blocks == 1) {
      tail_fold_direct(B, c, tid, gs, dk);
      return;
    }
    tail_fold_publish(B, t.nc, c, bx, tid, gs, part);
    __syncthreads();
    if (tid == 0) last = tail_fold_ticket(counter + c, blocks);
    __syncthreads();
    if (last) {
      __threadfence();
      tail_fold_last(B, t.nc, c, tid, part, dk, counter);
    }
    return;
  }
  if (t.kind[c] == KIND_WRAPPED_STEREO) {
    SplitStereo<D> st;
    bwd_split_rows<D>(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t,
                      c, bx, tid, sh, st);
  } else {
    SplitSphere<D> st;
    bwd_split_rows<D>(raw, eps, kvec, dz, daux, draw, dk_rows, B, W, E, Z, t,
                      c, bx, tid, sh, st);
  }
  // each owner fenced its dk_rows store (bwd_split_final)
  __syncthreads();
  if (tid == 0) last = tail_fold_ticket(counter + c, gridDim.x);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r0 = 0; r0 < B; r0 += TAIL_FOLD_CHUNK) {
    tail_split_fold_stage(B, t.nc, c, r0, tid, dk_rows, sh);
    __syncthreads();
    tail_split_fold_groups(B, r0, tid, sh);
    __syncthreads();
    tail_split_fold_total(B, c, r0, tid, sh, &total, dk, counter);
    __syncthreads();
  }
}

template <int D>
static void tail_bwd_go(const float* raw, const float* eps, const float* kvec,
                        const float* dz, const float* daux, float* draw,
                        float* dk_rows, float* dk, float* part,
                        unsigned* counter, int B, int W, int E, int Z,
                        const TailTable& t, cudaStream_t s) {
  if (!tail_any_split(t)) {
    tail_bwd_kernel<D><<<dim3(tail_bwd_blocks(B), t.nc), tail_bwd_threads(B),
                         0, s>>>(raw, eps, kvec, dz, daux, draw, dk_rows, dk,
                                 part, counter, B, W, E, Z, t);
    return;
  }
  tail_bwd_kernel_split<D><<<dim3(tail_split_blocks(B), t.nc), TAIL_THREADS, 0,
                             s>>>(raw, eps, kvec, dz, daux, draw, dk_rows, dk,
                                  part, counter, B, W, E, Z, t);
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
    cudaStream_t s = (cudaStream_t)stream;
    switch (tail_dim_class(t)) {
      case 2:
        tail_bwd_go<2>(raw, eps, kvec, dz, daux, draw, dk_rows, dk, part,
                       counter, B, W, E, Z, t, s);
        break;
      case 3:
        tail_bwd_go<3>(raw, eps, kvec, dz, daux, draw, dk_rows, dk, part,
                       counter, B, W, E, Z, t, s);
        break;
      case 6:
        tail_bwd_go<6>(raw, eps, kvec, dz, daux, draw, dk_rows, dk, part,
                       counter, B, W, E, Z, t, s);
        break;
      default:
        tail_bwd_go<0>(raw, eps, kvec, dz, daux, draw, dk_rows, dk, part,
                       counter, B, W, E, Z, t, s);
    }
  }
  return (int)cudaGetLastError();
}
