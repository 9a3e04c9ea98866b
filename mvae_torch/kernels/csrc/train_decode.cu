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
// Bound: at the flagship step (B = 128, Z = 8, H = 400, D = 784) one call
// does 2 B (Z H + H D) = 81.1 MFLOP (1.26 us at the card's calibrated FP32
// rate) on 2.28 MB (0.79 us at its triad rate), so what bounds it is
// latency and the share of the 132 SMs in use, not operations or bytes.
//
// Design (train_decode_plan.cuh holds the plan):
// - Tiles of 16 batch rows x 32 pixels: 8 x 25 = 200 blocks at B = 128,
//   so every SM has a block (32-row tiles would give 100); 4 waves and
//   more at eval's B = 512 and B = 1024. Each block of 4 warps owns its
//   16 x 32 logits; warp w sums the 8-deep steps k of the hidden layer
//   with k % 4 == w, and the 4 partial tiles are added in warp order.
// - W2's column slice (H x 32 floats, 51 KB at H = 400) is fetched while
//   the block computes h for its 16 rows (Z FMAs an entry, recomputed by
//   each pixel tile); then the block waits once, and the hidden-unit loop
//   reads only shared memory and has no __syncthreads. Where D % 4 == 0
//   one thread hands the Tensor Memory Accelerator a box of 16 units x 40
//   pixels a stage (the padded layout below; zeros past H and D), all on
//   one mbarrier. cp.async copies (4 or 16 bytes; D % 4 != 0, and the
//   ring) are issued by every thread, after the block's x, b2, z and first
//   W1 loads, and a thread that issues its 25 copies stalls until the SM's
//   outstanding requests drain, so h waits for them (PERF.md section 6;
//   scripts/torch_train_decode_phases.py times both). A slice that does
//   not fit goes through a ring of 4 stages (RING), refilled behind two
//   barriers a stage.
// - The product h W2 runs on the tensor cores as three TF32 products
//   (mma.sync m16n8k8; tf32.cuh splits each float32 operand into a
//   rounded TF32 hi and its exact rest lo: a_lo b_hi + a_hi b_lo + a_hi
//   b_hi), 12 mma a step for a warp's 16 x 32 tile. In plain FP32 FMA a
//   4 x 4 register tile reads its operands with 16-byte shared loads at 4
//   wavefronts each, and that bound it (PERF.md section 6). The tensor core
//   truncates each add into its float32 accumulator: the two small
//   products share one, and a_hi b_hi starts from zero every step and is
//   added into a float32 sum, rounded; accumulated over a warp's steps,
//   its bias misses 1e-3 nats a 784-pixel row at logits near 26
//   (tests/test_torch_decoder_kernels.py emulates both schemes).
// - Shared layouts without bank conflicts: h row-major with an odd number
//   of 16-byte words a row (td_hp), so the 8 rows of a fragment load and
//   the h stores (4 consecutive units a thread, from registers) spread
//   over all banks; W2's rows and the partial tiles at 40 words (TD_WS).
// - The epilogue is exact libm (expf, log1pf, a rounded division).
// - One launch, deterministic: each block writes its 16 rows' partial
//   sums, fences, and takes a ticket on its row tile's counter; the last
//   block of the row tile adds the 25 partials of each row in tile order,
//   writes ll and sets the counter back to 0 for the next call or graph
//   replay. gl and this pixel tile's 1/25 share of the row tile's h
//   (td_share; 16-byte stores from shared memory) are stored after the
//   fences, so that none waits for them.
//
// Entry point (plain C, loaded with ctypes):
//   int train_decode_launch(z (B, Z), x (B, D), w1 (Z, H), b1 (H,),
//                           w2 (H, D), b2 (D,), ll (B,), h (B, H),
//                           gl (B, D), part (TdPlan.part floats),
//                           counters (TdPlan.row_tiles ints, zero),
//                           B, Z, H, D, stream)
// Pointers 16-byte aligned. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue when (Z, H, D) has no plan.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tf32.cuh"
#include "train_decode_plan.cuh"

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk c (0 .. 127) of stage s of W2's slice into `dst` (KC rows of
// TD_WS words): 4 pixels of hidden unit s KC + c / 8; units past H and
// pixels past D are zeros.
__device__ __forceinline__ void issue_chunk(float* dst,
                                            const float* __restrict__ w2,
                                            int s, int H, int D, int d0,
                                            int c) {
  const int jj = c / 8, c4 = 4 * (c % 8);
  const int j = s * TD_KC + jj, d = d0 + c4;
  float* out = dst + jj * TD_WS + c4;
  const float* src = w2 + (size_t)j * D + d;
  if (j < H && D % 4 == 0 && d < D) {
    cp_async16(out, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (j < H && d + e < D) cp_async4(out + e, src + e);
    else out[e] = 0.f;
  }
}

// 4 consecutive floats from p (float4 when `vec`), n of them valid
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int n,
                                        bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = c < n ? __ldg(p + c) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// W1 (Z, H) columns 4 j4 .. 4 j4 + 3 of latent dims k0 .. k0 + 7 and, with
// k0 = 0, b1's 4 words (zeros past H or Z, and for j4 past hk4)
__device__ __forceinline__ void w1_batch(const float* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         int j4, int k0, int Z, int H,
                                         bool hvec, int hk4, float4 wk[8],
                                         float4* bk) {
  const int j = 4 * j4, n = j4 < hk4 ? min(4, H - j) : 0;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    wk[q] = n > 0 && k0 + q < Z ? load4(w1 + (size_t)(k0 + q) * H + j, n, hvec)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  if (k0 == 0)
    *bk = n > 0 ? load4(b1 + j, n, hvec) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// --- the product on the tensor cores ----------------------------------------

// d += a b for one m16n8k8 TF32 tile (a: 16 x 8 row-major, b: 8 x 8)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 8-deep step's operands for a lane (g = lane / 4, t = lane % 4): h at
// rows g, g + 8 and units t, t + 4 of the step (hs at the step's first
// unit), W2 at units t, t + 4 and pixel g of each of the 4 8-pixel tiles
// (ws at the step's first unit).
struct Step {
  float a[4], b[8];
};

__device__ __forceinline__ void load_step(Step& st, const float* hs,
                                          const float* ws, int hp, int g,
                                          int t) {
  st.a[0] = hs[g * hp + t];
  st.a[1] = hs[(g + 8) * hp + t];
  st.a[2] = hs[g * hp + t + 4];
  st.a[3] = hs[(g + 8) * hp + t + 4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    st.b[2 * n] = ws[t * TD_WS + 8 * n + g];
    st.b[2 * n + 1] = ws[(t + 4) * TD_WS + 8 * n + g];
  }
}

// small += a_lo b_hi + a_hi b_lo in the tensor core's accumulator, and
// big += a_hi b_hi in float32: the step's product from a zeroed
// accumulator, then a rounded add (see the note at the top)
__device__ __forceinline__ void mma_step(const Step& st, float (&big)[4][4],
                                         float (&small)[4][4]) {
  unsigned ah[4], al[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) tf32_split(st.a[q], ah[q], al[q]);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    unsigned bh0, bl0, bh1, bl1;
    tf32_split(st.b[2 * n], bh0, bl0);
    tf32_split(st.b[2 * n + 1], bh1, bl1);
    mma_tf32(small[n], al, bh0, bh1);
    mma_tf32(small[n], ah, bl0, bl1);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(p, ah, bh0, bh1);
#pragma unroll
    for (int c = 0; c < 4; ++c) big[n][c] += p[c];
  }
}

// --- W2's slice by the Tensor Memory Accelerator (TD_FETCH_TMA) ------------

// one 16-unit x 40-pixel box of W2 at (pixel d0, unit j0) into `dst`; rows
// past H and pixels past D arrive as zeros, and the barrier at `bar`
// counts the box's bytes
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int d0, int j0, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(d0), "r"(j0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_parity0(unsigned bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
}

template <int FETCH>
__global__ void __launch_bounds__(TD_NT)
train_decode_kernel(const __grid_constant__ CUtensorMap w2_map,
                    const float* __restrict__ z, const float* __restrict__ x,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ ll, float* __restrict__ h,
                    float* __restrict__ gl, float* __restrict__ part,
                    unsigned* __restrict__ counters, int B, int Z, int H,
                    int D, int stages, int slots, int hp) {
  extern __shared__ __align__(128) float smem[];
  float* ws = smem;                          // slots x KC x WS (128-aligned)
  float* hs = ws + slots * TD_KC * TD_WS;    // BM x hp, row-major
  float* zs = hs + TD_BM * hp;               // Z x BM
  float* red = zs + Z * TD_BM;               // WARPS x BM x WS
  __shared__ int last;
  __shared__ __align__(8) unsigned long long w2_bar;
  constexpr bool RING = FETCH == TD_FETCH_RING;

  const int pt = blockIdx.x, npt = gridDim.x, rt = blockIdx.y;
  const int d0 = pt * TD_BN, b0 = rt * TD_BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool dvec = D % 4 == 0, hvec = H % 4 == 0;

  // 1. the small loads first, so that they do not queue behind W2's: the
  // epilogue's words (this thread's row er and 4 pixels from ed), its z
  // word and the first batch of W1
  const int er = tid / 8, ed = d0 + 4 * (tid % 8), eb = b0 + er;
  const int en = min(4, D - ed);
  const float4 xv = eb < B && en > 0
                        ? load4(x + (size_t)eb * D + ed, en, dvec)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 bv = en > 0 ? load4(b2 + ed, en, dvec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  const int hk4 = stages * TD_KC / 4;
  float4 wk[8], bk;
  w1_batch(w1, b1, tid, 0, Z, H, hvec, hk4, wk, &bk);
  const float z0 = tid < TD_BM * Z && b0 + tid / Z < B
                       ? z[(size_t)b0 * Z + tid] : 0.f;

  // 2. W2's slice in flight: one thread hands the Tensor Memory
  // Accelerator a box a stage, so no thread stalls issuing copies; or,
  // where D % 4 != 0 and in the ring, every thread's cp.async copies
  const unsigned bar = smem_addr(&w2_bar);
  if (FETCH == TD_FETCH_TMA) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"((unsigned)(stages * TD_KC * TD_WS * sizeof(float)))
          : "memory");
      for (int s = 0; s < stages; ++s)
        tma_box(ws + s * TD_KC * TD_WS, &w2_map, d0, s * TD_KC, bar);
    }
  } else {
    for (int s = 0; s < slots; ++s) {
      issue_chunk(ws + s * TD_KC * TD_WS, w2, s, H, D, d0, tid);
      cp_async_commit();
    }
  }

  // 3. h for the block's rows: thread j4 computes units 4 j4 .. 4 j4 + 3
  // of all 16 rows (units past H are zeros), 8 latent dims a batch of
  // loads (the first one in flight since step 1); step 8 stores it.
  for (int i = tid; i < TD_BM * Z; i += TD_NT) {
    const int r = i / Z, k = i % Z;
    zs[k * TD_BM + r] = i == tid ? z0
                        : b0 + r < B ? z[(size_t)b0 * Z + i] : 0.f;
  }
  __syncthreads();
  for (int j4 = tid; j4 < hk4; j4 += TD_NT) {
    const int j = 4 * j4, n = min(4, H - j);
    float acc[TD_BM][4];
#pragma unroll
    for (int r = 0; r < TD_BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < Z; k0 += 8) {
      if (j4 != tid || k0 != 0)
        w1_batch(w1, b1, j4, k0, Z, H, hvec, hk4, wk, &bk);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (k0 + q >= Z) break;
        const float wc[4] = {wk[q].x, wk[q].y, wk[q].z, wk[q].w};
#pragma unroll
        for (int r4 = 0; r4 < TD_BM; r4 += 4) {
          const float4 zv =
              *reinterpret_cast<const float4*>(&zs[(k0 + q) * TD_BM + r4]);
          const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r4 + e][c] = fmaf(zr[e], wc[c], acc[r4 + e][c]);
        }
      }
    }
    const float bc[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
    for (int r = 0; r < TD_BM; ++r) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = c < n ? fmaxf(acc[r][c] + bc[c], 0.f) : 0.f;
      *reinterpret_cast<float4*>(&hs[r * hp + j]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (FETCH == TD_FETCH_TMA) wait_parity0(bar);
  if (FETCH == TD_FETCH_COPY) cp_async_wait<0>();
  __syncthreads();

  // 4. logits: warp w takes the 8-deep steps k = w, w + 4, ... With every
  // stage resident the next step's operands are read while this one's
  // products run; the ring hands each stage's two steps to two warps.
  const int g = lane / 4, t = lane % 4;
  const int nk = 2 * stages;
  float big[4][4], small[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) big[n][c] = small[n][c] = 0.f;
  if (!RING) {
    Step cur, nxt;
    if (warp < nk)
      load_step(cur, hs + 8 * warp, ws + 8 * warp * TD_WS, hp, g, t);
    for (int k = warp; k < nk; k += TD_WARPS) {
      if (k + TD_WARPS < nk)
        load_step(nxt, hs + 8 * (k + TD_WARPS),
                  ws + 8 * (k + TD_WARPS) * TD_WS, hp, g, t);
      mma_step(cur, big, small);
      cur = nxt;
    }
  } else {
    for (int s = 0; s < stages; ++s) {
      const int slot = s % TD_RING;
      cp_async_wait<TD_RING - 1>();
      __syncthreads();
      if (warp / 2 == (s & 1)) {
        Step st;
        load_step(st, hs + 8 * (2 * s + (warp & 1)),
                  ws + slot * TD_KC * TD_WS + 8 * (warp & 1) * TD_WS, hp, g,
                  t);
        mma_step(st, big, small);
      }
      __syncthreads();
      if (s + TD_RING < stages)
        issue_chunk(ws + slot * TD_KC * TD_WS, w2, s + TD_RING, H, D, d0,
                    tid);
      cp_async_commit();
    }
  }

  // 5. the 4 warps' partial tiles (big + small), added in warp order
  float* mine = red + warp * TD_BM * TD_WS;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(&mine[g * TD_WS + 8 * n + 2 * t]) =
        make_float2(big[n][0] + small[n][0], big[n][1] + small[n][1]);
    *reinterpret_cast<float2*>(&mine[(g + 8) * TD_WS + 8 * n + 2 * t]) =
        make_float2(big[n][2] + small[n][2], big[n][3] + small[n][3]);
  }
  __syncthreads();
  const int eo = er * TD_WS + 4 * (tid % 8);
  float4 lv = *reinterpret_cast<const float4*>(&red[eo]);
#pragma unroll
  for (int w = 1; w < TD_WARPS; ++w) {
    const float4 p =
        *reinterpret_cast<const float4*>(&red[w * TD_BM * TD_WS + eo]);
    lv.x += p.x; lv.y += p.y; lv.z += p.z; lv.w += p.w;
  }

  // 6. epilogue: gl, and the row's sum over this block's pixels
  const float lc[4] = {lv.x + bv.x, lv.y + bv.y, lv.z + bv.z, lv.w + bv.w};
  const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
  float gv[4], sum = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float l = lc[c];
    const float sp = fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
    gv[c] = xc[c] - 1.f / (1.f + expf(-l));
    if (c < en) sum += xc[c] * l - sp;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);

  // 7. one launch: the row tile's last block sums the partials in order
  const int rows = min(TD_BM, B - b0);
  float* tile_part = part + (size_t)rt * npt * TD_BM;
  if (tid % 8 == 0) {
    tile_part[pt * TD_BM + er] = sum;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[rt], 1u) == (unsigned)(npt - 1);
  __syncthreads();
  if (last) {
    __threadfence();
    if (tid < rows) {
      float s = 0.f;
      for (int q = 0; q < npt; ++q) s += __ldcg(&tile_part[q * TD_BM + tid]);
      ll[b0 + tid] = s;
    }
    if (tid == 0) counters[rt] = 0u;
  }

  // 8. the stores no fence waits for: gl, and this pixel tile's share of
  // the row tile's h (contiguous in global memory), from shared memory
  if (eb < B && en > 0) {
    float* dst = gl + (size_t)eb * D + ed;
    if (dvec && en == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(gv[0], gv[1], gv[2], gv[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < en) dst[c] = gv[c];
    }
  }
  int lo, hi;
  td_share(rows, H, npt, pt, &lo, &hi);
  float* ht = h + (size_t)b0 * H;
  if (hvec) {
    for (int e = lo + 4 * tid; e < hi; e += 4 * TD_NT)
      *reinterpret_cast<float4*>(ht + e) =
          *reinterpret_cast<const float4*>(&hs[e / H * hp + e % H]);
  } else {
    for (int e = lo + tid; e < hi; e += TD_NT) ht[e] = hs[e / H * hp + e % H];
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// W2 (H, D) as 16-unit x 40-pixel boxes: the padded rows of the stage
// layout, zeros past H and D. The last map is kept (per host thread) and
// reused while W2's pointer and shape stay: the training step updates its
// weights in place.
static cudaError_t w2_tensor_map(CUtensorMap* map, const float* w2, int H,
                                 int D) {
  static EncodeTiled encode = nullptr;
  static thread_local struct {
    const float* w2;
    int H, D;
    CUtensorMap map;
  } last = {nullptr, 0, 0, {}};
  if (last.w2 == w2 && last.H == H && last.D == D) {
    *map = last.map;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr)
      return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)H};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint32_t box[2] = {TD_WS, TD_KC};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                            (void*)w2, dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  last.w2 = w2;
  last.H = H;
  last.D = D;
  last.map = *map;
  return cudaSuccess;
}

typedef void (*Kernel)(CUtensorMap, const float*, const float*, const float*,
                       const float*, const float*, const float*, float*,
                       float*, float*, float*, unsigned*, int, int, int, int,
                       int, int, int);

// The kernel of a fetch mode with its dynamic shared-memory ceiling at
// least `smem` and its carveout the largest (so that two blocks share an
// SM); the attributes are set when a device first needs them
static cudaError_t kernel_for(int fetch, size_t smem, Kernel* fn) {
  static const Kernel fns[3] = {train_decode_kernel<TD_FETCH_TMA>,
                                train_decode_kernel<TD_FETCH_COPY>,
                                train_decode_kernel<TD_FETCH_RING>};
  static size_t ceiling[3][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *fn = fns[fetch];
  if (dev < 64 && ceiling[fetch][dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ceiling[fetch][dev] = smem;
  return err;
}

extern "C" int train_decode_launch(const float* z, const float* x,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2, float* ll,
                                   float* h, float* gl, float* part,
                                   unsigned* counters, int B, int Z, int H,
                                   int D, void* stream) {
  TdPlan p;
  if (!td_plan(B, Z, H, D, &p)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  CUtensorMap map = {};
  cudaError_t err = cudaSuccess;
  if (p.fetch == TD_FETCH_TMA) err = w2_tensor_map(&map, w2, H, D);
  Kernel fn = nullptr;
  if (err == cudaSuccess) err = kernel_for(p.fetch, p.smem, &fn);
  if (err != cudaSuccess) return (int)err;
  fn<<<dim3(p.pixel_tiles, p.row_tiles), TD_NT, p.smem,
       (cudaStream_t)stream>>>(map, z, x, w1, b1, w2, b2, ll, h, gl, part,
                               counters, B, Z, H, D, p.stages, p.slots, p.hp);
  return (int)cudaGetLastError();
}
