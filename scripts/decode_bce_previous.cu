// Fused MLP decoder + Bernoulli log-likelihood for the IWAE estimator:
//
//   out[s, b] = sum_d x[d, b] * l - softplus(l),
//   l = (relu(z[s, :, b] W1 + b1) W2 + b2)[d]
//
// with zt (S, Z, B), xt (D, B), w1 (Z, H), b1 (H,), w2 (H, D), b2 (D,), all
// float32, and out (S, B) float32.
//
// Replaces the TPU kernel mvae_tpu/kernels/decoder_kernels.py::
// fused_decode_bce_t (_decode_bce_kernel).
//
// Bound: tensor-core operations. The second product, h W2, is 2 S B H D
// operations, run as three TF32 products (3xTF32, below): 3 x 2 S B H D on
// the tensor cores. At the production IWAE chunk (S = 125 samples, B = 512
// examples, H = 400, D = 784) that is 120.4 GFLOP, 0.243 ms at the H100's
// 495 TFLOP/s TF32; the FP32 rest (h = relu(z W1 + b1) at Z = 8, the
// epilogue's ~9 operations and two transcendentals per logit) is a few
// percent of it, and the ~5 MB of inputs are far below either.
//
// Why 3xTF32. An FP32 SIMT kernel is held under the FP32 pipe's 67 TFLOP/s:
// 0.605 ms at that shape, against ~1.0 ms for cuBLAS's two FP32 SGEMMs.
// One TF32 pass (10 mantissa bits an operand) is 0.138 nats per 784-pixel
// row off FP32 (measured on the card), and the TPU kernel's bf16 x 3 split
// keeps ~16 bits, ~2e-3 nats, both over the 1e-3-nat gate. Each float32
// operand is split into a TF32 pair (csrc/tf32.cuh: hi = a rounded to TF32,
// lo = a - hi, exact), and a_lo b_hi + a_hi b_lo + a_hi b_hi keeps
// FP32-grade products at three tensor-core passes: the tensor core reads
// lo's top 19 bits, so each operand keeps ~22 of its 24 bits and the
// dropped lo lo term is ~2^-22 relative.
//
// Why wgmma. Hopper's warpgroup products are the only route to its full
// tensor-core rate; the warp-level mma.sync.m16n8k8 runs at a fraction of
// it, and a 3xTF32 kernel built on it, with the split of every operand in
// registers, stayed slower than the two SGEMMs. wgmma issues a 64 x 56 x 8
// product per instruction and runs it asynchronously.
//
// Accumulation. The tensor core adds each product into its float32
// accumulator with truncation, not round-to-nearest: a bias toward zero of
// up to an ulp of the running sum per product. One accumulator over the
// 150 products of a logit (3 per k-step of 8) is ~2e-3 nats per row off
// f64 in an emulation of that rounding (tests/test_torch_decoder_kernels
// .py), over the gate. So the two small products go into an accumulator of
// their own (2^-11 of the logit: its bias does not show), and the large one
// into a partial that starts from zero each BK-deep stage and is added into
// the logit's float32 sum with a rounded FADD once the stage's products are
// done.
//
// Tiling. A block owns BM = 64 consecutive examples b of one sample s; the
// grid is ceil(B / 64) x S (1,000 blocks at the production chunk). It loads
// its z tile coalesced along b, computes h = relu(z W1 + b1) once with FP32
// FMAs into shared memory, and keeps it there as float32 for the whole D
// walk (64 x (H rounded up to BK, + 4) floats: 107,520 B at H = 400; the
// row stride is 4 mod 32 words, so the ldmatrix loads of the A fragments
// hit 32 banks). The block walks D in BN = 112-wide tiles (784 = 7 x 112:
// no ragged tile at the production width; elsewhere the columns past D are
// zero), and each tile walks H in BK = 32-deep stages of W2. Two
// warpgroups each own a 64 x 56 half of the tile and stage, split and read
// only their own half of W2's columns, so they run apart and synchronise
// with a named barrier of their own. The products read h from registers
// (split there) and W2 from shared memory, where wgmma takes a float32
// operand only K-major: each stage is read from global memory into
// registers two stages ahead (16-byte loads, consecutive threads along a
// row), split, and stored transposed into the wgmma layout (8 x 4 core
// matrices, 128 B apart along k, 1,040 B along n: the 16 B of padding make
// 8 consecutive threads' 16-byte stores hit all 32 banks) of a double
// buffer, while the products of the stage run. A warpgroup waits for a
// stage's products before it reads any accumulator: a read of an
// accumulator on a path where products that write it may still run makes
// ptxas serialise every product (the kernel ran 1.3x slower so). Shared
// memory: 2 x 2 x 14 x 1,040 B of split W2, h, the z tile and the row
// partials: 168,320 B at (Z, H) = (8, 400), one block per SM.
//
// Epilogue, per D tile, in registers: l = sum + small + b2, then
// x l - (max(l, 0) + ln 2 log2(1 + 2^(-|l| log2 e))) on the special
// function unit (ex2 / lg2, ~2^-22 relative; within 1e-6 nats a logit of
// the plain version's softplus), with x read from xt (coalesced along b,
// prefetched into L1 at the tile's first stage; all the tile's b2 and x
// loads are issued before any is used, which took a tenth off the
// kernel's time), into a per-row partial.
// After the D walk each row's partials are summed across the 4 lanes that
// share it (shuffles) and across the 2 warpgroups (shared memory) in a
// fixed order, and stored once. No atomics: the result is deterministic.
//
// Entry point (plain C, loaded with ctypes):
//   int decode_bce_launch(zt (S, Z, B), xt (D, B), w1 (Z, H), b1 (H,),
//                         w2 (H, D), b2 (D,), out (S, B), S, Z, B, H, D,
//                         stream)
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// when H and Z need more shared memory than a block can have.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

// Must match decoder_kernels.py (_DEC_BM, _DEC_BN, _DEC_BK, _DEC_WG,
// _SMEM_LIMIT).
#define BM 64
#define BN 112
#define BK 32
#define NWG 2                    // warpgroups, each a 64 x 56 half tile
#define NT (128 * NWG)
#define WGN (BN / NWG)
#define NACC (WGN / 2)           // accumulator floats a thread holds
#define NQ (WGN / 4)             // 4-column quads of a warpgroup's half
#define SBO_W (8 * BK + 4)       // words between 8-row groups along n
#define WSPLIT (WGN / 8 * SBO_W) // words of one warpgroup's split half
#define KSTEPS (BK / 8)
#define NBUF 2                   // stages of split W2 in shared memory
#define SMEM_LIMIT 232448

__host__ __device__ static inline int padded_h(int H) {
  return (H + BK - 1) / BK * BK;
}

static size_t smem_bytes(int Z, int H) {
  return sizeof(float) * ((size_t)NBUF * NWG * 2 * WSPLIT +
                          (size_t)BM * (padded_h(H) + 4) + (size_t)Z * BM +
                          NWG * BM);
}

// d (+)= a b^T for one m64n56k8 TF32 product of a warpgroup: a from registers
// (the m16n8k8 A fragment of each warp's 16 rows), b from shared memory
// through its descriptor; scale_d = 0 writes a b^T over d
__device__ __forceinline__ void wgmma_tf32(float (&d)[NACC],
                                           const unsigned (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// keeps the compiler from moving reads or writes of v across the
// asynchronous products that own it
__device__ __forceinline__ void fence_operand(float (&v)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

// the wgmma descriptor of a K-major float32 operand without swizzle: core
// matrices of 8 rows x 16 B, 128 B apart along k and 4 SBO_W bytes along n
__device__ __forceinline__ uint64_t bdesc(const float* p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(4 * SBO_W >> 4) << 32);
}

// this warpgroup's half of W2 stage (k0, d0) into registers: thread q < 8 NQ
// of the warpgroup reads rows k = 4 (q / NQ) .. + 3 of the stage, columns
// 4 (q % NQ) .. + 3 of the half (consecutive threads along a row). Zero
// past H and D.
template <bool VEC>
__device__ __forceinline__ void load_stage(float4 (&v)[4],
                                           const float* __restrict__ w2,
                                           int k0, int d0, int H, int D,
                                           int q) {
  const int d = d0 + 4 * (q % NQ);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + 4 * (q / NQ) + r;
    const float* src = w2 + (size_t)k * D + d;
    if (VEC) {
      v[r] = (k < H && d < D) ? __ldg(reinterpret_cast<const float4*>(src))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool row = k < H;
      v[r].x = row && d < D ? __ldg(src) : 0.f;
      v[r].y = row && d + 1 < D ? __ldg(src + 1) : 0.f;
      v[r].z = row && d + 2 < D ? __ldg(src + 2) : 0.f;
      v[r].w = row && d + 3 < D ? __ldg(src + 3) : 0.f;
    }
  }
}

// the registers' stage, split, into the wgmma layout, where (n, k) is at
// (n / 8) SBO_W + (k / 4) 32 + (n % 8) 4 + k % 4 words: column n = 4 (q % NQ)
// + j of the thread's 4 rows is one 16 B row of a core matrix, and 8
// consecutive threads of a row store 128 B over all 32 banks (SBO_W is 4
// mod 32)
__device__ __forceinline__ void store_stage(float* hi, float* lo,
                                            const float4 (&v)[4], int q) {
  const int nq = q % NQ;
  const int base = (nq >> 1) * SBO_W + (q / NQ) * 32 + 16 * (nq & 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned h[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float w = j == 0 ? v[r].x : j == 1 ? v[r].y : j == 2 ? v[r].z
                                                                 : v[r].w;
      tf32_split(w, h[r], l[r]);
    }
    *reinterpret_cast<uint4*>(hi + base + 4 * j) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + base + 4 * j) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// the A fragments of k-steps kt BK .. + BK of this warp's 16 rows of h,
// split: ldmatrix gives word (lane / 4, lane % 4) of each 8 x 4 block
__device__ __forceinline__ void load_a(unsigned (&ah)[KSTEPS][4],
                                       unsigned (&al)[KSTEPS][4],
                                       const float* arow) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    unsigned r[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"((unsigned)__cvta_generic_to_shared(arow + 8 * ks)));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tf32_split(__uint_as_float(r[q]), ah[ks][q], al[ks][q]);
  }
}

// the 128 threads of warpgroup wg wait for each other (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
decode_bce_kernel(const float* __restrict__ zt, const float* __restrict__ xt,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ out, int Z, int B, int H, int D) {
  extern __shared__ __align__(1024) float smem[];
  const int Hp = padded_h(H), LDH = Hp + 4;
  float* bs = smem;                        // [buffer][warpgroup][hi, lo]
  float* hs = bs + NBUF * NWG * 2 * WSPLIT;  // BM x LDH hidden activations
  float* zs = hs + BM * LDH;               // Z x BM latent tile
  float* red = zs + Z * BM;                // NWG x BM row partials

  const int s = blockIdx.y;
  const int b0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp within it
  const int q = tid & 127;                   // thread within the warpgroup
  const bool loader = q < 8 * NQ;            // a W2 quad of each stage
  const int nK = Hp / BK, nD = (D + BN - 1) / BN, T = nK * nD;
  // this warpgroup's split half of buffer i
  auto half = [&](int i) { return bs + (i * NWG + wg) * 2 * WSPLIT; };

  // Each warpgroup stages, splits and reads only its own half of W2's
  // columns, so the two run apart, with a barrier of their own: stage 0
  // split into buffer 0, stage 1 in registers, while h is made.
  float4 pre[4];                           // a stage of W2, raw
  if (loader) {
    load_stage<VEC>(pre, w2, 0, wg * WGN, H, D, q);
    store_stage(half(0), half(0) + WSPLIT, pre, q);
    if (T > 1)
      load_stage<VEC>(pre, w2, (1 % nK) * BK, (1 / nK) * BN + wg * WGN, H,
                      D, q);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  for (int i = tid; i < Z * BM; i += NT) {
    const int k = i / BM, m = i % BM, b = b0 + m;
    zs[i] = b < B ? zt[((size_t)s * Z + k) * B + b] : 0.f;
  }
  __syncthreads();
  // h = relu(z W1 + b1) on the FP32 pipe: warp w fills rows w, w + 8, ...,
  // lanes walk the hidden units, columns H .. Hp stay zero. z is taken 8
  // latent dimensions at a time into registers (pre-activations of a wider
  // z accumulate in hs between the chunks).
  constexpr int NWARPS = NT / 32;
  for (int c = 0; c < Z; c += 8) {
    const bool last = c + 8 >= Z;
    float zr[8][BM / NWARPS];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int r = 0; r < BM / NWARPS; ++r)
        zr[k][r] = c + k < Z ? zs[(c + k) * BM + warp + NWARPS * r] : 0.f;
    for (int j = lane; j < Hp; j += 32) {
      const bool live = j < H;
      float wv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        wv[k] = live && c + k < Z ? w1[(size_t)(c + k) * H + j] : 0.f;
      const float bias = live ? b1[j] : 0.f;
#pragma unroll
      for (int r = 0; r < BM / NWARPS; ++r) {
        float* hp = hs + (warp + NWARPS * r) * LDH + j;
        float v = c == 0 ? 0.f : *hp;
#pragma unroll
        for (int k = 0; k < 8; ++k) v = fmaf(zr[k][r], wv[k], v);
        *hp = !last ? v : live ? fmaxf(v + bias, 0.f) : 0.f;
      }
    }
  }
  __syncthreads();

  // sum: the logits' float32 sums; small: the two small products; part:
  // the large product of one stage, from zero, added into sum once the
  // stage's products are done
  float sum[NACC], small[NACC], part[NACC];
  float rows[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NACC; ++i) sum[i] = small[i] = part[i] = 0.f;
  // this lane's ldmatrix row: rows 16 wq + (lane & 7) (+ 8 for the second
  // and fourth 8 x 4 block), columns + 4 for the third and fourth
  const float* arow = hs + (16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                               LDH + 4 * (lane >> 4);
  // the A fragments of the even / odd stages
  unsigned ah0[KSTEPS][4], al0[KSTEPS][4], ah1[KSTEPS][4], al1[KSTEPS][4];
  load_a(ah0, al0, arow);

  // One stage: its products are issued and left running while the
  // warpgroup splits stage it + 1 into the other buffer (which stage it - 1
  // read: every warp of the warpgroup waited for those products before the
  // last barrier), reads stage it + 2 into registers and loads the A
  // fragments of stage it + 1 into the other set. Then it waits for the
  // products and adds the stage's partial into sum; at a D tile's last
  // stage it runs the tile's epilogue. No accumulator is read while
  // products that write it may run (ptxas would serialise every product);
  // the other warpgroup's products keep the tensor cores busy meanwhile.
  auto stage = [&](int it, unsigned(&ah)[KSTEPS][4],
                   unsigned(&al)[KSTEPS][4], unsigned(&nh)[KSTEPS][4],
                   unsigned(&nl)[KSTEPS][4]) {
    const int kt = it % nK, d0 = (it / nK) * BN + wg * WGN;
    // the descriptors of k-step ks: the two core matrices at 64 ks words
    // along k. Every register the products read is made before the fence
    // (a register written between two products makes ptxas fence them).
    const float* bh = half(it % NBUF);
    uint64_t dh[KSTEPS], dl[KSTEPS];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      dh[ks] = bdesc(bh + 64 * ks);
      dl[ks] = bdesc(bh + WSPLIT + 64 * ks);
      asm volatile("" : "+l"(dh[ks]), "+l"(dl[ks]));
    }
    const int first = kt > 0;
    fence_operand(small);
    fence_operand(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      wgmma_tf32(small, al[ks], dh[ks], ks > 0 ? 1 : first);
      wgmma_tf32(small, ah[ks], dl[ks], 1);
      wgmma_tf32(part, ah[ks], dh[ks], ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt == 0 && q < 2 * WGN) {  // the tile's targets into L1 meanwhile
      const int d = d0 + (q >> 1);
      if (d < D)
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(
            xt + (size_t)d * B + b0 + 32 * (q & 1)));
    }
    if (loader) {
      if (it + 1 < T) {
        float* nb = half((it + 1) % NBUF);
        store_stage(nb, nb + WSPLIT, pre, q);
      }
      if (it + 2 < T)
        load_stage<VEC>(pre, w2, ((it + 2) % nK) * BK,
                        ((it + 2) / nK) * BN + wg * WGN, H, D, q);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    load_a(nh, nl, arow + ((it + 1) % nK) * BK);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        asm volatile("" : "+r"(nh[ks][c]), "+r"(nl[ks][c]));
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operand(small);
    fence_operand(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] += part[i];
    if (kt == nK - 1) {            // the D tile is summed: its epilogue
      // the tile's biases and targets first, all loads in flight at once
      // (at clamped addresses; the entries past D or B add nothing)
      float bv[NACC], xv[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int m = min(b0 + 16 * wq + g + 8 * ((i >> 1) & 1), B - 1);
        const int d = min(d0 + 8 * (i >> 2) + 2 * t + (i & 1), D - 1);
        bv[i] = __ldg(b2 + d);
        xv[i] = __ldg(xt + (size_t)d * B + m);
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int m = 16 * wq + g + 8 * ((i >> 1) & 1);
        const int d = d0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const float l = sum[i] + small[i] + bv[i];
        float e, lg;
        asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e)
            : "f"(-fabsf(l) * 1.4426950408889634f));
        asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.f + e));
        const float sp = fmaxf(l, 0.f) + 0.6931471805599453f * lg;
        rows[(i >> 1) & 1] += d < D && b0 + m < B ? xv[i] * l - sp : 0.f;
        sum[i] = 0.f;
      }
    }
    wg_sync(wg);                   // this half of the next buffer is whole
  };

  for (int it = 0; it < T; it += 2) {
    stage(it, ah0, al0, ah1, al1);
    if (it + 1 < T) stage(it + 1, ah1, al1, ah0, al0);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = rows[hf];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[wg * BM + 16 * wq + 8 * hf + g] = v;
  }
  __syncthreads();
  if (tid < BM && b0 + tid < B) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NWG; ++w) tot += red[w * BM + tid];
    out[(size_t)s * B + b0 + tid] = tot;
  }
}

extern "C" int decode_bce_launch(const float* zt, const float* xt,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 int S, int Z, int B, int H, int D,
                                 void* stream) {
  const size_t smem = smem_bytes(Z, H);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (S == 0 || B == 0) return (int)cudaGetLastError();
  const bool vec = D % 4 == 0 && ((uintptr_t)w2 & 15) == 0;
  void (*kernel)(const float*, const float*, const float*, const float*,
                 const float*, const float*, float*, int, int, int, int) =
      vec ? decode_bce_kernel<true> : decode_bce_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BM - 1) / BM, S);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(zt, xt, w1, b1, w2, b2,
                                                   out, Z, B, H, D);
  return (int)cudaGetLastError();
}
