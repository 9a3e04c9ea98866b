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
// 495 TFLOP/s TF32; the first product (made here on the tensor cores too,
// 2% of the second at Z = 8), the epilogue's ~9 operations and two
// transcendentals per logit and the ~5 MB of inputs are far below it.
//
// Why 3xTF32. An FP32 SIMT kernel is held under the FP32 pipe's 67 TFLOP/s:
// 0.605 ms at that shape, against ~1.0 ms for cuBLAS's two FP32 SGEMMs.
// One TF32 pass (10 mantissa bits an operand) is 0.138 nats per 784-pixel
// row off FP32 (measured on the card), over the 1e-3-nat gate. Each
// float32 operand is split into a TF32 pair (csrc/tf32.cuh: hi = a rounded
// to TF32, lo = a - hi, exact), and a_lo b_hi + a_hi b_lo + a_hi b_hi
// keeps FP32-grade products at three tensor-core passes: the tensor core
// reads lo's top 19 bits, so each operand keeps ~22 of its 24 bits and the
// dropped lo lo term is ~2^-22 relative.
//
// Accumulation. The tensor core adds each product into its float32
// accumulator with truncation, not round-to-nearest: a bias toward zero of
// up to an ulp of the running sum per product. One accumulator over the
// 150 products of a logit (3 per k-step of 8) is ~2e-3 nats per row off
// f64 in an emulation of that rounding (tests/test_torch_decoder_kernels
// .py), over the gate. So the two small products go into an accumulator of
// their own (2^-11 of the logit: its bias does not show), and the large one
// into a partial that starts from zero each BK = 32-deep stage and is added
// into the logit's float32 sum with a rounded FADD once the stage's
// products are done.
//
// What bounds a wgmma kernel here is shared memory, not the tensor cores.
// wgmma takes a float32 B operand only from shared memory, K-major, and
// every m64 product reads 64 B of it a clock at the full TF32 rate, half
// of the 128 B a clock the SM's shared memory moves. The previous design
// (scripts/decode_bce_previous.cu: 64 examples a block, W2 loaded, split
// and stored transposed by the same threads that multiply, h read back
// with ldmatrix every D tile) asked ~150 B a clock of it and ran at a
// third of the tensor rate. This one asks ~90:
//
// 1. W2 split once a launch. A first small launch (w_image_kernel) writes
//    every (D tile, hidden stage) of W2 as the exact shared-memory image
//    of its hi and lo tiles (wgmma's K-major core matrices: 8 columns x 4
//    hidden units, 128 B apart along k and 1,024 B along n, zeros past H
//    and D), with the stage's b1 and its W1 slice, split alike, behind it:
//    30,848 B a stage at Z <= 8, 2.8 MB at H = 400, D = 784, read back from
//    L2. No thread of the main kernel loads, splits or stores W2.
// 2. The copy engine and a ring. Each stage image reaches shared memory by
//    one bulk copy (cp.async.bulk) into a ring of up to 4 slots, each with
//    a full mbarrier; thread 0 issues the first ones, and the last of the
//    8 warps done with a stage (a count a slot in shared memory) issues
//    the slot's next one at once. No thread loads, splits or stores W2:
//    the warps only multiply and run the epilogue. There is no producer
//    warp:
//    with 8 warps, 2 on each of the SM's four 16K-register quarters, a
//    thread may hold 255 registers; a ninth warp puts 3 on one quarter and
//    caps every thread at 168, and setmaxnreg did not lift that cap for
//    the multiplying warps in ptxas's allocation (it spilled 470-780
//    bytes and serialised the products, in a first build of this design).
// 3. 128 examples share a staged byte. A block owns 128 consecutive rows
//    of the flattened (S B) row space (the samples' rows back to back, so a
//    ragged B wastes rows only at the end), each of its two consumer
//    warpgroups 64 rows and the whole 112-wide D tile (m64n112: three
//    56-float accumulators a thread, 168 registers), so a staged stage
//    serves 128 rows where the previous design's served 64.
// 4. h without a resident copy. h for 128 rows (213 KB at H = 400) cannot
//    sit beside the ring, so each warpgroup makes its 64 rows of h again
//    for every D tile, on the tensor cores: z's TF32 pair from registers
//    times the stage's W1 slice (3xTF32, m64n16k8 a half stage, from zero,
//    a k-step of 8 latent dimensions at a time), + b1, ReLU, split. The
//    accumulator of that product holds, in each thread, h at columns 2t
//    and 2t + 1 of every 8; an A fragment of the second product wants
//    columns t and t + 4. So the image permutes each k-step's 8 hidden
//    units (position u holds unit 2u for u < 4, 2(u - 4) + 1 after), and
//    the accumulator's registers are the A fragments as they are: no
//    shuffle and no shared-memory round trip of h.
//
// A warpgroup runs its stages in order, each in two halves of 16 hidden
// units, so that beside the 168 accumulator registers only one half's h
// block (8) and A fragments (16) hold registers (250 of 255 in all): the
// A fragments of half 0; the half's 6 products and h of half 1 behind
// them, wait; the next stage's slot waited for; the A fragments of half 1;
// the other 6 products and h of the next stage's half 0 behind them, wait;
// the slot released; the partial added into the sum. The other
// warpgroup's products keep the tensor cores busy meanwhile. No
// accumulator is read while products that write it may run, and no
// product is issued on a branch (ptxas would serialise every product).
//
// Epilogue, per D tile, in registers: l = sum + small + b2, then
// x l - (max(l, 0) + ln 2 log2(1 + 2^(-|l| log2 e))) on the special
// function unit (ex2 / lg2, ~2^-22 relative; within 1e-6 nats a logit of
// the plain version's softplus), with x read from xt (prefetched into L1
// two stages before the tile's last; the loads of the next pair of column
// groups issued before the current pair is used), into a per-row partial.
// After the D walk each row's partials are summed across the 4 lanes that
// share it (shuffles) and stored once. No atomics: the result is
// deterministic.
//
// Entry points (plain C, loaded with ctypes):
//   int decode_bce_launch(zt (S, Z, B), xt (D, B), w1 (Z, H), b1 (H,),
//                         w2 (H, D), b2 (D,), out (S, B), img, S, Z, B, H,
//                         D, stream)
//   int decode_image_launch(w1, b1, w2, img, Z, H, D, stream)
// img: decode_image_bytes(Z, H, D) of scratch, 16-byte aligned;
// decode_bce_launch writes it (the image launch) and then reads it (the
// main launch). Each returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue when a stage of Z does not fit a block's shared
// memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

// Must match decoder_kernels.py (_DEC_BN, _DEC_BK, _DEC_ZK, _DEC_SLOTS,
// _DEC_BAR_BYTES, _SMEM_LIMIT).
#define BM 128                   // rows a block: 2 warpgroups x 64
#define BN 112                   // D tile: one m64n112 product a k-step
#define BK 32                    // hidden units a stage
#define ZK 8                     // latent dimensions a k-step of h
#define NCW 2                    // consumer warpgroups
#define NT (128 * NCW)
#define NACC (BN / 2)            // accumulator floats a thread, a product
#define HALF (BK / 4)            // the h product's accumulator floats
#define MAX_SLOTS 4
#define SMEM_LIMIT 232448

// A stage image, in 32-bit words: W2's hi tile, its lo tile, b1, then the
// W1 slice of each ZK-wide chunk of z (hi tile, lo tile).
#define W2_WORDS (BN * BK)       // 3,584: (n, u) at W2_AT(n, u)
#define B1_WORD (2 * W2_WORDS)
#define W1_WORD (B1_WORD + BK)
#define W1_WORDS (BK * ZK)       // 256: (n, q) at W1_AT(n, q)
#define CORE_AT(n, k, depth) \
  (((n) >> 3) * (8 * (depth)) + ((k) >> 2) * 32 + ((n) & 7) * 4 + ((k) & 3))
#define W2_AT(n, u) CORE_AT(n, u, BK)
#define W1_AT(n, q) CORE_AT(n, q, ZK)
#define BAR_BYTES (2 * MAX_SLOTS * 8)

__host__ __device__ static inline int stage_words(int zc) {
  return W1_WORD + 2 * W1_WORDS * zc;
}

// ring slots for a stage of `zc` z chunks: as many as fit, up to 4 (0: none)
static int ring_slots(int zc) {
  const long stage = 4L * stage_words(zc);
  const long n = (SMEM_LIMIT - BAR_BYTES) / stage;
  return n > MAX_SLOTS ? MAX_SLOTS : (int)n;
}

// the hidden unit at position u of a stage's k-steps (u < 32): each
// k-step's 8 positions hold its units 0, 2, 4, 6, 1, 3, 5, 7
__host__ __device__ static inline int stage_unit(int u) {
  const int v = u & 7;
  return (u & ~7) + (v < 4 ? 2 * v : 2 * v - 7);
}

// --- the image launch ------------------------------------------------------

// Block (it, y), it = dt nK + kt, writes its part of stage (D tile dt,
// hidden stage kt): thread e of part y takes column n = e % BN and the 4
// positions 4 u4 .. + 3 (u4 = e / BN) of the stage's 32, reads their 4 W2
// words (consecutive threads along d: coalesced) and stores each half of
// the split as one 16-byte core-matrix row; part 0 also writes b1 and the
// W1 chunks. IMAGE_PARTS x IMAGE_NT threads cover the stage's BN x 8 rows.
#define IMAGE_NT 128
#define IMAGE_PARTS (BN * BK / 4 / IMAGE_NT)
__global__ void __launch_bounds__(IMAGE_NT)
w_image_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, unsigned* __restrict__ img,
               int Z, int H, int D, int nK, int zc) {
  const int it = blockIdx.x, dt = it / nK, kt = it % nK;
  unsigned* st = img + (size_t)it * stage_words(zc);
  const int e = blockIdx.y * IMAGE_NT + threadIdx.x;
  const int n = e % BN, u4 = e / BN, d = dt * BN + n;
  unsigned hi[4], lo[4];
  for (int i = 0; i < 4; ++i) {
    const int k = kt * BK + stage_unit(4 * u4 + i);
    tf32_split(k < H && d < D ? __ldg(w2 + (size_t)k * D + d) : 0.f, hi[i],
               lo[i]);
  }
  *reinterpret_cast<uint4*>(st + W2_AT(n, 4 * u4)) =
      make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(st + W2_WORDS + W2_AT(n, 4 * u4)) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
  if (blockIdx.y != 0) return;
  if (threadIdx.x < BK) {
    const int k = kt * BK + threadIdx.x;
    st[B1_WORD + threadIdx.x] = __float_as_uint(k < H ? __ldg(b1 + k) : 0.f);
  }
  for (int f = threadIdx.x; f < zc * ZK * BK; f += IMAGE_NT) {
    const int c = f / (ZK * BK), q = f / BK % ZK, m = f % BK;
    const int z = c * ZK + q, k = kt * BK + m;
    unsigned wh, wl;
    tf32_split(z < Z && k < H ? __ldg(w1 + (size_t)z * H + k) : 0.f, wh, wl);
    unsigned* w = st + W1_WORD + 2 * W1_WORDS * c;
    w[W1_AT(m, q)] = wh;
    w[W1_WORDS + W1_AT(m, q)] = wl;
  }
}

// --- the main launch -------------------------------------------------------

// d (+)= a b^T for one m64n16k8 TF32 product of a warpgroup: a from
// registers (the m16n8k8 A fragment of each warp's 16 rows), b from shared
// memory through its descriptor; scale_d = 0 writes a b^T over d. The
// _set forms write d = a b^T and do not read d, so that d holds no
// register before its first product (a stage's partial, the h block).
__device__ __forceinline__ void wgmma_n16(float (&d)[HALF],
    const unsigned (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n16_set(float (&d)[HALF],
    const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

__device__ __forceinline__ void wgmma_n112(float (&d)[NACC],
    const unsigned (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n112_set(float (&d)[NACC],
    const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}


// keeps the compiler from moving reads or writes of v across the
// asynchronous products that own it
template <int N>
__device__ __forceinline__ void fence_operand(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the wgmma descriptor of a K-major float32 operand without swizzle at
// shared address `a`: core matrices of 8 rows x 16 B, 128 B apart along k
// and `sbo` bytes along n
__device__ __forceinline__ uint64_t bdesc(unsigned a, unsigned sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the phase of parity `parity` of the barrier at `bar` to
// complete; traps after ~2^32 clocks (~2 s) rather than hang the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// hands stage `it` (its image of `sbytes`) to the copy engine: one bulk
// copy into ring slot it % slots, counted on the slot's full barrier
__device__ __forceinline__ void load_stage(unsigned ring, unsigned full,
                                           unsigned sbytes,
                                           const unsigned* img, int it,
                                           int slots) {
  const int s = it % slots;
  const unsigned bar = full + 8 * s;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(sbytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(ring + s * sbytes),
      "l"(img + (size_t)it * (sbytes / 4)), "r"(sbytes), "r"(bar)
      : "memory");
}

// z[row][c ZK + t] and [.. + t + 4] of this thread's two rows (pa, pb: the
// rows' first z entry in zt, B apart along z), split: the A fragment of the
// h product's k-step c
__device__ __forceinline__ void z_frags(unsigned (&zh)[4], unsigned (&zl)[4],
                                        const float* pa, const float* pb,
                                        int c, int t, int Z, int B) {
  const int k0 = c * ZK + t, k1 = k0 + 4;
  const float v[4] = {
      k0 < Z ? __ldg(pa + (size_t)k0 * B) : 0.f,
      k0 < Z ? __ldg(pb + (size_t)k0 * B) : 0.f,
      k1 < Z ? __ldg(pa + (size_t)k1 * B) : 0.f,
      k1 < Z ? __ldg(pb + (size_t)k1 * B) : 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(v[i], zh[i], zl[i]);
}

// ONE: Z <= ZK, z's fragments made once; else again every stage, a chunk
// of ZK latent dimensions at a time
template <bool ONE>
__global__ void __launch_bounds__(NT, 1)
decode_bce_kernel(const float* __restrict__ zt, const float* __restrict__ xt,
                  const float* __restrict__ b2,
                  const unsigned* __restrict__ img, float* __restrict__ out,
                  int Z, int B, int R, int D, int nK, int nD, int zc,
                  int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbytes = 4 * stage_words(zc);
  const unsigned ring = (unsigned)__cvta_generic_to_shared(smem);
  // a full barrier a slot, then a count of the warps done with it a slot
  const unsigned full = ring + slots * sbytes, done = full + 8 * MAX_SLOTS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int T = nK * nD;

  // thread 0 inits the barriers and hands the first stages to the copy
  // engine; the last warp done with a stage refills its slot (below)
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(full +
                                                                    8 * i));
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(done + 4 * i)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < slots && i < T; ++i)
      load_stage(ring, full, sbytes, img, i, slots);
  }
  __syncthreads();
  const int q = tid & 127, lane = tid & 31, wq = q >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the flattened (S B) row space: ra (fragment row
  // g) and rb = ra + 8; rows past R are computed on row R - 1 and dropped
  const int r0 = blockIdx.x * BM + 64 * wg;
  const int ra = r0 + 16 * wq + g, rb = ra + 8;
  const bool va = ra < R, vb = rb < R;
  const int ca = min(ra, R - 1), cb = min(rb, R - 1);
  const int ia = ca / B, ba = ca - ia * B, ib = cb / B, bb = cb - ib * B;
  const float* za = zt + (size_t)ia * Z * B + ba;
  const float* zb = zt + (size_t)ib * Z * B + bb;

  unsigned zh[4], zl[4];
  if (ONE) z_frags(zh, zl, za, zb, 0, t, Z, B);

  // sum: the logits' float32 sums; small: the two small products; part:
  // the large product of one stage, from zero, added into sum once the
  // stage's products are done; hacc: the stage's block of h
  float sum[NACC], small[NACC], part[NACC], hacc[HALF];
  unsigned ah[2][4], al[2][4];  // a half stage's A fragments
  float rows[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NACC; ++i) small[i] = 0.f;
  // the tile's targets go into L1 two stages before its epilogue
  const int pf = nK > 2 ? nK - 2 : 0;

  // waits for stage `it`; returns its shared address
  auto acquire = [&](int it) {
    mbar_wait(full + 8 * (it % slots), (it / slots) & 1);
    return ring + (it % slots) * sbytes;
  };
  // issues half hh of the 64 x 32 block of h of the stage at `st`: z W1
  // from zero on the tensor cores (the W1 tile's columns 16 hh .. + 15: two
  // core matrices along n, 512 bytes on). At Z <= ZK its three products go
  // into hacc. Past that, ZK latent dimensions a k-step, the second
  // product's scheme: each k-step's large product from zero, added into
  // hacc with a rounded add once done, and the small ones apart (one
  // accumulator over the 3 products of 50 k-steps at Z = 400 is 1.1e-3
  // nats a row off, measured); those k-steps wait for their products.
  auto h_block = [&](unsigned st, int hh) {
    const unsigned w1s = st + 4 * W1_WORD + 512 * hh;
    if (ONE) {
      const uint64_t wh = bdesc(w1s, 8 * 32);
      const uint64_t wl = bdesc(w1s + 4 * W1_WORDS, 8 * 32);
      wgmma_fence();
      wgmma_n16_set(hacc, zh, wh);
      wgmma_n16(hacc, zl, wh, 1);
      wgmma_n16(hacc, zh, wl, 1);
    } else {
      float big[HALF], sm[HALF];
      for (int c = 0; c < zc; ++c) {
        z_frags(zh, zl, za, zb, c, t, Z, B);
        const uint64_t wh = bdesc(w1s + 8 * W1_WORDS * c, 8 * 32);
        const uint64_t wl = bdesc(w1s + 8 * W1_WORDS * c + 4 * W1_WORDS,
                                  8 * 32);
        wgmma_fence();
        wgmma_n16_set(big, zh, wh);
        if (c == 0)
          wgmma_n16_set(sm, zl, wh);
        else
          wgmma_n16(sm, zl, wh, 1);
        wgmma_n16(sm, zh, wl, 1);
        wgmma_commit_wait();
        fence_operand(big);
        fence_operand(sm);
#pragma unroll
        for (int i = 0; i < HALF; ++i) hacc[i] = c ? hacc[i] + big[i] : big[i];
      }
#pragma unroll
      for (int i = 0; i < HALF; ++i) hacc[i] += sm[i];
    }
  };

  // Each stage in two halves of 16 hidden units (k-steps 2hh, 2hh + 1), so
  // that only one half's h block and A fragments hold registers: the A
  // fragments of half 0 (its h made behind the stage before); the half's 6
  // products with h of half 1 behind them, wait; its A fragments; the other
  // 6 products with h of the next stage's half 0 behind them, wait. part
  // starts from zero at the stage's first product. No product is issued
  // on a branch (ptxas would serialise them all): the last stage makes h of
  // its own half 0 again, unused. With a ring of one slot (Z > 336 only)
  // the next stage cannot arrive before this one is released: h of its
  // half 0 is then made at its start.
  const bool ahead = ONE || slots > 1;
  unsigned st = acquire(0);
  h_block(st, 0);
  wgmma_commit_wait();
  fence_operand(hacc);
  int it = 0;
  for (int dt = 0; dt < nD; ++dt) {
    const int d0 = dt * BN;
#pragma unroll
    for (int i = 0; i < NACC; ++i) sum[i] = 0.f;
    for (int kt = 0; kt < nK; ++kt, ++it) {
      if (!ahead && it > 0) {
        st = acquire(it);
        h_block(st, 0);
        wgmma_commit_wait();
        fence_operand(hacc);
      }
      const float* sg = reinterpret_cast<const float*>(smem + (st - ring));
      unsigned next = st;  // the next stage's shared address
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // no branch that threads may take apart between the products of a
        // group (ptxas would serialise them): the next stage is waited for
        // and the targets prefetched before the second half's products
        if (hh == 1) {
          if (ahead) next = acquire(it + 1 < T ? it + 1 : it);
          if (kt == pf) {
            // 8 lines of 16 rows a column of the tile, 896 prefetches
            for (int p = tid; p < 8 * BN; p += 128 * NCW) {
              const int d = d0 + p / 8;
              const int r = min(blockIdx.x * BM + 16 * (p % 8), R - 1);
              if (d < D)
                asm volatile("prefetch.global.L1 [%0];\n" ::"l"(
                    xt + (size_t)d * B + r % B));
            }
          }
        }
        // + b1, ReLU, split: register 4j + e of hacc is h at row g + 8
        // (e >> 1) and column 8j + 2t + (e & 1) of the half, which the
        // image put at position t (e & 1 == 0) or t + 4 of k-step
        // 2hh + j: the A fragment's order is e = 0, 2, 1, 3
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 bias = *reinterpret_cast<const float2*>(
              sg + B1_WORD + 16 * hh + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = fmaxf(
                hacc[4 * j + e] + (e & 1 ? bias.y : bias.x), 0.f);
            const int f = (e >> 1) | ((e & 1) << 1);
            tf32_split(v, ah[j][f], al[j][f]);
          }
        }
        // the half's products; the descriptors of k-step ks: the two core
        // matrices at 64 ks words along k
        fence_operand(small);
        if (hh) fence_operand(part);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ks = 2 * hh + j;
          const uint64_t dh = bdesc(st + 4 * 64 * ks, 8 * 128);
          const uint64_t dl = bdesc(st + 4 * (W2_WORDS + 64 * ks), 8 * 128);
          wgmma_n112(small, al[j], dh, ks > 0 ? 1 : kt > 0);
          wgmma_n112(small, ah[j], dl, 1);
          if (ks == 0)
            wgmma_n112_set(part, ah[j], dh);
          else
            wgmma_n112(part, ah[j], dh, 1);
        }
        if (hh == 0)
          h_block(st, 1);
        else if (ahead)
          h_block(next, 0);
        wgmma_commit_wait();
        fence_operand(small);
        fence_operand(part);
        fence_operand(hacc);
      }
      // the warp is done with the stage; the last of the 8 to be done
      // hands the slot's next stage to the copy engine at once
      __syncwarp();
      if (lane == 0) {
        unsigned before;
        asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                     : "=r"(before)
                     : "r"(done + 4 * (it % slots))
                     : "memory");
        if (before % (4 * NCW) == 4 * NCW - 1 && it + slots < T) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          load_stage(ring, full, sbytes, img, it + slots, slots);
        }
      }
      st = next;
#pragma unroll
      for (int i = 0; i < NACC; ++i) sum[i] += part[i];
    }

    // the tile's epilogue: register i is row g + 8 ((i >> 1) & 1), column
    // d0 + 8 (i >> 2) + 2t + (i & 1); a pair of column groups at a time,
    // the next pair's biases and targets in flight (at clamped addresses;
    // the entries past D or R add nothing)
    float bv[2][4], xv[2][8];
    auto load = [&](int p, float(&bq)[4], float(&xq)[8]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = min(d0 + 16 * p + 8 * (c >> 1) + 2 * t + (c & 1),
                          D - 1);
        bq[c] = __ldg(b2 + d);
        xq[2 * c] = __ldg(xt + (size_t)d * B + ba);
        xq[2 * c + 1] = __ldg(xt + (size_t)d * B + bb);
      }
    };
    load(0, bv[0], xv[0]);
#pragma unroll
    for (int p = 0; p < NACC / 8; ++p) {
      if (p + 1 < NACC / 8) load(p + 1, bv[(p + 1) & 1], xv[(p + 1) & 1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = d0 + 16 * p + 8 * (c >> 1) + 2 * t + (c & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 8 * p + 4 * (c >> 1) + 2 * h + (c & 1);
          const float l = sum[i] + small[i] + bv[p & 1][c];
          float e, lg;
          asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e)
              : "f"(-fabsf(l) * 1.4426950408889634f));
          asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.f + e));
          const float sp = fmaxf(l, 0.f) + 0.6931471805599453f * lg;
          rows[h] += d < D && (h ? vb : va) ? xv[p & 1][2 * c + h] * l - sp
                                            : 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = rows[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0 && (h ? vb : va)) out[h ? rb : ra] = v;
  }
}

extern "C" int decode_image_launch(const float* w1, const float* b1,
                                   const float* w2, unsigned* img, int Z,
                                   int H, int D, void* stream) {
  const int nK = (H + BK - 1) / BK, nD = (D + BN - 1) / BN;
  const int zc = (Z + ZK - 1) / ZK;
  if (ring_slots(zc) < 1) return (int)cudaErrorInvalidValue;
  w_image_kernel<<<dim3(nK * nD, IMAGE_PARTS), IMAGE_NT, 0,
                   (cudaStream_t)stream>>>(w1, b1, w2, img, Z, H, D, nK, zc);
  return (int)cudaGetLastError();
}

extern "C" int decode_bce_launch(const float* zt, const float* xt,
                                 const float* w1, const float* b1,
                                 const float* w2, const float* b2, float* out,
                                 unsigned* img, int S, int Z, int B, int H,
                                 int D, void* stream) {
  const int nK = (H + BK - 1) / BK, nD = (D + BN - 1) / BN;
  const int zc = (Z + ZK - 1) / ZK, slots = ring_slots(zc);
  if (slots < 1) return (int)cudaErrorInvalidValue;
  if (S == 0 || B == 0) return (int)cudaGetLastError();
  const int err0 = decode_image_launch(w1, b1, w2, img, Z, H, D, stream);
  if (err0 != 0) return err0;
  const size_t smem = (size_t)slots * 4 * stage_words(zc) + BAR_BYTES;
  void (*kernel)(const float*, const float*, const float*, const unsigned*,
                 float*, int, int, int, int, int, int, int, int) =
      zc == 1 ? decode_bce_kernel<true> : decode_bce_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int R = S * B;
  kernel<<<(R + BM - 1) / BM, NT, smem, (cudaStream_t)stream>>>(
      zt, xt, b2, img, out, Z, B, R, D, nK, nD, zc, slots);
  return (int)cudaGetLastError();
}
