// Adam over every leaf of a model in one launch: the curvature mask, the
// two groups' learning rates, the moments, the bias corrections and the two
// step counters of a training step.
//
// Replaces no TPU kernel: the reference's optimizer is optax's Adam, which
// XLA fuses into the step's program. On the card it replaces
// torch.optim.Adam (foreach, capturable) and the curvature mask before it,
// ~80 small kernels a step.
//
// For each leaf, in float32, with t the step count after its increment:
//   g  = g                                  (a plain leaf)
//        g * (step_t >= burnin)             (a learnable curvature)
//        0                                  (a fixed curvature, or no g)
//   m  = fma(1 - b1, g - m, m)              (torch's lerp at weight < 0.5)
//   v  = v b2 + ((1 - b2) g) g
//   p  = p - (s m) / (sqrt(v) / c + eps)
// where the step size s = lr / (1 - b1^t) and c = sqrt(1 - b2^t) are taken
// in double and rounded to float32 once, as torch.optim.Adam's CPU path and
// optax in double have them (in float32, 1 - 0.999 alone is 1.3e-5 off);
// then Adam's count and the global step step_t advance by one. p, m and v
// are stored in the parameters' type (float32 or bfloat16), each rounded
// once. The plain version (kernels/optim_kernels.py::adam_ref) evaluates the
// same expressions, one PyTorch op each, so the file is compiled with
// --fmad=false (each multiply and add rounds as there) and the lerp is an
// explicit fma, as PyTorch's lerp is. b1, b2, eps and the learning rates
// arrive in double and are rounded here as PyTorch rounds a Python scalar:
// 1 - b1 and 1 - b2 are taken in double first (0.1f and 0.001f, not
// 1 - 0.9f).
//
// Bound: bytes. It reads p, g, m and v and writes p, m and v: 28 bytes a
// float32 parameter, 17.8 MB for the flagship's 636,397, 5.3 us at
// 3.35 TB/s.
//
// Design: the table of leaves travels by value in the kernel's parameters
// (__grid_constant__, indexed in place; no host-to-device copy, so a CUDA
// graph captures the launch with the pointers of the moment baked in).
// Blocks are spread over the elements, not over the leaves: leaf i owns
// ceil(n_i / ADAM_TILE) consecutive blocks from first_i, and a block finds
// its leaf by a scan of the table. The two
// weight matrices, 98.6% of the flagship's parameters, take ~300 blocks;
// each bias or head takes one, so no leaf serialises the launch. A thread
// moves ADAM_VEC elements at a time (16-byte loads and stores of float32,
// 8-byte of bfloat16) where the leaf's four pointers are aligned to that,
// and loads both of its groups before it computes. The counters: every
// block reads count and step_t first (thread 0, through shared memory),
// takes a ticket when its elements are done, and the block that takes the
// last ticket advances both counters and puts the ticket back to 0, so
// every launch and every graph replay starts from a zero ticket. A table of
// more than ADAM_MAX_LEAVES leaves is refused (the port's widest model has
// 29).
//
// Entry point (plain C, loaded with ctypes):
//   int adam_launch(const AdamLeafIn* leaves, int count, int bf16,
//                   float* step_count, long long* step_t,
//                   unsigned* ticket, long long burnin, double b1,
//                   double b2, double eps, cudaStream_t stream)
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// table this file cannot take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ADAM_THREADS 256
#define ADAM_VEC 4
#define ADAM_GROUPS 2
#define ADAM_TILE (ADAM_THREADS * ADAM_VEC * ADAM_GROUPS)
#define ADAM_MAX_LEAVES 48

enum { ADAM_PLAIN = 0, ADAM_CURVATURE = 1, ADAM_FIXED = 2 };

// One leaf as the caller passes it (kernels/optim_kernels.py::_Leaf)
struct AdamLeafIn {
  void* p;
  const void* g;  // null: a zero gradient
  void* m;
  void* v;
  long long n;
  double lr;
  int kind;
};

struct AdamLeaf {
  AdamLeafIn in;
  long long first;  // the leaf's first block
};

struct AdamTable {
  AdamLeaf leaf[ADAM_MAX_LEAVES];
  int count;
};

__device__ __forceinline__ float adam_load(const float* p) { return *p; }
__device__ __forceinline__ float adam_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void adam_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void adam_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ADAM_VEC consecutive elements in one load or store
__device__ __forceinline__ void adam_load4(const float* p, float* x) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}
__device__ __forceinline__ void adam_load4(const __nv_bfloat16* p, float* x) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  x[0] = __low2float(a); x[1] = __high2float(a);
  x[2] = __low2float(b); x[3] = __high2float(b);
}
__device__ __forceinline__ void adam_store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void adam_store4(__nv_bfloat16* p, const float* x) {
  uint2 w;
  *reinterpret_cast<__nv_bfloat162*>(&w.x) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(&w.y) = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = w;
}

// The hyperparameters: b1 and b2 in double for the bias corrections, the
// rest rounded to float32 on the host
struct AdamBetas {
  double b1, b2;
  float b2f, w1, w2, eps;  // w1 = 1 - b1, w2 = 1 - b2
};

struct AdamScalars {
  float scale;      // the gradient's factor: 1 or the mask
  float w1, b2, w2;
  float step_size;  // lr / (1 - b1^t)
  float bc2_sqrt;   // sqrt(1 - b2^t)
  float eps;
};

__device__ __forceinline__ void adam_element(const AdamScalars& s, float g,
                                             float& p, float& m, float& v) {
  g = g * s.scale;
  m = fmaf(s.w1, g - m, m);
  v = v * s.b2 + (s.w2 * g) * g;
  const float denom = sqrtf(v) / s.bc2_sqrt + s.eps;
  p = p - (s.step_size * m) / denom;
}

template <class T>
__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(const __grid_constant__ AdamTable table,
            float* __restrict__ step_count, long long* __restrict__ step_t,
            unsigned* __restrict__ ticket, long long burnin,
            const AdamBetas h) {
  __shared__ float sh_count;
  __shared__ long long sh_step;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sh_count = *step_count;
    sh_step = *step_t;
  }
  __syncthreads();

  const long long bx = blockIdx.x;
  int i = 0;
  while (i + 1 < table.count && table.leaf[i + 1].first <= bx) ++i;
  const AdamLeafIn& L = table.leaf[i].in;

  AdamScalars s;
  const double t = (double)sh_count + 1.0;
  s.w1 = h.w1;
  s.b2 = h.b2f;
  s.w2 = h.w2;
  s.step_size = (float)(L.lr / (1.0 - pow(h.b1, t)));
  s.bc2_sqrt = (float)sqrt(1.0 - pow(h.b2, t));
  s.eps = h.eps;
  // a learnable curvature's gradient is multiplied by the mask, so an
  // infinite one turns nan in burn-in as the reference's does; a fixed
  // curvature's or an absent gradient is zero
  s.scale = L.kind == ADAM_CURVATURE ? (sh_step >= burnin ? 1.0f : 0.0f)
                                     : 1.0f;
  const bool zero_g = L.kind == ADAM_FIXED || L.g == nullptr;

  T* p = static_cast<T*>(L.p);
  const T* g = static_cast<const T*>(L.g);
  T* m = static_cast<T*>(L.m);
  T* v = static_cast<T*>(L.v);
  const long long start = (bx - table.leaf[i].first) * ADAM_TILE;
  const long long end = start + ADAM_TILE < L.n ? start + ADAM_TILE : L.n;
  const uintptr_t align = (uintptr_t)p | (uintptr_t)g | (uintptr_t)m |
                          (uintptr_t)v;
  const bool vec = align % (ADAM_VEC * sizeof(T)) == 0;

  float pr[ADAM_GROUPS][ADAM_VEC], gr[ADAM_GROUPS][ADAM_VEC];
  float mr[ADAM_GROUPS][ADAM_VEC], vr[ADAM_GROUPS][ADAM_VEC];
  long long e0[ADAM_GROUPS];
  #pragma unroll
  for (int k = 0; k < ADAM_GROUPS; ++k) {
    const long long e = start + ((long long)k * ADAM_THREADS + tid) * ADAM_VEC;
    e0[k] = e;
    if (vec && e + ADAM_VEC <= end) {
      adam_load4(p + e, pr[k]);
      adam_load4(m + e, mr[k]);
      adam_load4(v + e, vr[k]);
      if (zero_g) {
        #pragma unroll
        for (int j = 0; j < ADAM_VEC; ++j) gr[k][j] = 0.0f;
      } else {
        adam_load4(g + e, gr[k]);
      }
    } else {
      #pragma unroll
      for (int j = 0; j < ADAM_VEC; ++j) {
        const bool in = e + j < end;
        pr[k][j] = in ? adam_load(p + e + j) : 0.0f;
        mr[k][j] = in ? adam_load(m + e + j) : 0.0f;
        vr[k][j] = in ? adam_load(v + e + j) : 0.0f;
        gr[k][j] = in && !zero_g ? adam_load(g + e + j) : 0.0f;
      }
    }
  }
  #pragma unroll
  for (int k = 0; k < ADAM_GROUPS; ++k) {
    #pragma unroll
    for (int j = 0; j < ADAM_VEC; ++j)
      adam_element(s, gr[k][j], pr[k][j], mr[k][j], vr[k][j]);
    const long long e = e0[k];
    if (vec && e + ADAM_VEC <= end) {
      adam_store4(p + e, pr[k]);
      adam_store4(m + e, mr[k]);
      adam_store4(v + e, vr[k]);
    } else {
      #pragma unroll
      for (int j = 0; j < ADAM_VEC; ++j) {
        if (e + j < end) {
          adam_store(p + e + j, pr[k][j]);
          adam_store(m + e + j, mr[k][j]);
          adam_store(v + e + j, vr[k][j]);
        }
      }
    }
  }

  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      *step_count = sh_count + 1.0f;
      *step_t = sh_step + 1;
      *ticket = 0u;
      __threadfence();
    }
  }
}

// The launch's table from the caller's leaves: each leaf's first block,
// and the blocks of the whole table (0 for a table this file cannot take)
static inline long long adam_table(const AdamLeafIn* leaves, int count,
                                   AdamTable* table) {
  if (count < 1 || count > ADAM_MAX_LEAVES) return 0;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (leaves[i].n < 1 || leaves[i].kind < ADAM_PLAIN ||
        leaves[i].kind > ADAM_FIXED)
      return 0;
    table->leaf[i].in = leaves[i];
    table->leaf[i].first = blocks;
    blocks += (leaves[i].n + ADAM_TILE - 1) / ADAM_TILE;
  }
  table->count = count;
  return blocks <= 0x7fffffffLL ? blocks : 0;
}

static inline AdamBetas adam_betas(double b1, double b2, double eps) {
  const AdamBetas h = {b1, b2, (float)b2, (float)(1.0 - b1),
                       (float)(1.0 - b2), (float)eps};
  return h;
}

extern "C" int adam_launch(const AdamLeafIn* leaves, int count, int bf16,
                           float* step_count, long long* step_t,
                           unsigned* ticket, long long burnin, double b1,
                           double b2, double eps, void* stream) {
  AdamTable table = {};
  const long long blocks = adam_table(leaves, count, &table);
  if (blocks == 0) return cudaErrorInvalidValue;
  const AdamBetas h = adam_betas(b1, b2, eps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(ADAM_THREADS);
  if (bf16)
    adam_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        table, step_count, step_t, ticket, burnin, h);
  else
    adam_kernel<float><<<grid, block, 0, s>>>(
        table, step_count, step_t, ticket, burnin, h);
  return cudaGetLastError();
}
