// Hopper (sm_90a) fused pointwise TT-block: an eval-mode k=1 stride-1
// Block_TT as one kernel.
//
// Replaces scale_imagenet_tpu/pallas/fused_block.py::_kernel (:41) and
// ::_kernel_v2 (:191): both compute the same function, and one kernel with
// strided reads serves both contracts.  Bound with ctypes through a plain C
// interface (scale_imagenet_tpu_torch/kernels/fused_block.py holds the
// wrappers, the plain PyTorch versions and the launch count).
//
// Per pixel p and channel group g (ci inputs, m = t*ci hidden, co outputs):
//   h_j = gelu(s1[g,j] * sum_i x[p, g*ci+i] * w1[g,i,j] + b1[g,j])
//   y_o = act(s2[g,o] * sum_j h_j * w2[g,j,o] + b2[g,o])
// with the BN affines folded into (s, b), gelu(v) = 0.5 v (1 + erf(v/sqrt2))
// through the polynomial erf of ops/gelu.py::fast_erf (the same 17
// coefficients, clamp at c = 3.9192), act the Heaviside (v >= 0) or, for a
// last block, ReLU.  f32 arithmetic outside the two products, stored in
// x's dtype (f32 or bf16).  x and out are addressed through (b, c, h, w)
// strides, so NCHW activations and the (N, G*ci) row contract are the same
// kernel with other strides, and no transpose surrounds it.
//
// Two bodies, picked by shape alone (fused_body below; the wrapper's
// fused_body mirrors it):
//   tensor-core body: (ci, co) in {(8, 8), (16, 8), (16, 16), (32, 16),
//     (32, 32)} with m a multiple of 16.  That is every k=1 launch of the
//     flagship (16/16, 16/8 at m = 128), of v2 (32/32, 32/16 at m = 256)
//     and vAlexnet's head 3 (8/8 at m = 64).
//   FMA body (CUDA cores only): every other instantiated pair, i.e. ci or
//     co below 8 (the VGG stem's and TT_FHE's 4/4 launches, which take
//     11-290 us and are bound by launch latency), and a tensor-core pair
//     whose m is not a multiple of 16.
// A pair in neither list is refused (cudaErrorInvalidValue), as is a
// failed launch: nothing falls back.
//
// What bounds the tensor-core body (v2 block 0 head 3 at B = 256: G 2,
// ci = co = 32, m = 256, 1.606 M pixel-groups): per pixel-group the two
// group products are 6 m (ci + co) = 98,304 tensor-core flops as three
// TF32 products (0.319 ms at 495 TF/s); the BN1 FMA and the 41-op GELU a
// hidden unit and 3 ops an output are 11,104 CUDA-core ops (0.266 ms at
// 67 T/s); x and out are 411 MB (0.123 ms at 3.35 TB/s).  The FMA body
// ran the products on the CUDA cores too, a 1.051 ms bound there.  On the
// flagship's shapes the GELU on the CUDA cores sets the bound.
//
// Why three TF32 products keep the contract.  One TF32 product rounds
// each operand to 11 significant bits (relative error 2^-11): a
// pre-activation moves by ~1e-4, which flips Heaviside bits away from
// their threshold.  Here each f32 operand a is split into a_hi =
// rna_tf32(a) and a_lo = rna_tf32(a - a_hi) (the rounding of
// cvt.rna.tf32.f32), and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (CUTLASS's OpMultiplyAddFastF32).  The split carries ~22 significant
// bits, what a chain of f32 FMAs carries, and the dropped a_lo.b_lo is
// 2^-22 relative.  The two small products go into one f32 accumulator and
// the large one into another, added at the end: the small ones are summed
// among themselves first, and each chain of dependent mma is half as long.
// The tensor cores' f32 accumulation is coarser than an f32 add and the
// running sum over all m hidden units is the largest value in play, so
// GEMM 2 puts each chunk's large products into a zeroed partial and adds
// it to the output sum with an f32 add (rounded to nearest).  Without it,
// v2's launches flipped more Heaviside outputs near their thresholds
// (each within the contract), and carried through the model they changed
// the argmax of 1.1 % of 2,560 seeded images against the unfused forward
// (PERF.md).
// A bf16 x is exact in TF32, so for bf16 (a static property, the
// template's BF16) x_lo is 0 and GEMM 1 takes two products.  On the card
// every flagship and v2 launch stays well within the contract (PERF.md
// gives the largest differences), and tests/test_torch_fused_split.py
// emulates the split on the CPU: three products meet the contract, one
// does not.
//
// Tensor-core body design (mma.sync.aligned.m16n8k8 TF32, a warp's
// product.  A wgmma version of the same body, m64nNk8 with x and the
// hidden chunk as A in registers and W K-major in shared memory, one
// commit group a chunk, was slower at every flagship and v2 launch when
// tried: with 16 hidden units a chunk its N is small, and a warpgroup
// waits on each group before its GELU):
//  - Persistent CTAs, one wave: grid (resident CTAs an SM x SMs / G, G).
//    A CTA stages its group's W1, W2 and affines once, split into TF32 hi
//    and lo parts, in shared memory in fragment order: float4 {b0_hi,
//    b1_hi, b0_lo, b1_lo} per lane and (k-step, n-tile), so one
//    conflict-free 16-byte load gives a lane both parts of its B fragment
//    (no rows, so no padding).  Its warps then walk tiles of 16 R pixels of
//    that group (R m16 row tiles share each B fragment) with no barrier.
//  - A warp's x fragment is loaded from global straight into registers,
//    the next tile's loads issued before this tile's math so that they are
//    in flight under it.  cp.async was not taken: its smallest copy is 4
//    bytes, and a bf16 x in NCHW with an odd H*W (29^2, 15^2) has no
//    aligned pairs of pixels.  In NCHW a fragment load reads 8 consecutive
//    pixels of 4 channels, whole 32-byte sectors.
//  - The hidden layer never leaves the SM: m is walked in chunks of 16
//    hidden units.  GEMM 1 runs into the chunk's accumulators, the BN1
//    affine and the GELU are applied to those registers, and the chunk is
//    GEMM 2's A fragment as it stands: a thread's C fragment holds hidden
//    columns 2t and 2t+1 where the A fragment wants k = t and t+4, so
//    GEMM 2's k index is permuted (k = t <-> hidden 2t, k = t + 4 <->
//    hidden 2t + 1) and W2's B fragments are staged in that order.
//  - Instructions a hidden unit are what the CUDA cores spend: the BN1
//    affine is staged scaled by 1/sqrt2 so the GELU needs no scaling of
//    its own, erf's sign folds into |v/2|, and the TF32 rounding is two
//    integer operations (ptxas lowers cvt.rna.tf32.f32 to four).
//  - The epilogue applies the BN2 affine and the activation to the
//    [16 R x co] accumulators and stores them from the fragments: in NCHW
//    each store writes 8 consecutive pixels of 4 channels, whole 32-byte
//    sectors of f32.
// Measured (PERF.md): the mma part and the CUDA-core part of a
// launch add up rather than overlap (a launch without the GELU and one
// without the mma take about the whole between them), so the kernel sits
// above the bound, which assumes they overlap.
//
// FMA body design: one block per (128-pixel tile, group), one thread per
// pixel, W1/W2 rows as 16-byte shared-memory broadcasts, x[ci] and y[co]
// in registers; each hidden unit is a chain of ci FMAs and co FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>


namespace {

constexpr int kThreads = 128;              // FMA body
constexpr int kChunk = 16;                 // hidden units a GEMM 1 -> 2 step
constexpr int kTile = 16;                  // pixels a warp tile (mma rows)

struct Args {
  const void* x;
  void* out;
  const float* w1t;  // (G, m, ci): row j holds w1[g, :, j]
  const float* s1;   // (G, m)
  const float* b1;
  const float* w2;   // (G, m, co)
  const float* s2;   // (G, co)
  const float* b2;
  long long n;       // pixels = B * H * W
  long long hw;      // H * W
  long long w;       // W
  long long xsb, xsc, xsh, xsw;   // element strides of x as (B, C, H, W)
  long long osb, osc, osh, osw;   // and of out
  int m;
  int bf16;          // x and out are bf16 (else f32)
  int relu;          // ReLU (a last block) instead of Heaviside
};

// ops/gelu.py: erf(y) ~ sign(y) * a * P(2 a^2 / c^2 - 1), a = min(|y|, c)
constexpr float kErfClamp = 3.9192f;

// P(2 a^2 / c^2 - 1) for a = min(|y|, c)
__device__ __forceinline__ float erf_poly(float a) {
  constexpr float kScale = static_cast<float>(2.0 / (3.9192 * 3.9192));
  const float t = kScale * (a * a) - 1.0f;
  float acc = 4.2988495543e-04f;
  acc = acc * t + -9.2150733462e-04f;
  acc = acc * t + 4.0678763248e-04f;
  acc = acc * t + -1.0948765636e-03f;
  acc = acc * t + 4.5950983811e-03f;
  acc = acc * t + -8.0814775912e-03f;
  acc = acc * t + 1.1978128299e-02f;
  acc = acc * t + -1.9648207814e-02f;
  acc = acc * t + 3.0679596203e-02f;
  acc = acc * t + -4.3540862328e-02f;
  acc = acc * t + 5.8129466345e-02f;
  acc = acc * t + -7.3985296905e-02f;
  acc = acc * t + 9.0629897258e-02f;
  acc = acc * t + -1.0919577683e-01f;
  acc = acc * t + 1.3410743171e-01f;
  acc = acc * t + -1.8014451874e-01f;
  acc = acc * t + 3.6081034995e-01f;
  return acc;
}

__device__ __forceinline__ float fast_erf(float y) {
  const float a = fminf(fabsf(y), kErfClamp);
  return copysignf(a * erf_poly(a), y);
}

__device__ __forceinline__ float gelu(float v) {
  return (0.5f * v) * (1.0f + fast_erf(v * 0.70710678118654752f));
}

__device__ __forceinline__ float load(const void* p, long long off,
                                      int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[off])
              : static_cast<const float*>(p)[off];
}

__device__ __forceinline__ void store(void* p, long long off, float v,
                                      int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[off] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[off] = v;
  }
}

// the tensor-core body's element access, the dtype a template parameter
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ------------------------------------------------------------ FMA body

// dot += sum_k a[k] * row[k] over K values of a shared-memory row, as
// 16-byte broadcast loads when K allows
template <int K>
__device__ __forceinline__ float dot_row(const float (&a)[K],
                                         const float* row) {
  float acc = 0.0f;
  if constexpr (K % 4 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 v = r4[q];
      acc = fmaf(a[4 * q + 0], v.x, acc);
      acc = fmaf(a[4 * q + 1], v.y, acc);
      acc = fmaf(a[4 * q + 2], v.z, acc);
      acc = fmaf(a[4 * q + 3], v.w, acc);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(a[k], row[k], acc);
  }
  return acc;
}

template <int K>
__device__ __forceinline__ void axpy_row(float (&y)[K], float h,
                                         const float* row) {
  if constexpr (K % 4 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 v = r4[q];
      y[4 * q + 0] = fmaf(h, v.x, y[4 * q + 0]);
      y[4 * q + 1] = fmaf(h, v.y, y[4 * q + 1]);
      y[4 * q + 2] = fmaf(h, v.z, y[4 * q + 2]);
      y[4 * q + 3] = fmaf(h, v.w, y[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = fmaf(h, row[k], y[k]);
  }
}

// shared-memory regions, each starting on a 16-byte boundary
__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__host__ __device__ constexpr int smem_floats(int ci, int m, int co) {
  return round4(m * ci) + round4(m * co) + 2 * round4(m) + 2 * round4(co);
}

template <int CI, int CO>
__global__ void __launch_bounds__(kThreads)
fused_pointwise_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* const w1 = reinterpret_cast<float*>(smem4);
  const int m = a.m;
  float* const w2 = w1 + round4(m * CI);
  float* const s1 = w2 + round4(m * CO);
  float* const b1 = s1 + round4(m);
  float* const s2 = b1 + round4(m);
  float* const b2 = s2 + round4(CO);

  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const float* gw1 = a.w1t + static_cast<long long>(g) * m * CI;
  const float* gw2 = a.w2 + static_cast<long long>(g) * m * CO;
  for (int k = tid; k < m * CI; k += kThreads) w1[k] = gw1[k];
  for (int k = tid; k < m * CO; k += kThreads) w2[k] = gw2[k];
  for (int k = tid; k < m; k += kThreads) {
    s1[k] = a.s1[static_cast<long long>(g) * m + k];
    b1[k] = a.b1[static_cast<long long>(g) * m + k];
  }
  if (tid < CO) {
    s2[tid] = a.s2[g * CO + tid];
    b2[tid] = a.b2[g * CO + tid];
  }
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (p >= a.n) return;
  const long long b = p / a.hw;
  const long long r = p - b * a.hw;
  const long long hh = r / a.w;
  const long long ww = r - hh * a.w;

  const long long xo = b * a.xsb + hh * a.xsh + ww * a.xsw +
                       static_cast<long long>(g) * CI * a.xsc;
  float x[CI];
#pragma unroll
  for (int i = 0; i < CI; ++i) x[i] = load(a.x, xo + i * a.xsc, a.bf16);

  float y[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) y[o] = 0.0f;

#pragma unroll 2
  for (int j = 0; j < m; ++j) {
    const float h = gelu(dot_row<CI>(x, w1 + j * CI) * s1[j] + b1[j]);
    axpy_row<CO>(y, h, w2 + j * CO);
  }

  const long long oo = b * a.osb + hh * a.osh + ww * a.osw +
                       static_cast<long long>(g) * CO * a.osc;
#pragma unroll
  for (int o = 0; o < CO; ++o) {
    const float v = y[o] * s2[o] + b2[o];
    const float out = a.relu ? fmaxf(v, 0.0f) : (v >= 0.0f ? 1.0f : 0.0f);
    store(a.out, oo + o * a.osc, out, a.bf16);
  }
}

template <int CI, int CO>
int launch_fma(const Args& a, int G, cudaStream_t stream) {
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || G > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(float) * smem_floats(CI, a.m, CO);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_pointwise_kernel<CI, CO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(G));
  fused_pointwise_kernel<CI, CO><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- tensor-core body

// cvt.rna.tf32.f32's rounding (the mantissa to 10 bits, to nearest, ties
// away from zero) of a finite f32, as two integer operations: add half a
// unit of the last place to the magnitude and clear the 13 low bits.
// ptxas lowers the PTX instruction to four, with a guard for NaN and Inf;
// here an Inf stays Inf, and a NaN is not carried (the pre-activations and
// weights of a launch are finite).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32 (lo carries the next 11 significant bits)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a . b on one m16n8k8 TF32 tile (f32 accumulators).  Fragments, with
// q = lane / 4 and t = lane % 4: a0 (row q, k t), a1 (q + 8, t), a2 (q,
// t + 4), a3 (q + 8, t + 4); b0 (k t, col q), b1 (k t + 4, col q); c0 (row
// q, col 2t), c1 (q, 2t + 1), c2 (q + 8, 2t), c3 (q + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three products of a split A and B fragment: the two small ones into
// `small`, the large one into `big` (two accumulators, so that the chains
// of dependent mma are half as long; the caller adds them)
template <bool ALO>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  if constexpr (ALO) {
    mma_tf32(small, al, __float_as_uint(b.x), __float_as_uint(b.y));
  }
  mma_tf32(small, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(big, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

// float4 {hi(v0), hi(v1), lo(v0), lo(v1)}
__device__ __forceinline__ float4 split_pair(float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(v0, h0, l0);
  split_tf32(v1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

// gelu(v) from u = v / sqrt2 (the BN1 affine is staged scaled by 1/sqrt2):
// erf(u) = sign(u) a P, so 0.5 v (1 + erf(u)) = hv + |hv| a P with hv =
// u / sqrt2 = v / 2
__device__ __forceinline__ float gelu_of_scaled(float u) {
  const float a = fminf(fabsf(u), kErfClamp);
  const float hv = u * 0.70710678118654752f;
  return fmaf(fabsf(hv) * a, erf_poly(a), hv);
}

// shared memory of the tensor-core body, in float4: the W1 and W2
// fragments (one float4 a weight pair: m ci / 2 and m co / 2), the BN1
// affine (m / 2) and the BN2 affine (co / 2)
template <int CI, int CO>
__host__ __device__ constexpr int tc_smem_float4(int m) {
  return m * CI / 2 + m * CO / 2 + m / 2 + CO / 2;
}

// m16 row tiles a warp walks at a time (a warp tile is 16 R pixels: the
// B fragments loaded from shared memory serve R row tiles, and R
// independent mma chains hide each other's latency) and warps a CTA, as
// measured fastest on the card (PERF.md): ci = 32 at co = 32 two
// row tiles and 8 warps (245 registers; its 133 KB of weights leave room
// for one CTA an SM anyway), at co = 16 one and 8; ci <= 16 two and 4
template <int CI, int CO>
__host__ __device__ constexpr int tc_rows() {
  return CI == 32 && CO == 16 ? 1 : 2;
}

template <int CI, int CO>
__host__ __device__ constexpr int tc_warps() {
  return CI == 32 ? 8 : 4;
}

// element offsets of pixel p's (b, h, w) in x and in out
struct PixelOffsets {
  long long x, o;
};

__device__ __forceinline__ PixelOffsets pixel_offsets(const Args& a,
                                                      unsigned int p) {
  const unsigned int hw = static_cast<unsigned int>(a.hw);
  const unsigned int w = static_cast<unsigned int>(a.w);
  const unsigned int b = p / hw;
  const unsigned int r = p - b * hw;
  const unsigned int hh = r / w;
  const unsigned int ww = r - hh * w;
  return {b * a.xsb + hh * a.xsh + ww * a.xsw,
          b * a.osb + hh * a.osh + ww * a.osw};
}

template <int CI, int CO, bool BF16>
__global__ void __launch_bounds__(32 * tc_warps<CI, CO>())
fused_pointwise_tc_kernel(const Args a, const int tiles) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int R = tc_rows<CI, CO>();
  constexpr int kTcWarps = tc_warps<CI, CO>();
  constexpr int kTcThreads = 32 * kTcWarps;
  constexpr int KS1 = CI / 8;        // k-steps of GEMM 1
  constexpr int NT2 = CO / 8;        // n-tiles of GEMM 2
  constexpr int NC = kChunk / 8;     // hidden tiles a chunk
  extern __shared__ float4 smem4[];
  const int m = a.m;
  const int mt = m / 8;              // hidden tiles
  float4* const w1f = smem4;                    // [mt][KS1][32]
  float4* const w2f = w1f + mt * KS1 * 32;      // [mt][NT2][32]
  float4* const a1f = w2f + mt * NT2 * 32;      // [mt][4]
  float4* const a2f = a1f + mt * 4;             // [NT2][4]

  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  // stage the group's weights once, as TF32 hi/lo in fragment order
  {
    const float* gw1 = a.w1t + static_cast<long long>(g) * m * CI;
    for (int e = tid; e < mt * KS1 * 32; e += kTcThreads) {
      const int ln = e & 31, f = e >> 5;
      const int nt = f / KS1, ks = f - nt * KS1;
      // b0 = W1[k = 8 ks + t][n = 8 nt + q], b1 at k + 4
      const float* row = gw1 + (nt * 8 + (ln >> 2)) * CI + ks * 8 + (ln & 3);
      w1f[e] = split_pair(row[0], row[4]);
    }
    const float* gw2 = a.w2 + static_cast<long long>(g) * m * CO;
    for (int e = tid; e < mt * NT2 * 32; e += kTcThreads) {
      const int ln = e & 31, f = e >> 5;
      const int kt = f / NT2, nt = f - kt * NT2;
      // the permuted k of GEMM 2: b0 = W2[8 kt + 2t][8 nt + q], b1 at the
      // next hidden unit
      const float* col = gw2 + (kt * 8 + 2 * (ln & 3)) * CO + nt * 8 +
                         (ln >> 2);
      w2f[e] = split_pair(col[0], col[CO]);
    }
    // BN1 scaled by 1/sqrt2 (gelu_of_scaled)
    constexpr float kInvSqrt2 = 0.70710678118654752f;
    const long long gm = static_cast<long long>(g) * m;
    for (int e = tid; e < mt * 4; e += kTcThreads) {
      const long long j = gm + 2 * e;   // hidden 8 kt + 2t, e = 4 kt + t
      a1f[e] = make_float4(a.s1[j] * kInvSqrt2, a.s1[j + 1] * kInvSqrt2,
                           a.b1[j] * kInvSqrt2, a.b1[j + 1] * kInvSqrt2);
    }
    for (int e = tid; e < NT2 * 4; e += kTcThreads) {
      const int j = g * CO + 2 * e;     // output 8 nt + 2t, e = 4 nt + t
      a2f[e] = make_float4(a.s2[j], a.s2[j + 1], a.b2[j], a.b2[j + 1]);
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int q = lane >> 2, t = lane & 3;
  const int stride = gridDim.x * kTcWarps;
  int tile = blockIdx.x * kTcWarps + (tid >> 5);
  if (tile >= tiles) return;

  const T* const x = static_cast<const T*>(a.x);
  T* const out = static_cast<T*>(a.out);
  const long long xg = static_cast<long long>(g) * CI * a.xsc;
  const long long og = static_cast<long long>(g) * CO * a.osc;

  // a tile's x as GEMM 1's A fragments, raw: [row tile][k-step][a0..a3],
  // pixel rows 16 r + q and + 8, channels 8 ks + t and + 4, 0 past the
  // last pixel; and the tile's output offsets (-1 past the last pixel)
  T xr[R][KS1][4];
  long long on[R][2];
  auto load_tile = [&](int tl) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned int p = static_cast<unsigned int>(tl) * (kTile * R) +
                               16 * r + q + 8 * half;
        const bool ok = p < a.n;
        long long xb = 0;
        on[r][half] = -1;
        if (ok) {
          const PixelOffsets po = pixel_offsets(a, p);
          xb = po.x + xg;
          on[r][half] = po.o + og;
        }
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            T v{};
            if (ok) v = x[xb + (ks * 8 + t + 4 * kk) * a.xsc];
            xr[r][ks][half + 2 * kk] = v;
          }
        }
      }
    }
  };
  load_tile(tile);

  while (true) {
    uint32_t xh[R][KS1][4], xl[R][KS1][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = to_f32(xr[r][ks][i]);
          if constexpr (BF16) {
            xh[r][ks][i] = __float_as_uint(v);   // exact in TF32
            xl[r][ks][i] = 0u;
          } else {
            split_tf32(v, xh[r][ks][i], xl[r][ks][i]);
          }
        }
      }
    }
    long long oc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      oc[r][0] = on[r][0];
      oc[r][1] = on[r][1];
    }
    // the next tile's x is in flight under this tile's math
    const int next = tile + stride;
    if (next < tiles) load_tile(next);

    // GEMM 2's sums: the large products in yb, the small ones in ys
    float yb[R][NT2][4], ys[R][NT2][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) yb[r][nt][i] = ys[r][nt][i] = 0.0f;
      }
    }

    const float4* w1p = w1f + lane;
    const float4* w2p = w2f + lane;
    const float4* a1p = a1f + t;
    for (int c = 0; c < m / kChunk; ++c) {
      // GEMM 1: the chunk's pre-activations [16 R x kChunk]
      float hb[R][NC][4], hs[R][NC][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
          for (int i = 0; i < 4; ++i) hb[r][nc][i] = hs[r][nc][i] = 0.0f;
        }
      }
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
          const float4 b = w1p[(nc * KS1 + ks) * 32];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mma3<!BF16>(hb[r][nc], hs[r][nc], xh[r][ks], xl[r][ks], b);
          }
        }
      }
      // BN1 and GELU on the accumulators; the C fragment is GEMM 2's A
      // fragment under the permuted k (a0 = c0, a1 = c2, a2 = c1, a3 = c3)
      uint32_t hh[R][NC][4], hl[R][NC][4];
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const float4 af = a1p[nc * 4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = hb[r][nc][i] + hs[r][nc][i];
          split_tf32(gelu_of_scaled(fmaf(v[0], af.x, af.z)), hh[r][nc][0],
                     hl[r][nc][0]);
          split_tf32(gelu_of_scaled(fmaf(v[2], af.x, af.z)), hh[r][nc][1],
                     hl[r][nc][1]);
          split_tf32(gelu_of_scaled(fmaf(v[1], af.y, af.w)), hh[r][nc][2],
                     hl[r][nc][2]);
          split_tf32(gelu_of_scaled(fmaf(v[3], af.y, af.w)), hh[r][nc][3],
                     hl[r][nc][3]);
        }
      }
      // GEMM 2: the chunk's large products into a zeroed partial, added
      // to the output sum with an f32 add; the small products straight
      // into their sum
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        float pb[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) pb[r][i] = 0.0f;
        }
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const float4 b = w2p[(nc * NT2 + nt) * 32];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mma3<true>(pb[r], ys[r][nt], hh[r][nc], hl[r][nc], b);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) yb[r][nt][i] += pb[r][i];
        }
      }
      w1p += NC * KS1 * 32;
      w2p += NC * NT2 * 32;
      a1p += NC * 4;
    }

    // BN2 and the activation; rows q (c0, c1) and q + 8 (c2, c3), output
    // channels 8 nt + 2t (c0, c2) and 8 nt + 2t + 1 (c1, c3)
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) {
      const float4 af = a2f[nt * 4 + t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (oc[r][half] < 0) continue;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float v = fmaf(yb[r][nt][2 * half + e2] +
                                     ys[r][nt][2 * half + e2],
                                 e2 ? af.y : af.x, e2 ? af.w : af.z);
            const float o = a.relu ? fmaxf(v, 0.0f)
                                   : (v >= 0.0f ? 1.0f : 0.0f);
            put(out + oc[r][half] + (nt * 8 + 2 * t + e2) * a.osc, o);
          }
        }
      }
    }
    tile = next;
    if (tile >= tiles) break;
  }
}

// what the tensor-core body's launch takes: shared memory and resident CTAs
template <int CI, int CO, bool BF16>
int tc_plan(int m, size_t* smem, int* ctas_per_sm, int* threads) {
  *threads = 32 * tc_warps<CI, CO>();
  *smem = sizeof(float4) * tc_smem_float4<CI, CO>(m);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pointwise_tc_kernel<CI, CO, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fused_pointwise_tc_kernel<CI, CO, BF16>,
      32 * tc_warps<CI, CO>(),
      *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return *ctas_per_sm > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int CI, int CO, bool BF16>
int launch_tc(const Args& a, int G, cudaStream_t stream) {
  // pixel indices run in 32 bits; 2^31 pixels would not fit the card
  if (G > 65535 || a.n > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  size_t smem = 0;
  int ctas = 0;
  int threads = 0;
  const int err = tc_plan<CI, CO, BF16>(a.m, &smem, &ctas, &threads);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int rows = kTile * tc_rows<CI, CO>();
  constexpr int kTcWarps = tc_warps<CI, CO>();
  const int tiles = static_cast<int>((a.n + rows - 1) / rows);
  // one wave: at most the resident CTAs, an equal share to each group
  const int need = (tiles + kTcWarps - 1) / kTcWarps;
  const int fill = sms * ctas >= G ? sms * ctas / G : 1;
  const dim3 grid(static_cast<unsigned int>(need < fill ? need : fill),
                  static_cast<unsigned int>(G));
  fused_pointwise_tc_kernel<CI, CO, BF16>
      <<<grid, 32 * kTcWarps, smem, stream>>>(a, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

// 1: the tensor-core body, 0: the FMA body, -1: not instantiated
int fused_body(int ci, int m, int co) {
  const bool small = ci == 1 || ci == 2 || ci == 4 || ci == 8 || ci == 16;
  const bool small_co = co == 1 || co == 2 || co == 4 || co == 8 || co == 16;
  const bool pair = (small && small_co) || (ci == 32 && (co == 16 || co == 32));
  if (!pair || m <= 0) return -1;
  const bool tc = (ci == 8 && co == 8) || (ci == 16 && (co == 8 || co == 16))
                  || ci == 32;
  return tc && m % kChunk == 0 ? 1 : 0;
}

template <bool BF16>
int dispatch_tc(const Args& a, int G, int ci, int co, cudaStream_t s) {
  if (ci == 8 && co == 8) return launch_tc<8, 8, BF16>(a, G, s);
  if (ci == 16 && co == 8) return launch_tc<16, 8, BF16>(a, G, s);
  if (ci == 16 && co == 16) return launch_tc<16, 16, BF16>(a, G, s);
  if (ci == 32 && co == 16) return launch_tc<32, 16, BF16>(a, G, s);
  if (ci == 32 && co == 32) return launch_tc<32, 32, BF16>(a, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool BF16>
int plan_tc(int ci, int m, int co, size_t* smem, int* ctas, int* threads) {
  if (ci == 8 && co == 8) return tc_plan<8, 8, BF16>(m, smem, ctas, threads);
  if (ci == 16 && co == 8) return tc_plan<16, 8, BF16>(m, smem, ctas, threads);
  if (ci == 16 && co == 16) return tc_plan<16, 16, BF16>(m, smem, ctas, threads);
  if (ci == 32 && co == 16) return tc_plan<32, 16, BF16>(m, smem, ctas, threads);
  if (ci == 32 && co == 32) return tc_plan<32, 32, BF16>(m, smem, ctas, threads);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int CI>
int dispatch_co(const Args& a, int G, int co, cudaStream_t s) {
  switch (co) {
    case 1: return launch_fma<CI, 1>(a, G, s);
    case 2: return launch_fma<CI, 2>(a, G, s);
    case 4: return launch_fma<CI, 4>(a, G, s);
    case 8: return launch_fma<CI, 8>(a, G, s);
    case 16: return launch_fma<CI, 16>(a, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ci = 32: the v2 variant's heads, co 16 or 32 only
int dispatch_co32(const Args& a, int G, int co, cudaStream_t s) {
  switch (co) {
    case 16: return launch_fma<32, 16>(a, G, s);
    case 32: return launch_fma<32, 32>(a, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_fma(const Args& a, int G, int ci, int co, cudaStream_t s) {
  switch (ci) {
    case 1: return dispatch_co<1>(a, G, co, s);
    case 2: return dispatch_co<2>(a, G, co, s);
    case 4: return dispatch_co<4>(a, G, co, s);
    case 8: return dispatch_co<8>(a, G, co, s);
    case 16: return dispatch_co<16>(a, G, co, s);
    case 32: return dispatch_co32(a, G, co, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The (ci, co) pairs instantiated: ci, co in {1, 2, 4, 8, 16}, which covers
// every k=1 block of the ttnet_imagenet variants but v2 and of the TT_FHE
// family, and ci = 32 with co in {16, 32}, v2's (kernels/fused_block.py
// checks the shape before the call).  The body follows from (ci, m, co)
// alone (fused_body; fused_pointwise_plan reports it).  Returns cudaGetLastError() after the
// launch (0: ok), or cudaErrorInvalidValue for a shape not instantiated.
extern "C" int fused_pointwise_launch(
    const void* x, void* out, const void* w1t, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2,
    long long n, long long hw, long long w, long long xsb, long long xsc,
    long long xsh, long long xsw, long long osb, long long osc,
    long long osh, long long osw, int G, int ci, int m, int co, int bf16,
    int relu, void* stream) {
  if (n <= 0 || G <= 0) return 0;
  Args a;
  a.x = x;
  a.out = out;
  a.w1t = static_cast<const float*>(w1t);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.n = n;
  a.hw = hw;
  a.w = w;
  a.xsb = xsb;
  a.xsc = xsc;
  a.xsh = xsh;
  a.xsw = xsw;
  a.osb = osb;
  a.osc = osc;
  a.osh = osh;
  a.osw = osw;
  a.m = m;
  a.bf16 = bf16;
  a.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fused_body(ci, m, co)) {
    case 1:
      return bf16 ? dispatch_tc<true>(a, G, ci, co, s)
                  : dispatch_tc<false>(a, G, ci, co, s);
    case 0: return dispatch_fma(a, G, ci, co, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What a launch at (ci, m, co) and dtype takes on the current card:
// plan = {body, threads a CTA, dynamic shared memory bytes, resident CTAs
// an SM (the tensor-core body's persistent grid; 0 for the FMA body)}.
// Returns 0, or a CUDA error.
extern "C" int fused_pointwise_plan(int ci, int m, int co, int bf16,
                                    int* plan) {
  const int body = fused_body(ci, m, co);
  plan[0] = body;
  plan[1] = plan[2] = plan[3] = 0;
  if (body < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    plan[1] = kThreads;
    plan[2] = static_cast<int>(sizeof(float)) * smem_floats(ci, m, co);
    return 0;
  }
  size_t smem = 0;
  int ctas = 0;
  int threads = 0;
  const int err = bf16 ? plan_tc<true>(ci, m, co, &smem, &ctas, &threads)
                       : plan_tc<false>(ci, m, co, &smem, &ctas, &threads);
  plan[1] = threads;
  plan[2] = static_cast<int>(smem);
  plan[3] = ctas;
  return err;
}
