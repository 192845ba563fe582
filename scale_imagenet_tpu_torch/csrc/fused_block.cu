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
// last block, ReLU.  Compute in f32, store in x's dtype (f32 or bf16).
//
// What bounds it on this card: operations on the CUDA cores.  Each
// pixel-group does m*(ci + co) multiply-adds and m polynomial GELUs
// (~25 more ops each) per ci + co values read and written, about 30 f32
// operations per byte at the flagship's ci = co = 16, m = 128; the card's
// balance point is 67 TFLOP/s / 3.35 TB/s = 20.  The unfused chain's
// (pixels, G*m) f32 intermediate (1.6 GB in block 0 head 3 at B = 256)
// never leaves the SM here.  Products stay in f32 on the CUDA cores: TF32
// or bf16 tensor cores would flip Heaviside bits.
//
// Design (simple first): one block per (pixel tile, group), one thread per
// pixel.  The group's W1 (stored (m, ci)), W2 (m, co) and the four affine
// vectors go to shared memory (17.5 KB at the flagship).  A thread loads its
// ci inputs into registers once and streams over j < m: the W1 row and the
// W2 row of j are the same address for every thread of the warp, so each is
// a broadcast 16-byte shared load feeding 4 FMAs.  Only ci + co values stay
// live.  x and out are addressed through (b, c, h, w) strides, so NCHW
// activations are read and written coalesced across pixels with no
// transpose, and the (N, G*ci) row contract is the same kernel with other
// strides.  ci and co are template parameters (registers need fixed sizes);
// m, the dtype and the activation are run-time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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
__device__ __forceinline__ float fast_erf(float y) {
  constexpr float kC = 3.9192f;
  constexpr float kScale = static_cast<float>(2.0 / (3.9192 * 3.9192));
  const float a = fminf(fabsf(y), kC);
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
  return copysignf(a * acc, y);
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

template <int CI, int CO>
__host__ __device__ constexpr int smem_floats(int m) {
  return round4(m * CI) + round4(m * CO) + 2 * round4(m) + 2 * round4(CO);
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
int launch(const Args& a, int G, cudaStream_t stream) {
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || G > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(float) * smem_floats<CI, CO>(a.m);
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

template <int CI>
int dispatch_co(const Args& a, int G, int co, cudaStream_t s) {
  switch (co) {
    case 1: return launch<CI, 1>(a, G, s);
    case 2: return launch<CI, 2>(a, G, s);
    case 4: return launch<CI, 4>(a, G, s);
    case 8: return launch<CI, 8>(a, G, s);
    case 16: return launch<CI, 16>(a, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The (ci, co) pairs instantiated: ci, co in {1, 2, 4, 8, 16}, which covers
// every k=1 block of the ttnet_imagenet variants (kernels/fused_block.py
// checks the shape before the call).  Returns cudaGetLastError() after the
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
  switch (ci) {
    case 1: return dispatch_co<1>(a, G, co, s);
    case 2: return dispatch_co<2>(a, G, co, s);
    case 4: return dispatch_co<4>(a, G, co, s);
    case 8: return dispatch_co<8>(a, G, co, s);
    case 16: return dispatch_co<16>(a, G, co, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
