// Hopper (sm_90a) bit-sliced cube evaluation: a compiled Block_TT run as
// its boolean circuit, 32 window positions a 32-bit word.
//
// The JAX package has no Pallas kernel here: its device evaluator
// (scale_imagenet_tpu/compile/gate_device.py::gate_block_apply_device,
// :195-221) is XLA ops that build a (G, F, T, W) int32 mismatch tensor and
// OR it over the n bit planes, which XLA fuses on the TPU.  Eagerly that
// tensor is gigabytes a head and would be written and read once a plane,
// so the port evaluates the covers in this kernel instead.  Bound with
// ctypes through a plain C interface (scale_imagenet_tpu_torch/kernels/
// gate_cubes.py holds the wrapper, the plain PyTorch version and the
// launch count).
//
// Contract (bit for bit the out_words of gate_block_apply_device,
// :205-215):
//   planes  (G, n, W) uint32: plane p, word w, bit i = pattern bit p of
//           window position 32*w + i of group g (positions past the end 0);
//   cubes   (T_total, 2) uint32 (value, mask), mask bit = don't care, the
//           covers of the G*F filters one after another (filter g*F + f);
//   offsets (G*F + 1) int64: filter j's cubes are [offsets[j], offsets[j+1]);
//   out     (G, F, W) uint32 = OR over the filter's cubes of
//           AND over its fixed bits p < n of (plane_p == value_p),
//           inverted when `invert` (the CNF form: the cubes are the
//           minimized complement).  An empty cover (a constant filter)
//           gives 0, or ~0 inverted, as in JAX; the caller substitutes
//           the constant after unpacking.
//
// What bounds it on this card: integer logic on the CUDA cores.  The
// function needs one logic operation a word for every fixed literal of
// every cube: mism | (plane ^ value) is a three-input function, one LOP3
// at the int32 rate; and one a cube, out | ~mism.  Each word is read once
// and written once, so at the flagship's ~1,150 cubes of ~14 fixed
// literals a filter that is ~20,000 operations a byte.  This kernel
// spends two a bit and cube, (plane ^ x) & fixed and the OR, over every
// bit p < MAXN, don't-care bits included: about twice what is needed
// (the headroom a faster version goes after: walk only fixed literals).
//
// Design (simple first): one block per (filter, tile of 128 * NW words),
// one thread per NW words of the tile.  A thread keeps its NW words of the
// group's n planes in registers (loaded once), so no intermediate reaches
// global memory.  The filter's cubes are staged through shared memory
// kChunk at a time, each decoded once into per-bit (xor constant, fixed
// mask) words laid out bit-major, so the inner loop over a cube's bits is
// one broadcast 8-byte shared load and 2 * NW logic operations a bit.  The
// loop over a filter's cubes has a data-dependent length; n is a template
// bound (8, 16, 32) so that the bit loop unrolls over registers, and bits
// p >= n have a zero fixed mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;   // cubes staged in shared memory per pass

template <int MAXN, int NW>
__global__ void __launch_bounds__(kThreads)
gate_cubes_kernel(const uint32_t* __restrict__ planes,
                  const uint2* __restrict__ cubes,
                  const long long* __restrict__ offsets,
                  uint32_t* __restrict__ out, int F, int n, long long W,
                  int invert) {
  // per staged cube and bit p: (xor constant, fixed mask), bit-major so
  // that the decode writes and the broadcast reads hit distinct banks
  __shared__ uint2 lit[MAXN][kChunk];
  const int gf = blockIdx.y;                  // filter g * F + f
  const int g = gf / F;
  const long long w0 =
      static_cast<long long>(blockIdx.x) * (kThreads * NW) + threadIdx.x;

  uint32_t pl[NW][MAXN];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const long long w = w0 + static_cast<long long>(k) * kThreads;
#pragma unroll
    for (int p = 0; p < MAXN; ++p)
      pl[k][p] = (p < n && w < W)
                     ? __ldg(planes + (static_cast<long long>(g) * n + p) * W
                             + w)
                     : 0u;
  }
  uint32_t acc[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) acc[k] = 0u;

  const uint32_t nmask = n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
  const long long t_end = offsets[gf + 1];
  for (long long t0 = offsets[gf]; t0 < t_end; t0 += kChunk) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kChunk),
                                         t_end - t0));
    __syncthreads();                          // the last pass has read lit
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const uint2 c = __ldg(cubes + t0 + t);
      const uint32_t fixed = ~c.y & nmask;
#pragma unroll
      for (int p = 0; p < MAXN; ++p)
        lit[p][t] = make_uint2(0u - ((c.x >> p) & 1u),
                               0u - ((fixed >> p) & 1u));
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      uint32_t mism[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) mism[k] = 0u;
#pragma unroll
      for (int p = 0; p < MAXN; ++p) {
        const uint2 l = lit[p][t];
#pragma unroll
        for (int k = 0; k < NW; ++k) mism[k] |= (pl[k][p] ^ l.x) & l.y;
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) acc[k] |= ~mism[k];
    }
  }
  const uint32_t flip = invert ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const long long w = w0 + static_cast<long long>(k) * kThreads;
    if (w < W) out[static_cast<long long>(gf) * W + w] = acc[k] ^ flip;
  }
}

template <int MAXN, int NW>
int launch_t(const uint32_t* planes, const uint2* cubes,
             const long long* offsets, uint32_t* out, int G, int F, int n,
             long long W, int invert, cudaStream_t s) {
  const long long tiles = (W + kThreads * NW - 1) / (kThreads * NW);
  if (tiles > 0x7FFFFFFFLL || static_cast<long long>(G) * F > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(G * F));
  gate_cubes_kernel<MAXN, NW><<<grid, kThreads, 0, s>>>(
      planes, cubes, offsets, out, F, n, W, invert);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes (G, n, W) uint32, cubes (T_total, 2) uint32, offsets (G*F + 1)
// int64, out (G, F, W) uint32, all contiguous on the card.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gate_cubes_launch(const void* planes, const void* cubes,
                                 const void* offsets, void* out, int G,
                                 int F, int n, long long W, int invert,
                                 void* stream) {
  if (G <= 0 || F <= 0 || n <= 0 || n > 32 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto pl = static_cast<const uint32_t*>(planes);
  auto cb = static_cast<const uint2*>(cubes);
  auto of = static_cast<const long long*>(offsets);
  auto o = static_cast<uint32_t*>(out);
  if (n <= 8) return launch_t<8, 4>(pl, cb, of, o, G, F, n, W, invert, s);
  if (n <= 16) return launch_t<16, 4>(pl, cb, of, o, G, F, n, W, invert, s);
  return launch_t<32, 2>(pl, cb, of, o, G, F, n, W, invert, s);
}
