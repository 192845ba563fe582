// Hopper (sm_90a) LUT window gathers: a compiled Block_TT as one kernel that
// reads the block's input bits, builds each window's pattern index and looks
// it up in the block's truth tables.
//
// Replaces scale_imagenet_tpu/pallas/lut_gather.py::_bit_kernel (:84) and
// ::_float_kernel (:107), together with the index conv that fed them
// (scale_imagenet_tpu/compile/lut_eval.py::lut_block_tt_apply and
// ::_merged_heads_apply: pad, power-of-two grouped conv, int32 cast).  The
// TPU kernels take a precomputed (G, E) index because Mosaic could not build
// one inside the kernel; here the index never leaves the thread.  Bound with
// ctypes through a plain C interface (scale_imagenet_tpu_torch/kernels/
// lut_gather.py holds the wrappers, the plain PyTorch versions and the
// launch counts).
//
// Index front end (both kernels).  Input bits x (B, C, H, W), bf16 or f32,
// addressed through element strides, so NCHW and channels-last take no copy;
// a value is a bit 1 where it is not +-0.  Group g reads channels g*ci + c.
// Window (b, ho, wo) has bit j = c*kh*kw + a*kw + bb equal to the bit at row
// ho*stride - pad + a, column wo*stride - pad + bb (0 outside the image: the
// constant pad), and its index is sum_j bit_j << (n-1-j): MSB-first,
// channel-major, as compile/truth_table.py::enumerate_patterns orders the
// table rows.  Built with shifts and ors only, for any kh, kw, stride, pad
// and ci with n = kh*kw*ci <= 24; an index is below 2^n by construction, so
// no lookup can leave its table.
//
// lut_window_bits: words (K*G, F, Wd) int32 (pack_bit_table: entry v of
//   table (k*G+g, f) is bit v & 31 of word v >> 5), K heads sharing one
//   index (the merged heads 1+2).  out (E, K*G*F) in x's dtype, E = B*Ho*Wo
//   in NHWC order, channel k*G*F + g*F + f (head-major): the NHWC activation
//   itself, so the merged heads split it without a copy.
// lut_window_float: table (G, V, F) f32, V = 2^n (filter-minor: one lookup's
//   F values are F*4 contiguous bytes); out (E, G*F) f32.
//
// What bounds it on this card: bytes.  A launch reads its input bits once
// and writes its output once (the flagship's launches at B = 256 move 30 to
// 205 MB, 10 to 61 us at 3.35 TB/s); the lookups land in small tables (8 KB
// a filter at n = 16, resident in L1 and L2) or, for the float head, in one
// 268 MB table.  The arithmetic (a shift and an or a bit, a shift and a mask
// an output) is far below the CUDA cores' rate, but the work a bit costs
// in issued loads is what the design has to hold down.  So:
//
// * One thread a window and (for bits) a run of groups; the index is built
//   in registers with all of a batch's loads in flight before any is used,
//   and looked up at once.  Groups are chunked by GC, the least power of two
//   whose run of outputs a window and head is 32 bytes, so stores fill
//   whole sectors: F = 16 bf16 outputs are one group's 32 bytes as two
//   16-byte vectors; the depthwise heads (F = 1) take 16 groups.
// * How the bits are read follows their layout (chosen at launch):
//   - channels-last, a group's ci channels whole 16-byte vectors (the k=1
//     heads of the later blocks): one vector load a window position
//     instead of one load a bit;
//   - channels-last, one-channel groups (the depthwise heads of the later
//     blocks): a thread owns 8 groups (bf16; 4 in f32) whose channels are
//     one 16-byte vector, so each of the 16 window loads serves 8 indices;
//   - NCHW, F = 1 (block 0's depthwise heads): a thread owns 8 groups and
//     the warp runs along the windows, so each load instruction reads
//     consecutive columns of one channel plane, and the thread still stores
//     8 adjacent outputs as one vector;
//   - otherwise one load a bit from a window table of per-bit offsets held
//     in shared memory (pointwise windows in the float kernel index channel
//     j directly).  Loads are predicated, not branched, so that a batch
//     stays in flight at the image borders.
// * Tables are read through the read-only path: the blocks that share an SM
//   work on one chunk of groups, whose bit tables (at most 16 filters x 8 KB
//   at the flagship) stay in L1; the float table is filter-minor, so a
//   lookup's F = 16 values are one 64-byte run (four 16-byte loads), where
//   the (G, F, V) layout took 16 separate sectors for 64 useful bytes.
//
// Plain CUDA C++ on the CUDA cores: there is no product for the tensor
// cores here.  Measured times against the bound: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxBits = 24;
constexpr int kBatch = 16;             // window loads in flight a thread
constexpr int kMaxVec = 6;             // 16-byte channel vectors a position
constexpr int kThreads = 256;
constexpr long long kMaxE = 1LL << 30;  // windows a launch: 32-bit indexing

struct Geometry {
  long long sb, sc, sh, sw;  // element strides of x as (B, C, H, W)
  int E;                     // windows: B * Ho * Wo (below 2^30)
  int H, W, Ho, Wo;
  int kh, kw, stride, pad, ci, n;
  bool aligned;              // every position's channel 0 on 16 bytes
};

// Per-bit offsets of a window, relative to its (b, g*ci, h0, w0) corner.
struct WindowTable {
  long long off[kMaxBits];
  int a[kMaxBits];
  int b[kMaxBits];
};

__device__ __forceinline__ void fill_window(WindowTable& t,
                                            const Geometry& g) {
  const int j = threadIdx.x;
  if (j < g.n) {
    const int area = g.kh * g.kw;
    const int c = j / area, r = j % area;
    t.a[j] = r / g.kw;
    t.b[j] = r % g.kw;
    t.off[j] = c * g.sc + t.a[j] * g.sh + t.b[j] * g.sw;
  }
}

__device__ __forceinline__ uint32_t bit_of(const uint16_t* p) {
  return (__ldg(p) & 0x7FFFu) != 0u;          // bf16: not +-0
}

__device__ __forceinline__ uint32_t bit_of(const uint32_t* p) {
  return (__ldg(p) & 0x7FFFFFFFu) != 0u;      // f32: not +-0
}

// Window e of group grp: its corner (b, g*ci, h0, w0) and whether it lies
// inside the image.
template <typename T>
struct Window {
  const T* base;
  int h0, w0;
  bool inside;

  __device__ __forceinline__ Window(const T* x, const Geometry& g, int e,
                                    int grp) {
    const int hw = g.Ho * g.Wo;
    const int b = e / hw, r = e - b * hw;
    const int ho = r / g.Wo, wo = r - ho * g.Wo;
    h0 = ho * g.stride - g.pad;
    w0 = wo * g.stride - g.pad;
    inside = h0 >= 0 && w0 >= 0 && h0 + g.kh <= g.H && w0 + g.kw <= g.W;
    base = x + b * g.sb + static_cast<long long>(grp) * g.ci * g.sc +
           h0 * g.sh + w0 * g.sw;
  }

  __device__ __forceinline__ bool holds(const Geometry& g, int a,
                                        int b) const {
    return inside |
           ((static_cast<unsigned>(h0 + a) < static_cast<unsigned>(g.H)) &
            (static_cast<unsigned>(w0 + b) < static_cast<unsigned>(g.W)));
  }
};

// The n-bit pattern index of window e of group grp, one load a bit, a
// batch of kBatch loads in flight before any is used.
template <typename T>
__device__ __forceinline__ uint32_t window_index(const T* __restrict__ x,
                                                 const Geometry& g,
                                                 const WindowTable& t,
                                                 int e, int grp) {
  const Window<T> win(x, g, e, grp);
  uint32_t idx = 0;
  for (int j0 = 0; j0 < g.n; j0 += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // read the offsets whether or not the bit is inside, so that the
      // loads stay predicated and the batch stays in flight
      const int j = j0 + u;
      const bool in_window = j < g.n;
      const int a = in_window ? t.a[j] : 0, b = in_window ? t.b[j] : 0;
      const long long off = in_window ? t.off[j] : 0;
      v[u] = 0;
      if (in_window & win.holds(g, a, b)) v[u] = bit_of(win.base + off);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u < g.n) idx = (idx << 1) | v[u];
    }
  }
  return idx;
}

// The same index for a pointwise window (kh = kw = 1): bit j is channel j,
// at a stride the thread computes.
template <typename T>
__device__ __forceinline__ uint32_t window_index_point(
    const T* __restrict__ x, const Geometry& g, int e, int grp) {
  const Window<T> win(x, g, e, grp);
  uint32_t idx = 0;
  if (!win.holds(g, 0, 0)) return 0;
  for (int j0 = 0; j0 < g.n; j0 += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = j0 + u < g.n ? bit_of(win.base + (j0 + u) * g.sc) : 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (j0 + u < g.n) idx = (idx << 1) | v[u];
    }
  }
  return idx;
}

// The same index where a position's ci channels are contiguous and
// 16-byte aligned (channels-last bits): one 16-byte load per 8 bf16 (4 f32)
// channels of a window position.
template <typename T>
__device__ __forceinline__ uint32_t window_index_vec(
    const T* __restrict__ x, const Geometry& g, const WindowTable& t, int e,
    int grp) {
  constexpr int kPer = 16 / sizeof(T);           // channels a vector
  const Window<T> win(x, g, e, grp);
  const int area = g.kh * g.kw, nvec = g.ci / kPer;
  uint32_t idx = 0;
  for (int r = 0; r < area; ++r) {              // (a, b) of channel 0
    if (!win.holds(g, t.a[r], t.b[r])) continue;
    const uint4* p = reinterpret_cast<const uint4*>(win.base + t.off[r]);
    uint4 q[kMaxVec];
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      if (v < nvec) q[v] = __ldg(p + v);
    }
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      if (v >= nvec) break;
      const uint32_t w[4] = {q[v].x, q[v].y, q[v].z, q[v].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // channel c carries bit n-1-(c*area + r); the lower half of a
        // word is the lower channel
        if (sizeof(T) == 2) {
          const int c = v * 8 + 2 * i;
          idx |= static_cast<uint32_t>((w[i] & 0x7FFFu) != 0u)
                 << (g.n - 1 - (c * area + r));
          idx |= static_cast<uint32_t>((w[i] & 0x7FFF0000u) != 0u)
                 << (g.n - 1 - ((c + 1) * area + r));
        } else {
          const int c = v * 4 + i;
          idx |= static_cast<uint32_t>((w[i] & 0x7FFFFFFFu) != 0u)
                 << (g.n - 1 - (c * area + r));
        }
      }
    }
  }
  return idx;
}

// The indices of kPer consecutive one-channel groups grp0.. (depthwise
// windows over channels-last bits): one 16-byte load a window position
// serves all of them.
template <typename T, int kPer>
__device__ __forceinline__ void window_indices_vec(
    const T* __restrict__ x, const Geometry& g, const WindowTable& t, int e,
    int grp0, uint32_t (&idx)[kPer]) {
  constexpr int kB = kBatch / 2;
  const Window<T> win(x, g, e, grp0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) idx[k] = 0;
  for (int j0 = 0; j0 < g.n; j0 += kB) {
    uint4 q[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int j = j0 + u;
      const bool in_window = j < g.n;
      const int a = in_window ? t.a[j] : 0, b = in_window ? t.b[j] : 0;
      const long long off = in_window ? t.off[j] : 0;
      q[u] = make_uint4(0u, 0u, 0u, 0u);
      if (in_window & win.holds(g, a, b))
        q[u] = __ldg(reinterpret_cast<const uint4*>(win.base + off));
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (j0 + u >= g.n) break;
      const uint32_t w[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const uint32_t bit =
            sizeof(T) == 2
                ? (w[k / 2] & (k % 2 ? 0x7FFF0000u : 0x7FFFu)) != 0u
                : (w[k] & 0x7FFFFFFFu) != 0u;
        idx[k] = (idx[k] << 1) | bit;
      }
    }
  }
}

// How a thread reads its windows' bits.
enum Mode {
  kPerBit = 0,     // one load a bit, offsets from the window table
  kPointwise,      // one load a bit, channel j at j strides (kh = kw = 1)
  kVecChannels,    // a group's channels as 16-byte vectors
  kVecGroups,      // kGT one-channel groups' channels as one vector
};

template <int kMode, int kGT, typename T>
__device__ __forceinline__ void indices_of(const T* __restrict__ x,
                                           const Geometry& g,
                                           const WindowTable& t, int e,
                                           int grp0, uint32_t (&idx)[kGT]) {
  if (kMode == kVecGroups) {
    window_indices_vec<T, kGT>(x, g, t, e, grp0, idx);
  } else {
#pragma unroll
    for (int k = 0; k < kGT; ++k)
      idx[k] = kMode == kVecChannels ? window_index_vec(x, g, t, e, grp0 + k)
               : kMode == kPointwise  ? window_index_point(x, g, e, grp0 + k)
                                      : window_index(x, g, t, e, grp0 + k);
  }
}

template <typename OutT>
__device__ __forceinline__ OutT bit_value(uint32_t b);

// bf16 is stored as its raw 16-bit pattern: 1.0 is 0x3F80
template <>
__device__ __forceinline__ uint16_t bit_value<uint16_t>(uint32_t b) {
  return b ? static_cast<uint16_t>(0x3F80u) : static_cast<uint16_t>(0u);
}

template <>
__device__ __forceinline__ float bit_value<float>(uint32_t b) {
  return b ? 1.0f : 0.0f;
}

// A block covers a chunk of GC groups and blockDim / (GC / kGT) windows; a
// thread owns one window and kGT consecutive groups of the chunk.  kGT = 1
// runs the groups fastest across a warp (their channels are adjacent in
// channels-last bits); kGT = 8 (only where F = 1) runs the windows fastest,
// so that a warp's loads run along W in NCHW bits, and still stores 8
// adjacent outputs a thread.  T is the storage type of x and out: uint16_t
// (bf16) or uint32_t (f32).
template <typename T, int kMode, int kGT>
__global__ void __launch_bounds__(kThreads)
lut_window_bits_kernel(Geometry g, const T* __restrict__ x,
                       const uint32_t* __restrict__ words, void* out_v,
                       int G, int F, int Wd, int K, int GC) {
  using OutT = typename std::conditional<sizeof(T) == 2, uint16_t,
                                         float>::type;
  constexpr int kVec = 16 / sizeof(OutT);
  __shared__ WindowTable win;
  fill_window(win, g);
  __syncthreads();
  const int lanes_g = GC / kGT;
  const int slots = blockDim.x / lanes_g;
  const int e = blockIdx.x * slots + threadIdx.x / lanes_g;
  if (e >= g.E) return;
  const int grp0 = blockIdx.y * GC + (threadIdx.x % lanes_g) * kGT;
  uint32_t idx[kGT];
  indices_of<kMode, kGT>(x, g, win, e, grp0, idx);
  const long long table = static_cast<long long>(F) * Wd;   // words a table
  OutT* o = static_cast<OutT*>(out_v) +
            static_cast<long long>(e) * K * G * F +
            static_cast<long long>(grp0) * F;
  for (int h = 0; h < K; ++h, o += static_cast<long long>(G) * F) {
    const uint32_t* tab =
        words + (static_cast<long long>(h) * G + grp0) * table;
    if (kGT > 1) {                              // F = 1: a value a group
      union {
        uint4 u[kGT / kVec];
        OutT v[kGT];
      } pack;
#pragma unroll
      for (int k = 0; k < kGT; ++k)
        pack.v[k] = bit_value<OutT>(
            (__ldg(tab + k * table + (idx[k] >> 5)) >> (idx[k] & 31u)) & 1u);
#pragma unroll
      for (int v = 0; v < kGT / kVec; ++v)
        reinterpret_cast<uint4*>(o)[v] = pack.u[v];
      continue;
    }
    const uint32_t* w = tab + (idx[0] >> 5);
    const uint32_t shift = idx[0] & 31u;
    if (F % kVec == 0) {
      for (int f0 = 0; f0 < F; f0 += kVec) {
        union {
          uint4 u;
          OutT v[kVec];
        } pack;
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          pack.v[j] =
              bit_value<OutT>((__ldg(w + (f0 + j) * Wd) >> shift) & 1u);
        *reinterpret_cast<uint4*>(o + f0) = pack.u;
      }
    } else {
      for (int f = 0; f < F; ++f)
        o[f] = bit_value<OutT>((__ldg(w + f * Wd) >> shift) & 1u);
    }
  }
}

template <typename T, int kMode, int kGT>
void launch_bits(const Geometry& g, dim3 grid, const void* x,
                 const uint32_t* words, void* out, int G, int F, int Wd,
                 int K, int gc, cudaStream_t s) {
  lut_window_bits_kernel<T, kMode, kGT><<<grid, kThreads, 0, s>>>(
      g, static_cast<const T*>(x), words, out, G, F, Wd, K, gc);
}

// One thread a window of one group (blockIdx.y): its F floats are one
// contiguous run of the filter-minor table, copied as 16-byte vectors.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
lut_window_float_kernel(Geometry g, const T* __restrict__ x,
                        const float* __restrict__ table,
                        float* __restrict__ out, int G, int F) {
  __shared__ WindowTable win;
  fill_window(win, g);
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.E) return;
  const int grp = blockIdx.y;
  uint32_t idx[1];
  indices_of<kMode, 1>(x, g, win, e, grp, idx);
  const uint32_t v = idx[0];
  const float* src = table + ((static_cast<long long>(grp) << g.n) + v) * F;
  float* o = out + (static_cast<long long>(e) * G + grp) * F;
  if (F % 4 == 0) {
    for (int f0 = 0; f0 < F; f0 += 4)
      *reinterpret_cast<float4*>(o + f0) =
          __ldg(reinterpret_cast<const float4*>(src + f0));
  } else {
    for (int f = 0; f < F; ++f) o[f] = __ldg(src + f);
  }
}

int make_geometry(Geometry* g, const void* x, int elt, int B, int H, int W,
                  long long sb, long long sc, long long sh, long long sw,
                  int Ho, int Wo, int kh, int kw, int stride, int pad,
                  int ci) {
  g->sb = sb;
  g->sc = sc;
  g->sh = sh;
  g->sw = sw;
  g->H = H;
  g->W = W;
  g->Ho = Ho;
  g->Wo = Wo;
  g->kh = kh;
  g->kw = kw;
  g->stride = stride;
  g->pad = pad;
  g->ci = ci;
  g->n = kh * kw * ci;
  const long long E = static_cast<long long>(B) * Ho * Wo;
  if (g->n < 1 || g->n > kMaxBits || stride < 1 || pad < 0 || Ho < 1 ||
      Wo < 1 || E >= kMaxE)
    return static_cast<int>(cudaErrorInvalidValue);
  g->E = static_cast<int>(E);
  const long long v = 16 / elt;
  g->aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && sb % v == 0 &&
               sh % v == 0 && sw % v == 0;
  return 0;
}

// A group's channels are read as 16-byte vectors where they are
// contiguous, aligned and whole vectors (channels-last bits).
template <typename T>
bool channel_vectors(const Geometry& g) {
  constexpr int kPer = 16 / sizeof(T);
  return g.sc == 1 && g.aligned && g.ci % kPer == 0 &&
         g.ci / kPer <= kMaxVec;
}

template <typename T>
int launch_bits_t(const Geometry& g, const void* x, const uint32_t* words,
                  void* out, int G, int F, int Wd, int K, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  // a chunk of GC groups writes a 32-byte run a window and head
  int gc = 1;
  while (gc < 32 && gc * F * static_cast<int>(sizeof(T)) < 32 &&
         G % (gc * 2) == 0)
    gc *= 2;
  if (G / gc > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // one-channel groups (F = 1) are read kPer at a time where their channels
  // are contiguous; in NCHW bits a thread owns 8 of them, windows fastest
  // across the warp, so that its loads run along W
  const bool vec_c = channel_vectors<T>(g);
  const bool vec_g = !vec_c && g.sc == 1 && g.aligned && g.ci == 1 &&
                     F == 1 && gc % kPer == 0;
  const bool along_w = !vec_c && !vec_g && F == 1 && g.sw == 1 && gc % 8 == 0;
  const int gt = vec_g ? kPer : along_w ? 8 : 1;
  const int per_block = kThreads / (gc / gt);
  const dim3 grid(static_cast<unsigned int>((g.E + per_block - 1) /
                                            per_block),
                  static_cast<unsigned int>(G / gc));
  if (vec_g)
    launch_bits<T, kVecGroups, kPer>(g, grid, x, words, out, G, F, Wd, K, gc,
                                     s);
  else if (along_w)
    launch_bits<T, kPerBit, 8>(g, grid, x, words, out, G, F, Wd, K, gc, s);
  else if (vec_c)
    launch_bits<T, kVecChannels, 1>(g, grid, x, words, out, G, F, Wd, K, gc,
                                    s);
  else
    launch_bits<T, kPerBit, 1>(g, grid, x, words, out, G, F, Wd, K, gc, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_float_t(const Geometry& g, const void* x, const float* table,
                   float* out, int G, int F, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>((g.E + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(G));
  const T* xt = static_cast<const T*>(x);
  if (channel_vectors<T>(g))
    lut_window_float_kernel<T, kVecChannels><<<grid, kThreads, 0, s>>>(
        g, xt, table, out, G, F);
  else if (g.kh * g.kw == 1)
    lut_window_float_kernel<T, kPointwise><<<grid, kThreads, 0, s>>>(
        g, xt, table, out, G, F);
  else
    lut_window_float_kernel<T, kPerBit><<<grid, kThreads, 0, s>>>(
        g, xt, table, out, G, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K heads of G groups each share one index.  Returns cudaGetLastError()
// after the launch (0: ok), or cudaErrorInvalidValue for a geometry the
// kernel does not take (kernels/lut_gather.py checks before the call).
extern "C" int lut_window_bits_launch(
    const void* x, const void* words, void* out, int B, int H, int W,
    long long sb, long long sc, long long sh, long long sw, int Ho, int Wo,
    int kh, int kw, int stride, int pad, int ci, int G, int F, int Wd, int K,
    int bf16, void* stream) {
  const int elt = bf16 ? 2 : 4;
  Geometry g;
  const int bad = make_geometry(&g, x, elt, B, H, W, sb, sc, sh, sw, Ho, Wo,
                                kh, kw, stride, pad, ci);
  if (bad) return bad;
  if (G < 1 || F < 1 || K < 1 ||
      (static_cast<long long>(Wd) << 5) < (1LL << g.n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  return bf16 ? launch_bits_t<uint16_t>(g, x, w, out, G, F, Wd, K, s)
              : launch_bits_t<uint32_t>(g, x, w, out, G, F, Wd, K, s);
}

// table (G, 2^n, F) f32; out (E, G*F) f32.  Returns cudaGetLastError().
extern "C" int lut_window_float_launch(
    const void* x, const void* table, void* out, int B, int H, int W,
    long long sb, long long sc, long long sh, long long sw, int Ho, int Wo,
    int kh, int kw, int stride, int pad, int ci, int G, int F, int bf16,
    void* stream) {
  Geometry g;
  const int bad = make_geometry(&g, x, bf16 ? 2 : 4, B, H, W, sb, sc, sh,
                                sw, Ho, Wo, kh, kw, stride, pad, ci);
  if (bad) return bad;
  if (G < 1 || G > 65535 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  return bf16 ? launch_float_t<uint16_t>(g, x, tab, o, G, F, s)
              : launch_float_t<uint32_t>(g, x, tab, o, G, F, s);
}
