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
// What bounds it.  The bound the port states (chip_smoke.py::cube_ops) is
// int32 logic: one LOP3 a word for every fixed literal of every cube
// (mism | (plane ^ value)) and one a cube (out | ~mism), at 64 a clock an
// SM.  The flagship's minimized covers fix about 7.7 of a cube's 16 bits,
// so that is about 8.7 operations a cube and word; the words are read and
// written once, far below the memory rate.  A walk over literals with the
// planes in registers cannot reach it: registers take no run-time index,
// so a cube's don't-care bits can only be skipped by a branch a bit, which
// the compiler turns into predicated LOP3s issued for all 16 bits (17 a
// cube and word, twice the bound before any latency), or by a switch a
// nibble, which it compiles into compare trees with a shared load in every
// case.  Both were slower on the card than what follows.
//
// Design: no logic a literal at all.
// * Tables.  A block owns a tile of 64 words (two adjacent ones a lane)
//   and one group's planes.  For each word and each nibble q of the n
//   bits it keeps, in shared memory, the mismatch word of every one of the
//   81 states of the nibble's four literals (don't care, must be 0, must
//   be 1): the OR of plane or ~plane over the fixed bits.  Built once a
//   group (4 plane loads and 81 stores a lane, word and nibble), it turns
//   a cube into four table loads and two ORs a word, however many of its
//   bits are fixed: mism = T0[s0] | T1[s1] | T2[s2] | T3[s3], then
//   out |= ~mism.
// * What bounds the design: shared-memory load instructions.  A warp
//   issues five a cube (one 16-byte broadcast of the cube's four entry
//   offsets, then four table loads), whatever each carries, so a lane
//   takes two adjacent words and each table load is an 8-byte load: five
//   instructions and nine 128-byte wavefronts for 64 cube-words.  With one
//   word a lane (five instructions for 32 cube-words) the kernel was
//   slower on the card, as it was with the offsets passed by shuffles
//   (four instructions in place of one broadcast).
// * Occupancy.  A table is 81 KB for n = 16, so 2 blocks fit an SM; the 6
//   warps of a block share one table and take every sixth cube of the
//   run, four cubes in flight.
// * Work split.  The flat cube array (all filters' covers one after
//   another) is cut into S equal runs, and a block takes one run and one
//   tile.  S is set at launch from the shape alone (no host sync: each
//   block reads T_total = offsets[G*F] itself): at least kWaves waves of
//   resident blocks, raised until the last wave is 90 % full, since every
//   block walks as many cubes as any other, however long or short the
//   covers are.  So block 2's depthwise heads (G = 256, W = 512, 8 tiles,
//   covers of up to ~4,100 cubes) fill the card.  A run may end inside a
//   cover and may span several: at each filter boundary every warp
//   combines its partial OR into the filter's words with atomicOr on words
//   the launch zeroed first; CNF starts them at all ones and combines with
//   atomicAnd(~acc), so the inversion is applied exactly once, after the
//   combine, and an empty cover keeps 0 / ~0 with no block touching it.
//   Where a run crosses into another group the block rebuilds its table
//   between two barriers.
// * Staging.  Each warp decodes its own 32 cubes of a chunk (one a lane)
//   into table offsets in its own shared entries, so a chunk needs no
//   block barrier, only __syncwarp; the next chunk's raw cubes are loaded
//   into registers at the top of a chunk and are in flight while it is
//   walked (cp.async would land them raw, and their decode would then
//   need a second wait a chunk).
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, the flagship's
// covers at B = 256): 4.94 ms a DNF forward against the 3.50 ms bound,
// 1.41x, and every launch of a DNF or CNF forward between 1.25x and 1.70x;
// 5.19 cube-words a clock an SM at the boost clock, about 73 % of the
// 7.1 that nine wavefronts for 64 cube-words allow.  Every launch: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 6;          // warps of a block, sharing one table
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // words a block, two a lane
constexpr int kChunk = kThreads;   // cubes staged a pass, one a thread
constexpr int kStates = 81;        // 3^4 states of a nibble of literals
constexpr int kWaves = 2;          // least waves of resident blocks a launch

// one staged cube: for each nibble q of its bits, the byte offset of its
// table entry (q, state) from a lane's two words of the table
template <int MAXN>
struct alignas(16) StagedCube {
  uint32_t off[MAXN / 4];
};

template <int MAXN>
constexpr size_t smem_bytes() {
  return kChunk * sizeof(StagedCube<MAXN>)
         + static_cast<size_t>(MAXN / 4) * kStates * kTile
               * sizeof(uint32_t);
}

// The block's table: for every word of the tile, every nibble q of the
// group's bits and every state s = s0 + 3 s1 + 9 s2 + 27 s3 of its four
// literals (s_i = 0: don't care, 1: the bit must be 0, 2: it must be 1),
// the mismatch word of that literal set: the OR of plane (must be 0) or
// ~plane (must be 1) over the fixed bits.  Entry (q, s) of word l is
// tab[(q * 81 + s) * kTile + l], so a lane's two adjacent words are one
// 8-byte load.  Warp k builds the nibbles q = k mod kWarps of its lane's
// words w and w + 1.
template <int MAXN>
__device__ __forceinline__ void build_table(uint32_t* tab,
                                            const uint32_t* planes, int g,
                                            int n, int W, int w) {
  // a word past W reads the last word and a plane p >= n the last plane:
  // no store and no cube's fixed bit ever uses what they give
  const uint32_t* src = planes + static_cast<long long>(g) * n * W;
  const int w0 = min(w, W - 1), w1 = min(w + 1, W - 1);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q0 = 0; q0 < MAXN / 4; q0 += kWarps) {
    const int q = q0 + warp;
    if (q >= MAXN / 4) break;
    uint32_t x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t* row =
          src + static_cast<long long>(min(4 * q + i, n - 1)) * W;
      x[i] = __ldg(row + w0);
      y[i] = __ldg(row + w1);
    }
    uint2* e = reinterpret_cast<uint2*>(tab + q * kStates * kTile) + lane;
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      uint32_t m = 0u, m2 = 0u;
#pragma unroll
      for (int i = 0, d = s; i < 4; ++i, d /= 3) {
        if (d % 3 == 1) { m |= x[i]; m2 |= y[i]; }
        if (d % 3 == 2) { m |= ~x[i]; m2 |= ~y[i]; }
      }
      e[s * (kTile / 2)] = make_uint2(m, m2);
    }
  }
}

// OR (DNF) or AND-NOT (CNF) a run's partial result into a filter's words
// w and w + 1
__device__ __forceinline__ void combine(uint2& acc, uint32_t* row, int W,
                                        int w, int invert) {
  const uint32_t a[2] = {acc.x, acc.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (w + k < W && a[k]) {
      if (invert) atomicAnd(row + w + k, ~a[k]);
      else atomicOr(row + w + k, a[k]);
    }
  }
  acc = make_uint2(0u, 0u);
}

// the first filter j in [0, GF) whose cover ends after cube c, i.e. with
// offsets[j + 1] > c (offsets[GF] > c): a 32-way search, each lane one
// probe, every warp alike
__device__ __forceinline__ int find_filter(const long long* offsets, int GF,
                                           long long c) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = GF;                        // the answer is in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const bool after = probe < hi && __ldg(offsets + probe + 1) > c;
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, after);
    if (ball) {
      const int f = __ffs(ball) - 1;
      hi = lo + f * step + 1;
      if (f > 0) lo += (f - 1) * step + 1;
    } else {
      lo += ((hi - lo + step - 1) / step - 1) * step + 1;
    }
  }
  return lo;
}

template <int MAXN>
__global__ void __launch_bounds__(kThreads)
gate_cubes_kernel(const uint32_t* __restrict__ planes,
                  const uint2* __restrict__ cubes,
                  const long long* __restrict__ offsets,
                  uint32_t* __restrict__ out, int GF, int F, int n, int W,
                  int S, int invert) {
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // warp k stages and walks cubes k, k + kWarps, k + 2 kWarps, ... of each
  // chunk: lane i holds cube k + kWarps * i in the warp's 32 entries
  auto* mine = reinterpret_cast<StagedCube<MAXN>*>(smem) + 32 * warp;
  auto* tab = reinterpret_cast<uint32_t*>(
      reinterpret_cast<StagedCube<MAXN>*>(smem) + kChunk);
  const long long T = __ldg(offsets + GF);
  const long long c0 = T * blockIdx.y / S;
  const long long c1 = T * (blockIdx.y + 1) / S;
  if (c0 >= c1) return;                       // the whole block: no barrier
  const int w = blockIdx.x * kTile + 2 * lane;
  const uint32_t nmask = n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
  const char* colb = reinterpret_cast<const char*>(tab + 2 * lane);

  int j = find_filter(offsets, GF, c0);
  long long fend = __ldg(offsets + j + 1);
  int g = j / F;
  build_table<MAXN>(tab, planes, g, n, W, w);
  uint2 acc = make_uint2(0u, 0u);

  auto fetch = [&](long long base) {
    const long long c = base + warp + kWarps * lane;
    return c < c1 ? __ldg(cubes + c) : make_uint2(0u, 0u);
  };
  auto decode = [&](uint2 cube) {
    const uint32_t fx = ~cube.y & nmask;
    StagedCube<MAXN> sc;
#pragma unroll
    for (int q = 0; q < MAXN / 4; ++q) {
      uint32_t state = 0u;
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const int p = 4 * q + i;
        state = 3u * state
                + (((fx >> p) & 1u) ? 1u + ((cube.x >> p) & 1u) : 0u);
      }
      sc.off[q] = (q * kStates + state) * kTile * sizeof(uint32_t);
    }
    mine[lane] = sc;
    __syncwarp();
  };
  auto mismatch = [&](int i) {
    const StagedCube<MAXN> sc = mine[i];
    uint2 m = make_uint2(0u, 0u);
#pragma unroll
    for (int q = 0; q < MAXN / 4; ++q) {
      const uint2 v = *reinterpret_cast<const uint2*>(colb + sc.off[q]);
      m.x |= v.x;
      m.y |= v.y;
    }
    return m;
  };

  decode(fetch(c0));
  __syncthreads();                            // the table is built
  const int chunks = static_cast<int>((c1 - c0 + kChunk - 1) / kChunk);
  for (int q = 0; q < chunks; ++q) {
    const long long base = c0 + static_cast<long long>(q) * kChunk;
    const uint2 next = fetch(base + kChunk);  // in flight meanwhile
    const int cnt = static_cast<int>(min(static_cast<long long>(kChunk),
                                         c1 - base));
    int t = 0;
    while (t < cnt) {
      const int lim = static_cast<int>(min(static_cast<long long>(cnt),
                                           fend - base));
      // cubes [t, lim) are one filter's; this warp's are u = warp mod
      // kWarps, its entries u / kWarps
      int i = (t + kWarps - 1 - warp) / kWarps;
      const int end = (lim + kWarps - 1 - warp) / kWarps;
      for (; i + 4 <= end; i += 4) {            // four cubes in flight
        const uint2 m0 = mismatch(i), m1 = mismatch(i + 1);
        const uint2 m2 = mismatch(i + 2), m3 = mismatch(i + 3);
        acc.x |= ~m0.x | ~m1.x | ~m2.x | ~m3.x;
        acc.y |= ~m0.y | ~m1.y | ~m2.y | ~m3.y;
      }
      for (; i < end; ++i) {
        const uint2 m = mismatch(i);
        acc.x |= ~m.x;
        acc.y |= ~m.y;
      }
      t = lim;
      if (t < cnt) {              // cube base + t starts the next cover
        combine(acc, out + static_cast<long long>(j) * W, W, w, invert);
        do {
          ++j;
          fend = __ldg(offsets + j + 1);
        } while (fend <= base + t);             // skip empty covers
        if (j / F != g) {
          g = j / F;
          __syncthreads();                      // the old table is read
          build_table<MAXN>(tab, planes, g, n, W, w);
          __syncthreads();
        }
      }
    }
    __syncwarp();                               // this chunk's entries read
    if (q + 1 < chunks) decode(next);
  }
  combine(acc, out + static_cast<long long>(j) * W, W, w, invert);
}

// resident blocks of card `dev`, the current one: the kernel's shared
// memory (above 48 KB for n > 16) allowed and preferred over L1.  Function
// attributes belong to the card's context, so each card is set up itself
template <int MAXN>
int resident_blocks(int dev) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(gate_cubes_kernel<MAXN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes<MAXN>()));
  cudaFuncSetAttribute(gate_cubes_kernel<MAXN>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gate_cubes_kernel<MAXN>, kThreads, smem_bytes<MAXN>());
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

// S, the runs the flat cube array is cut into: at least kWaves waves of
// resident blocks over the word tiles, raised until the last wave is at
// least 90 % full (every block walks as many cubes as any other)
constexpr int kMaxDevices = 64;

// resident_blocks of the current card, set up once a card (0: not yet; two
// threads that set one card up at once set the same attributes)
template <int MAXN>
int card_slots() {
  static std::atomic<int> slots[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return resident_blocks<MAXN>(dev);
  int n = slots[dev].load(std::memory_order_acquire);
  if (n == 0) {
    n = resident_blocks<MAXN>(dev);
    slots[dev].store(n, std::memory_order_release);
  }
  return n;
}

template <int MAXN>
long long runs_t(long long W) {
  const int slots = card_slots<MAXN>();
  const long long tiles = (W + kTile - 1) / kTile;
  long long s = kWaves * static_cast<long long>(slots) / tiles;
  if (s < 1) s = 1;
  for (long long c = s; c <= 4 * s && c <= 65535; ++c) {
    const long long waves = (tiles * c + slots - 1) / slots;
    if (tiles * c * 10 >= waves * slots * 9) return c;
  }
  return s > 65535 ? 65535 : s;
}

template <int MAXN>
int launch_t(const uint32_t* planes, const uint2* cubes,
             const long long* offsets, uint32_t* out, int G, int F, int n,
             long long W, int invert, cudaStream_t s) {
  const long long tiles = (W + kTile - 1) / kTile;
  const int S = static_cast<int>(runs_t<MAXN>(W));
  cudaError_t err = cudaMemsetAsync(
      out, invert ? 0xFF : 0x00,
      static_cast<size_t>(G) * F * W * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(S));
  gate_cubes_kernel<MAXN><<<grid, kThreads, smem_bytes<MAXN>(), s>>>(
      planes, cubes, offsets, out, G * F, F, n, static_cast<int>(W), S,
      invert);
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
  if (G <= 0 || F <= 0 || n <= 0 || n > 32 || W < 0
      || static_cast<long long>(G) * F > 0x7FFFFFFFLL
      || W > 0x7FFFFFFFLL - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto pl = static_cast<const uint32_t*>(planes);
  auto cb = static_cast<const uint2*>(cubes);
  auto of = static_cast<const long long*>(offsets);
  auto o = static_cast<uint32_t*>(out);
  if (n <= 8) return launch_t<8>(pl, cb, of, o, G, F, n, W, invert, s);
  if (n <= 16) return launch_t<16>(pl, cb, of, o, G, F, n, W, invert, s);
  return launch_t<32>(pl, cb, of, o, G, F, n, W, invert, s);
}

// S for a launch of n bits and W words on the current card: run s of the
// flat cube array is cubes [T*s/S, T*(s+1)/S) (for tests)
extern "C" long long gate_cubes_segments(int n, long long W) {
  if (n <= 0 || n > 32 || W <= 0) return -1;
  if (n <= 8) return runs_t<8>(W);
  if (n <= 16) return runs_t<16>(W);
  return runs_t<32>(W);
}
