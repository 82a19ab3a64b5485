// The window-min core of the three signing kernels (cminhash_sparse.cu,
// cminhash_dense.cu, cminhash_packed.cu).
//
// Each kernel computes, for one row and hash q in [0, K),
//     h[q] = min over positions p in P of pi[(p - q - off) mod D],
// where P is the row's set of positions in [0, D): the valid indices of a
// sparse document, or the set entries (or set bits) of a dense row.  A warp owns one row
// and all its hashes: lane l holds q = q0 + l + 32 j for j < H in
// registers.  H is 2, 8, 16 or 32 (K <= 64, 256, 512, 1024: Fig. 7's K
// and the serving K each have their own; a K in between computes the
// hashes up to the next one and stores K), and K > 1024 makes passes of
// 1024 over q0.  The row's positions are compacted into a list in
// the warp's slice of shared memory (append1 / append_mask), and fold_list
// folds pi over the list for all the warp's hashes at once: per position a
// broadcast read of the list (four positions per 16-byte read), then per
// hash one table read and one min.  The 32 lanes of a warp read 32
// consecutive table entries, so a table read in shared memory is one
// conflict-free wavefront.
//
// pi must be a permutation of [0, D), or at least hold values in [0, D):
// the shared tables keep it as uint16 and the pair table marks a row with
// no position by 0xffff, so a value outside gives other codes than the
// plain version.  The port's permutations satisfy it: make_two_permutations
// draws them; convert.permutations_from_jax and SketchEngine's params=
// check them.
//
// Where pi lives (the kernels' launch functions pick one per call, unless
// the caller names one: kernels/autotune.py's signing kinds):
//   kPairs     uint16 pairs in shared memory, when 4 bytes an entry fit
//              beside the lists (D + ext <= 41,663) and K > 64: two
//              copies of the uint16 table as 32-bit words, one shifted by
//              an entry, so that one 4-byte read gives the
//              entries of two consecutive hashes whatever the parity of
//              p - q; the lane holds q = q0 + 2 l + 64 j and q + 1 packed
//              in one register and folds both with one __vminu2.  A warp's
//              32 reads are then one wavefront for 64 hashes, not 32.
//   kShared16  uint16 in shared memory for D <= 65,536 (pi's values are < D,
//              so they fit exactly): 128 KiB at D = 2^16, one block per SM.
//              An int32 table measured the same where both fit, and fits
//              only where this one does, so there is none;
//   kGlobal32  pi as it is in global memory, behind the read-only cache, for
//              D > 65,536 or when no shared table fits (K in the tens of
//              thousands).
// A shared table is staged once per block (the blocks are persistent: grid =
// resident blocks, rows taken grid-stride), and extended circularly by ext =
// passes * 32 * H + off entries in front, tab[t] = pi[(t - ext) mod D], so
// that p - q - off + ext is never negative: the inner step has no wrap, and
// the per-hash offsets -32 j are immediates of the shared load.  The global
// table has no extended copy and wraps each read instead (two conditional
// adds: the lanes past K of the last pass may reach one more D below 0).

#pragma once

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

#include "pack_epilogue.cuh"

namespace wfold {

using cminhash::kSentinel;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;                 // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCap = 1024;                 // list entries per warp
constexpr int kSlot = kCap + 4;            // + room to pad to a multiple of 4
constexpr int kMaxH = 32;                  // hashes a lane holds: K <= 1024
constexpr int kListBytes = kWarps * kSlot * 4;

// The pair table from 8 hashes a lane (K > 64): at 2 (K = 64, Fig. 7) it
// measured 9% slower than the plain uint16 table (PERF.md), its
// per-position word select not amortised over enough reads.
constexpr int kPairsMinH = 8;

enum Placement : int { kShared16 = 0, kGlobal32 = 1, kPairs = 2 };
constexpr int kPlacements = 3;

// Hashes a lane holds per pass: the fewest of 2, 8, 16, 32 that cover K.
inline int lane_hashes(int K) {
  return K <= 64 ? 2 : K <= 256 ? 8 : K <= 512 ? 16 : kMaxH;
}

// Entries in front of pi[0] in a shared table: every hash slot the passes
// cover (past K too, on the last pass), plus off.
inline int table_ext(int K, int off) {
  const int span = 32 * lane_hashes(K);
  return (K + span - 1) / span * span + off;
}

// A table read per hash: lane l holds q = q0 + l + 32 j in h[j].
struct LaneHashes {
  template <int H>
  __device__ __forceinline__ void init(int (&h)[H]) const {
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = kSentinel;
  }

  // The codes through the pack epilogue.
  template <int H>
  __device__ __forceinline__ void store(int* __restrict__ out_row, int q0,
                                        int K, const int (&h)[H],
                                        int pack_b) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < H; ++j)
      if (q0 + 32 * j < K)                   // uniform across the warp
        cminhash::store_codes(out_row, q0 + lane + 32 * j, K, h[j], pack_b);
  }
};

struct SharedTable : LaneHashes {
  const unsigned short* tab;               // tab[t] = pi[(t - ext) mod D]
  int ext;

  __device__ __forceinline__ int start(int q0, int off) const {
    return ext - q0 - (threadIdx.x & 31) - off;
  }

  template <int H>
  __device__ __forceinline__ void fold(int s, int (&h)[H]) const {
#pragma unroll
    for (int j = 0; j < H; ++j)
      h[j] = min(h[j], static_cast<int>(tab[s - 32 * j]));
  }
};

struct GlobalTable : LaneHashes {
  const int* __restrict__ pi;
  int D;

  __device__ __forceinline__ int start(int q0, int off) const {
    return -q0 - (threadIdx.x & 31) - off;
  }

  template <int H>
  __device__ __forceinline__ void fold(int s, int (&h)[H]) const {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      int m = s - 32 * j;                  // >= -2D
      if (m < 0) m += D;
      if (m < 0) m += D;
      h[j] = min(h[j], __ldg(pi + m));
    }
  }
};

// Two hashes per read: lane l holds q = q0 + 2 l + 64 j in the high half
// of h[j] and q + 1 in the low half, j < H / 2.  a[w] = tab[2w] |
// tab[2w+1] << 16 and b[w] = tab[2w+1] | tab[2w+2] << 16, with tab as in
// SharedTable (uint16).  For u = p + ext - off - q0 - 1 the pair of hash q
// is the word u / 2 - l - 32 j of a (u even) or of b (u odd): low half
// tab[t(q + 1)], high half tab[t(q)], t(q) = p - q - off + ext.  pi's
// values are < D <= 41,664, so 0xffff marks a row with no position.
struct PairTable {
  const unsigned* a;
  const unsigned* b;
  int ext;
  int lane;

  template <int H>
  __device__ __forceinline__ void init(int (&h)[H]) const {
#pragma unroll
    for (int j = 0; j < H / 2; ++j) h[j] = -1;
  }

  __device__ __forceinline__ int start(int q0, int off) const {
    return ext - off - q0 - 1;
  }

  template <int H>
  __device__ __forceinline__ void fold(int u, int (&h)[H]) const {
    const unsigned* words = (u & 1) ? b : a;
    const int w = (u >> 1) - lane;
#pragma unroll
    for (int j = 0; j < H / 2; ++j)
      h[j] = static_cast<int>(
          __vminu2(static_cast<unsigned>(h[j]), words[w - 32 * j]));
  }

  // Hash q0 + 32 g + lane sits in lane 16 (g % 2) + lane / 2 of pair
  // g / 2, in the low half for an odd lane.
  template <int H>
  __device__ __forceinline__ void store(int* __restrict__ out_row, int q0,
                                        int K, const int (&h)[H],
                                        int pack_b) const {
#pragma unroll
    for (int g = 0; g < H; ++g) {
      if (q0 + 32 * g >= K) break;           // uniform across the warp
      const unsigned x = __shfl_sync(kFull, static_cast<unsigned>(h[g / 2]),
                                     16 * (g & 1) + lane / 2);
      const unsigned v = (lane & 1) ? x & 0xffffu : x >> 16;
      cminhash::store_codes(out_row, q0 + 32 * g + lane, K,
                            v == 0xffffu ? kSentinel : static_cast<int>(v),
                            pack_b);
    }
  }
};

// pi[(t - ext) mod D] for t in [0, D + ext + 2]: one add for all but a
// tiny D, where ext may span D many times.
__device__ __forceinline__ int table_entry(const int* __restrict__ pi, int D,
                                           int ext, int t) {
  int m = t - ext;
  while (m < 0) m += D;
  while (m >= D) m -= D;
  return __ldg(pi + m);
}

// Loads in flight a thread while staging: the table is read once per
// block from L2, and a loop of one load at a time would wait out the L2's
// latency for every entry (~30 us for 2^16 entries over 512 threads).
constexpr int kStageUnroll = 16;

// Stage the extended uint16 table into shared memory; the whole block calls
// it.  Where pi is 16-byte aligned and D % 4 == 0, its body, tab[ext + m]
// = pi[m], is copied with 16-byte loads, and only the ext entries in front
// go one at a time.
__device__ void stage_table(unsigned short* tab, const int* __restrict__ pi,
                            int D, int ext) {
  const int nt = blockDim.x;
  int n = D + ext;
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(pi) % 16 == 0) {
    const int4* __restrict__ pi4 = reinterpret_cast<const int4*>(pi);
    constexpr int kU = kStageUnroll / 2;     // 4 entries a load
    for (int c0 = threadIdx.x; c0 < D / 4; c0 += nt * kU) {
      int4 e[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * nt;
        e[u] = c < D / 4 ? __ldg(pi4 + c) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = c0 + u * nt;
        if (c < D / 4) {
          unsigned short* t = tab + ext + 4 * c;
          t[0] = static_cast<unsigned short>(e[u].x);
          t[1] = static_cast<unsigned short>(e[u].y);
          t[2] = static_cast<unsigned short>(e[u].z);
          t[3] = static_cast<unsigned short>(e[u].w);
        }
      }
    }
    n = ext;                                 // the front is left
  }
  for (int t0 = threadIdx.x; t0 < n; t0 += nt * kStageUnroll) {
    int e[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int t = t0 + u * nt;
      e[u] = t < n ? table_entry(pi, D, ext, t) : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int t = t0 + u * nt;
      if (t < n) tab[t] = static_cast<unsigned short>(e[u]);
    }
  }
  __syncthreads();
}

// Words of a pair table: enough for u / 2 <= (D + ext) / 2.
__host__ __device__ inline int pair_words(int D, int ext) {
  return (D + ext) / 2 + 1;
}

// Stage a pair table's two copies; the whole block calls it.
__device__ void stage_pairs(unsigned* a, unsigned* b,
                            const int* __restrict__ pi, int D, int ext) {
  const int nw = pair_words(D, ext), nt = blockDim.x;
  constexpr int kU = kStageUnroll / 2;
  for (int w0 = threadIdx.x; w0 < nw; w0 += nt * kU) {
    unsigned e[kU][3];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int w = min(w0 + u * nt, nw - 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) e[u][k] = table_entry(pi, D, ext, 2 * w + k);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int w = w0 + u * nt;
      if (w < nw) {
        a[w] = e[u][0] | e[u][1] << 16;
        b[w] = e[u][1] | e[u][2] << 16;
      }
    }
  }
  __syncthreads();
}

// One position per lane: lanes with `set` append p; returns the new count.
__device__ __forceinline__ int append1(int* list, int n, bool set, int p) {
  const unsigned bal = __ballot_sync(kFull, set);
  const int lane = threadIdx.x & 31;
  if (set) list[n + __popc(bal & ((1u << lane) - 1u))] = p;
  return n + __popc(bal);
}

// Up to 32 positions per lane: bit i of `mask` appends p0 + i.
__device__ __forceinline__ int append_mask(int* list, int n, unsigned mask,
                                           int p0) {
  if (__ballot_sync(kFull, mask != 0) == 0) return n;
  const int lane = threadIdx.x & 31;
  const int c = __popc(mask);
  int incl = c;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += t;
  }
  int slot = n + incl - c;
  while (mask) {
    list[slot++] = p0 + __ffs(mask) - 1;
    mask &= mask - 1u;
  }
  return n + __shfl_sync(kFull, incl, 31);
}

// Folds the table over the warp's n listed positions into h (n
// warp-uniform; s0 = tab.start(q0, off)).  Pads the list to a multiple of
// four with copies of its first entry (a min does not change).
template <int H, class Table>
__device__ __forceinline__ void fold_list(int* list, int n, const Table& tab,
                                          int s0, int (&h)[H]) {
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  const int n4 = (n + 3) & ~3;
  __syncwarp();
  if (lane < n4 - n) list[n + lane] = list[0];
  __syncwarp();
  const int4* l4 = reinterpret_cast<const int4*>(list);
  for (int i = 0; i < n4 / 4; ++i) {
    const int4 p = l4[i];
    tab.template fold<H>(p.x + s0, h);
    tab.template fold<H>(p.y + s0, h);
    tab.template fold<H>(p.z + s0, h);
    tab.template fold<H>(p.w + s0, h);
  }
  __syncwarp();                              // the list is consumed
}

// Shared bytes a placement needs: the table (if any) and the warps' lists.
inline size_t shared_bytes(int placement, int D, int ext) {
  const size_t n = static_cast<size_t>(D) + ext;
  if (placement == kShared16) return n * 2 + kListBytes;
  if (placement == kPairs) return size_t(pair_words(D, ext)) * 8 + kListBytes;
  return kListBytes;
}

// A placement every launch takes instead of its own choice and the
// caller's, -1 for none: set only through the kernels' test entry points,
// to hold each placement against the plain version and to time it.
inline std::atomic<int>& forced_placement() {
  static std::atomic<int> p{-1};
  return p;
}

// What the runtime says of one shape: SMs, and resident blocks per SM of
// each placement's kernel (0 where it is not offered or does not fit).
struct Fit {
  int sms;
  int per[kPlacements];
};

// The Fit of (device, kernel set, D, ext), asked of the runtime at the
// first launch of that shape only.  Each offered kernel's dynamic shared
// limit is raised to the most a block may have, once, so a shape never
// finds a limit set for a smaller one.  kernels[p] is the instantiation
// for placement p, nullptr where there is none.
template <typename Kernel>
inline cudaError_t fit(const Kernel (&kernels)[kPlacements], int D, int ext,
                       Fit* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, Fit> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(
      dev, reinterpret_cast<const void*>(kernels[0]), D, ext);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int optin = 0;
  Fit f = {0, {0, 0, 0}};
  e = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  for (int p = 0; p < kPlacements; ++p) {
    const size_t bytes = shared_bytes(p, D, ext);
    if (kernels[p] == nullptr || bytes > size_t(optin) ||
        (p == kShared16 && D > 65536))
      continue;
    e = cudaFuncSetAttribute(kernels[p],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per[p], kernels[p],
                                                      kThreads, bytes);
    if (e != cudaSuccess) return e;
  }
  seen.emplace(key, f);
  *out = f;
  return cudaSuccess;
}

struct Plan {
  int placement;
  size_t smem;                               // dynamic shared bytes
  int grid;                                  // resident blocks, at most
};

// Pick the placement for one call and size the persistent grid: the
// caller's `requested` placement (0, 1, 2; -1 for none), else the pair
// table where it is offered (K > 64) and keeps as many blocks per SM as
// the uint16 table would; else the uint16 table where D <= 65,536 and it
// fits; else global.  A requested placement that is not offered or does
// not fit is refused, never replaced.
template <typename Kernel>
inline cudaError_t plan_launch(const Kernel (&kernels)[kPlacements], int D,
                               int ext, long long rows, int requested,
                               Plan* plan) {
  if (requested < -1 || requested >= kPlacements)
    return cudaErrorInvalidValue;
  Fit f;
  const cudaError_t e = fit(kernels, D, ext, &f);
  if (e != cudaSuccess) return e;
  int p = forced_placement().load(std::memory_order_relaxed);
  if (p < 0) p = requested;
  if (p < 0)
    p = f.per[kPairs] > 0 && f.per[kPairs] >= f.per[kShared16] ? kPairs
        : f.per[kShared16] > 0                                 ? kShared16
                                                               : kGlobal32;
  if (p >= kPlacements || f.per[p] == 0) return cudaErrorInvalidConfiguration;
  long long grid = (rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(f.per[p]) * f.sms;
  if (grid > cap) grid = cap;
  plan->placement = p;
  plan->smem = shared_bytes(p, D, ext);
  plan->grid = static_cast<int>(grid);
  return cudaSuccess;
}

template <int P> struct TableOf { using type = GlobalTable; };
template <> struct TableOf<kShared16> { using type = SharedTable; };
template <> struct TableOf<kPairs> { using type = PairTable; };

// The block's table: staged into `mem` (dynamic shared memory past the
// lists) for a shared placement.  The whole block calls it.
template <int P>
__device__ __forceinline__ typename TableOf<P>::type make_table(
    void* mem, const int* __restrict__ pi, int D, int ext) {
  if constexpr (P == kShared16) {
    unsigned short* t = static_cast<unsigned short*>(mem);
    stage_table(t, pi, D, ext);
    return {{}, t, ext};
  } else if constexpr (P == kPairs) {
    unsigned* a = static_cast<unsigned*>(mem);
    unsigned* b = a + pair_words(D, ext);
    stage_pairs(a, b, pi, D, ext);
    return {a, b, ext, static_cast<int>(threadIdx.x & 31)};
  } else {
    return {{}, pi, D};
  }
}

}  // namespace wfold
