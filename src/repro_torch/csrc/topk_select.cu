// Top-k select over rows of counts: the brute-force fallback's ranking.
//
// Replaces no TPU kernel.  The JAX package ranks on the host, with a full
// stable argsort of each row's scores (src/repro/store/planner.py _rank,
// np.argsort(-scored, kind="stable") at :187), which the port had carried
// over as a full stable sort on the card.  The answer is only each row's
// first kk columns in that order, so this kernel selects them instead.
//
// For each row of a (Q, U) int32 count matrix, writes the kk largest
// counts and their columns, ordered count descending, then column
// ascending: the order of a stable sort of -count over the columns.  The
// order is one 64-bit key, ((count + 1) << 32) | (0xFFFFFFFF - column),
// compared as unsigned: it is exact for counts in [-1, 2^31 - 1] (the
// candidate path masks non-candidates to -1, whose key has 0 above) and
// columns below 2^32 - 1, and a real key is never 0, the empty slot.
//
// What bounds it on an H100: bytes.  Every count is read once, 4 bytes, and
// compared a few times: the fallback's 1,240 x 262,144 real rows are 1.30
// GB, 0.39 ms at 3.35 TB/s; kk values and columns out are nothing beside
// that.  The full sort read and wrote the keys and int64 indices several
// times (36.9 ms a web batch).
//
// The design: one block of 256 threads a row.  Threads stride the row in
// increasing column order, with 16-byte streaming loads (four in flight a
// thread) where the row is 16-byte aligned and scalar loads at its ragged
// head and tail (a row of U = 69,363 counts starts anywhere mod 16).  Each
// thread keeps its best KMAX keys, sorted, in registers (KMAX = 8, 16 or
// 32, the least instance that holds the pass's keys).  A key enters the
// list only if it beats the thread's bar, a key with kk keys of the row
// known at or above it: the list's last entry; after every 16 counts a
// thread, the warp's highest last entry; after 16, 32 and 64 counts a
// thread, the kk-th largest head of the block's lists (kk rounds of a
// block-wide maximum).
// An insert is ~KMAX selects and diverges the warp, and where a thread
// sees few counts (MovieLens's 271 a thread) its own list alone lets most
// steps insert: the block's bar took the 500 x 69,363 select from 0.28 ms
// to 0.08, and the web select to within 13% of its bound on every
// distribution tried.
// Within a thread a later column of an equal count has a smaller key, so
// once the bar is up almost no load inserts, and the loop is a load and a
// compare a count.  A thread holds at most kk of the row's kk best, and
// every one of them passes its bar and stays in its list.  Then kk rounds
// of a block-wide maximum of the lists' heads (warp shuffles, then the 8
// warps' maxima through shared memory, double-buffered so a round takes
// one barrier) pop the winners in order; thread 0 writes each.  The bar is
// read from the lists' fixed last entry, never best[kk - 1]: a register
// array indexed by a runtime value goes to local memory (it did, and
// slowed the select twofold).
//
// A kk above 32 takes passes of at most 32 keys, each a launch over the
// whole row: a pass after the first reads the row's last key written so
// far, from the outputs, as a ceiling, and offers only keys below it.
// Each pass is exact, since every key is distinct (its column is in it),
// and reads the counts once more.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread

__device__ __forceinline__ uint64_t make_key(int count, int64_t col) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(count) + 1u) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(col));
}

__device__ __forceinline__ uint64_t umax(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// Insert key into best[] (descending) if it beats the bar, bar >=
// best[KMAX - 1] (a key at or below it cannot be among the pass's keys),
// and, with CEIL, lies below the ceiling (the keys of the earlier passes).
template <int KMAX, bool CEIL>
__device__ __forceinline__ void offer(uint64_t (&best)[KMAX], uint64_t& bar,
                                      uint64_t cap, uint64_t key) {
  if (key <= bar || (CEIL && key >= cap)) return;
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j)
    best[j] = key > best[j - 1] ? best[j - 1]
                                : (key > best[j] ? key : best[j]);
  best[0] = umax(key, best[0]);
  bar = umax(bar, best[KMAX - 1]);
}

template <int KMAX, bool CEIL>
__device__ __forceinline__ void offer4(uint64_t (&best)[KMAX], uint64_t& bar,
                                       uint64_t cap, int4 v, int64_t col) {
  offer<KMAX, CEIL>(best, bar, cap, make_key(v.x, col));
  offer<KMAX, CEIL>(best, bar, cap, make_key(v.y, col + 1));
  offer<KMAX, CEIL>(best, bar, cap, make_key(v.z, col + 2));
  offer<KMAX, CEIL>(best, bar, cap, make_key(v.w, col + 3));
}

__device__ __forceinline__ uint64_t warp_max(uint64_t m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = umax(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  return m;
}

// The block-wide maximum of m, through buf (2 x kWarps, double-buffered by
// round r's parity): one barrier.
__device__ __forceinline__ uint64_t block_max(uint64_t m, uint64_t* buf,
                                              int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* b = buf + (r & 1) * kWarps;
  m = warp_max(m);
  if (lane == 0) b[warp] = m;
  __syncthreads();
  m = b[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = umax(m, b[w]);
  return m;
}

// The kk-th largest of the block's list heads (0 if fewer are set): kk
// distinct keys of the row lie at or above it, so it is a bar for every
// thread.  Ends on a barrier, so buf is free again.
__device__ uint64_t block_kth_head(uint64_t head, int kk, uint64_t* buf) {
  uint64_t m = ~0ull;
  for (int r = 0; r < kk && m; ++r)        // m is the same in every thread
    m = block_max(head < m ? head : 0, buf, r);
  __syncthreads();
  return m;
}

// One pass: the row's kk keys after its first `start` (those below the
// ceiling, the start-th key, read back from the outputs), written to
// places start .. start + kk - 1 of the row's `stride` outputs.
template <int KMAX, bool CEIL>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const int* __restrict__ counts, int* __restrict__ values,
                   long long* __restrict__ cols, int64_t U, int kk,
                   int start, int stride) {
  const int64_t row = blockIdx.x;
  const int* p = counts + row * U;
  const int t = threadIdx.x;
  int* out_v = values + row * stride + start;
  long long* out_c = cols + row * stride + start;
  const uint64_t cap = CEIL ? make_key(out_v[-1], out_c[-1]) : ~0ull;
  uint64_t best[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) best[j] = 0;

  uint64_t bar = 0;

  // the ragged head: up to 3 scalars, until the row is 16-byte aligned
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
  if (head > U) head = U;
  if (t < head)
    offer<KMAX, CEIL>(best, bar, cap, make_key(__ldcs(p + t), t));
  const int64_t n4 = (U - head) >> 2;
  const int4* v = reinterpret_cast<const int4*>(p + head);
  __shared__ uint64_t buf[2 * kWarps];
  int64_t base = 0;                        // the same in every thread
  for (int it = 1; base + kUnroll * kThreads <= n4;
       base += kUnroll * kThreads, ++it) {
    int4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      a[u] = __ldcs(v + base + t + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      offer4<KMAX, CEIL>(best, bar, cap, a[u],
                         head + 4 * (base + t + u * kThreads));
    // Raise the bar: to the warp's highest KMAX-th best (its lane holds
    // KMAX >= kk keys above it) every 16 counts a thread, and to the kk-th
    // largest head of the block after 16, 32 and 64 counts a thread.
    bar = umax(bar, warp_max(best[KMAX - 1]));
    if (it == 1 || it == 2 || it == 4)
      bar = umax(bar, block_kth_head(best[0], kk, buf));
  }
  for (int64_t i = base + t; i < n4; i += kThreads)
    offer4<KMAX, CEIL>(best, bar, cap, __ldcs(v + i), head + 4 * i);
  // the ragged tail: up to 3 scalars
  const int64_t tail = head + 4 * n4 + t;
  if (tail < U)
    offer<KMAX, CEIL>(best, bar, cap, make_key(__ldcs(p + tail), tail));

  for (int r = 0; r < kk; ++r) {
    const uint64_t m = block_max(best[0], buf, r);
    if (best[0] == m) {                    // this thread's head won: pop it
#pragma unroll
      for (int j = 0; j + 1 < KMAX; ++j) best[j] = best[j + 1];
      best[KMAX - 1] = 0;
    }
    if (t == 0) {
      out_v[r] = static_cast<int>(static_cast<uint32_t>(m >> 32) - 1u);
      out_c[r] = 0xFFFFFFFFu - static_cast<uint32_t>(m);
    }
  }
}

template <bool CEIL>
void launch_pass(const int* counts, int* values, long long* cols, long long Q,
                 long long U, int n, int start, int kk, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(Q));
  if (n <= 8)
    topk_select_kernel<8, CEIL><<<grid, kThreads, 0, s>>>(
        counts, values, cols, U, n, start, kk);
  else if (n <= 16)
    topk_select_kernel<16, CEIL><<<grid, kThreads, 0, s>>>(
        counts, values, cols, U, n, start, kk);
  else
    topk_select_kernel<32, CEIL><<<grid, kThreads, 0, s>>>(
        counts, values, cols, U, n, start, kk);
}

}  // namespace

// counts: (Q, U) int32, row-major, 4-byte aligned.  values: (Q, kk) int32;
// cols: (Q, kk) int64.  1 <= kk <= U; kk above 32 takes ceil(kk / 32)
// passes, one launch each.
extern "C" int topk_select_launch(const int* counts, int* values,
                                  long long* cols, long long Q, long long U,
                                  int kk, void* stream) {
  if (Q == 0) return cudaSuccess;
  if (Q < 0 || Q > INT_MAX || U < 1 || U > 0xFFFFFFFFLL || kk < 1 || kk > U)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int start = 0; start < kk; start += 32) {
    const int n = kk - start < 32 ? kk - start : 32;
    if (start == 0)
      launch_pass<false>(counts, values, cols, Q, U, n, start, kk, s);
    else
      launch_pass<true>(counts, values, cols, Q, U, n, start, kk, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" const char* topk_select_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
