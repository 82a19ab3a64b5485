// LSH bucket probe: each shard's candidate leg of a query batch.
//
// Replaces the Pallas probe kernel of the JAX package:
//   src/repro/kernels/lsh_probe.py  _probe_kernel (:112) and
//   lsh_probe_pallas (:137; pallas_call at :155).
//
// Computes, for each entry e (one (query, band) pair, row-major by query),
// from the entry's uint64 band hash `key`:
//     band = e % n_bands,  base = key mod n_slots (unsigned),
//     key halves (low half first: the records' little-endian int32 view),
//     valid = key != 0xFFFF...FFFF (the empty-slot sentinel never matches),
// then walks the quadratic probe slot_t = (base + t(t+1)/2) mod n_slots,
// t < max_probes, over the fused records (n_bands * n_slots, 2 + W) int32,
// and writes the W posting ids of the slot whose key halves match, or W
// times -1.  The walk stops at the matching slot or at the first unused
// slot (key halves -1, -1): slots are never freed and inserts walk the same
// chain, so no record of a key sits past an unused slot on its chain, and
// the early exit gives the reference's fixed-depth branchless probe.  The
// keys are (E,) int64 hashes where the fold kernel (fold.cu) wrote them, or
// where the host uploaded its own fold: every query leg folds, then probes.
//
// What bounds it on an H100: latency.  At serving size the records are 32
// bands * 2^19 slots * 10 int32 = 640 MiB, far past the 50 MB L2, so a
// record read is a DRAM round trip, and a walk is a chain of them; the
// function's own bytes (8 a hash, 8 a step's key, the W ids of a hit) take
// under a microsecond at 3.35 TB/s.  The earlier kernel ran a thread an entry
// on host-built operand rows: the row, then one dependent read a step, then
// the hit's ids.  This design cuts the dependent reads:
//   * A group of G lanes owns an entry (32 / G entries a warp), and reads
//     the entry's hash where the fold wrote it: 8 bytes, no operand row.
//   * The group walks S <= G probe steps a round trip: lane j loads the
//     key halves of step t0 + j (with S = 4, the first four offsets, 0, 1,
//     3 and 6, lie within 7 records), a ballot within the group finds the first
//     step whose key matches or whose slot is unused, and the lanes then
//     read the hit's W ids and write them coalesced.  Nearly every walk at
//     serving load ends in the first four steps (33,747 of 34,816 end at
//     step 0), so a walk costs the hash, one DRAM round trip for the keys
//     and a dependent read for the ids; longer chains take one round trip
//     per S steps.
//   * (G, S) is a launch argument among the compiled instances below
//     (kernels/autotune.py's "probe" kind picks one a call); (4, 4), 8
//     entries a warp and four steps a round trip, is the default.  Each slot is reduced mod n_slots on its own, so a
//     chain that wraps at the table's end takes no other path.
//   * Reading the ids of the four steps with their keys would save the
//     ids' dependent read, but measured slower at serving size: most walks
//     end at step 0, so the speculative ids read ~3x the sectors (counted
//     from the layout) for nothing.
//   * Record offsets are 64-bit.  With an even stride 2 + W (and 8-byte
//     aligned pointers) keys and ids move as 8-byte int2, else as int32.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // kThreads / kGroup entries a block

// kGroup: lanes an entry (a power of two, <= 16); kSteps: probe steps a
// round trip (<= kGroup).
template <int kGroup, int kSteps, bool kEven>
__global__ void __launch_bounds__(kThreads)
lsh_probe_kernel(const int* __restrict__ records,
                 const long long* __restrict__ hashes, int* __restrict__ out,
                 long long n_entries, int n_bands, int n_slots,
                 int max_probes, int W) {
  static_assert(kGroup <= 16 && (kGroup & (kGroup - 1)) == 0 &&
                    kSteps <= kGroup,
                "probe geometry");
  using Chunk = typename std::conditional<kEven, int2, int>::type;
  constexpr int kInts = kEven ? 2 : 1;
  const int lane = threadIdx.x & (kGroup - 1);
  const long long e =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (e >= n_entries) return;                 // whole groups leave together
  const unsigned shift = threadIdx.x & 31 & ~(kGroup - 1);
  const unsigned group = ((1u << kGroup) - 1) << shift;

  const unsigned long long key =
      static_cast<unsigned long long>(__ldg(hashes + e));
  const int stride = 2 + W;
  const int cw = W / kInts;                   // id chunks a record
  Chunk* __restrict__ o = reinterpret_cast<Chunk*>(out + e * W);
  bool hit = false;
  if (key != ~0ull) {
    const unsigned long long ns = static_cast<unsigned>(n_slots);
    const unsigned long long base =
        (ns & (ns - 1)) == 0 ? key & (ns - 1) : key % ns;
    const int* __restrict__ band_records =
        records + (long long)(e % n_bands) * n_slots * stride;
    const int klo = static_cast<int>(static_cast<unsigned>(key));
    const int khi = static_cast<int>(key >> 32);
    for (int t0 = 0; t0 < max_probes; t0 += kSteps) {
      const int n = min(kSteps, max_probes - t0);
      auto record = [&](int j) {              // the record of step t0 + j
        const long long t = t0 + j;
        unsigned long long s = base + static_cast<unsigned long long>(
                                          t * (t + 1) / 2);
        if (s >= ns) s %= ns;
        return band_records + static_cast<long long>(s) * stride;
      };
      // every load of the round trip is issued before any is used
      int k0 = 0, k1 = 0;
      if (lane < n) {
        const int* __restrict__ r = record(lane);
        if constexpr (kEven) {
          const int2 k = __ldg(reinterpret_cast<const int2*>(r));
          k0 = k.x;
          k1 = k.y;
        } else {
          k0 = __ldg(r);
          k1 = __ldg(r + 1);
        }
      }
      const bool match = lane < n && k0 == klo && k1 == khi;
      const bool unused = lane < n && k0 == -1 && k1 == -1;
      const unsigned hits = __ballot_sync(group, match) >> shift;
      const unsigned ends = __ballot_sync(group, match || unused) >> shift;
      if (ends == 0) continue;                // the chain goes on
      const int first = __ffs(ends) - 1;
      if (!((hits >> first) & 1u)) break;     // unused slot: key absent
      hit = true;
      const Chunk* __restrict__ src =
          reinterpret_cast<const Chunk*>(record(first) + 2);
      for (int p = lane; p < cw; p += kGroup) o[p] = __ldg(src + p);
      break;
    }
  }
  if (!hit) {
    Chunk none;
    if constexpr (kEven) none = make_int2(-1, -1);
    else none = -1;
    for (int p = lane; p < cw; p += kGroup) o[p] = none;
  }
}

template <int kGroup, int kSteps>
int launch(const int* records, const long long* hashes, int* out,
           long long n_entries, int n_bands, int n_slots, int max_probes,
           int W, void* stream) {
  const long long grid = (n_entries * kGroup + kThreads - 1) / kThreads;
  const bool even = W % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(records) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (even)
    lsh_probe_kernel<kGroup, kSteps, true><<<unsigned(grid), kThreads, 0, s>>>(
        records, hashes, out, n_entries, n_bands, n_slots, max_probes, W);
  else
    lsh_probe_kernel<kGroup, kSteps, false><<<unsigned(grid), kThreads, 0, s>>>(
        records, hashes, out, n_entries, n_bands, n_slots, max_probes, W);
  return cudaGetLastError();
}

}  // namespace

// (E,) int64 band hashes (uint64 bits, row-major by (query, band)) ->
// (E, W) candidate ids.  (group, steps) must be one of the compiled
// instances; any other pair is refused.
extern "C" int lsh_probe_launch(const int* records, const long long* hashes,
                                int* out, long long n_entries, int n_bands,
                                int n_slots, int max_probes, int W,
                                int group, int steps, void* stream) {
  using Launch = int (*)(const int*, const long long*, int*, long long, int,
                         int, int, int, void*);
  struct Instance {
    int group, steps;
    Launch fn;
  };
  static constexpr Instance kInstances[] = {
      {2, 2, launch<2, 2>},   {4, 2, launch<4, 2>},   {4, 4, launch<4, 4>},
      {8, 4, launch<8, 4>},   {8, 8, launch<8, 8>},   {16, 8, launch<16, 8>}};
  for (const Instance& i : kInstances)
    if (i.group == group && i.steps == steps)
      return n_entries == 0 ? cudaSuccess
                            : i.fn(records, hashes, out, n_entries, n_bands,
                                   n_slots, max_probes, W, stream);
  return cudaErrorInvalidValue;
}

extern "C" const char* lsh_probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
