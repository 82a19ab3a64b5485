// LSH bucket probe: each shard's candidate leg of a query batch.
//
// Replaces the Pallas probe kernel of the JAX package:
//   src/repro/kernels/lsh_probe.py  _probe_kernel (:112) and
//   lsh_probe_pallas (:137; pallas_call at :155).
//
// Computes, for each entry e (one (query, band) pair) with operands
// meta[e] = [band * n_slots, base slot, key_lo, key_hi, valid], the
// quadratic probe slot_t = (base + t(t+1)/2) mod n_slots, t < max_probes,
// over the fused records (n_bands * n_slots, 2 + W) int32, and writes the
// W posting ids of the slot whose key halves match, or W times -1.  Entries
// with valid = 0 (the all-ones sentinel hash) never hit.  The walk stops at
// the matching slot or at the first unused slot (key halves -1, -1): slots
// are never freed and inserts walk the same chain, so no record of a key
// sits past an unused slot on its chain, and this early exit gives the
// same answer as the reference's fixed-depth branchless probe.
//
// What bounds it on an H100: latency.  The TPU kernel keeps the records in
// VMEM; at serving size they are 32 bands * 2^19 slots * 10 int32 = 640 MiB
// and live in HBM, and each probe step is one dependent random 40-byte
// gather, so the kernel waits on memory latency, not on bandwidth.  The
// design keeps many independent entries in flight (one thread per entry,
// 256 threads per block, 34816 entries for a 1088-query batch), reads the
// two key halves as one 8-byte load, and reads the W posting ids only for
// the slot that matched.  W = records.shape[1] - 2 is a runtime argument,
// since the bucket width grows on rebuild.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lsh_probe_kernel(const int* __restrict__ records, const int* __restrict__ meta,
                 int* __restrict__ out, long long n_entries, int n_slots,
                 int max_probes, int W) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int* __restrict__ m = meta + e * 5;
  const long long lin = __ldg(m + 0);
  const int base = __ldg(m + 1);
  const int klo = __ldg(m + 2), khi = __ldg(m + 3);
  const bool valid = __ldg(m + 4) != 0;
  const int stride = 2 + W;
  long long hit = -1;
  if (valid) {
    for (int t = 0; t < max_probes; ++t) {
      const long long off = (long long)t * (t + 1) / 2;
      const long long slot = (base + off) % n_slots;
      const int* __restrict__ rec = records + (lin + slot) * stride;
      int k0, k1;
      if ((stride & 1) == 0) {         // 8-byte aligned: one load for both
        const int2 k = __ldg(reinterpret_cast<const int2*>(rec));
        k0 = k.x;
        k1 = k.y;
      } else {
        k0 = __ldg(rec);
        k1 = __ldg(rec + 1);
      }
      if (k0 == klo && k1 == khi) {
        hit = lin + slot;
        break;
      }
      if (k0 == -1 && k1 == -1) break;  // unused slot: key absent
    }
  }
  int* __restrict__ o = out + e * W;
  if (hit < 0) {
    for (int w = 0; w < W; ++w) o[w] = -1;
  } else {
    const int* __restrict__ ids = records + hit * stride + 2;
    for (int w = 0; w < W; ++w) o[w] = __ldg(ids + w);
  }
}

}  // namespace

extern "C" int lsh_probe_launch(const int* records, const int* meta, int* out,
                                long long n_entries, int n_slots,
                                int max_probes, int W, void* stream) {
  if (n_entries == 0) return cudaSuccess;
  const long long grid = (n_entries + kThreads - 1) / kThreads;
  lsh_probe_kernel<<<unsigned(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      records, meta, out, n_entries, n_slots, max_probes, W);
  return cudaGetLastError();
}

extern "C" const char* lsh_probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
