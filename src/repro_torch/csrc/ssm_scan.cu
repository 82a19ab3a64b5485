// The Mamba-1 selective scan of a prompt: one pass over the sequence.
//
// Replaces no TPU kernel.  The JAX package scans with
// jax.lax.associative_scan (src/repro/models/ssm.py _ssm_inner, :88), a
// chunked parallel scan that XLA fuses on the TPU; the port had carried it
// over as a chunked Hillis-Steele scan in elementwise torch
// (models/ssm.py _ssm_inner), which builds (B, chunk, Di, N) float32 decays
// and increments and rewrites them log2(chunk) times: ~74% of the device
// time of a 16 x 1,024-token prompt through AI21-Jamba2-Mini.  This kernel
// runs the recurrence itself, with the state on chip.
//
// Computes, for each batch row b, channel d and state n, from h = h0[b, d, n]:
//   h_t = exp(dt[b,t,d] * a[d,n]) * h_{t-1} + (dt[b,t,d] * B[b,t,n]) * x[b,t,d]
//   y[b,t,d] = sum_n h_t[n] * C[b,t,n],   h_final[b,d,n] = h_S
// dt float32 (B, S, Di); a float32 (Di, N); B, C (B, S, N) and x (B, S, Di)
// both float32 or both bf16 (the configs' compute dtypes), widened in
// registers; h0 and h_final
// float32 (B, Di, N); y float32 (B, S, Di).  The state, every decay
// (expf, not a faster exp) and increment and every y are float32: the
// plain reference's order, one position at a time (the increment as
// (dt * B) * x); the compiler contracts h's multiply-add and y's sum into
// FMAs, and y sums its N terms in order (by lanes, then across them, where
// a channel is split).
//
// What bounds it on an H100, at AI21-Jamba2-Mini's prompt (B 16, S 1,024,
// Di 8,192, N 16), a layer: bytes read and written once, dt 537 MB, x
// (bf16) 268 MB, B and C 1 MB, h0 8 MB, y 537 MB and h_final 8 MB, 1.36 GB:
// 0.41 ms at 3.35 TB/s; and 2.15e9 exps at one MUFU.EX2 each, 16 a clock an
// SM (132 SMs, 1.98 GHz: 4.2e12 a second), 0.51 ms.  expf is that EX2 and
// ~7 FMA-pipe instructions of range reduction, and a state-step adds ~4
// more (the decay's argument, the increment, h's FMA, y's FMA): ~12 a
// state-step at 128 a clock an SM, ~0.8 ms.
//
// The design: a thread owns one (batch row, channel) and keeps its N
// states (and a[d, :]) in registers; a block of 128 threads takes 128
// consecutive channels of one batch row and walks S in tiles of 16
// positions.  Each tile's dt and x (coalesced along the channels) and B
// and C (the tile's rows, shared by the whole block) are staged in shared
// memory, double-buffered: cp.async 16-byte copies of the next tile are in
// flight while this tile's recurrence runs (plain loads where a row or an
// operand is not 16-byte aligned).  B and C are widened to float32 once a
// tile; y is written a position at a time, 512 contiguous bytes a block,
// and h_final once.  At the cell's shape that is 1,024 blocks of 128
// threads, 28 KB of shared memory (bf16) and 108 registers each: four fit
// an SM, 1,024 blocks in two waves over 132 SMs.  Capped at 64 registers
// for eight an SM (one wave), the loop spilled 104 bytes and ran 1.75 ms
// against 1.42 (tiles of 8 positions: 1.48): the scan is bound by its
// instructions, not by latency.  Where B x Di / 128 blocks would not give
// each SM two (B = 1 or 2 at Di 8,192), the wrapper splits each channel's
// N states over L = 2 or 4 adjacent lanes, each holding N / L, and the L
// partial sums of y meet through shuffles: L times the blocks, on the same
// bytes.  N is a template parameter (8 or 16).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;                  // positions a stage

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One stage: a tile's dt and x for the block's C channels, and its rows of
// B and C as stored.  Every member's size is a multiple of 16 bytes.
template <int N, int C, typename T>
struct __align__(16) Stage {
  float dt[kTile][C];
  T x[kTile][C];
  T bc[2][kTile * N];
};

// Stage positions row0 .. row0 + len - 1 (rows of the flattened (B * S)
// sequence) of channels c0 .. c0 + C - 1 (those below Di) into s.
template <int N, int C, typename T>
__device__ __forceinline__ void stage(Stage<N, C, T>& s,
                                      const float* __restrict__ dt,
                                      const T* __restrict__ x,
                                      const T* __restrict__ bm,
                                      const T* __restrict__ cm, int64_t row0,
                                      int len, int c0, int Di, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kDtChunks = C / 4;                  // 16 bytes of floats
    constexpr int kEl = 16 / static_cast<int>(sizeof(T));
    constexpr int kXChunks = C / kEl;
    for (int i = tid; i < len * kDtChunks; i += kThreads) {
      const int t = i / kDtChunks, c = (i % kDtChunks) * 4;
      if (c0 + c < Di)
        cp_async16(&s.dt[t][c], dt + (row0 + t) * Di + c0 + c);
    }
    for (int i = tid; i < len * kXChunks; i += kThreads) {
      const int t = i / kXChunks, c = (i % kXChunks) * kEl;
      if (c0 + c < Di) cp_async16(&s.x[t][c], x + (row0 + t) * Di + c0 + c);
    }
    const int n = len * N / kEl;                      // chunks a matrix
    for (int i = tid; i < 2 * n; i += kThreads) {
      const int m = i >= n, j = (i - m * n) * kEl;
      cp_async16(&s.bc[m][j], (m ? cm : bm) + row0 * N + j);
    }
  } else {
    for (int i = tid; i < len * C; i += kThreads) {
      const int t = i / C, c = i % C;
      if (c0 + c < Di) {
        s.dt[t][c] = dt[(row0 + t) * Di + c0 + c];
        s.x[t][c] = x[(row0 + t) * Di + c0 + c];
      }
    }
    for (int i = tid; i < 2 * len * N; i += kThreads) {
      const int m = i >= len * N, j = i - m * len * N;
      s.bc[m][j] = (m ? cm : bm)[row0 * N + j];
    }
  }
}

template <int N, int L, typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const T* __restrict__ x, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int Di, int blocks_a_row, bool vec) {
  constexpr int C = kThreads / L;          // channels a block
  constexpr int NS = N / L;                // states a thread
  __shared__ Stage<N, C, T> st[2];
  __shared__ __align__(16) float bcf[2][kTile][N];   // B, C widened

  const int b = blockIdx.x / blocks_a_row;
  const int c0 = (blockIdx.x % blocks_a_row) * C;
  const int ch = threadIdx.x / L, lane = threadIdx.x % L;
  const int d = c0 + ch;
  const bool live = d < Di;
  const int64_t row = static_cast<int64_t>(b) * S;
  const int64_t state0 = (static_cast<int64_t>(b) * Di + d) * N + lane * NS;

  float h[NS], av[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    h[j] = live ? h0[state0 + j] : 0.f;
    av[j] = live ? a[static_cast<int64_t>(d) * N + lane * NS + j] : 0.f;
  }

  const int tiles = (S + kTile - 1) / kTile;
  if (tiles > 0) stage(st[0], dt, x, bm, cm, row, min(kTile, S), c0, Di, vec);
  cp_async_commit();
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kTile, len = min(kTile, S - t0);
    if (k + 1 < tiles) {
      // the next tile's buffer was last read before the previous barrier
      stage(st[(k + 1) & 1], dt, x, bm, cm, row + t0 + kTile,
            min(kTile, S - t0 - kTile), c0, Di, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<N, C, T>& s = st[k & 1];
    for (int i = threadIdx.x; i < 2 * len * N; i += kThreads) {
      const int m = i >= len * N, j = i - m * len * N;
      bcf[m][j / N][j % N] = widen(s.bc[m][j]);
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float dtv = s.dt[t][ch];
      const float xv = widen(s.x[t][ch]);
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float bv = bcf[0][t][lane * NS + j];
        const float cv = bcf[1][t][lane * NS + j];
        h[j] = expf(dtv * av[j]) * h[j] + dtv * bv * xv;
        yv += h[j] * cv;
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xFFFFFFFFu, yv, off);
      if (live && lane == 0) y[(row + t0 + t) * Di + d] = yv;
    }
    __syncthreads();                       // st[k & 1] and bcf free again
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j) h_out[state0 + j] = h[j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int N, int L, typename T>
cudaError_t launch_typed(const float* dt, const float* a, const void* bm,
                         const void* cm, const void* x, const float* h0,
                         float* y, float* h_out, long long B, long long S,
                         long long Di, cudaStream_t stream) {
  constexpr int C = kThreads / L;
  const long long per_row = (Di + C - 1) / C;
  if (B * per_row > INT_MAX) return cudaErrorInvalidValue;
  // 16-byte copies need every row of dt and x, and B's and C's rows, to
  // start on 16 bytes: Di and N rows of whole 16-byte chunks, and the
  // operands aligned
  const bool vec = (Di * 4) % 16 == 0 && (Di * sizeof(T)) % 16 == 0 &&
                   (N * sizeof(T)) % 16 == 0 && aligned16(dt) &&
                   aligned16(x) && aligned16(bm) && aligned16(cm);
  ssm_scan_kernel<N, L, T><<<static_cast<unsigned>(B * per_row), kThreads,
                             0, stream>>>(
      dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(x), h0, y, h_out, static_cast<int>(S),
      static_cast<int>(Di), static_cast<int>(per_row), vec);
  return cudaGetLastError();
}

template <int N, typename T>
cudaError_t launch_lanes(int lanes, const float* dt, const float* a,
                         const void* bm, const void* cm, const void* x,
                         const float* h0, float* y, float* h_out, long long B,
                         long long S, long long Di, cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch_typed<N, 1, T>(dt, a, bm, cm, x, h0, y, h_out, B, S, Di,
                                   s);
    case 2:
      return launch_typed<N, 2, T>(dt, a, bm, cm, x, h0, y, h_out, B, S, Di,
                                   s);
    case 4:
      return launch_typed<N, 4, T>(dt, a, bm, cm, x, h0, y, h_out, B, S, Di,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int N>
cudaError_t launch_states(int dtype, int lanes, const float* dt,
                          const float* a, const void* bm, const void* cm,
                          const void* x, const float* h0, float* y,
                          float* h_out, long long B, long long S,
                          long long Di, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_lanes<N, float>(lanes, dt, a, bm, cm, x, h0, y, h_out, B,
                                    S, Di, s);
    case 1:
      return launch_lanes<N, __nv_bfloat16>(lanes, dt, a, bm, cm, x, h0, y,
                                            h_out, B, S, Di, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dt: (B, S, Di) float32; a: (Di, N) float32; bm, cm: (B, S, N) and x:
// (B, S, Di), all three of `dtype` (0 float32, 1 bf16); h0, h_out:
// (B, Di, N) float32; y: (B, S, Di) float32; all contiguous.  N is 8 or 16;
// lanes (1, 2 or 4) splits each channel's states over that many threads.
// S = 0 copies h0 to h_out.
extern "C" int ssm_scan_launch(const float* dt, const float* a,
                               const void* bm, const void* cm, const void* x,
                               const float* h0, float* y, float* h_out,
                               long long B, long long S, long long Di, int N,
                               int dtype, int lanes, void* stream) {
  if (B < 0 || S < 0 || Di < 0 || S > INT_MAX || Di > INT_MAX)
    return cudaErrorInvalidValue;
  if (B == 0 || Di == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 8)
    return launch_states<8>(dtype, lanes, dt, a, bm, cm, x, h0, y, h_out, B,
                            S, Di, s);
  if (N == 16)
    return launch_states<16>(dtype, lanes, dt, a, bm, cm, x, h0, y, h_out, B,
                             S, Di, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssm_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
