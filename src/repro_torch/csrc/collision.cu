// Pairwise collision counts over b-bit packed codes: the brute-force
// fallback's scoring kernel, and Fig. 7's over int32 signatures (b = 32).
//
// Replaces the Pallas collision kernel of the JAX package:
//   src/repro/kernels/collision_kernel.py  _kernel (:22) and
//   collision_count_pallas (:37; pallas_call at :51).
//
// Computes count[q, n] = sum_k 1{code_k(a[q]) == code_k(b[n])} for (Q, W) x
// (N, W) words of K b-bit codes in the kernels/packfmt.py layout (code j at
// bit (j % (32/b)) * b of word j / (32/b)) -> (Q, N) int32.  b = 32 is one
// code a word (W = K): the reference's int32 collision count.  The index
// is read as it is stored, so the brute-force fallback is one launch over
// the whole index, with no unpacked copy of it.
//
// What bounds it on an H100: operations.  The data flow is a matrix product
// with (==, +) for (*, +), and no tensor-core instruction computes an
// equality count of 32-bit codes, so it runs on the SIMT pipes.  Only the
// compare needs the integer pipe (64 lanes an SM a clock: 16.7e12 compares
// a second at 1.98 GHz); the count goes to the FMA pipe (128 lanes) as a
// predicated float add of 1 (ISETP, then @P FADD), exact while a count
// stays <= 2^24 (a longer K is counted in segments of 2^24 codes, each
// added into the output).  So Q*N*K / 16.7e12 s is the bound: at the
// fallback's 64 x 262,144 x 256, 0.257 ms, against 0.10 ms to read the 268
// MB of index words and write the 67 MB of counts once.  At b < 32 a word
// holds 32/b codes, compared at once: XOR, then ((d & m) + m) | d sets the
// top bit of every b-bit lane that is not zero (m = the low b-1 bits of
// each lane; the add cannot carry out of a lane), and a popcount of the
// complement under the lanes' top bits counts the equal codes: six integer
// operations a word, one of them a POPC at a quarter of the integer rate.
//
// The design: a compare's predicate reaches the add 13 clocks later, and
// ptxas chains most pairs through one predicate, so a warp completes a
// pair every ~14 clocks and the pipes fill only with enough warps: an SM
// needs about 28 (7 a scheduler) to keep the integer pipe busy.  A block of
// 16 x TY threads owns a 4 TY x 64 output tile, each thread a 4 x 4
// register tile (rows ty + TY i, columns tx + 16 j), 64 registers a thread
// (the launch bounds ask for 1024 threads an SM); at the default TY = 16,
// a 64 x 64 tile of 256 threads, four blocks (32 warps) fit an SM; an 8 x 8
// register tile, fewer loads a pair but 128 registers and 16 warps an SM,
// ran at half the rate.  The query tile, block_q = 4 TY of 16, 32 or 64
// rows, is a launch argument among the compiled instances
// (kernels/autotune.py's "collision" kind picks one a call; 64 is the
// default): a few query rows (a stream batch's 4) fill a 16-row tile, not
// a quarter of the threads of a 64-row one.  The words stream
// through shared memory 32 a row at a time in a double-buffered ring filled
// by cp.async (16-byte copies where W % 4 == 0 and both operands are
// 16-byte aligned, 4-byte copies otherwise; shifts and masks, no division,
// in the staging loop), so the next chunk is in flight while this one is
// counted; every 4 words a thread loads its 4 + 4 rows' words with 8
// 16-byte shared loads and makes 64 compares.  Rows are padded to 36 words, so the 8 lanes of a 16-byte
// load phase read 8 rows in 8 distinct bank groups.  Ragged edges: rows
// past Q or N and words past W are filled with zeros by cp.async (src-size
// 0); rows past Q or N are never written, and the zero words, equal on both
// sides, add 32/b to every count each, which the epilogue subtracts.
// Codes past K in the last word (b < 32) are taken off by comparing the two
// last words under the mask of those lanes.  Output offsets are 64-bit.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kT = 4;                      // rows and columns a thread
constexpr int kTX = 16;                    // threads along N
constexpr int kBN = kT * kTX;              // index rows per block: 64
constexpr int kKC = 32;                    // words per staged chunk
constexpr int kStride = kKC + 4;           // shared row stride, in words
constexpr int kSegChunks = (1 << 24) / kKC;       // chunks a float count spans

// The block's geometry for TY threads along Q (4, 8 or 16).
template <int TY>
struct Tile {
  static constexpr int kTY = TY;
  static constexpr int kBQ = kT * TY;      // query rows per block: 4 TY
  static constexpr int kThreads = kTX * TY;
  static constexpr int kStageWords = (kBQ + kBN) * kStride;
  static constexpr int kSmemBytes = 2 * kStageWords * 4;  // 36,864 at 16
  // 64 registers a thread: as many threads an SM as four 256-thread blocks
  static constexpr int kMinBlocks = 1024 / kThreads;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy VEC words global -> shared, or zero-fill them when !valid.
template <int VEC>
__device__ __forceinline__ void cp_async(unsigned* dst, const unsigned* src,
                                         bool valid) {
  const int n = valid ? 4 * VEC : 0;
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's staging of one chunk, words [w0, w0 + kKC) of its kBQ A rows
// and 64 B rows: this thread copies VEC words at column c of rows r0 +
// kRowStep u of each side.  Only a base pointer a side, the row step and
// the rows left are kept, so the loop holds few registers.
template <int VEC, class TL>
struct Stager {
  static constexpr int kPer = kKC / VEC;           // copies a row
  static constexpr int kRowStep = TL::kThreads / kPer;  // rows between copies
  static constexpr int kSideA = TL::kBQ / kRowStep;     // copies of A rows
  static constexpr int kSideB = kBN / kRowStep;         // copies of B rows
  static_assert(TL::kThreads % kPer == 0 && TL::kBQ % kRowStep == 0 &&
                    kBN % kRowStep == 0,
                "staging geometry");
  const unsigned* ga;                      // A row q0 + r0, column c
  const unsigned* gb;                      // B row n0 + r0, column c
  long long step;                          // kRowStep rows, in words
  long long a_left, b_left;                // rows from r0 to Q, to N
  int r0, c, W;

  __device__ Stager(const unsigned* a, const unsigned* b, long long q0,
                    long long n0, int Q, int N, int W_)
      : r0(threadIdx.x / kPer), c((threadIdx.x % kPer) * VEC), W(W_) {
    ga = a + (q0 + r0) * W + c;
    gb = b + (n0 + r0) * W + c;
    step = static_cast<long long>(kRowStep) * W;
    a_left = Q - q0 - r0;
    b_left = N - n0 - r0;
  }

  __device__ __forceinline__ void operator()(unsigned* s, int w0) const {
    const bool col = c + w0 < W;
#pragma unroll
    for (int u = 0; u < kSideA; ++u) {
      const bool ok_a = col && a_left > kRowStep * u;
      cp_async<VEC>(s + (r0 + kRowStep * u) * kStride + c,
                    ok_a ? ga + step * u + w0 : ga, ok_a);
    }
#pragma unroll
    for (int u = 0; u < kSideB; ++u) {
      const bool ok_b = col && b_left > kRowStep * u;
      cp_async<VEC>(s + (TL::kBQ + r0 + kRowStep * u) * kStride + c,
                    ok_b ? gb + step * u + w0 : gb, ok_b);
    }
  }
};

// b = 32: one code a word; the compare on the integer pipe, the count a
// predicated float add on the FMA pipe.
struct CodeCount {
  using Acc = float;
  static constexpr bool kFloat = true;
  unsigned m, h;                           // unused
  __device__ __forceinline__ void add(float& acc, unsigned x,
                                      unsigned y) const {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, %2;\n\t"
        "@p add.f32 %0, %0, 0f3F800000;\n\t}"
        : "+f"(acc)
        : "r"(x), "r"(y));
  }
};

// b < 32: 32/b codes a word, compared at once.
struct LaneCount {
  using Acc = int;
  static constexpr bool kFloat = false;
  unsigned m, h;                           // low b-1 bits / top bit of lanes
  __device__ __forceinline__ void add(int& acc, unsigned x,
                                      unsigned y) const {
    acc += __popc(~(((x ^ y) & m) + m | (x ^ y)) & h);
  }
};

template <class TL, class Op>
__device__ __forceinline__ void count_chunk(const unsigned* s, const Op& op,
                                            int tx, int ty,
                                            typename Op::Acc (&acc)[kT][kT]) {
  constexpr int kTY = TL::kTY;
  const unsigned* as = s + ty * kStride;
  const unsigned* bs = s + (TL::kBQ + tx) * kStride;
#pragma unroll
  for (int c = 0; c < kKC; c += 4) {
    uint4 av[kT], bv[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i)
      av[i] = *reinterpret_cast<const uint4*>(as + kTY * i * kStride + c);
#pragma unroll
    for (int j = 0; j < kT; ++j)
      bv[j] = *reinterpret_cast<const uint4*>(bs + kTX * j * kStride + c);
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        op.add(acc[i][j], av[i].x, bv[j].x);
        op.add(acc[i][j], av[i].y, bv[j].y);
        op.add(acc[i][j], av[i].z, bv[j].z);
        op.add(acc[i][j], av[i].w, bv[j].w);
      }
  }
}

template <class Op, int VEC, int TY>
__global__ void __launch_bounds__(Tile<TY>::kThreads, Tile<TY>::kMinBlocks)
collision_kernel(const unsigned* __restrict__ a,
                 const unsigned* __restrict__ b, int* __restrict__ out,
                 int Q, int N, int W, int K, int bits, Op op) {
  using TL = Tile<TY>;
  constexpr int kTY = TY, kBQ = TL::kBQ, kStageWords = TL::kStageWords;
  extern __shared__ int4 smem_raw[];
  unsigned* smem = reinterpret_cast<unsigned*>(smem_raw);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const long long q0 = (long long)blockIdx.y * kBQ;
  const long long n0 = (long long)blockIdx.x * kBN;
  using Acc = typename Op::Acc;
  Acc acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0;

  const int n_chunks = (W + kKC - 1) / kKC;
  const Stager<VEC, TL> stage(a, b, q0, n0, Q, N, W);
  stage(smem, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage(smem + ((ch + 1) & 1) * kStageWords, (ch + 1) * kKC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    count_chunk<TL>(smem + (ch & 1) * kStageWords, op, tx, ty, acc);
    __syncthreads();                       // the stage is consumed
    if constexpr (Op::kFloat) {
      if (((ch + 1) & (kSegChunks - 1)) == 0 && ch + 1 < n_chunks) {
        // K past 2^24 only: the counts so far go into out
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          const long long q = q0 + ty + kTY * i;
#pragma unroll
          for (int j = 0; j < kT; ++j) {
            const long long n = n0 + tx + kTX * j;
            if (q < Q && n < N) {
              int* o = out + q * N + n;
              *o = (ch + 1 > kSegChunks ? *o : 0) +
                   static_cast<int>(acc[i][j]);
            }
            acc[i][j] = 0;
          }
        }
      }
    }
  }
  const bool flushed = Op::kFloat && n_chunks > kSegChunks;

  // Zero words past W match on both sides, 32/b codes each; codes past K
  // in the last word are compared below and taken off.
  const int cpw = 32 / bits;
  const int pad = (n_chunks * kKC - W) * cpw;
  const int valid_last = K - (W - 1) * cpw;   // codes of the last word
  const unsigned tail = valid_last < cpw ? op.h & (~0u << (bits * valid_last))
                                         : 0u;
  unsigned a_last[kT], b_last[kT];
  if (tail) {
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const long long q = q0 + ty + kTY * i;
      a_last[i] = q < Q ? __ldg(a + q * W + W - 1) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const long long n = n0 + tx + kTX * j;
      b_last[j] = n < N ? __ldg(b + n * W + W - 1) : 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long q = q0 + ty + kTY * i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const long long n = n0 + tx + kTX * j;
      if (n >= N) continue;
      int c = static_cast<int>(acc[i][j]) - pad;
      if (tail) {
        const unsigned d = a_last[i] ^ b_last[j];
        c -= __popc(~((d & op.m) + op.m | d) & tail);
      }
      int* o = out + q * N + n;
      *o = flushed ? *o + c : c;
    }
  }
}

// Ask once per device and instantiation for the largest shared carveout,
// so that the blocks the launch bounds ask for (four of 36,864 bytes at
// the default tile) fit an SM whatever split of the SM's memory between L1
// and shared memory would otherwise be chosen.
template <class Op, int VEC, int TY>
cudaError_t prepare() {
  static std::mutex mu;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(collision_kernel<Op, VEC, TY>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           100);
  if (e != cudaSuccess) return e;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

template <class Op, int VEC, int TY>
cudaError_t launch(const unsigned* a, const unsigned* b, int* out, int Q,
                   int N, int W, int K, int bits, Op op,
                   cudaStream_t stream) {
  using TL = Tile<TY>;
  const cudaError_t e = prepare<Op, VEC, TY>();
  if (e != cudaSuccess) return e;
  const long long gy = (Q + TL::kBQ - 1) / TL::kBQ;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((N + kBN - 1) / kBN, static_cast<unsigned>(gy));
  collision_kernel<Op, VEC, TY>
      <<<grid, TL::kThreads, TL::kSmemBytes, stream>>>(a, b, out, Q, N, W, K,
                                                       bits, op);
  return cudaGetLastError();
}

// The compiled query tiles: block_q 16, 32 or 64 rows (TY 4, 8, 16).
template <class Op, int VEC>
cudaError_t launch_tile(const unsigned* a, const unsigned* b, int* out,
                        int Q, int N, int W, int K, int bits, Op op,
                        int block_q, cudaStream_t stream) {
  switch (block_q) {
    case 16: return launch<Op, VEC, 4>(a, b, out, Q, N, W, K, bits, op, stream);
    case 32: return launch<Op, VEC, 8>(a, b, out, Q, N, W, K, bits, op, stream);
    default: return launch<Op, VEC, 16>(a, b, out, Q, N, W, K, bits, op, stream);
  }
}

}  // namespace

// a (Q, W) and b (N, W) words of K b-bit codes (b in 1, 2, 4, 8, 16, 32;
// W = ceil(K / (32/b))) -> out (Q, N) int32 counts of equal codes, with a
// query tile of block_q rows (16, 32 or 64; any other is refused).
extern "C" int collision_launch(const unsigned* a, const unsigned* b,
                                int* out, int Q, int N, int W, int K,
                                int bits, int block_q, void* stream) {
  if (block_q != 16 && block_q != 32 && block_q != 64)
    return cudaErrorInvalidValue;
  if (Q == 0 || N == 0) return cudaSuccess;
  if (bits < 1 || bits > 32 || 32 % bits != 0 || W < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (bits == 32) {
    const CodeCount op = {0u, 0u};
    return vec ? launch_tile<CodeCount, 4>(a, b, out, Q, N, W, K, bits, op,
                                           block_q, s)
               : launch_tile<CodeCount, 1>(a, b, out, Q, N, W, K, bits, op,
                                           block_q, s);
  }
  unsigned lane_low = 0u, lane_top = 0u;
  for (int s0 = 0; s0 < 32; s0 += bits) {
    lane_low |= ((1u << (bits - 1)) - 1u) << s0;
    lane_top |= 1u << (s0 + bits - 1);
  }
  const LaneCount op = {lane_low, lane_top};
  return vec ? launch_tile<LaneCount, 4>(a, b, out, Q, N, W, K, bits, op,
                                         block_q, s)
             : launch_tile<LaneCount, 1>(a, b, out, Q, N, W, K, bits, op,
                                         block_q, s);
}

extern "C" const char* collision_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
