// Device helpers shared by csrc/blind_rotate.cu and csrc/blind_rotate64.cu
// (sm_90a): the int8 tensor-core product, cp.async, programmatic dependent
// launch, and the staging of the digit pass (`stage1`, `stage1_64`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ---- int8 tensor cores and cp.async ----

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---- programmatic dependent launch (Hopper) ----
//
// A kernel launched by launch_pdl may start while the kernel before it on
// the stream still runs, once every block of that one has called
// pdl_launch_dependents (or exited).  pdl_wait returns when the kernel
// before has finished and its writes are visible; a kernel reads nothing
// its predecessor writes, and writes nothing its predecessor reads, before
// it.  Both are no-ops in a kernel launched the ordinary way.
//
// In a rotation the external product calls pdl_launch_dependents once its
// products are summed, so the next digit pass is resident, `a` read,
// while the epilogue drains.  The digit pass does not: an external
// product launched while the digit pass still runs places its one wave of
// blocks unevenly over the SMs at narrow batches, and its step grew by
// half at B = 8 on an H100.  It starts as the digit pass's blocks exit.

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... Params, typename... Args>
int launch_pdl(void (*kern)(Params...), dim3 grid, dim3 block, size_t smem,
               cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// ---- the digit pass: segments, staging, padded shared memory ----
//
// A block of the digit pass covers coefficients [m0, m0 + S) of one
// polynomial (batch row b, component c); each of its S / 16 threads takes
// 16 consecutive coefficients.  It stages two runs of the row p = acc[b, c]
// in shared memory: p[m0 .. m0 + S) and the rotated source, p[(u0 + i) mod
// N] for i < S, u0 = (m0 - a) mod N, which is at most two contiguous runs
// of p (stage_digit_runs).  Both are read as 16-byte groups aligned in p,
// so the source run starts at u0 rounded down to a group (q0) and is one
// group longer; the thread then reads word off + i, off = u0 - q0.  A word
// w lies at spad(w) = w + w / 16: thread t reads word 16 t + q for a fixed
// q at once with its warp, and the pad puts those 32 words in 32 different
// banks (2-word words: 16 threads, 32 banks).

constexpr int kSegMin = 128;     // coefficients per digit-pass block, least
constexpr int kSegMax = 1024;    // and most
constexpr int kPerThread = 16;   // coefficients per thread
constexpr int kWave = 132;       // SMs of an H100 SXM

__host__ __device__ __forceinline__ int spad(int w) { return w + (w >> 4); }

// Shared words that hold n staged words.
__host__ __device__ __forceinline__ int spad_words(int n) {
  return spad(n - 1) + 1;
}

// Segment length S: the longest power of two in [kSegMin, min(N, kSegMax)]
// that still gives B * k1 * N / S >= kWave blocks.
inline int stage1_segment(int B, int k1, int N) {
  int S = N < kSegMax ? N : kSegMax;
  while (S > kSegMin && (long long)B * k1 * (N / S) < kWave) S >>= 1;
  return S;
}

// Words w .. w + G - 1 (mod N) of the row p as one 16-byte load, G = 16 /
// sizeof(Word) words to a group; w and N are multiples of G, so no group
// wraps.
template <typename Word>
__device__ __forceinline__ uint4 load_group(const Word* __restrict__ p, int w,
                                            int N) {
  return *reinterpret_cast<const uint4*>(p + (w & (N - 1)));
}

// A loaded group as the staged words w .. w + G - 1 of dst.
template <typename Word>
__device__ __forceinline__ void put_group(Word* dst, int w, uint4 v) {
  if constexpr (sizeof(Word) == 4) {
    dst[spad(w)] = v.x;
    dst[spad(w + 1)] = v.y;
    dst[spad(w + 2)] = v.z;
    dst[spad(w + 3)] = v.w;
  } else {
    dst[spad(w)] = v.x | (uint64_t)v.y << 32;
    dst[spad(w + 1)] = v.z | (uint64_t)v.w << 32;
  }
}

// Stage the block's two runs of the row p into sm: p[m0 .. m0 + S) at sm,
// p[q0 .. q0 + S + G) (mod N) at sm + spad_words(S), and return s0 = (m0 -
// a) mod 2N, a = *a_s (written by thread 0 before the call).  Thread t
// loads groups t, t + T, ... of each run (16 / G of each; thread 0 also
// the source run's last group) and issues all its loads before its first
// store, so they are in flight together: two dependent trips to memory,
// the row segment's beside `a`, then the source run's.
template <typename Word>
__device__ __forceinline__ int stage_digit_runs(Word* sm,
                                                const Word* __restrict__ p,
                                                int m0, const int* a_s,
                                                int N) {
  constexpr int G = 16 / sizeof(Word), PER = kPerThread / G;
  const int t = threadIdx.x, T = blockDim.x, S = T * kPerThread;
  uint4 own[PER], src[PER], last = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < PER; ++k) own[k] = load_group(p, m0 + (t + k * T) * G, N);
  __syncthreads();                                      // *a_s
  const int s0 = (m0 - *a_s) & (2 * N - 1);
  const int q0 = s0 & (N - 1) & ~(G - 1);
#pragma unroll
  for (int k = 0; k < PER; ++k) src[k] = load_group(p, q0 + (t + k * T) * G, N);
  if (t == 0) last = load_group(p, q0 + S, N);
  Word* src_s = sm + spad_words(S);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    put_group(sm, (t + k * T) * G, own[k]);
    put_group(src_s, (t + k * T) * G, src[k]);
  }
  if (t == 0) put_group(src_s, S, last);
  __syncthreads();
  return s0;
}

// Shared bytes of a digit-pass block of segment S over `Word`s: the acc run
// (S words) and the source run (S + G words).
template <typename Word>
inline size_t stage1_smem(int S) {
  constexpr int G = 16 / sizeof(Word);
  return (size_t)(spad_words(S) + spad_words(S + G)) * sizeof(Word);
}
