// Blind rotation for a batch of 64-bit TFHE bootstraps on Hopper (sm_90a).
//
// Replaces fhe_regex_tpu/ops/pbs_pallas.py::_fused_blindrot64_stacked_kernel
// and _fused_blindrot64_kernel (with _acc64_init; backend `pallas64`) and
// _fused_blindrot64_bg_kernel (backend `pallas64-bg`), and computes exactly
// what fhe_regex_tpu_torch/ops/pbs64.py::blind_rotate64 computes, bit for
// bit: [B, n+1] mod-switched ciphertexts -> [B, k+1, N] uint64 accumulators.
//
// What bounds it.  Every CMUX step is an external product of the B
// accumulators' gadget digits with the step's GGSW: at the 64-bit
// production set (n=866, N=2048, k=1, one base-2^23 digit per component,
// so 2 digit rows) that is B * 2 * 2 * N^2 = 1.7e7 * B multiply-adds mod
// 2^64 per step, on the CUDA cores.  A 64-bit multiply-add costs about
// three 32-bit IMAD slots, against one for the 32-bit kernel, but the
// 64-bit set has a third of the digit rows, so a step costs about what a
// 32-bit step does.  The accumulators (B * 32 KB) and one step's GGSW
// (64 KB) stay in the 50 MB L2.
//
// What the design does about it.
//  * The key side is never materialised: a block stages the doubled window
//    [g, -g mod 2^64] of one GGSW polynomial in shared memory, so the
//    Toeplitz entry M[t, m] = dbl[(m - t) mod 2N] is a shared-memory read.
//    Each key word is stored as a signed low half and an adjusted high
//    half, k = lo_s + hi' * 2^32 mod 2^64, so d * k mod 2^64 is one
//    signed 32x32->64 multiply-add (IMAD.WIDE) into a 64-bit sum plus one
//    32-bit IMAD into a separate high sum, joined once at the end.
//  * Each thread owns 4 batch rows x 8 consecutive coefficients; along t
//    the 8 coefficients read a sliding window of the key, so 8 steps of t
//    cost 15 key reads per half for 256 multiply-adds.  The window is
//    padded (one word every 8) so the 32 lanes hit 32 banks.
//  * The grid spans (batch tile, component x coefficient tile, digit row);
//    rows meet through 64-bit atomic adds, exact mod 2^64 in any order.
//  * Per step: one `stage1_64` launch (rotate by a~_i, subtract, round,
//    balanced digits into an int32 scratch) and one `ext_product64` launch,
//    from a step loop on the host side of this library.
//
// What the TPU kernels needed and this one does not: the (lo, hi) int32
// pairs with explicit carries, the 8 int8 key limbs and 3 digit limbs in
// weight classes for the MXU, the roll chains standing in for indexed
// reads, WIN and sublane padding, and (in the batch-grid kernel) the HBM
// accumulator with DMA staging and the skipping of weight classes below
// the key-limb drop.  Here the accumulator lives in global memory (L2),
// and a rounded key needs no skipping: its low bytes are zero, and the
// uint64 products are exact all the same.
//
// All torus arithmetic is uint64_t: wraparound is defined there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads1 = 256;      // stage1_64 / acc_init64 block
constexpr int BT = 4;               // batch rows per thread
constexpr int MT = 8;               // consecutive coefficients per thread
constexpr int kWarps = 2;           // warps per ext_product64 block
constexpr int TBB = BT * kWarps;    // batch rows per block
constexpr int TMB = MT * 32;        // coefficients per block
constexpr int TCH = 256;            // digits staged per chunk of t
constexpr int U = 8;                // t unroll (sliding-window length)

__host__ __device__ __forceinline__ int pad_idx(int y) { return y + (y >> 3); }

// acc[b, c<k, :] = 0;  acc[b, k, m] = (X^{r0} * lut)[m],
// r0 = (2N - b~) mod 2N,  lut = luts[lut_idx[b]].
__global__ void acc_init64(const int32_t* __restrict__ cts_ms,
                           const uint64_t* __restrict__ luts,
                           const int32_t* __restrict__ lut_idx,
                           uint64_t* __restrict__ acc, int B, int n, int k1,
                           int N) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * k1 * N) return;
  int m = (int)(e % N);
  int c = (int)((e / N) % k1);
  int b = (int)(e / ((long long)N * k1));
  uint64_t v = 0ull;
  if (c == k1 - 1) {
    int twoN = 2 * N;
    int r0 = (twoN - cts_ms[(long long)b * (n + 1) + n]) & (twoN - 1);
    int s = (m - r0) & (twoN - 1);
    const uint64_t* lut = luts + (long long)lut_idx[b] * N;
    v = s < N ? lut[s] : 0ull - lut[s - N];
  }
  acc[e] = v;
}

// digits[b, c*l + j, m] = j-th most significant balanced digit of
// (X^{a_i} * acc[b, c])[m] - acc[b, c, m], as int32.
__global__ void stage1_64(const int32_t* __restrict__ cts_ms,
                          const uint64_t* __restrict__ acc,
                          int32_t* __restrict__ digits, int B, int n, int k1,
                          int N, int level, int base_log, int step) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * k1 * N) return;
  int m = (int)(e % N);
  int c = (int)((e / N) % k1);
  int b = (int)(e / ((long long)N * k1));
  int twoN = 2 * N;
  int a = cts_ms[(long long)b * (n + 1) + step];
  const uint64_t* p = acc + ((long long)b * k1 + c) * N;
  int s = (m - a) & (twoN - 1);
  uint64_t rot = s < N ? p[s] : 0ull - p[s - N];
  uint64_t diff = rot - p[m];
  int shift = 64 - base_log * level;
  uint64_t state = (diff + (1ull << (shift - 1))) >> shift;
  uint64_t base = 1ull << base_log;
  uint64_t half = base >> 1;
  int32_t* out = digits + ((long long)b * k1 * level + (long long)c * level) * N + m;
  for (int j = level - 1; j >= 0; --j) {   // least significant first
    uint64_t d = state & (base - 1ull);
    long long sd = d >= half ? (long long)d - (long long)base : (long long)d;
    state = (state - (uint64_t)sd) >> base_log;
    out[(long long)j * N] = (int32_t)sd;
  }
}

// acc[b, c, m] += sum_t digits[b, r, t] * dbl_{r,c}[(m - t) mod 2N]  (mod 2^64)
// over the block's (batch tile, c, coefficient tile) and its one row r.
__global__ void __launch_bounds__(kWarps * 32)
ext_product64(const int32_t* __restrict__ digits,
              const uint64_t* __restrict__ ggsw,   // this step: [rows, k1, N]
              uint64_t* __restrict__ acc, int B, int k1, int N, int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int win_len = N + TMB;
  const int wpad = pad_idx(win_len) + 8;                 // a multiple of 8
  int32_t* wlo = reinterpret_cast<int32_t*>(smem);       // signed low halves
  uint32_t* whi = smem + wpad;                           // adjusted high halves
  int32_t* dig = reinterpret_cast<int32_t*>(smem + 2 * wpad);

  const int mtiles = N / TMB;
  const int r = blockIdx.z;
  const int c = blockIdx.y / mtiles;
  const int M0 = (blockIdx.y % mtiles) * TMB;
  const int b0 = blockIdx.x * TBB;
  const int lane = threadIdx.x & 31;
  const int wb = threadIdx.x >> 5;

  // win[y] = dbl[(M0 - N + y) mod 2N], y in [0, N + TMB), split as
  // v = (int32)lo + (hi + (lo >> 31)) * 2^32 mod 2^64
  const uint64_t* g = ggsw + ((long long)r * k1 + c) * N;
  for (int y = threadIdx.x; y < win_len; y += blockDim.x) {
    int z = (M0 - N + y) & (2 * N - 1);
    uint64_t v = z < N ? g[z] : 0ull - g[z - N];
    uint32_t lo = (uint32_t)v;
    wlo[pad_idx(y)] = (int32_t)lo;
    whi[pad_idx(y)] = (uint32_t)(v >> 32) + (lo >> 31);
  }

  uint64_t accl[BT][MT];
  uint32_t acch[BT][MT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      accl[bb][j] = 0ull;
      acch[bb][j] = 0u;
    }

  // coefficient m = M0 + lane*MT + j reads win at y = lane*MT + j - t + N
  const int ybase = lane * MT + N - (U - 1);
  const int32_t* drow = digits + (long long)r * N;
  const long long dstride = (long long)rows * N;

  for (int t0 = 0; t0 < N; t0 += TCH) {
    __syncthreads();   // window written / previous chunk consumed
    for (int e = threadIdx.x; e < TBB * TCH; e += blockDim.x) {
      int bb = e / TCH, tt = e % TCH;
      int b = b0 + bb;
      dig[tt * TBB + bb] = b < B ? drow[b * dstride + t0 + tt] : 0;
    }
    __syncthreads();
    for (int tu = 0; tu < TCH; tu += U) {
      const int t = t0 + tu;
      int32_t klo[MT + U - 1];
      uint32_t khi[MT + U - 1];
#pragma unroll
      for (int q = 0; q < MT + U - 1; ++q) {
        klo[q] = wlo[pad_idx(ybase - t + q)];
        khi[q] = whi[pad_idx(ybase - t + q)];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int4 dv =
            *reinterpret_cast<const int4*>(&dig[(tu + u) * TBB + wb * BT]);
        const int32_t d[BT] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int32_t kl = klo[j - u + U - 1];
          const uint32_t kh = khi[j - u + U - 1];
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            accl[bb][j] += (uint64_t)((long long)d[bb] * (long long)kl);
            acch[bb][j] += (uint32_t)d[bb] * kh;
          }
        }
      }
    }
  }

#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    int b = b0 + wb * BT + bb;
    if (b >= B) continue;
    unsigned long long* out = reinterpret_cast<unsigned long long*>(
        acc + ((long long)b * k1 + c) * N + M0 + lane * MT);
#pragma unroll
    for (int j = 0; j < MT; ++j)
      atomicAdd(out + j, (unsigned long long)(
                             accl[bb][j] + ((uint64_t)acch[bb][j] << 32)));
  }
}

// Shared memory of one ext_product64 block for polynomial size N.
size_t ext_product64_smem(int N) {
  return (size_t)(2 * (pad_idx(N + TMB) + 8)) * sizeof(uint32_t) +
         (size_t)TCH * TBB * sizeof(int32_t);
}

// The whole blind rotation of B instances, enqueued on `stream`.
int rotate64(const int32_t* cts_ms, const uint64_t* luts,
             const int32_t* lut_idx, const uint64_t* bsk, uint64_t* acc,
             int32_t* digits, int B, int n, int k1, int N, int level,
             int base_log, cudaStream_t stream) {
  const int rows = k1 * level;
  const long long elems = (long long)B * k1 * N;
  const unsigned grid1 = (unsigned)((elems + kThreads1 - 1) / kThreads1);
  const dim3 grid2((B + TBB - 1) / TBB, k1 * (N / TMB), rows);
  const size_t smem = ext_product64_smem(N);

  cudaError_t err = cudaFuncSetAttribute(
      ext_product64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  acc_init64<<<grid1, kThreads1, 0, stream>>>(cts_ms, luts, lut_idx, acc, B,
                                              n, k1, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long step_stride = (long long)rows * k1 * N;
  for (int i = 0; i < n; ++i) {
    stage1_64<<<grid1, kThreads1, 0, stream>>>(cts_ms, acc, digits, B, n, k1,
                                               N, level, base_log, i);
    ext_product64<<<grid2, kWarps * 32, smem, stream>>>(
        digits, bsk + i * step_stride, acc, B, k1, N, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The whole 64-bit blind rotation (the `pallas64` kernel's counterpart),
// enqueued on `stream`; returns a cudaError_t.
//   cts_ms  [B, n+1] int32 in [0, 2N)      luts [L, N] uint64  lut_idx [B]
//   bsk     [n, k1*level, k1, N] uint64    acc  [B, k1, N] uint64 (output)
//   digits  [B, k1*level, N] int32 scratch
// Needs N a power of two, a multiple of 256, and 64 - base_log*level >= 33.
int fhe_blind_rotate64(const int32_t* cts_ms, const uint64_t* luts,
                       const int32_t* lut_idx, const uint64_t* bsk,
                       uint64_t* acc, int32_t* digits, int B, int n, int k1,
                       int N, int level, int base_log, void* stream_ptr) {
  return rotate64(cts_ms, luts, lut_idx, bsk, acc, digits, B, n, k1, N, level,
                  base_log, static_cast<cudaStream_t>(stream_ptr));
}

// The same rotation over batch blocks of tb instances, one after another
// (the `pallas64-bg` kernel's counterpart); tb divides B, and digits is
// [tb, k1*level, N].  The caller passes the key rounded by its limb drop.
int fhe_blind_rotate64_bg(const int32_t* cts_ms, const uint64_t* luts,
                          const int32_t* lut_idx, const uint64_t* bsk,
                          uint64_t* acc, int32_t* digits, int B, int tb, int n,
                          int k1, int N, int level, int base_log,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int b0 = 0; b0 < B; b0 += tb) {
    int err = rotate64(cts_ms + (long long)b0 * (n + 1), luts, lut_idx + b0,
                       bsk, acc + (long long)b0 * k1 * N, digits, tb, n, k1,
                       N, level, base_log, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
