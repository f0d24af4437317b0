// Blind rotation for a batch of 32-bit TFHE bootstraps on Hopper (sm_90a).
//
// Replaces fhe_regex_tpu/ops/pbs_pallas.py::_fused_blindrot_kernel (the
// whole blind rotation of `pallas-fused`) and computes exactly what
// fhe_regex_tpu_torch/ops/pbs.py::blind_rotate computes, bit for bit:
// [B, n+1] mod-switched ciphertexts -> [B, k+1, N] accumulators.
//
// What bounds it.  Every CMUX step is an external product of the B
// accumulators' digits with the step's GGSW, a [B, (k+1)l*N] x
// [(k+1)l*N, (k+1)*N] product whose right side is negacyclic Toeplitz.  At
// the production set (n=866, N=2048, k=1, l=3) that is
// 866 * 12 * N^2 ~= 4.4e10 32-bit multiply-adds per bootstrap, run here on
// the CUDA cores (IMAD, 64 per clock per SM) -- not the tensor cores, which
// need an int8 limb split of the key (a later step).  The accumulators
// (B * 16 KB) and one step's GGSW (96 KB) stay in the 50 MB L2.
//
// What the design does about it.
//  * The key side is never materialised: a block stages the doubled window
//    [g, -g] of one GGSW polynomial in shared memory, so the Toeplitz entry
//    M[t, m] = dbl[(m - t) mod 2N] is a shared-memory read without a branch.
//  * Each thread owns 4 batch rows x 8 consecutive coefficients (32 uint32
//    accumulators).  Along t the 8 coefficients read a sliding window of
//    the key, so 8 steps of t cost 15 key reads and 8 digit reads for 256
//    multiply-adds: the loop is bound by IMAD, not by shared memory.  The
//    window is padded (one word every 8) so the 32 lanes hit 32 banks.
//  * The grid spans (batch tile, component x coefficient tile, digit row),
//    so even an 8-wide level keeps ~100 blocks busy; rows meet through
//    32-bit atomic adds, which are exact mod 2^32 in any order.
//  * Per step: one `stage1` launch (rotate by a~_i, subtract, round,
//    balanced digits into an int8 scratch) and one `ext_product` launch.
//    The step loop runs on the host side of this library, so a level of
//    any width spreads every step over the whole card.
//
// All torus arithmetic is uint32_t: wraparound is defined there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads1 = 256;      // stage1 / acc_init block
constexpr int BT = 4;               // batch rows per thread
constexpr int MT = 8;               // consecutive coefficients per thread
constexpr int kWarps = 2;           // warps per ext_product block (batch groups)
constexpr int TBB = BT * kWarps;    // batch rows per block
constexpr int TMB = MT * 32;        // coefficients per block
constexpr int TCH = 256;            // digits staged per chunk of t
constexpr int U = 8;                // t unroll (sliding-window length)

__host__ __device__ __forceinline__ int pad_idx(int y) { return y + (y >> 3); }

// acc[b, c<k, :] = 0;  acc[b, k, m] = (X^{r0} * lut)[m],
// r0 = (2N - b~) mod 2N,  lut = luts[lut_idx[b]].
__global__ void acc_init(const int32_t* __restrict__ cts_ms,
                         const int32_t* __restrict__ luts,
                         const int32_t* __restrict__ lut_idx,
                         uint32_t* __restrict__ acc, int B, int n, int k1,
                         int N) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * k1 * N) return;
  int m = (int)(e % N);
  int c = (int)((e / N) % k1);
  int b = (int)(e / ((long long)N * k1));
  uint32_t v = 0u;
  if (c == k1 - 1) {
    int twoN = 2 * N;
    int r0 = (twoN - cts_ms[(long long)b * (n + 1) + n]) & (twoN - 1);
    int s = (m - r0) & (twoN - 1);
    const uint32_t* lut =
        reinterpret_cast<const uint32_t*>(luts) + (long long)lut_idx[b] * N;
    v = s < N ? lut[s] : 0u - lut[s - N];
  }
  acc[e] = v;
}

// digits[b, c*l + j, m] = j-th most significant balanced digit of
// (X^{a_i} * acc[b, c])[m] - acc[b, c, m].
__global__ void stage1(const int32_t* __restrict__ cts_ms,
                       const uint32_t* __restrict__ acc,
                       int8_t* __restrict__ digits, int B, int n, int k1,
                       int N, int level, int base_log, int step) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * k1 * N) return;
  int m = (int)(e % N);
  int c = (int)((e / N) % k1);
  int b = (int)(e / ((long long)N * k1));
  int twoN = 2 * N;
  int a = cts_ms[(long long)b * (n + 1) + step];
  const uint32_t* p = acc + ((long long)b * k1 + c) * N;
  int s = (m - a) & (twoN - 1);
  uint32_t rot = s < N ? p[s] : 0u - p[s - N];
  uint32_t diff = rot - p[m];
  int shift = 32 - base_log * level;
  uint32_t state = (diff + (1u << (shift - 1))) >> shift;
  uint32_t base = 1u << base_log;
  uint32_t half = base >> 1;
  int8_t* out = digits + ((long long)b * k1 * level + (long long)c * level) * N + m;
  for (int j = level - 1; j >= 0; --j) {   // least significant first
    uint32_t d = state & (base - 1u);
    int sd = d >= half ? (int)d - (int)base : (int)d;
    state = (state - (uint32_t)sd) >> base_log;
    out[(long long)j * N] = (int8_t)sd;
  }
}

// acc[b, c, m] += sum_r sum_t digits[b, r, t] * dbl_{r,c}[(m - t) mod 2N]
// over the block's (batch tile, c, coefficient tile) and its one row r.
__global__ void __launch_bounds__(kWarps * 32)
ext_product(const int8_t* __restrict__ digits,
            const uint32_t* __restrict__ ggsw,   // this step: [rows, k1, N]
            uint32_t* __restrict__ acc, int B, int k1, int N, int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int win_len = N + TMB;
  uint32_t* win = smem;                                  // pad_idx(win_len)
  int32_t* dig = reinterpret_cast<int32_t*>(smem + pad_idx(win_len) + 8);

  const int mtiles = N / TMB;
  const int r = blockIdx.z;
  const int c = blockIdx.y / mtiles;
  const int M0 = (blockIdx.y % mtiles) * TMB;
  const int b0 = blockIdx.x * TBB;
  const int lane = threadIdx.x & 31;
  const int wb = threadIdx.x >> 5;

  // win[y] = dbl[(M0 - N + y) mod 2N], y in [0, N + TMB)
  const uint32_t* g = ggsw + ((long long)r * k1 + c) * N;
  for (int y = threadIdx.x; y < win_len; y += blockDim.x) {
    int z = (M0 - N + y) & (2 * N - 1);
    win[pad_idx(y)] = z < N ? g[z] : 0u - g[z - N];
  }

  uint32_t accv[BT][MT];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb)
#pragma unroll
    for (int j = 0; j < MT; ++j) accv[bb][j] = 0u;

  // coefficient m = M0 + lane*MT + j reads win at y = lane*MT + j - t + N
  const int ybase = lane * MT + N - (U - 1);
  const int8_t* drow = digits + (long long)r * N;
  const long long dstride = (long long)rows * N;

  for (int t0 = 0; t0 < N; t0 += TCH) {
    __syncthreads();   // window written / previous chunk consumed
    for (int e = threadIdx.x; e < TBB * TCH; e += blockDim.x) {
      int bb = e / TCH, tt = e % TCH;
      int b = b0 + bb;
      dig[tt * TBB + bb] = b < B ? (int32_t)drow[b * dstride + t0 + tt] : 0;
    }
    __syncthreads();
    for (int tu = 0; tu < TCH; tu += U) {
      const int t = t0 + tu;
      uint32_t kw[MT + U - 1];
#pragma unroll
      for (int q = 0; q < MT + U - 1; ++q) kw[q] = win[pad_idx(ybase - t + q)];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int4 dv =
            *reinterpret_cast<const int4*>(&dig[(tu + u) * TBB + wb * BT]);
        const uint32_t d[BT] = {(uint32_t)dv.x, (uint32_t)dv.y, (uint32_t)dv.z,
                                (uint32_t)dv.w};
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const uint32_t kv = kw[j - u + U - 1];
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) accv[bb][j] += d[bb] * kv;
        }
      }
    }
  }

#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
    int b = b0 + wb * BT + bb;
    if (b >= B) continue;
    uint32_t* out = acc + ((long long)b * k1 + c) * N + M0 + lane * MT;
#pragma unroll
    for (int j = 0; j < MT; ++j) atomicAdd(out + j, accv[bb][j]);
  }
}

}  // namespace

extern "C" {

// Shared memory of one ext_product block for polynomial size N.
static size_t ext_product_smem(int N) {
  return (size_t)(pad_idx(N + TMB) + 8) * sizeof(uint32_t) +
         (size_t)TCH * TBB * sizeof(int32_t);
}

// The whole blind rotation, enqueued on `stream`; returns a cudaError_t.
//   cts_ms  [B, n+1] int32 in [0, 2N)      luts [L, N]    lut_idx [B]
//   bsk     [n, k1*level, k1, N]           acc  [B, k1, N] (output)
//   digits  [B, k1*level, N] int8 scratch
// Needs N a power of two, a multiple of 256, and 32 - base_log*level >= 1.
int fhe_blind_rotate(const int32_t* cts_ms, const int32_t* luts,
                     const int32_t* lut_idx, const int32_t* bsk, int32_t* acc,
                     int8_t* digits, int B, int n, int k1, int N, int level,
                     int base_log, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  uint32_t* accu = reinterpret_cast<uint32_t*>(acc);
  const uint32_t* bsku = reinterpret_cast<const uint32_t*>(bsk);
  const int rows = k1 * level;
  const long long elems = (long long)B * k1 * N;
  const unsigned grid1 = (unsigned)((elems + kThreads1 - 1) / kThreads1);
  const dim3 grid2((B + TBB - 1) / TBB, k1 * (N / TMB), rows);
  const size_t smem = ext_product_smem(N);

  acc_init<<<grid1, kThreads1, 0, stream>>>(cts_ms, luts, lut_idx, accu, B, n,
                                            k1, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long step_stride = (long long)rows * k1 * N;
  for (int i = 0; i < n; ++i) {
    stage1<<<grid1, kThreads1, 0, stream>>>(cts_ms, accu, digits, B, n, k1, N,
                                            level, base_log, i);
    ext_product<<<grid2, kWarps * 32, smem, stream>>>(
        digits, bsku + i * step_stride, accu, B, k1, N, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
