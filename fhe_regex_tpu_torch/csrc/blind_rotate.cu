// Blind rotation for a batch of 32-bit TFHE bootstraps on Hopper (sm_90a).
//
// Replaces four kernels of fhe_regex_tpu/ops/pbs_pallas.py, each computing
// bit for bit what its plain twin in fhe_regex_tpu_torch/ops/pbs.py does:
//  * _fused_blindrot_kernel (the whole blind rotation of `pallas-fused`):
//    fhe_blind_rotate, [B, n+1] mod-switched ciphertexts -> [B, k+1, N]
//    accumulators (plain: blind_rotate);
//  * _fused_blindrot_bg_kernel (`pallas-bg`): fhe_blind_rotate_bg, the same
//    rotation over batch blocks of tb instances, one block after another;
//  * _stage1_kernel: fhe_stage1_digits, one `stage1` launch (plain:
//    stage1_digits);
//  * _ext_product_kernel: fhe_external_product_step, one `ext_product`
//    launch onto a copy of the accumulator (plain: external_product_step).
//    These two are the per-step backend `cuda`, whose step loop runs in
//    Python.
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
//  * fhe_blind_rotate_bg runs the same launches block by block.  A block's
//    working set is tb x (16 KB accumulator + 12 KB digits), 25 MB at the
//    default cap tb = 896: inside the 50 MB L2, where a whole B = 1792
//    batch (50 MB of accumulators and digits) is not.
//  * fhe_stage1_digits is bound by bytes (read the accumulator, write the
//    digits); fhe_external_product_step by the multiply-adds, as above.
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

// Shared memory of one ext_product block for polynomial size N.
size_t ext_product_smem(int N) {
  return (size_t)(pad_idx(N + TMB) + 8) * sizeof(uint32_t) +
         (size_t)TCH * TBB * sizeof(int32_t);
}

dim3 ext_product_grid(int B, int k1, int N, int rows) {
  return dim3((B + TBB - 1) / TBB, k1 * (N / TMB), rows);
}

unsigned elementwise_grid(int B, int k1, int N) {
  const long long elems = (long long)B * k1 * N;
  return (unsigned)((elems + kThreads1 - 1) / kThreads1);
}

// The whole blind rotation of B instances, enqueued on `stream`.
int rotate32(const int32_t* cts_ms, const int32_t* luts,
             const int32_t* lut_idx, const uint32_t* bsk, uint32_t* acc,
             int8_t* digits, int B, int n, int k1, int N, int level,
             int base_log, cudaStream_t stream) {
  const int rows = k1 * level;
  const unsigned grid1 = elementwise_grid(B, k1, N);
  const dim3 grid2 = ext_product_grid(B, k1, N, rows);
  const size_t smem = ext_product_smem(N);

  acc_init<<<grid1, kThreads1, 0, stream>>>(cts_ms, luts, lut_idx, acc, B, n,
                                            k1, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long step_stride = (long long)rows * k1 * N;
  for (int i = 0; i < n; ++i) {
    stage1<<<grid1, kThreads1, 0, stream>>>(cts_ms, acc, digits, B, n, k1, N,
                                            level, base_log, i);
    ext_product<<<grid2, kWarps * 32, smem, stream>>>(
        digits, bsk + i * step_stride, acc, B, k1, N, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The whole blind rotation, enqueued on `stream`; returns a cudaError_t.
//   cts_ms  [B, n+1] int32 in [0, 2N)      luts [L, N]    lut_idx [B]
//   bsk     [n, k1*level, k1, N]           acc  [B, k1, N] (output)
//   digits  [B, k1*level, N] int8 scratch
// Needs N a power of two, a multiple of 256, and 32 - base_log*level >= 1.
int fhe_blind_rotate(const int32_t* cts_ms, const int32_t* luts,
                     const int32_t* lut_idx, const int32_t* bsk, int32_t* acc,
                     int8_t* digits, int B, int n, int k1, int N, int level,
                     int base_log, void* stream_ptr) {
  return rotate32(cts_ms, luts, lut_idx, reinterpret_cast<const uint32_t*>(bsk),
                  reinterpret_cast<uint32_t*>(acc), digits, B, n, k1, N, level,
                  base_log, static_cast<cudaStream_t>(stream_ptr));
}

// The same rotation over batch blocks of tb instances, one after another
// (the `pallas-bg` kernel's counterpart, block-major as the JAX package
// runs it at 32 bits); tb divides B, and the one digits scratch is
// [tb, k1*level, N], reused by every block.
int fhe_blind_rotate_bg(const int32_t* cts_ms, const int32_t* luts,
                        const int32_t* lut_idx, const int32_t* bsk,
                        int32_t* acc, int8_t* digits, int B, int tb, int n,
                        int k1, int N, int level, int base_log,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const uint32_t* bsku = reinterpret_cast<const uint32_t*>(bsk);
  uint32_t* accu = reinterpret_cast<uint32_t*>(acc);
  for (int b0 = 0; b0 < B; b0 += tb) {
    int err = rotate32(cts_ms + (long long)b0 * (n + 1), luts, lut_idx + b0,
                       bsku, accu + (long long)b0 * k1 * N, digits, tb, n, k1,
                       N, level, base_log, stream);
    if (err != 0) return err;
  }
  return 0;
}

// One CMUX step's digits (the `_stage1_kernel` counterpart): digits[b, c*l
// + j, :] = j-th most significant balanced digit of X^{a[b]} * acc[b, c] -
// acc[b, c].  a [B] int32 in [0, 2N) is read as a one-column cts_ms (n = 0,
// step 0); acc [B, k1, N]; digits [B, k1*level, N] int8 (output).
int fhe_stage1_digits(const int32_t* a, const int32_t* acc, int8_t* digits,
                      int B, int k1, int N, int level, int base_log,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  stage1<<<elementwise_grid(B, k1, N), kThreads1, 0, stream>>>(
      a, reinterpret_cast<const uint32_t*>(acc), digits, B, 0, k1, N, level,
      base_log, 0);
  return (int)cudaGetLastError();
}

// One CMUX step's external product (the `_ext_product_kernel`
// counterpart): out = acc + sum_r digits[:, r] (*) ggsw_i[r, c] mod X^N+1,
// mod 2^32.  out starts as a copy of acc, so acc is left as it is.
//   digits [B, k1*level, N] int8   ggsw_i [k1*level, k1, N]
//   acc, out [B, k1, N]
int fhe_external_product_step(const int8_t* digits, const int32_t* ggsw_i,
                              const int32_t* acc, int32_t* out, int B, int k1,
                              int N, int level, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = k1 * level;
  cudaError_t err = cudaMemcpyAsync(
      out, acc, (size_t)B * k1 * N * sizeof(int32_t),
      cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  ext_product<<<ext_product_grid(B, k1, N, rows), kWarps * 32,
                ext_product_smem(N), stream>>>(
      digits, reinterpret_cast<const uint32_t*>(ggsw_i),
      reinterpret_cast<uint32_t*>(out), B, k1, N, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
