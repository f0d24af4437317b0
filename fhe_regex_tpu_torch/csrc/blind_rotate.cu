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
//  * _ext_product_kernel (:114): fhe_external_product_rows, one
//    `ext_product` launch onto a copy of the accumulator (plain:
//    external_product_step), over all of a step's digit rows, or over a
//    block of them, one rank's share of a step under tensor parallelism
//    (parallel/tensor.py).  With the digit pass it is the per-step backend
//    `cuda`, whose step loop runs in Python.
// The external product inside _fused_blindrot_kernel (:358) and
// _fused_blindrot_bg_kernel (:713) is the same `ext_product` device code,
// unless the rotation is given the key's spectrum: then it is the float64
// spectral external product of `spectral::ext_product`
// (fhe_blind_rotate_spectral, at the end of this file), which
// cuda-fused and cuda-bg run at the production set.  `ext_product` stays
// the per-step backend's (`cuda`) and the tensor-parallel path's.
//
// What bounds it.  Every CMUX step is an external product of the B
// accumulators' digits with the step's GGSW, a [B, (k+1)l*N] x
// [(k+1)l*N, (k+1)*N] product whose right side is negacyclic Toeplitz.  At
// the production set (n=866, N=2048, k=1, l=3) that is
// 866 * 12 * N^2 ~= 4.4e10 32-bit multiply-adds per bootstrap.  Split into
// four int8 limbs of the key it is 4x as many int8 multiply-adds, which
// the tensor cores run at 1,979 TOP/s dense: 0.052 ms per step at B = 256,
// the bound.  The accumulators (B * 16 KB) and one step's GGSW (96 KB)
// stay in the 50 MB L2.
//
// What the design does about it (`ext_product`).
//  * A limb GEMM on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 ->
//    s32).  Each key word of the doubled window [g, -g mod 2^32] is split
//    into four balanced int8 limbs, g and -g each on its own (no limb is
//    ever negated: -(-128) is not an int8).  Digits lie in [-64, 64), so a
//    limb product over all (k+1)l*N = 12288 terms is at most
//    12288 * 64 * 128 ~= 1.0e8 < 2^31: exact in int32.  The epilogue
//    combines sum_l 2^(8l) * P_l mod 2^32 in uint32.
//  * No Toeplitz matrix in memory.  A B-fragment register of m16n8k32 is 4
//    consecutive K entries (t) of one column (m), i.e. 4 consecutive
//    entries of the REVERSED key window rev[y] = dbl[(M0 + TN - 1 - y) mod
//    2N], y = t + M0 + TN - 1 - m.  The block keeps each limb's reversed
//    window in shared memory in 4 byte-shifted copies (copy s holds rev
//    from byte s), so every fragment register is one aligned 32-bit load.
//    A lane always reads copy (3 - groupID) & 3; copies are laid out 8
//    banks apart, so a warp's loads do not conflict.
//  * The digits (the left operand, contiguous along t) are staged in
//    shared memory with cp.async in a two-stage ring of 256-deep chunks
//    (half as many waits on the ring as 128-deep ones), rows padded by 16
//    bytes so the A-fragment loads hit 32 banks.
//  * The grid spans (batch tile, component x 64-coefficient tile, digit
//    row): a batch tile is 16, 32 or 64 rows (MT = 1, 2, 4 m16 tiles per
//    warp) by the batch, so an 8-wide level pads to 16 rows and still runs
//    ~400 blocks.  Digit rows meet through 32-bit atomic adds, exact mod
//    2^32 in any order.
//  * Per step: one `stage1` launch (rotate by a~_i, subtract, round,
//    balanced digits into an int8 scratch) and one `ext_product` launch.
//    The step loop runs on the host side of this library, so a level of
//    any width spreads every step over the whole card.
//  * Inside a rotation both launches are programmatic dependent launches
//    (hopper.cuh): `ext_product` lets the next `stage1` start once its
//    products are summed, so that one is resident, `a` read, while the
//    epilogue drains; `ext_product` starts as `stage1`'s blocks exit, with
//    no launch gap.  Each waits for the one before before it reads or
//    writes what that one touches.
//  * fhe_blind_rotate_bg runs the same launches block by block.  A block's
//    working set is tb x (16 KB accumulator + 12 KB digits), 25 MB at the
//    default cap tb = 896: inside the 50 MB L2.
//
// The digit pass (`stage1`, the port of _stage1_kernel :235) is bound by
// bytes: read the accumulator once, write l int8 digit planes, B * (k+1) *
// N * (4 + l) bytes, 7 MB at B = 256 (2.2 us at 3.35 TB/s).  Its design:
//  * The grid is (batch row, coefficient segment, component), indices from
//    blockIdx alone (no division); segments of S = 128 ... 1024
//    coefficients, as long as B * (k+1) * N / S still fills the 132 SMs
//    (S = 128 at B = 8, 1024 at B >= 37 for N = 2048).
//  * The block reads a = cts_ms[b, step] once, then stages its segment of
//    the row and the rotated source run (at most two runs of the row, the
//    sign flipped past N) into shared memory with 16-byte loads, all of a
//    thread's in flight together, padded so a warp's reads hit 32 banks
//    (hopper.cuh).
//  * Each thread rounds and decomposes 16 consecutive coefficients and
//    writes each of the l digit planes with one 16-byte store.
//
// All torus arithmetic is uint32_t: wraparound is defined there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads1 = 256;      // acc_init block
constexpr int kWarpsE = 4;          // warps per ext_product block
constexpr int NT = 2;               // n8 tiles per warp
constexpr int TN = kWarpsE * NT * 8;  // coefficients per block (64)
constexpr int KC = 256;             // digits (t) staged per chunk
constexpr int ASTRIDE = KC + 16;    // bytes per staged digit row
constexpr int NSTAGE = 2;           // cp.async ring depth
constexpr int NLIMB = 4;            // int8 limbs of a key word
constexpr int NCOPY = 4;            // byte-shifted copies of a window

// Words of one shifted window copy, and the stride between copies: at
// least that, and 8 mod 32 so the four copies sit 8 banks apart.
__host__ __device__ __forceinline__ int win_words(int N) { return (N + TN) / 4; }
__host__ __device__ __forceinline__ int win_stride(int N) {
  return ((win_words(N) - 8 + 31) / 32) * 32 + 8;
}

// The four balanced int8 limbs of w (w = sum_l 2^(8l) limb_l mod 2^32),
// limb l in byte l.
__device__ __forceinline__ uint32_t limbs8(uint32_t w) {
  uint32_t out = 0u;
#pragma unroll
  for (int l = 0; l < NLIMB; ++l) {
    const int v = (int)(int8_t)(w & 0xFFu);
    out |= (uint32_t)(uint8_t)v << (8 * l);
    w = (w - (uint32_t)v) >> 8;
  }
  return out;
}

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
// (X^a * acc[b, c])[m] - acc[b, c, m], a = cts_ms[b, step], for m in the
// block's segment [m0, m0 + S), S = 16 * blockDim.x; grid (b, segment, c).
__global__ void __launch_bounds__(kSegMax / kPerThread)
stage1(const int32_t* __restrict__ cts_ms, const uint32_t* __restrict__ acc,
       int8_t* __restrict__ digits, int n, int k1, int N, int level,
       int base_log, int step) {
  extern __shared__ __align__(16) uint32_t sm1[];
  __shared__ int a_s;
  const int S = blockDim.x * kPerThread;
  const int b = blockIdx.x, m0 = blockIdx.y * S, c = blockIdx.z;
  const int t = threadIdx.x;
  if (t == 0) a_s = cts_ms[(size_t)b * (n + 1) + step];
  const uint32_t* p = acc + ((size_t)b * k1 + c) * N;
  pdl_wait();                                // acc is the last step's
  const int s0 = stage_digit_runs(sm1, p, m0, &a_s, N);  // m0's source
  const int off = s0 & 3;                    // s0 - its 16-byte group
  const uint32_t* acc_s = sm1;
  const uint32_t* src_s = sm1 + spad_words(S);

  const int shift = 32 - base_log * level;
  const uint32_t rnd = 1u << (shift - 1);
  uint32_t st[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = t * kPerThread + q;
    const uint32_t v = src_s[spad(off + i)];
    const uint32_t rot = ((s0 + i) & N) ? 0u - v : v;   // past N: -p
    st[q] = (rot - acc_s[spad(i)] + rnd) >> shift;
  }
  const uint32_t mask = (1u << base_log) - 1u, half = 1u << (base_log - 1);
  int8_t* out = digits + ((size_t)b * k1 + c) * level * N + m0 + t * kPerThread;
  for (int j = level - 1; j >= 0; --j) {   // least significant first
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const uint32_t d = st[q] & mask;
      const uint32_t sd = d >= half ? d - mask - 1u : d;   // balanced
      st[q] = (st[q] - sd) >> base_log;
      w[q >> 2] |= (sd & 0xFFu) << (8 * (q & 3));
    }
    *reinterpret_cast<uint4*>(out + (size_t)j * N) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One stage1 launch on `stream`, a programmatic dependent launch inside a
// rotation (`pdl`), an ordinary one alone.
int launch_stage1(const int32_t* cts_ms, const uint32_t* acc, int8_t* digits,
                  int B, int n, int k1, int N, int level, int base_log,
                  int step, bool pdl, cudaStream_t stream) {
  const int S = stage1_segment(B, k1, N);
  const dim3 grid(B, N / S, k1), block(S / kPerThread);
  const size_t smem = stage1_smem<uint32_t>(S);
  if (pdl)
    return launch_pdl(stage1, grid, block, smem, stream, cts_ms, acc, digits,
                      n, k1, N, level, base_log, step);
  stage1<<<grid, block, smem, stream>>>(cts_ms, acc, digits, n, k1, N, level,
                                        base_log, step);
  return (int)cudaGetLastError();
}

// acc[b, c, m] += sum_t digits[b, r, t] * dbl_{r,c}[(m - t) mod 2N] over
// the block's batch tile (16 * MT rows from b0), component c, coefficient
// tile [M0, M0 + TN) and its one digit row r.
template <int MT>
__global__ void __launch_bounds__(kWarpsE * 32)
ext_product(const int8_t* __restrict__ digits,
            const uint32_t* __restrict__ ggsw,   // this step: [rows, k1, N]
            uint32_t* __restrict__ acc, int B, int k1, int N, int rows) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) uint32_t smem[];
  const int stride = win_stride(N);
  uint32_t* win = smem;                       // [limb][copy][stride] words
  int8_t* a_s = reinterpret_cast<int8_t*>(smem + NLIMB * NCOPY * stride);

  const int ntiles = N / TN;
  const int r = blockIdx.z;
  const int c = blockIdx.y / ntiles;
  const int M0 = (blockIdx.y % ntiles) * TN;
  const int b0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long dstride = (long long)rows * N;

  // rows past the batch stay zero in both stages; the rest arrive by
  // cp.async, chunk kc into stage kc % NSTAGE
  for (int e = tid; e < NSTAGE * BM * (KC / 16); e += blockDim.x) {
    const int row = (e / (KC / 16)) % BM;
    if (b0 + row >= B)
      *reinterpret_cast<int4*>(a_s + (e / (KC / 16)) * ASTRIDE +
                               (e % (KC / 16)) * 16) = make_int4(0, 0, 0, 0);
  }
  auto stage_chunk = [&](int kc) {
    int8_t* dst = a_s + (kc % NSTAGE) * BM * ASTRIDE;
    for (int e = tid; e < BM * (KC / 16); e += blockDim.x) {
      const int row = e / (KC / 16), q = e % (KC / 16);
      const int b = b0 + row;
      if (b < B)
        cp_async16(dst + row * ASTRIDE + q * 16,
                   digits + b * dstride + (long long)r * N + kc * KC + q * 16);
    }
    cp_async_commit();
  };
  pdl_wait();            // the digits and acc of this step's stage1
  stage_chunk(0);

  // the reversed windows: rev[y] = dbl[(M0 + TN - 1 - y) mod 2N], copy s
  // word i = limb bytes of rev[4i + s .. 4i + s + 3]
  const uint32_t* gp = ggsw + ((long long)r * k1 + c) * N;
  for (int i = tid; i < win_words(N); i += blockDim.x) {
    uint32_t lim[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const int z = (M0 + TN - 1 - (4 * i + q)) & (2 * N - 1);
      lim[q] = limbs8(z < N ? gp[z] : 0u - gp[z - N]);
    }
#pragma unroll
    for (int l = 0; l < NLIMB; ++l)
#pragma unroll
      for (int s = 0; s < NCOPY; ++s) {
        uint32_t v = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v |= ((lim[s + j] >> (8 * l)) & 0xFFu) << (8 * j);
        win[(l * NCOPY + s) * stride + i] = v;
      }
  }

  int p[MT][NT][NLIMB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int l = 0; l < NLIMB; ++l)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[mt][nt][l][q] = 0;

  // this lane's B fragments: column m = M0 + warp*NT*8 + nt*8 + g, rows
  // t = t0 + tig*4 + {0..3} (b0) and +16 (b1): y = t + TN - 1 - (m - M0)
  const int s = (3 - g) & 3;
  const uint32_t* wl = win + s * stride;
  const int nchunks = N / KC;
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) stage_chunk(kc + 1);
    else cp_async_commit();                 // keep one group per chunk
    cp_async_wait1();
    __syncthreads();   // chunk kc (and, at kc = 0, the windows) visible
    const int8_t* at = a_s + (kc % NSTAGE) * BM * ASTRIDE;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* ap = at + (mt * 16 + g) * ASTRIDE + ks * 32 + tig * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * ASTRIDE);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * ASTRIDE + 16);
      }
      const int t0 = kc * KC + ks * 32;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int yb = t0 + tig * 4 + TN - 1 - (warp * NT * 8 + nt * 8 + g);
        const uint32_t* bp = wl + ((yb - s) >> 2);
#pragma unroll
        for (int l = 0; l < NLIMB; ++l) {
          const uint32_t bf0 = bp[l * NCOPY * stride];
          const uint32_t bf1 = bp[l * NCOPY * stride + 4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(p[mt][nt][l], af[mt], bf0, bf1);
        }
      }
    }
    __syncthreads();   // stage kc % NSTAGE consumed before it is refilled
  }
  pdl_launch_dependents();   // the next digit pass may start; it waits

  // d fragment q: row g (+8 for q >= 2), column 2*tig + (q & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + mt * 16 + g + (q >= 2 ? 8 : 0);
      if (b >= B) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t v = 0u;
#pragma unroll
        for (int l = 0; l < NLIMB; ++l) v += (uint32_t)p[mt][nt][l][q] << (8 * l);
        const int m = M0 + warp * NT * 8 + nt * 8 + 2 * tig + (q & 1);
        atomicAdd(acc + ((long long)b * k1 + c) * N + m, v);
      }
    }
}

// Batch rows per ext_product block, in m16 tiles: 1 up to 16 rows, 2 up
// to 32, else 4.
int ext_mt(int B) { return B <= 16 ? 1 : (B <= 32 ? 2 : 4); }

size_t ext_product_smem(int N, int mt) {
  return (size_t)NLIMB * NCOPY * win_stride(N) * sizeof(uint32_t) +
         (size_t)NSTAGE * 16 * mt * ASTRIDE;
}

// One ext_product launch on `stream` (after its shared-memory opt-in,
// raised once per instance to the largest size asked for), a programmatic
// dependent launch inside a rotation (`pdl`); returns a cudaError_t.
int launch_ext_product(const int8_t* digits, const uint32_t* ggsw,
                       uint32_t* acc, int B, int k1, int N, int rows,
                       bool pdl, cudaStream_t stream) {
  static size_t opted[3] = {0, 0, 0};
  const int mt = ext_mt(B);
  const int which = mt == 1 ? 0 : (mt == 2 ? 1 : 2);
  const dim3 grid((B + 16 * mt - 1) / (16 * mt), k1 * (N / TN), rows);
  const size_t smem = ext_product_smem(N, mt);
  void (*kern)(const int8_t*, const uint32_t*, uint32_t*, int, int, int, int) =
      mt == 1 ? ext_product<1> : (mt == 2 ? ext_product<2> : ext_product<4>);
  if (smem > opted[which]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted[which] = smem;
  }
  if (pdl)
    return launch_pdl(kern, grid, dim3(kWarpsE * 32), smem, stream, digits,
                      ggsw, acc, B, k1, N, rows);
  kern<<<grid, kWarpsE * 32, smem, stream>>>(digits, ggsw, acc, B, k1, N,
                                             rows);
  return (int)cudaGetLastError();
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

  acc_init<<<grid1, kThreads1, 0, stream>>>(cts_ms, luts, lut_idx, acc, B, n,
                                            k1, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long step_stride = (long long)rows * k1 * N;
  for (int i = 0; i < n; ++i) {
    int e = launch_stage1(cts_ms, acc, digits, B, n, k1, N, level, base_log,
                          i, true, stream);
    if (e != 0) return e;
    e = launch_ext_product(digits, bsk + i * step_stride, acc, B, k1, N, rows,
                           true, stream);
    if (e != 0) return e;
  }
  return 0;
}

// ---- the spectral external product: cuda-fused and cuda-bg at N = 2048 ----
//
// Replaces, on those two backends, the step above (`stage1`, then the int8
// limb GEMM `ext_product`) by the float64 FFT formulation of
// ops/pbs_fft.py, on a key spectrum of its own limb plan (SPECTRAL_PLAN =
// (16, 16), complex128, [n, (k+1)l, k+1, 2, N/2], 341 MB at the production
// set; the `fft` backend keeps PLAN = (16, 8, 8)) that prepare_server_key
// makes on the card.  One block runs the whole rotation of T instances:
// their accumulators and every step's spectra stay in its shared memory,
// and no block waits on another, so the n steps need no launch between
// them (the two launches a step of the limb path would move each step's
// spectra, 96 KB an instance, through L2 and back).  Each step, for each
// instance:
//  1. the digit pass of `stage1` (X^{a_i} acc - acc, rounded, l balanced
//     digits), once a coefficient, into the head of each row's slot as
//     int8; each of the (k+1)l digit rows folded to M = N/2 complex points
//     u_j = (d_j + i d_{j+M}) t_j, t_j = e^{i pi j/N}, and transformed: a
//     Stockham FFT (natural order in and out) of radix 16, 16, 4, 64
//     threads a transform, 16 points a thread in registers;
//  2. the contraction: each frequency of the (k+1) x 2 outputs (component,
//     key limb) is the sum over the rows of digit spectrum x key spectrum,
//     written over the first 4 digit spectra; one thread a frequency for
//     all T instances, so each key value read serves T of them;
//  3. the inverse transforms, 1/M and the untwist; each limb rounded to its
//     integer, the two joined as limb 0 + 2^16 limb 1 and added into the
//     accumulator mod 2^32.
// Exactness: each limb's value is an integer below 64 * 2^15 * N * (k+1)l
// ~= 2^34.6 (digits |d| <= 64, both 16-bit limbs |k| <= 2^15: the high
// limb at weight 2^16 has the bound of the low one), far inside the 53-bit
// mantissa; on the worst input (every digit -64 or 64, every key word
// 0x7FFF8000, both limbs -2^15) the CPU tests find no limb further than
// 1.53e-5 from its integer, so rounding gives the integer and the step is
// the exact external product, bit for bit.  The CPU tests hold a twin of
// this arithmetic, its passes, swz and at16 included
// (tests/test_torch_kernels32.py, _spectral_step), to the exact one.
//
// What bounds it.  Per instance and step, 6 forward and 4 inverse
// length-1024 transforms and 24 x 1024 complex multiply-adds, ~0.7 MFLOP
// of float64: 4.0 ms a rotation at B = 256 at 34 TFLOP/s outside the
// tensor cores (and 67 on them for the contraction).  Every block reads
// the step's key spectrum, 393 KB, from L2 (from device memory once a
// step).  What the design does:
//  * T = 2 instances a block above one wave of the card (B > 132) halve
//    the key traffic an instance; T = 1 below, so a narrow batch spreads
//    over B SMs, and below half a wave (2 B <= the SM count) the cluster
//    pair of `pair::ext_product` spreads it over 2 B.  Shared memory is T
//    x (6 x 16 KB of spectra + 16 KB of accumulator), 229,376 bytes at T =
//    2 of the 232,448 a block may have: one block an SM, 12 warps, 168
//    registers a thread, no spills.  The key
//    goes around L1 (ld.global.cg), so the twist and twiddle tables (32 KB)
//    keep what is left of it.
//  * Forward: 6 T transforms on 6 groups of 64 threads, T rounds.  Inverse:
//    4 T transforms on the same 6 groups, so rounds would leave groups
//    idle (T = 1: 2 of 6; T = 2: 4 of 6 in a second round).  Its passes 1
//    and 2 run a transform a group on the group's own named barrier, and a
//    group past its last transform goes on to the block barrier; pass 3
//    runs over the whole block, a thread an (instance, component,
//    butterfly) with both limbs, so each accumulator word has one writer
//    and needs no atomic.  (Measured against it: rounds on block barriers
//    with atomics spill and take 20.9 / 134 ms at B = 8 / 1024; the forward
//    on group barriers, the idle groups of a T = 2 second round taking the
//    pass 3 of the pairs already done, and a digit pass unrolled by 4 each
//    moved no width beyond 2 %.)
//  * Shared accesses are conflict-free: every point is read and written at
//    swz(k) = k ^ ((k >> 4) & 7), which puts each 8 lanes of a quarter-warp
//    on 8 distinct 16-byte slots in every access pattern of the passes.
//  * A pass's twiddles are powers of one table entry, w^{q s} = (w^s)^q,
//    taken by multiplication: shared memory and L1 share one path, and
//    15 loads a point set of pass 2 held it (measured: pass 2 at half the
//    time without them).
// Measured (H100 SXM, 700 W): a rotation at B = 8 / 256 / 1024 takes 10.1 /
// 17.6 / 70 ms (on the three-limb plan (16, 8, 8) 12.7 / 22.6 / 90, the
// limb GEMM's 17.4 / 139 / 529).  By phase (clock64 of block 0, a build
// with FHE_SPECTRAL_CLOCKS), a step at T = 1 takes 23.1k clocks: digits
// and pass 1 28 %, forward passes 2 and 3 19 %, contraction 29 %, inverse
// 24 % (three limbs: 28.8k; 22, 15, 32, 31 %); at T = 2, 40.9k: 29 %,
// 21 %, 25 %, 25 % (three limbs: 51.5k; 23, 17, 28, 32 %).
namespace spectral {

constexpr int N = 2048, M = N / 2;     // coefficients; points a transform
constexpr int K1 = 2, LEVEL = 3;       // components; gadget levels
constexpr int ROWS = K1 * LEVEL;       // digit rows (forward transforms)
constexpr int NL = 2;                  // key limbs, SPECTRAL_PLAN (16, 16)
constexpr int LIMB_BITS = 16;          // weight of limb 1
constexpr int OUTS = K1 * NL;          // inverse transforms
constexpr int FT = 64;                 // threads a transform
constexpr int GROUPS = 6;              // transforms in flight
constexpr int THREADS = FT * GROUPS;   // 384
constexpr int BFLY = M / 4;            // radix-4 butterflies of pass 3
static_assert(ROWS == GROUPS, "forward: one slot a group and round");
static_assert(OUTS <= ROWS, "outputs written over the digit spectra");
static_assert(M == FT * 16, "passes 1 and 2: 16 points a thread");

#ifdef FHE_SPECTRAL_CLOCKS
constexpr bool kClocks = true;
#else
constexpr bool kClocks = false;
#endif
// clock64() ticks of block 0's thread 0 by phase (digits and pass 1,
// forward passes 2 and 3, contraction, inverse), summed over the steps,
// [T - 1][phase] for ext_product<T>, row 2 for the cluster pair, whose
// column PHASES holds the part of its contraction spent in the exchange
// (its last remote store to the end of the cluster barrier); written only
// in a build with FHE_SPECTRAL_CLOCKS defined
constexpr int PHASES = 4;
constexpr int CLOCK_ROWS = 3, CLOCK_COLS = PHASES + 1;
__device__ unsigned long long phase_clocks[CLOCK_ROWS][CLOCK_COLS];

__host__ __device__ constexpr size_t smem_bytes(int T) {
  return (size_t)T * (ROWS * M * sizeof(double2) + K1 * N * sizeof(uint32_t));
}

__device__ __forceinline__ int swz(int k) { return k ^ ((k >> 4) & 7); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ double2 cfma(double2 a, double2 b, double2 c) {
  return make_double2(fma(a.x, b.x, fma(-a.y, b.y, c.x)),
                      fma(a.x, b.y, fma(a.y, b.x, c.y)));
}
// table entry k, conjugated for the inverse transform
template <bool INV>
__device__ __forceinline__ double2 tab(const double2* t, int k) {
  const double2 v = __ldg(t + k);
  return INV ? make_double2(v.x, -v.y) : v;
}

// 4-point DFT in place, e^{-2 pi i/4} (forward) or e^{+2 pi i/4}.
template <bool INV>
__device__ __forceinline__ void dft4(double2& a, double2& b, double2& c,
                                     double2& d) {
  const double2 t0 = cadd(a, c), t1 = csub(a, c), t2 = cadd(b, d);
  double2 t3 = csub(b, d);
  t3 = INV ? make_double2(-t3.y, t3.x) : make_double2(t3.y, -t3.x);
  a = cadd(t0, t2);
  c = csub(t0, t2);
  b = cadd(t1, t3);
  d = csub(t1, t3);
}

// 16-point DFT as 4 x 4: X[q] ends in x[at16(q)] = x[4 (q % 4) + q / 4].
template <bool INV>
__device__ __forceinline__ void dft16(double2 (&x)[16]) {
  constexpr double C[10] = {1.0, 0.92387953251128674, 0.70710678118654752,
                            0.38268343236508978, 0.0, -0.38268343236508978,
                            -0.70710678118654752, -0.92387953251128674,
                            -1.0, -0.92387953251128674};
  constexpr double S[10] = {0.0, 0.38268343236508978, 0.70710678118654752,
                            0.92387953251128674, 1.0, 0.92387953251128674,
                            0.70710678118654752, 0.38268343236508978,
                            0.0, -0.38268343236508978};
#pragma unroll
  for (int n1 = 0; n1 < 4; ++n1)
    dft4<INV>(x[n1], x[n1 + 4], x[n1 + 8], x[n1 + 12]);
#pragma unroll
  for (int n1 = 1; n1 < 4; ++n1)
#pragma unroll
    for (int k2 = 1; k2 < 4; ++k2) {
      const int p = n1 * k2;                  // e^{-+2 pi i p/16}
      x[n1 + 4 * k2] = cmul(x[n1 + 4 * k2],
                            make_double2(C[p], INV ? S[p] : -S[p]));
    }
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2)
    dft4<INV>(x[4 * k2], x[4 * k2 + 1], x[4 * k2 + 2], x[4 * k2 + 3]);
}
__device__ __forceinline__ int at16(int q) { return 4 * (q & 3) + (q >> 2); }

// Pass 1 (radix 16, Ns = 1) of the round's transforms, in place: x holds
// this thread's points j + 64 q; barrier (every point of the slots read),
// then outputs 16 j + q.
__device__ __forceinline__ void pass1_store(double2* s, double2 (&x)[16],
                                            int j) {
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 16; ++q) s[swz(j * 16 + q)] = x[at16(q)];
}

// The barrier of group g's FT threads alone (named barrier 1 + g; 0 is
// __syncthreads's): a transform's passes touch its own slot only.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(FT) : "memory");
}

// Pass 2 (radix 16, Ns = 16) of slot s, its first half: this thread's
// points j + 64 q, twiddled and transformed in x.
template <bool INV>
__device__ __forceinline__ void pass2_load(const double2* s, const double2* w,
                                           int j, double2 (&x)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) x[q] = s[swz(j + FT * q)];
  const double2 w1 = tab<INV>(w, (j & 15) * 4);
  double2 wq = w1;                            // w^{4 (j mod 16) q}
#pragma unroll
  for (int q = 1; q < 16; ++q) {
    x[q] = cmul(x[q], wq);
    wq = cmul(wq, w1);
  }
  dft16<INV>(x);
}
// ... and its second half, after a barrier: outputs (j div 16) 256 + (j mod
// 16) + 16 q.
__device__ __forceinline__ void pass2_store(double2* s,
                                            const double2 (&x)[16], int j) {
  const int base = (j >> 4) * 256 + (j & 15);
#pragma unroll
  for (int q = 0; q < 16; ++q) s[swz(base + 16 * q)] = x[at16(q)];
}

// Pass 2 of every forward transform of the block, in place: read all,
// barrier, write all, a round of GROUPS transforms at a time.
template <int T>
__device__ __forceinline__ void pass2_forward(double2* sp, const double2* w,
                                              int g, int j) {
#pragma unroll
  for (int f = g; f < T * ROWS; f += GROUPS) {
    double2* s = sp + f * M;
    double2 x[16];
    pass2_load<false>(s, w, j, x);
    __syncthreads();
    pass2_store(s, x, j);
  }
  __syncthreads();
}

// Pass 3 (radix 4, Ns = 256) of butterfly jj of slot s: its points jj +
// 256 q, read and transformed in x (each thread's butterflies are its own).
template <bool INV>
__device__ __forceinline__ void pass3(const double2* s, const double2* w,
                                      int jj, double2 (&x)[4]) {
  const double2 v1 = tab<INV>(w, jj), v2 = cmul(v1, v1);
  x[0] = s[swz(jj)];
  x[1] = cmul(s[swz(jj + 256)], v1);
  x[2] = cmul(s[swz(jj + 512)], v2);
  x[3] = cmul(s[swz(jj + 768)], cmul(v2, v1));
  dft4<INV>(x[0], x[1], x[2], x[3]);
}

// The whole rotation of instances [T blockIdx.x, + T): acc_out [B, K1, N].
// key [n, ROWS, K1, NL, M] complex128; tables [2, M]: the twist, then the
// twiddles w_k = e^{-2 pi i k/M}.
template <int T>
__global__ void __launch_bounds__(THREADS, 1)
ext_product(const int32_t* __restrict__ cts_ms,
            const int32_t* __restrict__ luts,
            const int32_t* __restrict__ lut_idx,
            const double2* __restrict__ key,
            const double2* __restrict__ tables, int32_t* __restrict__ acc_out,
            int B, int n, int base_log) {
  extern __shared__ __align__(16) double2 sp[];   // [T][ROWS][M], swizzled
  uint32_t* acc = reinterpret_cast<uint32_t*>(sp + T * ROWS * M);  // [T][K1][N]
  const double2* twist = tables;
  const double2* w = tables + M;
  const int tid = threadIdx.x, g = tid / FT, j = tid % FT;
  const int b0 = blockIdx.x * T;
  const int shift = 32 - base_log * LEVEL;
  const uint32_t mask = (1u << base_log) - 1u, half = 1u << (base_log - 1);

  // acc0 = (0, X^{-b~} lut); a tile's instances past B stay zero
  for (int e = tid; e < T * K1 * N; e += THREADS) {
    const int t = e / (K1 * N), c = (e / N) % K1, m = e % N, b = b0 + t;
    uint32_t v = 0u;
    if (c == K1 - 1 && b < B) {
      const int r0 = (2 * N - cts_ms[(size_t)b * (n + 1) + n]) & (2 * N - 1);
      const int s = (m - r0) & (2 * N - 1);
      const uint32_t* lut =
          reinterpret_cast<const uint32_t*>(luts) + (size_t)lut_idx[b] * N;
      v = s < N ? lut[s] : 0u - lut[s - N];
    }
    acc[e] = v;
  }
  __syncthreads();

  // block 0's thread 0 times the phases of each step (FHE_SPECTRAL_CLOCKS)
  unsigned long long ticks[PHASES] = {}, t_last = 0;
  auto mark = [&](int p) {
    if constexpr (kClocks) {
      if (blockIdx.x == 0 && tid == 0) {
        const unsigned long long now = clock64();
        ticks[p] += now - t_last;
        t_last = now;
      }
    }
  };

  for (int i = 0; i < n; ++i) {
    if constexpr (kClocks) t_last = clock64();
    // 1. the digits of each row into the head of its slot, as int8
    for (int e = tid; e < T * K1 * N; e += THREADS) {
      const int t = e / (K1 * N), c = (e / N) % K1, m = e % N;
      const int a = cts_ms[(size_t)min(b0 + t, B - 1) * (n + 1) + i];
      const uint32_t* p = acc + (t * K1 + c) * N;
      const int s = (m - a) & (2 * N - 1);
      const uint32_t v = p[s & (N - 1)];
      uint32_t st =
          (((s & N) ? 0u - v : v) - p[m] + (1u << (shift - 1))) >> shift;
#pragma unroll
      for (int lev = LEVEL - 1; lev >= 0; --lev) {  // least significant first
        const uint32_t d = st & mask;
        const uint32_t sd = d >= half ? d - mask - 1u : d;   // balanced
        st = (st - sd) >> base_log;
        reinterpret_cast<int8_t*>(sp + (t * ROWS + c * LEVEL + lev) * M)[m] =
            (int8_t)sd;
      }
    }
    __syncthreads();
    // fold, twist, passes 1, 2 and 3 of the forward transforms
#pragma unroll
    for (int f = g; f < T * ROWS; f += GROUPS) {
      const int8_t* dg = reinterpret_cast<const int8_t*>(sp + f * M);
      double2 x[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int m = j + FT * q;
        x[q] = cmul(make_double2(dg[m], dg[m + M]), __ldg(twist + m));
      }
      dft16<false>(x);
      pass1_store(sp + f * M, x, j);
    }
    __syncthreads();
    mark(0);
    pass2_forward<T>(sp, w, g, j);
#pragma unroll
    for (int f = g; f < T * ROWS; f += GROUPS) {
      double2* s = sp + f * M;
#pragma unroll 1
      for (int u = 0; u < 4; ++u) {
        const int jj = j + FT * u;
        double2 x[4];
        pass3<false>(s, w, jj, x);
#pragma unroll
        for (int q = 0; q < 4; ++q) s[swz(jj + 256 * q)] = x[q];
      }
    }
    __syncthreads();
    mark(1);

    // 2. the contraction, frequency by frequency, into slot o = c NL + limb
    // of each instance
    const double2* ki = key + (size_t)i * ROWS * OUTS * M;
    for (int jf = tid; jf < M; jf += THREADS) {
      const int k = swz(jf);
      double2 d[T][ROWS];
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) d[t][r] = sp[(t * ROWS + r) * M + k];
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
        double2 y[T];
#pragma unroll
        for (int t = 0; t < T; ++t) y[t] = make_double2(0.0, 0.0);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const double2 kv = __ldcg(ki + (r * OUTS + o) * M + jf);
#pragma unroll
          for (int t = 0; t < T; ++t) y[t] = cfma(d[t][r], kv, y[t]);
        }
#pragma unroll
        for (int t = 0; t < T; ++t) sp[(t * ROWS + o) * M + k] = y[t];
      }
    }
    __syncthreads();
    mark(2);

    // 3. the inverse transforms.  Passes 1 and 2 a transform a group, each
    // group on its own barrier, so that the T OUTS transforms cost their
    // number, not rounds of GROUPS: a group past its last transform waits
    // at the block barrier only.
    for (int f = g; f < T * OUTS; f += GROUPS) {
      double2* s = sp + ((f / OUTS) * ROWS + f % OUTS) * M;
      double2 x[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) x[q] = s[swz(j + FT * q)];
      dft16<true>(x);
      group_sync(g);
#pragma unroll
      for (int q = 0; q < 16; ++q) s[swz(j * 16 + q)] = x[at16(q)];
      group_sync(g);
      pass2_load<true>(s, w, j, x);
      group_sync(g);
      pass2_store(s, x, j);
    }
    __syncthreads();
    // Pass 3 over the whole block, a (instance, component, butterfly) a
    // thread at a time: both limbs' outputs, untwisted, divided by M,
    // rounded, joined as limb 0 + 2^16 limb 1 and added into acc, whose
    // words this thread alone writes.
    for (int e = tid; e < T * K1 * BFLY; e += THREADS) {
      const int tc = e / BFLY, jj = e % BFLY;
      const double2* s = sp + ((tc / K1) * ROWS + (tc % K1) * NL) * M;
      double2 lo[4], hi[4];
      pass3<true>(s, w, jj, lo);
      pass3<true>(s + M, w, jj, hi);
      uint32_t* p = acc + tc * N;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = jj + 256 * q;
        const double2 tw = tab<true>(twist, m);
        const double2 a = cmul(lo[q], tw), b = cmul(hi[q], tw);
        const uint32_t re = (uint32_t)__double2ll_rn(a.x * (1.0 / M)) +
                            ((uint32_t)__double2ll_rn(b.x * (1.0 / M))
                             << LIMB_BITS);
        const uint32_t im = (uint32_t)__double2ll_rn(a.y * (1.0 / M)) +
                            ((uint32_t)__double2ll_rn(b.y * (1.0 / M))
                             << LIMB_BITS);
        p[m] += re;
        p[m + M] += im;
      }
    }
    __syncthreads();
    mark(3);
  }

  if constexpr (kClocks) {
    if (blockIdx.x == 0 && tid == 0)
      for (int p = 0; p < PHASES; ++p) phase_clocks[T - 1][p] += ticks[p];
  }
  for (int e = tid; e < T * K1 * N; e += THREADS)
    if (b0 + e / (K1 * N) < B)
      acc_out[(size_t)b0 * K1 * N + e] = (int32_t)acc[e];
}

// ---- the cluster pair: one instance's step on two SMs ----
//
// Below half a wave (2 B <= the SM count, which ops/pbs_cuda.py's
// spectral_cluster reads from the device) ext_product<1> would leave most
// SMs idle while each runs one instance's step as a chain of ~23k clocks:
// its FFT passes are latency chains of 64 threads a transform, 16 points a
// thread, and its contraction reads the step's 393 KB of key spectrum at
// the L2 bandwidth one SM takes in.  Here a cluster of two blocks on two
// SMs runs one instance; block c owns GLWE component c (its 8 KB
// accumulator) and, each step:
//  1. computes the digits of its own component's 3 rows, 16 coefficients a
//     thread, each thread keeping the level of its group (the 3 levels are
//     one carry chain, so every group runs it; no staging, no barrier),
//     folds, twists and transforms row g on group g: Stockham passes of
//     radix 8, 8, 16 in place with 128 threads a transform, 8 points a
//     thread; the radix-16 pass is a 2 x 8 DFT over the lane pair (l, l ^
//     16), each lane the 8-point DFT of its half of the inputs, then one
//     exchange of 4 values by shuffle and radix-2 butterflies;
//  2. contracts its rows 3c .. 3c + 2 with their half of the step's key
//     (196,608 bytes): partial spectra of all 4 outputs (component, limb); its own
//     two over its first two slots, the peer's two into the peer's shared
//     memory (distributed shared memory, 32 KB) in a receive slot of two,
//     by step parity, so one cluster barrier a step (arrive.release,
//     wait.acquire) orders both the exchange and the reuse of a slot.  The
//     first half of those key rows (96 KB) is already in shared memory: one
//     thread copies it there with bulk copies (TMA) on an mbarrier as soon
//     as the step before has read its copy, so the copy runs under that
//     step's inverse and this step's forward passes, which leave L2 idle;
//     the other half is read from L2 (and prefetched into it beside);
//  3. inverts its component's two limb spectra on groups 0 and 1 (radix 16,
//     8, 8; each input its own partial plus the peer's, in that order, so
//     the sum is the same on every run), untwists, rounds each limb and
//     adds lo + 2^16 hi into its accumulator (the two groups meet at each
//     word by shared atomics, exact mod 2^32 in any order).
// The arithmetic is ext_product's: float64, the same key tensor, each limb
// rounded to its integer; only the order of the row sums and the FFT's
// radices differ, far inside the rounding margin (the CPU twin,
// tests/test_torch_kernels32.py _pair_step, holds this order to the exact
// step).  Slots are swizzled by pswz, under which every access pattern of
// the passes and the contraction is free of bank conflicts.  Shared memory:
// the key's half (96 KB), 3 slots (48 KB), the receive slots (64 KB), the
// accumulator (8 KB).
namespace pair {

constexpr int PT = 128;                  // threads a transform
constexpr int GROUPS = LEVEL;            // a block's digit rows
constexpr int THREADS = PT * GROUPS;     // 384
constexpr int R = 8;                     // points a thread a pass
constexpr int SPLIT = M / 16;            // radix-16 butterflies (lane pairs)
constexpr int KOWN = LEVEL * OUTS / 2;   // key slabs (row, output) in shared
static_assert(M == PT * R && K1 == 2, "a component a block, 8 points a thread");
static_assert(NL == GROUPS - 1, "the inverse: a limb a group");
constexpr uint32_t KBYTES = KOWN * M * sizeof(double2);   // 96 KB
constexpr size_t SMEM = (KOWN + GROUPS + 2 * NL) * M * sizeof(double2) +
                        N * sizeof(uint32_t) + sizeof(uint64_t);

__device__ __forceinline__ int pswz(int k) {
  return k ^ ((k >> 3) & 7) ^ ((k >> 6) & 1);
}

// the barrier of group g's PT threads (named barrier 1 + g)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(PT) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the shared-memory address of p in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer(uint32_t addr, double2 v) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};" ::"r"(addr),
               "d"(v.x), "d"(v.y)
               : "memory");
}

// One thread: the KBYTES of key at src into dst by bulk copies that
// complete on the mbarrier bar (its next phase), and the rest of the
// step's rows, KBYTES more at src + KBYTES, prefetched into L2.
__device__ __forceinline__ void key_copy(double2* dst, const double2* src,
                                         uint64_t* bar) {
  constexpr uint32_t SLAB = M * sizeof(double2);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(KBYTES) : "memory");
#pragma unroll
  for (int s = 0; s < KOWN; ++s)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + s * M)),
        "l"(src + s * M), "r"(SLAB), "r"(smem_addr(bar))
        : "memory");
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                   src + KOWN * M), "r"(KBYTES) : "memory");
}

__device__ __forceinline__ void key_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// v e^{-+2 pi i p/8}, p = 1, 2, 3
template <bool INV, int P>
__device__ __forceinline__ double2 w8(double2 v) {
  constexpr double C = 0.70710678118654752;
  if constexpr (P == 2) return INV ? make_double2(-v.y, v.x)
                                   : make_double2(v.y, -v.x);
  const double s = C * (v.x + v.y), d = C * (v.x - v.y);
  if constexpr (P == 1) return INV ? make_double2(d, s) : make_double2(s, -d);
  return INV ? make_double2(-s, d) : make_double2(-d, -s);
}

__device__ __forceinline__ void dft2(double2& a, double2& b) {
  const double2 t = csub(a, b);
  a = cadd(a, b);
  b = t;
}

// 8-point DFT as 2 x 4: X[q] ends in x[at8(q)] = x[2 (q % 4) + q / 4].
template <bool INV>
__device__ __forceinline__ void dft8(double2 (&x)[8]) {
  dft4<INV>(x[0], x[2], x[4], x[6]);
  dft4<INV>(x[1], x[3], x[5], x[7]);
  x[3] = w8<INV, 1>(x[3]);
  x[5] = w8<INV, 2>(x[5]);
  x[7] = w8<INV, 3>(x[7]);
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) dft2(x[2 * k2], x[2 * k2 + 1]);
}
__device__ __forceinline__ int at8(int q) { return 2 * (q & 3) + (q >> 2); }

// A radix-8 pass at stride NS (Stockham): thread j's points j + PT r of
// src, twiddled by w^{(j mod NS) r M / (8 NS)} (powers of one table entry)
// and transformed in x.
template <bool INV, int NS>
__device__ __forceinline__ void p8_load(const double2* src, const double2* w,
                                        int j, double2 (&x)[8]) {
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = src[pswz(j + PT * r)];
  if constexpr (NS > 1) {
    const double2 w1 = tab<INV>(w, (j % NS) * (M / (NS * R)));
    double2 wr = w1;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      x[r] = cmul(x[r], wr);
      if (r + 1 < R) wr = cmul(wr, w1);
    }
  }
  dft8<INV>(x);
}
// ... its outputs q at (j div NS) 8 NS + (j mod NS) + NS q of dst
template <int NS>
__device__ __forceinline__ void p8_store(double2* dst, const double2 (&x)[8],
                                         int j) {
  const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
  for (int q = 0; q < R; ++q) dst[pswz(base + NS * q)] = x[at8(q)];
}

// A radix-16 pass at stride NS over the lane pair of butterfly jb: lane
// half h takes inputs r = h + 2 u (points jb + 64 r of src, plus those of
// add where ADD), twiddled by w^{(jb mod NS) r M / (16 NS)}, and their
// 8-point DFT Y_h; the pair swaps half of it (lane ^ 16) and each lane
// forms X[k + 8 k1] = Y_0[k] + (-1)^k1 W16^k Y_1[k] for its k = i + 4 h:
// out[i] = X[i + 4 h], out[4 + i] = X[i + 4 h + 8], i < 4.
template <bool INV, int NS, bool ADD>
__device__ __forceinline__ void p16_pair(const double2* src,
                                         const double2* add,
                                         const double2* w, int jb, int h,
                                         double2 (&out)[8]) {
  constexpr double C1 = 0.92387953251128674, S1 = 0.38268343236508978,
                   C2 = 0.70710678118654752;
  double2 x[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int k = pswz(jb + SPLIT * (h + 2 * u));
    x[u] = ADD ? cadd(src[k], add[k]) : src[k];
  }
  if constexpr (NS > 1) {
    const double2 w1 = tab<INV>(w, (jb % NS) * (M / (NS * 16)));
    const double2 w2 = cmul(w1, w1);
    double2 wr = h ? w1 : make_double2(1.0, 0.0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = cmul(x[u], wr);
      if (u < 7) wr = cmul(wr, w2);
    }
  }
  dft8<INV>(x);                 // Y_h[k] in x[at8(k)]
  const double2 W[4] = {make_double2(1.0, 0.0),
                        make_double2(C1, INV ? S1 : -S1),
                        make_double2(C2, INV ? C2 : -C2),
                        make_double2(S1, INV ? C1 : -C1)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // lane 0 keeps Y_0[i] (x[2i]) and sends Y_0[i + 4]; lane 1 keeps
    // Y_1[i + 4] (x[2i + 1]) and sends Y_1[i]
    const double2 send = h ? x[2 * i] : x[2 * i + 1];
    const double2 got = make_double2(__shfl_xor_sync(0xffffffffu, send.x, 16),
                                     __shfl_xor_sync(0xffffffffu, send.y, 16));
    const double2 a = h ? got : x[2 * i];
    double2 b = h ? x[2 * i + 1] : got;
    if (i > 0) b = cmul(b, W[i]);
    if (h) b = INV ? make_double2(-b.y, b.x) : make_double2(b.y, -b.x);
    out[i] = cadd(a, b);
    out[4 + i] = csub(a, b);
  }
}
// ... its outputs at (jb div NS) 16 NS + (jb mod NS) + NS q of dst
template <int NS>
__device__ __forceinline__ void p16_store(double2* dst, const double2 (&o)[8],
                                          int jb, int h) {
  const int base = (jb / NS) * NS * 16 + jb % NS;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[pswz(base + NS * ((i & 3) + 4 * h + 8 * (i >> 2)))] = o[i];
}

// The whole rotation of instance blockIdx.x / 2, component blockIdx.x % 2
// (the block's rank in its cluster of two); arguments as ext_product's.
__global__ void __launch_bounds__(THREADS, 1)
ext_product(const int32_t* __restrict__ cts_ms,
            const int32_t* __restrict__ luts,
            const int32_t* __restrict__ lut_idx,
            const double2* __restrict__ key,
            const double2* __restrict__ tables, int32_t* __restrict__ acc_out,
            int B, int n, int base_log) {
  extern __shared__ __align__(128) double2 sp[];
  double2* K = sp;                               // [KOWN][M]: key, in order
  double2* S = K + KOWN * M;                     // [GROUPS][M], swizzled
  double2* rx = S + GROUPS * M;                  // [2 parity][NL][M]
  uint32_t* acc = reinterpret_cast<uint32_t*>(rx + 2 * NL * M);   // [N]
  uint64_t* kbar = reinterpret_cast<uint64_t*>(acc + N);
  const double2* twist = tables;
  const double2* w = tables + M;
  const int tid = threadIdx.x, g = tid / PT, j = tid % PT;
  const uint32_t c = cluster_rank(), peer = c ^ 1u;
  const int b = blockIdx.x / 2;
  // a lane pair of the radix-16 passes: butterfly jb, half h
  const int jb = (j >> 5) * 16 + (j & 15), h = (j >> 4) & 1;
  const int shift = 32 - base_log * LEVEL;
  const uint32_t mask = (1u << base_log) - 1u, half = 1u << (base_log - 1);
  const int32_t* ct = cts_ms + (size_t)b * (n + 1);
  // this block's rows of step i's key
  auto key_rows = [&](int i) {
    return key + ((size_t)i * ROWS + c * LEVEL) * OUTS * M;
  };

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(kbar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // acc0 = (0, X^{-b~} lut)
  for (int m = tid; m < N; m += THREADS) {
    uint32_t v = 0u;
    if (c == K1 - 1) {
      const int r0 = (2 * N - ct[n]) & (2 * N - 1);
      const int s = (m - r0) & (2 * N - 1);
      const uint32_t* lut =
          reinterpret_cast<const uint32_t*>(luts) + (size_t)lut_idx[b] * N;
      v = s < N ? lut[s] : 0u - lut[s - N];
    }
    acc[m] = v;
  }
  cluster_sync();          // the peer runs before its memory is written
  if (tid == 0) key_copy(K, key_rows(0), kbar);

  unsigned long long ticks[CLOCK_COLS] = {}, t_last = 0;
  auto mark = [&](int p) {
    if constexpr (kClocks) {
      if (blockIdx.x == 0 && tid == 0) {
        const unsigned long long now = clock64();
        ticks[p] += now - t_last;
        t_last = now;
      }
    }
  };

  for (int i = 0; i < n; ++i) {
    if constexpr (kClocks) t_last = clock64();
    double2* s = S + g * M;
    // 1. digits of level g at coefficients j + PT q and + M, folded and
    // twisted, then pass 1 from registers
    {
      const int a = ct[i];
      double2 x[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        double d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = j + PT * q + M * e;
          const int sr = (m - a) & (2 * N - 1);
          const uint32_t v = acc[sr & (N - 1)];
          uint32_t st = (((sr & N) ? 0u - v : v) - acc[m] +
                         (1u << (shift - 1))) >> shift;
          uint32_t mine = 0u;
#pragma unroll
          for (int lev = LEVEL - 1; lev >= 0; --lev) {
            const uint32_t dg = st & mask;
            const uint32_t sd = dg >= half ? dg - mask - 1u : dg;
            st = (st - sd) >> base_log;
            if (lev == g) mine = sd;
          }
          d[e] = (double)(int32_t)mine;
        }
        x[q] = cmul(make_double2(d[0], d[1]), __ldg(twist + j + PT * q));
      }
      dft8<false>(x);
      p8_store<1>(s, x, j);
    }
    group_sync(g);
    mark(0);
    // passes 2 and 3 in place: read all, barrier, write all
    {
      double2 x[R];
      p8_load<false, 8>(s, w, j, x);
      group_sync(g);
      p8_store<8>(s, x, j);
    }
    group_sync(g);
    {
      double2 o[8];
      p16_pair<false, 64, false>(s, nullptr, w, jb, h, o);
      group_sync(g);
      p16_store<64>(s, o, jb, h);
    }
    __syncthreads();
    mark(1);

    // 2. the contraction over rows 3c + r: own outputs over slots 0 and 1,
    // the peer's into its receive slot of this parity; key slab r OUTS + o
    // from shared memory below KOWN, from L2 above
    const double2* ki = key_rows(i);
    double2* rxi = rx + (i & 1) * NL * M;
    key_wait(kbar, i & 1);
    for (int jf = tid; jf < M; jf += THREADS) {
      double2 kv[LEVEL * OUTS];
#pragma unroll
      for (int e = KOWN; e < LEVEL * OUTS; ++e) kv[e] = __ldcg(ki + e * M + jf);
#pragma unroll
      for (int e = 0; e < KOWN; ++e) kv[e] = K[e * M + jf];
      const int k = pswz(jf);
      double2 dv[LEVEL];
#pragma unroll
      for (int r = 0; r < LEVEL; ++r) dv[r] = S[r * M + k];
      double2 y[OUTS];
#pragma unroll
      for (int o = 0; o < OUTS; ++o) {
        y[o] = make_double2(0.0, 0.0);
#pragma unroll
        for (int r = 0; r < LEVEL; ++r)
          y[o] = cfma(dv[r], kv[r * OUTS + o], y[o]);
      }
#pragma unroll
      for (int l = 0; l < NL; ++l) {     // selects: y stays in registers
        S[l * M + k] = c ? y[NL + l] : y[l];
        st_peer(peer_addr(rxi + l * M + k, peer), c ? y[l] : y[NL + l]);
      }
    }
    mark(2);
    cluster_sync();
    // every thread is past its reads of K: the next step's copy may start
    if (tid == 0 && i + 1 < n) key_copy(K, key_rows(i + 1), kbar);
    if constexpr (kClocks) {
      if (blockIdx.x == 0 && tid == 0) {
        const unsigned long long now = clock64();
        ticks[PHASES] += now - t_last;    // the exchange, inside phase 2
        ticks[2] += now - t_last;
        t_last = now;
      }
    }

    // 3. the inverse of limb g (groups 0 and 1): its own partial plus the
    // peer's, radix 16, 8, 8 in place, then rounded into the accumulator
    if (g < NL) {
      {
        double2 o[8];
        p16_pair<true, 1, true>(s, rxi + g * M, w, jb, h, o);
        group_sync(g);
        p16_store<1>(s, o, jb, h);
      }
      group_sync(g);
      {
        double2 x[R];
        p8_load<true, 16>(s, w, j, x);
        group_sync(g);
        p8_store<16>(s, x, j);
      }
      group_sync(g);
      double2 x[R];
      p8_load<true, PT>(s, w, j, x);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int m = j + PT * q;
        const double2 v = cmul(x[at8(q)], tab<true>(twist, m));
        atomicAdd(acc + m, (uint32_t)__double2ll_rn(v.x * (1.0 / M))
                               << (LIMB_BITS * g));
        atomicAdd(acc + m + M, (uint32_t)__double2ll_rn(v.y * (1.0 / M))
                                   << (LIMB_BITS * g));
      }
    }
    __syncthreads();
    mark(3);
  }

  if constexpr (kClocks) {
    if (blockIdx.x == 0 && tid == 0)
      for (int p = 0; p < CLOCK_COLS; ++p) phase_clocks[2][p] += ticks[p];
  }
  for (int m = tid; m < N; m += THREADS)
    acc_out[((size_t)b * K1 + c) * N + m] = (int32_t)acc[m];
}

// The rotation of B instances on B clusters of two blocks.
int rotate(const int32_t* cts_ms, const int32_t* luts, const int32_t* lut_idx,
           const double2* key, const double2* tables, int32_t* acc, int B,
           int n, int base_log, cudaStream_t stream) {
  static bool opted = false;
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        ext_product, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, ext_product, cts_ms, luts,
                                       lut_idx, key, tables, acc, B, n,
                                       base_log);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace pair

// One spectral rotation of B instances on `stream`: on `cluster` = 2 the
// cluster pair (a pair of blocks an instance; ops/pbs_cuda.py chooses it
// below half a wave), else T = 1 instance a block while B blocks fit one
// wave of the card, else 2; returns a cudaError_t.
int rotate(const int32_t* cts_ms, const int32_t* luts, const int32_t* lut_idx,
           const double2* key, const double2* tables, int32_t* acc, int B,
           int n, int base_log, int cluster, cudaStream_t stream) {
  if (cluster == 2)
    return pair::rotate(cts_ms, luts, lut_idx, key, tables, acc, B, n,
                        base_log, stream);
  static bool opted[2] = {false, false};
  const int T = B > kWave ? 2 : 1;
  void (*kern)(const int32_t*, const int32_t*, const int32_t*, const double2*,
               const double2*, int32_t*, int, int, int) =
      T == 1 ? ext_product<1> : ext_product<2>;
  if (!opted[T - 1]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(T));
    if (err != cudaSuccess) return (int)err;
    opted[T - 1] = true;
  }
  kern<<<(B + T - 1) / T, THREADS, smem_bytes(T), stream>>>(
      cts_ms, luts, lut_idx, key, tables, acc, B, n, base_log);
  return (int)cudaGetLastError();
}

}  // namespace spectral

}  // namespace

extern "C" {

// The whole blind rotation, enqueued on `stream`; returns a cudaError_t.
//   cts_ms  [B, n+1] int32 in [0, 2N)      luts [L, N]    lut_idx [B]
//   bsk     [n, k1*level, k1, N]           acc  [B, k1, N] (output)
//   digits  [B, k1*level, N] int8 scratch; acc and digits 16-byte aligned
// Needs N a power of two, a multiple of 256, and 32 - base_log*level >= 1.
int fhe_blind_rotate(const int32_t* cts_ms, const int32_t* luts,
                     const int32_t* lut_idx, const int32_t* bsk, int32_t* acc,
                     int8_t* digits, int B, int n, int k1, int N, int level,
                     int base_log, void* stream_ptr) {
  return rotate32(cts_ms, luts, lut_idx, reinterpret_cast<const uint32_t*>(bsk),
                  reinterpret_cast<uint32_t*>(acc), digits, B, n, k1, N, level,
                  base_log, static_cast<cudaStream_t>(stream_ptr));
}

// The whole blind rotation through the spectral key (spectral::rotate),
// enqueued on `stream`; returns a cudaError_t.
//   cts_ms  [B, n+1] int32 in [0, 2N)      luts [L, N]    lut_idx [B]
//   key     [n, k1*level, k1, 2, N/2] complex128 (the limbs of
//           ops/pbs_fft.SPECTRAL_PLAN)
//   tables  [2, N/2] complex128: the twist, the transform's twiddles
//   acc     [B, k1, N] (output)
//   cluster 2: the cluster pair, two blocks an instance; 1: ext_product<T>
//           (ops/pbs_cuda.py's spectral_cluster chooses)
// Takes N = 2048, k1 = 2, level = 3 and 32 - base_log*level >= 1 only.
int fhe_blind_rotate_spectral(const int32_t* cts_ms, const int32_t* luts,
                              const int32_t* lut_idx, const double* key,
                              const double* tables, int32_t* acc, int B,
                              int n, int k1, int N, int level, int base_log,
                              int cluster, void* stream_ptr) {
  if (N != spectral::N || k1 != spectral::K1 || level != spectral::LEVEL ||
      (cluster != 1 && cluster != 2))
    return (int)cudaErrorInvalidValue;
  return spectral::rotate(cts_ms, luts, lut_idx,
                          reinterpret_cast<const double2*>(key),
                          reinterpret_cast<const double2*>(tables), acc, B, n,
                          base_log, cluster,
                          static_cast<cudaStream_t>(stream_ptr));
}

// The phase clocks of the spectral rotation, [3][5] (rows: T = 1, T = 2,
// the cluster pair; columns: digits and pass 1, forward passes 2 and 3,
// contraction, inverse, and the pair's exchange, part of its contraction):
// clock64() ticks of block 0's thread 0, summed over the steps of every
// launch since the last call, copied to out and set to zero.  Zeros unless
// the library was built with -DFHE_SPECTRAL_CLOCKS.  Synchronises the
// device.
int fhe_spectral_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, spectral::phase_clocks,
                                         sizeof(spectral::phase_clocks));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long
      zero[spectral::CLOCK_ROWS][spectral::CLOCK_COLS] = {};
  return (int)cudaMemcpyToSymbol(spectral::phase_clocks, zero, sizeof(zero));
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
// step 0); acc [B, k1, N] and digits [B, k1*level, N] int8 (output), both
// 16-byte aligned.
int fhe_stage1_digits(const int32_t* a, const int32_t* acc, int8_t* digits,
                      int B, int k1, int N, int level, int base_log,
                      void* stream_ptr) {
  return launch_stage1(a, reinterpret_cast<const uint32_t*>(acc), digits, B,
                       0, k1, N, level, base_log, 0, false,
                       static_cast<cudaStream_t>(stream_ptr));
}

// The external product over `rows` digit rows: out = acc + sum_r
// digits[:, r] (*) ggsw[r, c] mod X^N+1, mod 2^32, r < rows.  out starts as
// a copy of acc, so acc is left as it is.  With rows = k1*level it is one
// CMUX step's external product (the `_ext_product_kernel` counterpart);
// with a contiguous block of the rows it is one rank's share of that step
// under tensor parallelism (the rows of a GGSW are its outermost axis, so a
// row block of it is contiguous).
//   digits [B, rows, N] int8 (16-byte aligned)   ggsw [rows, k1, N]
//   acc, out [B, k1, N]
int fhe_external_product_rows(const int8_t* digits, const int32_t* ggsw,
                              const int32_t* acc, int32_t* out, int B, int k1,
                              int N, int rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemcpyAsync(
      out, acc, (size_t)B * k1 * N * sizeof(int32_t),
      cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  return launch_ext_product(digits, reinterpret_cast<const uint32_t*>(ggsw),
                            reinterpret_cast<uint32_t*>(out), B, k1, N, rows,
                            false, stream);
}

}  // extern "C"
