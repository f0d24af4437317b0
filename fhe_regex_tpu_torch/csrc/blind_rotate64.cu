// Blind rotation for a batch of 64-bit TFHE bootstraps on Hopper (sm_90a).
//
// Replaces fhe_regex_tpu/ops/pbs_pallas.py::_fused_blindrot64_stacked_kernel
// and _fused_blindrot64_kernel (with _acc64_init; backend `pallas64`) and
// _fused_blindrot64_bg_kernel (backend `pallas64-bg`, on a key rounded by its
// limb drop), and computes exactly what
// fhe_regex_tpu_torch/ops/pbs64.py::blind_rotate64 computes, bit for bit:
// [B, n+1] mod-switched ciphertexts -> [B, k+1, N] uint64 accumulators.
//
// What bounds it.  Every CMUX step is an external product of the B
// accumulators' gadget digits with the step's GGSW, a [B, rows*N] x
// [rows*N, (k+1)*N] product mod 2^64 whose right side is negacyclic
// Toeplitz.  Split into int8 limbs (8 of a key word, nd of a digit), the
// product is one int8 product per limb pair of weight below 2^64: at the
// production set (n=866, N=2048, k=1, one base-2^23 digit per component, so
// rows = 2 and nd = 3) 21 pairs, or 16.5 on average on a key rounded by the
// drop (1, 2).  That is B * 2 * 2 * N^2 * 21 = 3.5e8 * B int8 multiply-adds
// per step, which the tensor cores run at 1,979 TOP/s dense: 0.091 ms per
// step at B = 256, the bound.  The accumulators (B * 32 KB) and one step's
// GGSW (64 KB) stay in the 50 MB L2.
//
// What the design does about it (`ext_product64`).
//  * A limb GEMM on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 ->
//    s32), in the shape of the 32-bit `ext_product` (csrc/blind_rotate.cu).
//    Each key word of the doubled window [g, -g mod 2^64] is split into 8
//    balanced int8 limbs, g and -g each on its own (no limb is ever
//    negated: -(-128) is not an int8).  Each digit d lies in
//    [-2^(base_log-1), 2^(base_log-1)); `stage1_64` writes it as nd balanced
//    int8 limbs, d = sum_dl 2^(8 dl) d_dl, the top one in [-64, 64] at
//    base_log = 23.
//  * Products go to int32 sums per weight class cw = dl + j <= 7 (classes
//    of weight 2^64 and above vanish mod 2^64).  A block covers one digit
//    row, so a class sum has at most min(nd, 8) pairs of N terms each at
//    most 128 * 128: nd * N * 2^14 < 2^31 needs nd * N < 2^17, and the
//    wrapper admits nd <= 3 and N <= 4096 (3 * 4096 * 2^14 = 2.0e8).  At
//    the production set it is 3 * 2048 * 2^14 = 1.0e8.
//  * The epilogue sign-extends each class sum and forms
//    sum_cw (uint64)(int64)P_cw << 8 cw, exact mod 2^64; digit rows meet
//    through 64-bit atomic adds, exact in any order.
//  * Key limbs below the drop of the block's component are zero on a key
//    rounded by that drop (round_bsk64), and so are those of -g: the
//    block skips every pair with j below it (drop (1, 2): 18 pairs for the
//    mask, 15 for the body).  The caller passes the drop the key was
//    rounded by; the rotation of `cuda64` passes (0, 0).
//  * No Toeplitz matrix in memory.  A B-fragment register of m16n8k32 is 4
//    consecutive K entries (t) of one column (m), i.e. 4 consecutive
//    entries of the REVERSED key window rev[y] = dbl[(M0 + TN - 1 - y) mod
//    2N], y = t + M0 + TN - 1 - m.  The block keeps each of the 8 limbs'
//    reversed windows in shared memory in 4 byte-shifted copies (copy s
//    holds rev from byte s), so every fragment register is one aligned
//    32-bit load.  A lane always reads copy (3 - groupID) & 3; copies are
//    laid out 8 banks apart, so a warp's loads do not conflict.
//  * The digits (the left operand, contiguous along t) are staged by
//    cp.async in a two-stage ring of 128-deep chunks, the block row's nd
//    limb planes side by side, rows padded by 16 bytes so the A-fragment
//    loads hit 32 banks.
//  * The grid spans (batch tile, component x 64-coefficient tile, digit
//    row): 16 batch rows (MT = 1) up to B = 32, else 32 (MT = 2), so an
//    8-wide level runs 128 blocks.  A block is 8 warps of one n8 tile
//    each: a narrow level has one block per SM, and one warp alone issues
//    `mma` far below the tensor cores' rate, so 8 warps there beat 4 warps
//    of two tiles.  Shared memory at N = 2048, nd = 3 and MT = 2: 32
//    window copies of 552 words (70.7 KB) plus two stages of 3 x 32 rows
//    of 144 bytes (27.6 KB), 98.3 KB: two blocks per SM (a 256-deep chunk
//    would leave one).  A thread holds MT * 8 * 4 = 64 class sums at
//    MT = 2 (registers and spills: `chip_profile.py` prints what
//    `nvcc -Xptxas -v` reports).
//  * Per step: one `stage1_64` launch (rotate by a~_i, subtract, round,
//    balanced digits split into int8 limbs) and one `ext_product64` launch,
//    from a step loop on the host side of this library, both programmatic
//    dependent launches chained as in the 32-bit rotation (hopper.cuh):
//    the next `stage1_64` starts once the products are summed and waits
//    before it reads the accumulator; `ext_product64` starts as the digit
//    pass's blocks exit and waits before it stages the digits.
//
// The digit pass `stage1_64` is bound by bytes: read the accumulator once,
// write l * nd int8 limb planes, B * (k+1) * N * (8 + l * nd) bytes, 11.5 MB
// at B = 256 (3.4 us at 3.35 TB/s).  It is laid out as the 32-bit `stage1`
// (csrc/blind_rotate.cu): grid (batch row, segment, component) with no
// division, `a` read once per block, the row's segment and the rotated
// source run staged in padded shared memory by 16-byte loads, 16
// coefficients per thread, each limb plane written by one 16-byte store.
// `fhe_stage1_digits64` launches it alone, to hold it against its plain
// version (ops/pbs64.py::stage1_digits64) and time it.
//
// What the TPU kernels needed and this one does not: the (lo, hi) int32
// pairs with explicit carries, the roll chains standing in for indexed
// reads, WIN and sublane padding, and (in the batch-grid kernel) the HBM
// accumulator with DMA staging.  The accumulator lives in global memory
// (L2) as uint64; all torus arithmetic is uint64_t: wraparound is defined
// there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads1 = 256;        // acc_init64 block
constexpr int kWarps = 8;             // warps per ext_product64 block
constexpr int NT = 1;                 // n8 tiles per warp
constexpr int TN = kWarps * NT * 8;   // coefficients per block (64)
constexpr int KC = 128;               // digits (t) staged per chunk
constexpr int QC = KC / 16;           // 16-byte pieces of a staged row
constexpr int ASTRIDE = KC + 16;      // bytes per staged digit row
constexpr int NSTAGE = 2;             // cp.async ring depth
constexpr int NLIMB = 8;              // int8 limbs of a key word
constexpr int NCOPY = 4;              // byte-shifted copies of a window

// Words of one shifted window copy, and the stride between copies: at
// least that, and 8 mod 32 so the four copies sit 8 banks apart.
__host__ __device__ __forceinline__ int win_words(int N) { return (N + TN) / 4; }
__host__ __device__ __forceinline__ int win_stride(int N) {
  return ((win_words(N) - 8 + 31) / 32) * 32 + 8;
}

// The eight balanced int8 limbs of w (w = sum_l 2^(8l) limb_l mod 2^64),
// limb l in byte l.  Peeling limb_l = ((w + 128) & 255) - 128, w = (w -
// limb_l) >> 8 carries exactly as adding 0x80 to every byte does, so byte
// l of w + 0x80..80 is limb_l + 128.
__device__ __forceinline__ uint64_t limbs8(uint64_t w) {
  constexpr uint64_t kBias = 0x8080808080808080ull;
  return (w + kBias) ^ kBias;
}

// out[l] = bytes l of a, b, c, d, in that order from the low byte.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t (&out)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(ab_lo, cd_lo, 0x5410);         // a0 b0 c0 d0
  out[1] = __byte_perm(ab_lo, cd_lo, 0x7632);         // a1 b1 c1 d1
  out[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  out[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

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

// digits[b, (c*l + j)*nd + dl, m] = int8 limb dl of the j-th most
// significant balanced digit of (X^a * acc[b, c])[m] - acc[b, c, m],
// a = cts_ms[b, step], for m in the block's segment [m0, m0 + S),
// S = 16 * blockDim.x; grid (b, segment, c).
__global__ void __launch_bounds__(kSegMax / kPerThread)
stage1_64(const int32_t* __restrict__ cts_ms, const uint64_t* __restrict__ acc,
          int8_t* __restrict__ digits, int n, int k1, int N, int level,
          int base_log, int nd, int step) {
  extern __shared__ __align__(16) uint64_t sm64[];
  __shared__ int a_s;
  const int S = blockDim.x * kPerThread;
  const int b = blockIdx.x, m0 = blockIdx.y * S, c = blockIdx.z;
  const int t = threadIdx.x;
  if (t == 0) a_s = cts_ms[(size_t)b * (n + 1) + step];
  const uint64_t* p = acc + ((size_t)b * k1 + c) * N;
  pdl_wait();                                // acc is the last step's
  const int s0 = stage_digit_runs(sm64, p, m0, &a_s, N);  // m0's source
  const int off = s0 & 1;                    // s0 - its 16-byte group
  const uint64_t* acc_s = sm64;
  const uint64_t* src_s = sm64 + spad_words(S);

  const int shift = 64 - base_log * level;
  const uint64_t rnd = 1ull << (shift - 1);
  uint64_t st[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int i = t * kPerThread + q;
    const uint64_t v = src_s[spad(off + i)];
    const uint64_t rot = ((s0 + i) & N) ? 0ull - v : v;   // past N: -p
    st[q] = (rot - acc_s[spad(i)] + rnd) >> shift;
  }
  const uint64_t mask = (1ull << base_log) - 1ull;
  const uint64_t half = 1ull << (base_log - 1);
  int8_t* out = digits + ((size_t)b * k1 + c) * level * nd * N + m0 +
                t * kPerThread;
  for (int j = level - 1; j >= 0; --j) {   // least significant first
    uint64_t sd[kPerThread];                // the balanced digits, as uint64
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const uint64_t d = st[q] & mask;
      sd[q] = d >= half ? d - mask - 1ull : d;
      st[q] = (st[q] - sd[q]) >> base_log;
    }
    for (int dl = 0; dl < nd; ++dl) {       // balanced: ((v+128) & 255) - 128
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int64_t limb = (int8_t)(sd[q] & 0xFFull);
        w[q >> 2] |= (uint32_t)(sd[q] & 0xFFull) << (8 * (q & 3));
        sd[q] = (uint64_t)(((int64_t)sd[q] - limb) >> 8);
      }
      *reinterpret_cast<uint4*>(out + ((size_t)j * nd + dl) * N) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One stage1_64 launch on `stream`, a programmatic dependent launch inside
// a rotation (`pdl`), an ordinary one alone.
int launch_stage1_64(const int32_t* cts_ms, const uint64_t* acc,
                     int8_t* digits, int B, int n, int k1, int N, int level,
                     int base_log, int nd, int step, bool pdl,
                     cudaStream_t stream) {
  const int S = stage1_segment(B, k1, N);
  const dim3 grid(B, N / S, k1), block(S / kPerThread);
  const size_t smem = stage1_smem<uint64_t>(S);
  if (pdl)
    return launch_pdl(stage1_64, grid, block, smem, stream, cts_ms, acc,
                      digits, n, k1, N, level, base_log, nd, step);
  stage1_64<<<grid, block, smem, stream>>>(cts_ms, acc, digits, n, k1, N,
                                           level, base_log, nd, step);
  return (int)cudaGetLastError();
}

// acc[b, c, m] += sum_t digit[b, r, t] * dbl_{r,c}[(m - t) mod 2N] (mod 2^64)
// over the block's batch tile (16 * MT rows from b0), component c,
// coefficient tile [M0, M0 + TN) and its one digit row r, the digit given
// as ND int8 limb planes.
template <int ND, int MT>
__global__ void __launch_bounds__(kWarps * 32)
ext_product64(const int8_t* __restrict__ digits,   // [B, rows*ND, N]
              const uint64_t* __restrict__ ggsw,   // this step: [rows, k1, N]
              uint64_t* __restrict__ acc, int B, int k1, int N, int rows,
              int drop_mask, int drop_body) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) uint32_t smem[];
  const int stride = win_stride(N);
  uint32_t* win = smem;                     // [limb][copy][stride] words
  int8_t* a_s = reinterpret_cast<int8_t*>(  // [stage][dl][BM][ASTRIDE]
      smem + NLIMB * NCOPY * stride);

  const int ntiles = N / TN;
  const int r = blockIdx.z;
  const int c = blockIdx.y / ntiles;
  const int M0 = (blockIdx.y % ntiles) * TN;
  const int b0 = blockIdx.x * BM;
  const int jlo = c < k1 - 1 ? drop_mask : drop_body;   // zero key limbs
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long dstride = (long long)rows * ND * N;

  // rows past the batch stay zero in both stages; the rest arrive by
  // cp.async, chunk kc into stage kc % NSTAGE
  for (int e = tid; e < NSTAGE * ND * BM * QC; e += blockDim.x) {
    if (b0 + (e / QC) % BM >= B)
      *reinterpret_cast<int4*>(a_s + (e / QC) * ASTRIDE + (e % QC) * 16) =
          make_int4(0, 0, 0, 0);
  }
  auto stage_chunk = [&](int kc) {
    int8_t* dst = a_s + (kc % NSTAGE) * ND * BM * ASTRIDE;
    for (int e = tid; e < ND * BM * QC; e += blockDim.x) {
      const int pr = e / QC, q = e % QC;    // pr = dl * BM + row
      const int b = b0 + pr % BM;
      if (b < B)
        cp_async16(dst + pr * ASTRIDE + q * 16,
                   digits + b * dstride + (long long)(r * ND + pr / BM) * N +
                       kc * KC + q * 16);
    }
    cp_async_commit();
  };
  pdl_wait();            // the digits and acc of this step's stage1_64
  stage_chunk(0);

  // the reversed windows: rev[y] = dbl[(M0 + TN - 1 - y) mod 2N]; copy s
  // word i of limb l = limb-l bytes of rev[4i + s .. 4i + s + 3]
  const uint64_t* gp = ggsw + ((long long)r * k1 + c) * N;
  for (int i = tid; i < win_words(N); i += blockDim.x) {
    uint64_t lim[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const int z = (M0 + TN - 1 - (4 * i + q)) & (2 * N - 1);
      lim[q] = limbs8(z < N ? gp[z] : 0ull - gp[z - N]);
    }
#pragma unroll
    for (int s = 0; s < NCOPY; ++s) {
      uint32_t lo[4], hi[4];
      transpose4((uint32_t)lim[s], (uint32_t)lim[s + 1], (uint32_t)lim[s + 2],
                 (uint32_t)lim[s + 3], lo);
      transpose4((uint32_t)(lim[s] >> 32), (uint32_t)(lim[s + 1] >> 32),
                 (uint32_t)(lim[s + 2] >> 32), (uint32_t)(lim[s + 3] >> 32),
                 hi);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        win[(l * NCOPY + s) * stride + i] = lo[l];
        win[((l + 4) * NCOPY + s) * stride + i] = hi[l];
      }
    }
  }

  int p[MT][NT][NLIMB][4];                  // class sums, cw = dl + j
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int cw = 0; cw < NLIMB; ++cw)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[mt][nt][cw][q] = 0;

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
    const int8_t* at = a_s + (kc % NSTAGE) * ND * BM * ASTRIDE;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t af[ND][MT][4];
#pragma unroll
      for (int dl = 0; dl < ND; ++dl)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int8_t* ap =
              at + (dl * BM + mt * 16 + g) * ASTRIDE + ks * 32 + tig * 4;
          af[dl][mt][0] = *reinterpret_cast<const uint32_t*>(ap);
          af[dl][mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * ASTRIDE);
          af[dl][mt][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
          af[dl][mt][3] =
              *reinterpret_cast<const uint32_t*>(ap + 8 * ASTRIDE + 16);
        }
      const int t0 = kc * KC + ks * 32;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int yb = t0 + tig * 4 + TN - 1 - (warp * NT * 8 + nt * 8 + g);
        const uint32_t* bp = wl + ((yb - s) >> 2);
#pragma unroll
        for (int j = 0; j < NLIMB; ++j) {
          if (j < jlo) continue;            // the same in the whole block
          const uint32_t bf0 = bp[j * NCOPY * stride];
          const uint32_t bf1 = bp[j * NCOPY * stride + 4];
#pragma unroll
          for (int dl = 0; dl < ND; ++dl) {
            if (dl + j >= NLIMB) continue;  // weight 2^64: vanishes
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_s8(p[mt][nt][dl + j], af[dl][mt], bf0, bf1);
          }
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
        uint64_t v = 0ull;
#pragma unroll
        for (int cw = 0; cw < NLIMB; ++cw)
          v += (uint64_t)(int64_t)p[mt][nt][cw][q] << (8 * cw);
        const int m = M0 + warp * NT * 8 + nt * 8 + 2 * tig + (q & 1);
        atomicAdd(reinterpret_cast<unsigned long long*>(acc) +
                      ((long long)b * k1 + c) * N + m,
                  (unsigned long long)v);
      }
    }
}

size_t ext_product64_smem(int N, int nd, int mt) {
  return (size_t)NLIMB * NCOPY * win_stride(N) * sizeof(uint32_t) +
         (size_t)NSTAGE * nd * 16 * mt * ASTRIDE;
}

// One ext_product64<ND, MT> launch on `stream` (after its shared-memory
// opt-in, raised once per instance to the largest size asked for), a
// programmatic dependent launch: it runs inside a rotation only.
template <int ND, int MT>
int launch_ext_product64_t(const int8_t* digits, const uint64_t* ggsw,
                           uint64_t* acc, int B, int k1, int N, int rows,
                           int drop_mask, int drop_body, cudaStream_t stream) {
  static size_t opted = 0;
  const size_t smem = ext_product64_smem(N, ND, MT);
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        ext_product64<ND, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid((B + 16 * MT - 1) / (16 * MT), k1 * (N / TN), rows);
  return launch_pdl(ext_product64<ND, MT>, grid, dim3(kWarps * 32), smem,
                    stream, digits, ggsw, acc, B, k1, N, rows, drop_mask,
                    drop_body);
}

// Batch rows per block: 16 (MT = 1) up to B = 32, else 32 (MT = 2).
int launch_ext_product64(const int8_t* digits, const uint64_t* ggsw,
                         uint64_t* acc, int B, int k1, int N, int rows,
                         int nd, int drop_mask, int drop_body,
                         cudaStream_t stream) {
  const bool narrow = B <= 32;
#define FHE_EXT64(ND)                                                        \
  return narrow ? launch_ext_product64_t<ND, 1>(digits, ggsw, acc, B, k1, N, \
                                                rows, drop_mask, drop_body,  \
                                                stream)                      \
                : launch_ext_product64_t<ND, 2>(digits, ggsw, acc, B, k1, N, \
                                                rows, drop_mask, drop_body,  \
                                                stream)
  switch (nd) {
    case 1: FHE_EXT64(1);
    case 2: FHE_EXT64(2);
    case 3: FHE_EXT64(3);
  }
#undef FHE_EXT64
  return (int)cudaErrorInvalidValue;
}

// The whole blind rotation of B instances, enqueued on `stream`.
int rotate64(const int32_t* cts_ms, const uint64_t* luts,
             const int32_t* lut_idx, const uint64_t* bsk, uint64_t* acc,
             int8_t* digits, int B, int n, int k1, int N, int level,
             int base_log, int nd, int drop_mask, int drop_body,
             cudaStream_t stream) {
  const int rows = k1 * level;
  const long long elems = (long long)B * k1 * N;
  const unsigned grid1 = (unsigned)((elems + kThreads1 - 1) / kThreads1);

  acc_init64<<<grid1, kThreads1, 0, stream>>>(cts_ms, luts, lut_idx, acc, B,
                                              n, k1, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long step_stride = (long long)rows * k1 * N;
  for (int i = 0; i < n; ++i) {
    int e = launch_stage1_64(cts_ms, acc, digits, B, n, k1, N, level,
                             base_log, nd, i, true, stream);
    if (e != 0) return e;
    e = launch_ext_product64(digits, bsk + i * step_stride, acc, B, k1, N,
                             rows, nd, drop_mask, drop_body, stream);
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// The 64-bit blind rotation over batch blocks of tb instances, one after
// another, enqueued on `stream`; returns a cudaError_t.  tb = B is the
// `pallas64` kernel's counterpart, tb < B the `pallas64-bg` one's.
//   cts_ms  [B, n+1] int32 in [0, 2N)      luts [L, N] uint64  lut_idx [B]
//   bsk     [n, k1*level, k1, N] uint64    acc  [B, k1, N] uint64 (output)
//   digits  [tb, k1*level*nd, N] int8 scratch, nd int8 limbs per digit;
//           acc and digits 16-byte aligned
// tb divides B.  The key is rounded to multiples of 256^drop_mask (mask
// components) and 256^drop_body (body): the key limbs below are skipped.
// Needs N a power of two in [256, 4096], base_log * level <= 31, and
// 1 <= nd <= 3 limbs that hold every digit (the wrapper checks).
int fhe_blind_rotate64(const int32_t* cts_ms, const uint64_t* luts,
                       const int32_t* lut_idx, const uint64_t* bsk,
                       uint64_t* acc, int8_t* digits, int B, int tb, int n,
                       int k1, int N, int level, int base_log, int nd,
                       int drop_mask, int drop_body, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  for (int b0 = 0; b0 < B; b0 += tb) {
    int err = rotate64(cts_ms + (long long)b0 * (n + 1), luts, lut_idx + b0,
                       bsk, acc + (long long)b0 * k1 * N, digits, tb, n, k1,
                       N, level, base_log, nd, drop_mask, drop_body, stream);
    if (err != 0) return err;
  }
  return 0;
}

// One CMUX step's digit limbs, alone (the pass `stage1_64` of the
// rotation): digits[b, (c*l + j)*nd + dl, :] = int8 limb dl of the j-th
// most significant balanced digit of X^{a[b]} * acc[b, c] - acc[b, c].
// a [B] int32 in [0, 2N) is read as a one-column cts_ms (n = 0, step 0);
// acc [B, k1, N] uint64 and digits [B, k1*level*nd, N] int8 (output), both
// 16-byte aligned.
int fhe_stage1_digits64(const int32_t* a, const uint64_t* acc, int8_t* digits,
                        int B, int k1, int N, int level, int base_log, int nd,
                        void* stream_ptr) {
  return launch_stage1_64(a, acc, digits, B, 0, k1, N, level, base_log, nd, 0,
                          false, static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
