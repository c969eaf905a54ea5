// Hand-written Hopper kernels of the coder families' training forward,
// one C call ("coder_fwd", wst_coder_fwd) that replaces
// whisper_sae_tpu/ops/pallas_sae.py:_fused_coder_kernel, reached by
// _fused_coder_forward (pallas_call at :679; fused_transcoder_loss,
// fused_relu_sae_loss, fused_relu_crosscoder_loss) and, with a row offset
// into the epoch buffers, by _fused_coder_forward_indexed (:1057; the
// three *_indexed entries).
//
// What it computes for each row (no centring: these families have no b_pre):
//   xc    = bf16(x)
//   pre   = xc @ W_enc + b_enc                       (bf16 products, f32 sums)
//   hid   = bf16(topk_mask(pre, k))  or  bf16(relu(pre))
//   pred  = (hid @ W_dec + b_out) [+ xc @ W_skip]    (b_out = b_dec [+ b_skip])
//   resid = pred - f32(y)                            (y = x itself when Y_IS_X)
//   and sum(resid^2), count(hid > 0), active[j] |= hid_j > 0; in ReLU mode
//   also sum(hid) and hsum[j] = sum_b hid_bj over the f32 (unrounded) hid.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations for the ReLU
// modes and the crosscoders (2*B*D*H encode plus, for ReLU, the dense
// 2*B*H*dout decode: 19 GFLOP for the ReLU SAE and 77 GFLOP for the ReLU
// crosscoder at B=4096), bytes for the TopK transcoders (their sparse
// decode needs 2*B*k*dout FLOPs; x, y, the weights, the bf16 latent and
// the f32 residual are ~52 MB at B=4096, 16 us).
//
// ReLU modes (k <= 0): five launches, each of the two products on the
// warp-specialised TMA/wgmma GEMM of encoder_gemm.cu.  The latent is about
// half positive, so the decode is a second dense GEMM, and nothing is
// gained by keeping a row's pre on chip (kernel A's reason for a row
// kernel, the exact top-k, is absent).
//  1. coder_cast_kernel writes xc = bf16(x[row_offset + r]) once: the
//     backward's operand and the encode's A; and zeroes l0.
//  2. gemm_kernel<kRelu>: A = xc, B = W_enc^T [H, D]; hid =
//     bf16(relu(acc + b_enc)) through the output tile and TMA; from the
//     f32 values, the per-feature sums of each 64 rows (hsum_partial
//     [ceil(B/64), H]) and l0 (an int32 atomic).  Rows past B load as TMA
//     zeros and their acc + b_enc = b_enc, about half positive: the
//     epilogue leaves them out of every sum and of l0.
//  3. gemm_kernel<kResid>: A = hid, B = W_dec^T [dout, H]; resid = acc +
//     b_dec - f32(x) in f32 from the registers, and one sum(resid^2)
//     partial a 128 x 128 output tile.
//  4. coder_hsum_kernel: hsum[j] = the partials of column j, in row order;
//     feature j is active exactly when hsum[j] > 0 (a sum of values >= 0),
//     which the caller reads off hsum.
//  5. coder_sum_kernel: sums[0] = the sq partials, sums[1] = sum(hsum),
//     each in a fixed order.
// The price: hid makes one bf16 round trip through device memory (2*B*H*2
// bytes, 50 MB at B=4096: 15 us at 3.35 TB/s), and at 128 rows the
// decode has 3 output tiles of 48 K blocks each for 132 SMs.  The ReLU
// modes' earlier form, the TopK row kernel below with a ReLU (16-row CTAs,
// mma.sync from L2, a [16, H] f32 tile of pre in shared memory, so one CTA
// an SM, re-reading both weights every 16 rows), took 0.2855 ms for the
// ReLU SAE and 1.1092 for the ReLU crosscoder at B=4096 (PERF.md, rows 6c
// and 6e).
//
// TopK modes (k > 0): coder_rows_kernel<SKIP, Y_IS_X>, then
// coder_sum_kernel.  A CTA owns 16 rows (the M of one
// mma.sync.m16n8k16 tile) and keeps their [16, H] f32 pre-activation in
// shared memory (192 KB at H=3072), so pre and the latent never reach
// device memory except as the bf16 latent the backward needs.  The rows'
// bf16 tile sits beside it when it fits (D=384: 12 KB); at the
// crosscoder's L*D=1536 it does not (48 KB), and the products read their
// A fragments from the CTA's own bf16 rows in device memory (written first,
// then served from L1/L2).  The top-k gives each row to one warp, which
// holds it in registers (topk_common.cuh: the exact 32-pass
// bisection) and overwrites the row's f32 slot with its bf16
// latent; then the decode is a tensor-core product of that latent tile
// with W_dec^T (TopK decodes its zeros too, which costs FLOPs, not bytes).
// Weights are read as their bf16 transposes [N, K] and stay in L2; every
// lane takes its A and B fragments for two MMA steps with one 16-byte
// load each (a permutation of K that A and B share) and keeps four such
// K blocks of loads in flight before their MMAs, so the products wait on
// L2 bandwidth rather than on one round trip per 16-wide K step.  The
// encode gives each warp 32 columns of H at a time, the decode 16 of dout
// (24 tiles for 8 warps at dout=384, none idle).  Not yet fast: no wgmma,
// TMA, warp specialisation or persistent grid; each CTA re-reads W_enc and
// W_dec from L2 (ROADMAP queue 2).
//
// Cross-CTA reductions without float atomics (CTAs run concurrently,
// unlike the TPU grid's read-modify-write accumulation at :606-622): l0
// and active are int32 atomics (order-free; ReLU mode needs only l0's);
// sum(resid^2) and the [H]
// hsum are written as partials and summed in a fixed order by
// coder_sum_kernel and coder_hsum_kernel.  The loss has the same bits
// from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "topk_common.cuh"

namespace wst {
namespace coder {

constexpr int kRows = 16;   // rows per CTA: the M of one mma.sync tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kEncTiles = 4;  // n8 tiles per encode warp step: 32 columns of H
constexpr int kDecTiles = 2;  // n8 tiles per decode warp step: 16 columns of dout
constexpr int kLoads = 4;     // 32-wide K blocks whose loads are in flight together
constexpr int kSumThreads = 256;
constexpr int kCastThreads = 256;
constexpr int kSmemOptin = 232448;  // H100: shared memory a block may opt into
constexpr int kSmemStatic = 1024;   // margin for the kernel's static arrays

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_val(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Eight bf16 (16 bytes) of row r of a row-major bf16 tile (shared or
// device memory) from column c; rows past the batch read as zeros.
__device__ __forceinline__ uint4 ld_row8(const unsigned short* base, int stride, int r, int c,
                                        int nrows) {
  return r < nrows ? *reinterpret_cast<const uint4*>(base + (size_t)r * stride + c)
                   : make_uint4(0u, 0u, 0u, 0u);
}

// acc[t] += A[16, K] @ Bt[n0 + 8t : n0 + 8t + 8, :]^T over K (a multiple
// of 32), for one warp: A row-major (stride a_stride), Bt the [N, K] bf16
// transpose (stride K).  Within each 32-wide K block, lane q = lane & 3
// loads the 8 consecutive k at 8q of its two A rows and its B row with
// one 16-byte load each, and feeds them to two m16n8k16 steps as the
// fragments' k pairs {2q, 2q+1, 2q+8, 2q+9}: A and B see the same
// permutation of k, so the sum is the same product.  U blocks of loads
// are issued before their MMAs, so U L2 round trips overlap instead of
// following one another.
template <int NT, int U>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const unsigned short* a,
                                             int a_stride, int nrows,
                                             const unsigned short* bt, int kdim, int n0,
                                             int lane) {
  const int fr = lane >> 2, q = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += 32 * U) {
    uint4 av[U][2], bv[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kc = k0 + 32 * u + 8 * q;
      if (k0 + 32 * u < kdim) {
        av[u][0] = ld_row8(a, a_stride, fr, kc, nrows);
        av[u][1] = ld_row8(a, a_stride, fr + 8, kc, nrows);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          bv[u][t] = __ldg(reinterpret_cast<const uint4*>(bt + (size_t)(n0 + t * 8 + fr) * kdim + kc));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + 32 * u < kdim) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          mma_16816(acc[t], av[u][0].x, av[u][1].x, av[u][0].y, av[u][1].y, bv[u][t].x, bv[u][t].y);
          mma_16816(acc[t], av[u][0].z, av[u][1].z, av[u][0].w, av[u][1].w, bv[u][t].z, bv[u][t].w);
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row strides of the shared tiles, chosen so that a quarter-warp's 16-byte
// fragment loads (two rows x 64 bytes) fall on all 32 banks once: 16 words
// mod 32.  pre_stride is in f32 words and is also the bf16 latent's row
// stride in words (the latent overwrites its row's f32 slot); x_stride
// is in bf16 elements.  H and D are multiples of 32.
__host__ __device__ __forceinline__ int pre_stride(int h) { return h + 16; }
__host__ __device__ __forceinline__ int x_stride(int d) { return d + (d % 64 == 0 ? 32 : 0); }

struct CoderArgs {
  const void* x;              // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  const void* y;              // [>= row_offset + rows, dout] f32 or bf16 (not Y_IS_X)
  int y_bf16;
  long long row_offset;       // first row of this batch in x (and y)
  int rows, d, h, dout, k;
  const unsigned short* w_enc_t;   // [h, d] bf16: W_enc transposed
  const float* b_enc;              // [h]
  const unsigned short* w_dec_t;   // [dout, h] bf16: W_dec transposed
  const float* b_out;              // [dout]
  const unsigned short* w_skip_t;  // [dout, d] bf16 (SKIP)
  unsigned short* hidden;     // [rows, h] bf16
  float* resid;               // [rows, dout]
  unsigned short* xc;         // [rows, d] bf16
  float* sq_partial;          // [gridDim.x]
  int* counts;                // [1 + h], zeroed: l0, active
  int stage_x;                // the rows' bf16 tile is staged in shared memory
};

template <bool SKIP, bool Y_IS_X>
__global__ void __launch_bounds__(kThreads, 1) coder_rows_kernel(CoderArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = pre_stride(a.h);
  const int ds = x_stride(a.d);
  float* pre_s = reinterpret_cast<float*>(smem);
  unsigned short* xs = reinterpret_cast<unsigned short*>(pre_s + kRows * hs);
  __shared__ float warp_part[kWarps];
  __shared__ int row_l0[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.rows - row0);

  // -- bf16 rows: to device memory (the backward's operand) and, when they
  //    fit, to shared memory; rows past the batch are zeros ---------------
  for (int i = tid; i < kRows * a.d; i += kThreads) {
    const int r = i / a.d, c = i - r * a.d;
    unsigned short v = 0;
    if (r < nrows) {
      const size_t g = (size_t)(row0 + r);
      v = float_to_bf16_bits(load_val(a.x, a.x_bf16, (size_t)(a.row_offset + g) * a.d + c));
      a.xc[g * a.d + c] = v;
    }
    if (a.stage_x) xs[r * ds + c] = v;
  }
  if (tid < kRows) row_l0[tid] = 0;
  __syncthreads();
  const unsigned short* xa = a.stage_x ? xs : a.xc + (size_t)row0 * a.d;
  const int xa_stride = a.stage_x ? ds : a.d;

  // -- encode: pre = xc @ W_enc + b_enc, into shared memory -----------------
  {
    const int fr = lane >> 2, fc = (lane & 3) * 2;
    constexpr int cols = kEncTiles * 8;
    for (int n0 = warp * cols; n0 < a.h; n0 += kWarps * cols) {
      float acc[kEncTiles][4] = {};
      warp_product<kEncTiles, kLoads>(acc, xa, xa_stride, nrows, a.w_enc_t, a.d, n0, lane);
#pragma unroll
      for (int t = 0; t < kEncTiles; ++t) {
        const int col = n0 + t * 8 + fc;
        const float be0 = a.b_enc[col], be1 = a.b_enc[col + 1];
        *reinterpret_cast<float2*>(pre_s + fr * hs + col) = make_float2(acc[t][0] + be0,
                                                                        acc[t][1] + be1);
        *reinterpret_cast<float2*>(pre_s + (fr + 8) * hs + col) = make_float2(acc[t][2] + be0,
                                                                              acc[t][3] + be1);
      }
    }
  }
  __syncthreads();

  // -- one warp per row: the row in registers, its threshold, the bf16
  //    latent over the row's own f32 slot and to device memory -----------
  for (int r = warp; r < kRows; r += kWarps) {
    unsigned short* lat = reinterpret_cast<unsigned short*>(pre_s + r * hs);
    if (r >= nrows) {  // warp-uniform: zero latent rows past the batch
      for (int c = lane; c < a.h; c += kWarp) lat[c] = 0;
      continue;
    }
    const size_t g = (size_t)(row0 + r);
    int xi[kMaxPerLane];
    load_row_monotone(pre_s + r * hs, a.h, lane, xi);
    const int th = warp_kth_largest(xi, a.k);
    __syncwarp();  // the whole row is in registers before its slot is rewritten
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int c = j * kWarp + lane;
      if (c < a.h) {
        const float v = masked_relu(xi[j], th);
        const unsigned short bits = float_to_bf16_bits(v);
        lat[c] = bits;
        a.hidden[g * a.h + c] = bits;
        if (v > 0.0f) {
          ++cnt;
          atomicOr(&a.counts[1 + c], 1);
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (lane == 0) row_l0[r] = cnt;
  }
  __syncthreads();

  // -- decode: pred = (hid @ W_dec + b_out) [+ xc @ W_skip]; resid = pred - y
  const unsigned short* lat_s = reinterpret_cast<const unsigned short*>(pre_s);
  const int ls = 2 * hs;  // latent row stride in bf16 elements
  float sq = 0.0f;
  {
    const int fr = lane >> 2, fc = (lane & 3) * 2;
    constexpr int cols = kDecTiles * 8;
    for (int n0 = warp * cols; n0 < a.dout; n0 += kWarps * cols) {
      float acc[kDecTiles][4] = {};
      float acc_skip[kDecTiles][4] = {};
      warp_product<kDecTiles, kLoads>(acc, lat_s, ls, kRows, a.w_dec_t, a.h, n0, lane);
      if (SKIP)
        warp_product<kDecTiles, kLoads>(acc_skip, xa, xa_stride, nrows, a.w_skip_t, a.d, n0, lane);
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = fr + 8 * half;
          if (r >= nrows) continue;
          const size_t g = (size_t)(row0 + r);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + t * 8 + fc + e;
            float p = acc[t][2 * half + e] + a.b_out[col];
            if (SKIP) p += acc_skip[t][2 * half + e];
            const float yv = Y_IS_X
                ? load_val(a.x, a.x_bf16, (size_t)(a.row_offset + g) * a.d + col)
                : load_val(a.y, a.y_bf16, (size_t)(a.row_offset + g) * a.dout + col);
            const float res = p - yv;
            a.resid[g * a.dout + col] = res;
            sq = fmaf(res, res, sq);
          }
        }
      }
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) warp_part[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    int l0 = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w];
    for (int r = 0; r < kRows; ++r) l0 += row_l0[r];
    a.sq_partial[blockIdx.x] = s;
    atomicAdd(&a.counts[0], l0);
  }
}

// sums[blockIdx.x] = the n_sq partials of block 0 (sum resid^2) or the
// n_hid values of block 1 (sum hid: the per-feature sums), in a fixed
// order (strided per thread, then a fixed tree).
__global__ void __launch_bounds__(kSumThreads) coder_sum_kernel(const float* sq_partial, int n_sq,
                                                                const float* hsum, int n_hid,
                                                                float* sums) {
  __shared__ float buf[kSumThreads];
  const float* p = blockIdx.x == 0 ? sq_partial : hsum;
  const int n = blockIdx.x == 0 ? n_sq : n_hid;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += p[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = buf[0];
}

// hsum[j] = sum over blocks of rows of hsum_partial[:, j], in order.
__global__ void __launch_bounds__(kSumThreads) coder_hsum_kernel(const float* partial, int blocks,
                                                                 int h, float* hsum) {
  const int j = blockIdx.x * kSumThreads + threadIdx.x;
  if (j >= h) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * h + j];
  hsum[j] = s;
}

// xc = bf16(x[row_offset : row_offset + rows]), four values a thread (d is
// a multiple of 4, so a group never straddles a row); *l0 = 0 for the
// encode that follows.
__global__ void __launch_bounds__(kCastThreads) coder_cast_kernel(const void* x, int x_bf16,
                                                                  long long row_offset, int d,
                                                                  long long groups,
                                                                  unsigned short* xc, int* l0) {
  const long long first = (long long)blockIdx.x * kCastThreads + threadIdx.x;
  if (first == 0) *l0 = 0;
  const long long stride = (long long)gridDim.x * kCastThreads;
  const long long src = row_offset * d;
  for (long long i = first; i < groups; i += stride) {
    if (x_bf16) {
      reinterpret_cast<uint2*>(xc)[i] =
          __ldg(reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(x) + src) + i);
    } else {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) + src) + i);
      const unsigned int lo = float_to_bf16_bits(v.x) | ((unsigned int)float_to_bf16_bits(v.y) << 16);
      const unsigned int hi = float_to_bf16_bits(v.z) | ((unsigned int)float_to_bf16_bits(v.w) << 16);
      reinterpret_cast<uint2*>(xc)[i] = make_uint2(lo, hi);
    }
  }
}

size_t smem_bytes(int d, int h, int stage_x) {
  return (size_t)kRows * pre_stride(h) * sizeof(float) +
         (stage_x ? (size_t)kRows * x_stride(d) * sizeof(unsigned short) : 0);
}

template <bool SKIP, bool Y_IS_X>
int launch(const CoderArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(coder_rows_kernel<SKIP, Y_IS_X>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.rows + kRows - 1) / kRows;
  coder_rows_kernel<SKIP, Y_IS_X><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool SKIP>
int launch_y(const CoderArgs& a, int y_is_x, size_t smem, cudaStream_t s) {
  return y_is_x ? launch<SKIP, true>(a, smem, s) : launch<SKIP, false>(a, smem, s);
}

// The ReLU modes (y is x): cast, encode (kRelu), decode (kResid), hsum, sums.
int relu_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d, int h, int dout,
             const void* w_enc_t, const void* b_enc, const void* w_dec_t, const void* b_out,
             void* hidden, void* resid, void* xc, void* sq_partial, void* hsum_partial,
             void* l0, void* sums, void* hsum, void* stream) {
  if (d % 4 || dout != d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = (long long)rows * d / 4;
  const long long want = (groups + kCastThreads - 1) / kCastThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  coder_cast_kernel<<<blocks, kCastThreads, 0, s>>>(x, x_bf16, row_offset, d, groups,
                                                    static_cast<unsigned short*>(xc),
                                                    static_cast<int*>(l0));
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = wst_coder_gemm_fwd(wst_gemm::kRelu, xc, w_enc_t, rows, h, d, b_enc, hidden, hsum_partial,
                           l0, nullptr, 0, 0, stream);
  if (err) return err;
  err = wst_coder_gemm_fwd(wst_gemm::kResid, hidden, w_dec_t, rows, dout, h, b_out, resid,
                           sq_partial, nullptr, x, x_bf16, row_offset, stream);
  if (err) return err;
  const int tile = wst_gemm_tile();
  const int hsum_rows = (rows + tile / 2 - 1) / (tile / 2);
  const int sq_parts = (rows + tile - 1) / tile * ((dout + tile - 1) / tile);
  coder_hsum_kernel<<<(h + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      static_cast<const float*>(hsum_partial), hsum_rows, h, static_cast<float*>(hsum));
  coder_sum_kernel<<<2, kSumThreads, 0, s>>>(static_cast<const float*>(sq_partial), sq_parts,
                                              static_cast<const float*>(hsum), h,
                                              static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace coder
}  // namespace wst

extern "C" {

// Rows per CTA of the TopK modes' row kernel (one sq partial a CTA).
int wst_coder_rows_per_cta() { return wst::coder::kRows; }

// The coder forward: sums[0] = sum(resid^2), counts[0] = l0 count.  k > 0
// selects TopK: the row kernel, sq_partial [ceil(rows / 16)], counts
// [1 + h] zeroed by the caller, counts[1 + j] = feature j active.  k <= 0
// is ReLU mode (y is x, no skip): sums[1] = sum(hid) and hsum[h] (feature
// j is active when hsum[j] > 0), with sq_partial [ceil(rows / 128) *
// ceil(dout / 128)], hsum_partial [ceil(rows / 64), h] (wst_gemm_tile() =
// 128) and counts [1], set here.
int wst_coder_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset,
                  int rows, int d, int h, int dout, int k, int use_skip, int y_is_x,
                  const void* w_enc_t, const void* b_enc, const void* w_dec_t, const void* b_out,
                  const void* w_skip_t, void* hidden, void* resid, void* xc, void* sq_partial,
                  void* hsum_partial, void* counts, void* sums, void* hsum, void* stream) {
  namespace C = wst::coder;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  if (k <= 0) {
    if (use_skip || !y_is_x) return (int)cudaErrorInvalidValue;
    return C::relu_fwd(x, x_bf16, row_offset, rows, d, h, dout, w_enc_t, b_enc, w_dec_t, b_out,
                       hidden, resid, xc, sq_partial, hsum_partial, counts, sums, hsum, stream);
  }
  int stage_x = 1;
  size_t smem = C::smem_bytes(d, h, stage_x);
  if (smem > (size_t)(C::kSmemOptin - C::kSmemStatic)) {
    stage_x = 0;
    smem = C::smem_bytes(d, h, stage_x);
  }
  C::CoderArgs a{x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k,
                 static_cast<const unsigned short*>(w_enc_t),
                 static_cast<const float*>(b_enc),
                 static_cast<const unsigned short*>(w_dec_t),
                 static_cast<const float*>(b_out),
                 static_cast<const unsigned short*>(w_skip_t),
                 static_cast<unsigned short*>(hidden),
                 static_cast<float*>(resid),
                 static_cast<unsigned short*>(xc),
                 static_cast<float*>(sq_partial),
                 static_cast<int*>(counts),
                 stage_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = use_skip ? C::launch_y<true>(a, y_is_x, smem, s)
                           : C::launch_y<false>(a, y_is_x, smem, s);
  if (err != 0) return err;
  const int blocks = (rows + C::kRows - 1) / C::kRows;
  C::coder_sum_kernel<<<1, C::kSumThreads, 0, s>>>(static_cast<const float*>(sq_partial), blocks,
                                                   nullptr, 0, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // extern "C"
