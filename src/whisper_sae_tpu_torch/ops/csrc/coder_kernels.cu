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
// gained by keeping a row's pre on chip (the TopK modes' reason for a row
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
// decode has 3 output tiles of 48 K blocks each for 132 SMs.
//
// TopK modes (k > 0): kernel A's route (sae_kernels.cu), four launches
// (five with the skip path).
//  1. coder_cast_kernel writes xc as above and zeroes the int32 counts
//     (l0 and the [H] active flags).
//  2. gemm_kernel<kPre> (wst_enc_gemm_fwd): A = xc, B = W_enc^T [H, D];
//     pre = acc + b_enc in f32 to a workspace [B, H].
//  3. Skip mode: gemm_kernel<kPre> again, A = xc, B = W_skip^T [dout, D],
//     bias b_out: the base xc @ W_skip + b_out, f32, straight into resid.
//  4. coder_select_decode_kernel<SKIP, Y_IS_X>: one warp a row loads its
//     pre into registers, finds the threshold (topk_common.cuh), writes
//     the bf16 latent, sets the active flags and compacts its positive
//     selections into its list in shared memory, in feature order; then
//     decodes from those rows of W_dec [H, dout] alone, lanes over dout,
//     in passes of kDecCols = 384 columns (the crosscoder's dout = 1536
//     takes four), from the rounded latent; resid = (decode + base) - y
//     with base = resid's row (Skip) or b_out; one sum(resid^2) partial
//     and an l0 atomic a CTA of four rows (select_decode.cuh, shared with
//     kernel A).
//  5. coder_sum_kernel adds the partials in a fixed order.
// The price is kernel A's: the f32 pre's round trip through device
// memory, 2*B*H*4 bytes beyond the bound (101 MB at B=4096, ~0.03 ms),
// and the decode's gathers, k rows of W_dec a row (32 * 1536 * 2 bytes
// at the crosscoder), served from L2.  The TopK modes' earlier form, a row
// kernel of 16-row CTAs (mma.sync from L2, a [16, H] f32 tile of pre in
// shared memory, so one CTA an SM, re-reading both weights every 16 rows,
// and a dense decode of the latent's zeros), took 0.3157 / 0.2900 /
// 1.0914 ms for the Skip / TopK transcoder and the TopK crosscoder at
// B=4096 (PERF.md, rows 6a, 6b, 6d).
//
// Cross-CTA reductions without float atomics (CTAs run concurrently,
// unlike the TPU grid's read-modify-write accumulation at :606-622): l0
// and active are int32 atomics (order-free; ReLU mode needs only l0's);
// sum(resid^2) and the [H] hsum are written as partials and summed in a
// fixed order by coder_sum_kernel and coder_hsum_kernel.  The loss has
// the same bits from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "select_decode.cuh"
#include "topk_common.cuh"

namespace wst {
namespace coder {

constexpr int kSumThreads = 256;
constexpr int kCastThreads = 256;

__device__ __forceinline__ float load_val(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

struct SelectArgs {
  const void* x;              // [>= row_offset + rows, d] f32 or bf16
  int x_bf16;
  const void* y;              // [>= row_offset + rows, dout] f32 or bf16 (not Y_IS_X)
  int y_bf16;
  long long row_offset;       // first row of this batch in x (and y)
  int rows, d, h, dout, k;
  const float* pre;           // [rows, h] f32: xc @ W_enc + b_enc
  const unsigned short* w_dec;  // [h, dout] bf16
  const float* b_out;         // [dout] (not SKIP)
  unsigned short* hidden;     // [rows, h] bf16
  float* resid;               // [rows, dout]; SKIP: holds xc @ W_skip + b_out on entry
  float* sq_partial;          // [gridDim.x]
  int* counts;                // [1 + h], zeroed: l0, active
};

// One warp a row: the threshold, the latent, the sparse decode in passes
// of kDecCols columns and the row's share of the loss; dynamic shared
// memory holds each warp's list of selections (h entries at most).
template <bool SKIP, bool Y_IS_X>
__global__ void __launch_bounds__(kSelThreads, 4) coder_select_decode_kernel(SelectArgs a) {
  extern __shared__ unsigned int sel_lists[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int g = blockIdx.x * kSelWarps + warp;
  float sq = 0.0f;
  int nsel = 0;
  if (g < a.rows) {  // warp-uniform
    int xi[kMaxPerLane];
    load_row_monotone(a.pre + (size_t)g * a.h, a.h, lane, xi);
    const int th = warp_kth_largest(xi, a.k);
    unsigned int* list = sel_lists + warp * a.h;
    nsel = select_to_list(xi, th, a.h, lane, a.hidden + (size_t)g * a.h, a.counts + 1, list);

    const size_t src = (size_t)(a.row_offset + g);
    float* rrow = a.resid + (size_t)g * a.dout;
    for (int c0 = 0; c0 < a.dout; c0 += kDecCols) {
      const int nt = min(kDecCols, a.dout - c0) / kWarp;
      float acc[kDecTiles];
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) acc[t] = 0.0f;
      sparse_decode(list, nsel, a.w_dec, a.dout, c0, nt, lane, acc);
      float base[kDecTiles], yv[kDecTiles];
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) {
        const int c = c0 + (t < nt ? t : 0) * kWarp + lane;
        base[t] = SKIP ? rrow[c] : a.b_out[c];
        yv[t] = Y_IS_X ? load_val(a.x, a.x_bf16, src * a.d + c)
                       : load_val(a.y, a.y_bf16, src * a.dout + c);
      }
#pragma unroll
      for (int t = 0; t < kDecTiles; ++t) {
        if (t < nt) {
          const float res = (acc[t] + base[t]) - yv[t];
          rrow[c0 + t * kWarp + lane] = res;
          sq = fmaf(res, res, sq);
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  cta_partial(sq, nsel, a.sq_partial, a.counts);
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
// a multiple of 4, so a group never straddles a row); counts[0 : n_counts]
// = 0 for the launches that follow.
__global__ void __launch_bounds__(kCastThreads) coder_cast_kernel(const void* x, int x_bf16,
                                                                  long long row_offset, int d,
                                                                  long long groups,
                                                                  unsigned short* xc, int* counts,
                                                                  int n_counts) {
  const long long first = (long long)blockIdx.x * kCastThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kCastThreads;
  for (long long i = first; i < n_counts; i += stride) counts[i] = 0;
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

int cast(const void* x, int x_bf16, long long row_offset, int rows, int d, void* xc,
         void* counts, int n_counts, cudaStream_t s) {
  const long long groups = (long long)rows * d / 4;
  const long long want = (groups + kCastThreads - 1) / kCastThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  coder_cast_kernel<<<blocks, kCastThreads, 0, s>>>(x, x_bf16, row_offset, d, groups,
                                                    static_cast<unsigned short*>(xc),
                                                    static_cast<int*>(counts), n_counts);
  return (int)cudaGetLastError();
}

// The ReLU modes (y is x): cast, encode (kRelu), decode (kResid), hsum, sums.
int relu_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d, int h, int dout,
             const void* w_enc_t, const void* b_enc, const void* w_dec_t, const void* b_out,
             void* hidden, void* resid, void* xc, void* sq_partial, void* hsum_partial,
             void* l0, void* sums, void* hsum, void* stream) {
  if (dout != d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cast(x, x_bf16, row_offset, rows, d, xc, l0, 1, s);
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

template <bool SKIP, bool Y_IS_X>
int launch_select(const SelectArgs& a, cudaStream_t s) {
  const size_t smem = (size_t)kSelWarps * a.h * sizeof(unsigned int);
  const cudaError_t err = cudaFuncSetAttribute(coder_select_decode_kernel<SKIP, Y_IS_X>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.rows + kSelWarps - 1) / kSelWarps;
  coder_select_decode_kernel<SKIP, Y_IS_X><<<blocks, kSelThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The TopK modes: cast, encode (kPre), [the skip product (kPre)], select
// and decode, sum.
int topk_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset, int rows,
             int d, int h, int dout, int k, int use_skip, int y_is_x, const void* w_enc_t,
             const void* b_enc, const void* w_dec, const void* b_out, const void* w_skip_t,
             void* hidden, void* resid, void* xc, void* pre, void* sq_partial, void* counts,
             void* sums, void* stream) {
  if (h > kMaxRow || k > h || (y_is_x ? dout != d : y == nullptr) || (use_skip && !w_skip_t))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cast(x, x_bf16, row_offset, rows, d, xc, counts, 1 + h, s);
  if (err) return err;
  err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_enc_t, rows, h, d, b_enc, 1.0f, 0, pre, nullptr,
                         nullptr, nullptr, stream);
  if (err) return err;
  if (use_skip) {
    err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_skip_t, rows, dout, d, b_out, 1.0f, 0, resid,
                           nullptr, nullptr, nullptr, stream);
    if (err) return err;
  }
  const SelectArgs a{x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k,
                     static_cast<const float*>(pre),
                     static_cast<const unsigned short*>(w_dec),
                     static_cast<const float*>(b_out),
                     static_cast<unsigned short*>(hidden),
                     static_cast<float*>(resid),
                     static_cast<float*>(sq_partial),
                     static_cast<int*>(counts)};
  err = use_skip ? (y_is_x ? launch_select<true, true>(a, s) : launch_select<true, false>(a, s))
                 : (y_is_x ? launch_select<false, true>(a, s) : launch_select<false, false>(a, s));
  if (err) return err;
  const int blocks = (rows + kSelWarps - 1) / kSelWarps;
  coder_sum_kernel<<<1, kSumThreads, 0, s>>>(static_cast<const float*>(sq_partial), blocks,
                                              nullptr, 0, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // namespace coder
}  // namespace wst

extern "C" {

// The coder forward: sums[0] = sum(resid^2), counts[0] = l0 count; d, h
// and dout multiples of 32.  k > 0 selects TopK: w_dec is W_dec itself
// [h, dout] bf16 (the rows the sparse decode gathers), pre an f32 [rows,
// h] workspace, sq_partial [ceil(rows / wst_rows_per_cta())] (4 rows a
// partial), counts [1 + h] (counts[1 + j] = feature j active), h <= 3072;
// w_skip_t [dout, d] with use_skip.  k <= 0 is ReLU mode (y is x, no skip):
// w_dec is W_dec^T [dout, h], sums[1] = sum(hid) and hsum[h] (feature j is
// active when hsum[j] > 0), with sq_partial [ceil(rows / 128) * ceil(dout /
// 128)], hsum_partial [ceil(rows / 64), h] (wst_gemm_tile() = 128) and
// counts [1].  The counts are zeroed here.
int wst_coder_fwd(const void* x, int x_bf16, const void* y, int y_bf16, long long row_offset,
                  int rows, int d, int h, int dout, int k, int use_skip, int y_is_x,
                  const void* w_enc_t, const void* b_enc, const void* w_dec, const void* b_out,
                  const void* w_skip_t, void* hidden, void* resid, void* xc, void* pre,
                  void* sq_partial, void* hsum_partial, void* counts, void* sums, void* hsum,
                  void* stream) {
  namespace C = wst::coder;
  if (rows <= 0 || d <= 0 || h <= 0 || dout <= 0 || d % wst::kWarp || h % wst::kWarp ||
      dout % wst::kWarp)
    return (int)cudaErrorInvalidValue;
  if (k <= 0) {
    if (use_skip || !y_is_x) return (int)cudaErrorInvalidValue;
    return C::relu_fwd(x, x_bf16, row_offset, rows, d, h, dout, w_enc_t, b_enc, w_dec, b_out,
                       hidden, resid, xc, sq_partial, hsum_partial, counts, sums, hsum, stream);
  }
  return C::topk_fwd(x, x_bf16, y, y_bf16, row_offset, rows, d, h, dout, k, use_skip, y_is_x,
                     w_enc_t, b_enc, w_dec, b_out, w_skip_t, hidden, resid, xc, pre, sq_partial,
                     counts, sums, stream);
}

}  // extern "C"
