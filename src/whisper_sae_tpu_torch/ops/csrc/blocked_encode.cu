// Hand-written Hopper kernels of the large-H top-k encode.
//
// blocked_encode_fwd = sae_centre_kernel (sae_kernels.cu),
// gemm_cols_kernel<kPre> (or gemm_kernel<kPre> where W_enc fits the L2;
// encoder_gemm.cu), then blocked_select_kernel<N>, chunk by chunk;
//   replaces whisper_sae_tpu/ops/pallas_sae.py:_encode_forward_blocked
//   (_encode_kernel_blocked, pallas_call at :1392), the branch of
//   fused_topk_encode taken when W_enc does not fit on chip (whisper-large
//   32x: D=1280, H=40960, W_enc 105 MB in bf16).
//
// What it computes for each row, as the TPU kernel does:
//   xc  = bf16(x - b_pre)                          (x f32 or bf16)
//   pre = xc @ W_enc + b_enc                       (bf16 products, f32 sums)
//   th  = exact k-th largest of pre                (topk_common.cuh)
//   out = relu(pre) * [pre >= th]                  (bf16 or f32)
//
// Bound on the H100 at bench.py's batch (B=8192; 989 TFLOP/s bf16, 3.35
// TB/s): the product is 2*B*D*H = 859 GFLOP (0.87 ms) and the bisection
// at most 33*B*H integer operations (0.17 ms at 67 T/s), while the bytes
// it must move (x 42 MB, W_enc 105 MB, the bf16 latent 671 MB) take 0.24
// ms: it is bound by operations, 0.87 ms.
//
// Why the TPU's design does not carry over: the TPU keeps a 256-row block
// of pre (40 MB of int32) in VMEM while W_enc streams past it in [D, 2048]
// tiles.  One row of pre is 160 KB here, and an SM has 228 KB of shared
// memory, so a row block cannot stay on chip.  The route takes three
// launches per chunk of at most kChunkRows rows:
//   (a) kernel A's centre (wst_sae_centre_fwd) writes the chunk's xc
//       (bf16 [chunk, D]);
//   (b) the encoder GEMM's kPre epilogue (TMA, wgmma, warp-specialised;
//       the same C entry as kernel A's encode) writes pre = acc + b_enc in
//       f32 from the registers into a [chunk, H] workspace.  W_enc^T is
//       larger than the L2 and than A, so the GEMM walks column tiles
//       outer (gemm_cols_kernel; launch_gemm decides by shape): the
//       chunk's xc (5.2 MB) stays in L2 and W_enc streams from device
//       memory once a chunk, 0.42 GB at 8192 rows, against once a 128-row
//       tile (6.7 GB) in the row-tile order the GEMM's other launches
//       keep.  Each output is one CTA's fixed K chain, so the order
//       changes no bits;
//   (c) blocked_select_kernel: one CTA per row reads its f32 row into
//       registers once, finds the threshold (cta_kth_largest: stops at the
//       first pass whose CTA total is exactly k) and writes the latent.
// Beyond the bound: the f32 workspace is written and read back, 2*4*B*H
// bytes (2.7 GB at B=8192, >= 0.80 ms); chunks of 2048 rows keep it at
// 335 MB.  Keeping pre on chip needs a thread-block cluster holding a row
// block's pre across its CTAs' shared memory, with the counts reduced
// over DSMEM: a later version.  Offsets of the [rows, H] arrays are
// 64-bit: above 13,107 rows a [rows, H] f32 array passes 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_gemm.cuh"
#include "topk_common.cuh"

// sae_kernels.cu: xc = bf16(x[row_offset + r] - b_pre) for r < rows
extern "C" int wst_sae_centre_fwd(const void* x, int x_bf16, long long row_offset, int rows, int d,
                                  const void* b_pre, void* xc, void* stream);

namespace wst {
namespace blocked {

constexpr int kChunkRows = 2048;

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One CTA per row of the chunk: the row's pre into registers once (as
// monotone ints), the exact threshold, the latent written once.
template <int N, bool F32_OUT>
__global__ void __launch_bounds__(kWideThreads, 1) blocked_select_kernel(const float* pre, int h,
                                                                         int k, void* out,
                                                                         long long row0) {
  __shared__ int warp_cnt[2][kWideWarps];
  int xi[N];
  load_wide_monotone(pre + (size_t)blockIdx.x * h, h, xi);
  const int th = cta_kth_largest(xi, k, warp_cnt);
  const size_t base = (size_t)(row0 + blockIdx.x) * h;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = j * kWideThreads + threadIdx.x;
    if (c < h) {
      const float v = masked_relu(xi[j], th);
      if (F32_OUT) {
        static_cast<float*>(out)[base + c] = v;
      } else {
        static_cast<unsigned short*>(out)[base + c] = float_to_bf16_bits(v);
      }
    }
  }
}

}  // namespace blocked
}  // namespace wst

extern "C" {

// Rows of a chunk: each chunk is three launches.
int wst_blocked_chunk_rows() { return wst::blocked::kChunkRows; }

// Bytes of the workspace for ``rows`` rows: one chunk's f32 pre [n, h],
// then its centred bf16 rows [n, d], n = min(rows, chunk).
long long wst_blocked_workspace_bytes(int rows, int d, int h) {
  const long long n = rows < wst::blocked::kChunkRows ? rows : wst::blocked::kChunkRows;
  return n * h * (long long)sizeof(float) + n * d * 2;
}

// The blocked encode over all rows, chunk by chunk: the centre, the
// product (the GEMM's kPre epilogue) into the workspace, then the
// selection into out ([rows, h], bf16, or f32 when out_f32).  ws holds
// wst_blocked_workspace_bytes(rows, d, h) bytes; w_enc_t ([h, d] bf16) is
// 16-byte aligned (read by TMA).  d and h multiples of 32, h <=
// wst_max_wide_row_width().
int wst_blocked_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                           const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                           int out_f32, void* ws, void* stream) {
  namespace B = wst::blocked;
  if (rows <= 0 || d <= 0 || d % wst::kWarp || h <= 0 || h % wst::kWarp ||
      h > wst::kMaxWideRow || k < 1 || k > h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cap = rows < B::kChunkRows ? rows : B::kChunkRows;
  float* pre = static_cast<float*>(ws);
  // 16-byte aligned, as TMA reads it: cap * h * 4 is a multiple of 128
  unsigned short* xc =
      reinterpret_cast<unsigned short*>(static_cast<char*>(ws) + (size_t)cap * h * sizeof(float));
  for (int row0 = 0; row0 < rows; row0 += B::kChunkRows) {
    const int n = rows - row0 < B::kChunkRows ? rows - row0 : B::kChunkRows;
    int err = wst_sae_centre_fwd(x, x_bf16, row0, n, d, b_pre, xc, stream);
    if (err) return err;
    err = wst_enc_gemm_fwd(wst_gemm::kPre, xc, w_enc_t, n, h, d, b_enc, 1.0f, 0, pre, nullptr,
                           nullptr, nullptr, stream);
    if (err) return err;
#define WST_LAUNCH_SELECT(N)                                                               \
  if (out_f32) {                                                                           \
    B::blocked_select_kernel<N, true><<<n, wst::kWideThreads, 0, s>>>(pre, h, k, out, row0);  \
  } else {                                                                                 \
    B::blocked_select_kernel<N, false><<<n, wst::kWideThreads, 0, s>>>(pre, h, k, out, row0); \
  }
    WST_WIDE_DISPATCH(h, WST_LAUNCH_SELECT)
#undef WST_LAUNCH_SELECT
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
