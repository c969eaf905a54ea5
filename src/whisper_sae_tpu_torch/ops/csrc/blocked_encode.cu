// Hand-written Hopper kernels of the large-H top-k encode.
//
// blocked_encode_fwd = encode_gemm_kernel, then blocked_select_kernel<N>
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
// 33*B*H integer operations (0.17 ms at 67 T/s), while the bytes it must
// move (x 42 MB, W_enc 105 MB, the bf16 latent 671 MB) take 0.24 ms: it
// is bound by operations, 0.87 ms.
//
// Why the TPU's design does not carry over: the TPU keeps a 256-row block
// of pre (40 MB of int32) in VMEM while W_enc streams past it in [D, 2048]
// tiles.  One row of pre is 160 KB here, and an SM has 228 KB of shared
// memory, so a row block cannot stay on chip.  This first version takes
// two launches per chunk of at most kChunkRows rows:
//   (a) encode_gemm_kernel: a 128x128 tile of pre per CTA, mma.sync
//       m16n8k16 (bf16 in, f32 sums), K = D streamed through shared
//       memory in 32-wide slices, two stages: W_enc^T's slice by cp.async,
//       the rows' slice loaded, centred and rounded to bf16 in registers
//       while the previous slice is multiplied.  The epilogue adds b_enc
//       and writes the monotone int32 view of pre to a workspace.
//   (b) blocked_select_kernel: one CTA per row reads its workspace row
//       into registers once, finds the threshold (cta_kth_largest) and
//       writes the latent.
// The workspace adds 2*4*B*H bytes of traffic (2.7 GB at B=8192, >= 0.8
// ms) beyond the bound; chunks of 2048 rows keep it at 335 MB.  Keeping
// pre on chip needs a thread-block cluster holding a row block's pre
// across its CTAs' shared memory, with the counts reduced over DSMEM: a
// later version.  Offsets of the [rows, H] arrays are 64-bit: above
// 13,107 rows an int32 workspace passes 2^31 bytes.
//
// Not yet fast: no wgmma, TMA or ldmatrix; the A slice is not staged by
// cp.async because it is converted on the way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace wst {
namespace blocked {

constexpr int kBM = 128;  // rows of a product tile
constexpr int kBN = 128;  // features of a product tile
constexpr int kBK = 32;   // depth of a shared-memory slice
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along features, 64x32 each
// Slice row stride in bf16 elements: 80 bytes, so the 8 rows a fragment
// load touches start 20 words apart and fall on distinct banks.
constexpr int kStride = kBK + 8;
constexpr int kChunkRows = 2048;

__device__ __forceinline__ unsigned short float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(float_to_bf16_bits(lo)) |
         (static_cast<uint32_t>(float_to_bf16_bits(hi)) << 16);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without registers; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

struct GemmArgs {
  const void* x;   // [>= row0 + rows, d] f32 or bf16
  int x_bf16;
  long long row0;  // first row of this chunk in x
  int rows, d, h;  // rows in this chunk
  const unsigned short* w_enc_t;  // [h, d] bf16: W_enc transposed
  const float* b_enc;             // [h]
  const float* b_pre;             // [d]
  int* ws;                        // [rows, h]: monotone int of pre
};

// Thread t stages row t/2, columns (t&1)*16 .. +16 of a slice: 16 values
// of x, centred and rounded to bf16, packed in pairs.
__device__ __forceinline__ void load_a(const GemmArgs& a, int m0, int k0, uint32_t (&pk)[8]) {
  const int r = threadIdx.x >> 1, c = k0 + (threadIdx.x & 1) * 16;
  const int g = m0 + r;
  if (g >= a.rows) {
#pragma unroll
    for (int i = 0; i < 8; ++i) pk[i] = 0u;
    return;
  }
  const size_t off = (size_t)(a.row0 + g) * a.d + c;
  float v[16];
  if (a.x_bf16) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const unsigned short*>(a.x) + off);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 u = p[q];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[q * 8 + 2 * e] = bf16_bits_to_float(static_cast<unsigned short>(w[e] & 0xffffu));
        v[q * 8 + 2 * e + 1] = bf16_bits_to_float(static_cast<unsigned short>(w[e] >> 16));
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = p[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
  const float4* bp = reinterpret_cast<const float4*>(a.b_pre + c);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 b = __ldg(bp + q);
    pk[2 * q] = pack_bf16(v[4 * q] - b.x, v[4 * q + 1] - b.y);
    pk[2 * q + 1] = pack_bf16(v[4 * q + 2] - b.z, v[4 * q + 3] - b.w);
  }
}

__device__ __forceinline__ void store_a(unsigned short* as, const uint32_t (&pk)[8]) {
  uint4* dst = reinterpret_cast<uint4*>(as + (threadIdx.x >> 1) * kStride + (threadIdx.x & 1) * 16);
  dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
}

// The [kBN, kBK] slice of W_enc^T: 512 16-byte pieces, two a thread;
// features past h are zeros.
__device__ __forceinline__ void load_b(const GemmArgs& a, int n0, int k0, unsigned short* bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + i * kThreads;
    const int r = id >> 2, seg = (id & 3) * 8;
    const bool ok = n0 + r < a.h;
    const unsigned short* src = ok ? a.w_enc_t + (size_t)(n0 + r) * a.d + k0 + seg : a.w_enc_t;
    cp_async16(bs + r * kStride + seg, src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads) encode_gemm_kernel(GemmArgs a) {
  __shared__ __align__(16) unsigned short As[2][kBM * kStride];
  __shared__ __align__(16) unsigned short Bs[2][kBN * kStride];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt_n = a.d / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  uint32_t pk[8];
  load_a(a, m0, 0, pk);
  store_a(As[0], pk);
  load_b(a, n0, 0, Bs[0]);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < kt_n;
    if (next) {  // the next slice is in flight while this one is multiplied
      load_b(a, n0, (kt + 1) * kBK, Bs[cur ^ 1]);
      cp_async_commit();
      load_a(a, m0, (kt + 1) * kBK, pk);
    }
    const unsigned short* as = As[cur];
    const unsigned short* bs = Bs[cur];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned short* p = as + (wm + mt * 16 + fr) * kStride + ks + fc;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned short* p = bs + (wn + nt * 8 + fr) * kStride + ks + fc;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], bf[nt][0], bf[nt][1]);
    }
    if (next) store_a(As[cur ^ 1], pk);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: + b_enc, monotone int, two adjacent features per store
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + fc;
    if (col >= a.h) continue;  // h is even: col + 1 < h too
    const float be0 = a.b_enc[col], be1 = a.b_enc[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + fr + 8 * half;
        if (row >= a.rows) continue;
        *reinterpret_cast<int2*>(a.ws + (size_t)row * a.h + col) =
            make_int2(monotone_int(acc[mt][nt][2 * half] + be0),
                      monotone_int(acc[mt][nt][2 * half + 1] + be1));
      }
    }
  }
}

// One CTA per row of the chunk: the row's monotone ints into registers
// once, the exact threshold, the latent written once.
template <int N, bool F32_OUT>
__global__ void __launch_bounds__(kWideThreads, 1) blocked_select_kernel(const int* ws, int h,
                                                                         int k, void* out,
                                                                         long long row0) {
  __shared__ int warp_cnt[2][kWideWarps];
  int xi[N];
  load_wide_ints(ws + (size_t)blockIdx.x * h, h, xi);
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

// Rows a workspace must hold: min(rows, this).
int wst_blocked_chunk_rows() { return wst::blocked::kChunkRows; }

// The blocked encode over all rows, chunk by chunk: for each chunk the
// product into ws ([min(rows, chunk), h] int32), then the selection into
// out ([rows, h], bf16 or f32 when out_f32).  d % 32 == 0, h even and
// h <= wst_max_wide_row_width(), checked by the caller.
int wst_blocked_encode_fwd(const void* x, int x_bf16, int rows, int d, int h, int k,
                           const void* w_enc_t, const void* b_enc, const void* b_pre, void* out,
                           int out_f32, void* ws, void* stream) {
  namespace B = wst::blocked;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int row0 = 0; row0 < rows; row0 += B::kChunkRows) {
    const int n = rows - row0 < B::kChunkRows ? rows - row0 : B::kChunkRows;
    B::GemmArgs a{x, x_bf16, row0, n, d, h,
                  static_cast<const unsigned short*>(w_enc_t),
                  static_cast<const float*>(b_enc),
                  static_cast<const float*>(b_pre),
                  static_cast<int*>(ws)};
    const dim3 grid((h + B::kBN - 1) / B::kBN, (n + B::kBM - 1) / B::kBM);
    B::encode_gemm_kernel<<<grid, B::kThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int* wsp = static_cast<const int*>(ws);
#define WST_LAUNCH_SELECT(N)                                                              \
  if (out_f32) {                                                                          \
    B::blocked_select_kernel<N, true><<<n, wst::kWideThreads, 0, s>>>(wsp, h, k, out, row0); \
  } else {                                                                                \
    B::blocked_select_kernel<N, false><<<n, wst::kWideThreads, 0, s>>>(wsp, h, k, out, row0); \
  }
    WST_WIDE_DISPATCH(h, WST_LAUNCH_SELECT)
#undef WST_LAUNCH_SELECT
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
