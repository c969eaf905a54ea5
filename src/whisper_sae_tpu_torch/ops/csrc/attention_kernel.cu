// The attention core of the Whisper encoder on Hopper: softmax(q k^T) v per
// head, written for sm_90a (wgmma, TMA, mbarriers).
//
// attention_kernel ("attention_fwd")
//   replaces the core of whisper_sae_tpu/ops/pallas_encoder.py:
//   _attention_block_kernel / _attention_block_kernel_tiled
//   (fused_attention_block, pallas_call at :340), launched between the
//   LN+QKV and out-projection GEMMs of ops/csrc/encoder_gemm.cu, and the
//   library flash attention of models/whisper.py:_flash_self_attention
//   (:141) on the composed route.  Its mbarrier, TMA, descriptor and wgmma
//   helpers are in ops/csrc/hopper_common.cuh.
//
// Semantics (unchanged from the mma.sync kernel it replaces): q arrives
// scaled; key columns >= t_real get exactly zero weight; query rows
// t_real .. t-1 are computed like any other; the numerator is bf16(p) @ v
// over the f32 sum of p; the output is rounded once to bf16.  No atomics,
// so two launches give the same bits.
//
// Bounds at whisper-tiny, 64 clips (T=1500, 6 heads of 64): the two
// products are 4*T^2*64 per head and clip = 221 GFLOP (0.224 ms at 989
// TFLOP/s), the softmax 864 M exponentials (0.207 ms at 4.18e12 exp/s on
// the special-function units).  Two bounds of one size: a kernel that runs
// them one after the other cannot go below ~0.43 ms.
//
// What the design does about it:
// - Both products are wgmma.mma_async (m64n64k16, bf16 in, f32 sums): S =
//   Q K^T with Q and the K tile in shared memory (both K-major), O += P V
//   with P from registers (the S accumulators, rounded to bf16, are the A
//   fragments as they lie) and the V tile MN-major (the transpose bit).
// - One CTA is three consumer warpgroups of 64 queries each that share
//   every K/V tile, plus one producer warp.  The producer feeds the 64-key
//   K and V tiles by TMA into a ring of four stages (full/empty
//   mbarriers), from 3-D [B, T, D] tensor maps with 128-byte swizzle: a
//   box never crosses a clip, and keys past T load as zeros.
// - The softmax is exp2 with log2(e) folded into one FFMA (ex2.approx).
//   A warpgroup issues tile it+1's S product and tile it's PV product
//   back to back, waits, and runs tile it+1's softmax; the three
//   warpgroups drift apart, so the special-function units work on one's
//   softmax while the tensor cores work on another's products.  An
//   explicit ping-pong (named barriers) was slower on the card, and so
//   was the softmax under its own warpgroup's PV product while ptxas
//   serialised that loop's wgmmas.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper_common.cuh"

namespace wst_attn {

using namespace wst_hopper;

typedef unsigned short bf16_t;

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;     // queries of one consumer warpgroup
constexpr int kConsumers = 3;   // consumer warpgroups a CTA
constexpr int kBlockK = 64;     // keys a tile
constexpr int kStages = 4;      // K/V ring depth
constexpr uint32_t kTileBytes = kBlockK * kHeadDim * sizeof(bf16_t);  // 8 KB, one swizzle span a row
constexpr float kMaskedScore = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Every tile is 1024-byte aligned (the 128-byte swizzle repeats every 8 rows).
template <int NC>
struct __align__(1024) Smem {
  bf16_t q[NC][kBlockQ * kHeadDim];
  bf16_t k[kStages][kBlockK * kHeadDim];
  bf16_t v[kStages][kBlockK * kHeadDim];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};

#define WST_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WST_D32_OUT(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WST_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WST_D32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WST_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WST_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One CTA: kConsumers x 64 queries of one head of one clip.  Warpgroups
// 0 .. kConsumers-1 consume, the warp after them produces.  Accumulator
// layout (wgmma m64nN, f32): thread (warp w of the warpgroup, lane l)
// holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) + {0, 1} in
// d[4j + {0, 1}] and d[4j + {2, 3}] -- the mma.sync m16n8 C layout, one
// n8 tile per j.
//
// The loop, per key tile ``it`` of a warpgroup (P(it) already in
// registers): rescale O, issue S(it+1) = Q K(it+1)^T and O += P(it)
// V(it), wait for both, then run tile it+1's softmax while the other
// warpgroups' products run.  Nothing touches an accumulator or a P
// fragment between an issue and its wait: ptxas serialises the wgmmas
// otherwise.
template <int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1) attention_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, int t, int t_real, int d, bf16_t* out) {
  extern __shared__ unsigned char smem_raw[];
  Smem<NC>& s = *reinterpret_cast<Smem<NC>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int head = blockIdx.y, clip = blockIdx.z;
  const int col = head * kHeadDim;
  const int q0 = blockIdx.x * NC * kBlockQ;
  const int tiles = (t_real + kBlockK - 1) / kBlockK;  // tiles of masked keys only are skipped

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], NC * 4);  // lane 0 of every consumer warp
    }
    mbar_init(&s.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {  // the producer warp
    if (tid == NC * 128) {
      mbar_expect_tx(&s.q_full, NC * kTileBytes);
      for (int w = 0; w < NC; ++w)
        tma_load_3d(s.q[w], &map_q, &s.q_full, col, q0 + w * kBlockQ, clip);
      for (int it = 0; it < tiles; ++it) {
        const int st = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(&s.empty[st], (round - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kTileBytes);
        tma_load_3d(s.k[st], &map_k, &s.full[st], col, it * kBlockK, clip);
        tma_load_3d(s.v[st], &map_v, &s.full[st], col, it * kBlockK, clip);
      }
    }
    return;
  }

  const int lane = tid & 31, warp = (tid / 32) & 3;
  const int fr = lane >> 2, fc = (lane & 3) * 2;
  const int r0 = q0 + wg * kBlockQ + warp * 16 + fr, r1 = r0 + 8;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(&s.q_full, 0);
  const uint64_t dq = desc_k_major(s.q[wg]);

  // S = Q K^T for tile ``it``: four k16 steps along the head dim, 32 bytes
  // apart, issued and committed as one group (not waited for)
  auto issue_s = [&](float (&sv)[32], int it) {
    const int st = it % kStages;
    mbar_wait(&s.full[st], (it / kStages) & 1);
    const uint64_t dk = desc_k_major(s.k[st]);
    fence_acc(sv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) wgmma_ss(sv, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    fence_acc(sv);
  };
  // tile ``it``'s online softmax on its scores ``sv``: the row maxima and
  // sums move on, ``p`` gets bf16(P) as the PV product's A fragments (the
  // accumulators of key columns 16u .. 16u+15 are k-step u's fragment as
  // they lie), ``a0``/``a1`` the factors that rescale O
  auto softmax = [&](float (&sv)[32], int it, uint32_t (&p)[kBlockK / 16][4], float& a0,
                     float& a1) {
    const int kt = it * kBlockK;
    if (kt + kBlockK > t_real) {  // the last tile: keys >= t_real get -1e30
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const int key = kt + j * 8 + fc;
        if (key >= t_real) sv[4 * j] = sv[4 * j + 2] = kMaskedScore;
        if (key + 1 >= t_real) sv[4 * j + 1] = sv[4 * j + 3] = kMaskedScore;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sv[4 * j], sv[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sv[4 * j + 2], sv[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // exp(x - m) = 2^(x log2e - m log2e): one FFMA and one ex2 a score
    const float nb0 = -mn0 * kLog2e, nb1 = -mn1 * kLog2e;
    a0 = ex2(fmaf(m0, kLog2e, nb0));
    a1 = ex2(fmaf(m1, kLog2e, nb1));
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      sv[4 * j] = ex2(fmaf(sv[4 * j], kLog2e, nb0));
      sv[4 * j + 1] = ex2(fmaf(sv[4 * j + 1], kLog2e, nb0));
      sv[4 * j + 2] = ex2(fmaf(sv[4 * j + 2], kLog2e, nb1));
      sv[4 * j + 3] = ex2(fmaf(sv[4 * j + 3], kLog2e, nb1));
      ps0 += sv[4 * j] + sv[4 * j + 1];
      ps1 += sv[4 * j + 2] + sv[4 * j + 3];
    }
    // each lane keeps its part of the row sums; one reduction at the end
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int u = 0; u < kBlockK / 16; ++u) {
      p[u][0] = pack2(sv[8 * u], sv[8 * u + 1]);
      p[u][1] = pack2(sv[8 * u + 2], sv[8 * u + 3]);
      p[u][2] = pack2(sv[8 * u + 4], sv[8 * u + 5]);
      p[u][3] = pack2(sv[8 * u + 6], sv[8 * u + 7]);
    }
  };
  // this warp is done with tile ``it``'s K and V
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[it % kStages]);
  };

  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  uint32_t pa[kBlockK / 16][4];
  float al0, al1;
  issue_s(sc, 0);
  wgmma_wait<0>();
  fence_acc(sc);
  softmax(sc, 0, pa, al0, al1);
  // one key tile; ``next`` is a constant at both call sites, so no
  // product is issued under a branch
  auto step = [&](int it, bool next) {
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    if (next) issue_s(sc, it + 1);
    // O += bf16(P) V: V's k-step u is 16 rows (2 KB) further on
    const uint64_t dv = desc_mn_major(s.v[it % kStages]);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kBlockK / 16; ++u) wgmma_rs(o, pa[u], dv + (uint64_t)((u * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    release(it);
    if (next) {
      fence_acc(sc);
      softmax(sc, it + 1, pa, al0, al1);
    }
  };
  for (int it = 0; it + 1 < tiles; ++it) step(it, true);
  step(tiles - 1, false);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const size_t base = (size_t)clip * t * d + col;
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    const int c = j * 8 + fc;
    if (r0 < t)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * d + c) =
          pack2(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (r1 < t)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * d + c) =
          pack2(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
}

// [b, t, d] bf16 as a 3-D map (innermost first: d, t, b), boxes of
// 64 columns x 64 rows x 1 clip, 128-byte swizzle, zeros out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int b, int t, int d) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(bf16_t), (cuuint64_t)t * d * sizeof(bf16_t)};
  const cuuint32_t box[3] = {kHeadDim, kBlockK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NC>
int launch_attention(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, int b,
                     int t, int t_real, int d, int n_heads, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<NC>) + 1024;  // + room to align the base to 1024
  int err = (int)cudaFuncSetAttribute(attention_kernel<NC>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((t + NC * kBlockQ - 1) / (NC * kBlockQ), n_heads, b);
  attention_kernel<NC><<<grid, NC * 128 + 32, smem, stream>>>(
      mq, mk, mv, t, t_real, d, static_cast<bf16_t*>(out));
  return (int)cudaGetLastError();
}

// The three tensor maps of q, k, v, then ``launch``.
template <typename L>
int with_maps(const void* q, const void* k, const void* v, int b, int t, int d, int n_heads,
              L launch) {
  if (b <= 0 || t <= 0) return 0;
  if (d != n_heads * kHeadDim || d % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, b, t, d);
  if (!err) err = make_map(&mk, k, b, t, d);
  if (!err) err = make_map(&mv, v, b, t, d);
  return err ? err : launch(mq, mk, mv);
}

}  // namespace wst_attn

extern "C" {

int wst_attention_fwd(const void* q, const void* k, const void* v, int b, int t, int t_real,
                      int d, int n_heads, void* out, void* stream) {
  using namespace wst_attn;
  return with_maps(q, k, v, b, t, d, n_heads, [&](const CUtensorMap& mq, const CUtensorMap& mk,
                                                  const CUtensorMap& mv) {
    return launch_attention<kConsumers>(
        mq, mk, mv, b, t, t_real, d, n_heads, out, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
