// Hand-written Hopper backward of the TopK-SAE training step over the
// selected latents: one C entry, wst_sae_topk_bwd.
//
// It replaces no Pallas kernel.  The JAX package's custom VJPs
// (ops/pallas_sae.py: _fused_loss_vjp_bwd :321-353,
// _fused_loss_indexed_vjp_bwd :490-517, _bwd :123-143) leave these
// products to XLA as dense [B, H] matmuls; the port ran them as dense
// f32 products of bf16 operands (utils/device.mm_f32: cuBLAS SIMT FFMA,
// 59-76% of a training step).  But the latent is sparse -- k of H entries
// a row are positive (32 of 3072 at whisper-tiny 8x, 32 of 40960 at
// whisper-large 32x) -- and the gradient reaches only those: every other
// product term is an exact zero.  So, for the entries (b, f) with
// hid[b, f] > 0,
//   dpre[b, f]   = d_recon[b, :] . W_dec[f, :]            (f32 sums)
//   dW_dec[f, :] = sum_b hid[b, f] * d_recon[b, :]
//   dW_enc[:, f] = sum_b xc[b, :] * bf16(dpre[b, f])
//   db_enc[f]    = sum_b dpre[b, f]   (of bf16(dpre) on the composed route)
// with the f32 products and bf16 roundings of the dense route, sums in
// another (fixed) order.  The rounding points are the calling route's,
// a template parameter:
//   kernel A's route (ops/cuda_sae.py: _FusedLoss): d_recon in bf16 for
//     both products, dpre rounded to bf16 before the dW_enc product only;
//   the composed route (_ComposedLoss, autograd through mm_f32 before):
//     d_recon in f32, dpre rounded to bf16 for db_enc and dW_enc alike
//     (the latent's gradient is bf16), dW_dec rounded to bf16 after its
//     f32 sum and widened back (W_dec enters the product as bf16).
//
// Bound on the H100 (3.35 TB/s, 67 T/s f32): it must read the bf16 latent
// once (B*H*2 bytes), d_recon, xc and W_dec once, and write dW_enc and
// dW_dec in f32 (2*H*D*4): 263 MB at whisper-tiny 8x's step (B = 32768,
// D = 384, H = 3072; 0.079 ms) and 1.26 GB at whisper-large 32x's (B =
// 8192, D = 1280, H = 40960; 0.376 ms).  Its arithmetic, 6*B*k*D FLOPs
// (2.4 and 2.0 GFLOP), takes 0.04 ms: it is bound by bytes.
//
// The design, in launches on one stream, no host synchronisation and no
// float atomics (the gradients have the same bits from run to run):
//  1. mask_kernel: one warp a row reads the latent once, in 16-byte
//     loads, and sets bit b%32 of word b/32 of its feature's row mask
//     (integer atomicOr on an [H, ceil(B/128)*4] bit matrix, zeroed
//     first).  This is the compaction: a feature's entries are its set
//     bits, rows ascending -- the feature-major order, stable, with no
//     sort and no entry list, whose size ties at the k-th value leave
//     unbounded.
//  2. count_kernel: one warp a feature counts its bits.
//  3. plan_kernel (one CTA): the entry count E, the segment length S =
//     max(kMinSeg, E / kSlots) rounded up to 32 (512 at whisper-tiny 8x,
//     128 at whisper-large 32x), and for each feature with more than S
//     entries one scratch slot a segment past its first (at most kSlots
//     in all): a hot feature is cut into fixed segments, so that it does
//     not serialise the grid.
//  4. seg_kernel (persistent): each extra segment's partial sums, to its
//     slot of an f32 scratch.
//  5. tile_kernel: a CTA a tile of adjacent features (eight at P = 1,
//     four at P = 2); each feature's first segment, then its extra
//     segments' partials added in segment order; dW_dec's row and db_enc
//     from registers, dW_enc's [D x features] tile staged in shared
//     memory so that the stores along H are row runs of 16 or 32 bytes.
//     Features no row selected get their zeros here.
// In 4 and 5 a feature's segment is walked by a group of P warps, each
// over a slice of D (ceil(D/128) four-column groups, up to kMaxGroups a
// lane: P = 1 at D = 384, 2 at D = 1280).  The mask words come in blocks
// of 128, the next block's load in flight; their set bits are handed out
// a lane an entry into batches of 32, each in sub-batches of kSub = 8:
// loop 1 loads its rows of d_recon (8 or 16 bytes a lane a group, a
// load group's loads issued before any is used), adds each dot's
// products over the lane's columns and h * d_recon into dW_dec's sums;
// a transposed butterfly leaves each dot's warp total in four lanes (9
// shuffles for 8 dots), and the P warps' totals are added in warp order
// through shared memory; loop 2 loads the xc rows into dW_enc's sums.
// The rows are gathered E times (E*D*(2+2) bytes, or (4+2) with f32
// d_recon: 1.6 GB at whisper-tiny 8x, mostly L2 hits, as d_recon and xc
// there are 50 MB; 2.0 GB at whisper-large 32x, where they are 63 MB):
// that gather, not the bound, is the design's floor.  W_dec's rows, the
// mask and the gradients are read or written once and bypass L2's
// retention (__ldcs, __stcs), which keeps the gathered rows there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wst_bwd {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCtaWarps = 8;
constexpr int kCtaThreads = kCtaWarps * kWarp;
constexpr int kMaxGroups = 5;     // four-column groups a lane: 640 columns a warp
constexpr int kMaxWarpsD = 4;     // warps a feature at most (P): D <= 2560
constexpr int kMaxD = kMaxWarpsD * kMaxGroups * 4 * kWarp;
constexpr int kBatch = kWarp;     // entries a batch: one a lane
constexpr int kSub = 8;           // entries whose rows are read together
constexpr int kMinSeg = 64;       // a segment's entries at least
constexpr int kSlots = 2048;      // extra segments at most (the scratch's slots)
constexpr int kPlanThreads = 1024;

struct Args {
  const unsigned short* hid;  // [rows, h] bf16
  const void* d_recon;        // [rows, d] bf16 (kernel A's route) or f32 (composed)
  const unsigned short* xc;   // [rows, d] bf16
  const unsigned short* w_dec;  // [h, d] bf16
  int d, h;
  int nbp;                    // mask words a feature: ceil(rows / 32), padded to 4
  int p;                      // warps a feature
  const uint32_t* mask;       // [h, nbp]
  const int* cnt;             // [h] entries a feature
  const int* slot_base;       // [h] a feature's first extra slot
  const int* unit_f;          // [kSlots] the feature of each extra slot
  const int* params;          // S, L
  float* scratch;             // [kSlots, 2*d + 4]: dW_dec sums, dW_enc sums, db_enc sum
  float* dw_enc;              // [d, h]
  float* db_enc;              // [h]
  float* dw_dec;              // [h, d]
};

__device__ __forceinline__ float bf16f(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The n-th (0-based) set bit of w.
__device__ __forceinline__ int nth_bit(uint32_t w, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s; s >>= 1) {
    const int c = __popc(w & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      w >>= s;
      pos += s;
    }
  }
  return pos;
}

// A four-column group of a row as loaded: f32 in 16 bytes, bf16 in 8.
template <bool kF32>
using Raw = std::conditional_t<kF32, uint4, uint2>;

template <bool kF32>
__device__ __forceinline__ Raw<kF32> load_raw(const void* base, size_t off) {
  if constexpr (kF32) {
    return *reinterpret_cast<const uint4*>(static_cast<const float*>(base) + off);
  } else {
    return *reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(base) + off);
  }
}

// The group's four values in f32 (bf16 widened exactly).
__device__ __forceinline__ void widen(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x), v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z), v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint2& r, float (&v)[4]) {
  v[0] = bf16f(r.x & 0xffffu), v[1] = bf16f(r.x >> 16);
  v[2] = bf16f(r.y & 0xffffu), v[3] = bf16f(r.y >> 16);
}

// Entries of a sub-batch whose groups are loaded before any is used: as
// many as keep the loaded words within 64 registers a thread.
template <int NG, bool kF32>
__host__ __device__ constexpr int load_group() {
  constexpr int words = NG * (kF32 ? 4 : 2);
  return words * 8 <= 64 ? 8 : words * 4 <= 64 ? 4 : words * 2 <= 64 ? 2 : 1;
}

// Column of four-column group i of warp q's slice, for this lane.
template <int NG>
__device__ __forceinline__ int group_col(int q, int i, int lane) {
  return 4 * ((q * NG + i) * kWarp + lane);
}

// Lane l's v[u] (u < kSub) summed over the warp's lanes, total u left in
// lanes 4u..4u+3: three transposed butterfly stages, each halving the
// values a lane keeps, then two plain ones (9 shuffles for 8 sums).
__device__ __forceinline__ float sub_batch_sum(float (&v)[kSub], int lane) {
#pragma unroll
  for (int s = kSub / 2; s >= 1; s >>= 1) {
    const bool up = lane & (4 * s);
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = up ? v[i] : v[i + s];
      const float keep = up ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, 4 * s);
    }
  }
  float t = v[0];
  t += __shfl_xor_sync(kFull, t, 2);
  t += __shfl_xor_sync(kFull, t, 1);
  return t;
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The group's warps meet: a named barrier for P > 1 warps, else the warp.
__device__ __forceinline__ void group_meet(const Args& a, int gbar) {
  if (a.p > 1) {
    group_sync(gbar, a.p * kWarp);
  } else {
    __syncwarp();
  }
}

// One feature's sums over a segment, held by a group of P warps: warp q
// owns four-column groups q*NG*32 + i*32 + lane (i < NG) of D.
template <int NG, bool kComposed>
struct Sums {
  float dec[NG][4];
  float enc[NG][4];
  float db;  // the same in every lane
};

// A batch of n <= 32 entries of feature f, lane j holding entry j's row, in
// sub-batches of kSub.  Loop 1: each dot's partial sum over this warp's
// columns, and h * d_recon into dW_dec's sums; the dots' warp totals go to
// the group's exchange (xch [P][32] floats), added over the group's warps
// in warp order.  Loop 2: bf16(dpre) * xc into dW_enc's sums, dpre (or its
// bf16 rounding) into db_enc's.  Each loop issues the loads of
// load_group() entries (predicated on the entry) before using any, so
// that they are in flight together.
template <int NG, bool kComposed>
__device__ __forceinline__ void process_batch(const Args& a, int f, int q, int lane, int gbar,
                                              float* xch, const uint2 (&w)[NG], int my_row,
                                              int n, Sums<NG, kComposed>& s) {
  constexpr int kL1 = load_group<NG, kComposed>(), kL2 = load_group<NG, false>();
  const float my_h = lane < n ? bf16f(a.hid[(size_t)my_row * a.h + f]) : 0.0f;
#pragma unroll 1
  for (int t = 0; t * kSub < n; ++t) {
    float part[kSub];
#pragma unroll
    for (int u0 = 0; u0 < kSub; u0 += kL1) {
      Raw<kComposed> raw[kL1][NG];
#pragma unroll
      for (int u = 0; u < kL1; ++u) {
        const int j = t * kSub + u0 + u;
        const int row = __shfl_sync(kFull, my_row, j);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int c = group_col<NG>(q, i, lane);
          raw[u][i] = c < a.d && j < n ? load_raw<kComposed>(a.d_recon, (size_t)row * a.d + c)
                                       : Raw<kComposed>{};
        }
      }
#pragma unroll
      for (int u = 0; u < kL1; ++u) {
        const int j = t * kSub + u0 + u;
        const float hj = __shfl_sync(kFull, my_h, j);
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          float v[4];
          widen(raw[u][i], v);
          const float wv[4] = {bf16f(w[i].x & 0xffffu), bf16f(w[i].x >> 16),
                               bf16f(w[i].y & 0xffffu), bf16f(w[i].y >> 16)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc = fmaf(v[e], wv[e], acc);
            if (j < n) s.dec[i][e] = fmaf(hj, v[e], s.dec[i][e]);
          }
        }
        part[u0 + u] = acc;
      }
    }
    const float tot = sub_batch_sum(part, lane);
    if ((lane & 3) == 0) xch[q * kBatch + t * kSub + lane / 4] = tot;
  }
  group_meet(a, gbar);
#pragma unroll 1
  for (int t = 0; t * kSub < n; ++t) {
#pragma unroll
    for (int u0 = 0; u0 < kSub; u0 += kL2) {
      Raw<false> raw[kL2][NG];
#pragma unroll
      for (int u = 0; u < kL2; ++u) {
        const int j = t * kSub + u0 + u;
        const int row = __shfl_sync(kFull, my_row, j);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int c = group_col<NG>(q, i, lane);
          raw[u][i] = c < a.d && j < n ? load_raw<false>(a.xc, (size_t)row * a.d + c) : uint2{};
        }
      }
#pragma unroll
      for (int u = 0; u < kL2; ++u) {
        const int j = t * kSub + u0 + u;
        float p = xch[j];
        for (int r = 1; r < a.p; ++r) p += xch[r * kBatch + j];
        const float p_enc = bf16r(p);
        if (j < n) s.db += kComposed ? p_enc : p;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          float v[4];
          widen(raw[u][i], v);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j < n) s.enc[i][e] = fmaf(v[e], p_enc, s.enc[i][e]);
        }
      }
    }
  }
  group_meet(a, gbar);  // the exchange is read before the next batch writes it
}

// 128 mask words from word c0 on, four a lane (zero past the row's nbp).
__device__ __forceinline__ uint4 load_words(const uint32_t* m, int nbp, int c0, int lane) {
  const int w0 = c0 + 4 * lane;
  return w0 < nbp ? __ldcs(reinterpret_cast<const uint4*>(m + w0)) : make_uint4(0u, 0u, 0u, 0u);
}

// The sums of feature f over its entries [e_lo, e_hi) (rows ascending),
// from zero: the feature's mask words in blocks of 128 (four a lane, the
// next block's load in flight while this one's entries are handed out),
// the entries a lane a row into batches of 32.
template <int NG, bool kComposed>
__device__ __forceinline__ void walk(const Args& a, int f, int e_lo, int e_hi, int q, int lane,
                                     int gbar, float* xch, Sums<NG, kComposed>& s) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s.dec[i][e] = s.enc[i][e] = 0.0f;
  s.db = 0.0f;
  if (e_lo >= e_hi) return;
  uint2 w[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = group_col<NG>(q, i, lane);
    w[i] = c < a.d ? __ldcs(reinterpret_cast<const uint2*>(a.w_dec + (size_t)f * a.d + c))
                   : make_uint2(0u, 0u);
  }
  const uint32_t* m = a.mask + (size_t)f * a.nbp;
  constexpr int kBlock = 4 * kWarp;
  uint4 next = load_words(m, a.nbp, 0, lane);
  int base = 0, nbat = 0, my_row = 0;
  for (int c0 = 0; c0 < a.nbp && base < e_hi; c0 += kBlock) {
    const uint4 wd = next;
    next = load_words(m, a.nbp, c0 + kBlock, lane);
    const int cw = __popc(wd.x) + __popc(wd.y) + __popc(wd.z) + __popc(wd.w);
    int incl = cw;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int tot = __shfl_sync(kFull, incl, kWarp - 1);
    int q0 = e_lo - base > 0 ? e_lo - base : 0;
    const int q1 = e_hi - base < tot ? e_hi - base : tot;
    while (q0 < q1) {
      const int take = kBatch - nbat < q1 - q0 ? kBatch - nbat : q1 - q0;
      const int local = q0 + lane - nbat;  // this lane's entry of the block
      int own = 0;                         // its lane: the lanes whose words end at or before it
#pragma unroll
      for (int st = kWarp / 2; st; st >>= 1) {
        const int v = __shfl_sync(kFull, incl, own + st - 1);
        if (v <= local) own += st;
      }
      const uint32_t ox = __shfl_sync(kFull, wd.x, own), oy = __shfl_sync(kFull, wd.y, own);
      const uint32_t oz = __shfl_sync(kFull, wd.z, own), ow = __shfl_sync(kFull, wd.w, own);
      int r = local - __shfl_sync(kFull, incl - cw, own), k = 0;
      uint32_t word = ox;
      if (r >= __popc(ox)) {
        r -= __popc(ox), k = 1, word = oy;
        if (r >= __popc(oy)) {
          r -= __popc(oy), k = 2, word = oz;
          if (r >= __popc(oz)) r -= __popc(oz), k = 3, word = ow;
        }
      }
      if (lane >= nbat && lane < nbat + take)
        my_row = (c0 + 4 * own + k) * kWarp + nth_bit(word, r);
      nbat += take;
      q0 += take;
      if (nbat == kBatch) {
        process_batch<NG, kComposed>(a, f, q, lane, gbar, xch, w, my_row, nbat, s);
        nbat = 0;
      }
    }
    base += tot;
  }
  if (nbat) process_batch<NG, kComposed>(a, f, q, lane, gbar, xch, w, my_row, nbat, s);
}

constexpr int kMaskUnroll = 4;

__global__ void __launch_bounds__(kCtaThreads) mask_kernel(const unsigned short* hid, int rows,
                                                           int h, int nbp, uint32_t* mask) {
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kCtaWarps + threadIdx.x / kWarp;
  if (b >= rows) return;
  const uint4* row = reinterpret_cast<const uint4*>(hid + (size_t)b * h);
  const uint32_t bit = 1u << (b % kWarp);
  uint32_t* col = mask + b / kWarp;
  const int nv = h / 8;
  for (int v0 = lane; v0 < nv; v0 += kMaskUnroll * kWarp) {
    uint4 qv[kMaskUnroll];
#pragma unroll
    for (int r = 0; r < kMaskUnroll; ++r) {
      const int v = v0 + r * kWarp;
      qv[r] = v < nv ? row[v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < kMaskUnroll; ++r) {
      const uint32_t u[4] = {qv[r].x, qv[r].y, qv[r].z, qv[r].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // > 0: +0 and the sign bit set fail, as do NaNs (above 0x7f80, +inf)
        const uint32_t e = (u[i / 2] >> (16 * (i % 2))) & 0xffffu;
        if (e - 1u < 0x7f80u)
          atomicOr(col + (size_t)(8 * (v0 + r * kWarp) + i) * nbp, bit);
      }
    }
  }
}

__global__ void __launch_bounds__(kCtaThreads) count_kernel(const uint32_t* mask, int h, int nbp,
                                                            int* cnt) {
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.x * kCtaWarps + threadIdx.x / kWarp;
  if (f >= h) return;
  int c = 0;
  for (int j = 4 * lane; j < nbp; j += 4 * kWarp) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + (size_t)f * nbp + j);
    c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) cnt[f] = c;
}

__device__ __forceinline__ int extra_segments(int n, int s) { return n > s ? (n - 1) / s : 0; }

// Features a tile CTA of kCtaWarps warps: eight at P = 1, four at P = 2
// (a wider tile of 16 warps is slower there: the CTA waits longer for its
// slowest feature).
__host__ __device__ __forceinline__ int tile_features(int p) { return kCtaWarps / p; }

// A scratch slot: dW_dec's d sums, dW_enc's d sums, db_enc's sum, padded
// to a multiple of four floats (16-byte stores).
__host__ __device__ __forceinline__ size_t slot_floats(int d) { return 2 * (size_t)d + 4; }

// Thread t owns features t, t + kPlanThreads, ... (loads along H); its
// features' extra segments take consecutive slots from the exclusive scan
// of the threads' counts: a fixed assignment, whatever the schedule.
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(const int* cnt, int h, int* slot_base,
                                                            int* unit_f, int* params) {
  __shared__ long long sum_w[kPlanThreads / kWarp];
  __shared__ int scan_w[kPlanThreads / kWarp];
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  long long e = 0;
  for (int f = t; f < h; f += kPlanThreads) e += cnt[f];
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
  if (lane == 0) sum_w[warp] = e;
  __syncthreads();
  long long total = 0;
  for (int i = 0; i < kPlanThreads / kWarp; ++i) total += sum_w[i];
  long long sl = (total + kSlots - 1) / kSlots;
  sl = sl < kMinSeg ? kMinSeg : (sl + kWarp - 1) / kWarp * kWarp;
  const int s = (int)sl;
  int x = 0;
  for (int f = t; f < h; f += kPlanThreads) x += extra_segments(cnt[f], s);
  int incl = x;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == kWarp - 1) scan_w[warp] = incl;
  __syncthreads();
  int base = incl - x, all = 0;
  for (int i = 0; i < kPlanThreads / kWarp; ++i) {
    if (i < warp) base += scan_w[i];
    all += scan_w[i];
  }
  for (int f = t; f < h; f += kPlanThreads) {
    const int ex = extra_segments(cnt[f], s);
    slot_base[f] = base;
    for (int i = 0; i < ex; ++i) unit_f[base + i] = f;
    base += ex;
  }
  if (t == 0) {
    params[0] = s;
    params[1] = all;  // <= kSlots: (n - 1) / s < n / s, summed, < E / s <= kSlots
  }
}

template <int NG, bool kComposed>
__global__ void __launch_bounds__(kCtaThreads, 2) seg_kernel(Args a) {
  __shared__ float xch[kCtaWarps * kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int groups = kCtaWarps / a.p, g = warp / a.p, q = warp % a.p;
  const int s = a.params[0], units = a.params[1];
  const size_t stride = slot_floats(a.d);
  for (int u = blockIdx.x * groups + g; u < units; u += gridDim.x * groups) {
    const int f = a.unit_f[u];
    const int e_lo = (u - a.slot_base[f] + 1) * s;
    const int e_hi = e_lo + s < a.cnt[f] ? e_lo + s : a.cnt[f];
    Sums<NG, kComposed> sm;
    walk<NG, kComposed>(a, f, e_lo, e_hi, q, lane, 1 + g, xch + g * a.p * kWarp, sm);
    float* out = a.scratch + u * stride;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = group_col<NG>(q, i, lane);
      if (c < a.d) {
        *reinterpret_cast<float4*>(out + c) =
            make_float4(sm.dec[i][0], sm.dec[i][1], sm.dec[i][2], sm.dec[i][3]);
        *reinterpret_cast<float4*>(out + a.d + c) =
            make_float4(sm.enc[i][0], sm.enc[i][1], sm.enc[i][2], sm.enc[i][3]);
      }
    }
    if (q == 0 && lane == 0) out[2 * a.d] = sm.db;
  }
}

// A CTA a tile of tile_features(P) adjacent features, P warps each.
// Shared memory: the groups' exchange (32 floats a warp), then dW_enc's
// tile [d][F + 1].
template <int NG, bool kComposed>
__global__ void __launch_bounds__(kCtaThreads, 2) tile_kernel(Args a) {
  extern __shared__ float smem[];
  float* xch = smem;
  float* enc = smem + blockDim.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nf = tile_features(a.p), g = warp / a.p, q = warp % a.p;
  const int f0 = blockIdx.x * nf, f = f0 + g;
  const int s = a.params[0], n = a.cnt[f];
  Sums<NG, kComposed> sm;
  walk<NG, kComposed>(a, f, 0, n < s ? n : s, q, lane, 1 + g, xch + g * a.p * kWarp, sm);
  const int ex = extra_segments(n, s);
  const size_t stride = slot_floats(a.d);
  for (int k = 0; k < ex; ++k) {  // the extra segments' partials, in segment order
    const float* in = a.scratch + (a.slot_base[f] + k) * stride;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = group_col<NG>(q, i, lane);
      if (c < a.d) {
        const float4 dv = *reinterpret_cast<const float4*>(in + c);
        const float4 ev = *reinterpret_cast<const float4*>(in + a.d + c);
        sm.dec[i][0] += dv.x, sm.dec[i][1] += dv.y, sm.dec[i][2] += dv.z, sm.dec[i][3] += dv.w;
        sm.enc[i][0] += ev.x, sm.enc[i][1] += ev.y, sm.enc[i][2] += ev.z, sm.enc[i][3] += ev.w;
      }
    }
    sm.db += in[2 * a.d];
  }
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = group_col<NG>(q, i, lane);
    if (c < a.d) {
      float4 dv = make_float4(sm.dec[i][0], sm.dec[i][1], sm.dec[i][2], sm.dec[i][3]);
      if (kComposed) dv = make_float4(bf16r(dv.x), bf16r(dv.y), bf16r(dv.z), bf16r(dv.w));
      __stcs(reinterpret_cast<float4*>(a.dw_dec + (size_t)f * a.d + c), dv);
#pragma unroll
      for (int t = 0; t < 4; ++t) enc[(c + t) * (nf + 1) + g] = sm.enc[i][t];
    }
  }
  if (q == 0 && lane == 0) a.db_enc[f] = sm.db;
  __syncthreads();
  // dW_enc's rows of the tile: F floats each, in 16-byte stores where F
  // is a multiple of 4
  if (nf % 4 == 0) {
    const int per = nf / 4;
    for (int i = threadIdx.x; i < a.d * per; i += blockDim.x) {
      const int c = i / per;
      const float* e = enc + c * (nf + 1) + 4 * (i % per);
      __stcs(reinterpret_cast<float4*>(a.dw_enc + (size_t)c * a.h + f0) + i % per,
             make_float4(e[0], e[1], e[2], e[3]));
    }
  } else {
    for (int i = threadIdx.x; i < a.d * nf; i += blockDim.x) {
      const int c = i / nf, fl = i % nf;
      __stcs(a.dw_enc + (size_t)c * a.h + f0 + fl, enc[c * (nf + 1) + fl]);
    }
  }
}

// Warps a feature (a power of two, so that groups tile the CTA) and
// four-column groups a lane for width d.
__host__ __device__ inline int warps_per_feature(int d) {
  const int groups = (d + 4 * kWarp - 1) / (4 * kWarp);
  int p = 1;
  while (p * kMaxGroups < groups) p *= 2;
  return p;
}
inline int groups_per_lane(int d) {
  const int groups = (d + 4 * kWarp - 1) / (4 * kWarp);
  const int p = warps_per_feature(d);
  return (groups + p - 1) / p;
}

// The workspace's parts, each 256-byte aligned.
struct Layout {
  size_t mask, cnt, slot_base, unit_f, params, scratch, total;
};
inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }
// A feature's mask words: a bit a row, padded to four words (16-byte loads).
inline int mask_words(int rows) { return (rows + 4 * kWarp - 1) / (4 * kWarp) * 4; }
inline Layout layout(int rows, int d, int h) {
  Layout l{};
  l.mask = 0;
  l.cnt = align256(l.mask + (size_t)h * mask_words(rows) * 4);
  l.slot_base = align256(l.cnt + (size_t)h * 4);
  l.unit_f = align256(l.slot_base + (size_t)h * 4);
  l.params = align256(l.unit_f + (size_t)kSlots * 4);
  l.scratch = align256(l.params + 16);
  l.total = align256(l.scratch + (size_t)kSlots * slot_floats(d) * 4);
  return l;
}

template <int NG, bool kComposed>
int launch(const Args& a, int sms, cudaStream_t s) {
  const int nf = tile_features(a.p), threads = nf * a.p * kWarp;
  seg_kernel<NG, kComposed><<<2 * sms, kCtaThreads, 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = (threads + (size_t)a.d * (nf + 1)) * sizeof(float);
  err = (int)cudaFuncSetAttribute(tile_kernel<NG, kComposed>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  tile_kernel<NG, kComposed><<<a.h / nf, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kComposed>
int launch_route(const Args& a, int sms, cudaStream_t s) {
  switch (groups_per_lane(a.d)) {
    case 1: return launch<1, kComposed>(a, sms, s);
    case 2: return launch<2, kComposed>(a, sms, s);
    case 3: return launch<3, kComposed>(a, sms, s);
    case 4: return launch<4, kComposed>(a, sms, s);
    case 5: return launch<5, kComposed>(a, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wst_bwd

extern "C" {

// The widest rows the backward takes (checked again in Python).
int wst_sae_topk_bwd_max_d() { return wst_bwd::kMaxD; }

long long wst_sae_topk_bwd_workspace_bytes(int rows, int d, int h) {
  return (long long)wst_bwd::layout(rows, d, h).total;
}

// The TopK SAE step's backward over the positive entries of the latent
// (hid [rows, h] bf16): dw_enc [d, h], db_enc [h] and dw_dec [h, d] in
// f32, from d_recon [rows, d] (f32 with ``composed``, else bf16), the
// centred rows xc [rows, d] bf16 and W_dec [h, d] bf16.  ``composed``
// picks the composed route's rounding points, else kernel A's.  d and h
// multiples of 32, d <= wst_sae_topk_bwd_max_d(); every pointer 16-byte
// aligned; ``ws`` of wst_sae_topk_bwd_workspace_bytes(rows, d, h).
int wst_sae_topk_bwd(int composed, const void* hid, const void* d_recon, const void* xc,
                     const void* w_dec, int rows, int d, int h, void* dw_enc, void* db_enc,
                     void* dw_dec, void* ws, void* stream) {
  using namespace wst_bwd;
  const void* ptrs[] = {hid, d_recon, xc, w_dec, dw_enc, db_enc, dw_dec, ws};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (rows < 0 || d <= 0 || d % kWarp || d > kMaxD || h <= 0 || h % kWarp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(rows, d, h);
  char* w = static_cast<char*>(ws);
  Args a{};
  a.hid = static_cast<const unsigned short*>(hid);
  a.d_recon = d_recon;
  a.xc = static_cast<const unsigned short*>(xc);
  a.w_dec = static_cast<const unsigned short*>(w_dec);
  a.d = d, a.h = h, a.nbp = mask_words(rows), a.p = warps_per_feature(d);
  uint32_t* mask = reinterpret_cast<uint32_t*>(w + l.mask);
  int* cnt = reinterpret_cast<int*>(w + l.cnt);
  int* slot_base = reinterpret_cast<int*>(w + l.slot_base);
  int* unit_f = reinterpret_cast<int*>(w + l.unit_f);
  int* params = reinterpret_cast<int*>(w + l.params);
  a.mask = mask, a.cnt = cnt, a.slot_base = slot_base, a.unit_f = unit_f, a.params = params;
  a.scratch = reinterpret_cast<float*>(w + l.scratch);
  a.dw_enc = static_cast<float*>(dw_enc);
  a.db_enc = static_cast<float*>(db_enc);
  a.dw_dec = static_cast<float*>(dw_dec);
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaMemsetAsync(mask, 0, (size_t)h * a.nbp * 4, s);
  if (err) return err;
  if (rows) {
    mask_kernel<<<(rows + kCtaWarps - 1) / kCtaWarps, kCtaThreads, 0, s>>>(a.hid, rows, h, a.nbp,
                                                                           mask);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  count_kernel<<<(h + kCtaWarps - 1) / kCtaWarps, kCtaThreads, 0, s>>>(mask, h, a.nbp, cnt);
  err = (int)cudaGetLastError();
  if (err) return err;
  plan_kernel<<<1, kPlanThreads, 0, s>>>(cnt, h, slot_base, unit_f, params);
  err = (int)cudaGetLastError();
  if (err) return err;
  return composed ? launch_route<true>(a, sms, s) : launch_route<false>(a, sms, s);
}

}  // extern "C"
