// Paged GQA decode attention for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the TPU kernel `paged_attention_decode_pallas`
// (dynamo_tpu/ops/pallas_paged_attention.py, body `_decode_kernel`) in its
// bf16 mode (`paged_decode_bf16`) and its int8 mode (`paged_decode_int8`).
// Same function: one query token per sequence; the group =
// nh / nkv query heads of a kv head attend over that sequence's paged
// context, reached block by block through its block table; positions >=
// kv_len are masked; kv_len is clamped to >= 1; q is pre-scaled by
// 1/sqrt(hd) and rounded to bf16 first, as the TPU wrapper does; softmax
// and accumulation run in fp32 (online softmax across blocks).
//
// Cache layout: [nkv, num_blocks, bs, hd] per layer (the caller passes the
// layer's slice), head_dim innermost, so a block's keys are one contiguous
// bs * hd-element slab.  An int8 cache adds fp32 scale planes
// [nkv, num_blocks, bs] per layer, one scale per (position, kv head): a
// block's scale row is bs * 4 contiguous bytes.
//
// What bounds it on this card: bytes.  Every context position's K and V
// row is read once (2 * nkv * hd * 2 bytes per position per sequence in
// bf16, 2 * nkv * (hd + 4) in int8) and the arithmetic is 4 * nh * hd
// flops per position, about 1 flop per byte, far under the ~295
// flop/byte ridge of the H100 in bf16.
//
// Design: split-KV ("flash-decoding").  B * nkv blocks alone (64 at B = 8,
// llama-8b) would leave most of the 132 SMs idle, so the grid is
// (sequence, kv head, split), each split walking kSplitBlocks cache blocks
// of the table; a second kernel merges the splits' (max, sum, accumulator)
// partials with a log-sum-exp rescale.  Within a split, each cache block's
// valid K and V rows are copied to shared memory with cp.async (16-byte
// copies that need no registers; rows padded to hd + 8 elements, so
// fragment reads of 8 rows hit 8 distinct bank groups).  The products run
// on the tensor cores even though the group is a handful of rows: the
// group's query rows, zero-padded to the 16-row tile, are mma.sync A
// fragments held in registers; each of the 4 warps keeps its own online
// softmax state over a 32-column slice of every cache block (S = Q.K^T
// and O += P.V with mma.sync.m16n8k16, V fragments by ldmatrix.trans),
// and the warps' states are merged in shared memory at the end.  With
// about one block per SM at serving batch sizes, each scheduler runs one
// warp; FMA loops there expose every latency (in the FMA version the
// scores and P.V phases, not the loads, took most of a block's time),
// where a few dozen mma.sync per warp do the same work.  Positions past
// kv_len are masked, and V rows past them are zeroed, so junk in the
// garbage block or a block's unwritten tail cannot reach the output.
//
// Int8 mode: the TPU kernel dequantizes each block to the query dtype
// (k = bf16(code * scale)) before its products; this kernel computes the
// same function without a dequantized tile, by folding the scales out of
// the products.  A code |c| <= 127 is exact in bf16, so each block's int8
// rows (hd bytes) are converted once, on their way into shared memory, to
// bf16 codes in the bf16 mode's row layout, and the bf16 mode's fragment
// code runs on them unchanged.  The rows come through registers, with
// kLoadBatch 16-byte loads of K and of V in flight per thread (one load
// at a time left each thread waiting out eight round trips per block,
// and a cp.async staging buffer converted shared to shared cost an extra
// pass and barrier: both were measured slower, PERF.md); the block's fp32
// scale rows (bs * 4 contiguous bytes per kv head) come by cp.async.
// s_j = (q . c_kj) * k_scale_j in fp32 after Q.K^T, and O += P.V takes
// bf16(p_j * v_scale_j) as its A operand against the V codes, with l
// summing the unscaled p_j.  That rounds less than the TPU's dequantized
// tile (one bf16 rounding of p * scale instead of one of code * scale and
// one of p).  Junk scales (the garbage block, a block's unwritten tail,
// even inf or NaN) never reach a sum: a masked score is selected to -inf,
// never multiplied, and a masked column's P operand is selected to
// exactly 0 before its scale could multiply it.
//
// Known limits, for later PRs: no copy/compute double buffering within a
// block, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // mma rows: the group's query rows, zero-padded
constexpr int kSlice = 32;       // context columns per warp per step
constexpr int kSplitBlocks = 4;  // cache blocks per split
constexpr int kLoadBatch = 4;    // int8 mode: 16-byte loads in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 codes (one 16-byte load) stored as 16 bf16 values, exactly
__device__ __forceinline__ void store_codes(__nv_bfloat16* dst, uint4 raw) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = pack_bf16(c[2 * e], c[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

// a P operand scaled by its column's V scale; a masked column (p == 0)
// stays exactly 0 whatever its scale holds
__device__ __forceinline__ float scaled_p(float p, float s) { return p > 0.f ? p * s : 0.f; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ constexpr size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

// shared memory carve-up, in bytes, shared by the kernel and the launcher;
// the warps' final states (o) reuse the K region once the walk is done;
// int8 adds the block's K and V scale rows
template <int HD, bool kQ>
struct Smem {
  static constexpr int kStride = HD + 8;  // bf16 per row
  __host__ __device__ static size_t k(int) { return align16(sizeof(__nv_bfloat16) * kRows * kStride); }
  __host__ __device__ static size_t v(int bs) {
    return k(bs) + align16(max_size(sizeof(__nv_bfloat16) * bs * kStride,
                                    sizeof(float) * kWarps * kRows * HD));
  }
  __host__ __device__ static size_t sc(int bs) { return v(bs) + align16(sizeof(__nv_bfloat16) * bs * kStride); }
  __host__ __device__ static size_t ml(int bs) { return sc(bs) + (kQ ? sizeof(float) * 2 * bs : 0); }
  __host__ __device__ static size_t total(int bs) { return ml(bs) + sizeof(float) * 2 * kWarps * kRows; }
};

// one split of one (sequence, kv head): unnormalized partials.  kQ: an
// int8 cache with its scale planes (k_scale/v_scale unused otherwise)
template <int HD, bool kQ>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const __nv_bfloat16* __restrict__ q,  // [B, nh, HD]
                   const std::conditional_t<kQ, int8_t, __nv_bfloat16>* __restrict__ k_cache,
                   const std::conditional_t<kQ, int8_t, __nv_bfloat16>* __restrict__ v_cache,
                   const float* __restrict__ k_scale,    // [nkv, NB, bs] (int8)
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,       // [B, mb]
                   const int* __restrict__ kv_lens,      // [B]
                   float* __restrict__ part_m,           // [B, nh, n_splits]
                   float* __restrict__ part_l,           // [B, nh, n_splits]
                   float* __restrict__ part_acc,         // [B, nh, n_splits, HD]
                   int nh, int nkv, int num_blocks, int bs, int mb, float scale) {
  using L = Smem<HD, kQ>;
  using KV = std::conditional_t<kQ, int8_t, __nv_bfloat16>;
  constexpr int kStride = L::kStride;
  constexpr int kGran = HD / 8;                  // 16-byte bf16 granules per row
  constexpr int kKVGran = HD * sizeof(KV) / 16;  // 16-byte granules per cache row
  constexpr int kKSteps = HD / 16;
  constexpr int kDTiles = HD / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][kStride]
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k(bs));  // [bs][kStride]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v(bs));
  float* ks_s = reinterpret_cast<float*>(smem + L::sc(bs));     // [bs] (int8)
  float* vs_s = ks_s + bs;
  float* o_w = reinterpret_cast<float*>(smem + L::k(bs));  // [kWarps][kRows][HD], after the walk
  float* m_w = reinterpret_cast<float*>(smem + L::ml(bs));  // [kWarps][kRows]
  float* l_w = m_w + kWarps * kRows;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int group = nh / nkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int kv_len = max(kv_lens[b], 1);
  const int n_blk = min((kv_len + bs - 1) / bs, mb);
  const int c_begin = split * kSplitBlocks;
  const int c_end = min(c_begin + kSplitBlocks, n_blk);
  const size_t part = (size_t)b * nh + (size_t)h * group;  // first row's (b, head)

  if (c_begin >= c_end) {  // this split holds no context: an empty partial
    if (tid < group) {
      part_m[(part + tid) * n_splits + split] = kNegInf;
      part_l[(part + tid) * n_splits + split] = 0.f;
    }
    return;
  }

  // the group's query rows, pre-scaled and rounded to bf16; rows past the
  // group are zero
  for (int i = tid; i < kRows * kGran; i += kThreads) {
    const int r = i / kGran;
    const int gr = i % kGran;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < group) raw = *reinterpret_cast<const uint4*>(q + (part + r) * HD + gr * 8);
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * kStride + gr * 8) = raw;
  }
  __syncthreads();

  // A fragments: row ra (c0, c1) and ra + 8 (c2, c3)
  const int ra = lane >> 2;
  const int kc = (lane & 3) * 2;
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const __nv_bfloat16* base = q_s + ks * 16 + kc;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(base + ra * kStride);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(base + (ra + 8) * kStride);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(base + ra * kStride + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(base + (ra + 8) * kStride + 8);
  }

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const size_t head_pos = (size_t)h * num_blocks * bs;  // this head's first position
  for (int c = c_begin; c < c_end; ++c) {
    const int blk = tables[(size_t)b * mb + c];
    const int n_valid = min(bs, kv_len - c * bs);
    const int n_pad = min(bs, (n_valid + kSlice - 1) / kSlice * kSlice);
    const size_t blk_pos = head_pos + (size_t)blk * bs;
    const uint4* kg = reinterpret_cast<const uint4*>(k_cache + blk_pos * HD);
    const uint4* vg = reinterpret_cast<const uint4*>(v_cache + blk_pos * HD);
    __syncthreads();  // the previous block's readers are done with k_s/v_s
    if constexpr (kQ) {
      // the block's scale rows, 4 positions per copy (bs is a multiple of
      // 32, so rows are 16-byte aligned); junk past n_valid is never used
      const uint4* ksg = reinterpret_cast<const uint4*>(k_scale + blk_pos);
      const uint4* vsg = reinterpret_cast<const uint4*>(v_scale + blk_pos);
      for (int i = tid; i < (n_valid + 3) / 4; i += kThreads) {
        cp_async16(ks_s + 4 * i, ksg + i);
        cp_async16(vs_s + 4 * i, vsg + i);
      }
      // int8 rows, 16 codes a load, kLoadBatch loads of K and of V in
      // flight per thread before any is stored as bf16 codes
      const int n = n_valid * kKVGran;
      for (int i0 = tid; i0 < n; i0 += kLoadBatch * kThreads) {
        uint4 kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
        for (int j = 0; j < kLoadBatch; ++j) {
          const int i = i0 + j * kThreads;
          if (i < n) {
            kr[j] = kg[i];
            vr[j] = vg[i];
          }
        }
#pragma unroll
        for (int j = 0; j < kLoadBatch; ++j) {
          const int i = i0 + j * kThreads;
          if (i < n) {
            store_codes(k_s + (i / kKVGran) * kStride + (i % kKVGran) * 16, kr[j]);
            store_codes(v_s + (i / kKVGran) * kStride + (i % kKVGran) * 16, vr[j]);
          }
        }
      }
    } else {
      for (int i = tid; i < n_valid * kKVGran; i += kThreads) {
        const int r = i / kKVGran;
        const int gr = i % kKVGran;
        cp_async16(k_s + r * kStride + gr * 8, kg + i);
        cp_async16(v_s + r * kStride + gr * 8, vg + i);
      }
    }
    // V rows past kv_len meet P = 0: make them finite zeros
    for (int i = n_valid * kGran + tid; i < n_pad * kGran; i += kThreads)
      *reinterpret_cast<uint4*>(v_s + (i / kGran) * kStride + (i % kGran) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    cp_async_wait_all();
    __syncthreads();

    for (int col0 = warp * kSlice; col0 < n_valid; col0 += kWarps * kSlice) {
      // S = Q.K^T over this warp's 32 columns: 4 n8 tiles
      float sc[kSlice / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSlice / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
        const __nv_bfloat16* krow = k_s + (col0 + nt * 8 + (lane >> 2)) * kStride + kc;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
          mma_bf16(sc[nt], qa[ks], b0, b1);
        }
      }
      // mask positions past kv_len (int8: scale the rest by their K
      // scale); online softmax over this slice
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kSlice / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + nt * 8 + kc + e;
          const bool ok = col < n_valid;
          if constexpr (kQ) {
            sc[nt][e] *= ks_s[col];
            sc[nt][2 + e] *= ks_s[col];
          }
          sc[nt][e] = ok ? sc[nt][e] : kNegInf;
          sc[nt][2 + e] = ok ? sc[nt][2 + e] : kNegInf;
          mx0 = fmaxf(mx0, sc[nt][e]);
          mx1 = fmaxf(mx1, sc[nt][2 + e]);
        }
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kSlice / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked score is exactly kNegInf: its probability is 0
          const float e0 = sc[nt][e] > kNegInf ? __expf(sc[nt][e] - mn0) : 0.f;
          const float e1 = sc[nt][2 + e] > kNegInf ? __expf(sc[nt][2 + e] - mn1) : 0.f;
          sc[nt][e] = e0;
          sc[nt][2 + e] = e1;
          sum0 += e0;
          sum1 += e1;
        }
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o2);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o2);
      }
      const float al0 = __expf(m0 - mn0);
      const float al1 = __expf(m1 - mn1);
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        o[dt][0] *= al0;
        o[dt][1] *= al0;
        o[dt][2] *= al1;
        o[dt][3] *= al1;
      }
      // O += P.V: P re-packed as bf16 A fragments (int8: each column's P
      // scaled by its V scale first), V by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        if constexpr (kQ) {
          const int ca = col0 + kk * 16 + kc;  // this thread's columns ca, ca+1, ca+8, ca+9
          const float2 sa = *reinterpret_cast<const float2*>(vs_s + ca);
          const float2 sb = *reinterpret_cast<const float2*>(vs_s + ca + 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sc[2 * kk][2 * h] = scaled_p(sc[2 * kk][2 * h], sa.x);
            sc[2 * kk][2 * h + 1] = scaled_p(sc[2 * kk][2 * h + 1], sa.y);
            sc[2 * kk + 1][2 * h] = scaled_p(sc[2 * kk + 1][2 * h], sb.x);
            sc[2 * kk + 1][2 * h + 1] = scaled_p(sc[2 * kk + 1][2 * h + 1], sb.y);
          }
        }
        const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        const __nv_bfloat16* vrow = v_s + (col0 + kk * 16 + (lane & 15)) * kStride + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + dp * 16);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  // merge the warps' states: M = max_w m_w, L = sum_w l_w e^(m_w - M),
  // O = sum_w o_w e^(m_w - M); written as this split's partial
  __syncthreads();  // the walk is done: o_w may reuse the K region
  if ((lane & 3) == 0) {
    m_w[warp * kRows + ra] = m0;
    l_w[warp * kRows + ra] = l0;
    m_w[warp * kRows + ra + 8] = m1;
    l_w[warp * kRows + ra + 8] = l1;
  }
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    float* r0 = o_w + (warp * kRows + ra) * HD + dt * 8 + kc;
    float* r1 = r0 + 8 * HD;
    r0[0] = o[dt][0];
    r0[1] = o[dt][1];
    r1[0] = o[dt][2];
    r1[1] = o[dt][3];
  }
  __syncthreads();
  for (int i = tid; i < group * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kRows + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_w[w * kRows + g] - mx);
      den = fmaf(l_w[w * kRows + g], wt, den);
      num = fmaf(o_w[(w * kRows + g) * HD + d], wt, num);
    }
    part_acc[((part + g) * n_splits + split) * HD + d] = num;
    if (d == 0) {
      part_m[(part + g) * n_splits + split] = mx;
      part_l[(part + g) * n_splits + split] = den;
    }
  }
}

// merge the splits of one (sequence, head): out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M)
template <int HD>
__global__ void __launch_bounds__(HD)
paged_decode_merge(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, __nv_bfloat16* __restrict__ out,
                   int n_splits) {
  const size_t row = blockIdx.x;  // b * nh + head
  const int d = threadIdx.x;
  const float* m = part_m + row * n_splits;
  const float* l = part_l + row * n_splits;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
  float den = 0.f;
  float num = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    if (l[s] > 0.f) {
      const float w = expf(m[s] - mx);
      den = fmaf(l[s], w, den);
      num = fmaf(part_acc[(row * n_splits + s) * HD + d], w, num);
    }
  }
  out[row * HD + d] = __float2bfloat16(num / den);
}

template <int HD, bool kQ>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* tables, const void* kv_lens, void* part_m, void* part_l, void* part_acc,
           void* out, int B, int nh, int nkv, int num_blocks, int bs, int mb, float scale,
           cudaStream_t stream) {
  using KV = std::conditional_t<kQ, int8_t, __nv_bfloat16>;
  const size_t smem = Smem<HD, kQ>::total(bs);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_split<HD, kQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_splits = (mb + kSplitBlocks - 1) / kSplitBlocks;
  paged_decode_split<HD, kQ><<<dim3(B, nkv, n_splits), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(kv_lens),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      nh, nkv, num_blocks, bs, mb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge<HD><<<B * nh, HD, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Splits of the context per row, for the caller's partial buffers.
int paged_decode_num_splits(int mb) { return (mb + kSplitBlocks - 1) / kSplitBlocks; }

// Both return the cudaError_t of the launches (0 on success).  Shapes are
// checked by the Python wrapper: hd is 64 or 128, nh / nkv <= 16, bs a
// multiple of 32; the partial buffers hold B * nh * num_splits (m, l) and
// that times hd (acc) floats.
int paged_decode_bf16(const void* q, const void* k_layer, const void* v_layer,
                      const void* tables, const void* kv_lens, void* part_m, void* part_l,
                      void* part_acc, void* out, int B, int nh, int nkv, int hd, int num_blocks,
                      int bs, int mb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, false>(q, k_layer, v_layer, nullptr, nullptr, tables, kv_lens, part_m,
                              part_l, part_acc, out, B, nh, nkv, num_blocks, bs, mb, scale, s);
  if (hd == 64)
    return launch<64, false>(q, k_layer, v_layer, nullptr, nullptr, tables, kv_lens, part_m,
                             part_l, part_acc, out, B, nh, nkv, num_blocks, bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: int8 caches with their layer's fp32 scale planes
// [nkv, num_blocks, bs].
int paged_decode_int8(const void* q, const void* k_layer, const void* v_layer,
                      const void* k_scale_layer, const void* v_scale_layer, const void* tables,
                      const void* kv_lens, void* part_m, void* part_l, void* part_acc, void* out,
                      int B, int nh, int nkv, int hd, int num_blocks, int bs, int mb, float scale,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, kv_lens,
                             part_m, part_l, part_acc, out, B, nh, nkv, num_blocks, bs, mb, scale,
                             s);
  if (hd == 64)
    return launch<64, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, kv_lens,
                            part_m, part_l, part_acc, out, B, nh, nkv, num_blocks, bs, mb, scale,
                            s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
