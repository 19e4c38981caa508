// Packed-prefill segment-causal paged attention for Hopper (sm_90a):
// kernel K3 of the port.
//
// Replaces the TPU kernel `packed_prefill_attention_pallas`
// (dynamo_tpu/ops/pallas_packed_prefill.py, body `_packed_kernel`) in its
// bf16 mode (`packed_prefill_bf16`) and its int8 mode
// (`packed_prefill_int8`).  Same function: a packed stream of T tokens from S segments;
// token t attends to its own segment's paged context at absolute positions
// [0, positions[t]] (the chunk's own K/V is already in the cache); q is
// pre-scaled by 1/sqrt(hd) and rounded to bf16 first; online softmax and
// accumulation in fp32, with probabilities forced to exactly 0 outside the
// mask so a row's carry never mixes in another segment; tokens no segment
// owns (the padded tail, invalid tokens) output exactly 0.
//
// Tile-skip: the wrapper builds, as the TPU wrapper does, the number of
// context blocks each (token tile, segment) pair needs: the causal
// frontier of the tile's farthest token of that segment, or 0 when the
// segment owns no token of the tile.  A thread block walks only those, so
// no block iterates over a foreign segment's context and the attention
// work is about 1x the stream's own, not S-fold.
//
// What bounds it on this card: operations.  At a 2048-token causal
// segment it does 4 * nh * hd * T^2 / 2 flops per layer (34 GFLOP at
// llama-8b) on a few MiB of K/V, far above the bf16 ridge of ~295
// flop/byte, so the products belong on the tensor cores.
//
// Design: grid = (16-token tiles, kv heads), one warp per query head of
// the kv head's group.  A block holds its tile's 16 * group query rows
// (row = token * group + head) and each warp owns 16 of them, kept in
// registers as mma.sync A fragments.  Per owned segment and context block
// (bs positions) the block copies the valid K and V rows to shared memory
// with cp.async (rows padded to hd + 8 elements: 16-byte aligned, and the
// fragment reads of 8 rows land in 8 distinct bank groups), then per
// 64-column step: S = Q.K^T with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), the mask and online-softmax update in registers (row
// statistics reduced over the 4 lanes that share a row), and O += P.V
// with P re-packed from the score accumulators as bf16 A fragments and V
// fragments loaded by ldmatrix.trans.  V rows past the valid columns are
// zeroed, so 0 * junk can never reach O.
//
// Int8 mode, with the decode kernel's design (csrc/paged_decode.cu has
// the reasoning): each block's int8 rows are converted once, on their way
// into shared memory, to bf16 codes (exact) in the bf16 mode's layout,
// so the eight warps that read the tile share one conversion; the rows
// come through registers, kLoadBatch 16-byte loads of K and of V in
// flight per thread, and the block's fp32 scale rows (bs * 4 bytes each,
// at [(h * nb + blk) * bs] of the layer's planes) by cp.async.  Scores are scaled by their
// column's K scale after Q.K^T, and P.V takes bf16(p * v_scale) against
// the V codes, with l summing the unscaled p.  Masked columns are
// selected, never multiplied, so junk scales of the garbage block or an
// unwritten tail cannot reach a sum.
//
// Known limits, for later PRs: one block's copies do not overlap its own
// arithmetic (no double buffering; two blocks per SM overlap each other),
// no TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTB = 16;        // tokens per tile
constexpr int kMaxGroup = 8;   // query heads per kv head (= warps per block)
constexpr int kCols = 64;      // score columns per step
constexpr int kLoadBatch = 4;  // int8 mode: 16-byte loads in flight per thread
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

// shared memory carve-up, in bytes, shared by the kernel and the launcher;
// int8 adds the block's K and V scale rows
template <int HD, bool kQ>
struct Smem {
  static constexpr int kStride = HD + 8;  // bf16 per row
  __host__ __device__ static size_t k(int rows) {
    return align16(sizeof(__nv_bfloat16) * rows * kStride);
  }
  __host__ __device__ static size_t v(int rows, int bs) {
    return k(rows) + sizeof(__nv_bfloat16) * bs * kStride;
  }
  __host__ __device__ static size_t sc(int rows, int bs) {
    return v(rows, bs) + sizeof(__nv_bfloat16) * bs * kStride;
  }
  __host__ __device__ static size_t seg(int rows, int bs) {
    return sc(rows, bs) + (kQ ? sizeof(float) * 2 * bs : 0);
  }
  __host__ __device__ static size_t pos(int rows, int bs) { return seg(rows, bs) + sizeof(int) * kTB; }
  __host__ __device__ static size_t total(int rows, int bs) { return pos(rows, bs) + sizeof(int) * kTB; }
};

// kQ: an int8 cache with its scale planes (k_scale/v_scale unused otherwise)
template <int HD, bool kQ>
__global__ void __launch_bounds__(32 * kMaxGroup)
packed_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [T, nh, HD]
                      const std::conditional_t<kQ, int8_t, __nv_bfloat16>* __restrict__ k_cache,
                      const std::conditional_t<kQ, int8_t, __nv_bfloat16>* __restrict__ v_cache,
                      const float* __restrict__ k_scale,  // [nkv, NB, bs] (int8)
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,     // [S, mb]
                      const int* __restrict__ seg_eff,    // [n_tiles * kTB], -1 = none
                      const int* __restrict__ positions,  // [n_tiles * kTB]
                      const int* __restrict__ nchunks,    // [n_tiles, S]
                      __nv_bfloat16* __restrict__ out,    // [T, nh, HD]
                      int T, int nh, int nkv, int num_blocks, int bs, int S, int mb,
                      float scale) {
  using L = Smem<HD, kQ>;
  using KV = std::conditional_t<kQ, int8_t, __nv_bfloat16>;
  constexpr int kStride = L::kStride;
  constexpr int kGran = HD / 8;                  // 16-byte bf16 granules per row
  constexpr int kKVGran = HD * sizeof(KV) / 16;  // 16-byte granules per cache row
  constexpr int kKSteps = HD / 16;
  constexpr int kDTiles = HD / 8;

  const int group = nh / nkv;
  const int rows = kTB * group;
  const int nthreads = 32 * group;
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t0 = tile * kTB;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k(rows));  // [bs][kStride]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v(rows, bs));
  float* ks_s = reinterpret_cast<float*>(smem + L::sc(rows, bs));  // [bs] (int8)
  float* vs_s = ks_s + bs;
  int* seg_s = reinterpret_cast<int*>(smem + L::seg(rows, bs));
  int* pos_s = reinterpret_cast<int*>(smem + L::pos(rows, bs));

  // the tile's query rows (row = token * group + head), pre-scaled and
  // rounded to bf16; rows past T are zero
  for (int i = tid; i < rows * kGran; i += nthreads) {
    const int r = i / kGran;
    const int gr = i % kGran;
    const int tok = t0 + r / group;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (tok < T)
      raw = *reinterpret_cast<const uint4*>(
          q + ((size_t)tok * nh + (size_t)h * group + r % group) * HD + gr * 8);
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * kStride + gr * 8) = raw;
  }
  if (tid < kTB) {
    seg_s[tid] = seg_eff[t0 + tid];
    pos_s[tid] = positions[t0 + tid];
  }
  __syncthreads();

  // this warp's 16 rows as A fragments: row ra (c0, c1) and ra + 8 (c2, c3)
  const int ra = warp * 16 + (lane >> 2);
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
  const int tok0 = ra / group;        // tile-local tokens of the two rows
  const int tok1 = (ra + 8) / group;

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const size_t head_pos = (size_t)h * num_blocks * bs;  // this head's first position
  for (int s = 0; s < S; ++s) {
    const int nch = nchunks[(size_t)tile * S + s];
    if (nch == 0) continue;  // the segment owns no token of this tile
    int maxp = -1;           // the tile's causal frontier in this segment
    for (int i = 0; i < kTB; ++i)
      if (seg_s[i] == s) maxp = max(maxp, pos_s[i]);
    const bool own0 = seg_s[tok0] == s;
    const bool own1 = seg_s[tok1] == s;
    const int p0 = pos_s[tok0];
    const int p1 = pos_s[tok1];

    for (int c = 0; c < nch; ++c) {
      const int c0 = c * bs;
      const int n_cols = min(bs, maxp - c0 + 1);
      const int n_pad = min(bs, (n_cols + kCols - 1) / kCols * kCols);
      const int blk = tables[(size_t)s * mb + c];
      const size_t blk_pos = head_pos + (size_t)blk * bs;
      const uint4* kg = reinterpret_cast<const uint4*>(k_cache + blk_pos * HD);
      const uint4* vg = reinterpret_cast<const uint4*>(v_cache + blk_pos * HD);
      __syncthreads();  // the previous block's readers are done
      if constexpr (kQ) {
        // the block's scale rows, 4 positions per copy (bs is a multiple
        // of 64, so rows are 16-byte aligned); junk past n_cols is unused
        const uint4* ksg = reinterpret_cast<const uint4*>(k_scale + blk_pos);
        const uint4* vsg = reinterpret_cast<const uint4*>(v_scale + blk_pos);
        for (int i = tid; i < (n_cols + 3) / 4; i += nthreads) {
          cp_async16(ks_s + 4 * i, ksg + i);
          cp_async16(vs_s + 4 * i, vsg + i);
        }
        // int8 rows, 16 codes a load, kLoadBatch loads of K and of V in
        // flight per thread before any is stored as bf16 codes
        const int n = n_cols * kKVGran;
        for (int i0 = tid; i0 < n; i0 += kLoadBatch * nthreads) {
          uint4 kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
          for (int j = 0; j < kLoadBatch; ++j) {
            const int i = i0 + j * nthreads;
            if (i < n) {
              kr[j] = kg[i];
              vr[j] = vg[i];
            }
          }
#pragma unroll
          for (int j = 0; j < kLoadBatch; ++j) {
            const int i = i0 + j * nthreads;
            if (i < n) {
              store_codes(k_s + (i / kKVGran) * kStride + (i % kKVGran) * 16, kr[j]);
              store_codes(v_s + (i / kKVGran) * kStride + (i % kKVGran) * 16, vr[j]);
            }
          }
        }
      } else {
        for (int i = tid; i < n_cols * kKVGran; i += nthreads) {
          const int r = i / kKVGran;
          const int gr = i % kKVGran;
          cp_async16(k_s + r * kStride + gr * 8, kg + i);
          cp_async16(v_s + r * kStride + gr * 8, vg + i);
        }
      }
      // V rows past the valid columns meet P = 0: make them finite zeros
      for (int i = n_cols * kGran + tid; i < n_pad * kGran; i += nthreads)
        *reinterpret_cast<uint4*>(v_s + (i / kGran) * kStride + (i % kGran) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      cp_async_wait_all();
      __syncthreads();

      for (int sub = 0; sub < n_cols; sub += kCols) {
        // S = Q.K^T over columns [sub, sub + 64): 8 n8 tiles
        float sc[kCols / 8][4];
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
          const __nv_bfloat16* krow = k_s + (sub + nt * 8 + (lane >> 2)) * kStride + kc;
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
            mma_bf16(sc[nt], qa[ks], b0, b1);
          }
        }
        // mask (ownership and the causal frontier; int8: scale the rest by
        // their K scale) and the online softmax
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = sub + nt * 8 + kc + e;
            const int pc = c0 + col;
            const bool ok0 = own0 && col < n_cols && pc <= p0;
            const bool ok1 = own1 && col < n_cols && pc <= p1;
            if constexpr (kQ) {
              sc[nt][e] *= ks_s[col];
              sc[nt][2 + e] *= ks_s[col];
            }
            sc[nt][e] = ok0 ? sc[nt][e] : kNegInf;
            sc[nt][2 + e] = ok1 ? sc[nt][2 + e] : kNegInf;
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
        for (int nt = 0; nt < kCols / 8; ++nt) {
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
        // O += P.V: P's accumulators re-packed as bf16 A fragments (k16 =
        // two n8 score tiles; int8: each column's P scaled by its V scale
        // first), V's B fragments by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk) {
          if constexpr (kQ) {
            const int ca = sub + kk * 16 + kc;  // this thread's columns ca, ca+1, ca+8, ca+9
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
          const __nv_bfloat16* vrow =
              v_s + (sub + kk * 16 + (lane & 15)) * kStride + (lane >> 4) * 8;
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
  }

  // tokens no segment owns have l == 0 and output 0
  const int out_rows[2] = {ra, ra + 8};
  const float inv[2] = {1.f / fmaxf(l0, 1e-20f), 1.f / fmaxf(l1, 1e-20f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = out_rows[half];
    const int tok = t0 + r / group;
    if (tok < T) {
      __nv_bfloat16* dst = out + ((size_t)tok * nh + (size_t)h * group + r % group) * HD + kc;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = __floats2bfloat162_rn(
            o[dt][2 * half] * inv[half], o[dt][2 * half + 1] * inv[half]);
    }
  }
}

template <int HD, bool kQ>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* tables, const void* seg_eff, const void* positions, const void* nchunks,
           void* out, int T, int nh, int nkv, int num_blocks, int bs, int S, int mb, int n_tiles,
           float scale, cudaStream_t stream) {
  using KV = std::conditional_t<kQ, int8_t, __nv_bfloat16>;
  const int group = nh / nkv;
  const size_t smem = Smem<HD, kQ>::total(kTB * group, bs);
  cudaError_t err = cudaFuncSetAttribute(packed_prefill_kernel<HD, kQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_prefill_kernel<HD, kQ><<<dim3(n_tiles, nkv), 32 * group, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(seg_eff),
      static_cast<const int*>(positions), static_cast<const int*>(nchunks),
      static_cast<__nv_bfloat16*>(out), T, nh, nkv, num_blocks, bs, S, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return the cudaError_t of the launch (0 on success).  Shapes are
// checked by the Python wrapper: hd is 64 or 128, nh / nkv <= 8, bs a
// multiple of 64 and <= 128; seg_eff/positions are padded to n_tiles * 16
// entries.
int packed_prefill_bf16(const void* q, const void* k_layer, const void* v_layer,
                        const void* tables, const void* seg_eff, const void* positions,
                        const void* nchunks, void* out, int T, int nh, int nkv, int hd,
                        int num_blocks, int bs, int S, int mb, int n_tiles, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, false>(q, k_layer, v_layer, nullptr, nullptr, tables, seg_eff, positions,
                              nchunks, out, T, nh, nkv, num_blocks, bs, S, mb, n_tiles, scale, s);
  if (hd == 64)
    return launch<64, false>(q, k_layer, v_layer, nullptr, nullptr, tables, seg_eff, positions,
                             nchunks, out, T, nh, nkv, num_blocks, bs, S, mb, n_tiles, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: int8 caches with their layer's fp32 scale planes
// [nkv, num_blocks, bs].
int packed_prefill_int8(const void* q, const void* k_layer, const void* v_layer,
                        const void* k_scale_layer, const void* v_scale_layer, const void* tables,
                        const void* seg_eff, const void* positions, const void* nchunks,
                        void* out, int T, int nh, int nkv, int hd, int num_blocks, int bs, int S,
                        int mb, int n_tiles, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, seg_eff,
                             positions, nchunks, out, T, nh, nkv, num_blocks, bs, S, mb, n_tiles,
                             scale, s);
  if (hd == 64)
    return launch<64, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, seg_eff,
                            positions, nchunks, out, T, nh, nkv, num_blocks, bs, S, mb, n_tiles,
                            scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* packed_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
