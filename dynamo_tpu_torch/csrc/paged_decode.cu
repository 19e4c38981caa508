// Paged GQA decode attention for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the TPU kernel `paged_attention_decode_pallas`
// (dynamo_tpu/ops/pallas_paged_attention.py, body `_decode_kernel`) in its
// bf16 mode (`paged_decode_bf16`) and its int8 mode (`paged_decode_int8`).
// Same function: one query token per sequence; the group =
// nh / nkv query heads of a kv head attend over that sequence's paged
// context, reached block by block through its block table; positions >=
// kv_len are masked; kv_len is clamped to [1, mb * bs]; q is pre-scaled by
// 1/sqrt(hd) and rounded to bf16 first, as the TPU wrapper does; softmax
// and accumulation run in fp32 (online softmax).
//
// Cache layout: [nkv, num_blocks, bs, hd] per layer (the caller passes the
// layer's slice), head_dim innermost, so a block's keys are one contiguous
// bs * hd-element slab.  An int8 cache adds fp32 scale planes
// [nkv, num_blocks, bs] per layer, one scale per (position, kv head).
//
// What bounds it on this card: bytes.  Every context position's K and V
// row is read once (2 * nkv * hd * 2 bytes per position per sequence in
// bf16, 2 * nkv * (hd + 4) in int8) and the arithmetic is 4 * nh * hd
// flops per position, about 1 flop per byte, far under the ~295
// flop/byte ridge of the H100 in bf16.  So the design is about keeping
// bytes in flight on every SM, and about the latency chain of one call:
//
// - Splits sized to the grid.  The context of each (sequence, kv head) is
//   cut into units of 64 positions, and the wrapper picks n_splits from
//   B, nkv, the table width and the SM count: one wave of two CTAs per SM
//   at full tables (no read of kv_lens, so the call stays capturable in a
//   CUDA graph).  Each row deals its own ceil(kv_len / 64) units
//   round-robin over min(n_splits, units) live splits on the device, so
//   a 2048-token row and a 129-token row both use every split that has
//   work; splits past a row's work exit at once.  Because where a split's
//   stages lie does not depend on kv_len, the row's length, its block
//   table entries and its query rows are requested together.
// - Loads in flight during the math.  Each of the 4 warps of a split owns
//   16 of every unit's 64 positions and runs its own cp.async ring of
//   kStages stages (16 K rows and 16 V rows a stage): while it computes
//   stage c, the copies of the next stages are in flight.  A warp waits
//   only on its own copies (cp.async.wait_group), so the walk needs no
//   block-wide barrier, and each lane holds the block of one of the next
//   32 stages, so starting a copy never waits on the block table.  Rows
//   are padded to hd + 8 elements, so the fragment reads of 8 rows hit 8
//   distinct bank groups.
// - One launch per call.  The last live split of a (sequence, kv head) to
//   finish merges every split's (max, sum, accumulator) partial with a
//   log-sum-exp rescale, reading the partials 8 splits at a time in one
//   round trip each, and writes the output; it finds out it is last from
//   a counter in the wrapper's workspace, which it resets to 0, so a
//   captured graph can replay.  A row with one live split writes its
//   output directly.  The workspace is preallocated by the wrapper.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, PERF.md): at the
// B = 8 case 0.0161 ms against a 0.0082 ms byte bound, B = 4 0.0100, B = 1
// 0.0076.  What is left is a chain of dependent steps that no split count
// hides (launch, row length and table, first bytes, the partials' fence,
// counter and merge: the B = 1 sweep puts it near 7 us) plus the longest
// split's walk.  Measured and not kept: one even share of all rows' units
// per CTA (CTAs that span several short rows pay the chain once per row),
// length-proportional splits (one more dependent round trip than they
// save), deeper rings, L2 prefetch ahead of the ring, two accumulator
// chains for Q.K^T and a lazy rescale of O (no gain).

// The products run on the tensor cores although the group is a handful of
// rows: the group's query rows, zero-padded to 16, are mma.sync.m16n8k16
// A fragments held in registers (wgmma's 64-row tile would be 94%
// padding at group 4); S = Q.K^T over a warp's 16 columns, the online
// softmax in registers, and O += P.V with P re-packed from the score
// accumulators and V fragments by ldmatrix.trans.  The warps' states are
// merged in shared memory at the end of a split.  Positions past kv_len
// are masked by a select (never a multiply), and V rows past kv_len are
// zeroed, so junk in the garbage block or a block's unwritten tail cannot
// reach the output.
//
// Int8 mode: the TPU kernel dequantizes each block to the query dtype
// (k = bf16(code * scale)) before its products; this kernel computes the
// same function without a dequantized tile, by folding the scales out of
// the products.  The int8 codes and their fp32 scale rows come through the
// same cp.async ring (half the bytes); once a stage has landed, the warp
// converts its 16 K and 16 V rows to bf16 codes (exact) in its own bf16
// work tile, while the next stages' copies stay in flight, and the bf16
// mode's fragment code runs on them unchanged.  The conversion is integer
// and fp32-add work at full rate (codes_to_bf16), not int-to-float
// conversions, which run at a quarter of that rate (PERF.md).
// Measured: B = 8 0.0194 ms against a 0.0043 ms byte bound, B = 4 0.0117,
// B = 1 0.0081: half the bytes of bf16, and the same latency chain.
// s_j = (q . c_kj) * k_scale_j in fp32 after Q.K^T, and O += P.V takes
// bf16(p_j * v_scale_j) as its A operand against the V codes, with l
// summing the unscaled p_j.  Junk scales (the garbage block, a block's
// unwritten tail, even inf or NaN) never reach a sum: a masked score is
// selected to -inf, and a masked column's P operand is selected to exactly
// 0 before its scale could multiply it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;              // mma rows: the group's query rows, zero-padded
constexpr int kUnit = 64;              // context positions per unit of split work
constexpr int kSlice = kUnit / kWarps;  // positions per warp per unit (one k16 step)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// four int8 codes (one 32-bit word) as four bf16 values, exactly, in
// full-rate integer and fp32 ops (no int-to-float conversions): each byte,
// offset to unsigned, becomes the low mantissa byte of 2^23 in fp32;
// subtracting 2^23 + 128 leaves the code, and a code needs no more than
// the upper 16 bits of its float, which are its bf16 bits
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// 16 int8 codes (16 bytes) stored as 16 bf16 values, exactly
__device__ __forceinline__ void store_codes(__nv_bfloat16* dst, uint4 raw) {
  const uint2 a = codes_to_bf16(raw.x), b = codes_to_bf16(raw.y);
  const uint2 c = codes_to_bf16(raw.z), d = codes_to_bf16(raw.w);
  *reinterpret_cast<uint4*>(dst) = make_uint4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(c.x, c.y, d.x, d.y);
}

// a P operand scaled by its column's V scale; a masked column (p == 0)
// stays exactly 0 whatever its scale holds
__device__ __forceinline__ float scaled_p(float p, float s) { return p > 0.f ? p * s : 0.f; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory carve-up, in bytes, shared by the kernel and the launcher.
// Per warp: a ring of kStages stages of its 16 K and 16 V rows (bf16 rows
// padded to kStride; int8: the codes as they are, then the two 16-entry
// scale rows) and, in int8 mode, one bf16 work tile the codes are
// converted into.  The warps' final states (o) reuse the rings after the
// walk.
template <int HD, bool kQ>
struct Smem {
  static constexpr int kStages = kQ ? 4 : 3;
  static constexpr int kStride = HD + 8;  // bf16 per padded row
  static constexpr size_t kTile = sizeof(__nv_bfloat16) * 2 * kSlice * kStride;  // K + V, bf16
  static constexpr size_t kStage = kQ ? 2 * kSlice * HD + 2 * kSlice * sizeof(float) : kTile;
  static constexpr size_t kWarp = kStages * kStage + (kQ ? kTile : 0);
  static constexpr size_t q = 0;  // [kRows][kStride] bf16
  static constexpr size_t ring = align16(q + sizeof(__nv_bfloat16) * kRows * kStride);
  static constexpr size_t ml = ring + kWarps * kWarp;  // [2][kWarps][kRows] fp32
  static constexpr size_t flag = ml + sizeof(float) * 2 * kWarps * kRows;
  static constexpr size_t total = flag + 16;
  static_assert(sizeof(float) * kWarps * kRows * HD <= kWarps * kWarp, "o_w must fit the rings");
};

// one split of one (sequence, kv head): units split, split + n_splits, ...
// of the row; the last live split to finish merges.  kQ: an int8 cache
// with its scale planes (k_scale/v_scale unused otherwise)
template <int HD, bool kQ>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, nh, HD]
                    const std::conditional_t<kQ, int8_t, __nv_bfloat16>* __restrict__ k_cache,
                    const std::conditional_t<kQ, int8_t, __nv_bfloat16>* __restrict__ v_cache,
                    const float* __restrict__ k_scale,    // [nkv, NB, bs] (int8)
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,       // [B, mb]
                    const int* __restrict__ kv_lens,      // [B]
                    float* __restrict__ part_ml,          // [B, nh, n_splits, 2]
                    float* __restrict__ part_acc,         // [B, nh, n_splits, HD]
                    int* __restrict__ counters,           // [B, nkv], 0 between calls
                    __nv_bfloat16* __restrict__ out,      // [B, nh, HD]
                    int nh, int nkv, int num_blocks, int bs, int mb, float scale) {
  using L = Smem<HD, kQ>;
  using KV = std::conditional_t<kQ, int8_t, __nv_bfloat16>;
  constexpr int kStages = L::kStages;
  constexpr int kStride = L::kStride;
  constexpr int kGran = HD / 8;                  // 16-byte bf16 granules per row
  constexpr int kKVGran = HD * sizeof(KV) / 16;  // 16-byte granules per cache row
  constexpr int kKSteps = HD / 16;
  constexpr int kDTiles = HD / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  float* m_w = reinterpret_cast<float*>(smem + L::ml);  // [kWarps][kRows]
  float* l_w = m_w + kWarps * kRows;
  int* flag = reinterpret_cast<int*>(smem + L::flag);

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = nh / nkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t part = (size_t)b * nh + (size_t)h * group;  // first row's (b, head)
  const size_t head_pos = (size_t)h * num_blocks * bs;     // this head's first position

  // stage i of this warp's walk: its 16 positions of unit split + i *
  // n_splits.  Where a stage lies does not depend on kv_len, so the row's
  // length, the block table entries and the query rows are all requested
  // at once.  Each lane holds the block of one of the next 32 stages
  // (loaded 32 stages at a time, ahead of use), so starting a stage never
  // waits on the table; entries past the table read as block 0 and are
  // never used
  auto first_pos = [&](int i) { return (split + i * n_splits) * kUnit + warp * kSlice; };
  auto table_entry = [&](int i) {
    return first_pos(i) < mb * bs ? tables[(size_t)b * mb + first_pos(i) / bs] : 0;
  };
  const int len_raw = kv_lens[b];
  int blk_lane = table_entry(lane);

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

  // this row's units, dealt round-robin over its live splits
  const int kv_len = min(max(len_raw, 1), mb * bs);
  const int n_units = (kv_len + kUnit - 1) / kUnit;
  const int n_live = min(n_splits, n_units);
  if (split >= n_live) return;  // no work for this split (uniform over the block)
  const int n_steps = (n_units - split + n_splits - 1) / n_splits;
  auto valid_rows = [&](int i) { return min(kSlice, kv_len - first_pos(i)); };
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

  unsigned char* ring = smem + L::ring + warp * L::kWarp;
  // int8: the bf16 work tile the landed codes are converted into
  __nv_bfloat16* work = reinterpret_cast<__nv_bfloat16*>(ring + kStages * L::kStage);
  auto load_stage = [&](int i) {
    if (i >= n_steps) {
      cp_async_commit();  // one group per stage, empty or not
      return;
    }
    if (i % 32 == 0 && i > 0) blk_lane = table_entry(i + lane);
    const int blk = __shfl_sync(0xffffffffu, blk_lane, i % 32);
    const int n_valid = valid_rows(i);
    if (n_valid > 0) {  // bs is a multiple of 16: the 16 rows lie in one block
      const size_t row0 = head_pos + (size_t)blk * bs + first_pos(i) % bs;
      const uint4* kg = reinterpret_cast<const uint4*>(k_cache + row0 * HD);
      const uint4* vg = reinterpret_cast<const uint4*>(v_cache + row0 * HD);
      unsigned char* st = ring + (i % kStages) * L::kStage;
      if constexpr (kQ) {
        // the codes of all 16 rows (finite whatever they hold; masked
        // columns are selected away) and the two scale rows
        int8_t* ks8 = reinterpret_cast<int8_t*>(st);
        int8_t* vs8 = ks8 + kSlice * HD;
        for (int g = lane; g < kSlice * kKVGran; g += 32) {
          cp_async16(ks8 + g * 16, kg + g);
          cp_async16(vs8 + g * 16, vg + g);
        }
        float* sc = reinterpret_cast<float*>(vs8 + kSlice * HD);
        if (lane < 8) {
          const float* src = (lane < 4 ? k_scale : v_scale) + row0;
          cp_async16(sc + (lane >> 2) * kSlice + (lane & 3) * 4, src + (lane & 3) * 4);
        }
      } else {
        __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(st);
        __nv_bfloat16* v_s = k_s + kSlice * kStride;
        for (int g = lane; g < kSlice * kKVGran; g += 32) {
          const int r = g / kKVGran;
          const int gr = g % kKVGran;
          cp_async16(k_s + r * kStride + gr * 8, kg + g);  // junk rows are masked
          if (r < n_valid)
            cp_async16(v_s + r * kStride + gr * 8, vg + g);
          else  // V rows past kv_len meet P = 0: make them finite zeros
            *reinterpret_cast<uint4*>(v_s + r * kStride + gr * 8) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_stage(i);
  for (int i = 0; i < n_steps; ++i) {
    load_stage(i + kStages - 1);      // into the buffer stage i - 1 freed
    cp_async_wait<kStages - 1>();      // this lane's copies of stage i landed
    __syncwarp();                      // ... and every lane's
    const int n_valid = valid_rows(i);
    if (n_valid > 0) {
      unsigned char* st = ring + (i % kStages) * L::kStage;
      const __nv_bfloat16* k_s;
      const __nv_bfloat16* v_s;
      const float* ks_s = nullptr;
      const float* vs_s = nullptr;
      if constexpr (kQ) {
        // the landed codes to bf16 codes in the work tile, K then V rows
        const uint4* codes = reinterpret_cast<const uint4*>(st);
        for (int g = lane; g < 2 * kSlice * kKVGran; g += 32)
          store_codes(work + (g / kKVGran) * kStride + (g % kKVGran) * 16, codes[g]);
        ks_s = reinterpret_cast<const float*>(st + 2 * kSlice * HD);
        vs_s = ks_s + kSlice;
        k_s = work;
        v_s = work + kSlice * kStride;
        __syncwarp();
      } else {
        k_s = reinterpret_cast<const __nv_bfloat16*>(st);
        v_s = k_s + kSlice * kStride;
      }

      // S = Q.K^T over this warp's 16 columns: 2 n8 tiles
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
        const __nv_bfloat16* krow = k_s + (nt * 8 + (lane >> 2)) * kStride + kc;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
          mma_bf16(sc[nt], qa[ks], b0, b1);
        }
      }
      // mask positions past kv_len (int8: scale the rest by their K
      // scale); online softmax over these 16 columns
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + kc + e;
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
      for (int nt = 0; nt < 2; ++nt) {
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
      // O += P.V: P re-packed as one bf16 A fragment (int8: each column's
      // P scaled by its V scale first), V by ldmatrix.trans
      if constexpr (kQ) {
        const float2 sa = *reinterpret_cast<const float2*>(vs_s + kc);  // columns kc, kc+1
        const float2 sb = *reinterpret_cast<const float2*>(vs_s + kc + 8);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          sc[0][2 * hh] = scaled_p(sc[0][2 * hh], sa.x);
          sc[0][2 * hh + 1] = scaled_p(sc[0][2 * hh + 1], sa.y);
          sc[1][2 * hh] = scaled_p(sc[1][2 * hh], sb.x);
          sc[1][2 * hh + 1] = scaled_p(sc[1][2 * hh + 1], sb.y);
        }
      }
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
      const __nv_bfloat16* vrow = v_s + (lane & 15) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dp * 16);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // only empty groups can remain

  // merge the warps' states: M = max_w m_w, L = sum_w l_w e^(m_w - M),
  // O = sum_w o_w e^(m_w - M)
  __syncthreads();  // the walk is done: o_w may reuse the rings
  float* o_w = reinterpret_cast<float*>(smem + L::ring);  // [kWarps][kRows][HD]
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
      const float wt = __expf(m_w[w * kRows + g] - mx);  // 0 for a warp with no columns
      den = fmaf(l_w[w * kRows + g], wt, den);
      num = fmaf(o_w[(w * kRows + g) * HD + d], wt, num);
    }
    if (n_live == 1) {
      out[(part + g) * HD + d] = __float2bfloat16(num / den);
    } else {
      const size_t row = (part + g) * n_splits + split;
      part_acc[row * HD + d] = num;
      if (d == 0) {
        part_ml[2 * row] = mx;
        part_ml[2 * row + 1] = den;
      }
    }
  }
  if (n_live == 1) return;

  // the last live split of this (sequence, kv head) merges them all.
  // Each thread owns 4 output values of one query row and reads, 8 splits
  // at a time, their (max, sum) and its accumulator slice all at once,
  // folding each batch in with an online log-sum-exp rescale
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)b * nkv + h;
  if (tid == 0) *flag = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int i = tid; i < group * HD / 4; i += kThreads) {
    const int g = i / (HD / 4);
    const int d4 = i % (HD / 4);
    const size_t row0 = (part + g) * n_splits;
    float mx = kNegInf, den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += 8) {
      float m[8], l[8];
      float4 a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool live = s0 + k < n_live;
        const size_t row = row0 + s0 + k;
        m[k] = live ? __ldcg(part_ml + 2 * row) : kNegInf;
        l[k] = live ? __ldcg(part_ml + 2 * row + 1) : 0.f;
        a[k] = live ? __ldcg(reinterpret_cast<const float4*>(part_acc + row * HD) + d4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mn = mx;
#pragma unroll
      for (int k = 0; k < 8; ++k) mn = fmaxf(mn, m[k]);
      const float f = __expf(mx - mn);
      den *= f;
      acc.x *= f;
      acc.y *= f;
      acc.z *= f;
      acc.w *= f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float w = __expf(m[k] - mn);  // 0 past the live splits
        den = fmaf(l[k], w, den);
        acc.x = fmaf(a[k].x, w, acc.x);
        acc.y = fmaf(a[k].y, w, acc.y);
        acc.z = fmaf(a[k].z, w, acc.z);
        acc.w = fmaf(a[k].w, w, acc.w);
      }
      mx = mn;
    }
    const float inv = 1.f / den;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (part + g) * HD + 4 * d4);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  if (tid == 0) *counter = 0;  // ready for the next call (or graph replay)
}

template <int HD, bool kQ>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* tables, const void* kv_lens, void* part_ml, void* part_acc, void* counters,
           void* out, int B, int nh, int nkv, int num_blocks, int bs, int mb, int n_splits,
           float scale, cudaStream_t stream) {
  using KV = std::conditional_t<kQ, int8_t, __nv_bfloat16>;
  const size_t smem = Smem<HD, kQ>::total;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<HD, kQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<HD, kQ><<<dim3(n_splits, nkv, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(kv_lens),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), static_cast<int*>(counters),
      static_cast<__nv_bfloat16*>(out), nh, nkv, num_blocks, bs, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return the cudaError_t of the launch (0 on success).  Shapes are
// checked by the Python wrapper: hd is 64 or 128, nh / nkv <= 16, bs a
// multiple of 32; n_splits >= 1 splits per (row, kv head) (units of kUnit =
// 64 positions, the wrapper's UNIT); the workspace holds B * nh * n_splits
// * 2 (part_ml) and B * nh * n_splits * hd (part_acc, 16-byte aligned)
// floats and B * nkv counters that are 0.
int paged_decode_bf16(const void* q, const void* k_layer, const void* v_layer,
                      const void* tables, const void* kv_lens, void* part_ml, void* part_acc,
                      void* counters, void* out, int B, int nh, int nkv, int hd, int num_blocks,
                      int bs, int mb, int n_splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, false>(q, k_layer, v_layer, nullptr, nullptr, tables, kv_lens, part_ml,
                              part_acc, counters, out, B, nh, nkv, num_blocks, bs, mb, n_splits,
                              scale, s);
  if (hd == 64)
    return launch<64, false>(q, k_layer, v_layer, nullptr, nullptr, tables, kv_lens, part_ml,
                             part_acc, counters, out, B, nh, nkv, num_blocks, bs, mb, n_splits,
                             scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: int8 caches with their layer's fp32 scale planes
// [nkv, num_blocks, bs].
int paged_decode_int8(const void* q, const void* k_layer, const void* v_layer,
                      const void* k_scale_layer, const void* v_scale_layer, const void* tables,
                      const void* kv_lens, void* part_ml, void* part_acc, void* counters,
                      void* out, int B, int nh, int nkv, int hd, int num_blocks, int bs, int mb,
                      int n_splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, kv_lens,
                             part_ml, part_acc, counters, out, B, nh, nkv, num_blocks, bs, mb,
                             n_splits, scale, s);
  if (hd == 64)
    return launch<64, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, kv_lens,
                            part_ml, part_acc, counters, out, B, nh, nkv, num_blocks, bs, mb,
                            n_splits, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one CTA of a launch asks for, in bytes.
int paged_decode_smem_bytes(int hd, int int8) {
  if (hd == 128) return (int)(int8 ? Smem<128, true>::total : Smem<128, false>::total);
  if (hd == 64) return (int)(int8 ? Smem<64, true>::total : Smem<64, false>::total);
  return -1;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
