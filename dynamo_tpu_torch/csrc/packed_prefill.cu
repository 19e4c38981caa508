// Packed-prefill segment-causal paged attention for Hopper (sm_90a):
// kernel K3 of the port.
//
// Replaces the TPU kernel `packed_prefill_attention_pallas`
// (dynamo_tpu/ops/pallas_packed_prefill.py, body `_packed_kernel`) in its
// bf16 mode (`packed_prefill_bf16`) and its int8 mode
// (`packed_prefill_int8`).  Same function: a packed stream of T tokens
// from S segments; token t attends to its own segment's paged context at
// absolute positions [0, positions[t]] (the chunk's own K/V is already in
// the cache); q is pre-scaled by 1/sqrt(hd) and rounded to bf16 first;
// online softmax and accumulation in fp32, with probabilities forced to
// exactly 0 outside the mask so a row's carry never mixes in another
// segment; tokens no segment owns (the padded tail, invalid tokens)
// output exactly 0.
//
// Tile-skip: the wrapper's tile plan gives, as the TPU wrapper does, the
// number of context blocks each (token tile, segment) pair needs: the
// causal frontier of the tile's farthest token of that segment, or 0 when
// the segment owns no token of the tile.  A tile walks only those, so no
// tile iterates over a foreign segment's context and the attention work
// is about 1x the stream's own, not S-fold.  The plan also orders the
// tiles by their work, longest first, and the grid follows that order,
// so the last causal tiles of a long segment do not set the tail.
//
// What bounds it on this card: operations.  At a 2048-token causal
// segment it does 4 * nh * hd * T^2 / 2 flops per layer (34 GFLOP at
// llama-8b) on a few MiB of K/V, far above the bf16 ridge of ~295
// flop/byte, so the design is the one Hopper's tensor cores need:
//
// - wgmma on 64-row tiles.  A consumer warpgroup's tile is 64 rows =
//   64 / group tokens x the group's query heads of one kv head (row =
//   token * group + head; 16 tokens at group 4).  A CTA holds two
//   consumer warpgroups (32 tokens at group 4) and one producer
//   warpgroup, and the two consumers share every K/V stage, so a
//   segment's context is read from L2 once per 32 tokens instead of per
//   16.  S = Q.K^T is wgmma.mma_async m64n64k16 with Q (A) and the K
//   stage (B, K-major) in 128-byte-swizzled shared memory; the online
//   softmax runs in registers; O += P.V is m64n{hd}k16 with P from
//   registers (A) and the V stage as a transposed (MN-major) B.
// - TMA into an mbarrier ring.  Q's tile comes by TMA from a 3-D tensor
//   map over [T, nh, hd] (box 64 hd x group heads x tokens, swizzled for
//   wgmma; tokens past T read as 0), then the consumers scale it in place.
//   One producer thread streams the walk's K and V stages (64 positions,
//   half a 128-position block) by TMA from 2-D tensor maps over the
//   layer's [nkv * num_blocks * bs, hd] slabs into a 4-stage ring with
//   full and empty mbarriers.  setmaxnreg hands the consumers the
//   registers the producer warpgroup does not need.
// - The mask only where it is needed.  A stage wholly inside every row's
//   causal frontier (all of the warpgroup's rows in the stage's segment)
//   skips the mask-and-select pass; others select masked scores to -inf
//   (never a multiply).  V rows past the tile's frontier are zeroed in
//   the stage before P.V, so 0 * junk can never reach O.
//
// Int8 mode, the decode kernel's function (csrc/paged_decode.cu has the
// reasoning): the producer brings each stage's int8 codes by TMA and its
// two fp32 scale rows by bulk copy into a ring of code stages; the
// producer warpgroup's other three warps convert each stage once into
// bf16 codes (exact, at full rate: codes_to_bf16) in the swizzled layout
// of a bf16 ring stage, with its scale rows, off the consumers' path; the
// bf16 mode's wgmma path runs on them.  Scores are scaled by their
// column's K scale after Q.K^T, and P.V takes bf16(p * v_scale) against
// the V codes, with l summing the unscaled p.  Masked columns are
// selected, never multiplied, so junk scales of the garbage block or an
// unwritten tail (NaN included) cannot reach a sum.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W, PERF.md): the
// T = 2048 stream 0.1099 ms (bf16) and 0.1482 ms (int8) against a 0.0275
// ms operation bound, about 250 TFLOP/s; the four-prompt T = 512 stream
// 0.0121 and 0.0128 ms.  Each warpgroup runs S, softmax and P.V one after
// the other, so the tensor cores idle during its softmax unless the other
// warpgroup fills them.  Starting the next stage's S before this stage's
// softmax was measured slower: under this launch bound ptxas keeps the
// consumers at 168 registers, spills the second score accumulator and
// serializes the wgmmas.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kWG = 2;                     // consumer warpgroups per CTA
constexpr int kThreads = 128 * (kWG + 1);  // + the producer warpgroup
constexpr int kRowsWG = 64;                // wgmma rows per consumer warpgroup
constexpr int kCols = 64;                  // context positions per stage
constexpr int kMaxTB = kWG * kRowsWG;      // tokens per tile at group 1
constexpr float kNegInf = -1e30f;
constexpr int kEncodeError = 1000;         // + the CUresult of a failed tensor-map encode
static_assert(kWG == 2, "int8 conversion splits K and V between two warpgroups");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, bulk copies ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the phase of parity `parity` has completed.  A wait that
// never ends is a bug in the walk: trap (the launch fails) instead of
// holding the device
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ----

// descriptor of a 128-byte-swizzled operand tile: 8-row groups 1024 bytes
// apart (SBO); LBO is the distance between 64-element chunks of an
// MN-major operand (unused for K-major)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64 fp32) (+)= A (64 x 16, smem, K-major) * B (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// D (64 x 128 fp32) += A (64 x 16 bf16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// ---- the kernel ----

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

// a P operand scaled by its column's V scale; a masked column (p == 0)
// stays exactly 0 whatever its scale holds
__device__ __forceinline__ float scaled_p(float p, float s) { return p > 0.f ? p * s : 0.f; }

// the largest position among tokens [lo, lo + n) of the tile owned by
// segment s, -1 when it owns none
__device__ __forceinline__ int frontier(const int* seg_s, const int* pos_s, int lo, int n, int s) {
  int p = -1;
  for (int i = lo; i < lo + n; ++i)
    if (seg_s[i] == s) p = max(p, pos_s[i]);
  return p;
}

__host__ __device__ constexpr size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// Shared memory carve-up, in bytes from a 1024-byte-aligned base, shared
// by the kernel and the launcher.  A "tile" is 64 rows x HD bf16 as
// HD / 64 slabs of [64 rows][64] with the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B, wgmma's B128 layout).  The consumers read
// the ring of (K tile, V tile) stages; in int8 mode the producer fills a
// ring of code stages and the converter warps turn each into a ring stage.
template <int HD, bool kQ>
struct Smem {
  static constexpr int kSlabs = HD / 64;
  static constexpr size_t kSlab = 64 * 128;
  static constexpr size_t kTile = kSlabs * kSlab;
  static constexpr int kRing = kQ ? 3 : 4;      // (K, V) bf16 stages
  static constexpr int kCodeRing = kQ ? 4 : 0;  // int8: code stages
  static constexpr size_t kCodes = 64 * HD;     // int8: one stage's K (or V) codes
  // a code stage: K codes, V codes, the K and V scale rows
  static constexpr size_t kCodeStage = 2 * kCodes + 2 * 64 * sizeof(float);
  static constexpr size_t q = 0;  // [kWG] tiles
  static constexpr size_t ring = q + kWG * kTile;
  static constexpr size_t codes = ring + kRing * 2 * kTile;
  static constexpr size_t scales = codes + kCodeRing * kCodeStage;  // int8: [kRing][2][64] fp32
  static constexpr size_t bars = align_up(scales + (kQ ? kRing * 2 * 64 * sizeof(float) : 0), 8);
  // full[kRing], empty[kRing], cfull[kCodeRing], cempty[kCodeRing], qfull[kWG]
  static constexpr size_t seg = bars + sizeof(uint64_t) * (2 * kRing + 2 * kCodeRing + kWG);
  static constexpr size_t pos = seg + sizeof(int) * kMaxTB;
  static constexpr size_t total = pos + sizeof(int) * kMaxTB;
  static_assert(kCodeStage % 128 == 0, "TMA destinations are 128-byte aligned");
};

constexpr int kConverters = 96;  // int8: the producer warpgroup's warps 1-3

// one (token tile, kv head) per CTA: warpgroups 0 and 1 compute; warpgroup
// 2's first thread streams K/V by TMA and, in int8 mode, its other three
// warps convert codes.  kQ: an int8 cache with its scale planes
template <int HD, bool kQ>
__global__ void __launch_bounds__(kThreads, 1)
packed_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,  // [T, nh, HD] bf16
                      const __grid_constant__ CUtensorMap tm_k,  // [nkv * NB * bs, HD]
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ k_scale,  // [nkv, NB, bs] (int8)
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,     // [S, mb]
                      const int* __restrict__ seg_eff,    // [n_tiles * tb], -1 = none
                      const int* __restrict__ positions,  // [n_tiles * tb]
                      const int* __restrict__ nchunks,    // [n_tiles, S]
                      const int* __restrict__ order,      // [n_tiles], longest first
                      __nv_bfloat16* __restrict__ out,    // [T, nh, HD]
                      int T, int nh, int nkv, int num_blocks, int bs, int S, int mb,
                      float scale) {
  using L = Smem<HD, kQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::kRing;
  uint64_t* cfull = empty + L::kRing;
  uint64_t* cempty = cfull + L::kCodeRing;
  uint64_t* qfull = cempty + L::kCodeRing;
  int* seg_s = reinterpret_cast<int*>(smem + L::seg);
  int* pos_s = reinterpret_cast<int*>(smem + L::pos);

  const int group = nh / nkv;
  const int tbw = kRowsWG / group;  // tokens per consumer warpgroup
  const int tb = kWG * tbw;         // tokens per tile
  const int h = blockIdx.x;
  const int tile = order[blockIdx.y];
  const int t0 = tile * tb;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid < tb) {
    seg_s[tid] = seg_eff[t0 + tid];
    pos_s[tid] = positions[t0 + tid];
  }
  if (tid == 0) {
    for (int i = 0; i < L::kRing; ++i) {
      mbar_init(&full[i], kQ ? kConverters : 1);
      mbar_init(&empty[i], kWG * 4);  // one arrival per consumer warp
    }
    for (int i = 0; i < L::kCodeRing; ++i) {
      mbar_init(&cfull[i], 1);
      mbar_init(&cempty[i], kConverters);
    }
    for (int w = 0; w < kWG; ++w) mbar_init(&qfull[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role takes the same walk: per segment s with work in this tile,
  // its first nchunks blocks, 64 positions c0 at a time up to the tile's
  // frontier maxp in s.
  if (wg == kWG) {
    setmaxnreg_dec<56>();
    const int pt = tid - kWG * 128;
    if (pt == 0) {
      // ---------------- producer: TMA ----------------
      for (int w = 0; w < kWG; ++w) {
        mbar_expect_tx(&qfull[w], L::kSlabs * tbw * group * 128);
        for (int sl = 0; sl < L::kSlabs; ++sl)
          tma_load_3d(smem + L::q + w * L::kTile + sl * L::kSlab, &tm_q, &qfull[w], sl * 64,
                      h * group, t0 + w * tbw);
      }
      int stage = 0, phase = 0;
      for (int s = 0; s < S; ++s) {
        const int nch = nchunks[tile * S + s];
        if (nch == 0) continue;
        const int maxp = frontier(seg_s, pos_s, 0, tb, s);
        for (int c = 0; c < nch; ++c) {
          const int blk = tables[(size_t)s * mb + c];
          for (int c0 = c * bs; c0 < (c + 1) * bs && c0 <= maxp; c0 += kCols) {
            const int row = (h * num_blocks + blk) * bs + (c0 - c * bs);
            if constexpr (kQ) {
              mbar_wait(&cempty[stage], phase ^ 1);
              unsigned char* st = smem + L::codes + stage * L::kCodeStage;
              mbar_expect_tx(&cfull[stage], L::kCodeStage);
              tma_load_2d(st, &tm_k, &cfull[stage], 0, row);
              tma_load_2d(st + L::kCodes, &tm_v, &cfull[stage], 0, row);
              bulk_load(st + 2 * L::kCodes, k_scale + row, 64 * sizeof(float), &cfull[stage]);
              bulk_load(st + 2 * L::kCodes + 64 * sizeof(float), v_scale + row,
                        64 * sizeof(float), &cfull[stage]);
              if (++stage == L::kCodeRing) {
                stage = 0;
                phase ^= 1;
              }
            } else {
              mbar_wait(&empty[stage], phase ^ 1);
              unsigned char* st = smem + L::ring + stage * 2 * L::kTile;
              mbar_expect_tx(&full[stage], 2 * L::kTile);
              for (int sl = 0; sl < L::kSlabs; ++sl) {
                tma_load_2d(st + sl * L::kSlab, &tm_k, &full[stage], sl * 64, row);
                tma_load_2d(st + L::kTile + sl * L::kSlab, &tm_v, &full[stage], sl * 64, row);
              }
              if (++stage == L::kRing) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    } else if (kQ && pt >= 32) {
      // ---------------- int8: converters ----------------
      // each code stage's K and V codes to bf16 codes (exact) in the
      // swizzled tiles of a ring stage, and its scale rows beside them
      const int ct = pt - 32;
      constexpr int kGran = HD / 16;  // 16-code granules per row
      int cs = 0, cph = 0, rs = 0, rph = 0;
      for (int s = 0; s < S; ++s) {
        const int nch = nchunks[tile * S + s];
        if (nch == 0) continue;
        const int maxp = frontier(seg_s, pos_s, 0, tb, s);
        for (int c = 0; c < nch; ++c) {
          for (int c0 = c * bs; c0 < (c + 1) * bs && c0 <= maxp; c0 += kCols) {
            mbar_wait(&cfull[cs], cph);
            mbar_wait(&empty[rs], rph ^ 1);
            const unsigned char* src = smem + L::codes + cs * L::kCodeStage;
            unsigned char* dst = smem + L::ring + rs * 2 * L::kTile;
            for (int g = ct; g < 2 * 64 * kGran; g += kConverters) {
              const int r = g / kGran;  // rows 0-63 K, 64-127 V
              const int j = 2 * (g % kGran);
              const uint4 raw = reinterpret_cast<const uint4*>(src)[g];
              const uint2 a = codes_to_bf16(raw.x), b = codes_to_bf16(raw.y);
              const uint2 cc = codes_to_bf16(raw.z), dd = codes_to_bf16(raw.w);
              const uint32_t w[8] = {a.x, a.y, b.x, b.y, cc.x, cc.y, dd.x, dd.y};
              unsigned char* tl = dst + (r / 64) * L::kTile;
              const int rr = r % 64;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int jj = j + hf;
                *reinterpret_cast<uint4*>(tl + (jj / 8) * L::kSlab + rr * 128 +
                                          (((jj % 8) ^ (rr & 7)) << 4)) =
                    make_uint4(w[4 * hf], w[4 * hf + 1], w[4 * hf + 2], w[4 * hf + 3]);
              }
            }
            if (ct < 32)
              reinterpret_cast<float4*>(smem + L::scales)[rs * 32 + ct] =
                  reinterpret_cast<const float4*>(src + 2 * L::kCodes)[ct];
            fence_proxy_async();
            mbar_arrive(&full[rs]);
            mbar_arrive(&cempty[cs]);
            if (++cs == L::kCodeRing) {
              cs = 0;
              cph ^= 1;
            }
            if (++rs == L::kRing) {
              rs = 0;
              rph ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<224>();
    const int wt = tid % 128;
    const int warp = wt / 32;
    const int lane = tid % 32;
    const int rows_used = tbw * group;

    // Q: scaled by 1/sqrt(hd) and rounded to bf16 in place; rows past the
    // warpgroup's tokens are zero
    mbar_wait(&qfull[wg], 0);
    unsigned char* q_t = smem + L::q + wg * L::kTile;
    for (int i = wt; i < (int)(L::kTile / 16); i += 128) {
      uint4* p = reinterpret_cast<uint4*>(q_t) + i;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if ((i * 16 % L::kSlab) / 128 < rows_used) {
        raw = *p;
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(x[e]);
          x[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
      *p = raw;
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    // this thread's rows r0 and r0 + 8 of the warpgroup's 64 (the wgmma
    // accumulator layout), their tile-local tokens, segments and positions
    const int r0 = warp * 16 + (lane >> 2);
    const int kc = (lane & 3) * 2;
    int sg[2], ps[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tok = (r0 + 8 * hf) / group;
      sg[hf] = tok < tbw ? seg_s[wg * tbw + tok] : -1;
      ps[hf] = tok < tbw ? pos_s[wg * tbw + tok] : -1;
    }

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint64_t dq = sw128_desc(q_t, 16);

    int stage = 0, phase = 0;
    for (int s = 0; s < S; ++s) {
      const int nch = nchunks[tile * S + s];
      if (nch == 0) continue;
      const int maxp = frontier(seg_s, pos_s, 0, tb, s);
      // the warpgroup's own frontier in s, and the first position any of
      // its rows may not see (-1 unless all its rows belong to s)
      const int wg_max = frontier(seg_s, pos_s, wg * tbw, tbw, s);
      int wg_min = rows_used == kRowsWG ? 1 << 30 : -1;
      for (int i = wg * tbw; i < (wg + 1) * tbw; ++i)
        wg_min = seg_s[i] == s ? min(wg_min, pos_s[i]) : -1;
      const bool own0 = sg[0] == s, own1 = sg[1] == s;

      for (int c = 0; c < nch; ++c) {
        for (int c0 = c * bs; c0 < (c + 1) * bs && c0 <= maxp; c0 += kCols) {
          mbar_wait(&full[stage], phase);
          unsigned char* k_t = smem + L::ring + stage * 2 * L::kTile;
          unsigned char* v_t = k_t + L::kTile;
          const float* ks = reinterpret_cast<const float*>(smem + L::scales) + stage * 128;
          const float* vs = ks + 64;
          if constexpr (!kQ) {
            const int n_cols = min(kCols, maxp - c0 + 1);
            if (n_cols < kCols) {
              // V rows past the tile's frontier meet P = 0: make them
              // finite zeros (a row is 128 contiguous bytes of each slab;
              // int8 codes are finite and need none)
              const int chunks = (kCols - n_cols) * 8;
              for (int i = tid; i < L::kSlabs * chunks; i += 128 * kWG)
                *reinterpret_cast<uint4*>(v_t + (i / chunks) * L::kSlab + n_cols * 128 +
                                          (i % chunks) * 16) = make_uint4(0u, 0u, 0u, 0u);
              fence_proxy_async();
              named_barrier(3, 128 * kWG);
            }
          }

          if (wg_max >= c0) {  // some row of this warpgroup sees these columns
            // S = Q.K^T: 64 rows x 64 columns
            float d[32];
            wgmma_fence();
#pragma unroll
            for (int ksx = 0; ksx < HD / 16; ++ksx) {
              const uint32_t off = (ksx / 4) * L::kSlab + (ksx % 4) * 32;
              wgmma_ss_n64(d, dq + (off >> 4), sw128_desc(k_t + off, 16), ksx > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(d);

            // int8: scores scaled by their column's K scale; then the mask
            // (ownership and the causal frontier) where some row needs it
            if constexpr (kQ) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float sk = ks[j * 8 + kc + e];
                  d[4 * j + e] *= sk;
                  d[4 * j + 2 + e] *= sk;
                }
            }
            if (!(wg_min >= c0 + kCols - 1)) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int pc = c0 + j * 8 + kc + e;
                  d[4 * j + e] = own0 && pc <= ps[0] ? d[4 * j + e] : kNegInf;
                  d[4 * j + 2 + e] = own1 && pc <= ps[1] ? d[4 * j + 2 + e] : kNegInf;
                }
            }
            // online softmax; row statistics over the 4 lanes of a row
            float al[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float mx = kNegInf;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                mx = fmaxf(mx, fmaxf(d[4 * j + 2 * hf], d[4 * j + 2 * hf + 1]));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
              const float mn = fmaxf(m[hf], mx);
              float sum = 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  // a masked score is exactly kNegInf: its probability is 0
                  float& x = d[4 * j + 2 * hf + e];
                  x = x > kNegInf ? __expf(x - mn) : 0.f;
                  sum += x;
                }
              sum += __shfl_xor_sync(0xffffffffu, sum, 1);
              sum += __shfl_xor_sync(0xffffffffu, sum, 2);
              al[hf] = __expf(m[hf] - mn);
              l[hf] = l[hf] * al[hf] + sum;
              m[hf] = mn;
            }
            if constexpr (kQ) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float sv = vs[j * 8 + kc + e];
                  d[4 * j + e] = scaled_p(d[4 * j + e], sv);
                  d[4 * j + 2 + e] = scaled_p(d[4 * j + 2 + e], sv);
                }
            }
            // O = O * alpha + P.V: P's accumulators as bf16 A fragments
            // (k16 = two n8 score tiles), V as the MN-major B
            uint32_t pa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
              o[4 * j] *= al[0];
              o[4 * j + 1] *= al[0];
              o[4 * j + 2] *= al[1];
              o[4 * j + 3] *= al[1];
            }
            fence_regs(o);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t dv = sw128_desc(v_t + kk * 16 * 128, L::kSlab);
              if constexpr (HD == 128)
                wgmma_rs_n128(o, pa[kk], dv);
              else
                wgmma_rs_n64(o, pa[kk], dv);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(o);
          }
          if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
          if (++stage == L::kRing) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }

    // tokens no segment owns have l == 0 and output 0
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      const int tok = r / group;
      const int t = t0 + wg * tbw + tok;
      if (tok < tbw && t < T) {
        const float inv = 1.f / fmaxf(l[hf], 1e-20f);
        __nv_bfloat16* dst = out + ((size_t)t * nh + (size_t)h * group + r % group) * HD + kc;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
      }
    }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map over rows x HD elements of a layer's cache slab, one stage
// (64 rows) a box: bf16 as 128-byte-swizzled 64-element slabs, int8 rows
// as they are
template <int HD, bool kQ>
CUresult encode_cache(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)HD, rows};
  const cuuint32_t ones[2] = {1, 1};
  if constexpr (kQ) {
    const cuuint64_t strides[1] = {(cuuint64_t)HD};
    const cuuint32_t box[2] = {(cuuint32_t)HD, 64};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
               ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t strides[1] = {(cuuint64_t)HD * 2};
    const cuuint32_t box[2] = {64, 64};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
               box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
}

}  // namespace

extern "C" int packed_prefill_smem_bytes(int hd, int int8);

namespace {

template <int HD, bool kQ>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* tables, const void* seg_eff, const void* positions, const void* nchunks,
           const void* order, void* out, int T, int nh, int nkv, int num_blocks, int bs, int S,
           int mb, int n_tiles, float scale, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kEncodeError;
  const int group = nh / nkv;
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[3] = {(cuuint64_t)HD, (cuuint64_t)nh, (cuuint64_t)T};
  const cuuint64_t qstrides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)nh * HD * 2};
  const cuuint32_t qbox[3] = {64, (cuuint32_t)group, (cuuint32_t)(kRowsWG / group)};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = enc(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(q), qdims, qstrides,
                   qbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const uint64_t rows = (uint64_t)nkv * num_blocks * bs;
  if ((r = encode_cache<HD, kQ>(enc, &tk, k, rows)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode_cache<HD, kQ>(enc, &tv, v, rows)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  const size_t smem = packed_prefill_smem_bytes(HD, kQ);
  cudaError_t err = cudaFuncSetAttribute(packed_prefill_kernel<HD, kQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  packed_prefill_kernel<HD, kQ><<<dim3(nkv, n_tiles), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(seg_eff),
      static_cast<const int*>(positions), static_cast<const int*>(nchunks),
      static_cast<const int*>(order), static_cast<__nv_bfloat16*>(out), T, nh, nkv, num_blocks,
      bs, S, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return 0 on success, the cudaError_t of the launch, or 1000 + the
// CUresult of a failed tensor-map encode.  Shapes are checked by the
// Python wrapper: hd is 64 or 128, nh / nkv <= 8, bs a multiple of 64 and
// <= 128; the tile plan (seg_eff, positions padded to n_tiles * tb tokens,
// tb = 2 * (64 / group); nchunks [n_tiles, S]; order) is the wrapper's.
int packed_prefill_bf16(const void* q, const void* k_layer, const void* v_layer,
                        const void* tables, const void* seg_eff, const void* positions,
                        const void* nchunks, const void* order, void* out, int T, int nh, int nkv,
                        int hd, int num_blocks, int bs, int S, int mb, int n_tiles, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, false>(q, k_layer, v_layer, nullptr, nullptr, tables, seg_eff, positions,
                              nchunks, order, out, T, nh, nkv, num_blocks, bs, S, mb, n_tiles,
                              scale, s);
  if (hd == 64)
    return launch<64, false>(q, k_layer, v_layer, nullptr, nullptr, tables, seg_eff, positions,
                             nchunks, order, out, T, nh, nkv, num_blocks, bs, S, mb, n_tiles,
                             scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 mode: int8 caches with their layer's fp32 scale planes
// [nkv, num_blocks, bs].
int packed_prefill_int8(const void* q, const void* k_layer, const void* v_layer,
                        const void* k_scale_layer, const void* v_scale_layer, const void* tables,
                        const void* seg_eff, const void* positions, const void* nchunks,
                        const void* order, void* out, int T, int nh, int nkv, int hd,
                        int num_blocks, int bs, int S, int mb, int n_tiles, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, seg_eff,
                             positions, nchunks, order, out, T, nh, nkv, num_blocks, bs, S, mb,
                             n_tiles, scale, s);
  if (hd == 64)
    return launch<64, true>(q, k_layer, v_layer, k_scale_layer, v_scale_layer, tables, seg_eff,
                            positions, nchunks, order, out, T, nh, nkv, num_blocks, bs, S, mb,
                            n_tiles, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one CTA of a launch asks for, in bytes (the
// carve-up and the 1024 bytes its base may need for alignment).
int packed_prefill_smem_bytes(int hd, int int8) {
  if (hd == 128) return (int)(int8 ? Smem<128, true>::total : Smem<128, false>::total) + 1024;
  if (hd == 64) return (int)(int8 ? Smem<64, true>::total : Smem<64, false>::total) + 1024;
  return -1;
}

const char* packed_prefill_error_string(int code) {
  static char msg[96];
  if (code >= kEncodeError) {
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed (CUresult %d)", code - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
