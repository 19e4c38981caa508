// Paged-gather bandwidth microbench for Hopper (sm_90a): kernels K4a and
// K4b of the port.
//
// Replaces the two TPU kernels of benchmarks/bench_dma_layouts.py:
// `make_gather` (body `gather_kernel`, K4a) in its "strided" and
// "contig" modes, and the sequential `seq` kernel of its `main` (K4b).
// They measure how fast paged KV blocks cross from device memory into
// on-chip memory for a cache layout, and compute a checksum of what
// crossed so the copies cannot be elided:
//
// - K4a (`dma_gather_*`): REPS passes over a table of nread block ids,
//   taken in chunks of bpc blocks.  Every byte of every listed block is
//   copied into shared memory; the output [8, hd] fp32 is the sum, over
//   every chunk of every pass, of the chunk's first block's head-0 plane,
//   rows (positions) 0-7.  "strided" reads the port's head-major cache
//   layer [nkv, nb, bs, hd]: a block is nkv planes of bs * hd * 2 bytes
//   (32 KB at llama-8b), each nb planes apart.  "contig" reads a
//   block-major slab [nb, nkv, bs, hd]: a block is one contiguous run of
//   nkv planes (256 KB).
// - K4b (`dma_seq`): REPS passes over the whole block-major slab in
//   order; the output [bs, hd] fp32 is the sum, over every chunk of
//   every pass, of the chunk's first block's head-0 plane.
//
// What bounds it on this card: bytes, by construction (1.07 GB a gather
// call, 2.15 GB a sequential call at the default shapes, far past the
// 50 MB L2).  The TPU kernels run one sequential grid step that keeps two
// VMEM slots of bpc blocks in flight with DMAs and semaphores.  Here each
// pass's walk over planes is cut into one contiguous slice per CTA, one
// CTA per SM, and each CTA keeps a ring of kStages plane-sized shared-memory
// stages in flight with cp.async.bulk copies completing on mbarriers
// (192 KB in flight per SM, several times what hides the memory latency
// at 25 GB/s per SM).  The passes stay sequential in time, as on the TPU:
// each CTA walks its own slice of every pass, pass after pass, so all
// CTAs read one pass at a time and a block is read again only a whole
// pass (128 or 256 MB, past the L2) later; were the passes cut into
// contiguous ranges per CTA, CTAs of different passes would read the
// same blocks at once and the L2 would serve most of them.  One thread
// issues the copies; all threads wait on a stage, add it to their
// registers if it feeds the output, and release it with a barrier before
// it is refilled.  Each CTA writes its partial sum; a second launch adds
// the partials in CTA order, so the output does not depend on timing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 6;
constexpr int kMaxPlaneBytes = 32768;
// output elements a thread accumulates: the [bs, hd] plane of K4b at
// bs = hd = 128 (K4a's [8, hd] corner uses the first 4)
constexpr int kAcc = 64;
constexpr int kMaxOut = kAcc * kThreads;

enum Mode { kStrided = 0, kContig = 1, kSeq = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
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

// a wait that never ends is a bug in the walk: trap (the launch fails)
// instead of holding the device
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the stage was read through the generic proxy; order those reads before
// the async proxy's refill
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Walk {
  const char* base;   // the cache layer or slab
  const int* tables;  // gather: [nread] block ids
  int mode, nkv, nb, nread, bpc, plane_bytes;
};

// plane of the walk's unit u, and whether it feeds the output
__device__ __forceinline__ const char* unit_plane(const Walk& w, long long u, bool& feeds) {
  const int h = (int)(u % w.nkv);
  long long plane;
  if (w.mode == kSeq) {
    const int b = (int)((u / w.nkv) % w.nb);
    feeds = h == 0 && b % w.bpc == 0;
    plane = (long long)b * w.nkv + h;
  } else {
    const long long t = u / ((long long)w.bpc * w.nkv);  // chunk step
    const int i = (int)((u / w.nkv) % w.bpc);           // block in chunk
    const int c = (int)(t % (w.nread / w.bpc));
    const int pid = w.tables[c * w.bpc + i];
    feeds = h == 0 && i == 0;
    plane = w.mode == kStrided ? (long long)h * w.nb + pid : (long long)pid * w.nkv + h;
  }
  return w.base + plane * w.plane_bytes;
}

// `per_pass` units make one pass; the CTA's slice of a pass is
// [lo, lo + cnt) and its j-th unit lies in pass j / cnt
__global__ void __launch_bounds__(kThreads, 1)
    walk_kernel(Walk w, int per_pass, int reps, int out_elems, float* partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kMaxPlaneBytes);
  const int tid = threadIdx.x;
  const int lo = (int)((long long)per_pass * blockIdx.x / gridDim.x);
  const int cnt = (int)((long long)per_pass * (blockIdx.x + 1) / gridDim.x) - lo;
  const int n = cnt * reps;
  auto unit = [&](int j) { return (long long)(j / cnt) * per_pass + lo + j % cnt; };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int j) {
    bool feeds;
    const char* src = unit_plane(w, unit(j), feeds);
    uint64_t* bar = &full[j % kStages];
    mbar_expect_tx(bar, (uint32_t)w.plane_bytes);
    bulk_load(smem + (j % kStages) * kMaxPlaneBytes, src, (uint32_t)w.plane_bytes, bar);
  };
  if (tid == 0)
    for (int j = 0; j < kStages && j < n; ++j) issue(j);
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    bool feeds;
    unit_plane(w, unit(j), feeds);
    if (feeds) {
      const __nv_bfloat16* st =
          reinterpret_cast<const __nv_bfloat16*>(smem + s * kMaxPlaneBytes);
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int e = tid + a * kThreads;
        if (e < out_elems) acc[a] += __bfloat162float(st[e]);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && j + kStages < n) {
      fence_proxy_async();
      issue(j + kStages);
    }
  }
  float* part = partials + (long long)blockIdx.x * out_elems;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int e = tid + a * kThreads;
    if (e < out_elems) part[e] = acc[a];
  }
}

// out[e] = the CTAs' partials added in CTA order
__global__ void reduce_kernel(const float* partials, int n_parts, int out_elems, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= out_elems) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += partials[(long long)p * out_elems + e];
  out[e] = s;
}

int launch(const Walk& w, int per_pass, int reps, int out_elems, int grid, float* partials,
           float* out, cudaStream_t stream) {
  if (w.plane_bytes <= 0 || w.plane_bytes > kMaxPlaneBytes || w.plane_bytes % 16 ||
      out_elems <= 0 || out_elems > kMaxOut || grid <= 0 || reps <= 0 ||
      (w.mode != kSeq && (w.bpc <= 0 || w.nread % w.bpc)))
    return (int)cudaErrorInvalidValue;
  const int smem = kStages * kMaxPlaneBytes + kStages * 8;
  cudaError_t err =
      cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<grid, kThreads, smem, stream>>>(w, per_pass, reps, out_elems, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(out_elems + 255) / 256, 256, 0, stream>>>(partials, grid, out_elems, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4a.  `cache` is a layer [nkv, nb, bs, hd] (strided = 1) or a slab
// [nb, nkv, bs, hd] (strided = 0) of bf16; out [8, hd] fp32; partials
// [grid, 8 * hd] fp32 scratch.  Returns 0 or the cudaError_t.
int dma_gather(const void* cache, const void* tables, void* partials, void* out, int strided,
               int nkv, int nb, int bs, int hd, int nread, int bpc, int reps, int grid,
               void* stream) {
  const Walk w{static_cast<const char*>(cache), static_cast<const int*>(tables),
               strided ? kStrided : kContig, nkv, nb, nread, bpc, bs * hd * 2};
  return launch(w, nread * nkv, reps, 8 * hd, grid, static_cast<float*>(partials),
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// K4b.  `slab` [nb, nkv, bs, hd] bf16; out [bs, hd] fp32; partials
// [grid, bs * hd] fp32 scratch.
int dma_seq(const void* slab, void* partials, void* out, int nkv, int nb, int bs, int hd, int bpc,
            int reps, int grid, void* stream) {
  const Walk w{static_cast<const char*>(slab), nullptr, kSeq, nkv, nb, 0, bpc, bs * hd * 2};
  return launch(w, nb * nkv, reps, bs * hd, grid, static_cast<float*>(partials),
                static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

const char* dma_layouts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
