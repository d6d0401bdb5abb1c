// Greedy NMS keep mask for Hopper (sm_90a): kernel B2.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/nms_kernel.py:
// nms_keep_mask_batch (_nms_kernel_batch) and nms_keep_mask (_nms_kernel):
// for score-sorted, class-offset corner boxes [B,N,4] f32, box i is kept iff
// no kept box j < i has IoU(j, i) > thr (strict).
//
// What bounds it here: greedy suppression is a chain of N dependent
// decisions per image; the N^2/2 IoU tests around it are small (5e5 per
// image at the serving config).  Written in PyTorch it is N dependent
// launches (the JAX default is a fori_loop).  Two launches:
//   1. nms_mask: one 64-thread CTA per (row block, column block) of the
//      upper triangle (column block >= row block; the blocks below the
//      diagonal are never read, so never computed) writes, for each of its
//      64 boxes i, the 64-bit word of the boxes j > i of the column block
//      that i would suppress, stored [B][pair][64 rows] so that a row
//      block's words are contiguous and every store is coalesced.
//   2. nms_scan: one CTA of two warps per image walks the row blocks in
//      order.  One thread keeps a ring of row blocks in shared memory
//      ahead of the scan with bulk copies (mbarriers; every block is in
//      flight from the start where N <= 1536, as at the serving config's
//      N = 1000).  For block k warp 0 resolves the block's 64 decisions
//      against the removed word k with bit operations only (the diagonal
//      words in registers) and ORs the kept boxes' rows into word k + 1,
//      the only word block k + 1 waits for; warp 1, one block behind, ORs
//      them into words k + 2 and later (lane w, word w: independent loads
//      in a lane-rotated order that spreads them over the banks).  The
//      serial chain is a test and an OR per box.
// The IoU follows the op order of retinanet_tpu/ops/boxes.py:iou (the plain
// version's): max/min corners, ih*iw, (area_i + area_j) - inter, a guarded
// divide, and pairs with ih < 0 or iw < 0 give 0.  Build with -fmad=false and
// without fast math: a contracted FMA or an approximate divide would flip
// pairs that sit at the threshold, and the mask must be bit-identical to the
// plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {
namespace b2_nms {

typedef unsigned long long u64;
constexpr int TB = 64;            // boxes per block: one word per row
constexpr int BAR_BYTES = 256;    // the scan ring's mbarriers (<= 32)
constexpr int RING_BYTES = 192 * 1024;

__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float thr) {
  const float y_top = fmaxf(a.x, b.x);
  const float x_left = fmaxf(a.y, b.y);
  const float y_bottom = fminf(a.z, b.z);
  const float x_right = fminf(a.w, b.w);
  const float ih = y_bottom - y_top;
  const float iw = x_right - x_left;
  if (ih < 0.f || iw < 0.f) return 0.f > thr;
  const float inter = ih * iw;
  const float area_b = (b.z - b.x) * (b.w - b.y);
  const float uni = area_a + area_b - inter;
  const float iou = inter / (uni > 0.f ? uni : 1.0f);
  return iou > thr;
}

// The upper-triangle pairs of NW blocks in row-major order: row block rb's
// pairs (rb, rb..NW-1) start at pair_offset(rb).
__host__ __device__ inline int pair_offset(int rb, int NW) {
  return rb * NW - rb * (rb - 1) / 2;
}

// grid (NW(NW+1)/2, B).  Rows and columns past N give zero words.
__global__ void __launch_bounds__(TB)
    nms_mask(const float4* __restrict__ boxes, int N, int NW, float thr,
             u64* __restrict__ mask) {
  __shared__ float4 cols[TB];
  const int b = blockIdx.y;
  int rb = 0, rest = blockIdx.x;
  while (rest >= NW - rb) rest -= NW - rb++;
  const int cb = rb + rest;
  const float4* bb = boxes + (size_t)b * N;
  const int col0 = cb * TB;
  if (col0 + threadIdx.x < N) cols[threadIdx.x] = bb[col0 + threadIdx.x];
  __syncthreads();
  const int i = rb * TB + threadIdx.x;
  u64 bits = 0ull;
  if (i < N) {
    const float4 a = bb[i];
    const float area_a = (a.z - a.x) * (a.w - a.y);
    const int ncol = min(TB, N - col0);
    for (int k = cb == rb ? threadIdx.x + 1 : 0; k < ncol; ++k)
      if (suppresses(a, area_a, cols[k], thr)) bits |= 1ull << k;
  }
  mask[((size_t)b * gridDim.x + blockIdx.x) * TB + threadIdx.x] = bits;
}

// Named barriers between the scan's two warps (ids 1-4; 0 is
// __syncthreads): 64 threads, one warp arriving and one waiting.
__device__ __forceinline__ void warps_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void warps_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// grid B, two warps; dynamic shared memory BAR_BYTES + S slots of NW * 64
// words, S <= NW.  Warp 0 resolves each block of 64 boxes in order; warp 1
// ORs the rows of a block's kept boxes into the removed words two or more
// blocks ahead, one block behind warp 0.  Warp 0 ORs the rows into the
// next word itself (the only word the next block waits for), 32 lanes
// and two OR reductions.  Handshakes, alternating by block parity so that
// neither warp can reach a barrier twice before the other has: warp 0
// publishes block j's kept word (barrier 1 + j % 2), warp 1 its words
// after block j (barrier 3 + j % 2), which warp 0 waits for at block j + 2
// before it refills block j's slot.
__global__ void __launch_bounds__(64)
    nms_scan(const u64* __restrict__ mask, int N, int NW, int S,
             uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ u64 kept_s[32], removed_s[32];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  u64* ring = reinterpret_cast<u64*>(smem + BAR_BYTES);
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const size_t slot_words = (size_t)NW * TB;
  const u64* mb = mask + (size_t)b * pair_offset(NW, NW) * TB;
  // Row block k's words, [NW - k][64], into slot k % S (one thread).
  auto fetch = [&](int k) {
    bulk::load(ring + (k % S) * slot_words,
               mb + (size_t)pair_offset(k, NW) * TB,
               (uint32_t)((NW - k) * TB * sizeof(u64)), bar + k % S);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bulk::init(bar + s);
    bulk::fence_init();
    for (int k = 0; k < S; ++k) fetch(k);
  }
  if (threadIdx.x < 32) removed_s[threadIdx.x] = 0ull;
  __syncthreads();
  if (threadIdx.x >= 32) {  // warp 1: words j + 2 .. NW - 1 after block j
    u64 acc = 0ull;  // lane w holds word w
    for (int j = 0; j + 2 < NW; ++j) {
      warps_sync(1 + (j & 1));
      bulk::wait(bar + j % S, (uint32_t)((j / S) & 1));
      const u64 kept = kept_s[j];
      if (lane >= j + 2 && lane < NW) {
        const u64* col = ring + (j % S) * slot_words + (size_t)(lane - j) * TB;
#pragma unroll 16
        for (int r = 0; r < TB; ++r) {
          const int rr = (r + lane) & (TB - 1);
          acc |= ((kept >> rr) & 1ull) ? col[rr] : 0ull;
        }
        removed_s[lane] = acc;
      }
      warps_arrive(3 + (j & 1));
    }
    return;
  }
  uint8_t* kb = keep + (size_t)b * N;
  u64 next = 0ull;  // the previous block's kept rows ORed into this word
  for (int k = 0; k < NW; ++k) {
    u64 rem = next;
    if (k >= 2) {  // warp 1 is done with block k - 2: its words, its slot
      warps_sync(3 + (k & 1));
      rem |= removed_s[k];
      if (lane == 0 && k - 2 + S < NW) {
        bulk::fence_proxy();  // both warps' reads of the slot come first
        fetch(k - 2 + S);
      }
    }
    const int s = k % S;
    bulk::wait(bar + s, (uint32_t)((k / S) & 1));
    const u64* slot = ring + s * slot_words;
    // Each box's suppressions within the block (bits above its own).
    u64 diag[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) diag[r] = slot[r];
    // A box is kept iff it is not removed when its turn comes; a kept box
    // removes the later boxes of the block it suppresses.  Bit r of rem is
    // final once step r is done, so the kept word is ~rem.
#pragma unroll
    for (int r = 0; r < TB; ++r)
      if (!((rem >> r) & 1ull)) rem |= diag[r];
    const u64 kept = ~rem;
    if (k + 2 < NW) {
      if (lane == 0) kept_s[k] = kept;
      warps_arrive(1 + (k & 1));
    }
    for (int t = lane; t < TB; t += 32) {
      const int i = k * TB + t;
      if (i < N) kb[i] = (uint8_t)((kept >> t) & 1ull);
    }
    if (k + 1 < NW) {  // word k + 1 of the kept rows: lane l rows l, l + 32
      const u64* col = slot + TB;
      const u64 v = (((kept >> lane) & 1ull) ? col[lane] : 0ull) |
                    (((kept >> (lane + 32)) & 1ull) ? col[lane + 32] : 0ull);
      const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
      const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
      next = ((u64)hi << 32) | lo;
    }
  }
}

}  // namespace b2_nms
}  // namespace

using namespace b2_nms;

// boxes [B,N,4] f32 contiguous; mask scratch [B, NW(NW+1)/2, 64] u64 with
// NW = ceil(N/64); keep [B,N] u8.  1 <= N <= 2048 (a warp's 32 lanes hold
// the removed words; checked by the Python wrapper).  Returns the first launch
// error (0 = cudaSuccess).
extern "C" int nms_keep_mask_fwd(const void* boxes, int B, int N, float thr,
                                 void* mask, void* keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NW = (N + TB - 1) / TB;
  cudaError_t e;
  nms_mask<<<dim3(pair_offset(NW, NW), B), TB, 0, st>>>(
      static_cast<const float4*>(boxes), N, NW, thr, static_cast<u64*>(mask));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int slot = NW * TB * (int)sizeof(u64);
  const int S = min(NW, RING_BYTES / slot);
  const int smem = BAR_BYTES + S * slot;
  static int smem_allowed = 32 * 1024;  // beside 512 bytes of static
  if (smem > smem_allowed) {
    e = cudaFuncSetAttribute(nms_scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  nms_scan<<<B, 64, smem, st>>>(static_cast<const u64*>(mask), N, NW, S,
                                static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
