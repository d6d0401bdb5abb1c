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
//      ahead of the scan with bulk copies (mbarriers), refilling a slot as
//      soon as both warps are done with it: every block is in flight from
//      the start where the ring holds them all (N <= 1536, as at the
//      serving config's N = 1000); at N = 4125 (65 words) five 33 KB
//      slots run three blocks ahead of the scan.  A slot holds a row
//      block's first SW words (all of them up to 192 words, N <= 12288);
//      the words past SW are read from the mask in device memory.  For
//      block k warp 0 resolves the block's 64 decisions against the
//      removed word k with bit operations only (the diagonal words in
//      registers) and ORs the kept boxes' rows into word k + 1, the only
//      word block k + 1 waits for; warp 1, one block behind, ORs them into
//      words k + 2 and later (lane l owns words l, l + 32, ..., kept in
//      shared memory; independent loads in a lane-rotated order that
//      spreads them over the banks).  The serial chain is a test and an OR
//      per box.
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
constexpr int RING_WORDS = 384;   // the ring: 192 KB of 512-byte words
constexpr int WORD_BYTES = TB * 8;
// The dynamic shared memory a CTA may take: the card's 227 KB less the
// scan's static shared memory (at most 512 bytes).
constexpr int SMEM_MAX = 232448 - 512;

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

// The OR of the kept rows of one 64-row word column ``col``, read in a
// lane-rotated order that spreads the lanes' loads over the banks.  Every
// row is loaded and masked by its kept bit: unconditional loads pipeline,
// where loads under a condition wait for each other.
__device__ __forceinline__ u64 kept_rows(const u64* col, u64 kept, int lane) {
  u64 acc = 0ull;
#pragma unroll 16
  for (int r = 0; r < TB; ++r) {
    const int rr = (r + lane) & (TB - 1);
    acc |= col[rr] & (0ull - ((kept >> rr) & 1ull));
  }
  return acc;
}

// Named barriers between the scan's two warps (ids 1-4; 0 is
// __syncthreads): 64 threads, one warp arriving and one waiting.
__device__ __forceinline__ void warps_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void warps_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// grid B, two warps; dynamic shared memory BAR_BYTES + the removed words
// [NW] rounded up to 16 (WIDE: NW > 32; else a static array of 32) + S
// slots of SW * 64 words, 2 <= S <= 32 (S = NW = 1 alone), 2 <= SW <= NW
// (SW = NW unless WIDE).  Warp 0 resolves each block of 64
// boxes in order; warp 1 ORs the rows of a block's kept boxes into the
// removed words two or more blocks ahead, one block behind warp 0.  Warp
// 0 ORs the rows into the next word itself (the only word the next block
// waits for), 32 lanes and two OR reductions.  Handshakes, alternating by
// block parity so that neither warp can reach a barrier twice before the
// other has: warp 0 publishes block j's kept word (barrier 1 + j % 2),
// warp 1 its words after block j (barrier 3 + j % 2), which warp 0 waits
// for at block j + 2 before it refills block j's slot.
template <bool WIDE>
__global__ void __launch_bounds__(64)
    nms_scan(const u64* __restrict__ mask, int N, int NW, int S, int SW,
             uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Block j's kept word at j (WIDE: j % 4; warp 0 is at most two blocks
  // ahead of warp 1) and, unless WIDE, the removed words.
  __shared__ u64 kept_s[WIDE ? 4 : 32], removed_s[WIDE ? 1 : 32];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  u64* removed =
      WIDE ? reinterpret_cast<u64*>(smem + BAR_BYTES) : removed_s;
  u64* ring = reinterpret_cast<u64*>(smem + BAR_BYTES) +
              (WIDE ? (NW + 15) & ~15 : 0);
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const size_t slot_words = (size_t)SW * TB;
  const u64* mb = mask + (size_t)b * pair_offset(NW, NW) * TB;
  // Row block k's first min(NW - k, SW) words into slot k % S (one thread).
  auto fetch = [&](int k) {
    bulk::load(ring + (k % S) * slot_words,
               mb + (size_t)pair_offset(k, NW) * TB,
               (uint32_t)((WIDE ? min(NW - k, SW) : NW - k) * WORD_BYTES),
               bar + k % S);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bulk::init(bar + s);
    bulk::fence_init();
    for (int k = 0; k < S; ++k) fetch(k);
  }
  if (WIDE) {
    for (int w = threadIdx.x; w < NW; w += 64) removed[w] = 0ull;
  } else if (threadIdx.x < 32) {
    removed_s[threadIdx.x] = 0ull;
  }
  __syncthreads();
  if (threadIdx.x >= 32) {  // warp 1: words j + 2 .. NW - 1 after block j
    u64 acc = 0ull;  // lane w < 32 holds word w
    for (int j = 0; j + 2 < NW; ++j) {
      warps_sync(1 + (j & 1));
      bulk::wait(bar + j % S, (uint32_t)((j / S) & 1));
      const u64 kept = kept_s[WIDE ? j & 3 : j];
      const u64* slot = ring + (j % S) * slot_words;
      if (lane >= j + 2 && lane < NW) {  // word lane - j < 32 <= SW: the slot
        acc |= kept_rows(slot + (size_t)(lane - j) * TB, kept, lane);
        removed[lane] = acc;
      }
      if (WIDE) {
        // Words 32 and on (N > 2048), lane l those of l + 32, l + 64, ...:
        // in the slot, or past it in device memory.
        const u64* row = mb + (size_t)pair_offset(j, NW) * TB;
        for (int w = j + 2 - lane > 32 ? lane + ((j + 2 - lane + 31) & ~31)
                                       : lane + 32;
             w < NW; w += 32) {
          const int d = w - j;
          removed[w] |= d < SW ? kept_rows(slot + (size_t)d * TB, kept, lane)
                               : kept_rows(row + (size_t)d * TB, kept, lane);
        }
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
      rem |= removed[k];
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
      if (lane == 0) kept_s[WIDE ? k & 3 : k] = kept;
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
// NW = ceil(N/64); keep [B,N] u8.  1 <= N <= 1048576 (the removed words,
// 8 bytes per 64 boxes, and a two-slot ring share the CTA's shared memory;
// checked by the Python wrapper).  Returns the first launch error
// (0 = cudaSuccess).
extern "C" int nms_keep_mask_fwd(const void* boxes, int B, int N, float thr,
                                 void* mask, void* keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NW = (N + TB - 1) / TB;
  cudaError_t e;
  nms_mask<<<dim3(pair_offset(NW, NW), B), TB, 0, st>>>(
      static_cast<const float4*>(boxes), N, NW, thr, static_cast<u64*>(mask));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // The ring: as many whole row blocks as fit in RING_WORDS (at most 32
  // barriers), at least two slots of at least two words each.  Up to 2048
  // boxes the removed words fit one per lane of a warp: the wide instance
  // forced there took 8.6% longer at [8,1000,4] and 2.3% at [128,1000,4]
  // on the H100 (PERF.md, B2).
  const bool wide = NW > 32;
  const int removed_bytes = wide ? ((NW + 15) & ~15) * 8 : 0;
  const int words = min(RING_WORDS, (SMEM_MAX - BAR_BYTES - removed_bytes) /
                                        WORD_BYTES);
  const int S = min(NW, max(2, min(32, words / NW)));
  const int SW = min(NW, words / S);
  const int smem = BAR_BYTES + removed_bytes + S * SW * WORD_BYTES;
  static int smem_allowed[2] = {32 * 1024, 32 * 1024};
  auto scan = wide ? nms_scan<true> : nms_scan<false>;
  if (smem > smem_allowed[wide]) {
    e = cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    smem_allowed[wide] = smem;
  }
  scan<<<B, 64, smem, st>>>(static_cast<const u64*>(mask), N, NW, S, SW,
                            static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
