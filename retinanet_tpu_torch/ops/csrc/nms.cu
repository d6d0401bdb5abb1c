// Greedy NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/nms_kernel.py:
// nms_keep_mask_batch (_nms_kernel_batch) and nms_keep_mask (_nms_kernel):
// for score-sorted, class-offset corner boxes [B,N,4] f32, box i is kept iff
// no kept box j < i has IoU(j, i) > thr (strict).
//
// What bounds it here: greedy suppression is a chain of N dependent
// decisions per image.  Written in PyTorch it is N dependent launches (the
// JAX default is a fori_loop), and the N x N IoU work is small (1000^2 per
// image at the serving config).  So the dependence is taken off the launch
// path and out of device memory latency:
//   1. nms_mask: every (i, 64-box column block) pair in parallel writes a
//      64-bit word of the boxes j > i that i would suppress -> [B,N,ceil(N/64)].
//   2. nms_scan: one block per image copies those rows into shared memory in
//      chunks and one warp walks i in order, each lane holding one 64-bit
//      word of the removed set; a kept box ORs its row in.  One step is a
//      shuffle and a shared-memory load, not a launch.
// The IoU follows the op order of retinanet_tpu/ops/boxes.py:iou (the plain
// version's): max/min corners, ih*iw, (area_i + area_j) - inter, a guarded
// divide, and pairs with ih < 0 or iw < 0 give 0.  Build with -fmad=false and
// without fast math: a contracted FMA or an approximate divide would flip
// pairs that sit at the threshold, and the mask must be bit-identical to the
// plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;

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

__global__ void __launch_bounds__(TB) nms_mask(
    const float4* __restrict__ boxes, int N, int NW, float thr,
    unsigned long long* __restrict__ mask) {
  __shared__ float4 cb[TB];
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * TB;
  const int row0 = blockIdx.y * TB;
  const float4* bb = boxes + (size_t)b * N;
  if (col0 + threadIdx.x < N) cb[threadIdx.x] = bb[col0 + threadIdx.x];
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i >= N) return;
  unsigned long long bits = 0ull;
  if (col0 + TB > i + 1) {  // the block holds some j > i
    const float4 a = bb[i];
    const float area_a = (a.z - a.x) * (a.w - a.y);
    const int ncol = min(TB, N - col0);
    for (int k = 0; k < ncol; ++k) {
      if (col0 + k > i && suppresses(a, area_a, cb[k], thr)) bits |= 1ull << k;
    }
  }
  mask[((size_t)b * N + i) * NW + blockIdx.x] = bits;
}

__global__ void nms_scan(const unsigned long long* __restrict__ mask, int N,
                         int NW, int rows_per_chunk, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long rows[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool scanner = threadIdx.x < 32;
  unsigned long long removed = 0ull;  // lane w holds word w of the removed set
  const unsigned long long* mb = mask + (size_t)b * N * NW;
  for (int r0 = 0; r0 < N; r0 += rows_per_chunk) {
    const int nrows = min(rows_per_chunk, N - r0);
    for (int e = threadIdx.x; e < nrows * NW; e += blockDim.x)
      rows[e] = mb[(size_t)r0 * NW + e];
    __syncthreads();
    if (scanner) {
      for (int i = r0; i < r0 + nrows; ++i) {
        const unsigned long long word =
            __shfl_sync(0xffffffffu, removed, i >> 6);
        const bool kept = !((word >> (i & 63)) & 1ull);
        if (kept && lane < NW) removed |= rows[(i - r0) * NW + lane];
        if (lane == 0) keep[(size_t)b * N + i] = kept ? 1 : 0;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [B,N,4] f32 contiguous; mask scratch [B,N,ceil(N/64)] u64;
// keep [B,N] u8.  N <= 2048 (one warp holds the removed set; checked by the
// Python wrapper).  Returns the first launch error (0 = cudaSuccess).
extern "C" int nms_keep_mask_fwd(const void* boxes, int B, int N, float thr,
                                 void* mask, void* keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NW = (N + TB - 1) / TB;
  cudaError_t e;
  nms_mask<<<dim3(NW, NW, B), TB, 0, st>>>(
      static_cast<const float4*>(boxes), N, NW, thr,
      static_cast<unsigned long long*>(mask));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int chunk_bytes = 48 * 1024;
  int rows_per_chunk = chunk_bytes / (NW * 8);
  if (rows_per_chunk > N) rows_per_chunk = N;
  nms_scan<<<B, 256, rows_per_chunk * NW * 8, st>>>(
      static_cast<const unsigned long long*>(mask), N, NW, rows_per_chunk,
      static_cast<uint8_t*>(keep));
  return cudaGetLastError();
}
