// Fused stem epilogue for Hopper (sm_90a): kernel B7.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/stem.py:gn_relu_maxpool
// (_gn_pool_kernel), called by fused_stem:
//     out[b, oy, ox, c] = max over the 3x3 window at (2*oy, 2*ox), TF-SAME,
//                         of relu(bf16(bf16(y * scale[b,c]) + shift[b,c]))
// with y [B,H,W,C] bf16 NHWC (the stem conv's output) and bf16 per-image
// scale/shift.  Padding is zero, which equals the -inf of max_pool_same
// here: every value is a relu output (>= 0) and no window is all padding.
// There is no sum, so the kernel equals its plain version bitwise.
//
// What bounds it here: one read of y and one write of the pooled output
// (a quarter of y), a few operations per byte: device memory.  The TPU
// kernel turned the stride-2 taps into even/odd row pairs because Mosaic
// dislikes strided slices; on the card each thread computes one output
// pixel's eight channels from its nine 16-byte taps, which neighbouring
// threads share through L1/L2, so y is read from device memory about once.
// Compile with -fmad=false: the affine's multiply and add each round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace b7_gn_relu_maxpool {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rnd(float v) { return __float2bfloat16_rn(v); }

__global__ void gn_relu_maxpool(const bf16* __restrict__ y,
                                const bf16* __restrict__ scale,
                                const bf16* __restrict__ shift,
                                bf16* __restrict__ out, int H, int W, int C,
                                int Ho, int Wo, int pad_t, int pad_l,
                                size_t nvec) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const int c = (int)(e % C);
    const size_t pix = e / C;
    const int ox = (int)(pix % Wo);
    const size_t t = pix / Wo;
    const int oy = (int)(t % Ho);
    const int b = (int)(t / Ho);
    const size_t bc = (size_t)b * C + c;
    const uint4 sv = *reinterpret_cast<const uint4*>(scale + bc);
    const uint4 hv = *reinterpret_cast<const uint4*>(shift + bc);
    const bf16* se = reinterpret_cast<const bf16*>(&sv);
    const bf16* he = reinterpret_cast<const bf16*>(&hv);
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = oy * 2 + dy - pad_t;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = ox * 2 + dx - pad_l;
        if (ix < 0 || ix >= W) continue;
        const uint4 yv = *reinterpret_cast<const uint4*>(
            y + (((size_t)b * H + iy) * W + ix) * C + c);
        const bf16* ye = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = f32(rnd(f32(ye[j]) * f32(se[j])));
          const float v = f32(rnd(p + f32(he[j])));
          m[j] = fmaxf(m[j], v);
        }
      }
    }
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) oe[j] = rnd(m[j]);
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

}  // namespace b7_gn_relu_maxpool
}  // namespace

using namespace b7_gn_relu_maxpool;

// y [B,H,W,C], scale/shift [B,C], out [B,Ho,Wo,C], all bf16; C % 8 == 0
// (checked by the Python wrapper).  Returns the launch error.
extern "C" int gn_relu_maxpool_fwd(const void* y, const void* scale,
                                   const void* shift, void* out, int B, int H,
                                   int W, int C, int Ho, int Wo, int pad_t,
                                   int pad_l, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nvec = (size_t)B * Ho * Wo * C / 8;
  const size_t want = (nvec + 255) / 256;
  const int blocks = (int)(want < 65535 ? (want > 0 ? want : 1) : 65535);
  gn_relu_maxpool<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), static_cast<bf16*>(out), H, W, C, Ho,
      Wo, pad_t, pad_l, nvec);
  return cudaGetLastError();
}
