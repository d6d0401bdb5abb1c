// Fused stride-1 projection bottleneck for Hopper (sm_90a): kernel B5.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/bottleneck.py:
// fused_bottleneck_proj (_proj_strip_kernel), the serving block res2 b0:
//     out = relu(GN3(conv1x1_3(a2)) + GNp(conv1x1_p(x)))
//     a2  = relu(GN2(conv3x3(relu(GN1(conv1x1_1(x))))))
// with x [B,H,W,Cin] bf16 NHWC, inner width F, output width C (at 640 px:
// [B,160,160,64] -> 256, F = 64).
//
// Rounding points, those of _proj_strip_kernel and of the unfused block:
// every conv output (yp included) rounds once to bf16; GN moments are fp32
// sums of the rounded values; scale and shift round to bf16 and each affine
// runs in bf16 (multiply rounds, add rounds); the residual sum
// GN3(y3) + GNp(yp) rounds to bf16 before the relu.
//
// What bounds it here: the same as B1 (bottleneck.cu), whose design and
// device code (bottleneck_common.cuh's fwd_gemm on hopper_gemm.cuh's wgmma
// mainloop) it reuses: the block is split at its GN reductions into four
// launches, each GEMM with a statistics epilogue whose image's last CTA
// finalizes the GN, and a GN-affine+relu prologue applied to A in shared
// memory, so every intermediate is streamed once and repeated runs are
// bitwise equal.  conv1 and the projection share their input x, so they
// are one GEMM over N = F + C columns of the stacked weights [w1; wp]
// (no tile straddles the two): columns below F go to y1,
// the rest to yp, each with its own statistics and its own finalize (GN1,
// GNp).  Then conv2 and conv3 with their prologues, and the last
// elementwise pass applies GNp's affine to yp in place of B1's identity
// read of x.  At 640 px the block is bytes-bound (34 MB in and out per
// image against ~6 GFLOP), and its largest term is the three [B,H,W,C]
// planes (y3, yp, out) this split writes.  Compile with -fmad=false: the
// bf16 affines must round after the multiply.

#define BOTTLENECK_NS b5_fused_bottleneck_proj
#include "bottleneck_common.cuh"

namespace {
namespace BOTTLENECK_NS {

// out = relu(bf16(GN3 affine of y3 + GNp affine of yp)), eight channels
// per thread.
__global__ void gn_proj_residual_relu(const bf16* __restrict__ y3,
                                      const bf16* __restrict__ yp,
                                      const bf16* __restrict__ sc3,
                                      const bf16* __restrict__ sh3,
                                      const bf16* __restrict__ scp,
                                      const bf16* __restrict__ shp,
                                      bf16* __restrict__ out, int HW, int C,
                                      size_t nvec) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const size_t bc = (e / ((size_t)HW * C)) * C + (e % C);
    const uint4 yv = *reinterpret_cast<const uint4*>(y3 + e);
    const uint4 pv = *reinterpret_cast<const uint4*>(yp + e);
    const uint4 s3 = *reinterpret_cast<const uint4*>(sc3 + bc);
    const uint4 h3 = *reinterpret_cast<const uint4*>(sh3 + bc);
    const uint4 sp = *reinterpret_cast<const uint4*>(scp + bc);
    const uint4 hp = *reinterpret_cast<const uint4*>(shp + bc);
    const bf16* ye = reinterpret_cast<const bf16*>(&yv);
    const bf16* pe = reinterpret_cast<const bf16*>(&pv);
    const bf16* s3e = reinterpret_cast<const bf16*>(&s3);
    const bf16* h3e = reinterpret_cast<const bf16*>(&h3);
    const bf16* spe = reinterpret_cast<const bf16*>(&sp);
    const bf16* hpe = reinterpret_cast<const bf16*>(&hp);
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = f32(rnd(affine(ye[j], s3e[j], h3e[j]) +
                              affine(pe[j], spe[j], hpe[j])));
      oe[j] = rnd(fmaxf(v, 0.f));
    }
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

}  // namespace BOTTLENECK_NS
}  // namespace

using namespace BOTTLENECK_NS;

// x [B,H,W,Cin], out [B,H,W,C] bf16.  w1p [F+C, Cin] the stacked conv1 and
// projection weights [w1; wp], w2 [F,9F] (tap-major k), w3 [C,F] bf16; g*/b*
// fp32 GN affines.  Scratch: y1, y2 [B,H*W,F] and y3, yp [B,H*W,C] bf16;
// part [B, ceil(H*W/128), 2, G1 + G3] fp32; ss [8, B, C] bf16
// scale/shift; tickets [B] words, 0 on entry (left 0).  Requires Cin, F, C
// % 64 == 0, F <= 512 and GN groups of C/G3 and F/G1 channels that divide
// 64 (checked by the Python wrapper).  Returns the
// first launch error (0 = cudaSuccess).
extern "C" int fused_bottleneck_proj_fwd(
    const void* x, const void* w1p, const void* g1, const void* b1,
    const void* w2, const void* g2, const void* b2, const void* w3,
    const void* g3, const void* b3, const void* gp, const void* bp,
    void* y1, void* y2, void* y3, void* yp, void* part, void* ss,
    void* tickets, void* out, int B, int H, int W, int Cin, int C, int F,
    int G1, int G3, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  bf16* s = static_cast<bf16*>(ss);
  const size_t bc = (size_t)B * C;
  bf16 *sc1 = s, *sh1 = s + bc, *sc2 = s + 2 * bc, *sh2 = s + 3 * bc,
       *sc3 = s + 4 * bc, *sh3 = s + 5 * bc, *scp = s + 6 * bc,
       *shp = s + 7 * bc;
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  bf16 *Y1 = static_cast<bf16*>(y1), *Y2 = static_cast<bf16*>(y2),
       *Y3 = static_cast<bf16*>(y3), *YP = static_cast<bf16*>(yp);
  cudaError_t e;

  // conv1 and the projection: one GEMM over the F + C stacked columns.
  FwdArgs a = fwd_args(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1p), nullptr,
      nullptr, Y1, pt, tk, H, W, Cin, F + C, eps,
      {0, F, G1, static_cast<const float*>(g1), static_cast<const float*>(b1),
       sc1, sh1, nullptr, nullptr});
  a.y2 = YP;
  a.ldy = F;
  a.ngn = 2;
  a.gn[1] = {F, C, G3, static_cast<const float*>(gp),
             static_cast<const float*>(bp), scp, shp, nullptr, nullptr};
  if ((e = fwd_conv<1, false>(a, B, st)) != cudaSuccess) return e;
  if ((e = fwd_conv<9, true>(
           fwd_args(Y1, static_cast<const bf16*>(w2), sc1, sh1, Y2, pt, tk,
                    H, W, F, F, eps,
                    {0, F, G1, static_cast<const float*>(g2),
                     static_cast<const float*>(b2), sc2, sh2, nullptr,
                     nullptr}),
           B, st)) != cudaSuccess)
    return e;
  if ((e = fwd_conv<1, true>(
           fwd_args(Y2, static_cast<const bf16*>(w3), sc2, sh2, Y3, pt, tk,
                    H, W, F, C, eps,
                    {0, C, G3, static_cast<const float*>(g3),
                     static_cast<const float*>(b3), sc3, sh3, nullptr,
                     nullptr}),
           B, st)) != cudaSuccess)
    return e;

  const size_t nvec = (size_t)B * HW * C / 8;
  const int blocks = (int)((nvec + 255) / 256 < 65535 ? (nvec + 255) / 256
                                                      : 65535);
  gn_proj_residual_relu<<<blocks, 256, 0, st>>>(Y3, YP, sc3, sh3, scp, shp,
                                                static_cast<bf16*>(out), HW, C,
                                                nvec);
  return cudaGetLastError();
}
