// Fused stride-1 identity bottleneck for Hopper (sm_90a).
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/bottleneck.py:
// fused_bottleneck (_block_kernel / _strip_kernel, helpers _gn_partial_stats,
// _gn_scale_shift, _gn_act):
//     out = relu(GN3(conv1x1_3(relu(GN2(conv3x3(relu(GN1(conv1x1_1(x))))))) + x)
// with x [B,H,W,C] bf16 NHWC, inner width F = C/4, one GN per image.
//
// Semantics kept from the TPU kernel: every conv accumulates in fp32 and is
// rounded once to bf16; GN moments are fp32 sums of those rounded values;
// per-channel scale = inv*gamma and shift = beta - mean*inv*gamma are rounded
// to bf16 and the affine runs in bf16 (each op rounds, as the plain PyTorch
// version does); the residual is added to the bf16 GN3 output.  conv2's SAME
// zeros live in the post-GN/relu domain: an out-of-image tap loads 0, never
// relu(shift).
//
// What bounds it here: at 640 px the blocks are small GEMMs (K = C, 9F or F)
// over B*H*W rows whose GN statistics are full-image reductions sitting
// between one conv and the next.  The TPU kernel kept the whole image in
// 100 MB of VMEM; an SM has 227 KB, and CTAs run in parallel in no order.
// So the block is split at its three GN reductions into four launches that
// each stream their operand once:
//   1. conv1 GEMM -> bf16 y1, per-CTA (sum, sum^2) partials; GN1 finalize
//   2. conv2 implicit GEMM, GN1 affine+relu applied to A once it lands in
//      shared memory (prologue) -> bf16 y2, partials; GN2 finalize
//   3. conv3 GEMM with the GN2 prologue -> bf16 y3, partials; GN3 finalize
//   4. elementwise GN3 affine + residual + relu
// The GEMMs (fwd_gemm, bottleneck_common.cuh) run hopper_gemm.cuh's
// mainloop: 128 x BN tiles of one image (BN = 128, or 64 where 128 does
// not divide N), a ring of three 16-byte cp.async stages in the 128-byte
// swizzle, zero-filled outside the image, bf16 wgmma m64nBNk16 on two
// warpgroups.  Each thread maps the 64 bytes of A it copied through the
// previous GN (scale/shift staged in shared memory once per CTA) before
// the barrier that hands the stage to wgmma; chunks zero-filled outside the
// image stay 0.  The epilogue rounds once, stages the tile in shared
// memory, stores 16-byte rows, and writes per-CTA per-group partials
// summed in a fixed order; the image's last CTA (an atomic ticket it
// resets) reduces them in a fixed order and writes the bf16 scale/shift
// (and, for B3 and return_forward, the fp32 mean/inv-std).  No float
// atomics: repeated runs are bitwise equal.  Rows past H*W (res4's 1600
// and res5's 400 are not multiples of 128) enter neither the stores nor
// the statistics.  The split moves ~12*B*H*W*C bytes per block (x twice,
// y1..y3 written and read, out), ~2.2x the x-in/out bound.  B3's recompute
// (bottleneck_bwd.cu) launches these same kernels, so its relu masks are
// B1's bit for bit.  Compile with -fmad=false: the bf16 affine must round
// after the multiply, as the plain version does.

#define BOTTLENECK_NS b1_fused_bottleneck
#include "bottleneck_common.cuh"

namespace {
namespace BOTTLENECK_NS {

// out = relu(bf16(GN3 affine of y) + x), eight channels per thread.
__global__ void gn_residual_relu(const bf16* __restrict__ y,
                                 const bf16* __restrict__ x,
                                 const bf16* __restrict__ scale,
                                 const bf16* __restrict__ shift,
                                 bf16* __restrict__ out, int HW, int C,
                                 size_t nvec) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const size_t b = e / ((size_t)HW * C);
    const int c = (int)(e % C);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + e);
    const uint4 sv = *reinterpret_cast<const uint4*>(scale + b * C + c);
    const uint4 hv = *reinterpret_cast<const uint4*>(shift + b * C + c);
    const bf16* ye = reinterpret_cast<const bf16*>(&yv);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const bf16* se = reinterpret_cast<const bf16*>(&sv);
    const bf16* he = reinterpret_cast<const bf16*>(&hv);
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = f32(rnd(affine(ye[j], se[j], he[j]) + f32(xe[j])));
      oe[j] = rnd(fmaxf(v, 0.f));
    }
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

}  // namespace BOTTLENECK_NS
}  // namespace

using namespace BOTTLENECK_NS;

// x, out: [B,H,W,C] bf16.  w1 [F,C], w2 [F,9F] (tap-major k), w3 [C,F] bf16.
// g*/b*: fp32 GN affines.  Scratch: y1, y2 [B,H*W,F] and y3 [B,H*W,C] bf16;
// part [B, ceil(H*W/128), 2, max(G1, G3)] fp32; ss [6, B, C] bf16
// scale/shift; tickets [B] words, 0 on entry (left 0).  mv [6, B, C] fp32
// receives each GN's mean and inv-std (mean1, inv1, mean2, ..., each
// [B, F or C] packed at the start of its row), or is null.  Requires C % 64
// == 0, F % 64 == 0, F <= 512 and GN groups of C/G3 and F/G1 channels that
// divide 64 (checked by the Python wrapper).  Returns the
// first launch error (0 = cudaSuccess).
extern "C" int fused_bottleneck_fwd(
    const void* x, const void* w1, const void* g1, const void* b1,
    const void* w2, const void* g2, const void* b2, const void* w3,
    const void* g3, const void* b3, void* y1, void* y2, void* y3, void* part,
    void* ss, void* mv, void* tickets, void* out, int B, int H, int W, int C,
    int F, int G1, int G3, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  bf16* s = static_cast<bf16*>(ss);
  const size_t bc = (size_t)B * C;
  bf16 *sc1 = s, *sh1 = s + bc, *sc2 = s + 2 * bc, *sh2 = s + 3 * bc,
       *sc3 = s + 4 * bc, *sh3 = s + 5 * bc;
  float* m = static_cast<float*>(mv);
  auto stat = [&](int i) { return m != nullptr ? m + i * bc : nullptr; };
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  bf16 *Y1 = static_cast<bf16*>(y1), *Y2 = static_cast<bf16*>(y2),
       *Y3 = static_cast<bf16*>(y3);
  const GnOut gn1 = {0, F, G1, static_cast<const float*>(g1),
                     static_cast<const float*>(b1), sc1, sh1, stat(0),
                     stat(1)};
  const GnOut gn2 = {0, F, G1, static_cast<const float*>(g2),
                     static_cast<const float*>(b2), sc2, sh2, stat(2),
                     stat(3)};
  const GnOut gn3 = {0, C, G3, static_cast<const float*>(g3),
                     static_cast<const float*>(b3), sc3, sh3, stat(4),
                     stat(5)};
  cudaError_t e;
  if ((e = fwd_conv<1, false>(
           fwd_args(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                    nullptr, nullptr, Y1, pt, tk, H, W, C, F, eps, gn1),
           B, st)) != cudaSuccess)
    return e;
  if ((e = fwd_conv<9, true>(
           fwd_args(Y1, static_cast<const bf16*>(w2), sc1, sh1, Y2, pt, tk,
                    H, W, F, F, eps, gn2),
           B, st)) != cudaSuccess)
    return e;
  if ((e = fwd_conv<1, true>(
           fwd_args(Y2, static_cast<const bf16*>(w3), sc2, sh2, Y3, pt, tk,
                    H, W, F, C, eps, gn3),
           B, st)) != cudaSuccess)
    return e;

  const size_t nvec = (size_t)B * HW * C / 8;
  const int blocks = (int)((nvec + 255) / 256 < 65535 ? (nvec + 255) / 256
                                                      : 65535);
  gn_residual_relu<<<blocks, 256, 0, st>>>(Y3, static_cast<const bf16*>(x),
                                           sc3, sh3, static_cast<bf16*>(out),
                                           HW, C, nvec);
  return cudaGetLastError();
}
