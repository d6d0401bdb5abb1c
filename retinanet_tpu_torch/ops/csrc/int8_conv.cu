// int8 convolution for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/int8_conv.py:int8_conv3x3
// (_conv_kernel) and serves the quantized model path that the JAX package
// runs through XLA (retinanet_tpu/models/layers.py:_int8_conv):
//     s_x = max(max|x|, 1e-8) / 127                 one fp32 scalar
//     x_q = clip(rint(x / s_x), -127, 127)
//     acc = sum_k x_q * w_q  (s8 x s8 -> s32, exact, TF-SAME zero padding)
//     y   = float(acc) * (s_x * s_w[f])  [+ bias[f]] [relu] -> out dtype
// for 1x1 and 3x3 windows at stride 1 or 2, C and F any multiple of 8.  The
// weights arrive quantized (w_q [Fp, k*k*Cp] tap-major, s_w [F] fp32, with
// Cp and Fp C and F rounded up to multiples of 64 and the padding zero; a
// grouped conv arrives as its block-diagonal dense kernel): the wrapper
// quantizes them once per parameter version, so serving launches three
// kernels per conv:
//   1. int8_amax: max|x| over the whole tensor, 16 bytes per load; each CTA
//      writes its maximum, and the last CTA to finish (an atomic ticket)
//      reduces them and writes s_x = max(amax, 1e-8) / 127 with a true
//      division.  Max is exact, so the result does not depend on order.
//      |x| compares as the unsigned bit pattern of a non-negative float.
//   2. int8_quantize: x -> x_q [B,H,W,Cp], one 16-byte chunk of x_q per
//      thread (a 2-D block: chunk by pixel), zero past C, so that the
//      GEMM's 64-byte half rows stay inside one tap (where C < Cp the
//      padding multiplies x_q's bytes by Cp / C).  The quotient is
//      the correctly rounded x / s_x, as the model path divides (the TPU
//      kernel multiplied by 1/s_x): x * (1/s_x) gives the same integer
//      except within ~3e-5 of a half-integer, where the kernel divides
//      (__fdiv_rn); rintf rounds half to even like jnp.round.  A division
//      per element would make this pass compute-bound.
//   3. int8_conv_gemm: implicit GEMM, M = B*Ho*Wo output pixels (all images
//      in one M), N = F, K = k*k*C tap-major, through hopper_gemm.cuh's
//      mainloop: 128 x BN tiles (BN = 64, 128 or 256 by F, the grid and K:
//      the 64-wide res2 convs fill their tile, small grids take narrow
//      tiles), a ring of three cp.async stages of 128 bytes of K in the
//      128-byte swizzle (fewer where K is shorter, so more CTAs fit an SM),
//      zero-filled outside the image (src-size 0), and int8 wgmma
//      m64nBNk32 on two warpgroups.  Both operands are K-major (x_q is
//      NHWC, w_q tap-major), the layout int8 wgmma takes, so wgmma fits
//      every shape.  Fp / BN tiles cover F; the columns past F are computed
//      from zero weights and not stored.  The epilogue converts acc with
//      __int2float_rn (|acc| reaches 127^2 * 9 * 512 > 2^24, so it rounds,
//      as XLA's does), multiplies by the fp32 product s_x*s_w[f], adds the
//      bias in fp32, applies relu and casts into a shared-memory tile,
//      written out in 16-byte pieces below F.  s32 sums are exact in any
//      order, so the result
//      equals the plain version (float64 sums of the same integers, same
//      fp32 epilogue) bitwise.
//
// What bounds it: at 640 px the quantized convs are K = C..9C GEMMs over
// B*Ho*Wo rows, ~39 GMAC per image, 0.04 ms per image at 1,979 TOPS, so
// reading x (bf16) and writing y (bf16) sets the bound for nearly all of
// them.  Three passes read x: int8_amax (2 bytes per element), the
// quantize pass (2, and 1 written) and the GEMM (1, up to nine times for a
// 3x3 conv, from L2).  Quantizing inside the GEMM's A producer instead,
// for the 1x1 convs where each x element is read once per output tile, is
// slower: loading bf16 x through registers and dividing there holds the
// GEMM's pipeline up.  At batch 8 most convs take a few tens of
// microseconds, so the host's three launches per conv set the pace of a
// whole conv.  Compile with -fmad=false (the
// epilogue's multiply and add each round).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {
namespace b6_int8_conv {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int AMAX_THREADS = 256;
constexpr int AMAX_MAX_CTAS = 1024;  // the wrapper's partial buffer

// max|x| of x (n16 groups of 16 bytes) -> s_x.  partial holds one word per
// CTA; ticket is 0 on entry and is left 0 by the last CTA.
template <typename T>
__global__ void __launch_bounds__(AMAX_THREADS) int8_amax(
    const T* __restrict__ x, size_t n16, unsigned* __restrict__ partial,
    unsigned* __restrict__ ticket, float* __restrict__ sx) {
  __shared__ unsigned wmax[AMAX_THREADS / 32];
  __shared__ bool last;
  unsigned m = 0;
  for (size_t i = blockIdx.x * (size_t)AMAX_THREADS + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * AMAX_THREADS) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 2) {
        m = max(m, max(w[j] & 0x7fffu, (w[j] >> 16) & 0x7fffu));
      } else {
        m = max(m, w[j] & 0x7fffffffu);
      }
    }
  }
  if constexpr (sizeof(T) == 2) m <<= 16;  // bf16 bits -> fp32 bits
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned a = 0;
    for (int w = 0; w < AMAX_THREADS / 32; ++w) a = max(a, wmax[w]);
    partial[blockIdx.x] = a;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  unsigned a = 0;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += AMAX_THREADS)
    a = max(a, (unsigned)*reinterpret_cast<volatile unsigned*>(partial + i));
  a = __reduce_max_sync(0xffffffffu, a);
  __syncthreads();
  if (lane == 0) wmax[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned b = 0;
    for (int w = 0; w < AMAX_THREADS / 32; ++w) b = max(b, wmax[w]);
    *sx = __fdiv_rn(fmaxf(__uint_as_float(b), 1e-8f), 127.f);
    *ticket = 0u;
  }
}

// clip(rint(v / s), -127, 127) with v / s the correctly rounded quotient
// (rs = 1/s, rounded).  t = v * rs lies within 2^-23 |v / s| of v / s, and
// the rounded quotient within 2^-24 |v / s|: below |v / s| = 256 both are
// within 3.1e-5 of each other, so they round to the same integer unless
// v / s lies that close to a half-integer, where the true division decides
// (above 256 both clip to the same end).  Bitwise the quotient's result at
// the cost of a multiply for all but ~1e-4 of the elements.
__device__ __forceinline__ int8_t quantize(float v, float s, float rs) {
  float t = __fmul_rn(v, rs);
  if (fabsf(t - floorf(t) - 0.5f) < 1e-4f) t = __fdiv_rn(v, s);
  const float r = fminf(fmaxf(rintf(t), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// x [P, C] -> x_q [P, Cp] for C % 8 == 0 and C <= Cp, zero in channels
// C..Cp-1.  A thread writes one 16-byte chunk of x_q (16 channels):
// threadIdx.x picks the chunk within a pixel, threadIdx.y and the block the
// pixel, so that no index is divided.  Both 8-channel halves are loaded
// before either is quantized (a half past C loads zeros, which quantize to
// 0), so that a thread has all its loads in flight at once.
template <typename T>
__global__ void int8_quantize(const T* __restrict__ x,
                              const float* __restrict__ sx,
                              int8_t* __restrict__ q, size_t pixels, int C,
                              int Cp) {
  constexpr int LOADS = 8 * sizeof(T) / 16;  // 16-byte loads a half
  const float s = *sx;
  const float rs = __fdiv_rn(1.f, s);
  const int chunks = Cp / 16;
  for (size_t p = blockIdx.x * (size_t)blockDim.y + threadIdx.y; p < pixels;
       p += (size_t)gridDim.x * blockDim.y) {
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
      uint4 raw[2 * LOADS];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = k * 16 + half * 8;
#pragma unroll
        for (int j = 0; j < LOADS; ++j)
          raw[half * LOADS + j] =
              c < C ? reinterpret_cast<const uint4*>(x + p * C + c)[j]
                    : make_uint4(0u, 0u, 0u, 0u);
      }
      const T* e = reinterpret_cast<const T*>(raw);
      uint4 out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v;
        if constexpr (sizeof(T) == 2) {
          v = __bfloat162float(e[j]);
        } else {
          v = e[j];
        }
        o[j] = quantize(v, s, rs);
      }
      reinterpret_cast<uint4*>(q + p * Cp)[k] = out;
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// out[p, n] = epi(sum_k x_q[tap(p, k)] * w_q[n, k]) over M = B*Ho*Wo rows
// and the first F columns; C is x_q's padded channel count (a multiple of
// 64) and w_q has a row for every column of the grid's tiles.  EDGE: BN
// does not divide F, so the last N tile reads no s_w or bias and stores
// nothing past F (the instance without it keeps the epilogue free of
// those tests).
template <int BN, int KS, typename OutT, bool EDGE>
__global__ void __launch_bounds__(CONV_THREADS) int8_conv_gemm(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, OutT* __restrict__ out, int M, int H,
    int W, int C, int F, int stride, int pad_t, int pad_l, int Ho, int Wo,
    int has_bias, int relu) {
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  const int tid = threadIdx.x;
  // Tile t = x + y * gridDim.x, N tiles fastest, so that neighbouring CTAs
  // share their rows of x_q: a (N tiles, M tiles) grid, or a flat one
  // where the M tiles pass y's 65535 (8.4M output pixels, fewer than a
  // 320x320 plane at batch 128).
  const int ntiles = (F + BN - 1) / BN;
  const unsigned t = blockIdx.x + blockIdx.y * gridDim.x;
  const int n0 = (int)(t % ntiles) * BN;
  const int m0 = (int)(t / ntiles) * CONV_BM;
  const int K = KS * KS * C;
  const float s = *sx;

  ConvRow row;
  {
    const int p = m0 + (tid >> 1);
    row.valid = p < M;
    const int pp = row.valid ? p : 0;
    const int hwo = Ho * Wo;
    const int b = pp / hwo, rem = pp - b * hwo;
    const int oy = rem / Wo, ox = rem - oy * Wo;
    row.img = reinterpret_cast<const char*>(xq) + (size_t)b * H * W * C;
    row.iy0 = oy * stride - pad_t;
    row.ix0 = ox * stride - pad_l;
  }
  const char* wt = reinterpret_cast<const char*>(wq) + (size_t)n0 * K;
  int acc[BN / 2];
  const CopyA<KS> pa = {row, H, W, C, K};
  conv_mainloop<BN>(acc, smem, pa, wt, K);

  // Epilogue: dequantize into a [128][BN] tile in shared memory (rows
  // padded by 16 bytes: conflict-free), then write whole rows out in
  // 16-byte pieces.
  constexpr int PITCH = BN * sizeof(OutT) + 16;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    OutT* trow = reinterpret_cast<OutT*>(smem + acc_row(tid, half) * PITCH);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = acc_col(tid, j);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + col + e;  // past F: computed, never stored
        const bool in = !EDGE || n < F;
        float y = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]),
                            __fmul_rn(s, in ? sw[n] : 0.f));
        if (has_bias && in) y = __fadd_rn(y, bias[n]);
        if (relu) y = fmaxf(y, 0.f);
        v[e] = y;
      }
      store2(trow + col, v[0], v[1]);
    }
  }
  __syncthreads();
  constexpr int CH = BN * sizeof(OutT) / 16;  // 16-byte pieces per row
  constexpr int PER = 16 / sizeof(OutT);      // columns per piece
  for (int c = tid; c < CONV_BM * CH; c += CONV_THREADS) {
    const int r = c / CH, q = c - r * CH;
    // F % 8 == 0: a piece lies wholly below F or wholly past it.
    if (m0 + r < M && (!EDGE || n0 + (q + 1) * PER <= F))
      reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * F + n0)[q] =
          *reinterpret_cast<const uint4*>(smem + r * PITCH + q * 16);
  }
}

// Dynamic shared memory of an int8_conv_gemm instance: its ring for K =
// kb bytes, or the epilogue's tile where that is larger.
template <int BN, typename OutT>
int gemm_smem_bytes(int kb) {
  const int tile = CONV_BM * (BN * (int)sizeof(OutT) + 16) + 1024;
  const int ring = conv_smem_bytes<BN>(kb);
  return ring > tile ? ring : tile;
}

template <int BN, int KS, typename OutT, bool EDGE>
cudaError_t launch_conv(const int8_t* xq, const int8_t* wq, const float* sx,
                        const float* sw, const float* bias, void* out, int B,
                        int H, int W, int C, int F, int stride, int pad_t,
                        int pad_l, int Ho, int Wo, int has_bias, int relu,
                        cudaStream_t st) {
  auto kernel = int8_conv_gemm<BN, KS, OutT, EDGE>;
  static bool sized[MAX_DEVICES] = {};
  const cudaError_t e =
      allow_smem(kernel, gemm_smem_bytes<BN, OutT>(1 << 30), sized);
  if (e != cudaSuccess) return e;
  const int M = B * Ho * Wo;
  const unsigned ntiles = (F + BN - 1) / BN;
  const unsigned mtiles = (M + CONV_BM - 1) / CONV_BM;
  const dim3 grid = mtiles <= 65535 ? dim3(ntiles, mtiles)
                                    : dim3(ntiles * mtiles);
  kernel<<<grid, CONV_THREADS, gemm_smem_bytes<BN, OutT>(KS * KS * C),
           st>>>(
      xq, wq, sx, sw, bias, static_cast<OutT*>(out), M, H, W, C, F, stride,
      pad_t, pad_l, Ho, Wo, has_bias, relu);
  return cudaGetLastError();
}

template <int BN, typename OutT>
cudaError_t launch_conv_ks(int ks, const int8_t* xq, const int8_t* wq,
                           const float* sx, const float* sw,
                           const float* bias, void* out, int B, int H, int W,
                           int C, int F, int stride, int pad_t, int pad_l,
                           int Ho, int Wo, int has_bias, int relu,
                           cudaStream_t st) {
  const bool edge = F % BN != 0;
  if (ks == 1 && edge)
    return launch_conv<BN, 1, OutT, true>(xq, wq, sx, sw, bias, out, B, H, W,
                                          C, F, stride, pad_t, pad_l, Ho, Wo,
                                          has_bias, relu, st);
  if (ks == 1)
    return launch_conv<BN, 1, OutT, false>(xq, wq, sx, sw, bias, out, B, H,
                                           W, C, F, stride, pad_t, pad_l, Ho,
                                           Wo, has_bias, relu, st);
  if (edge)
    return launch_conv<BN, 3, OutT, true>(xq, wq, sx, sw, bias, out, B, H, W,
                                          C, F, stride, pad_t, pad_l, Ho, Wo,
                                          has_bias, relu, st);
  return launch_conv<BN, 3, OutT, false>(xq, wq, sx, sw, bias, out, B, H, W,
                                         C, F, stride, pad_t, pad_l, Ho, Wo,
                                         has_bias, relu, st);
}

template <typename OutT>
cudaError_t launch_conv_bn(int bn, int ks, const int8_t* xq,
                           const int8_t* wq, const float* sx, const float* sw,
                           const float* bias, void* out, int B, int H, int W,
                           int C, int F, int stride, int pad_t, int pad_l,
                           int Ho, int Wo, int has_bias, int relu,
                           cudaStream_t st) {
  if (bn == 64)
    return launch_conv_ks<64, OutT>(ks, xq, wq, sx, sw, bias, out, B, H, W, C,
                                    F, stride, pad_t, pad_l, Ho, Wo, has_bias,
                                    relu, st);
  if (bn == 128)
    return launch_conv_ks<128, OutT>(ks, xq, wq, sx, sw, bias, out, B, H, W,
                                     C, F, stride, pad_t, pad_l, Ho, Wo,
                                     has_bias, relu, st);
  return launch_conv_ks<256, OutT>(ks, xq, wq, sx, sw, bias, out, B, H, W, C,
                                   F, stride, pad_t, pad_l, Ho, Wo, has_bias,
                                   relu, st);
}

int grid_for(size_t n16, int per_cta, int most) {
  const size_t want = (n16 + per_cta - 1) / per_cta;
  return (int)(want < (size_t)most ? (want > 0 ? want : 1) : most);
}

}  // namespace b6_int8_conv
}  // namespace

using namespace b6_int8_conv;

// One int8 convolution, its three launches in order; `which` selects them
// (bit 0 int8_amax, bit 1 int8_quantize, bit 2 int8_conv_gemm), so that a
// caller can time the GEMM alone.
//   x [B,H,W,C] bf16 (in_code 0) or fp32 (1); xq: B*H*W*Cp s8 of scratch
//   (Cp = C rounded up to a multiple of 64, Fp likewise);
//   scratch: AMAX_MAX_CTAS + 2 words: per-CTA maxima, the ticket (0 on
//   entry, left 0), then s_x (fp32);
//   wq [Fp, ks*ks*Cp] s8 (tap-major k, zero past F and C); sw [F] and
//   bias [F] fp32 (bias read only when has_bias; may be null otherwise);
//   out [B,Ho,Wo,F] bf16 (out_code 0) or fp32 (1); bn in {64, 128, 256}
//   divides Fp;
//   geom: in_code, B, H, W, C, F, ks, stride, pad_t, pad_l, Ho, Wo,
//   out_code (13 ints, one array per conv geometry, kept by the caller).
// Requires C % 8 == 0 and F % 8 == 0 (checked by the Python wrapper).
// Returns the first launch error (0 = cudaSuccess).
extern "C" int int8_conv_forward(const void* x, void* xq, void* scratch,
                                 const void* wq, const void* sw,
                                 const void* bias, void* out,
                                 const int* geom, int has_bias, int relu,
                                 int bn, int which, void* stream) {
  const int in_code = geom[0], B = geom[1], H = geom[2], W = geom[3],
            C = geom[4], F = geom[5], ks = geom[6], stride = geom[7],
            pad_t = geom[8], pad_l = geom[9], Ho = geom[10], Wo = geom[11],
            out_code = geom[12];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* partial = static_cast<unsigned*>(scratch);
  unsigned* ticket = partial + AMAX_MAX_CTAS;
  float* sx = reinterpret_cast<float*>(ticket + 1);
  int8_t* q = static_cast<int8_t*>(xq);
  const int Cp = (C + 63) / 64 * 64;
  const size_t n = (size_t)B * H * W * C;
  cudaError_t e;
  if (which & 1) {
    const size_t n16 = n * (in_code == 0 ? 2 : 4) / 16;
    const int blocks = grid_for(n16, AMAX_THREADS * 4, AMAX_MAX_CTAS);
    if (in_code == 0)
      int8_amax<bf16><<<blocks, AMAX_THREADS, 0, st>>>(
          static_cast<const bf16*>(x), n16, partial, ticket, sx);
    else
      int8_amax<float><<<blocks, AMAX_THREADS, 0, st>>>(
          static_cast<const float*>(x), n16, partial, ticket, sx);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (which & 2) {
    const size_t pixels = (size_t)B * H * W;
    const int bx = Cp / 16 < 256 ? Cp / 16 : 256;
    const dim3 block(bx, 256 / bx);
    const int blocks = grid_for(pixels, block.y, 65535);
    if (in_code == 0)
      int8_quantize<bf16><<<blocks, block, 0, st>>>(
          static_cast<const bf16*>(x), sx, q, pixels, C, Cp);
    else
      int8_quantize<float><<<blocks, block, 0, st>>>(
          static_cast<const float*>(x), sx, q, pixels, C, Cp);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (which & 4) {
    const int8_t* w8 = static_cast<const int8_t*>(wq);
    const float* w = static_cast<const float*>(sw);
    const float* bi = static_cast<const float*>(bias);
    if (out_code == 0)
      return launch_conv_bn<bf16>(bn, ks, q, w8, sx, w, bi, out, B, H, W, Cp,
                                  F, stride, pad_t, pad_l, Ho, Wo, has_bias,
                                  relu, st);
    return launch_conv_bn<float>(bn, ks, q, w8, sx, w, bi, out, B, H, W, Cp,
                                 F, stride, pad_t, pad_l, Ho, Wo, has_bias,
                                 relu, st);
  }
  return cudaSuccess;
}
