// int8 convolution for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/int8_conv.py:int8_conv3x3
// (_conv_kernel) and serves the quantized model path that the JAX package
// runs through XLA (retinanet_tpu/models/layers.py:_int8_conv):
//     x_q = clip(rint(x / s_x), -127, 127)         s_x: one fp32 scalar
//     acc = sum_k x_q * w_q  (s8 x s8 -> s32, exact, TF-SAME zero padding)
//     y   = float(acc) * (s_x * s_w[f])  [+ bias[f]] [relu] -> out dtype
// for 1x1 and 3x3 windows at stride 1 or 2.
//
// Two launches:
//   1. int8_quantize: x (bf16 or fp32, NHWC) -> x_q (s8), 16 elements per
//      thread.  The division is a true IEEE division (__fdiv_rn), as the
//      model path divides (the TPU kernel multiplied by 1/s_x); rintf
//      rounds half to even like jnp.round and torch.round.  s_x is read
//      from device memory, so the host never waits for it.  This is the
//      TPU kernel's "quantize once" VMEM scratch, here in device memory.
//   2. int8_conv_gemm: implicit GEMM, M = B*Ho*Wo output pixels (one image
//      per grid z), N = F, K = k*k*C tap-major.  64x64 output tiles, 64-byte
//      K tiles in shared memory, mma.sync m16n8k32 s8 tiles accumulated in
//      s32.  C % 64 == 0 (checked by the wrapper), so a K tile never spans
//      two taps; an out-of-image tap loads quantized zeros.  The epilogue
//      converts acc with __int2float_rn (|acc| reaches 127^2 * 9 * 512 >
//      2^24, so the conversion rounds, as XLA's does), multiplies by the
//      fp32 product s_x*s_w[f], adds the bias in fp32, applies relu and
//      casts.  The plain PyTorch version convolves the same integers in
//      float64 and applies the same fp32 epilogue: the two agree bitwise.
//
// What bounds it here: at 640 px the quantized convs are K = C..9C GEMMs
// over B*H*W rows, ~39 GMAC per image, 0.04 ms per image at 1,979 TOPS, so
// reading x (bf16) and writing y (bf16) sets the bound for most of them.
// This first version stages both operands through registers into shared
// memory with one tile of prefetch; TMA/wgmma (int8 wgmma takes K = 32)
// and quantizing x inside the GEMM's producer are later work.  Compile
// with -fmad=false (the epilogue's multiply and add each round).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace b6_int8_conv {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;        // bytes (= s8 elements) of K per tile
constexpr int NT = 128;       // 4 warps, 2x2 over the 64x64 tile
constexpr int LDS = BK + 16;  // smem row pitch in bytes: 80, conflict-free

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// 16 elements per thread: n16 = n / 16 groups.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const float* __restrict__ sx,
                                int8_t* __restrict__ q, size_t n16) {
  const float s = *sx;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n16;
       i += (size_t)gridDim.x * blockDim.x) {
    constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
    uint4 raw[16 / PER];
#pragma unroll
    for (int j = 0; j < 16 / PER; ++j)
      raw[j] = reinterpret_cast<const uint4*>(x + i * 16)[j];
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
      o[j] = quantize(v, s);
    }
    reinterpret_cast<uint4*>(q)[i] = out;
  }
}

__device__ __forceinline__ void mma16832(int* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// out[b, p, n] = epi(sum_k x_q[b, tap(p, k)] * w_q[n, k]) for one image b.
template <int KS, typename OutT>
__global__ void __launch_bounds__(NT) int8_conv_gemm(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, OutT* __restrict__ out, int H, int W,
    int C, int F, int stride, int pad_t, int pad_l, int Ho, int Wo,
    int has_bias, int relu) {
  __shared__ __align__(16) int8_t As[BM][LDS];
  __shared__ __align__(16) int8_t Bs[BN][LDS];

  const int HWo = Ho * Wo;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int K = KS * KS * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  const int8_t* xb = xq + (size_t)b * H * W * C;

  // This thread's two 16-byte chunks of each 64x64-byte tile.
  int oy[2], ox[2];
  bool pval[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + ((tid + i * NT) >> 2);
    pval[i] = p < HWo;
    oy[i] = p / Wo;
    ox[i] = p - oy[i] * Wo;
  }

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / C;
    const int c0 = k0 - tap * C;
    const int dy = tap / KS, dx = tap % KS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, kc = (c & 3) * 16;
      const int iy = oy[i] * stride + dy - pad_t;
      const int ix = ox[i] * stride + dx - pad_l;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pval[i] && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = *reinterpret_cast<const uint4*>(xb + ((size_t)iy * W + ix) * C +
                                            c0 + kc);
      ra[i] = v;
      rb[i] = *reinterpret_cast<const uint4*>(wq + (size_t)(n0 + r) * K +
                                              k0 + kc);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, kc = (c & 3) * 16;
      *reinterpret_cast<uint4*>(&As[r][kc]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[r][kc]) = rb[i];
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mf][nf][j] = 0;

  const int KT = K / BK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const int r = wm * 32 + mf * 16 + g;
        af[mf][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 4 * t]);
        af[mf][1] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 4 * t]);
        af[mf][2] =
            *reinterpret_cast<const uint32_t*>(&As[r][ks + 16 + 4 * t]);
        af[mf][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = wn * 32 + nf * 8 + g;
        bfr[nf][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 4 * t]);
        bfr[nf][1] =
            *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) mma16832(acc[mf][nf], af[mf], bfr[nf]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      store();
      __syncthreads();
    }
  }

  const float s = *sx;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + wm * 32 + mf * 16 + g + half * 8;
      if (p >= HWo) continue;
      OutT* orow = out + ((size_t)b * HWo + p) * F;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int col = n0 + wn * 32 + nf * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float y = __fmul_rn(__int2float_rn(acc[mf][nf][half * 2 + j]),
                              __fmul_rn(s, sw[col + j]));
          if (has_bias) y = __fadd_rn(y, bias[col + j]);
          if (relu) y = fmaxf(y, 0.f);
          v[j] = y;
        }
        store2(orow + col, v[0], v[1]);
      }
    }
  }
}

template <int KS, typename OutT>
cudaError_t launch_conv(const int8_t* xq, const int8_t* wq, const float* sx,
                        const float* sw, const float* bias, void* out, int B,
                        int H, int W, int C, int F, int stride, int pad_t,
                        int pad_l, int Ho, int Wo, int has_bias, int relu,
                        cudaStream_t st) {
  const dim3 grid(F / BN, (Ho * Wo + BM - 1) / BM, B);
  int8_conv_gemm<KS, OutT><<<grid, NT, 0, st>>>(
      xq, wq, sx, sw, bias, static_cast<OutT*>(out), H, W, C, F, stride,
      pad_t, pad_l, Ho, Wo, has_bias, relu);
  return cudaGetLastError();
}

}  // namespace b6_int8_conv
}  // namespace

using namespace b6_int8_conv;

// x: n elements (n % 16 == 0), bf16 (in_code 0) or fp32 (1); sx: device
// fp32 scalar; q: n int8.  Returns the launch error (0 = cudaSuccess).
extern "C" int int8_quantize(const void* x, int in_code, const void* sx,
                             void* q, size_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n16 = n / 16;
  const size_t want = (n16 + 255) / 256;
  const int blocks = (int)(want < 65535 ? (want > 0 ? want : 1) : 65535);
  if (in_code == 0)
    quantize_kernel<bf16><<<blocks, 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(sx),
        static_cast<int8_t*>(q), n16);
  else
    quantize_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(sx),
        static_cast<int8_t*>(q), n16);
  return cudaGetLastError();
}

// xq [B,H,W,C] s8; wq [F, ks*ks*C] s8 (tap-major k); sx fp32 scalar, sw [F]
// and bias [F] fp32 (read only when has_bias; may be null otherwise); out
// [B,Ho,Wo,F] bf16 (out_code 0) or fp32 (1).
// Requires C % 64 == 0 and F % 64 == 0 (checked by the Python wrapper).
extern "C" int int8_conv_fwd(const void* xq, const void* wq, const void* sx,
                             const void* sw, const void* bias, void* out,
                             int B, int H, int W, int C, int F, int ks,
                             int stride, int pad_t, int pad_l, int Ho, int Wo,
                             int out_code, int has_bias, int relu,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(sx);
  const float* w = static_cast<const float*>(sw);
  const float* bi = static_cast<const float*>(bias);
  if (ks == 1 && out_code == 0)
    return launch_conv<1, bf16>(x8, w8, s, w, bi, out, B, H, W, C, F, stride,
                                pad_t, pad_l, Ho, Wo, has_bias, relu, st);
  if (ks == 1)
    return launch_conv<1, float>(x8, w8, s, w, bi, out, B, H, W, C, F, stride,
                                 pad_t, pad_l, Ho, Wo, has_bias, relu, st);
  if (out_code == 0)
    return launch_conv<3, bf16>(x8, w8, s, w, bi, out, B, H, W, C, F, stride,
                                pad_t, pad_l, Ho, Wo, has_bias, relu, st);
  return launch_conv<3, float>(x8, w8, s, w, bi, out, B, H, W, C, F, stride,
                               pad_t, pad_l, Ho, Wo, has_bias, relu, st);
}
