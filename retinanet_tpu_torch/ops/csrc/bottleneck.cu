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
// So the block is split at the three GN reductions into launches that each
// stream their operand once:
//   1. conv1 GEMM -> bf16 y1 + per-CTA (sum, sum^2) partials      (epilogue)
//   2. finalize GN1 partials in a fixed order -> bf16 scale/shift
//   3. conv2 implicit GEMM, GN1 affine+relu applied while loading A (prologue)
//      -> bf16 y2 + partials
//   4. finalize GN2
//   5. conv3 GEMM with the GN2 prologue -> bf16 y3 + partials
//   6. finalize GN3
//   7. elementwise GN3 affine + residual + relu
// Statistics are written as per-CTA partials and reduced in a fixed order
// (no float atomics), so repeated runs are bitwise equal.  The products use
// mma.sync m16n8k16 bf16 tiles of 64x64x32 from shared memory; wgmma/TMA
// pipelines are later work.  Compile with -fmad=false: the bf16 affine must
// round after the multiply, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 128;       // 4 warps, 2x2 over the 64x64 tile
constexpr int LDS = BK + 8;   // smem row pitch in bf16: 80 bytes, conflict-free

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rnd(float v) { return __float2bfloat16_rn(v); }

// bf16 GN affine (+ relu): y*scale rounds, +shift rounds.
__device__ __forceinline__ float affine(bf16 y, bf16 sc, bf16 sh) {
  float p = f32(rnd(f32(y) * f32(sc)));
  return f32(rnd(p + f32(sh)));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Y[b, p, n] = sum_k A'[b, p, k] * Wt[n, k] for one image b, where k runs
// over TAPS taps x K0 input channels (tap-major), A' is the activation at the
// tap's neighbour pixel (0 outside the image), optionally mapped through the
// previous GN's bf16 affine + relu (PRO).  Writes bf16 Y and the per-CTA
// per-channel (sum, sum^2) of the rounded outputs to part[b, mt, 2, N].
template <int TAPS, bool PRO>
__global__ void __launch_bounds__(NT) conv_gemm(
    const bf16* __restrict__ A, const bf16* __restrict__ Wt,
    const bf16* __restrict__ psc, const bf16* __restrict__ psh,
    bf16* __restrict__ Y, float* __restrict__ part, int H, int W, int K0,
    int N) {
  __shared__ __align__(16) bf16 As[BM][LDS];
  __shared__ __align__(16) bf16 Bs[BN][LDS];
  __shared__ float red[2][2][BN];

  const int HW = H * W;
  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y;
  const int MT = gridDim.y;
  const int m0 = mt * BM;
  const int b = blockIdx.z;
  const int K = TAPS * K0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  const bf16* Ab = A + (size_t)b * HW * K0;

  // This thread's two 8-element chunks of each 64x32 tile.
  int py[2], px[2];
  bool pval[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + ((tid + i * NT) >> 2);
    pval[i] = p < HW;
    py[i] = p / W;
    px[i] = p - py[i] * W;
  }

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / K0;
    const int c0 = k0 - tap * K0;
    const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
    const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, kc = (c & 3) * 8;
      const int yy = py[i] + dy, xx = px[i] + dx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pval[i] && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        v = *reinterpret_cast<const uint4*>(
            Ab + (size_t)(yy * W + xx) * K0 + c0 + kc);
        if (PRO) {
          const uint4 s = *reinterpret_cast<const uint4*>(
              psc + (size_t)b * K0 + c0 + kc);
          const uint4 h = *reinterpret_cast<const uint4*>(
              psh + (size_t)b * K0 + c0 + kc);
          bf16* e = reinterpret_cast<bf16*>(&v);
          const bf16* se = reinterpret_cast<const bf16*>(&s);
          const bf16* he = reinterpret_cast<const bf16*>(&h);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = rnd(fmaxf(affine(e[j], se[j], he[j]), 0.f));
        }
      }
      ra[i] = v;
      rb[i] = *reinterpret_cast<const uint4*>(Wt + (size_t)(n0 + r) * K +
                                              k0 + kc);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      const int r = c >> 2, kc = (c & 3) * 8;
      *reinterpret_cast<uint4*>(&As[r][kc]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[r][kc]) = rb[i];
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mf][nf][j] = 0.f;

  const int KT = K / BK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const int r = wm * 32 + mf * 16 + g;
        af[mf][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 2 * t]);
        af[mf][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 2 * t]);
        af[mf][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 2 * t + 8]);
        af[mf][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = wn * 32 + nf * 8 + g;
        bfr[nf][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 2 * t]);
        bfr[nf][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) mma16816(acc[mf][nf], af[mf], bfr[nf]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      store();
      __syncthreads();
    }
  }

  // Epilogue: round to bf16, store, and sum the rounded values per column.
  float s[4][2], q[4][2];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) s[nf][0] = s[nf][1] = q[nf][0] = q[nf][1] = 0.f;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + wm * 32 + mf * 16 + g + half * 8;
      if (p >= HW) continue;
      bf16* yrow = Y + ((size_t)b * HW + p) * N + n0 + wn * 32 + 2 * t;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const bf16 v0 = rnd(acc[mf][nf][half * 2]);
        const bf16 v1 = rnd(acc[mf][nf][half * 2 + 1]);
        *reinterpret_cast<__nv_bfloat162*>(yrow + nf * 8) =
            __halves2bfloat162(v0, v1);
        const float f0 = f32(v0), f1 = f32(v1);
        s[nf][0] += f0;
        q[nf][0] += f0 * f0;
        s[nf][1] += f1;
        q[nf][1] += f1 * f1;
      }
    }
  }
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[nf][j] += __shfl_xor_sync(0xffffffffu, s[nf][j], off);
        q[nf][j] += __shfl_xor_sync(0xffffffffu, q[nf][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + nf * 8 + 2 * t + j;
        red[wm][0][col] = s[nf][j];
        red[wm][1][col] = q[nf][j];
      }
  }
  __syncthreads();
  if (tid < BN) {
#pragma unroll
    for (int st = 0; st < 2; ++st)
      part[(((size_t)b * MT + mt) * 2 + st) * N + n0 + tid] =
          red[0][st][tid] + red[1][st][tid];
  }
}

// One block per image: reduce the per-CTA partials in a fixed order, form
// group moments and write the bf16 per-channel scale and shift.
__global__ void gn_finalize(const float* __restrict__ part, int MT, int N,
                            int groups, int hw, const float* __restrict__ gamma,
                            const float* __restrict__ beta, float eps,
                            bf16* __restrict__ scale, bf16* __restrict__ shift) {
  extern __shared__ float sm[];
  float* ch = sm;              // [2, N]
  float* gm = sm + 2 * N;      // [2, groups]
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int m = 0; m < MT; ++m) {
      const float* pm = part + ((size_t)b * MT + m) * 2 * N;
      s1 += pm[c];
      s2 += pm[N + c];
    }
    ch[c] = s1;
    ch[N + c] = s2;
  }
  __syncthreads();
  const int cg = N / groups;
  const float cnt = (float)(hw * cg);
  for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      s1 += ch[gi * cg + j];
      s2 += ch[N + gi * cg + j];
    }
    const float mean = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
    gm[gi] = mean;
    gm[groups + gi] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    const int gi = c / cg;
    const float mean = gm[gi], inv = gm[groups + gi];
    scale[(size_t)b * N + c] = rnd(inv * gamma[c]);
    shift[(size_t)b * N + c] = rnd(beta[c] - mean * inv * gamma[c]);
  }
}

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

}  // namespace

// x, out: [B,H,W,C] bf16.  w1 [F,C], w2 [F,9F] (tap-major k), w3 [C,F] bf16.
// g*/b*: fp32 GN affines.  Scratch: y1, y2 [B,H*W,F] and y3 [B,H*W,C] bf16;
// part [B, ceil(H*W/64), 2, C] fp32; ss [6, B, C] bf16 scale/shift.
// Requires C % 64 == 0 and F % 64 == 0 (checked by the Python wrapper).
// Returns the first launch error (0 = cudaSuccess).
extern "C" int fused_bottleneck_fwd(
    const void* x, const void* w1, const void* g1, const void* b1,
    const void* w2, const void* g2, const void* b2, const void* w3,
    const void* g3, const void* b3, void* y1, void* y2, void* y3, void* part,
    void* ss, void* out, int B, int H, int W, int C, int F, int G1, int G3,
    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int MT = (HW + BM - 1) / BM;
  bf16* s = static_cast<bf16*>(ss);
  const size_t bc = (size_t)B * C;
  bf16 *sc1 = s, *sh1 = s + bc, *sc2 = s + 2 * bc, *sh2 = s + 3 * bc,
       *sc3 = s + 4 * bc, *sh3 = s + 5 * bc;
  const float* pf = static_cast<const float*>(part);
  cudaError_t e;

  conv_gemm<1, false><<<dim3(F / BN, MT, B), NT, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), nullptr,
      nullptr, static_cast<bf16*>(y1), static_cast<float*>(part), H, W, C, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gn_finalize<<<B, 256, (2 * F + 2 * G1) * sizeof(float), st>>>(
      pf, MT, F, G1, HW, static_cast<const float*>(g1),
      static_cast<const float*>(b1), eps, sc1, sh1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  conv_gemm<9, true><<<dim3(F / BN, MT, B), NT, 0, st>>>(
      static_cast<const bf16*>(y1), static_cast<const bf16*>(w2), sc1, sh1,
      static_cast<bf16*>(y2), static_cast<float*>(part), H, W, F, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gn_finalize<<<B, 256, (2 * F + 2 * G1) * sizeof(float), st>>>(
      pf, MT, F, G1, HW, static_cast<const float*>(g2),
      static_cast<const float*>(b2), eps, sc2, sh2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  conv_gemm<1, true><<<dim3(C / BN, MT, B), NT, 0, st>>>(
      static_cast<const bf16*>(y2), static_cast<const bf16*>(w3), sc2, sh2,
      static_cast<bf16*>(y3), static_cast<float*>(part), H, W, F, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gn_finalize<<<B, 256, (2 * C + 2 * G3) * sizeof(float), st>>>(
      pf, MT, C, G3, HW, static_cast<const float*>(g3),
      static_cast<const float*>(b3), eps, sc3, sh3);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t nvec = (size_t)B * HW * C / 8;
  const int blocks = (int)((nvec + 255) / 256 < 65535 ? (nvec + 255) / 256
                                                      : 65535);
  gn_residual_relu<<<blocks, 256, 0, st>>>(
      static_cast<const bf16*>(y3), static_cast<const bf16*>(x), sc3, sh3,
      static_cast<bf16*>(out), HW, C, nvec);
  return cudaGetLastError();
}
