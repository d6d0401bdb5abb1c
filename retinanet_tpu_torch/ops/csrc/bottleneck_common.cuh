// Device code shared by the fused bottleneck forward (bottleneck.cu, B1)
// and its backward (bottleneck_bwd.cu, B3): the bf16 GN affine, the
// mma.sync implicit-GEMM convolution with its epilogues, and the fixed-order
// GN finalize.  Compile with -fmad=false: the bf16 affine and the fp32 GN
// backward terms must round after every multiply, as the plain versions do.
// The including file names the namespace (BOTTLENECK_NS) its copy of these
// kernels lives in, so that a profile tells B1's launches from B3's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BOTTLENECK_NS
#error "define BOTTLENECK_NS before including bottleneck_common.cuh"
#endif

namespace {
namespace BOTTLENECK_NS {

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

// acc[mf][nf][:] += As[64 x BK] . Bs[64 x BK]^T for this warp's 32x32 part.
__device__ __forceinline__ void mma_tile(float (*acc)[4][4],
                                         bf16 (*As)[LDS], bf16 (*Bs)[LDS],
                                         int wm, int wn,
                                         int g, int t) {
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
}

// What conv_gemm does with each rounded output y = bf16(acc):
//   EPI_STATS  store y; partials (sum y, sum y^2)                 (forward)
//   EPI_MASK   store d = (GN affine of yf > 0) ? y : 0, where yf is the
//              forward's pre-GN plane of this layer; partials (sum d,
//              sum d*yhat) with yhat = (yf - mean) * inv        (backward)
//   EPI_RESID  store bf16(y + res)                    (backward, dx + dn3)
enum Epilogue { EPI_STATS = 0, EPI_MASK = 1, EPI_RESID = 2 };

struct EpiArgs {
  const bf16* yf;     // [B, HW, N] forward pre-GN values (EPI_MASK)
  const bf16* sc;     // [B, N] bf16 GN scale, shift (EPI_MASK)
  const bf16* sh;
  const float* mean;  // [B, N] fp32 GN mean, inv-std (EPI_MASK)
  const float* inv;
  const bf16* res;    // [B, HW, N] residual (EPI_RESID)
};

// Y[b, p, n] = epi(sum_k A'[b, p, k] * Wt[n, k]) for one image b, where k
// runs over TAPS taps x K0 input channels (tap-major), A' is the activation
// at the tap's neighbour pixel (0 outside the image), optionally mapped
// through the previous GN's bf16 affine + relu (PRO).  Per-CTA per-channel
// partials go to part[b, mt, 2, N] (EPI_STATS, EPI_MASK).
template <int TAPS, bool PRO, int EPI>
__global__ void __launch_bounds__(NT) conv_gemm(
    const bf16* __restrict__ A, const bf16* __restrict__ Wt,
    const bf16* __restrict__ psc, const bf16* __restrict__ psh,
    bf16* __restrict__ Y, float* __restrict__ part, int H, int W, int K0,
    int N, EpiArgs ep) {
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
    mma_tile(acc, As, Bs, wm, wn, g, t);
    __syncthreads();
    if (kt + 1 < KT) {
      store();
      __syncthreads();
    }
  }

  // Epilogue: round to bf16, apply EPI, store, and sum per column.
  float s[4][2], q[4][2];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) s[nf][0] = s[nf][1] = q[nf][0] = q[nf][1] = 0.f;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + wm * 32 + mf * 16 + g + half * 8;
      if (p >= HW) continue;
      const size_t row = ((size_t)b * HW + p) * N;
      bf16* yrow = Y + row + n0 + wn * 32 + 2 * t;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        bf16 v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + nf * 8 + 2 * t + j;
          v[j] = rnd(acc[mf][nf][half * 2 + j]);
          if (EPI == EPI_STATS) {
            const float f = f32(v[j]);
            s[nf][j] += f;
            q[nf][j] += f * f;
          } else if (EPI == EPI_MASK) {
            const size_t bc = (size_t)b * N + col;
            const bf16 yf = ep.yf[row + col];
            if (!(affine(yf, ep.sc[bc], ep.sh[bc]) > 0.f)) v[j] = rnd(0.f);
            const float d = f32(v[j]);
            const float yhat = (f32(yf) - ep.mean[bc]) * ep.inv[bc];
            s[nf][j] += d;
            q[nf][j] += d * yhat;
          } else {
            v[j] = rnd(f32(v[j]) + f32(ep.res[row + col]));
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(yrow + nf * 8) =
            __halves2bfloat162(v[0], v[1]);
      }
    }
  }
  if (EPI == EPI_RESID) return;
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
// group moments and write the bf16 per-channel scale and shift, and, where
// mean/inv are given, the fp32 per-channel mean and inverse std as well.
__global__ void gn_finalize(const float* __restrict__ part, int MT, int N,
                            int groups, int hw, const float* __restrict__ gamma,
                            const float* __restrict__ beta, float eps,
                            bf16* __restrict__ scale, bf16* __restrict__ shift,
                            float* __restrict__ mean_out,
                            float* __restrict__ inv_out) {
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
    if (mean_out != nullptr) {
      mean_out[(size_t)b * N + c] = mean;
      inv_out[(size_t)b * N + c] = inv;
    }
  }
}

}  // namespace BOTTLENECK_NS
}  // namespace
