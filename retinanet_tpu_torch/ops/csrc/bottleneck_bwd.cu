// Backward of the fused stride-1 identity bottleneck for Hopper (sm_90a).
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/bottleneck_bwd.py:
// fused_bottleneck_bwd (_bwd_kernel, helper _gn_bwd_terms), the backward of
//     out = relu(GN3(conv1x1_3(relu(GN2(conv3x3(relu(GN1(conv1x1_1(x))))))) + x)
// from the primals alone: x [B,H,W,C] bf16 NHWC, dout [B,H,W,C] bf16 and the
// nine parameters give dx (bf16) and dk1, dk2, dk3, dgamma1..3, dbeta1..3
// (fp32).  Nothing of the forward is saved: the forward is recomputed.
//
// Semantics kept from the TPU kernel (its seven passes P1..P7): the
// recomputed forward rounds exactly as B1 does (same device code), so the
// relu masks see the forward's bf16 values; inter-op cotangents are bf16
// (dn3, dn2, dn1 and each GN backward's dy); products accumulate in fp32;
// GN sums, weight and GN-parameter gradients are fp32.  The GN backward is
//     dy = bf16(inv * ((gamma*d - t1) - yhat*t2)),  yhat = (y - mean) * inv,
//     t1 = group_sum(gamma * sum d) / n,  t2 = group_sum(gamma * sum d*yhat) / n,
// with n = H*W*C/G, dgamma = sum d*yhat and dbeta = sum d.  conv2's dgrad
// takes the nine reverse taps of dy2 with zero cotangent outside the image;
// its wgrad takes the a1 taps with zeros outside the image after the affine
// (never relu(shift)).  dx = bf16(dy1 . k1^T) + dn3 is a bf16 add.
//
// What bounds it here: three recomputed GEMMs, three dgrad GEMMs and three
// wgrad GEMMs (about 3x B1's FLOP), and GN reductions between them that span
// a whole image.  The TPU kernel kept the image in VMEM and accumulated the
// weight gradients across a sequential batch grid; CTAs on an H100 run in
// parallel in no order.  So the backward is cut at every reduction into
// launches that stream their operands once (bf16 planes y1..y3, dn3, dn2/1
// and dy stay in device memory for the duration of one block's backward):
//   P1-P3  B1's conv GEMMs; the finalize also writes fp32 mean and inv-std
//   P4     elementwise output mask -> dn3, per-CTA (sum d, sum d*yhat)
//   GN3    fixed-order finalize -> t1, t2, per-image dgamma3/dbeta3; dy3
//   P5     GEMM dy3.k3^T with a mask epilogue (GN2 affine > 0) -> dn2 and
//          GN2 partials; wgrad dk3 = dy3^T . relu(GN2 affine of y2)
//   GN2    finalize; dy2
//   P6     implicit GEMM over the 9 reverse taps of dy2 with the GN1 mask
//          epilogue -> dn1 and partials; wgrad dk2 over 9 taps of a1
//   GN1    finalize; dy1
//   P7     GEMM dy1.k1^T with a residual epilogue (+ dn3) -> dx;
//          wgrad dk1 = dy1^T . x
// Weight gradients have K = B*H*W rows: K is cut into a fixed number of
// slices, each CTA writes an fp32 partial, and a second launch sums the
// slices in order; dgamma/dbeta are summed over images in order.  No float
// atomics: repeated runs are bitwise equal.  The products use the simple
// mma.sync 64x64x32 tiles of B1; wgmma/TMA pipelines are later work.

#define BOTTLENECK_NS b3_fused_bottleneck_bwd
#include "bottleneck_common.cuh"

namespace {
namespace BOTTLENECK_NS {

// P4: dn3 = (bf16(GN3 affine of y3) + x > 0) ? dout : 0, with per-CTA
// partials (sum dn3, sum dn3*yhat3) of 64 rows x 64 channels.  A thread
// takes eight channels of every 32nd row.
__global__ void __launch_bounds__(256) out_mask_bwd(
    const bf16* __restrict__ y3, const bf16* __restrict__ x,
    const bf16* __restrict__ dout, const bf16* __restrict__ sc,
    const bf16* __restrict__ sh, const float* __restrict__ mean,
    const float* __restrict__ inv, bf16* __restrict__ dn3,
    float* __restrict__ part, int HW, int C) {
  __shared__ float red[2][32][BN];
  const int n0 = blockIdx.x * BN, mt = blockIdx.y, MT = gridDim.y;
  const int b = blockIdx.z;
  const int cg = threadIdx.x & 7, rg = threadIdx.x >> 3;
  const int c0 = n0 + cg * 8;
  const size_t bc = (size_t)b * C + c0;
  const uint4 sv = *reinterpret_cast<const uint4*>(sc + bc);
  const uint4 hv = *reinterpret_cast<const uint4*>(sh + bc);
  const bf16* se = reinterpret_cast<const bf16*>(&sv);
  const bf16* he = reinterpret_cast<const bf16*>(&hv);
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  for (int r = rg; r < BM; r += 32) {
    const int p = mt * BM + r;
    if (p >= HW) break;
    const size_t e = ((size_t)b * HW + p) * C + c0;
    const uint4 yv = *reinterpret_cast<const uint4*>(y3 + e);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + e);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + e);
    const bf16* ye = reinterpret_cast<const bf16*>(&yv);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pre = f32(rnd(affine(ye[j], se[j], he[j]) + f32(xe[j])));
      oe[j] = pre > 0.f ? de[j] : rnd(0.f);
      const float d = f32(oe[j]);
      const float yhat = (f32(ye[j]) - mean[bc + j]) * inv[bc + j];
      s[j] += d;
      q[j] += d * yhat;
    }
    *reinterpret_cast<uint4*>(dn3 + e) = ov;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[0][rg][cg * 8 + j] = s[j];
    red[1][rg][cg * 8 + j] = q[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int st = threadIdx.x / BN, c = threadIdx.x % BN;
    float a = 0.f;
    for (int r = 0; r < 32; ++r) a += red[st][r][c];
    part[(((size_t)b * MT + mt) * 2 + st) * C + n0 + c] = a;
  }
}

// One block per image: reduce the partials (sum d, sum d*yhat) in a fixed
// order; write the per-image dgamma = sum d*yhat and dbeta = sum d, and the
// per-channel group terms t1, t2 of the GN backward.
__global__ void gn_bwd_finalize(const float* __restrict__ part, int MT, int N,
                                int groups, int hw,
                                const float* __restrict__ gamma,
                                float* __restrict__ t1, float* __restrict__ t2,
                                float* __restrict__ dgam_img,
                                float* __restrict__ dbet_img) {
  extern __shared__ float sm[];
  float* ch = sm;              // [2, N]
  float* gm = sm + 2 * N;      // [2, groups]
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float sb = 0.f, sg = 0.f;
    for (int m = 0; m < MT; ++m) {
      const float* pm = part + ((size_t)b * MT + m) * 2 * N;
      sb += pm[c];
      sg += pm[N + c];
    }
    ch[c] = sb;
    ch[N + c] = sg;
    dbet_img[(size_t)b * N + c] = sb;
    dgam_img[(size_t)b * N + c] = sg;
  }
  __syncthreads();
  const int cg = N / groups;
  const float n = (float)(hw * cg);
  for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int c = gi * cg + j;
      a1 += gamma[c] * ch[c];
      a2 += gamma[c] * ch[N + c];
    }
    gm[gi] = a1 / n;
    gm[groups + gi] = a2 / n;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    t1[(size_t)b * N + c] = gm[c / cg];
    t2[(size_t)b * N + c] = gm[groups + c / cg];
  }
}

// dy = bf16(inv * ((gamma*d - t1) - yhat*t2)), yhat = (y - mean) * inv, over
// [B, HW, N] bf16 planes, eight channels per thread.
__global__ void gn_bwd_dy(const bf16* __restrict__ dn, const bf16* __restrict__ y,
                          const float* __restrict__ gamma,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          const float* __restrict__ t1,
                          const float* __restrict__ t2, bf16* __restrict__ dy,
                          int HW, int N, size_t nvec) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const size_t b = e / ((size_t)HW * N);
    const int c = (int)(e % N);
    const uint4 dv = *reinterpret_cast<const uint4*>(dn + e);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
    const bf16* ye = reinterpret_cast<const bf16*>(&yv);
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t bc = b * N + c + j;
      const float yhat = (f32(ye[j]) - mean[bc]) * inv[bc];
      const float v = (gamma[c + j] * f32(de[j]) - t1[bc]) - yhat * t2[bc];
      oe[j] = rnd(inv[bc] * v);
    }
    *reinterpret_cast<uint4*>(dy + e) = ov;
  }
}

// Weight gradient, one K-slice per CTA:
//   part[s, tap, i, j] = sum over rows r of slice s of P[r, i] * Q_tap[r, j]
// Rows r = b*HW + p run over every pixel of every image; Q_tap[r] is Q at
// pixel p shifted by the tap's (dy, dx) in image b, zero outside the image,
// and mapped through image b's GN affine + relu when PRO.  A warp loads one
// 8-column group of all 32 rows of a k-step and stores it transposed, so the
// shared-memory stores do not collide.
template <int TAPS, bool PRO>
__global__ void __launch_bounds__(NT) wgrad_gemm(
    const bf16* __restrict__ P, const bf16* __restrict__ Q,
    const bf16* __restrict__ qsc, const bf16* __restrict__ qsh,
    float* __restrict__ part, int Bn, int H, int W, int M, int N, int S) {
  __shared__ __align__(16) bf16 As[BM][LDS];
  __shared__ __align__(16) bf16 Bs[BN][LDS];

  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM;
  const int s = blockIdx.z / TAPS, tap = blockIdx.z % TAPS;
  const int HW = H * W;
  const long long R = (long long)Bn * HW;
  const long long KTall = (R + BK - 1) / BK;
  const int kt0 = (int)(s * KTall / S), kt1 = (int)((s + 1) * KTall / S);
  const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
  const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  uint4 rp[2], rq[2];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      const int k = c & 31, col = (c >> 5) * 8;
      const long long r = (long long)kt * BK + k;
      uint4 vp = make_uint4(0u, 0u, 0u, 0u), vq = vp;
      if (r < R) {
        vp = *reinterpret_cast<const uint4*>(P + r * M + i0 + col);
        const int b = (int)(r / HW);
        const int p = (int)(r - (long long)b * HW);
        const int yy = p / W + dy, xx = p % W + dx;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
          vq = *reinterpret_cast<const uint4*>(
              Q + ((size_t)b * HW + yy * W + xx) * N + j0 + col);
          if (PRO) {
            const uint4 sv = *reinterpret_cast<const uint4*>(
                qsc + (size_t)b * N + j0 + col);
            const uint4 hv = *reinterpret_cast<const uint4*>(
                qsh + (size_t)b * N + j0 + col);
            bf16* e = reinterpret_cast<bf16*>(&vq);
            const bf16* se = reinterpret_cast<const bf16*>(&sv);
            const bf16* he = reinterpret_cast<const bf16*>(&hv);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              e[j] = rnd(fmaxf(affine(e[j], se[j], he[j]), 0.f));
          }
        }
      }
      rp[i] = vp;
      rq[i] = vq;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT;
      const int k = c & 31, col = (c >> 5) * 8;
      const bf16* pe = reinterpret_cast<const bf16*>(&rp[i]);
      const bf16* qe = reinterpret_cast<const bf16*>(&rq[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        As[col + j][k] = pe[j];
        Bs[col + j][k] = qe[j];
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mf][nf][j] = 0.f;

  if (kt0 < kt1) {
    load(kt0);
    store();
    __syncthreads();
    for (int kt = kt0; kt < kt1; ++kt) {
      if (kt + 1 < kt1) load(kt + 1);
      mma_tile(acc, As, Bs, wm, wn, g, t);
      __syncthreads();
      if (kt + 1 < kt1) {
        store();
        __syncthreads();
      }
    }
  }

  float* out = part + ((size_t)s * TAPS + tap) * M * N;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm * 32 + mf * 16 + g + half * 8;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int j = j0 + wn * 32 + nf * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)i * N + j) =
            make_float2(acc[mf][nf][half * 2], acc[mf][nf][half * 2 + 1]);
      }
    }
}

// out[(i*N + j)*TAPS + tap] = sum over s in order of part[s, tap, i, j]:
// [M, N] for one tap, [M, N, 3, 3] (OIHW) for nine.
__global__ void reduce_slices(const float* __restrict__ part,
                              float* __restrict__ out, int S, int TAPS, int M,
                              int N) {
  const size_t mn = (size_t)M * N, total = mn * TAPS;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t tap = idx / mn, rem = idx - tap * mn;
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += part[((size_t)s * TAPS + tap) * mn + rem];
    out[rem * TAPS + tap] = a;
  }
}

// The six GN-parameter gradients: out[k][c] = sum over images in order of
// in[k][b, c], for k = dgamma1, dbeta1, dgamma2, dbeta2, dgamma3, dbeta3.
struct ImageSums {
  const float* in[6];
  float* out[6];
  int n[6];
};

__global__ void reduce_images(ImageSums v, int B) {
  const int k = blockIdx.x, n = v.n[k];
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float a = 0.f;
    for (int b = 0; b < B; ++b) a += v.in[k][(size_t)b * n + c];
    v.out[k][c] = a;
  }
}

int grid1d(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 65535 ? blocks : 65535);
}

}  // namespace BOTTLENECK_NS
}  // namespace

using namespace BOTTLENECK_NS;

// x, dout, dx: [B,H,W,C] bf16.  Weights (bf16): w1 [F,C] and its transpose
// w1t [C,F]; w2 [F,9F] forward taps (out, tap, in) and w2r [F,9F] the
// dgrad's reversed taps (in, tap, out); w3 [C,F] and w3t [F,C].  g*/b* fp32
// GN affines.  Scratch: y1, y2 [B,HW,F], y3 [B,HW,C] bf16; part [B, ceil(HW/
// 64), 2, C] fp32; ss [6,B,C] bf16 scale/shift; mv [6,B,C] fp32 mean/inv;
// dn3 [B,HW,C], dn21 [B,HW,F], dyb [B,HW,C] bf16; tt [2,B,C] fp32; gimg
// [6,B,C] fp32; wpart fp32 of max(S1*F*C, S2*9*F*F, S3*C*F).  Outputs (fp32):
// dk1 [F,C], dk2 [F,F,3,3], dk3 [C,F], dg*/db* [F] or [C].  S1..S3: K-slices
// of the dk1, dk2, dk3 wgrads.  Requires C % 64 == 0 and F % 64 == 0 and
// 1 <= S <= ceil(B*H*W/32) (checked by the Python wrapper).  Returns the
// first launch error (0 = cudaSuccess).
extern "C" int fused_bottleneck_bwd(
    const void* x, const void* dout, const void* w1, const void* w1t,
    const void* g1, const void* b1, const void* w2, const void* w2r,
    const void* g2, const void* b2, const void* w3, const void* w3t,
    const void* g3, const void* b3, void* y1, void* y2, void* y3, void* part,
    void* ss, void* mv, void* dn3, void* dn21, void* dyb, void* tt,
    void* gimg, void* wpart, void* dx, void* dk1, void* dk2, void* dk3,
    void* dg1, void* db1, void* dg2, void* db2, void* dg3, void* db3, int B,
    int H, int W, int C, int F, int G1, int G3, int S1, int S2, int S3,
    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int MT = (HW + BM - 1) / BM;
  const size_t bc = (size_t)B * C;
  bf16* s = static_cast<bf16*>(ss);
  bf16 *sc1 = s, *sh1 = s + bc, *sc2 = s + 2 * bc, *sh2 = s + 3 * bc,
       *sc3 = s + 4 * bc, *sh3 = s + 5 * bc;
  float* m = static_cast<float*>(mv);
  float *mean1 = m, *inv1 = m + bc, *mean2 = m + 2 * bc, *inv2 = m + 3 * bc,
        *mean3 = m + 4 * bc, *inv3 = m + 5 * bc;
  float* t1 = static_cast<float*>(tt);
  float* t2 = t1 + bc;
  float* gi = static_cast<float*>(gimg);
  float* pt = static_cast<float*>(part);
  float* wp = static_cast<float*>(wpart);
  const bf16* X = static_cast<const bf16*>(x);
  bf16 *Y1 = static_cast<bf16*>(y1), *Y2 = static_cast<bf16*>(y2),
       *Y3 = static_cast<bf16*>(y3), *DN3 = static_cast<bf16*>(dn3),
       *DN = static_cast<bf16*>(dn21), *DY = static_cast<bf16*>(dyb);
  const float *G1p = static_cast<const float*>(g1),
              *G2p = static_cast<const float*>(g2),
              *G3p = static_cast<const float*>(g3);
  const EpiArgs none = {};
  const size_t smF = (2 * F + 2 * G1) * sizeof(float);
  const size_t smC = (2 * C + 2 * G3) * sizeof(float);
  cudaError_t e;
#define CHECK()                                         \
  if ((e = cudaGetLastError()) != cudaSuccess) return e

  // P1-P3: the forward, as B1 computes it, keeping fp32 mean/inv.
  conv_gemm<1, false, EPI_STATS><<<dim3(F / BN, MT, B), NT, 0, st>>>(
      X, static_cast<const bf16*>(w1), nullptr, nullptr, Y1, pt, H, W, C, F,
      none);
  CHECK();
  gn_finalize<<<B, 256, smF, st>>>(pt, MT, F, G1, HW, G1p,
                                   static_cast<const float*>(b1), eps, sc1,
                                   sh1, mean1, inv1);
  CHECK();
  conv_gemm<9, true, EPI_STATS><<<dim3(F / BN, MT, B), NT, 0, st>>>(
      Y1, static_cast<const bf16*>(w2), sc1, sh1, Y2, pt, H, W, F, F, none);
  CHECK();
  gn_finalize<<<B, 256, smF, st>>>(pt, MT, F, G1, HW, G2p,
                                   static_cast<const float*>(b2), eps, sc2,
                                   sh2, mean2, inv2);
  CHECK();
  conv_gemm<1, true, EPI_STATS><<<dim3(C / BN, MT, B), NT, 0, st>>>(
      Y2, static_cast<const bf16*>(w3), sc2, sh2, Y3, pt, H, W, F, C, none);
  CHECK();
  gn_finalize<<<B, 256, smC, st>>>(pt, MT, C, G3, HW, G3p,
                                   static_cast<const float*>(b3), eps, sc3,
                                   sh3, mean3, inv3);
  CHECK();

  // P4 + GN3 backward.
  out_mask_bwd<<<dim3(C / BN, MT, B), 256, 0, st>>>(
      Y3, X, static_cast<const bf16*>(dout), sc3, sh3, mean3, inv3, DN3, pt,
      HW, C);
  CHECK();
  gn_bwd_finalize<<<B, 256, smC, st>>>(pt, MT, C, G3, HW, G3p, t1, t2,
                                       gi + 4 * bc, gi + 5 * bc);
  CHECK();
  gn_bwd_dy<<<grid1d(bc * HW / 8, 256), 256, 0, st>>>(
      DN3, Y3, G3p, mean3, inv3, t1, t2, DY, HW, C, bc * HW / 8);
  CHECK();

  // P5: da2 = dy3.k3^T masked by GN2 -> dn2; dk3 = dy3^T . a2.
  const EpiArgs ep2 = {Y2, sc2, sh2, mean2, inv2, nullptr};
  conv_gemm<1, false, EPI_MASK><<<dim3(F / BN, MT, B), NT, 0, st>>>(
      DY, static_cast<const bf16*>(w3t), nullptr, nullptr, DN, pt, H, W, C, F,
      ep2);
  CHECK();
  wgrad_gemm<1, true><<<dim3(F / BN, C / BM, S3), NT, 0, st>>>(
      DY, Y2, sc2, sh2, wp, B, H, W, C, F, S3);
  CHECK();
  reduce_slices<<<grid1d((size_t)C * F, 256), 256, 0, st>>>(
      wp, static_cast<float*>(dk3), S3, 1, C, F);
  CHECK();
  gn_bwd_finalize<<<B, 256, smF, st>>>(pt, MT, F, G1, HW, G2p, t1, t2,
                                       gi + 2 * bc, gi + 3 * bc);
  CHECK();
  gn_bwd_dy<<<grid1d((size_t)B * HW * F / 8, 256), 256, 0, st>>>(
      DN, Y2, G2p, mean2, inv2, t1, t2, DY, HW, F, (size_t)B * HW * F / 8);
  CHECK();

  // P6: conv2 dgrad over the reverse taps of dy2, masked by GN1 -> dn1
  // (over dn2, which dy2 has consumed); dk2 over the nine a1 taps.
  const EpiArgs ep1 = {Y1, sc1, sh1, mean1, inv1, nullptr};
  conv_gemm<9, false, EPI_MASK><<<dim3(F / BN, MT, B), NT, 0, st>>>(
      DY, static_cast<const bf16*>(w2r), nullptr, nullptr, DN, pt, H, W, F, F,
      ep1);
  CHECK();
  wgrad_gemm<9, true><<<dim3(F / BN, F / BM, S2 * 9), NT, 0, st>>>(
      DY, Y1, sc1, sh1, wp, B, H, W, F, F, S2);
  CHECK();
  reduce_slices<<<grid1d((size_t)9 * F * F, 256), 256, 0, st>>>(
      wp, static_cast<float*>(dk2), S2, 9, F, F);
  CHECK();
  gn_bwd_finalize<<<B, 256, smF, st>>>(pt, MT, F, G1, HW, G1p, t1, t2, gi,
                                       gi + bc);
  CHECK();
  gn_bwd_dy<<<grid1d((size_t)B * HW * F / 8, 256), 256, 0, st>>>(
      DN, Y1, G1p, mean1, inv1, t1, t2, DY, HW, F, (size_t)B * HW * F / 8);
  CHECK();

  // P7: dx = bf16(dy1.k1^T) + dn3; dk1 = dy1^T . x.
  EpiArgs ep0 = {};
  ep0.res = DN3;
  conv_gemm<1, false, EPI_RESID><<<dim3(C / BN, MT, B), NT, 0, st>>>(
      DY, static_cast<const bf16*>(w1t), nullptr, nullptr,
      static_cast<bf16*>(dx), nullptr, H, W, F, C, ep0);
  CHECK();
  wgrad_gemm<1, false><<<dim3(C / BN, F / BM, S1), NT, 0, st>>>(
      DY, X, nullptr, nullptr, wp, B, H, W, F, C, S1);
  CHECK();
  reduce_slices<<<grid1d((size_t)F * C, 256), 256, 0, st>>>(
      wp, static_cast<float*>(dk1), S1, 1, F, C);
  CHECK();

  ImageSums v;
  float* outs[6] = {static_cast<float*>(dg1), static_cast<float*>(db1),
                    static_cast<float*>(dg2), static_cast<float*>(db2),
                    static_cast<float*>(dg3), static_cast<float*>(db3)};
  for (int k = 0; k < 6; ++k) {
    v.in[k] = gi + k * bc;
    v.out[k] = outs[k];
    v.n[k] = k < 4 ? F : C;
  }
  reduce_images<<<6, 256, 0, st>>>(v, B);
  return cudaGetLastError();
#undef CHECK
}
