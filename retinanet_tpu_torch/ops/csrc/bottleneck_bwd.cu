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
// The TPU kernel kept the image in VMEM and accumulated the weight
// gradients across a sequential batch grid; CTAs on an H100 run in parallel
// in no order.  So the backward is cut at every reduction into launches
// that stream their operands (bf16 planes y1..y3, a1, a2, dn3, dn2/1 and dy
// stay in device memory for one block's backward):
//   P1-P3  B1's forward GEMMs (bottleneck_common.cuh's fwd_gemm on the
//          wgmma mainloop, launched as B1 launches them: the same tiles and
//          K order, so y1..y3, the GN statistics and the relu masks are
//          B1's bit for bit); their in-GEMM finalize also writes fp32 mean
//          and inv-std.  relu_planes then writes a1 = bf16(relu(GN1
//          affine(y1))) and a2 = bf16(relu(GN2 affine(y2))) once, for the weight
//          gradients' nine taps and one to read.
//   P4     elementwise output mask -> dn3, per-CTA (sum d, sum d*yhat)
//   GN3    fixed-order finalize (one CTA per image and 64 channels) -> t1,
//          t2, per-image dgamma3/dbeta3; dy3
//   P5     dgrad_gemm dy3.k3^T with a mask epilogue (GN2 affine > 0) -> dn2
//          and GN2 partials; wgrad dk3 = dy3^T . a2
//   GN2    finalize; dy2
//   P6     dgrad_gemm over the 9 reverse taps of dy2 with the GN1 mask
//          epilogue -> dn1 and partials; wgrad dk2 over 9 taps of a1
//   GN1    finalize; dy1
//   P7     dgrad_gemm dy1.k1^T with a residual epilogue (+ dn3) -> dx;
//          wgrad dk1 = dy1^T . x
// 21 launches per block.
//
// The GEMMs.  dgrad_gemm runs hopper_gemm.cuh's implicit-GEMM mainloop: 128
// x BN tiles of one image (BN = 128, or 64 for the 64-wide res2), a ring
// of three cp.async stages of 64 K values in the 128-byte swizzle,
// zero-filled outside the image, and bf16 wgmma m64nBNk16 on two
// warpgroups, fp32 accumulation.  The epilogue rounds the accumulators
// into a shared-memory tile and re-reads it by rows, 8 columns a thread:
// 16-byte loads of the forward plane (mask) or the residual, 16-byte
// stores, and the per-column GN partials summed over row groups in order.
// wgmma's accumulator layout (rows g and g + 8 of each warp's 16, columns
// 8j + 2t and 8j + 2t + 1) thus never meets the epilogue, and every dgrad
// runs on wgmma.
// wgrad_gemm computes part[s, tap, i, j] = sum_r P[r, i] * Q_tap[r, j] over
// the rows r of K-slice s: both operands are MN-major (pixels by channels),
// staged as they lie with 16-byte cp.async copies into a ring of three
// stages of 64 rows, in the 128-byte swizzle, and read by bf16 wgmma
// through its transposed (MN-major) descriptors: 128 x 128 tiles (64 where
// a dimension is 64), one warpgroup per 64 rows of i, one m64n64k16 per 64
// columns of j, so that every descriptor spans one 64-wide atom.
// Weight gradients have K = B*H*W rows: K is cut into a fixed number of
// slices, each CTA writes an fp32 partial, and reduce_slices sums the
// slices in order; dgamma/dbeta are summed over images in order.  No float
// atomics: repeated runs are bitwise equal.
//
// What bounds it: three recomputed, three dgrad and three wgrad GEMMs
// (about 3x B1's FLOP) at the bf16 tensor-core peak, plus the bf16 planes
// each pass streams.

#define BOTTLENECK_NS b3_fused_bottleneck_bwd
#include "bottleneck_common.cuh"

namespace {
namespace BOTTLENECK_NS {

// Rows and channels of an out_mask_bwd tile.
constexpr int BM = 64;
constexpr int BN = 64;

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

// GN backward terms of one image and 64 channels per block (groups do not
// straddle blocks: the wrapper checks that C/G divides 64): reduce the
// per-tile partials (sum d, sum d*yhat) in a fixed order, four row
// partitions per channel summed in order; write the per-image dgamma =
// sum d*yhat and dbeta = sum d, and the per-channel group terms t1, t2.
__global__ void __launch_bounds__(256) gn_bwd_finalize(
    const float* __restrict__ part, int MT, int N, int groups, int hw,
    const float* __restrict__ gamma, float* __restrict__ t1,
    float* __restrict__ t2, float* __restrict__ dgam_img,
    float* __restrict__ dbet_img) {
  __shared__ float red[2][4][64];
  __shared__ float ch[2][64];
  const int b = blockIdx.y, c0 = blockIdx.x * 64;
  const int lc = threadIdx.x & 63, rp = threadIdx.x >> 6;
  const int c = c0 + lc;
  float sb = 0.f, sg = 0.f;
  for (int m = rp; m < MT; m += 4) {
    const float* pm = part + ((size_t)b * MT + m) * 2 * N;
    sb += pm[c];
    sg += pm[N + c];
  }
  red[0][rp][lc] = sb;
  red[1][rp][lc] = sg;
  __syncthreads();
  if (threadIdx.x < 64) {
    sb = ((red[0][0][lc] + red[0][1][lc]) + red[0][2][lc]) + red[0][3][lc];
    sg = ((red[1][0][lc] + red[1][1][lc]) + red[1][2][lc]) + red[1][3][lc];
    dbet_img[(size_t)b * N + c] = sb;
    dgam_img[(size_t)b * N + c] = sg;
    ch[0][lc] = gamma[c] * sb;
    ch[1][lc] = gamma[c] * sg;
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    const int cg = N / groups;
    const int g0 = lc / cg * cg;
    const float n = (float)(hw * cg);
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      a1 += ch[0][g0 + j];
      a2 += ch[1][g0 + j];
    }
    t1[(size_t)b * N + c] = a1 / n;
    t2[(size_t)b * N + c] = a2 / n;
  }
}

// dy = bf16(inv * ((gamma*d - t1) - yhat*t2)), yhat = (y - mean) * inv, over
// [B, HW, N] bf16 planes, eight channels per thread; the per-channel terms
// load as float4 pairs.
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
    const size_t bc = b * N + c;
    const uint4 dv = *reinterpret_cast<const uint4*>(dn + e);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
    const bf16* ye = reinterpret_cast<const bf16*>(&yv);
    float gm[8], mn[8], iv[8], a[8], q[8];
    const float* src[5] = {gamma + c, mean + bc, inv + bc, t1 + bc, t2 + bc};
    float* dst[5] = {gm, mn, iv, a, q};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float4 lo = reinterpret_cast<const float4*>(src[k])[0];
      const float4 hi = reinterpret_cast<const float4*>(src[k])[1];
      dst[k][0] = lo.x; dst[k][1] = lo.y; dst[k][2] = lo.z; dst[k][3] = lo.w;
      dst[k][4] = hi.x; dst[k][5] = hi.y; dst[k][6] = hi.z; dst[k][7] = hi.w;
    }
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float yhat = (f32(ye[j]) - mn[j]) * iv[j];
      const float v = (gm[j] * f32(de[j]) - a[j]) - yhat * q[j];
      oe[j] = rnd(iv[j] * v);
    }
    *reinterpret_cast<uint4*>(dy + e) = ov;
  }
}

// a1 = bf16(relu(GN1 affine(y1))) and a2 = bf16(relu(GN2 affine(y2))) over
// [B, HW, F] planes, eight channels per thread: the wgrad GEMMs' Q operands.
__global__ void relu_planes(const bf16* __restrict__ y1,
                            const bf16* __restrict__ y2,
                            const bf16* __restrict__ sc1,
                            const bf16* __restrict__ sh1,
                            const bf16* __restrict__ sc2,
                            const bf16* __restrict__ sh2,
                            bf16* __restrict__ a1, bf16* __restrict__ a2,
                            int HW, int F, size_t nvec) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const size_t bc = e / ((size_t)HW * F) * F + e % F;
    const bf16* ys[2] = {y1, y2};
    const bf16* scs[2] = {sc1, sc2};
    const bf16* shs[2] = {sh1, sh2};
    bf16* outs[2] = {a1, a2};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uint4 v = *reinterpret_cast<const uint4*>(ys[k] + e);
      const uint4 s = *reinterpret_cast<const uint4*>(scs[k] + bc);
      const uint4 h = *reinterpret_cast<const uint4*>(shs[k] + bc);
      bf16* ve = reinterpret_cast<bf16*>(&v);
      const bf16* se = reinterpret_cast<const bf16*>(&s);
      const bf16* he = reinterpret_cast<const bf16*>(&h);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ve[j] = rnd(fmaxf(affine(ve[j], se[j], he[j]), 0.f));
      *reinterpret_cast<uint4*>(outs[k] + e) = v;
    }
  }
}

// dgrad: Y[b, p, n] = epi(sum_k A'[b, p, k] * Wt[n, k]) for the 128 rows p
// of tile blockIdx.y of image b, k over TAPS taps x K0 channels (tap-major),
// A' the cotangent at the tap's neighbour pixel (0 outside the image), with
// the EPI_MASK or EPI_RESID epilogue; EPI_MASK writes per-CTA
// per-channel partials to part[b, mt, 2, N] (MT = ceil(HW / 128)).
template <int TAPS, int EPI, int BN>
__global__ void __launch_bounds__(hopper::CONV_THREADS) dgrad_gemm(
    const bf16* __restrict__ A, const bf16* __restrict__ Wt,
    bf16* __restrict__ Y, float* __restrict__ part, int H, int W, int K0,
    int N, EpiArgs ep) {
  extern __shared__ char smem_raw[];
  char* smem = hopper::align1024(smem_raw);
  const int HW = H * W;
  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y, MT = gridDim.y;
  const int m0 = mt * hopper::CONV_BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int K = TAPS * K0;

  hopper::CopyA<TAPS == 9 ? 3 : 1> pa;
  {
    const int p = m0 + (tid >> 1);
    const int pp = p < HW ? p : 0;
    pa.row.valid = p < HW;
    pa.row.img = reinterpret_cast<const char*>(A + (size_t)b * HW * K0);
    pa.row.iy0 = pp / W - (TAPS == 9);
    pa.row.ix0 = pp % W - (TAPS == 9);
    pa.H = H;
    pa.W = W;
    pa.cb = K0 * 2;
    pa.kb = K * 2;
  }
  float acc[BN / 2];
  hopper::conv_mainloop<BN>(
      acc, smem, pa, reinterpret_cast<const char*>(Wt + (size_t)n0 * K),
      K * 2);

  // Epilogue: bf16(acc) into a [128][BN] tile in shared memory (rows
  // padded by 16 bytes: conflict-free), then each thread takes 8 columns
  // of every 16th (BN = 128) or 32nd (BN = 64) row with 16-byte loads and
  // stores: the mask and the GN partials (EPI_MASK) or the residual add
  // (EPI_RESID).
  constexpr int PITCH = BN + 8;         // bf16
  constexpr int CH = BN / 8;            // 8-column chunks per row
  constexpr int RG = hopper::CONV_THREADS / CH;  // row groups
  bf16* tile = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* trow = tile + hopper::acc_row(tid, half) * PITCH;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(trow + hopper::acc_col(tid, j)) =
          __halves2bfloat162(rnd(acc[4 * j + 2 * half]),
                             rnd(acc[4 * j + 2 * half + 1]));
  }
  __syncthreads();
  const int cq = tid % CH, rg = tid / CH;
  const int col = n0 + cq * 8;
  // This thread's columns' GN terms (EPI_MASK) and partial sums.
  float s[8], q[8], mn[8], iv[8];
  uint4 scv, shv;
  const bf16* se = reinterpret_cast<const bf16*>(&scv);
  const bf16* he = reinterpret_cast<const bf16*>(&shv);
  if constexpr (EPI == EPI_MASK) {
    const size_t bc = (size_t)b * N + col;
    scv = *reinterpret_cast<const uint4*>(ep.sc + bc);
    shv = *reinterpret_cast<const uint4*>(ep.sh + bc);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = q[e] = 0.f;
      mn[e] = ep.mean[bc + e];
      iv[e] = ep.inv[bc + e];
    }
  }
  for (int r = rg; r < hopper::CONV_BM; r += RG) {
    const int p = m0 + r;
    if (p >= HW) break;
    const size_t at = ((size_t)b * HW + p) * N + col;
    uint4 v = *reinterpret_cast<const uint4*>(tile + r * PITCH + cq * 8);
    bf16* ve = reinterpret_cast<bf16*>(&v);
    if constexpr (EPI == EPI_MASK) {
      const uint4 yv = *reinterpret_cast<const uint4*>(ep.yf + at);
      const bf16* ye = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!(affine(ye[e], se[e], he[e]) > 0.f)) ve[e] = rnd(0.f);
        const float d = f32(ve[e]);
        const float yhat = (f32(ye[e]) - mn[e]) * iv[e];
        s[e] += d;
        q[e] += d * yhat;
      }
    } else {
      const uint4 rv = *reinterpret_cast<const uint4*>(ep.res + at);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) ve[e] = rnd(f32(ve[e]) + f32(re[e]));
    }
    *reinterpret_cast<uint4*>(Y + at) = v;
  }
  if constexpr (EPI == EPI_MASK) {
    // Column sums over the row groups, in order, through shared memory.
    float* red =
        reinterpret_cast<float*>(smem) + hopper::CONV_BM * PITCH / 2;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(rg * 2 + 0) * BN + cq * 8 + e] = s[e];
      red[(rg * 2 + 1) * BN + cq * 8 + e] = q[e];
    }
    __syncthreads();
    for (int c = tid; c < 2 * BN; c += hopper::CONV_THREADS) {
      const int st = c / BN, cc = c % BN;
      float a = 0.f;
      for (int g = 0; g < RG; ++g) a += red[(g * 2 + st) * BN + cc];
      part[(((size_t)b * MT + mt) * 2 + st) * N + n0 + cc] = a;
    }
  }
}

// Dynamic shared memory of a dgrad_gemm instance for K = kb bytes: its
// ring, or its epilogue's tile and row-group sums where larger.
template <int BN>
int dgrad_smem_bytes(int kb) {
  const int epi = hopper::CONV_BM * (BN + 8) * 2 +
                  hopper::CONV_THREADS / (BN / 8) * 2 * BN * 4 + 1024;
  const int ring = hopper::conv_smem_bytes<BN>(kb);
  return ring > epi ? ring : epi;
}

// Weight gradient, one K-slice per CTA:
//   part[s, tap, i, j] = sum over rows r of slice s of P[r, i] * Q_tap[r, j]
// Rows r = b*HW + p run over every pixel of every image; Q_tap[r] is Q at
// pixel p shifted by the tap's (dy, dx) in image b, zero outside the image.
// Both tiles are staged as they lie in memory (rows r, 64-channel atoms of
// 128 bytes in the 128-byte swizzle: MN-major), and wgmma reads them
// transposed: warpgroup w takes rows i of atom w and issues one m64n64k16
// per 64 columns of j.
constexpr int WG_BK = 64;      // rows of K per stage
constexpr int WG_STAGES = 3;

template <int BI, int BJ>
__host__ __device__ constexpr int wgrad_smem_bytes() {
  return WG_STAGES * (BI + BJ) / 64 * WG_BK * 128 + 1024;
}

template <int TAPS, int BI, int BJ>
__global__ void __launch_bounds__(2 * BI) wgrad_gemm(
    const bf16* __restrict__ P, const bf16* __restrict__ Q,
    float* __restrict__ part, int Bn, int H, int W, int M, int N, int S) {
  constexpr int NTH = 2 * BI;         // one warpgroup per 64 rows of i
  constexpr int ATOM = WG_BK * 128;   // bytes: 64 channels x WG_BK rows
  constexpr int AJ = BJ / 64;
  constexpr int STAGE = (BI / 64 + AJ) * ATOM;
  extern __shared__ char wsm_raw[];
  char* sm = hopper::align1024(wsm_raw);
  const uint32_t base = hopper::smem_u32(sm);

  const int j0 = blockIdx.x * BJ, i0 = blockIdx.y * BI;
  const int s = blockIdx.z / TAPS, tap = blockIdx.z % TAPS;
  const int HW = H * W;
  const long long R = (long long)Bn * HW;
  const long long KTall = (R + WG_BK - 1) / WG_BK;
  const int kt0 = (int)(s * KTall / S), kt1 = (int)((s + 1) * KTall / S);
  const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
  const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  // Chunk (row rr, 16-byte piece cc of the tile's row) of an MN-major
  // stage: atom cc / 8, swizzled within it.
  auto at = [](int rr, int cc) {
    return (uint32_t)((cc >> 3) * ATOM + rr * 128 + (((cc & 7) ^ (rr & 7)) << 4));
  };
  auto load = [&](int kt) {
    const uint32_t ps = base + (kt % WG_STAGES) * STAGE;
    const uint32_t qs = ps + BI / 64 * ATOM;
    for (int c = tid; c < WG_BK * BI / 8; c += NTH) {
      const int rr = c / (BI / 8), cc = c % (BI / 8);
      const long long r = (long long)kt * WG_BK + rr;
      const bool ok = r < R;
      hopper::cp_async16(ps + at(rr, cc), P + (ok ? r * M + i0 + cc * 8 : 0),
                         ok ? 16 : 0);
    }
    for (int c = tid; c < WG_BK * BJ / 8; c += NTH) {
      const int rr = c / (BJ / 8), cc = c % (BJ / 8);
      const long long r = (long long)kt * WG_BK + rr;
      bool ok = r < R;
      size_t off = 0;
      if (ok) {
        const int b = (int)(r / HW);
        const int p = (int)(r - (long long)b * HW);
        const int yy = p / W + dy, xx = p % W + dx;
        ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
        off = ((size_t)b * HW + yy * W + xx) * N + j0 + cc * 8;
      }
      hopper::cp_async16(qs + at(rr, cc), Q + (ok ? off : 0), ok ? 16 : 0);
    }
  };

  float acc[AJ][32];
#pragma unroll
  for (int aj = 0; aj < AJ; ++aj)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[aj][e] = 0.f;

#pragma unroll
  for (int st = 0; st < WG_STAGES - 1; ++st) {
    if (kt0 + st < kt1) load(kt0 + st);
    hopper::cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    hopper::cp_async_wait<WG_STAGES - 2>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (kt + WG_STAGES - 1 < kt1) load(kt + WG_STAGES - 1);
    hopper::cp_async_commit();
    const uint32_t ps = base + (kt % WG_STAGES) * STAGE;
    const uint32_t qs = ps + BI / 64 * ATOM;
#pragma unroll
    for (int aj = 0; aj < AJ; ++aj) hopper::fence_operands(acc[aj]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks)
#pragma unroll
      for (int aj = 0; aj < AJ; ++aj)
        hopper::wgmma_bf16_mn_n64(
            acc[aj], hopper::sw128_mn_desc(ps + wg * ATOM + ks * 2048),
            hopper::sw128_mn_desc(qs + aj * ATOM + ks * 2048));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int aj = 0; aj < AJ; ++aj) hopper::fence_operands(acc[aj]);
  }
  hopper::cp_async_wait<0>();

  float* out = part + ((size_t)s * TAPS + tap) * M * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + hopper::acc_row(tid, half);
#pragma unroll
    for (int aj = 0; aj < AJ; ++aj)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = j0 + aj * 64 + hopper::acc_col(tid, jj);
        *reinterpret_cast<float2*>(out + (size_t)i * N + j) = make_float2(
            acc[aj][4 * jj + 2 * half], acc[aj][4 * jj + 2 * half + 1]);
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

namespace {

template <int TAPS, int EPI>
cudaError_t dgrad(const bf16* A, const bf16* Wt, bf16* Y, float* part, int B,
                  int H, int W, int K0, int N, const EpiArgs& ep,
                  cudaStream_t st) {
  const int MT = (H * W + hopper::CONV_BM - 1) / hopper::CONV_BM;
  cudaError_t e;
  const int kb = TAPS * K0 * 2;
  if (N % 128 == 0) {
    static bool sized[hopper::MAX_DEVICES] = {};
    if ((e = hopper::allow_smem(dgrad_gemm<TAPS, EPI, 128>,
                                dgrad_smem_bytes<128>(1 << 30), sized)) !=
        cudaSuccess)
      return e;
    dgrad_gemm<TAPS, EPI, 128><<<dim3(N / 128, MT, B), hopper::CONV_THREADS,
                                 dgrad_smem_bytes<128>(kb), st>>>(
        A, Wt, Y, part, H, W, K0, N, ep);
  } else {
    static bool sized[hopper::MAX_DEVICES] = {};
    if ((e = hopper::allow_smem(dgrad_gemm<TAPS, EPI, 64>,
                                dgrad_smem_bytes<64>(1 << 30), sized)) !=
        cudaSuccess)
      return e;
    dgrad_gemm<TAPS, EPI, 64><<<dim3(N / 64, MT, B), hopper::CONV_THREADS,
                                dgrad_smem_bytes<64>(kb), st>>>(
        A, Wt, Y, part, H, W, K0, N, ep);
  }
  return cudaGetLastError();
}

template <int TAPS, int BI, int BJ>
cudaError_t wgrad_tile(const bf16* P, const bf16* Q, float* part, int B,
                       int H, int W, int M, int N, int S, cudaStream_t st) {
  constexpr int smem = wgrad_smem_bytes<BI, BJ>();
  static bool sized[hopper::MAX_DEVICES] = {};
  const cudaError_t e =
      hopper::allow_smem(wgrad_gemm<TAPS, BI, BJ>, smem, sized);
  if (e != cudaSuccess) return e;
  wgrad_gemm<TAPS, BI, BJ><<<dim3(N / BJ, M / BI, S * TAPS), 2 * BI,
                             smem, st>>>(P, Q, part, B, H, W, M, N, S);
  return cudaGetLastError();
}

// 128-wide tiles where M (N) allows, else 64 (the wrapper's _slices makes
// the same choice).
template <int TAPS>
cudaError_t wgrad(const bf16* P, const bf16* Q, float* part, int B, int H,
                  int W, int M, int N, int S, cudaStream_t st) {
  if (M % 128 == 0 && N % 128 == 0)
    return wgrad_tile<TAPS, 128, 128>(P, Q, part, B, H, W, M, N, S, st);
  if (M % 128 == 0)
    return wgrad_tile<TAPS, 128, 64>(P, Q, part, B, H, W, M, N, S, st);
  if (N % 128 == 0)
    return wgrad_tile<TAPS, 64, 128>(P, Q, part, B, H, W, M, N, S, st);
  return wgrad_tile<TAPS, 64, 64>(P, Q, part, B, H, W, M, N, S, st);
}

}  // namespace

// x, dout, dx: [B,H,W,C] bf16.  Weights (bf16): w1 [F,C] and its transpose
// w1t [C,F]; w2 [F,9F] forward taps (out, tap, in) and w2r [F,9F] the
// dgrad's reversed taps (in, tap, out); w3 [C,F] and w3t [F,C].  g*/b* fp32
// GN affines.  Scratch: y1, y2 [B,HW,F], y3 [B,HW,C] bf16; planes [2,B,HW,F]
// bf16 (a1, a2); part [B, ceil(HW/64), 2, C] fp32; ss [6,B,C] bf16
// scale/shift; mv [6,B,C] fp32 mean/inv; dn3 [B,HW,C], dn21 [B,HW,F], dyb
// [B,HW,C] bf16; tt [2,B,C] fp32; gimg [6,B,C] fp32; wpart fp32 of
// max(S1*F*C, S2*9*F*F, S3*C*F); tickets [B] words, 0 on entry (left 0).  Outputs (fp32): dk1 [F,C], dk2 [F,F,3,3],
// dk3 [C,F], dg*/db* [F] or [C].  S1..S3: K-slices of the dk1, dk2, dk3
// wgrads.  Requires C % 64 == 0, F % 64 == 0, F <= 512, GN groups of C/G3
// and F/G1 channels that divide 64, and 1 <= S <= ceil(B*H*W/64) (checked
// by the Python wrapper).  Returns the first launch error (0 =
// cudaSuccess).
extern "C" int fused_bottleneck_bwd(
    const void* x, const void* dout, const void* w1, const void* w1t,
    const void* g1, const void* b1, const void* w2, const void* w2r,
    const void* g2, const void* b2, const void* w3, const void* w3t,
    const void* g3, const void* b3, void* y1, void* y2, void* y3,
    void* planes, void* part, void* ss, void* mv, void* dn3, void* dn21,
    void* dyb, void* tt, void* gimg, void* wpart, void* tickets, void* dx,
    void* dk1, void* dk2, void* dk3, void* dg1, void* db1, void* dg2, void* db2,
    void* dg3, void* db3, int B, int H, int W, int C, int F, int G1, int G3,
    int S1, int S2, int S3, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const int MT = (HW + BM - 1) / BM;  // out_mask_bwd's 64-row tiles (P4)
  const int MT2 = (HW + hopper::CONV_BM - 1) / hopper::CONV_BM;  // dgrad's
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
  bf16* A1 = static_cast<bf16*>(planes);
  bf16* A2 = A1 + (size_t)B * HW * F;
  const float *G1p = static_cast<const float*>(g1),
              *G2p = static_cast<const float*>(g2),
              *G3p = static_cast<const float*>(g3);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const size_t nF = (size_t)B * HW * F / 8;
  cudaError_t e;
#define CHECK()                                         \
  if ((e = cudaGetLastError()) != cudaSuccess) return e
#define CALL(expr)                                      \
  if ((e = (expr)) != cudaSuccess) return e

  // P1-P3: the forward, as B1 computes it, keeping fp32 mean/inv; then the
  // wgrads' relu(GN affine) planes a1, a2.
  CALL((fwd_conv<1, false>(
      fwd_args(X, static_cast<const bf16*>(w1), nullptr, nullptr, Y1, pt, tk,
               H, W, C, F, eps,
               {0, F, G1, G1p, static_cast<const float*>(b1), sc1, sh1, mean1,
                inv1}),
      B, st)));
  CALL((fwd_conv<9, true>(
      fwd_args(Y1, static_cast<const bf16*>(w2), sc1, sh1, Y2, pt, tk, H, W,
               F, F, eps,
               {0, F, G1, G2p, static_cast<const float*>(b2), sc2, sh2, mean2,
                inv2}),
      B, st)));
  CALL((fwd_conv<1, true>(
      fwd_args(Y2, static_cast<const bf16*>(w3), sc2, sh2, Y3, pt, tk, H, W,
               F, C, eps,
               {0, C, G3, G3p, static_cast<const float*>(b3), sc3, sh3, mean3,
                inv3}),
      B, st)));
  relu_planes<<<grid1d(nF, 256), 256, 0, st>>>(Y1, Y2, sc1, sh1, sc2, sh2,
                                              A1, A2, HW, F, nF);
  CHECK();

  // P4 + GN3 backward.
  out_mask_bwd<<<dim3(C / BN, MT, B), 256, 0, st>>>(
      Y3, X, static_cast<const bf16*>(dout), sc3, sh3, mean3, inv3, DN3, pt,
      HW, C);
  CHECK();
  gn_bwd_finalize<<<dim3(C / 64, B), 256, 0, st>>>(
      pt, MT, C, G3, HW, G3p, t1, t2, gi + 4 * bc, gi + 5 * bc);
  CHECK();
  gn_bwd_dy<<<grid1d(bc * HW / 8, 256), 256, 0, st>>>(
      DN3, Y3, G3p, mean3, inv3, t1, t2, DY, HW, C, bc * HW / 8);
  CHECK();

  // P5: da2 = dy3.k3^T masked by GN2 -> dn2; dk3 = dy3^T . a2.
  const EpiArgs ep2 = {Y2, sc2, sh2, mean2, inv2, nullptr};
  CALL((dgrad<1, EPI_MASK>(DY, static_cast<const bf16*>(w3t), DN, pt, B, H,
                           W, C, F, ep2, st)));
  CALL(wgrad<1>(DY, A2, wp, B, H, W, C, F, S3, st));
  reduce_slices<<<grid1d((size_t)C * F, 256), 256, 0, st>>>(
      wp, static_cast<float*>(dk3), S3, 1, C, F);
  CHECK();
  gn_bwd_finalize<<<dim3(F / 64, B), 256, 0, st>>>(
      pt, MT2, F, G1, HW, G2p, t1, t2, gi + 2 * bc, gi + 3 * bc);
  CHECK();
  gn_bwd_dy<<<grid1d(nF, 256), 256, 0, st>>>(DN, Y2, G2p, mean2, inv2, t1,
                                             t2, DY, HW, F, nF);
  CHECK();

  // P6: conv2 dgrad over the reverse taps of dy2, masked by GN1 -> dn1
  // (over dn2, which dy2 has consumed); dk2 over the nine a1 taps.
  const EpiArgs ep1 = {Y1, sc1, sh1, mean1, inv1, nullptr};
  CALL((dgrad<9, EPI_MASK>(DY, static_cast<const bf16*>(w2r), DN, pt, B, H,
                           W, F, F, ep1, st)));
  CALL(wgrad<9>(DY, A1, wp, B, H, W, F, F, S2, st));
  reduce_slices<<<grid1d((size_t)9 * F * F, 256), 256, 0, st>>>(
      wp, static_cast<float*>(dk2), S2, 9, F, F);
  CHECK();
  gn_bwd_finalize<<<dim3(F / 64, B), 256, 0, st>>>(
      pt, MT2, F, G1, HW, G1p, t1, t2, gi, gi + bc);
  CHECK();
  gn_bwd_dy<<<grid1d(nF, 256), 256, 0, st>>>(DN, Y1, G1p, mean1, inv1, t1,
                                             t2, DY, HW, F, nF);
  CHECK();

  // P7: dx = bf16(dy1.k1^T) + dn3; dk1 = dy1^T . x.
  EpiArgs ep0 = {};
  ep0.res = DN3;
  CALL((dgrad<1, EPI_RESID>(DY, static_cast<const bf16*>(w1t),
                            static_cast<bf16*>(dx), nullptr, B, H, W, F, C,
                            ep0, st)));
  CALL(wgrad<1>(DY, X, wp, B, H, W, F, C, S1, st));
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
#undef CALL
#undef CHECK
}
