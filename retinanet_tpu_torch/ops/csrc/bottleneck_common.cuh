// Device code shared by the fused bottlenecks B1 (bottleneck.cu) and B5
// (bottleneck_proj.cu) and by B1's backward B3 (bottleneck_bwd.cu): the
// bf16 GN affine, the forward convolution GEMM (fwd_gemm) on
// hopper_gemm.cuh's wgmma mainloop with its GN-affine+relu prologue, its
// statistics epilogue and the GN finalize its last CTA per image runs, and
// B3's epilogue arguments.  Compile with -fmad=false: the bf16 affine and
// the fp32 GN terms must round after every multiply, as the plain versions
// do.  The including file names the namespace (BOTTLENECK_NS) its copy of
// these kernels lives in, so that a profile tells B1's launches from B3's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_gemm.cuh"

#ifndef BOTTLENECK_NS
#error "define BOTTLENECK_NS before including bottleneck_common.cuh"
#endif

namespace {
namespace BOTTLENECK_NS {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rnd(float v) { return __float2bfloat16_rn(v); }

// bf16 GN affine (+ relu): y*scale rounds, +shift rounds.
__device__ __forceinline__ float affine(bf16 y, bf16 sc, bf16 sh) {
  float p = f32(rnd(f32(y) * f32(sc)));
  return f32(rnd(p + f32(sh)));
}

// The same on two packed bf16 values, then relu: mul.rn and add.rn round
// each result to bf16 once, as affine() does (a product of two bf16 values
// is exact in fp32, and a sum that fp32 rounds lies far from a bf16 tie).
__device__ __forceinline__ uint32_t affine_relu2(uint32_t y, uint32_t sc,
                                                 uint32_t sh) {
  uint32_t p, a, r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(y), "r"(sc));
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(a) : "r"(p), "r"(sh));
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(0u));
  return r;
}

// B3's dgrad epilogues (bottleneck_bwd.cu), with each rounded output y:
//   EPI_MASK   store d = (GN affine of yf > 0) ? y : 0, where yf is the
//              forward's pre-GN plane of this layer; partials (sum d,
//              sum d*yhat) with yhat = (yf - mean) * inv
//   EPI_RESID  store bf16(y + res)                          (dx + dn3)
enum Epilogue { EPI_MASK = 1, EPI_RESID = 2 };

struct EpiArgs {
  const bf16* yf;     // [B, HW, N] forward pre-GN values (EPI_MASK)
  const bf16* sc;     // [B, N] bf16 GN scale, shift (EPI_MASK)
  const bf16* sh;
  const float* mean;  // [B, N] fp32 GN mean, inv-std (EPI_MASK)
  const float* inv;
  const bf16* res;    // [B, HW, N] residual (EPI_RESID)
};

// Channels of a prologue GN the CTA stages in shared memory, after its
// ring (the inner width F <= 512).
constexpr int MAX_PRO_K = 512;

// The A producer of a convolution whose input is the previous conv's
// pre-GN output: copies as CopyA does, then, once a stage has landed, maps
// each in-image 16-byte chunk this thread copied through the previous GN's
// bf16 affine and relu (scale and shift of its image in shared memory).
// Chunks zero-filled outside the image stay 0: conv2's SAME zeros are
// post-GN zeros, never relu(shift).
template <int KS>
struct CopyAGn : hopper::CopyA<KS> {
  const bf16* sc;  // [K0] in shared memory
  const bf16* sh;

  __device__ __forceinline__ void landed(uint32_t sa, int k0, int tid) const {
    const char* src;
    int c0;
    if (!this->source(k0, tid, &src, &c0)) return;
    const int r = tid >> 1, h = tid & 1;
    const bf16* s0 = sc + c0 / 2;
    const bf16* h0 = sh + c0 / 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t at = sa + hopper::sw128(r, h * 4 + j);
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(at)
                   : "memory");
      const uint4 s = *reinterpret_cast<const uint4*>(s0 + 8 * j);
      const uint4 t = *reinterpret_cast<const uint4*>(h0 + 8 * j);
      v.x = affine_relu2(v.x, s.x, t.x);
      v.y = affine_relu2(v.y, s.y, t.y);
      v.z = affine_relu2(v.z, s.z, t.z);
      v.w = affine_relu2(v.w, s.w, t.w);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(at),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
};

// One GroupNorm over GEMM columns [c0, c0 + n): n channels in `groups`
// groups, fp32 gamma/beta [n]; the finalize writes the bf16 per-channel
// scale = inv*gamma and shift = beta - mean*inv*gamma [B, n] and, where
// mean is not null, the fp32 per-channel mean and inverse std [B, n].
struct GnOut {
  int c0, n, groups;
  const float* gamma;
  const float* beta;
  bf16* scale;
  bf16* shift;
  float* mean;
  float* inv;
};

// Y[b, p, n] = bf16(sum_k A'[b, p, k] * Wt[n, k]) for image b, k over TAPS
// taps x K0 input channels (tap-major), A' the input at the tap's neighbour
// pixel (0 outside the image), mapped through a prologue GN where psc is
// given.  Columns [0, ldy) go to y [B, HW, ldy], columns [ldy, N) to y2
// [B, HW, N - ldy] (B5's projection).  The GNs in gn cover the N columns
// in order, at most 128 groups in all, each group's channels inside one
// tile.  Each CTA writes per-group (sum y, sum y^2) partials to
// part [B, MT, 2, groups]; the image's last CTA (an atomic ticket, 0 on
// entry and left 0) finalizes each GN.
struct FwdArgs {
  const bf16* A;
  const bf16* Wt;
  const bf16* psc;  // [B, K0] prologue GN scale, shift (PRO)
  const bf16* psh;
  bf16* y;
  bf16* y2;
  int ldy;
  float* part;
  unsigned* ticket;  // [B]
  int H, W, K0, N;
  float eps;
  int ngn;
  GnOut gn[2];
};

// The last CTA of image b: reduce the image's per-group partials over its
// MT tiles in a fixed order (S segments of tiles, each summed in order by
// one thread, then the segments in order), form each GN's group moments
// and write its per-channel outputs.  The 2 * NG <= 256 (statistic, group)
// pairs take a thread each per segment.  sm: 3 * 256 floats.
__device__ __forceinline__ void finalize_image(const FwdArgs& a, int b,
                                               int MT, int HW, float* sm) {
  const int tid = threadIdx.x;
  const int NG = a.gn[0].groups + (a.ngn > 1 ? a.gn[1].groups : 0);
  const int P = 2 * NG;  // (statistic, group) pairs
  const int S = hopper::CONV_THREADS / P;
  const float* pb = a.part + (size_t)b * MT * P;
  for (int i = tid; i < S * P; i += hopper::CONV_THREADS) {
    const int s = i / P, pr = i - s * P;
    const int m1 = (s + 1) * MT / S;
    float acc = 0.f;
#pragma unroll 16
    for (int m = s * MT / S; m < m1; ++m)
      acc += __ldcg(pb + (size_t)m * P + pr);
    sm[i] = acc;
  }
  __syncthreads();
  float* gs = sm + hopper::CONV_THREADS;  // [2, NG] image sums
  for (int pr = tid; pr < P; pr += hopper::CONV_THREADS) {
    float acc = sm[pr];
    for (int s = 1; s < S; ++s) acc += sm[s * P + pr];
    gs[pr] = acc;
  }
  __syncthreads();
  float* gm = gs + P;  // [2, groups] of the GN at hand
  for (int g = 0, g0 = 0; g < a.ngn; g0 += a.gn[g].groups, ++g) {
    const GnOut o = a.gn[g];
    const int cg = o.n / o.groups;
    const float cnt = (float)(HW * cg);
    for (int gi = tid; gi < o.groups; gi += hopper::CONV_THREADS) {
      const float mean = gs[g0 + gi] / cnt;
      const float var = fmaxf(gs[NG + g0 + gi] / cnt - mean * mean, 0.f);
      gm[gi] = mean;
      gm[o.groups + gi] = 1.0f / sqrtf(var + a.eps);
    }
    __syncthreads();
    for (int c = tid; c < o.n; c += hopper::CONV_THREADS) {
      const int gi = c / cg;
      const float mean = gm[gi], inv = gm[o.groups + gi];
      const size_t at = (size_t)b * o.n + c;
      o.scale[at] = rnd(inv * o.gamma[c]);
      o.shift[at] = rnd(o.beta[c] - mean * inv * o.gamma[c]);
      if (o.mean != nullptr) {
        o.mean[at] = mean;
        o.inv[at] = inv;
      }
    }
    __syncthreads();
  }
}

// One 128 x BN output tile of image blockIdx.z: the mainloop (prologue in
// the producer's landed hook), then the epilogue: bf16(acc) into a [128][BN]
// shared-memory tile (rows padded by 16 bytes: conflict-free), re-read by
// rows, 8 columns a thread, stored with 16-byte stores and summed per
// column over row groups in order, then per GN group; rows past HW enter
// neither.
template <int TAPS, bool PRO, int BN>
__global__ void __launch_bounds__(hopper::CONV_THREADS)
    fwd_gemm(const __grid_constant__ FwdArgs a) {
  constexpr int KS = TAPS == 9 ? 3 : 1;
  typedef typename std::conditional<PRO, CopyAGn<KS>, hopper::CopyA<KS>>::type
      Copy;
  extern __shared__ char smem_raw[];
  __shared__ bool last;
  char* smem = hopper::align1024(smem_raw);
  const int HW = a.H * a.W;
  const int n0 = blockIdx.x * BN;
  const int mt = blockIdx.y, MT = gridDim.y;
  const int m0 = mt * hopper::CONV_BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int K = TAPS * a.K0;

  Copy pa;
  {
    const int p = m0 + (tid >> 1);
    const int pp = p < HW ? p : 0;
    pa.row.valid = p < HW;
    pa.row.img = reinterpret_cast<const char*>(a.A + (size_t)b * HW * a.K0);
    pa.row.iy0 = pp / a.W - (TAPS == 9);
    pa.row.ix0 = pp % a.W - (TAPS == 9);
    pa.H = a.H;
    pa.W = a.W;
    pa.cb = a.K0 * 2;
    pa.kb = K * 2;
  }
  if constexpr (PRO) {
    // The image's scale and shift, after the ring: [2][K0] bf16.
    bf16* pro = reinterpret_cast<bf16*>(
        smem + hopper::conv_smem_bytes<BN>(K * 2) - 1024);
    for (int c = tid * 8; c < a.K0; c += hopper::CONV_THREADS * 8) {
      const size_t at = (size_t)b * a.K0 + c;
      *reinterpret_cast<uint4*>(pro + c) =
          *reinterpret_cast<const uint4*>(a.psc + at);
      *reinterpret_cast<uint4*>(pro + a.K0 + c) =
          *reinterpret_cast<const uint4*>(a.psh + at);
    }
    pa.sc = pro;
    pa.sh = pro + a.K0;
    __syncthreads();
  }
  float acc[BN / 2];
  hopper::conv_mainloop<BN>(
      acc, smem, pa, reinterpret_cast<const char*>(a.Wt + (size_t)n0 * K),
      K * 2);

  constexpr int PITCH = BN + 8;                  // bf16
  constexpr int CH = BN / 8;                     // 8-column chunks per row
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
  const bool first = n0 < a.ldy;
  const int ld = first ? a.ldy : a.N - a.ldy;
  bf16* Y = (first ? a.y : a.y2) + (size_t)b * HW * ld +
            (first ? n0 : n0 - a.ldy) + cq * 8;
  float s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  for (int r = rg; r < hopper::CONV_BM; r += RG) {
    const int p = m0 + r;
    if (p >= HW) break;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + r * PITCH + cq * 8);
    *reinterpret_cast<uint4*>(Y + (size_t)p * ld) = v;
    const bf16* ve = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float f = f32(ve[e]);
      s[e] += f;
      q[e] += f * f;
    }
  }
  float* red = reinterpret_cast<float*>(smem) + hopper::CONV_BM * PITCH / 2;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[(rg * 2 + 0) * BN + cq * 8 + e] = s[e];
    red[(rg * 2 + 1) * BN + cq * 8 + e] = q[e];
  }
  __syncthreads();
  // Column sums over the row groups in order, then each group's columns
  // in order: the tile's per-group partials.
  float* cols = red + RG * 2 * BN;  // [2, BN]
  for (int c = tid; c < 2 * BN; c += hopper::CONV_THREADS) {
    const int st = c / BN, cc = c % BN;
    float t = 0.f;
    for (int g = 0; g < RG; ++g) t += red[(g * 2 + st) * BN + cc];
    cols[c] = t;
  }
  __syncthreads();
  const int g = a.ngn > 1 && n0 >= a.gn[1].c0;  // the tile's GN
  const int cg = a.gn[g].n / a.gn[g].groups;
  const int NG = a.gn[0].groups + (a.ngn > 1 ? a.gn[1].groups : 0);
  const int gt = BN / cg;  // groups in the tile
  const int gbase = (g ? a.gn[0].groups : 0) + (n0 - a.gn[g].c0) / cg;
  for (int i = tid; i < 2 * gt; i += hopper::CONV_THREADS) {
    const int st = i / gt, gl = i - st * gt;
    float t = 0.f;
    for (int j = 0; j < cg; ++j) t += cols[st * BN + gl * cg + j];
    a.part[(((size_t)b * MT + mt) * 2 + st) * NG + gbase + gl] = t;
  }
  // Release (the barrier orders every thread's partials before thread 0's
  // fence and ticket); the image's last CTA finalizes its GNs from every
  // CTA's partials.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.ticket + b, 1u) == gridDim.x * (unsigned)MT - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  finalize_image(a, b, MT, HW, reinterpret_cast<float*>(smem));
  if (tid == 0) a.ticket[b] = 0u;
}

// Dynamic shared memory of a fwd_gemm instance for K = kb bytes and a
// prologue GN of pro_k channels (0: none): its ring and the GN's scale and
// shift, or its epilogue's tile, row-group and column sums (which the
// finalize's sums fit in), whichever is larger.
template <int BN>
__host__ __device__ constexpr int fwd_smem_bytes(int kb, int pro_k) {
  const int ring = hopper::conv_smem_bytes<BN>(kb) + pro_k * 4;
  const int epi = hopper::CONV_BM * (BN + 8) * 2 +
                  (hopper::CONV_THREADS / (BN / 8) + 1) * 2 * BN * 4 + 1024;
  return ring > epi ? ring : epi;
}

template <int TAPS, bool PRO, int BN>
cudaError_t fwd_launch(const FwdArgs& a, int B, cudaStream_t st) {
  static bool sized[hopper::MAX_DEVICES] = {};
  cudaError_t e = hopper::allow_smem(
      fwd_gemm<TAPS, PRO, BN>, fwd_smem_bytes<BN>(1 << 30, MAX_PRO_K), sized);
  if (e != cudaSuccess) return e;
  const int MT = (a.H * a.W + hopper::CONV_BM - 1) / hopper::CONV_BM;
  fwd_gemm<TAPS, PRO, BN>
      <<<dim3(a.N / BN, MT, B), hopper::CONV_THREADS,
         fwd_smem_bytes<BN>(TAPS * a.K0 * 2, PRO ? a.K0 : 0), st>>>(a);
  return cudaGetLastError();
}

// One forward conv of a bottleneck: 128 x 128 tiles where 128 divides N
// and ldy (so that no tile straddles y and y2), else 128 x 64.  Requires
// K0, N and ldy % 64 == 0, K0 <= MAX_PRO_K with a prologue, and GN groups
// of at most 64 channels that divide 64 (checked by the Python
// wrappers).
template <int TAPS, bool PRO>
cudaError_t fwd_conv(const FwdArgs& a, int B, cudaStream_t st) {
  return a.N % 128 == 0 && a.ldy % 128 == 0
             ? fwd_launch<TAPS, PRO, 128>(a, B, st)
             : fwd_launch<TAPS, PRO, 64>(a, B, st);
}

// The FwdArgs of a conv whose columns all go to y with one GN.
inline FwdArgs fwd_args(const bf16* A, const bf16* Wt, const bf16* psc,
                        const bf16* psh, bf16* y, float* part,
                        unsigned* ticket, int H, int W, int K0, int N,
                        float eps, GnOut gn) {
  FwdArgs a = {};
  a.A = A;
  a.Wt = Wt;
  a.psc = psc;
  a.psh = psh;
  a.y = y;
  a.ldy = N;
  a.part = part;
  a.ticket = ticket;
  a.H = H;
  a.W = W;
  a.K0 = K0;
  a.N = N;
  a.eps = eps;
  a.ngn = 1;
  a.gn[0] = gn;
  return a;
}

}  // namespace BOTTLENECK_NS
}  // namespace
