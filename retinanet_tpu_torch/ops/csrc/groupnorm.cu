// Fused GroupNorm + activation for Hopper (sm_90a): kernel B4.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/groupnorm.py:
// fused_group_norm_act (_stats_kernel, _apply_kernel via _fused_forward):
//     out = act(x * scale[b,c] + shift[b,c])   fp32 affine, cast to x's type
//     scale = inv * gamma,  shift = beta - mean * inv * gamma
// with fp32 per-image group moments from per-channel sums of x and x^2,
// var = E[x^2] - E[x]^2 clamped at 0, inv = rsqrt(var + eps).  x is
// [B, H*W, C] bf16 or fp32 (NHWC); activations in the TPU kernel's forms
// (none / elu = exp(min(x,0)) - 1 / relu / relu6 / swish = x/(1+exp(-x)) /
// tanh gelu).
//
// What bounds it here: one read of x for the statistics and one read and
// one write for the affine, a handful of flops per byte: device memory.
// The TPU kernel carried the sums across a sequential grid in VMEM; CTAs
// on the card run in no order, so the op takes three launches:
//   1. gn_stats: one CTA per (row block, image) sums its rows per channel
//      in fp32, 16 bytes per thread load, thread partitions reduced in a
//      fixed order through shared memory -> part[b, rb, 2, C];
//   2. gn_moments: one CTA per image sums the partials over row blocks in
//      order, forms the group moments and writes fp32 scale/shift [2,B,C];
//   3. gn_apply: the fp32 affine + activation, 16 bytes per thread.
// No float atomics: repeated runs are bitwise equal.  Compile with
// -fmad=false: the affine's multiply and add each round, as the plain
// version's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace b4_group_norm {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1:  // elu
      return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
    case 2:  // relu
      return fmaxf(x, 0.f);
    case 3:  // relu6
      return fminf(fmaxf(x, 0.f), 6.f);
    case 4:  // swish
      return x / (1.f + expf(-x));
    case 5:  // gelu, tanh form
      return 0.5f * x *
             (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
    default:
      return x;
  }
}

// grid (NRB, B).  Rows [rb*R, min(rb*R + R, HW)) of image b, every channel.
template <typename T>
__global__ void __launch_bounds__(NT) gn_stats(const T* __restrict__ x,
                                               float* __restrict__ part,
                                               int HW, int C, int R) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[2][NT * VEC];
  const int rb = blockIdx.x, b = blockIdx.y, NRB = gridDim.x;
  const int lanes = C / VEC;
  const int LP = lanes < NT ? lanes : NT;  // channel vectors per pass
  const int P = NT / LP;                   // row partitions
  const int tid = threadIdx.x;
  const int p = tid / LP, cvl = tid % LP;
  const int r0 = rb * R;
  const int r1 = min(r0 + R, HW);
  const T* xb = x + (size_t)b * HW * C;
  for (int cv0 = 0; cv0 < lanes; cv0 += LP) {
    const int cv = cv0 + cvl;
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    if (p < P && cv < lanes) {
      for (int r = r0 + p; r < r1; r += P) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(xb + (size_t)r * C + cv * VEC);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = to_f32(e[j]);
          s[j] += v;
          q[j] += v * v;
        }
      }
    }
    if (p < P) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[0][p * LP * VEC + cvl * VEC + j] = s[j];
        red[1][p * LP * VEC + cvl * VEC + j] = q[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < LP * VEC; i += NT) {
      const int c = cv0 * VEC + i;
      if (c >= C) continue;
      float ts = 0.f, tq = 0.f;
      for (int pp = 0; pp < P; ++pp) {
        ts += red[0][pp * LP * VEC + i];
        tq += red[1][pp * LP * VEC + i];
      }
      float* pm = part + ((size_t)b * NRB + rb) * 2 * C;
      pm[c] = ts;
      pm[C + c] = tq;
    }
    __syncthreads();
  }
}

// One CTA per image: fixed-order sums over the NRB partials, group
// moments, fp32 scale/shift.  Dynamic smem: 2C + 2G floats.
__global__ void gn_moments(const float* __restrict__ part, int NRB, int C,
                           int groups, int HW, const float* __restrict__ gamma,
                           const float* __restrict__ beta, float eps,
                           float* __restrict__ scale,
                           float* __restrict__ shift) {
  extern __shared__ float sm[];
  float* ch = sm;            // [2, C]
  float* gm = sm + 2 * C;    // [2, groups]
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int m = 0; m < NRB; ++m) {
      const float* pm = part + ((size_t)b * NRB + m) * 2 * C;
      s1 += pm[c];
      s2 += pm[C + c];
    }
    ch[c] = s1;
    ch[C + c] = s2;
  }
  __syncthreads();
  const int cg = C / groups;
  const float cnt = (float)HW * (float)cg;
  for (int gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      s1 += ch[gi * cg + j];
      s2 += ch[C + gi * cg + j];
    }
    const float mean = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
    gm[gi] = mean;
    gm[groups + gi] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int gi = c / cg;
    const float mean = gm[gi], inv = gm[groups + gi];
    scale[(size_t)b * C + c] = inv * gamma[c];
    shift[(size_t)b * C + c] = beta[c] - mean * inv * gamma[c];
  }
}

template <typename T>
__global__ void gn_apply(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ out,
                         int HW, int C, int act, size_t nvec) {
  constexpr int VEC = 16 / sizeof(T);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < nvec;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * VEC;
    const size_t bc = (e / ((size_t)HW * C)) * C + (e % C);
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    const T* xe = reinterpret_cast<const T*>(&raw);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = to_f32(xe[j]) * scale[bc + j] + shift[bc + j];
      from_f32(activate(y, act), oe + j);
    }
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

template <typename T>
cudaError_t run(const void* x, const float* gamma, const float* beta,
                float* part, float* ss, void* out, int B, int HW, int C,
                int groups, int act, int R, float eps, cudaStream_t st) {
  cudaError_t e;
  const int NRB = (HW + R - 1) / R;
  gn_stats<T><<<dim3(NRB, B), NT, 0, st>>>(static_cast<const T*>(x), part,
                                           HW, C, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem = (2 * (size_t)C + 2 * (size_t)groups) * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gn_moments,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  gn_moments<<<B, NT, smem, st>>>(part, NRB, C, groups, HW, gamma, beta, eps,
                                  ss, ss + (size_t)B * C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  constexpr int VEC = 16 / sizeof(T);
  const size_t nvec = (size_t)B * HW * C / VEC;
  const size_t want = (nvec + NT - 1) / NT;
  const int blocks = (int)(want < 65535 ? want : 65535);
  gn_apply<T><<<blocks, NT, 0, st>>>(static_cast<const T*>(x), ss,
                                     ss + (size_t)B * C, static_cast<T*>(out),
                                     HW, C, act, nvec);
  return cudaGetLastError();
}

}  // namespace b4_group_norm
}  // namespace

using namespace b4_group_norm;

// x, out [B, HW, C] bf16 (dtype 0) or fp32 (1); gamma, beta [C] fp32;
// part [B, ceil(HW/R), 2, C] fp32 scratch; ss [2, B, C] fp32 scale/shift.
// C % (16 / sizeof(element)) == 0 and C % groups == 0 (checked by the
// Python wrapper).  Returns the first launch error (0 = cudaSuccess).
extern "C" int fused_group_norm_act_fwd(const void* x, const void* gamma,
                                        const void* beta, void* part,
                                        void* ss, void* out, int B, int HW,
                                        int C, int groups, int dtype, int act,
                                        int R, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* p = static_cast<float*>(part);
  float* s = static_cast<float*>(ss);
  if (dtype == 0)
    return run<bf16>(x, g, be, p, s, out, B, HW, C, groups, act, R, eps, st);
  return run<float>(x, g, be, p, s, out, B, HW, C, groups, act, R, eps, st);
}
