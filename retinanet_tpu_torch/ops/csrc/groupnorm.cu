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
// What bounds it here: x read once and out written once, a handful of
// flops per byte: device memory.  The TPU kernel carried the sums across a
// sequential grid in VMEM; CTAs here run in no order, so the statistics of
// an image must be complete before its affine starts.  Two paths, chosen
// by the wrapper from the shape:
//
// split (two launches, any shape):
//   1. gn_stats: one CTA per (row block, image) sums its rows per channel
//      in fp32 (16-byte loads, thread partitions reduced in a fixed order
//      through shared memory) into part[b, rb, 2, C]; the image's last CTA,
//      found by a ticket word it resets, sums the row blocks' partials in
//      order and writes the fp32 scale and shift [2, B, C];
//   2. gn_apply: one CTA per (row block, image), visited in the reverse of
//      the stats pass's order so that the rows it read last, still in L2,
//      are read again first; each thread keeps its channels' scale and
//      shift in registers and walks rows with 32-bit offsets and 16-byte
//      loads and stores.
// cluster (one launch, an image that fits the shared memory of a cluster of
// CS = 8 or 16 CTAs):
//   gn_cluster: each CTA bulk-copies its slice of the image's rows into
//   shared memory (chunks completing on mbarriers, summed as they land),
//   the cluster reduces the CTAs' channel partials over distributed shared
//   memory in rank order, and each CTA applies the affine to its rows from
//   shared memory: x is read from device memory once.
//
// No float atomics, fixed summation orders: repeated runs are bitwise
// equal.  Compile with -fmad=false: the affine's multiply and add each
// round, as the plain version's do.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {
namespace b4_group_norm {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;
constexpr int NT = 256;
constexpr int MAX_CHUNKS = 8;  // cluster path: bulk copies per CTA
constexpr int BAR_BYTES = 128;  // cluster path: the chunks' mbarriers

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

// How a CTA's NT threads cover C channels: thread (p, cvl) takes channel
// vector cv0 + cvl of every pass cv0 = 0, LP, 2LP, ... and rows p, p + P,
// ... of the CTA's rows.  Consecutive threads read consecutive 16 bytes.
template <typename T>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);
  int lanes, LP, P, p, cvl;
  __device__ Lanes(int C) {
    lanes = C / VEC;
    LP = lanes < NT ? lanes : NT;
    P = NT / LP;
    p = threadIdx.x / LP;
    cvl = threadIdx.x - p * LP;
  }
};

// Sums of x and x^2 per channel of rows [0, nrows) of ``rows`` (row
// stride C) into sums[2][C], thread partitions added in order through
// ``red`` [2][NT * VEC].  ``landed(r)`` runs before row r is read.
template <typename T, typename Landed>
__device__ void channel_sums(const T* rows, int nrows, int C, float* red,
                             float* sums, Landed landed) {
  constexpr int VEC = Lanes<T>::VEC;
  const Lanes<T> L(C);
  const int tid = threadIdx.x;
  for (int cv0 = 0; cv0 < L.lanes; cv0 += L.LP) {
    const int cv = cv0 + L.cvl;
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    if (L.p < L.P && cv < L.lanes) {
#pragma unroll 4
      for (int r = L.p; r < nrows; r += L.P) {
        landed(r);
        const uint4 raw =
            *reinterpret_cast<const uint4*>(rows + r * C + cv * VEC);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = to_f32(e[j]);
          s[j] += v;
          q[j] += v * v;
        }
      }
    }
    if (L.p < L.P) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[L.p * L.LP * VEC + L.cvl * VEC + j] = s[j];
        red[NT * VEC + L.p * L.LP * VEC + L.cvl * VEC + j] = q[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < L.LP * VEC; i += NT) {
      const int c = cv0 * VEC + i;
      if (c >= C) continue;
      float ts = 0.f, tq = 0.f;
      for (int pp = 0; pp < L.P; ++pp) {
        ts += red[pp * L.LP * VEC + i];
        tq += red[NT * VEC + pp * L.LP * VEC + i];
      }
      sums[c] = ts;
      sums[C + c] = tq;
    }
    __syncthreads();
  }
}

// From an image's per-channel totals tot[2][C] (shared memory): group
// moments into gm[2][groups] (shared), then each channel's fp32 scale and
// shift into sc[c], sh[c].  Ends with a barrier.
__device__ void moments(const float* tot, int C, int groups, int HW,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, float eps, float* gm,
                        float* sc, float* sh) {
  const int cgw = C / groups;
  const float cnt = (float)HW * (float)cgw;
  for (int gi = threadIdx.x; gi < groups; gi += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cgw; ++j) {
      s1 += tot[gi * cgw + j];
      s2 += tot[C + gi * cgw + j];
    }
    const float mean = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mean * mean, 0.f);
    gm[gi] = mean;
    gm[groups + gi] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    const int gi = c / cgw;
    const float mean = gm[gi], inv = gm[groups + gi];
    sc[c] = inv * gamma[c];
    sh[c] = beta[c] - mean * inv * gamma[c];
  }
  __syncthreads();
}

// act(x * scale + shift) of rows [0, nrows) of ``in`` into ``out`` (row
// stride C); each thread loads its channels' scale and shift once.
template <typename T>
__device__ void apply_rows(const T* in, T* __restrict__ out, int nrows,
                           int C, const float* sc, const float* sh, int act) {
  constexpr int VEC = Lanes<T>::VEC;
  const Lanes<T> L(C);
  if (L.p >= L.P) return;
  for (int cv0 = 0; cv0 < L.lanes; cv0 += L.LP) {
    const int cv = cv0 + L.cvl;
    if (cv >= L.lanes) continue;
    float a[VEC], d[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a[j] = sc[cv * VEC + j];
      d[j] = sh[cv * VEC + j];
    }
#pragma unroll 4
    for (int r = L.p; r < nrows; r += L.P) {
      const int off = r * C + cv * VEC;
      const uint4 raw = *reinterpret_cast<const uint4*>(in + off);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 ov;
      T* o = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float y = to_f32(e[j]) * a[j] + d[j];
        from_f32(activate(y, act), o + j);
      }
      *reinterpret_cast<uint4*>(out + off) = ov;
    }
  }
}

// ---- split path --------------------------------------------------------

// grid (NRB, B).  Rows [rb*R, min(rb*R + R, HW)) of image b.  Dynamic
// shared memory: (2C + 2 groups) floats for the last CTA's finalize.
template <typename T>
__global__ void __launch_bounds__(NT)
    gn_stats(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, float* __restrict__ part,
             unsigned* __restrict__ ticket, float* __restrict__ ss, int HW,
             int C, int groups, int R, float eps) {
  constexpr int VEC = Lanes<T>::VEC;
  __shared__ float red[2 * NT * VEC];
  __shared__ bool last;
  extern __shared__ float fin[];  // tot [2C], gm [2 groups]
  const int rb = blockIdx.x, b = blockIdx.y, NRB = gridDim.x, B = gridDim.y;
  const int r0 = rb * R;
  const int nrows = min(R, HW - r0);
  const T* xb = x + (size_t)b * HW * C + (size_t)r0 * C;
  float* pm = part + ((size_t)b * NRB + rb) * 2 * C;
  channel_sums<T>(xb, nrows, C, red, pm, [](int) {});
  // Release (the barrier orders every thread's partials before thread 0's
  // fence and ticket); the image's last CTA finalizes it.
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket + b, 1u) == (unsigned)NRB - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* tot = fin;
  float* gm = fin + 2 * C;
  const float* pb = part + (size_t)b * NRB * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += NT) {
    const int st = i / C, c = i - st * C;
    // Four running sums (row blocks m = j mod 4) keep four loads in
    // flight; they are added in a fixed order.
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    int m = 0;
    for (; m + 4 <= NRB; m += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t[j] += __ldcg(pb + ((size_t)(m + j) * 2 + st) * C + c);
    }
    for (int j = 0; m < NRB; ++m, ++j)
      t[j] += __ldcg(pb + ((size_t)m * 2 + st) * C + c);
    tot[i] = (t[0] + t[1]) + (t[2] + t[3]);
  }
  __syncthreads();
  moments(tot, C, groups, HW, gamma, beta, eps, gm, ss + (size_t)b * C,
          ss + ((size_t)B + b) * C);
  if (threadIdx.x == 0) ticket[b] = 0u;
}

// grid (NRB, B) over rows [rb*R, ...) of image b, the CTAs mapped in the
// reverse of gn_stats's order.
template <typename T>
__global__ void __launch_bounds__(NT)
    gn_apply(const T* __restrict__ x, const float* __restrict__ ss,
             T* __restrict__ out, int HW, int C, int R, int act) {
  const int NRB = gridDim.x, B = gridDim.y;
  const int rev = B * NRB - 1 - (blockIdx.y * NRB + blockIdx.x);
  const int b = rev / NRB, rb = rev - b * NRB;
  const int r0 = rb * R;
  const size_t base = (size_t)b * HW * C + (size_t)r0 * C;
  apply_rows<T>(x + base, out + base, min(R, HW - r0), C, ss + (size_t)b * C,
                ss + ((size_t)B + b) * C, act);
}

// ---- cluster path ------------------------------------------------------

// Floats of the cluster kernel's shared memory ahead of the image rows:
// the partition sums (``red``, later reused for the totals, group moments,
// scale and shift) and this CTA's channel partials.
__host__ __device__ inline int cluster_floats(int C, int groups, int vec) {
  const int red = 2 * NT * vec, fin = 4 * C + 2 * groups;
  return (red > fin ? red : fin) + 2 * C;
}

__host__ __device__ inline size_t cluster_rows_offset(int C, int groups,
                                                      int vec) {
  const size_t bytes = BAR_BYTES + 4 * (size_t)cluster_floats(C, groups, vec);
  return (bytes + 127) / 128 * 128;
}

// grid (CS, B), one cluster of CS CTAs per image; rank k holds rows
// [k*R, min(k*R + R, HW)).
template <typename T>
__global__ void __launch_bounds__(NT)
    gn_cluster(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out, int HW,
               int C, int groups, int R, int act, float eps) {
  constexpr int VEC = Lanes<T>::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CS = (int)cluster.num_blocks();
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + BAR_BYTES);
  float* part = red + (cluster_floats(C, groups, VEC) - 2 * C);
  T* rows = reinterpret_cast<T*>(smem + cluster_rows_offset(C, groups, VEC));
  const int b = blockIdx.y;
  const int r0 = rank * R;
  const int nrows = max(0, min(R, HW - r0));
  const int rch = max(1, (nrows + MAX_CHUNKS - 1) / MAX_CHUNKS);
  const int nch = (nrows + rch - 1) / rch;  // chunks of rch rows, the last
                                            // possibly shorter
  const size_t base = (size_t)b * HW * C + (size_t)r0 * C;
  if (threadIdx.x == 0) {
    for (int k = 0; k < nch; ++k) bulk::init(bar + k);
    bulk::fence_init();
    for (int k = 0; k < nch; ++k) {
      const int n = min(rch, nrows - k * rch);
      bulk::load(rows + (size_t)k * rch * C, x + base + (size_t)k * rch * C,
                 (uint32_t)(n * C * sizeof(T)), bar + k);
    }
  }
  __syncthreads();
  int waited = -1;
  channel_sums<T>(rows, nrows, C, red, part, [&](int r) {
    const int k = r / rch;
    while (waited < k) bulk::wait(bar + ++waited, 0);
  });
  // Every CTA's partials, summed in rank order by each CTA.
  cluster.sync();
  float* tot = red;
  float* gm = red + 2 * C;
  float* sc = gm + 2 * groups;
  float* sh = sc + C;
  for (int i = threadIdx.x; i < 2 * C; i += NT) {
    float t = 0.f;
    for (int k = 0; k < CS; ++k) t += cluster.map_shared_rank(part, k)[i];
    tot[i] = t;
  }
  // Done reading the other CTAs' shared memory; they may not exit before
  // every CTA has arrived here.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  moments(tot, C, groups, HW, gamma, beta, eps, gm, sc, sh);
  apply_rows<T>(rows, out + base, nrows, C, sc, sh, act);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
cudaError_t run_split(const void* x, const float* gamma, const float* beta,
                      float* part, unsigned* ticket, float* ss, void* out,
                      int B, int HW, int C, int groups, int act, int R,
                      int RA, float eps, cudaStream_t st) {
  cudaError_t e;
  const int NRB = (HW + R - 1) / R;
  const size_t fin = (2 * (size_t)C + 2 * (size_t)groups) * sizeof(float);
  static size_t fin_allowed = 32 * 1024;  // beside the static 8 or 16 KB
  if (fin > fin_allowed) {
    e = cudaFuncSetAttribute(gn_stats<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fin);
    if (e != cudaSuccess) return e;
    fin_allowed = fin;
  }
  gn_stats<T><<<dim3(NRB, B), NT, fin, st>>>(static_cast<const T*>(x), gamma,
                                            beta, part, ticket, ss, HW, C,
                                            groups, R, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gn_apply<T><<<dim3((HW + RA - 1) / RA, B), NT, 0, st>>>(
      static_cast<const T*>(x), ss, static_cast<T*>(out), HW, C, RA, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_cluster(const void* x, const float* gamma, const float* beta,
                        void* out, int B, int HW, int C, int groups, int act,
                        int CS, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int R = (HW + CS - 1) / CS;
  const size_t smem = cluster_rows_offset(C, groups, VEC) +
                      (size_t)R * C * sizeof(T);
  static size_t smem_allowed = 0;
  static bool non_portable = false;
  cudaError_t e;
  if (smem > smem_allowed) {
    e = cudaFuncSetAttribute(gn_cluster<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  if (CS > 8 && !non_portable) {
    e = cudaFuncSetAttribute(
        gn_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_cluster<T>, static_cast<const T*>(x), gamma,
                         beta, static_cast<T*>(out), HW, C, groups, R, act,
                         eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace b4_group_norm
}  // namespace

using namespace b4_group_norm;

// Split path.  x, out [B, HW, C] bf16 (dtype 0) or fp32 (1); gamma, beta
// [C] fp32; part [B, ceil(HW/R), 2, C] fp32 scratch; ticket [B] u32, zero
// (left zero); ss [2, B, C] fp32 scale/shift; R rows per stats CTA, RA per
// apply CTA.  C % (16 / sizeof(element)) == 0, C % groups == 0 and HW*C <
// 2^31 (checked by the Python wrapper).  Returns the first launch error
// (0 = cudaSuccess).
extern "C" int gn_split_fwd(const void* x, const void* gamma,
                            const void* beta, void* part, void* ticket,
                            void* ss, void* out, int B, int HW, int C,
                            int groups, int dtype, int act, int R, int RA,
                            float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* p = static_cast<float*>(part);
  unsigned* t = static_cast<unsigned*>(ticket);
  float* s = static_cast<float*>(ss);
  if (dtype == 0)
    return run_split<bf16>(x, g, be, p, t, s, out, B, HW, C, groups, act, R,
                           RA, eps, st);
  return run_split<float>(x, g, be, p, t, s, out, B, HW, C, groups, act, R,
                          RA, eps, st);
}

// Cluster path: one cluster of CS (8, or 16 non-portable) CTAs per image,
// each holding ceil(HW/CS) rows in shared memory (at most 227 KB with
// gn_cluster_smem's header; the wrapper checks).  Same layouts as above.
extern "C" int gn_cluster_fwd(const void* x, const void* gamma,
                              const void* beta, void* out, int B, int HW,
                              int C, int groups, int dtype, int act, int CS,
                              float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 0)
    return run_cluster<bf16>(x, g, be, out, B, HW, C, groups, act, CS, eps,
                             st);
  return run_cluster<float>(x, g, be, out, B, HW, C, groups, act, CS, eps,
                            st);
}
