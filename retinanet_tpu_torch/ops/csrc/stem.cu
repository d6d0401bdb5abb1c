// Fused stem epilogue for Hopper (sm_90a): kernel B7.
//
// Replaces the TPU kernel retinanet_tpu/ops/pallas/stem.py:gn_relu_maxpool
// (_gn_pool_kernel), called by fused_stem:
//     out[b, oy, ox, c] = max over the 3x3 window at (2*oy, 2*ox), TF-SAME,
//                         of relu(bf16(bf16(y * scale[b,c]) + shift[b,c]))
// with y [B,H,W,C] bf16 NHWC (the stem conv's output) and bf16 per-image
// scale/shift.  Padding is zero, which equals the -inf of max_pool_same
// here: every value is a relu output (>= 0) and no window is all padding.
// There is no sum, so the kernel equals its plain version bitwise.
//
// What bounds it here: one read of y and one write of the pooled output
// (a quarter of y), a few operations per byte: device memory.  The TPU
// kernel turned the stride-2 taps into even/odd row pairs because Mosaic
// dislikes strided slices.  Here a CTA owns one image's band of ROWS
// output rows and a tile of TW output columns, one thread per (output column,
// 8 channels), and walks down the band one input row pair at a time:
//   - each thread loads its two input columns (2*ox - pad_l and the next)
//     of the pair's two rows with 16-byte loads, the pair after it in
//     flight while it computes this one;
//   - each element goes through the affine once, as packed bf16x2
//     multiplies and adds rounded to nearest (each equals the fp32
//     operation rounded to bf16: both operands are bf16, and fp32 has more
//     than 2 * 8 + 2 bits), with scale and shift held in registers for the
//     whole band;
//   - the third column of a window is the right neighbour's first, handed
//     over through shared memory (the tile's last column loads it itself);
//   - the vertical max carries the pair's second row's horizontal max to
//     the next output row, so the band's first row (its halo) is the only
//     row read twice;
//   - offsets are 32-bit within an image, positions come from the CTA's
//     coordinates; the relu is one max with zero per output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace b7_gn_relu_maxpool {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;  // threads per CTA
// Output rows per CTA.  The band's first input row is read twice (one row
// in 2 * ROWS + 1), but short bands give the card more CTAs to overlap: of
// 2, 4, 8, 16 and 32 rows at the stem's shape, 4 was among the fastest
// (PERF.md, B7).
constexpr int ROWS = 4;

// Packed bf16x2, rounded to nearest even (an explicit rounding mode keeps
// ptxas from contracting the multiply and add into an fma).
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z),
                    max2(a.w, b.w));
}

// bf16(bf16(v * s) + h) on 8 channels; zero where the tap is padding.
__device__ __forceinline__ uint4 affine(uint4 v, uint4 s, uint4 h, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  return make_uint4(add2(mul2(v.x, s.x), h.x), add2(mul2(v.y, s.y), h.y),
                    add2(mul2(v.z, s.z), h.z), add2(mul2(v.w, s.w), h.w));
}

__device__ __forceinline__ uint4 load16(const bf16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p))
            : make_uint4(0u, 0u, 0u, 0u);
}

// One input row's taps of a thread: columns c0, c0 + 1 and, at the tile's
// edge, c0 + 2.
struct Row {
  uint4 v0, v1, v2;
  bool ok;
};

// grid (column tiles * channel chunks, bands, B), NT threads.  Thread t
// takes channel group g = chunk * GC + t % GC and output column
// ox = tile * TW + t / GC.
__global__ void __launch_bounds__(NT)
    gn_relu_maxpool(const bf16* __restrict__ y, const bf16* __restrict__ scale,
                    const bf16* __restrict__ shift, bf16* __restrict__ out,
                    int H, int W, int C, int Ho, int Wo, int pad_t,
                    int pad_l, int GC, int TW, int tiles) {
  __shared__ uint4 edge_s[2 * 2 * NT];  // [buffer][row of the pair][thread]
  uint4* const edge = edge_s;
  const int t = threadIdx.x;
  const int chunk = blockIdx.x / tiles;
  const int j = t / GC;
  const int g = chunk * GC + (t - j * GC);
  const int ox = (blockIdx.x - chunk * tiles) * TW + j;
  const bool active = j < TW && g * 8 < C && ox < Wo;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * ROWS;
  const int oy1 = min(oy0 + ROWS, Ho);
  const bf16* yb = y + (size_t)b * H * W * C;
  bf16* ob = out + (size_t)b * Ho * Wo * C;

  // Columns c0 = 2*ox - pad_l (padding only at ox = 0 on an odd side),
  // c0 + 1 (always inside) and c0 + 2 (padding only at ox = Wo - 1): the
  // right neighbour's c0, in this CTA unless this is the tile's last
  // column.
  const int c0 = 2 * ox - pad_l;
  const bool ok0 = active && c0 >= 0;
  const bool ok2 = active && c0 + 2 < W;
  const bool own2 = ok2 && j + 1 == TW;
  uint4 s = make_uint4(0u, 0u, 0u, 0u), h = s;
  if (active) {
    s = __ldg(reinterpret_cast<const uint4*>(scale + b * C + g * 8));
    h = __ldg(reinterpret_cast<const uint4*>(shift + b * C + g * 8));
  }
  const int col_off = c0 * C + g * 8;

  auto load_row = [&](int r) {
    Row row;
    row.ok = active && r >= 0 && r < H;
    const bf16* p = yb + (row.ok ? r * W * C + col_off : 0);
    row.v0 = load16(p, row.ok && ok0);
    row.v1 = load16(p + C, row.ok);
    row.v2 = load16(p + 2 * C, row.ok && own2);
    return row;
  };
  // The horizontal max of one row: its affine taps, c0's handed to the
  // left neighbour through edge[buf][slot][t] (read after the caller's
  // __syncthreads) and c0 + 2's taken from the right neighbour.
  auto affine_row = [&](const Row& row, uint4& z0, uint4& z1, uint4& z2,
                        int buf, int slot) {
    z0 = affine(row.v0, s, h, row.ok && ok0);
    z1 = affine(row.v1, s, h, row.ok);
    z2 = affine(row.v2, s, h, row.ok && own2);
    edge[(buf * 2 + slot) * NT + t] = z0;
  };
  auto hmax = [&](const uint4& z0, const uint4& z1, const uint4& z2, int buf,
                  int slot) {
    const uint4 n = (ok2 && !own2) ? edge[(buf * 2 + slot) * NT + t + GC]
                                   : z2;
    return vmax(vmax(z0, z1), n);
  };

  // The band's halo row 2*oy0 - pad_t: the first row of output oy0's
  // window, the last of oy0 - 1's.
  const int r_first = 2 * oy0 - pad_t;
  Row halo = load_row(r_first);
  Row na = load_row(r_first + 1), nb = load_row(r_first + 2);
  uint4 carry;
  {
    uint4 z0, z1, z2;
    affine_row(halo, z0, z1, z2, 1, 0);
    __syncthreads();
    carry = hmax(z0, z1, z2, 1, 0);
  }
  int buf = 0;
#pragma unroll 1
  for (int oy = oy0; oy < oy1; ++oy) {
    const Row ra = na, rb = nb;
    if (oy + 1 < oy1) {  // the next pair, in flight during this one
      const int r = 2 * (oy + 1) - pad_t;
      na = load_row(r + 1);
      nb = load_row(r + 2);
    }
    uint4 a0, a1, a2, b0, b1, b2;
    affine_row(ra, a0, a1, a2, buf, 0);
    affine_row(rb, b0, b1, b2, buf, 1);
    __syncthreads();
    const uint4 ha = hmax(a0, a1, a2, buf, 0);
    const uint4 hb = hmax(b0, b1, b2, buf, 1);
    const uint4 o =
        vmax(vmax(carry, vmax(ha, hb)), make_uint4(0u, 0u, 0u, 0u));
    if (active)
      *reinterpret_cast<uint4*>(ob + (oy * Wo + ox) * C + g * 8) = o;
    carry = hb;
    buf ^= 1;
  }
}

}  // namespace b7_gn_relu_maxpool
}  // namespace

using namespace b7_gn_relu_maxpool;

// y [B,H,W,C], scale/shift [B,C], out [B,Ho,Wo,C], all bf16; C % 8 == 0,
// H*W*C < 2^31 (checked by the Python wrapper).  Returns the launch
// error.
extern "C" int gn_relu_maxpool_fwd(const void* y, const void* scale,
                                   const void* shift, void* out, int B, int H,
                                   int W, int C, int Ho, int Wo, int pad_t,
                                   int pad_l, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = C / 8;                 // 8-channel groups
  const int GC = G < NT ? G : NT;      // groups per CTA
  const int TW = NT / GC;              // output columns per CTA
  const int tiles = (Wo + TW - 1) / TW;
  const int chunks = (G + GC - 1) / GC;
  const dim3 grid(tiles * chunks, (Ho + ROWS - 1) / ROWS, B);
  gn_relu_maxpool<<<grid, NT, 0, st>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), static_cast<bf16*>(out), H, W, C, Ho,
      Wo, pad_t, pad_l, GC, TW, tiles);
  return cudaGetLastError();
}
