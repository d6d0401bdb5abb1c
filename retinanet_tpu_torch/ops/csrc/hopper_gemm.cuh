// Hopper GEMM building blocks of kernels B1 and B5 (bottleneck.cu,
// bottleneck_proj.cu, through bottleneck_common.cuh), B3
// (bottleneck_bwd.cu) and B6 (int8_conv.cu): 16-byte cp.async copies into a
// ring of shared-memory stages (zero-filled where the source is outside the
// image), 128-byte swizzled tiles that wgmma reads through shared-memory
// descriptors, and the implicit-GEMM convolution mainloop that B1's, B5's
// and B3's bf16 convolutions and B6's int8 GEMM share.
//
// The convolution mainloop computes a 128 x BN tile of
//     acc[p, n] += sum_k A[p, k] * Wt[n, k]
// with two warpgroups (256 threads), each issuing wgmma m64nBNk{32 s8, 16
// bf16} on its 64 rows.  A row p is one output pixel: its K = KS*KS*C values
// are the window's taps, tap-major, read from an NHWC image; Wt is [N, K],
// K contiguous.  A stage holds 128 bytes of K for the 128 rows of A and the
// BN rows of Wt, each row one 128-byte swizzle atom row, so both operands
// are K-major, which int8 wgmma requires.  K advances 32 bytes per wgmma
// (k32 s8 or k16 bf16).  C*sizeof(element) % 64 == 0 keeps every 64-byte
// half row inside one tap; a K that is not a multiple of 128 bytes ends in a
// zero-filled half stage, which adds nothing.  Once a stage has landed, the
// A producer's landed() hook may rewrite the bytes each thread copied
// itself before wgmma reads them (B1's and B5's GN-affine+relu prologue).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int CONV_BM = 128;       // output rows per CTA (two warpgroups)
constexpr int CONV_BK = 128;       // bytes of K per stage
constexpr int CONV_THREADS = 256;
constexpr int CONV_STAGES = 3;

// Bytes of one stage: A [128][128 B], then Wt [BN][128 B].
template <int BN>
__host__ __device__ constexpr int conv_stage_bytes() {
  return (CONV_BM + BN) * CONV_BK;
}
// Dynamic shared memory a conv_mainloop CTA asks for (+1 KB to align):
// CONV_STAGES stages, or one per K stage where K is shorter (the ring then
// never wraps), so that short-K GEMMs fit more CTAs on an SM.
template <int BN>
__host__ __device__ constexpr int conv_smem_bytes(int kb = 1 << 30) {
  return ((kb + CONV_BK - 1) / CONV_BK < CONV_STAGES
              ? (kb + CONV_BK - 1) / CONV_BK
              : CONV_STAGES) *
             conv_stage_bytes<BN>() +
         1024;
}

// Lets kernel take up to bytes of dynamic shared memory (above 48 KB it
// must ask), once per device: done is the flag set of the calling kernel
// instance.
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

__device__ __forceinline__ char* align1024(char* p) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; the bytes past src_bytes (0 or 16) are
// written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's completed shared-memory writes before the async
// proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the wgmma
// issue and wait.
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// (8-row atoms of 1024 bytes, 16-byte chunk c of row r stored at chunk
// c ^ (r % 8)); the tile starts on a 1024-byte boundary.  Leading byte
// offset unused (1), stride byte offset 1024 (64 in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Descriptor of an MN-major tile in the 128-byte swizzle that spans one
// 64-wide atom along M or N: rows along K of 64 bf16 (128 bytes), 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), 8-row groups 1024 bytes
// apart.  That stride is the stride byte offset; the leading byte offset
// (the stride between atoms along M or N) never applies to one atom, and
// carries the same 1024.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(64) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][128 B] tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma m64nNk32 s8 x s8 -> s32 and m64nNk16 bf16 x bf16 -> f32, D += A *
// B from shared memory: both operands K-major (wgmma: the accumulator
// array's type and length pick the instruction), or both MN-major
// (wgmma_bf16_mn_n64, bf16 only).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_mn_n64(float (&d)[32],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}


__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t a, uint64_t b) {
  wgmma_s8_n64(d, a, b);
}
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_s8_n128(d, a, b);
}
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t a,
                                      uint64_t b) {
  wgmma_s8_n256(d, a, b);
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  wgmma_bf16_n64(d, a, b);
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a,
                                      uint64_t b) {
  wgmma_bf16_n128(d, a, b);
}

// The output pixel whose window this thread's A row loads.
struct ConvRow {
  const char* img;  // its image: NHWC
  int iy0, ix0;     // input pixel of tap (0, 0); may lie outside the image
  bool valid;       // false past the last output row
};

// The mainloop's A producer: copies bytes [k0, k0 + 128) of K of this
// thread's A row (row tid / 2, half tid % 2: 64 bytes) into the swizzled
// stage at sa with cp.async, from an image of cb bytes per pixel (taps
// KS x KS, zero outside the image, past the last row or past kb).
template <int KS>
struct CopyA {
  ConvRow row;
  int H, W, cb, kb;

  // Whether this thread's 64 bytes of stage k0 lie in the image (else they
  // are zero-filled), with their source and their byte offset c0 within
  // the source pixel.
  __device__ __forceinline__ bool source(int k0, int tid, const char** src,
                                         int* c0) const {
    const int k = k0 + (tid & 1) * 64;
    const int tap = k / cb;
    *c0 = k - tap * cb;
    const int iy = row.iy0 + tap / KS, ix = row.ix0 + tap % KS;
    const bool ok =
        row.valid && k < kb && iy >= 0 && iy < H && ix >= 0 && ix < W;
    *src = ok ? row.img + ((size_t)iy * W + ix) * cb + *c0 : row.img;
    return ok;
  }

  __device__ __forceinline__ void operator()(uint32_t sa, int k0,
                                             int tid) const {
    const int r = tid >> 1, h = tid & 1;
    const char* src;
    int c0;
    const bool ok = source(k0, tid, &src, &c0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cp_async16(sa + sw128(r, h * 4 + j), src + (ok ? j * 16 : 0),
                 ok ? 16 : 0);
  }

  // Called once stage k0 (at sa) has landed for this thread, before the
  // CTA's barrier and wgmma: a producer that transforms its own copies in
  // place does so here.  A plain copy leaves them.
  __device__ __forceinline__ void landed(uint32_t, int, int) const {}
};

// Bytes [k0, k0 + 128) of the BN rows of Wt (kb bytes each): 32 bytes per
// thread per row, 64 rows per pass, zero past kb.
template <int BN>
__device__ __forceinline__ void conv_load_b(uint32_t sb, const char* wt,
                                            int kb, int k0, int tid) {
  const int q = tid & 3;
  const int kq = k0 + q * 32;
  const bool ok = kq < kb;
#pragma unroll
  for (int i = 0; i < BN / 64; ++i) {
    const int n = i * 64 + (tid >> 2);
    const char* s = wt + (size_t)n * kb + (ok ? kq : 0);
    cp_async16(sb + sw128(n, 2 * q), s, ok ? 16 : 0);
    cp_async16(sb + sw128(n, 2 * q + 1), s + (ok ? 16 : 0), ok ? 16 : 0);
  }
}

// acc = A . Wt^T over K = kb bytes for this CTA's 128 rows (pa, a CopyA
// or a producer with the same interface) and the BN rows of wt (Wt + n0 *
// kb bytes).  Ends with every copy landed and a barrier, so the caller may
// reuse smem.
template <int BN, typename Copy, typename Acc>
__device__ __forceinline__ void conv_mainloop(Acc (&acc)[BN / 2], char* smem,
                                              const Copy& pa,
                                              const char* wt, int kb) {
  constexpr int SB = conv_stage_bytes<BN>();
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t base = smem_u32(smem);
  const int KT = (kb + CONV_BK - 1) / CONV_BK;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll
  for (int s = 0; s < CONV_STAGES - 1; ++s) {
    if (s < KT) {
      conv_load_b<BN>(base + s * SB + CONV_BM * CONV_BK, wt, kb, s * CONV_BK,
                      tid);
      pa(base + s * SB, s * CONV_BK, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // Stage kt has landed for this thread, and the producer's hook runs on
    // it while this warpgroup's wgmma of stage kt - 1 (another slot) may
    // still run.  Then that wgmma is waited for, and the barrier tells every
    // thread that stage kt has landed everywhere and that stage kt - 1's
    // slot, which the next stage refills, is read.
    cp_async_wait<CONV_STAGES - 2>();
    pa.landed(base + (kt % CONV_STAGES) * SB, kt * CONV_BK, tid);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();
    const int nxt = kt + CONV_STAGES - 1;
    const uint32_t sn = base + (nxt % CONV_STAGES) * SB;
    if (nxt < KT) {
      conv_load_b<BN>(sn + CONV_BM * CONV_BK, wt, kb, nxt * CONV_BK, tid);
      pa(sn, nxt * CONV_BK, tid);
    }
    cp_async_commit();
    const uint32_t sa = base + (kt % CONV_STAGES) * SB;
    const uint64_t da = sw128_desc(sa + wg * 64 * CONV_BK);
    const uint64_t db = sw128_desc(sa + CONV_BM * CONV_BK);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// Row (0..127) and column (0..BN-1) in the tile of accumulator element
// 4 * j + 2 * half + e of this thread: rows g and g + 8 of its warp's 16,
// columns 8 j + 2 t + e (the m16n8 C-fragment layout, repeated along N).
__device__ __forceinline__ int acc_row(int tid, int half) {
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2) +
         half * 8;
}
__device__ __forceinline__ int acc_col(int tid, int j) {
  return 8 * j + 2 * (tid & 3);
}

}  // namespace hopper
}  // namespace
