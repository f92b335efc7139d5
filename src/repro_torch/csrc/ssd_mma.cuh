// Tile helpers shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): the largest widths the kernels take, the padded
// shared-memory row lengths, 3xTF32 products on the tensor cores through
// mma.sync m16n8k8, and cp.async tile loads with zero fill.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxCS = 256;
constexpr int kKT = 32;             // depth of a streamed k-tile
// padded shared-memory rows, so that the fragment loads below hit 32
// distinct banks: rows read by (g, t) at g * ld + t need ld = 4 (mod 32),
// rows read at t * ld + g need ld = 8 (mod 32)
constexpr int kLdN = kMaxN + 4;     // C, B by rows of n; S_in by rows of p
constexpr int kLdB2 = kMaxN + 8;    // pass 2's B, read at (s = t, n = g)
constexpr int kLdX = kMaxP + 8;     // x, read at (s = t, p = g)
constexpr int kLdK = kKT + 4;       // pass 4's C and score k-tiles

// ------------------------------------------------------ 3xTF32 products

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a 16 x 8 (rows x k) operand tile.  Lane (g, t) = (lane / 4,
// lane % 4) holds entries (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// The getters take (row, k) and, as literals once inlined, which half of
// the rows and of k the entry lies in, so that they can pick from small
// register arrays without indexing them at run time.
struct FragA {
  uint32_t hi[4], lo[4];
};
// A fragment of an 8 x 8 (k x columns) tile: entries (t, g) and (t + 4, g).
struct FragB {
  uint32_t hi[2], lo[2];
};

template <class F>
__device__ __forceinline__ FragA frag_a(F at, int g, int t) {
  FragA f;
  split_tf32(at(g, t, 0, 0), f.hi[0], f.lo[0]);
  split_tf32(at(g + 8, t, 1, 0), f.hi[1], f.lo[1]);
  split_tf32(at(g, t + 4, 0, 1), f.hi[2], f.lo[2]);
  split_tf32(at(g + 8, t + 4, 1, 1), f.hi[3], f.lo[3]);
  return f;
}

template <class F>
__device__ __forceinline__ FragB frag_b(F at, int g, int t) {
  FragB f;
  split_tf32(at(t, g, 0), f.hi[0], f.lo[0]);
  split_tf32(at(t + 4, g, 1), f.hi[1], f.lo[1]);
  return f;
}

// A B fragment whose hi and lo parts were split ahead, into two arrays.
template <class F, class G>
__device__ __forceinline__ FragB frag_b_split(F hi, G lo, int g, int t) {
  FragB f;
  f.hi[0] = __float_as_uint(hi(t, g));
  f.lo[0] = __float_as_uint(lo(t, g));
  f.hi[1] = __float_as_uint(hi(t + 4, g));
  f.lo[1] = __float_as_uint(lo(t + 4, g));
  return f;
}

// d += a b in 3xTF32, the small terms first.  d holds the 16 x 8 outputs
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// ------------------------------------------------------ cp.async tiles

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copies rows x cols floats (cols a multiple of 4) from src (row stride ld)
// to dst (row stride lds), zero-filling entries at row >= nr or col >= nc.
// vec: 16-byte copies (src 16-byte aligned, ld and nc multiples of 4), else
// 4-byte ones.  safe is any valid address, read by no zero-filled copy.
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* src,
                                          long long ld, int rows, int cols,
                                          int nr, int nc, bool vec,
                                          const float* safe) {
  if (vec) {
    const int q = cols / 4;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q;
      const int c = 4 * (i - r * q);
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * lds + c, ok ? src + r * ld + c : safe, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      const bool ok = r < nr && c < nc;
      cp_async4(dst + r * lds + c, ok ? src + r * ld + c : safe, ok);
    }
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
