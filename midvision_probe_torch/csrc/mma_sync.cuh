// mma.sync building blocks shared by the attention kernels
// (vit_attention.cu's mma_sync and tf32x3 routes, attention_bwd.cu):
// (B, H, N, d) strides, cp.async copies, ldmatrix, the bf16 m16n8k16
// product, the TF32 m16n8k8 product, and the 3xTF32 split (each f32
// operand as hi = tf32(x) plus lo = tf32(x - hi), a product as lo*hi +
// hi*lo + hi*hi) with its pre-pass `split_pairs`, all but the pre-pass as
// inline PTX.
//
// Fragment layouts (g = lane / 4, tq = lane % 4; c0..c3 of an accumulator
// are (row g, cols 2tq and 2tq + 1) and (row g + 8, the same cols)):
//   * m16n8k16 bf16: A a0 (g, 2tq..2tq+1), a1 (g + 8, 2tq..), a2 (g, 2tq+8..),
//     a3 (g + 8, 2tq+8..); B b0 (k 2tq..2tq+1, n g), b1 (k 2tq+8.., n g).
//   * m16n8k8 tf32: A a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4),
//     a3 (g + 8, tq + 4); B b0 (k tq, n g), b1 (k tq + 4, n g).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// element strides of a (B, H, N, d) operand; the last dimension has stride 1
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c += a * b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 bit patterns -> one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ a residue of ~2^-22 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float2 split_pair(float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// The 3xTF32 routes' pre-pass: x (B, H, rows, D) f32 by element strides -> its
// (hi, lo) pairs, contiguous (B, H, rows, D) float2; one float4 of x per step.
__global__ void split_pairs(const float* __restrict__ x, Strides s, float4* __restrict__ out,
                            int H, int rows, int d4, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % d4);
    long long r = i / d4;
    const int n = static_cast<int>(r % rows);
    r /= rows;
    const int h = static_cast<int>(r % H);
    const long long b = r / H;
    const float4 v = *reinterpret_cast<const float4*>(x + b * s.b + h * s.h + n * s.n + 4 * c);
    const float2 p0 = split_pair(v.x), p1 = split_pair(v.y), p2 = split_pair(v.z),
                 p3 = split_pair(v.w);
    out[2 * i] = make_float4(p0.x, p0.y, p1.x, p1.y);
    out[2 * i + 1] = make_float4(p2.x, p2.y, p3.x, p3.y);
  }
}

// split_pairs over `rows` rows of x into `pairs`, at most 8 blocks an SM
inline void launch_split_pairs(const float* x, Strides s, float2* pairs, int B, int H, int rows,
                               int D, int sms, cudaStream_t stream) {
  const long long chunks = static_cast<long long>(B) * H * rows * (D / 4);
  const long long want = (chunks + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  split_pairs<<<blocks, 256, 0, stream>>>(x, s, reinterpret_cast<float4*>(pairs), H, rows,
                                          D / 4, chunks);
}

// 16 bytes, or zeros when `full` is false (the source is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(full ? 16 : 0));
}

// one arrival on `bar` once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// four 8x8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the row
// addresses of matrix i; plain: lane l holds (row l/4, cols 2(l%4), +1) of
// each, trans: (rows 2(l%4), +1, col l/4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a * b for one m16n8k8 tile: a 16x8 tf32 (row), b 8x8 tf32 (col), c
// 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b for one m16n8k8 tile, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// t (=, kFirst; else +=) a * b in 3xTF32, a given as its hi and lo
// fragments, b as this thread's two B fragment elements as (hi, lo) pairs;
// the small terms first
template <bool kFirst>
__device__ __forceinline__ void mma_3xtf32(float (&t)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float2 b0, float2 b1) {
  const uint32_t h0 = __float_as_uint(b0.x), l0 = __float_as_uint(b0.y);
  const uint32_t h1 = __float_as_uint(b1.x), l1 = __float_as_uint(b1.y);
  if (kFirst) {
    mma_tf32_zero(t, a_lo, h0, h1);
  } else {
    mma_tf32(t, a_lo, h0, h1);
  }
  mma_tf32(t, a_hi, l0, l1);
  mma_tf32(t, a_hi, h0, h1);
}

// c (=, kFirst; else +=) t in f32
template <bool kFirst>
__device__ __forceinline__ void add_f32(float (&c)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = kFirst ? t[e] : c[e] + t[e];
}

}  // namespace
