// 2D rotary position embedding (rotate-half, CroCo-v2) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel `rope_2d` (ops/rope2d.py:
// `_rope_2d_pallas` -> `_rope2d_kernel`).
//
// What it computes: tokens (B, H, N, dim) -> out (B, H, N, dim). The y half
// [..., :dim/2] gets 1-D RoPE from the token's y grid coordinate, the x half
// [..., dim/2:] from its x coordinate. Within a half of D = dim/2 elements,
// pair i in [0, D/2) is (u, v) = (t[i], t[i + D/2]) and becomes
// (u cos - v sin, v cos + u sin) with angle = pos * inv_freq_i,
// inv_freq_i = exp(-log(base) * (2 i / D)). The input is read by element
// strides (b, h, n) with the last dimension contiguous, so q and k may be
// views of the (B, N, 3, H, dim) qkv projection; the output is contiguous.
//
// Precision: the arithmetic repeats the JAX formula in f32 in its order:
// -log(base) arrives as the f32 rounding of the host's double log, then
// (2.0f * i) / D, expf, pos * inv_freq, precise sincosf (no --use_fast_math,
// no __sinf), and the products and sums are rounded one by one
// (__fmul_rn / __fadd_rn / __fsub_rn) so that nvcc does not contract them
// into FMAs the plain PyTorch version does not use.
//
// What bounds it on an H100: it is elementwise, ~4 FLOP plus one expf and
// one sincosf per pair, against 2 bytes read and 2 written per bf16 element:
// bound by bytes (CroCo-v2's q at B=64, H=12, N=196, dim=64 is 19.3 MB in and
// 19.3 MB out, ~11.5 us at 3.35 TB/s). The design computes each (batch,
// token, pair) angle once and reuses it for all H heads (the angle does not
// depend on the head), so the transcendental work is 1/H of a per-element
// kernel; neighbouring threads take neighbouring pairs of one row, so the
// loads and stores of a warp are contiguous.
//
// Plain C interface for ctypes: pointers, ints and 64-bit strides; the
// function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store_f(__half* p, float x) { *p = __float2half_rn(x); }

// One thread per (batch, token, rotation pair); it loops over the heads.
// pair p in [0, dim/2): axis = p / Q (0: y, 1: x), i = p % Q, Q = dim/4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope2d(const T* __restrict__ t, const int* __restrict__ pos, T* __restrict__ out, int B,
           int H, int N, int dim, long long t_sb, long long t_sh, long long t_sn,
           long long p_sb, long long p_sn, long long p_sc, float neg_log_base) {
  const int pairs = dim / 2;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * N * pairs) return;
  const int p = static_cast<int>(idx % pairs);
  const long long bn = idx / pairs;
  const int n = static_cast<int>(bn % N);
  const int b = static_cast<int>(bn / N);

  const int D = dim / 2;  // per-axis rotary dim
  const int Q = D / 2;
  const int axis = p / Q;
  const int i = p - axis * Q;
  const float inv_freq =
      expf(__fmul_rn(neg_log_base, __fdiv_rn(__fmul_rn(2.0f, static_cast<float>(i)),
                                             static_cast<float>(D))));
  const float position = static_cast<float>(pos[b * p_sb + n * p_sn + axis * p_sc]);
  float sn, cs;
  sincosf(__fmul_rn(position, inv_freq), &sn, &cs);

  const int iu = axis * D + i;
  const int iv = iu + Q;
  const T* src = t + b * t_sb + n * t_sn;
  T* dst = out + ((static_cast<long long>(b) * H) * N + n) * dim;
  const long long o_sh = static_cast<long long>(N) * dim;
  for (int h = 0; h < H; ++h) {
    const float u = load_f(src + h * t_sh + iu);
    const float v = load_f(src + h * t_sh + iv);
    store_f(dst + h * o_sh + iu, __fsub_rn(__fmul_rn(u, cs), __fmul_rn(v, sn)));
    store_f(dst + h * o_sh + iv, __fadd_rn(__fmul_rn(v, cs), __fmul_rn(u, sn)));
  }
}

template <typename T>
void launch(const void* t, const int* pos, void* out, int B, int H, int N, int dim,
            long long t_sb, long long t_sh, long long t_sn, long long p_sb, long long p_sn,
            long long p_sc, float nlb, cudaStream_t stream) {
  const long long work = static_cast<long long>(B) * N * (dim / 2);
  const unsigned blocks = static_cast<unsigned>((work + kThreads - 1) / kThreads);
  rope2d<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(t), pos,
                                             static_cast<T*>(out), B, H, N, dim, t_sb, t_sh,
                                             t_sn, p_sb, p_sn, p_sc, nlb);
}

}  // namespace

// tokens: (B, H, N, dim) by element strides (batch, head, token), last
// dimension contiguous; positions: int32 (B, N, 2) by element strides
// (batch, token, component); out: contiguous (B, H, N, dim), tokens' dtype.
// dtype: 0 float32, 1 bfloat16, 2 float16. neg_log_base_bits: the f32
// -log(base) as its 32-bit pattern.
extern "C" int mvp_rope2d(const void* tokens, const void* positions, void* out, int B, int H,
                          int N, int dim, long long t_sb, long long t_sh, long long t_sn,
                          long long p_sb, long long p_sn, long long p_sc,
                          int neg_log_base_bits, int dtype, void* stream) {
  float nlb;
  memcpy(&nlb, &neg_log_base_bits, sizeof(nlb));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || N <= 0 || dim <= 0 || dim % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* pos = static_cast<const int*>(positions);
  switch (dtype) {
    case 0:
      launch<float>(tokens, pos, out, B, H, N, dim, t_sb, t_sh, t_sn, p_sb, p_sn, p_sc, nlb, st);
      break;
    case 1:
      launch<__nv_bfloat16>(tokens, pos, out, B, H, N, dim, t_sb, t_sh, t_sn, p_sb, p_sn, p_sc,
                            nlb, st);
      break;
    case 2:
      launch<__half>(tokens, pos, out, B, H, N, dim, t_sb, t_sh, t_sn, p_sb, p_sn, p_sc, nlb,
                     st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
