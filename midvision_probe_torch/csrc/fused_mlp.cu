// Fused transformer MLP for Hopper (sm_90a), forward only:
// out = (act(x @ W1 + b1) rounded to x's dtype) @ W2 + b2.
//
// Replaces the JAX package's Pallas TPU kernel `fused_mlp`
// (ops/fused_mlp.py, `_forward` -> `_mlp_kernel`), a library op that no
// model dispatches. Entry point mvp_fused_mlp; x (M, C), W1 (C, H), b1 (H),
// W2 (H, C), b2 (C), out (M, C), all contiguous and of one dtype, and an
// (M, H) scratch of that dtype for the hidden activations; float32 also
// takes a workspace for the split weights.
//
// What it computes: h = x @ W1 + b1; act(h) with the TPU kernel's
// activations (gelu with the Abramowitz-Stegun rational erf, gelu_tanh,
// quickgelu); h rounded to x's dtype; o = h @ W2 + b2, rounded to x's
// dtype. The rounding points are the TPU kernel's. bf16 sums in f32 and
// applies the activation in f32; f32 sums its exact products with a
// compensated f32 sum and adds the bias and applies the activation in f64,
// so that each output is within about one f32 rounding of the exact result.
//
// What bounds it on an H100: at DINO ViT-B/16's MLP over a 64-image batch
// at 480x640 (M = 64*1201 = 76,864, C = 768, H = 3072) the work is 4*M*C*H
// = 7.25e11 operations against ~0.25 GB (bf16) of x, weights and output:
// bound by operations, 0.733 ms at 989 TFLOP/s in bf16 and, in f32 on the
// six bf16 products per product below, 4.40 ms (the same as three TF32
// products at 495 TFLOP/s).
//
// Both dtypes run a warp-specialised wgmma GEMM with a fused epilogue,
// launched twice (fc1 with bias and activation into the scratch, fc2 with
// bias from it). Keeping the hidden activations on chip would need a
// (rows x C) f32 accumulator for the whole hidden loop: at wgmma's least M
// of 64 rows that is 196 KB of registers at C = 768 and 320 KB at C =
// 1280, more than an SM's 256 KB, so a one-SM fused design is held to small
// row blocks that re-read W1 and W2 for every block. The hidden instead
// makes one round trip through device memory (472 MB each way at DINO's
// shape in bf16, 944 MB in f32); both products stay above the card's
// ridge, so the kernels stay bound by operations.
//
// bf16 (`gemm_bias_act`):
//   * a persistent grid (one block per SM) walks 128 x 256 output tiles,
//     the N tile fastest, so that concurrent blocks share A rows in L2 and
//     the weights (4.7 MB at ViT-B, 13 MB at ViT-H) stay there;
//   * one producer thread keeps a 4-stage ring of 64-wide K slices in
//     flight with TMA (A 128 x 64 = 16 KB, K-major; B 64 x 256 = 32 KB, read
//     in place from the row-major weight, MN-major), each stage guarded by
//     a full and an empty mbarrier; the producer warpgroup gives its
//     registers to the consumers (setmaxnreg 40 / 232);
//   * two consumer warpgroups each own 64 rows of the tile and issue
//     wgmma.m64n256k16 (bf16 in, f32 accumulate, 128 accumulator registers
//     a thread), keeping one K slice's products in flight while the next
//     slice's are issued;
//   * the epilogue adds f32(bias), applies the activation (a runtime
//     argument, -1 for none: fc2) in f32, rounds to bf16 and stores with
//     row and column masks, while the producer already loads the block's
//     next tile.
// On the card (NVIDIA H100 80GB HBM3, 700 W) this runs at ~4x its bound
// at DINO's shape (~3 ms). Two variants ran slower in the same call and
// were dropped: a 2-CTA cluster that multicasts each B slice, and a
// schedule in which the two warpgroups take whole 128 x 128 tiles in turn.
// The epilogue's exact activation math is a large share: gelu, with its
// f32 division and expf, is slower than gelu_tanh. PERF.md has the numbers.
//
// float32 (`gemm_bf16x6`): f32 accuracy from the bf16 tensor cores. Each
// f32 operand x is split exactly into three bf16 pieces, x = x0 + x1 + x2
// (8 significant bits apiece), and each product a*b is taken as the six
// piece products of weight 2^-16 and more (a0b0; a0b1, a1b0; a0b2, a1b1,
// a2b0), all exact on the tensor cores; the three dropped ones come to at
// most 2^-23 of the product. Three TF32 products (hi = tf32(x), lo =
// tf32(x - hi)) cost the same tensor-core time but leave errors of up to
// 2^-21 of the product (x - hi - lo is up to 2^-22 of x): at one row of
// DINO's width that floor alone is above cuBLAS's own f32 error (PERF.md).
//   * a pre-pass (`split_weight`) splits each weight once per call into
//     its three planes, kept MN-major as stored, in a workspace the caller
//     provides (6*C*H bf16; 28 MB at ViT-B beside 236 MB of x);
//   * A (x in fc1, the hidden in fc2) arrives by TMA as f32 and each
//     consumer thread splits its own A fragments in registers, once per K
//     slice, for wgmma.m64n128k16 with A from registers;
//   * 128 x 128 tiles, a 4-stage ring of 32-deep K slices (A 16 KB, the
//     three B planes 8 KB each), producer and consumers as in bf16; the
//     two consumer warpgroups take turns at issuing a slice's products (a
//     pair of named barriers), so that one's split and sum can run while
//     the other's products do;
//   * the tensor cores round their f32 accumulation toward zero (a bias of
//     1.1e-5 over 1,539 steps in vit_attention.cu), and a sum that holds
//     the large products truncates every small one added to it at its own
//     ulp: each K slice's twelve products start from a zero accumulator,
//     the small terms first, and the slices are summed in f32 with
//     Kahan's compensation;
//   * the epilogue adds acc - compensation and the bias in f64 and applies
//     the activation in f64 (its own exp and reciprocal, with no f64
//     division), so that the hidden and the output are rounded to f32 once,
//     as the exact oracle rounds them; it stages a warpgroup's values in
//     shared memory a quarter of the tile at a time, so that each warp
//     evaluates a row of 32 values with no code duplicated per register
//     and stores it coalesced.
// What holds it above its bound on the card (PERF.md): the per-slice split
// and compensated sum, which the turns hide only in part, and fc1's f64
// epilogue, during which the tensor cores wait.
//
// Any C that is a multiple of 8 and any H that is a multiple of 32, in
// either dtype; any M >= 1. Ragged M, N and K need no padding: TMA fills
// rows and columns outside the tensors with zeros, and the stores are
// masked. Plain C interface for ctypes; returns cudaGetLastError() after
// the launches (or the tensor-map encoding's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                        // GEMM tile rows (two warpgroups of 64)
constexpr int kBN = 256;                        // GEMM tile columns
constexpr int kBK = 64;                         // K slice: 128 bytes of bf16
constexpr int kStages = 4;                      // TMA ring depth
constexpr int kABytes = kBM * kBK * 2;          // 16 KB
constexpr int kBBytes = kBK * kBN * 2;          // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kBChunk = kBK * 128;              // one 64-column block of B: 8 KB
constexpr int kGemmThreads = 384;               // 2 consumer warpgroups + 1 producer
constexpr int kGemmSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;

// the f32 route: 128 x 128 tiles, K slices of 32: the A rows as f32 (128
// bytes a row) and the slice's 32 k-rows of each of B's three bf16 planes
// (two 64-column blocks a plane); the epilogue stages a warpgroup's 64 rows
// a quarter of the tile's columns at a time, as f64, rows padded to 40
// values (an 8-row store of 16 bytes a thread then meets every bank 4 times)
constexpr int kFBN = 128;                                 // tile columns (rows: kBM)
constexpr int kFBK = 32;                                  // K slice
constexpr int kFStages = 4;                               // TMA ring depth
constexpr int kFABytes = kBM * kFBK * 4;                  // 16 KB
constexpr int kFBChunk = kFBK * 128;                      // one 64-column block: 4 KB
constexpr int kFPlaneBytes = (kFBN / 64) * kFBChunk;      // 8 KB
constexpr int kFStageBytes = kFABytes + 3 * kFPlaneBytes; // 40 KB
constexpr int kFPass = 32;                                // staged columns
constexpr int kFRow = kFPass + 8;                         // staged row, in doubles
constexpr int kFStagingBytes = 2 * 64 * kFRow * 8;        // 40 KB
constexpr int kFSmem = kFStages * kFStageBytes + kFStagingBytes + 2 * kFStages * 8 + 1024;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// the TPU kernel's activations, in f32 (act: 0 gelu with the rational erf,
// 1 gelu_tanh, 2 quickgelu)
__device__ __forceinline__ float activation(float h, int act) {
  if (act == 0) {
    const float x = h * 0.70710678118654752f;
    const float ax = fabsf(x);
    const float t = 1.f / (1.f + 0.3275911f * ax);
    const float poly =
        ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
         0.254829592f) *
        t;
    const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
    return 0.5f * h * (1.f + sgn * (1.f - poly * expf(-ax * ax)));
  }
  if (act == 1) {
    return 0.5f * h * (1.f + tanhf(0.79788456080286536f * (h + 0.044715f * h * h * h)));
  }
  return h * (1.f / (1.f + expf(-1.702f * h)));
}

// out (M, N) = epilogue(A (M, K) @ B (K, N)), A and B bf16 row-major by
// tensor map; epilogue: + f32(bias[n]), activation `act` (-1: none), bf16.
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_bias_act(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const uint16_t* __restrict__ bias,
                  uint16_t* __restrict__ out, int M, int N, int K, int act) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_blocks = (K + kBK - 1) / kBK;

  if (tid >= 2 * 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM;
        const int n0 = (t % n_tiles) * kBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(a, &map_a, &full[stage], kb * kBK, m0);
#pragma unroll
          for (int i = 0; i < kBN / 64; ++i) {
            tma_load_2d(a + kABytes + i * kBChunk, &map_b, &full[stage], n0 + 64 * i, kb * kBK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the tile each
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM;
      const int n0 = (t % n_tiles) * kBN;
      int prev = 0;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(smem + stage * kStageBytes) + wg * (64 * 128);
        const uint32_t b = smem_u32(smem + stage * kStageBytes + kABytes);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          wgmma_m64n256k16_ss<1>(acc, smem_desc(a + 32 * ks, 16, 1024),
                                 smem_desc(b + 2048 * ks, kBChunk, 1024), kb + ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done: free its stage
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      const long long row = m0 + wg * 64 + warp * 16 + (lane >> 2);
      const int cb = n0 + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = cb + 8 * j;
        if (col < N) {  // N is even: col + 1 < N too
          const float b0 = bf16_to_f32(bias[col]);
          const float b1 = bf16_to_f32(bias[col + 1]);
          float v0 = acc[4 * j] + b0, v1 = acc[4 * j + 1] + b1;
          float v2 = acc[4 * j + 2] + b0, v3 = acc[4 * j + 3] + b1;
          if (act >= 0) {
            v0 = activation(v0, act);
            v1 = activation(v1, act);
            v2 = activation(v2, act);
            v3 = activation(v3, act);
          }
          if (row < M) {
            *reinterpret_cast<uint32_t*>(out + row * N + col) = pack_bf16(v0, v1);
          }
          if (row + 8 < M) {
            *reinterpret_cast<uint32_t*>(out + (row + 8) * N + col) = pack_bf16(v2, v3);
          }
        }
      }
    }
  }
}

// (x, y) = p0 + p1 + p2 exactly, each piece a bf16 pair (8 significant bits
// apiece; each remainder is exact in f32): the pieces packed as bf16x2
__device__ __forceinline__ void split3(float x, float y, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x, y);
  const float2 f0 = __bfloat1622float2(h0);
  const float rx = x - f0.x, ry = y - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(rx, ry);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx - f1.x, ry - f1.y);  // exact
  p0 = *reinterpret_cast<const uint32_t*>(&h0);
  p1 = *reinterpret_cast<const uint32_t*>(&h1);
  p2 = *reinterpret_cast<const uint32_t*>(&h2);
}

// exp(x) in f64 to ~1e-11 relative, for x <= 700 (0 below -700): 2^k e^r,
// |r| <= ln2 / 2, r's series to degree 9; k rounded by adding 1.5 * 2^52
// (its integer is then the low word), so that no conversion unit is used
__device__ __forceinline__ double exp64(double x) {
  if (x < -700.0) return 0.0;
  const double shifted = fma(x, 1.4426950408889634, 6755399441055744.0);
  const double k = shifted - 6755399441055744.0;
  const double r = fma(k, -6.93147180369123816490e-01, x) - k * 1.90821492927058770002e-10;
  double p = 1.0 / 362880.0;
  p = fma(p, r, 1.0 / 40320.0);
  p = fma(p, r, 1.0 / 5040.0);
  p = fma(p, r, 1.0 / 720.0);
  p = fma(p, r, 1.0 / 120.0);
  p = fma(p, r, 1.0 / 24.0);
  p = fma(p, r, 1.0 / 6.0);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  p = fma(p, r, 1.0);
  return __longlong_as_double(__double_as_longlong(p) +
                              static_cast<long long>(__double2loint(shifted)) * (1LL << 52));
}

// 1 / d in f64 for 1 <= d <= 1e305: the approximate f64 reciprocal refined
// by two Newton steps (the f64 division's slow path is never needed here)
__device__ __forceinline__ double rcp64(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(d));
  r = fma(r, fma(-d, r, 1.0), r);
  return fma(r, fma(-d, r, 1.0), r);
}

// The activations in f64 (the f32 constants of `activation` widened), as the
// exact oracle evaluates them up to f64 rounding: gelu_tanh as h (1 +
// tanh(u)) / 2 = h / (1 + exp(-2u)) and quickgelu as h / (1 + exp(-1.702 h)),
// with no cancellation; exp's argument capped at 700, where h / (1 + e^z) is
// 0 to f32 precision.
__device__ __forceinline__ double activation64(double h, int act) {
  if (act == 0) {
    const double x = h * static_cast<double>(0.70710678118654752f);
    const double ax = fabs(x);
    const double t = rcp64(1.0 + 0.3275911 * fmin(ax, 1e30));
    const double poly =
        ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t - 0.284496736) * t +
         0.254829592) *
        t;
    const double e = 1.0 - poly * exp64(-ax * ax);  // erf(|x|)
    return 0.5 * h * (1.0 + (x < 0.0 ? -e : e));
  }
  const double z = act == 1 ? -2.0 * static_cast<double>(0.79788456080286536f) *
                                  (h + 0.044715 * h * h * h)
                            : -1.702 * h;
  return h * rcp64(1.0 + exp64(fmin(z, 700.0)));
}

// The f32 pre-pass: w (K, N) f32 -> its three bf16 planes (3, K, N), w =
// plane 0 + plane 1 + plane 2 exactly. Two elements a thread.
__global__ void split_weight(const float* __restrict__ w, uint16_t* __restrict__ planes,
                             long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i >= n) return;
  const float2 v = *reinterpret_cast<const float2*>(w + i);  // n is even
  uint32_t p0, p1, p2;
  split3(v.x, v.y, p0, p1, p2);
  *reinterpret_cast<uint32_t*>(planes + i) = p0;
  *reinterpret_cast<uint32_t*>(planes + n + i) = p1;
  *reinterpret_cast<uint32_t*>(planes + 2 * n + i) = p2;
}

// float2 (row, k..k+1) of a 128-row tile of 32-float rows in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)); g = row % 8
__device__ __forceinline__ float2 tile_f2(const uint8_t* tile, int row, int k, int g) {
  return *reinterpret_cast<const float2*>(tile + row * 128 +
                                          ((((k >> 2) ^ g) << 4) | ((k & 3) << 2)));
}

// this thread's A fragments of one K slice (a 128 x 32 f32 tile), each split
// into its three bf16 pieces: a[ks][piece][j], register j of k16 step ks
// holding row r + 8 (j & 1), k 16 ks + 2 tq + 8 (j >> 1) and the next k
__device__ __forceinline__ void load_split_a(const uint8_t* tile, int r, int tq, int g,
                                             uint32_t (&a)[kFBK / 16][3][4]) {
#pragma unroll
  for (int ks = 0; ks < kFBK / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = tile_f2(tile, r + 8 * (j & 1), 16 * ks + 2 * tq + 8 * (j >> 1), g);
      split3(v.x, v.y, a[ks][0][j], a[ks][1][j], a[ks][2][j]);
    }
  }
}

// d (64 x 128) = one K slice's six piece products (those of weight 2^-16
// and more) from a zero accumulator, the smallest first so that the large
// term comes last: B's plane p at b + p * kFPlaneBytes, k16 step ks 16
// k-rows of 128 bytes further
__device__ __forceinline__ void slice_products(float (&d)[64],
                                               const uint32_t (&a)[kFBK / 16][3][4],
                                               uint32_t b) {
#define MVP_DESC_B(p, ks) smem_desc(b + (p) * kFPlaneBytes + 2048 * (ks), kFBChunk, 1024)
#pragma unroll
  for (int ks = 0; ks < kFBK / 16; ++ks) {
    wgmma_m64n128k16_rs<1>(d, a[ks][2], MVP_DESC_B(0, ks), ks > 0);
    wgmma_m64n128k16_rs<1>(d, a[ks][1], MVP_DESC_B(1, ks), 1);
    wgmma_m64n128k16_rs<1>(d, a[ks][0], MVP_DESC_B(2, ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < kFBK / 16; ++ks) {
    wgmma_m64n128k16_rs<1>(d, a[ks][1], MVP_DESC_B(0, ks), 1);
    wgmma_m64n128k16_rs<1>(d, a[ks][0], MVP_DESC_B(1, ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < kFBK / 16; ++ks) {
    wgmma_m64n128k16_rs<1>(d, a[ks][0], MVP_DESC_B(0, ks), 1);
  }
#undef MVP_DESC_B
}

// acc += part, compensated (Kahan): acc - comp carries the rounding errors
// of the f32 additions
__device__ __forceinline__ void kahan(float (&acc)[64], float (&comp)[64],
                                      const float (&part)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float y = part[i] - comp[i];
    const float s = acc[i] + y;
    comp[i] = (s - acc[i]) - y;
    acc[i] = s;
  }
}

// out (M, N) = epilogue(A (M, K) @ B (K, N)) on f32 operands: A f32
// row-major, B as its three bf16 planes (3, K, N), both by tensor map;
// epilogue in f64: + bias[n], activation `act` (-1: none), rounded to f32.
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_bf16x6(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const float* __restrict__ bias,
                float* __restrict__ out, int M, int N, int K, int act) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  double* staging = reinterpret_cast<double*>(smem + kFStages * kFStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFStages * kFStageBytes + kFStagingBytes);
  uint64_t* empty = full + kFStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (N + kFBN - 1) / kFBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_blocks = (K + kFBK - 1) / kFBK;

  if (tid >= 2 * 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM;
        const int n0 = (t % n_tiles) * kFBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a = smem + stage * kFStageBytes;
          mbar_expect_tx(&full[stage], kFStageBytes);
          tma_load_2d(a, &map_a, &full[stage], kb * kFBK, m0);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int i = 0; i < kFBN / 64; ++i) {
              tma_load_3d(a + kFABytes + p * kFPlaneBytes + i * kFBChunk, &map_b, &full[stage],
                          n0 + 64 * i, kb * kFBK, p);
            }
          }
          if (++stage == kFStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the tile each
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int r = wg * 64 + warp * 16 + g;  // this thread's A rows: r and r + 8
    // The two warpgroups take turns at the tensor cores, a K slice each,
    // so that one's split and compensated sum run while the other's
    // products do: barrier 2 + wg is "warpgroup wg may issue", opened by
    // the other warpgroup once it has issued (warpgroup 0 goes first).
    const int my_turn = 2 + wg, their_turn = 2 + (wg ^ 1);
    if (wg == 1) named_barrier_arrive(2, 2 * 128);
    int stage = 0;
    uint32_t phase = 0;
    // acc / comp [4 j + e]: column 8 j + 2 tq + (e & 1) of rows r (e < 2)
    // and r + 8 of the warpgroup's 64 x 128 quarter of the tile; part: one
    // K slice's products
    float acc[64], comp[64], part[64];
    uint32_t a[kFBK / 16][3][4];

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM;
      const int n0 = (t % n_tiles) * kFBN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = comp[i] = 0.f;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sa = smem + stage * kFStageBytes;
        load_split_a(sa, r, tq, g, a);
        named_barrier(my_turn, 2 * 128);
        fence_operands(part);
        wgmma_fence();
        slice_products(part, a, smem_u32(sa + kFABytes));
        wgmma_commit();
        named_barrier_arrive(their_turn, 2 * 128);
        wgmma_wait<0>();
        fence_operands(part);
        if (lane == 0) mbar_arrive(&empty[stage]);
        kahan(acc, comp, part);
        if (++stage == kFStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue, a quarter of the columns at a time: each thread stages
      // acc - comp + bias of its accumulators in f64, then the warpgroup
      // applies the activation to the staged values in f64, a warp to a
      // row of 32 columns, and stores them rounded to f32, coalesced
      double* mine = staging + wg * 64 * kFRow;
      const int srow = warp * 16 + g;  // this thread's rows in the staging: srow, srow + 8
#pragma unroll
      for (int q = 0; q < kFBN / kFPass; ++q) {
#pragma unroll
        for (int j = 0; j < kFPass / 8; ++j) {
          const int jj = q * (kFPass / 8) + j;  // the accumulators' 8-column block
          const int scol = 8 * j + 2 * tq;
          const int col = n0 + 8 * jj + 2 * tq;
          const double b0 = col < N ? bias[col] : 0.0;  // N is even: col + 1 < N too
          const double b1 = col < N ? bias[col + 1] : 0.0;
          *reinterpret_cast<double2*>(mine + srow * kFRow + scol) = make_double2(
              (static_cast<double>(acc[4 * jj]) - comp[4 * jj]) + b0,
              (static_cast<double>(acc[4 * jj + 1]) - comp[4 * jj + 1]) + b1);
          *reinterpret_cast<double2*>(mine + (srow + 8) * kFRow + scol) = make_double2(
              (static_cast<double>(acc[4 * jj + 2]) - comp[4 * jj + 2]) + b0,
              (static_cast<double>(acc[4 * jj + 3]) - comp[4 * jj + 3]) + b1);
        }
        named_barrier(4 + wg, 128);
        const int col = n0 + q * kFPass + lane;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int sr = warp + 4 * i;
          double v = mine[sr * kFRow + lane];
          if (act >= 0) v = activation64(v, act);
          if (m0 + wg * 64 + sr < M && col < N) {
            out[static_cast<long long>(m0 + wg * 64 + sr) * N + col] = static_cast<float>(v);
          }
        }
        named_barrier(4 + wg, 128);
      }
    }
    if (wg == 0) named_barrier(my_turn, 2 * 128);  // warpgroup 1's last opening
  }
}

// one GEMM launch: out (M, N) = epilogue(a (M, K) @ b (K, N))
int launch_gemm(const void* a, const void* b, const void* bias, void* out, int M, int N, int K,
                int act, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t dims_b[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t stride_a[1] = {static_cast<uint64_t>(K) * 2};
  const uint64_t stride_b[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t box_a[2] = {kBK, kBM};
  const uint32_t box_b[2] = {64, kBK};
  int err = encode_tensor_map(&map_a, a, 2, dims_a, stride_a, box_a);
  if (err == 0) err = encode_tensor_map(&map_b, b, 2, dims_b, stride_b, box_b);
  if (err != 0) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int sms = sm_count();
  cudaFuncSetAttribute(gemm_bias_act, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  gemm_bias_act<<<tiles < sms ? tiles : sms, kGemmThreads, kGemmSmem, stream>>>(
      map_a, map_b, static_cast<const uint16_t*>(bias), static_cast<uint16_t*>(out), M, N, K,
      act);
  return static_cast<int>(cudaGetLastError());
}

// one f32 GEMM launch: out (M, N) = epilogue(a (M, K) @ b (K, N)), b given
// as its three bf16 planes (3, K, N)
int launch_gemm_f32(const void* a, const uint16_t* planes, const void* bias, void* out, int M,
                    int N, int K, int act, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t stride_a[1] = {static_cast<uint64_t>(K) * 4};
  const uint32_t box_a[2] = {kFBK, kBM};
  const uint64_t dims_b[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K), 3};
  const uint64_t stride_b[2] = {static_cast<uint64_t>(N) * 2, static_cast<uint64_t>(K) * N * 2};
  const uint32_t box_b[3] = {64, kFBK, 1};
  int err = encode_tensor_map(&map_a, a, 2, dims_a, stride_a, box_a, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == 0) err = encode_tensor_map(&map_b, planes, 3, dims_b, stride_b, box_b);
  if (err != 0) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kFBN - 1) / kFBN);
  const int sms = sm_count();
  cudaFuncSetAttribute(gemm_bf16x6, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  gemm_bf16x6<<<tiles < sms ? tiles : sms, kGemmThreads, kFSmem, stream>>>(
      map_a, map_b, static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

// the three bf16 planes (3, K, N) of w (K, N)
int launch_split(const void* w, uint16_t* planes, int K, int N, cudaStream_t stream) {
  const long long n = static_cast<long long>(K) * N;
  const int threads = 256;
  split_weight<<<static_cast<unsigned>((n / 2 + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(w), planes, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, C), w1 (C, H), b1 (H), w2 (H, C), b2 (C), out (M, C): contiguous, one
// dtype (is_bf16: 1 bfloat16, 0 float32); hidden: an (M, H) scratch of that
// dtype; planes: for float32 a workspace of 6*C*H bf16 (the split weights;
// unused, may be null, for bfloat16). act: 0 gelu, 1 gelu_tanh, 2
// quickgelu. C a multiple of 8, H a multiple of 32.
extern "C" int mvp_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* hidden, void* planes, int M,
                             int C, int H, int act, int is_bf16, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 || H <= 0 || H % 32 || act < 0 || act > 2 ||
      hidden == nullptr || (!is_bf16 && planes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int err = launch_gemm(x, w1, b1, hidden, M, H, C, act, st);  // fc1 + act
    return err != 0 ? err : launch_gemm(hidden, w2, b2, out, M, C, H, -1, st);  // fc2
  }
  uint16_t* w1_planes = static_cast<uint16_t*>(planes);  // (3, C, H)
  uint16_t* w2_planes = w1_planes + 3LL * C * H;         // (3, H, C)
  int err = launch_split(w1, w1_planes, C, H, st);
  if (err == 0) err = launch_split(w2, w2_planes, H, C, st);
  if (err == 0) err = launch_gemm_f32(x, w1_planes, b1, hidden, M, H, C, act, st);  // fc1
  return err != 0 ? err : launch_gemm_f32(hidden, w2_planes, b2, out, M, C, H, -1, st);
}
