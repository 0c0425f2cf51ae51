// Fused transformer MLP for Hopper (sm_90a), forward only:
// out = (act(x @ W1 + b1) rounded to x's dtype) @ W2 + b2.
//
// Replaces the JAX package's Pallas TPU kernel `fused_mlp`
// (ops/fused_mlp.py, `_forward` -> `_mlp_kernel`), a library op that no
// model dispatches. Entry point mvp_fused_mlp; x (M, C), W1 (C, H), b1 (H),
// W2 (H, C), b2 (C), out (M, C), all contiguous and of one dtype; bf16 also
// takes an (M, H) scratch for the hidden activations.
//
// What it computes: h = x @ W1 accumulated in f32, plus f32(b1); act(h) in
// f32 with the TPU kernel's activations (gelu with the Abramowitz-Stegun
// rational erf, gelu_tanh, quickgelu); h rounded to x's dtype; o = h @ W2
// accumulated in f32, plus f32(b2), rounded to x's dtype. The rounding
// points are the TPU kernel's; only the f32 summation order differs.
//
// What bounds it on an H100: at DINO ViT-B/16's MLP over a 64-image batch
// at 480x640 (M = 64*1201 = 76,864, C = 768, H = 3072, bf16) the work is
// 4*M*C*H = 7.25e11 tensor-core operations against ~0.25 GB of x, weights
// and output: bound by operations (0.733 ms at 989 TFLOP/s).
//
// The bf16 design: one warp-specialised wgmma GEMM with a fused epilogue,
// launched twice (fc1 into the scratch, fc2 from it). Keeping the hidden
// activations on chip would need a (rows x C) f32 accumulator for the whole
// hidden loop: at wgmma's least M of 64 rows that is 196 KB of registers at
// C = 768 and 320 KB at C = 1280, more than an SM's 256 KB, so a one-SM
// fused design is held to small row blocks (32 on mma.sync) that re-read W1
// and W2 from L2 for every block. The hidden instead makes one round trip through
// device memory in bf16 (472 MB written and read at DINO's shape); both
// products stay above the card's ridge, so the kernel stays bound by
// operations. The GEMM:
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
// Ragged M, N and K need no padding: TMA fills rows and columns outside the
// tensors with zeros, and the stores are masked.
// On the card (NVIDIA H100 80GB HBM3, 700 W) this runs at ~4x its bound
// at DINO's shape (3.1 ms). Two variants ran slower in the same call and
// were dropped: a 2-CTA cluster that multicasts each B slice (so L2
// bandwidth does not bound the tile), and a schedule in which the two
// warpgroups take whole 128 x 128 tiles in turn, one's epilogue beside the
// other's products. The epilogue's exact activation math is a large share:
// gelu, with its f32 division and expf, is slower than gelu_tanh. PERF.md
// has the numbers.
//
// float32 takes a SIMT path (f32 FMA, no TF32, 16 rows per block, W1 and
// W2 read through L1/L2, the hidden kept in shared memory), which keeps
// full f32 accuracy for parity runs; it is not tuned.
//
// bf16: any C and H that are multiples of 8 (the wrapper asks H to be a
// multiple of 32 on both paths); f32: C in {768, 1024, 1280} (one instance
// each: the output accumulator is indexed at compile time), H a multiple of
// 32; any M >= 1. Plain C interface for ctypes; returns cudaGetLastError()
// after the launches (or the tensor-map encoding's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // f32 path: 8 warps
constexpr int kHC = 32;        // f32 path: hidden units per chunk
constexpr int kRowsF = 16;     // f32 path: rows of x per block

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

// f32 SIMT path: a block owns 16 rows; thread t works on row t / 16. fc1:
// hidden columns t % 16 and t % 16 + 16 of the chunk; fc2: output columns
// t % 16 + 16 j.
template <int C>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_f32(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int M, int H,
                  int act) {
  constexpr int NJ = C / 16;
  extern __shared__ __align__(16) float smemf[];
  float* sX = smemf;               // [kRowsF][C]
  float* sH = sX + kRowsF * C;     // [kRowsF][kHC]

  const int m0 = blockIdx.x * kRowsF;
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  for (int i = tid; i < kRowsF * C / 4; i += kThreads) {
    const int row = i / (C / 4), q = i % (C / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + row < M) {
      val = *reinterpret_cast<const float4*>(x + static_cast<long long>(m0 + row) * C + q * 4);
    }
    *reinterpret_cast<float4*>(sX + row * C + q * 4) = val;
  }
  float o[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j] = 0.f;
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += kHC) {
    float a0 = 0.f, a1 = 0.f;
    const float* xr = sX + r * C;
    const float* wc = w1 + h0 + c;
    for (int k = 0; k < C; ++k) {
      const float xv = xr[k];
      a0 = fmaf(xv, __ldg(wc + static_cast<long long>(k) * H), a0);
      a1 = fmaf(xv, __ldg(wc + static_cast<long long>(k) * H + 16), a1);
    }
    sH[r * kHC + c] = activation(a0 + b1[h0 + c], act);
    sH[r * kHC + c + 16] = activation(a1 + b1[h0 + c + 16], act);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kHC; ++k) {
      const float hv = sH[r * kHC + k];
      const float* wr = w2 + static_cast<long long>(h0 + k) * C + c;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[j] = fmaf(hv, __ldg(wr + 16 * j), o[j]);
    }
    __syncthreads();
  }
  if (m0 + r < M) {
    float* dst = out + static_cast<long long>(m0 + r) * C + c;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[16 * j] = o[j] + b2[c + 16 * j];
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

template <int C>
int launch_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int M, int H, int act, cudaStream_t stream) {
  const int smem = (kRowsF * C + kRowsF * kHC) * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(fused_mlp_f32<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fused_mlp_f32<C><<<(M + kRowsF - 1) / kRowsF, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), M, H, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, C), w1 (C, H), b1 (H), w2 (H, C), b2 (C), out (M, C): contiguous, one
// dtype (is_bf16: 1 bfloat16, 0 float32). hidden: an (M, H) bf16 scratch for
// the bf16 path (unused, may be null, for float32). act: 0 gelu,
// 1 gelu_tanh, 2 quickgelu.
extern "C" int mvp_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* hidden, int M, int C, int H,
                             int act, int is_bf16, void* stream) {
  if (M <= 0 || H <= 0 || H % kHC || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hidden == nullptr || C <= 0 || C % 8) return static_cast<int>(cudaErrorInvalidValue);
    const int err = launch_gemm(x, w1, b1, hidden, M, H, C, act, st);  // fc1 + act
    return err != 0 ? err : launch_gemm(hidden, w2, b2, out, M, C, H, -1, st);  // fc2
  }
  switch (C) {
    case 768: return launch_f32<768>(x, w1, b1, w2, b2, out, M, H, act, st);
    case 1024: return launch_f32<1024>(x, w1, b1, w2, b2, out, M, H, act, st);
    case 1280: return launch_f32<1280>(x, w1, b1, w2, b2, out, M, H, act, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
