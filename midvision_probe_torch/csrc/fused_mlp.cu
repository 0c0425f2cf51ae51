// Fused transformer MLP for Hopper (sm_90a), forward only:
// out = (act(x @ W1 + b1) rounded to x's dtype) @ W2 + b2.
//
// Replaces the JAX package's Pallas TPU kernel `fused_mlp`
// (ops/fused_mlp.py, `_forward` -> `_mlp_kernel`), a library op that no
// model dispatches. Entry point mvp_fused_mlp; x (M, C), W1 (C, H), b1 (H),
// W2 (H, C), b2 (C), out (M, C), all contiguous and of one dtype.
//
// What it computes: h = x @ W1 accumulated in f32, plus f32(b1); act(h) in
// f32 with the TPU kernel's activations (gelu with the Abramowitz-Stegun
// rational erf, gelu_tanh, quickgelu); h rounded to x's dtype; o = h @ W2
// accumulated in f32, plus f32(b2), rounded to x's dtype. The hidden
// activations never go to device memory.
//
// What bounds it on an H100: at DINO ViT-B/16's MLP over a 64-image batch
// at 480x640 (M = 64*1201 = 76,864, C = 768, H = 3072, bf16) the work is
// 4*M*C*H = 7.25e11 tensor-core operations against ~0.25 GB of x, weights
// and output: bound by operations (0.733 ms at 989 TFLOP/s; 0.073 ms of
// bytes). The design: a block owns 32 rows and walks the hidden dimension
// in chunks of 32. Per chunk it computes the (32 x 32) hidden tile from the
// block's x rows (resident in shared memory) and W1 tiles streamed through
// a two-stage cp.async ring, applies bias and activation in registers,
// rounds the tile to bf16 into shared memory, and multiplies it with the
// chunk's 32 rows of W2 (staged whole in shared memory) into the block's
// (32 x C) f32 output accumulator, which lives in registers split across
// 8 warps by columns (C/8 floats a thread: 160 at C = 1280, hence 32 rows).
// Both products run on mma.sync m16n8k16 (bf16 in, f32 accumulate); the
// W1/W2 fragments come from row-major tiles through ldmatrix .trans. W1 and
// W2 (9.4 MB in bf16 at ViT-B, 26 MB at ViT-H) are re-read by every block
// and stay in the 50 MB L2. 32 rows per block make that L2 traffic the
// limit of this simple design (32 operations per byte of weights read);
// wgmma with 128-row tiles and TMA is the next step.
//
// float32 takes a SIMT path (f32 FMA, no TF32, 16 rows per block, W1 and
// W2 read through L1/L2), which keeps full f32 accuracy for parity runs; it
// is not tuned.
//
// C in {768, 1024, 1280}, the zoo's ViT widths (one instance each: the
// output accumulator is indexed at compile time); H a multiple of 32; any M >= 1.
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 32;      // bf16 path: rows of x per block
constexpr int kHC = 32;        // hidden units per chunk
constexpr int kKT = 64;        // bf16 path: rows of a W1 tile (along C)
constexpr int kLW = kHC + 8;   // padded row of a W1 tile and of the hidden tile, halves
constexpr int kRowsF = 16;     // f32 path: rows of x per block

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

// B fragments of m16n8k16 from a row-major [k][n] bf16 tile: x2 gives
// {b0, b1} of one n-tile (lanes 0-15 address rows k0..k0+15 at column n0),
// x4 those of two (lanes 16-31 address the same rows at column n0 + 8).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w1,
                   const uint16_t* __restrict__ b1, const uint16_t* __restrict__ w2,
                   const uint16_t* __restrict__ b2, uint16_t* __restrict__ out, int M, int H,
                   int act) {
  constexpr int LX = C + 8;       // padded row of x and of a W2 chunk, halves
  constexpr int CX = C / 8;       // 16-byte chunks per row of x / W2
  constexpr int NKT = C / kKT;    // W1 tiles per hidden chunk
  constexpr int CW = C / 4;       // output columns per warp
  constexpr int NTB = CW / 8;     // output n-tiles per warp

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sX = smem;               // [kRows][LX]
  uint16_t* sW2 = sX + kRows * LX;   // [kHC][LX]
  uint16_t* sW1 = sW2 + kHC * LX;    // [2][kKT][kLW]
  uint16_t* sH = sW1 + 2 * kKT * kLW;  // [kRows][kLW]

  const int m0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rg = warp & 1;   // rows rg*16 .. rg*16+15 in both products
  const int cg = warp >> 1;  // hidden columns cg*8 (fc1); output columns cg*CW (fc2)

  for (int i = tid; i < kRows * CX; i += kThreads) {
    const int r = i / CX, c = i % CX;
    uint16_t* dst = sX + r * LX + c * 8;
    if (m0 + r < M) {
      cp_async16(dst, x + static_cast<long long>(m0 + r) * C + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  auto fetch_w1 = [&](int h0, int kt, int stage) {  // W1[kt*64 .. +64][h0 .. h0+32]
    uint16_t* dst = sW1 + stage * kKT * kLW;
    for (int i = tid; i < kKT * (kHC / 8); i += kThreads) {
      const int r = i / (kHC / 8), c = i % (kHC / 8);
      cp_async16(dst + r * kLW + c * 8,
                 w1 + static_cast<long long>(kt * kKT + r) * H + h0 + c * 8);
    }
  };

  float o[NTB][4];
#pragma unroll
  for (int nt = 0; nt < NTB; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  }

  for (int h0 = 0; h0 < H; h0 += kHC) {
    // this chunk's 32 rows of W2 and the first W1 tile, in one group
    for (int i = tid; i < kHC * CX; i += kThreads) {
      const int r = i / CX, c = i % CX;
      cp_async16(sW2 + r * LX + c * 8, w2 + static_cast<long long>(h0 + r) * C + c * 8);
    }
    fetch_w1(h0, 0, 0);
    cp_async_commit();

    // fc1: this warp's 16 x 8 tile of the hidden chunk
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < NKT; ++kt) {
      if (kt + 1 < NKT) {
        fetch_w1(h0, kt + 1, (kt + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint16_t* tile = sW1 + (kt & 1) * kKT * kLW;
#pragma unroll
      for (int ks = 0; ks < kKT / 16; ++ks) {
        const uint16_t* xa = sX + (rg * 16 + g) * LX + kt * kKT + ks * 16 + tq * 2;
        uint32_t a[4];
        a[0] = ld_u32(xa);
        a[1] = ld_u32(xa + 8 * LX);
        a[2] = ld_u32(xa + 8);
        a[3] = ld_u32(xa + 8 * LX + 8);
        uint32_t b[2];
        ldmatrix_x2_trans(b, tile + (ks * 16 + (lane & 15)) * kLW + cg * 8);
        mma_16816(acc, a, b[0], b[1]);
      }
      __syncthreads();  // the next fetch refills this stage
    }

    // bias + activation in f32, rounded to bf16 into the hidden tile
    {
      const int col = cg * 8 + tq * 2;
      const float bb0 = bf16_to_f32(b1[h0 + col]);
      const float bb1 = bf16_to_f32(b1[h0 + col + 1]);
      uint16_t* hr = sH + (rg * 16 + g) * kLW + col;
      *reinterpret_cast<uint32_t*>(hr) =
          pack_bf16(activation(acc[0] + bb0, act), activation(acc[1] + bb1, act));
      *reinterpret_cast<uint32_t*>(hr + 8 * kLW) =
          pack_bf16(activation(acc[2] + bb0, act), activation(acc[3] + bb1, act));
    }
    __syncthreads();

    // fc2: this warp's 16 rows x CW columns += hidden (16 x 32) @ W2 chunk
#pragma unroll
    for (int ks = 0; ks < kHC / 16; ++ks) {
      const uint16_t* ha = sH + (rg * 16 + g) * kLW + ks * 16 + tq * 2;
      uint32_t a[4];
      a[0] = ld_u32(ha);
      a[1] = ld_u32(ha + 8 * kLW);
      a[2] = ld_u32(ha + 8);
      a[3] = ld_u32(ha + 8 * kLW + 8);
      const uint16_t* wb =
          sW2 + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LX + cg * CW + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < NTB / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wb + np * 16);
        mma_16816(o[2 * np], a, b[0], b[1]);
        mma_16816(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next chunk refills W2 and the hidden tile
  }

  const int ra = m0 + rg * 16 + g;
  const int rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < NTB; ++nt) {
    const int col = cg * CW + nt * 8 + tq * 2;
    const float bb0 = bf16_to_f32(b2[col]);
    const float bb1 = bf16_to_f32(b2[col + 1]);
    if (ra < M) {
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(ra) * C + col) =
          pack_bf16(o[nt][0] + bb0, o[nt][1] + bb1);
    }
    if (rb < M) {
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(rb) * C + col) =
          pack_bf16(o[nt][2] + bb0, o[nt][3] + bb1);
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

template <int C>
int launch_c(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
             void* out, int M, int H, int act, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const int smem = ((kRows + kHC) * (C + 8) + 2 * kKT * kLW + kRows * kLW) *
                     static_cast<int>(sizeof(uint16_t));
    cudaFuncSetAttribute(fused_mlp_bf16<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_mlp_bf16<C><<<(M + kRows - 1) / kRows, kThreads, smem, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w1),
        static_cast<const uint16_t*>(b1), static_cast<const uint16_t*>(w2),
        static_cast<const uint16_t*>(b2), static_cast<uint16_t*>(out), M, H, act);
  } else {
    const int smem = (kRowsF * C + kRowsF * kHC) * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(fused_mlp_f32<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_mlp_f32<C><<<(M + kRowsF - 1) / kRowsF, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), M, H, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, C), w1 (C, H), b1 (H), w2 (H, C), b2 (C), out (M, C): contiguous, one
// dtype (is_bf16: 1 bfloat16, 0 float32). act: 0 gelu, 1 gelu_tanh,
// 2 quickgelu.
extern "C" int mvp_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int M, int C, int H, int act,
                             int is_bf16, void* stream) {
  if (M <= 0 || H <= 0 || H % kHC || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 768: return launch_c<768>(x, w1, b1, w2, b2, out, M, H, act, is_bf16, st);
    case 1024: return launch_c<1024>(x, w1, b1, w2, b2, out, M, H, act, is_bf16, st);
    case 1280: return launch_c<1280>(x, w1, b1, w2, b2, out, M, H, act, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
