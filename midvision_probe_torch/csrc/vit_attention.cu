// Fused-qkv ViT attention for Hopper (sm_90a), forward only.
//
// Replaces the JAX package's Pallas TPU kernel `fused_qkv_attention`
// (ops/vit_attention.py: `_fused_forward` -> `_fused_kernel`).
//
// What it computes: non-causal softmax attention read straight out of the
// qkv projection. Input is the contiguous (B, N, 3, H, d) tensor (column
// order role, head, j); q, k and v are read by stride, never transposed in
// device memory. Output is (B, N, H*d), token-major. Keys and values at
// index >= n_valid are never read: their shared-memory rows are zero-filled
// and their scores are -inf, so NaN garbage in padded rows cannot reach the
// softmax or the PV product. Query rows in [n_valid, N) are computed like
// any other row (they attend over the valid keys); rows >= N are not
// written.
//
// What bounds it on an H100: at the ViT-B/16 probing shape (B=64, N=1201,
// H=12, d=64) the work is 4*B*H*N^2*d = 283 GFLOP against 2 * 59 MB of
// bf16 qkv-in / out-out traffic, ~2400 FLOP per byte, far above the card's
// ~295 FLOP/byte ridge: it is bound by tensor-core operations (bound
// ~0.29 ms at 989 TFLOP/s). The design therefore keeps the N x N scores
// out of device memory entirely (online softmax over KV tiles in shared
// memory, fp32 accumulators in registers) and runs both products on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the next
// KV tile is fetched with cp.async while the current one is consumed.
// wgmma/TMA (the only route to the full tensor-core rate) is left for a
// later revision.
//
// The JAX kernel's max-free exp2 softmax, its +110 clamp and its 1e-30
// normaliser floor work around the TPU's vector unit; this kernel uses the
// exact max-subtracted online softmax instead (scores are pre-scaled by
// scale*log2(e) so the exponential is exp2).
//
// fp32 inputs take a separate SIMT path (fp32 FMA, no TF32), which keeps
// full fp32 accuracy for parity runs; it is not tuned.
//
// Plain C interface for ctypes: every argument is a pointer or an int (the
// softmax scale arrives as the bit pattern of a float); the function
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;  // 4 warps per block on both paths
constexpr int kBM = 64;        // bf16 path: query rows per block (16 per warp)
constexpr int kBN = 64;        // bf16 path: keys per KV tile

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

// One block per (q-tile of 64 rows, head, batch). Each warp owns 16 query
// rows. Shared memory: Q[64][D+8] plus two stages of K[64][D+8] and
// V[64][D+8]; the +8 halves of row padding make every fragment load below
// free of bank conflicts for D in {16, 32, 64, 128}.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_qkv_attention_bf16(const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out,
                             int N, int H, int n_valid, float scale_log2) {
  constexpr int LD = D + 8;   // padded shared-memory row, in halves
  constexpr int KC = D / 16;  // k-chunks of Q K^T
  constexpr int DN = D / 8;   // n-tiles of P V
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NT = kBN / 8; // n-tiles of the score tile

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + kBM * LD;
  uint16_t* sV = sK + 2 * kBN * LD;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in quad
  const int HD = H * D;
  const long long tok = 3LL * HD;  // elements between consecutive tokens
  const uint16_t* base = qkv + static_cast<long long>(b) * N * tok + h * D;

  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint16_t* dst = sQ + r * LD + c * 8;
    if (q0 + r < N) {
      cp_async16(dst, base + (q0 + r) * tok + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBN;
    uint16_t* dK = sK + stage * kBN * LD;
    uint16_t* dV = sV + stage * kBN * LD;
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      if (k0 + r < n_valid) {
        const uint16_t* src = base + (k0 + r) * tok + c * 8;
        cp_async16(dK + r * LD + c * 8, src + HD);
        cp_async16(dV + r * LD + c * 8, src + 2 * HD);
      } else {  // never read keys/values past n_valid
        *reinterpret_cast<uint4*>(dK + r * LD + c * 8) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dV + r * LD + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  const int n_tiles = (n_valid + kBN - 1) / kBN;
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KC][4];
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  float m[2] = {neg_inf(), neg_inf()};  // running row max (rows g and g+8)
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
      const uint16_t* qw = sQ + warp * 16 * LD;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        qf[kc][0] = ld_u32(qw + g * LD + kc * 16 + tq * 2);
        qf[kc][1] = ld_u32(qw + (g + 8) * LD + kc * 16 + tq * 2);
        qf[kc][2] = ld_u32(qw + g * LD + kc * 16 + 8 + tq * 2);
        qf[kc][3] = ld_u32(qw + (g + 8) * LD + kc * 16 + 8 + tq * 2);
      }
    }
    const uint16_t* cK = sK + (j & 1) * kBN * LD;
    const uint16_t* cV = sV + (j & 1) * kBN * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const uint16_t* kr = cK + (nt * 8 + g) * LD + tq * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma_16816(s[nt], qf[kc], ld_u32(kr + kc * 16), ld_u32(kr + kc * 16 + 8));
      }
    }

    // scale to base 2, mask keys past n_valid, online softmax update
    const int k0 = j * kBN;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tq * 2 + (e & 1);
        const float v = key < n_valid ? s[nt][e] * scale_log2 : neg_inf();
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V; the score accumulators already sit in the A-fragment layout
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const uint16_t* vr = cV + (kc * 16 + tq * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const uint16_t* vp = vr + dn * 8;
        mma_16816(o[dn], pa, pack_u16(vp[0], vp[LD]), pack_u16(vp[8 * LD], vp[9 * LD]));
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int ra = q0 + warp * 16 + g;
  const int rb = ra + 8;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = h * D + dn * 8 + tq * 2;
    if (ra < N) {
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(b * N + ra) * HD + col) =
          pack_bf16(o[dn][0] * inv[0], o[dn][1] * inv[0]);
    }
    if (rb < N) {
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(b * N + rb) * HD + col) =
          pack_bf16(o[dn][2] * inv[1], o[dn][3] * inv[1]);
    }
  }
}

// fp32 SIMT path: one block per (q-tile of 32 rows, head, batch); four
// threads share a query row, each holding every fourth element of q and of
// the output accumulator; dot products are finished with quad shuffles.
constexpr int kF32Rows = 32;
constexpr int kF32Keys = 32;
constexpr int kF32Tpr = 4;

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_qkv_attention_f32(const float* __restrict__ qkv, float* __restrict__ out, int N,
                            int H, int n_valid, float scale_log2) {
  constexpr int DPT = D / kF32Tpr;
  constexpr int C4 = D / 4;  // float4 chunks per row
  __shared__ __align__(16) float sK[kF32Keys][D];
  __shared__ __align__(16) float sV[kF32Keys][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t = tid % kF32Tpr;
  const int qi = blockIdx.x * kF32Rows + tid / kF32Tpr;
  const int HD = H * D;
  const long long tok = 3LL * HD;
  const float* base = qkv + static_cast<long long>(b) * N * tok + h * D;

  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = qi < N ? base[qi * tok + t + kF32Tpr * i] * scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  float m = neg_inf(), l = 0.f;

  for (int k0 = 0; k0 < n_valid; k0 += kF32Keys) {
    __syncthreads();
    for (int i = tid; i < kF32Keys * C4; i += kThreads) {
      const int r = i / C4, c = i % C4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < n_valid) {  // never read keys/values past n_valid
        const float* src = base + (k0 + r) * tok + c * 4;
        kv = *reinterpret_cast<const float4*>(src + HD);
        vv = *reinterpret_cast<const float4*>(src + 2 * HD);
      }
      *reinterpret_cast<float4*>(&sK[r][c * 4]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c * 4]) = vv;
    }
    __syncthreads();

    float s[kF32Keys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) p = fmaf(q[i], sK[j][t + kF32Tpr * i], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      s[j] = k0 + j < n_valid ? p : neg_inf();
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      s[j] = exp2f(s[j] - m);
      sum += s[j];
    }
    l = l * alpha + sum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(s[j], sV[j][t + kF32Tpr * i], acc[i]);
    }
  }

  if (qi < N) {
    float* dst = out + static_cast<long long>(b * N + qi) * HD + h * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dst[t + kF32Tpr * i] = acc[i] / l;
  }
}

template <int D>
void launch_bf16(const void* qkv, void* out, int B, int N, int H, int n_valid, float sl2,
                 cudaStream_t stream) {
  const int smem = (kBM + 4 * kBN) * (D + 8) * static_cast<int>(sizeof(uint16_t));
  cudaFuncSetAttribute(fused_qkv_attention_bf16<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + kBM - 1) / kBM, H, B);
  fused_qkv_attention_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(qkv), static_cast<uint16_t*>(out), N, H, n_valid, sl2);
}

template <int D>
void launch_f32(const void* qkv, void* out, int B, int N, int H, int n_valid, float sl2,
                cudaStream_t stream) {
  const dim3 grid((N + kF32Rows - 1) / kF32Rows, H, B);
  fused_qkv_attention_f32<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, H, n_valid, sl2);
}

}  // namespace

// qkv: contiguous (B, N, 3, H, D); out: contiguous (B, N, H*D), same dtype.
// is_bf16: 1 for bfloat16, 0 for float32. scale_log2_bits: the float
// softmax scale * log2(e), passed as its 32-bit pattern.
extern "C" int mvp_fused_qkv_attention(const void* qkv, void* out, int B, int N, int H,
                                       int D, int n_valid, int scale_log2_bits,
                                       int is_bf16, void* stream) {
  float sl2;
  memcpy(&sl2, &scale_log2_bits, sizeof(sl2));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16) {
    switch (D) {
      case 16: launch_bf16<16>(qkv, out, B, N, H, n_valid, sl2, st); break;
      case 32: launch_bf16<32>(qkv, out, B, N, H, n_valid, sl2, st); break;
      case 64: launch_bf16<64>(qkv, out, B, N, H, n_valid, sl2, st); break;
      case 128: launch_bf16<128>(qkv, out, B, N, H, n_valid, sl2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (D) {
      case 16: launch_f32<16>(qkv, out, B, N, H, n_valid, sl2, st); break;
      case 32: launch_f32<32>(qkv, out, B, N, H, n_valid, sl2, st); break;
      case 64: launch_f32<64>(qkv, out, B, N, H, n_valid, sl2, st); break;
      case 128: launch_f32<128>(qkv, out, B, N, H, n_valid, sl2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
