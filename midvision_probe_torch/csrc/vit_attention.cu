// ViT softmax attention for Hopper (sm_90a), forward only: three kernels
// (routes) behind two entry points.
//
// Replaces two of the JAX package's Pallas TPU kernels (ops/vit_attention.py):
//   * K1 `fused_qkv_attention` (`_fused_forward` -> `_fused_kernel`), entry
//     point mvp_fused_qkv_attention: q, k and v read straight out of the
//     contiguous (B, N, 3, H, d) qkv projection (column order role, head,
//     j), output (B, N, H*d) token-major;
//   * K2 `vit_attention` (`_forward` -> `_attn_kernel`), entry point
//     mvp_vit_attention: q, k, v and the output are (B, H, N, d) tensors
//     given by element strides (b, h, n) with the last dimension contiguous,
//     so q/k/v may be views of the qkv projection (token stride 3*H*d) and
//     the output may be written straight into a (B, N, H, d) buffer. The
//     JAX package's `_flash_attention` (the jax library's TPU flash kernel,
//     taken when K+V exceed 2 MB of VMEM) is this same entry point: the
//     KV-tile loop below is the flash algorithm and takes any N. So is the
//     attention bench's `splash_attention` (launch_script/bench_attn.py, the
//     jax library's TPU splash kernel with a mask over the valid keys): it
//     passes n_valid < N and its softmax scale as q_scale.
//
// What it computes: non-causal softmax attention of q' = q * q_scale
// (rounded to q's dtype; q_scale = 1 leaves q as it is) with the exact
// max-subtracted online softmax (scores pre-scaled by scale*log2(e), exp2,
// fp32 accumulators). Keys and values at index >= n_valid are never read:
// they arrive in shared memory as zeros and their scores are -inf, so NaN
// garbage in padded rows cannot reach the softmax or the PV product; no
// 128-padding or segment ids are needed (the TPU kernels pad only for their
// layout). Query rows in [n_valid, N) are computed like any other row (they
// attend over the valid keys); rows >= N are not written.
//
// What bounds it on an H100: at the ViT-B/16 probing shape (B=64, N=1201,
// H=12, d=64) the work is 4*B*H*N^2*d = 283 GFLOP against 2 * 59 MB of
// bf16 qkv-in / out-out traffic, ~2400 FLOP per byte, far above the card's
// ~295 FLOP/byte ridge: it is bound by tensor-core operations (bound
// ~0.29 ms at 989 TFLOP/s); RADIO's ViT-H/16 shape (H=16, d=80) is the same
// regime. Every route keeps the N x N scores out of device memory (online
// softmax over KV tiles in shared memory, fp32 accumulators in registers).
//
// Routes (chosen here by head dim and dtype, `route_of`, and reported back
// to the caller through `route_ran`; ops/vit_attention.py `attention_route`
// mirrors the choice):
//   * 0, wgmma: bf16 at d in {64, 80} (DINO, CroCo-v2, the bench, RADIO-v2).
//     Only wgmma reaches the full tensor-core rate, and the mma.sync
//     design below spends its issue slots on scalar shared loads (4 per PV
//     product for V) and waits at two block barriers per 64-key tile, so a
//     warp's softmax never overlaps the next tile's loads. This kernel:
//     persistent blocks of one producer warpgroup and two consumer
//     warpgroups of 64 query rows; TMA loads of Q, K and V through tensor
//     maps (the strides of the views) into mbarrier-guarded rings; S = Q K^T
//     on wgmma m64n128k16 from shared memory; P converted to bf16 in
//     registers and fed as wgmma's register A operand for O += P V, with V
//     read in place (MN-major, transposed by the instruction). d = 80 splits
//     each row into a 64-column part (128-byte swizzle) and a 16-column part
//     (32-byte swizzle): QK^T takes 4 + 1 k16 steps, PV an n = 64 and an
//     n = 16 product.
//   * 1, mma_sync: bf16 at d in {16, 32, 128}: mma.sync m16n8k16, 64 query
//     rows per block (16 per warp), 64-key tiles through a cp.async double
//     buffer.
//   * 2, simt: fp32 at every head dim (fp32 FMA, no TF32), which keeps full
//     fp32 accuracy for parity runs; it is not tuned.
//
// The JAX kernels' max-free exp2 softmax, +110 clamp and 1e-30 normaliser
// floor work around the TPU's vector unit; these kernels use the exact
// max-subtracted online softmax instead.
//
// Head dims: 16, 32, 64, 80, 128.
//
// Plain C interface for ctypes: every argument is a pointer, an int or a
// 64-bit stride (the softmax scale and q_scale arrive as the bit patterns of
// floats); each entry point returns cudaGetLastError() after the launch (or
// the tensor-map encoding's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps per block on the mma_sync and simt routes
constexpr int kBM = 64;        // mma_sync route: query rows per block (16 per warp)
constexpr int kBN = 64;        // mma_sync route: keys per KV tile

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

// mma_sync route. One block per (q-tile of 64 rows, head, batch). Each warp
// owns 16 query rows. Shared memory: Q[64][D+8] plus two stages of
// K[64][D+8] and V[64][D+8]; the +8 halves of row padding make every
// fragment load below free of bank conflicts for D in {16, 32, 128}.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ out, Strides sq,
                   Strides sk, Strides sv, Strides so, int N, int n_valid, float scale_log2,
                   float q_scale) {
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
  const uint16_t* qb = q + b * sq.b + h * sq.h;
  const uint16_t* kb = k + b * sk.b + h * sk.h;
  const uint16_t* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint16_t* dst = sQ + r * LD + c * 8;
    if (q0 + r < N) {
      cp_async16(dst, qb + (q0 + r) * sq.n + c * 8);
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
        cp_async16(dK + r * LD + c * 8, kb + (k0 + r) * sk.n + c * 8);
        cp_async16(dV + r * LD + c * 8, vb + (k0 + r) * sv.n + c * 8);
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
        if (q_scale != 1.f) {  // q <- bf16(f32(q) * q_scale)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qf[kc][e] = pack_bf16(__uint_as_float(qf[kc][e] << 16) * q_scale,
                                  __uint_as_float(qf[kc][e] & 0xffff0000u) * q_scale);
          }
        }
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
        const float x = key < n_valid ? s[nt][e] * scale_log2 : neg_inf();
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
  uint16_t* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + tq * 2;
    if (ra < N) {
      *reinterpret_cast<uint32_t*>(ob + ra * so.n + col) =
          pack_bf16(o[dn][0] * inv[0], o[dn][1] * inv[0]);
    }
    if (rb < N) {
      *reinterpret_cast<uint32_t*>(ob + rb * so.n + col) =
          pack_bf16(o[dn][2] * inv[1], o[dn][3] * inv[1]);
    }
  }
}

// simt route (fp32): one block per (q-tile of 32 rows, head, batch); four
// threads share a query row, each holding every fourth element of q and of
// the output accumulator; dot products are finished with quad shuffles.
constexpr int kF32Rows = 32;
constexpr int kF32Keys = 32;
constexpr int kF32Tpr = 4;

template <int D>
__global__ void __launch_bounds__(kThreads)
    attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, Strides sq,
                  Strides sk, Strides sv, Strides so, int N, int n_valid, float scale_log2,
                  float q_scale) {
  constexpr int DPT = D / kF32Tpr;
  constexpr int C4 = D / 4;  // float4 chunks per row
  __shared__ __align__(16) float sK[kF32Keys][D];
  __shared__ __align__(16) float sV[kF32Keys][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t = tid % kF32Tpr;
  const int qi = blockIdx.x * kF32Rows + tid / kF32Tpr;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qi < N ? qb[qi * sq.n + t + kF32Tpr * i] * q_scale * scale_log2 : 0.f;
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
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * sk.n + c * 4);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * sv.n + c * 4);
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
      for (int i = 0; i < DPT; ++i) p = fmaf(qr[i], sK[j][t + kF32Tpr * i], p);
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
    float* dst = out + b * so.b + h * so.h + qi * so.n;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dst[t + kF32Tpr * i] = acc[i] / l;
  }
}

// ---------------------------------------------------------------- wgmma route
// bf16 at d = 64 and d = 80. A persistent block walks work items of 128
// query rows of one (batch, head), the query tile fastest so that concurrent
// blocks share K and V in L2. Warpgroups 0 and 1 consume 64 query rows each;
// warpgroup 2 is the producer, one thread of which issues every TMA load:
// the item's Q tile into a two-deep Q ring, then its 128-key K and V tiles
// into a kKvStages-deep ring, each tile behind its own full mbarrier and
// each slot behind an empty one. Q, K and V arrive through 4-D tensor maps
// (d, token, head, batch; token and head in the order of their strides):
// the first 64 columns with 128-byte swizzle and, at d = 80, the last 16
// through a second map with 32-byte swizzle (a 160-byte row exceeds the
// 128-byte swizzle span), each part a tile of its own that the products
// address with their own descriptors. The K and V maps end at n_valid
// tokens, so rows past it arrive as zeros and are never read from device
// memory.
constexpr int kWgThreads = 384;
constexpr int kQRows = 128;     // query rows per work item
constexpr int kKeys = 128;      // keys per KV tile
constexpr int kKvStages = 3;    // KV ring depth
constexpr int kMainBytes = 128 * 64 * 2;  // the 64-column part of a Q, K or V tile (16 KB)

template <int D>
struct WgTile {
  static constexpr int kTail = D - 64;                       // columns past 64: 0 or 16
  static constexpr int kBytes = kMainBytes + 128 * kTail * 2;  // one Q, K or V tile
  static constexpr int kSmem = (2 + 2 * kKvStages) * kBytes + (4 + 3 * kKvStages) * 8 + 1024;
};

// one tile: the 64-column part, and at d = 80 the 16-column tail after it
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          const CUtensorMap* tail, uint64_t* bar, int tok,
                                          int h, int b, bool tok_inner) {
  const int c1 = tok_inner ? tok : h;
  const int c2 = tok_inner ? h : tok;
  tma_load_4d(dst, map, bar, 0, c1, c2, b);
  if (D == 80) tma_load_4d(dst + kMainBytes, tail, bar, 0, c1, c2, b);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  return pack_bf16(__uint_as_float(v << 16) * s, __uint_as_float(v & 0xffff0000u) * s);
}

__device__ __forceinline__ void scale_16_bytes(uint4* p, float s) {
  uint4 v = *p;
  v.x = scale_bf16x2(v.x, s);
  v.y = scale_bf16x2(v.y, s);
  v.z = scale_bf16x2(v.z, s);
  v.w = scale_bf16x2(v.w, s);
  *p = v;
}

// tok_inner: bit 0 q, bit 1 k, bit 2 v (the token coordinate precedes the
// head coordinate in that operand's maps). The tail maps are read at d = 80
// only.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    attention_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap tail_q,
                    const __grid_constant__ CUtensorMap tail_k,
                    const __grid_constant__ CUtensorMap tail_v, uint16_t* __restrict__ out,
                    Strides so, int B, int N, int H, int n_valid, int tok_inner,
                    float scale_log2, float q_scale) {
  constexpr int kTail = WgTile<D>::kTail;
  constexpr int kTileBytes = WgTile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;                       // [2] tiles
  uint8_t* sK = sQ + 2 * kTileBytes;        // [kKvStages] tiles
  uint8_t* sV = sK + kKvStages * kTileBytes;  // [kKvStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kKvStages * kTileBytes);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kKvStages;
  uint64_t* kv_empty = v_full + kKvStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int q_tiles = (N + kQRows - 1) / kQRows;
  const int kv_tiles = (n_valid + kKeys - 1) / kKeys;
  const int items = q_tiles * H * B;

  if (tid >= 2 * 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      int qs = 0, st = 0;
      uint32_t qph = 0, ph = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int qt = it % q_tiles;
        const int h = (it / q_tiles) % H;
        const int b = it / (q_tiles * H);
        mbar_wait(&q_empty[qs], qph ^ 1);
        mbar_expect_tx(&q_full[qs], kTileBytes);
        load_tile<D>(sQ + qs * kTileBytes, &map_q, &tail_q, &q_full[qs], qt * kQRows, h, b,
                     tok_inner & 1);
        if (++qs == 2) {
          qs = 0;
          qph ^= 1;
        }
        for (int j = 0; j < kv_tiles; ++j) {
          mbar_wait(&kv_empty[st], ph ^ 1);
          mbar_expect_tx(&k_full[st], kTileBytes);
          load_tile<D>(sK + st * kTileBytes, &map_k, &tail_k, &k_full[st], j * kKeys, h, b,
                       tok_inner & 2);
          mbar_expect_tx(&v_full[st], kTileBytes);
          load_tile<D>(sV + st * kTileBytes, &map_v, &tail_v, &v_full[st], j * kKeys, h, b,
                       tok_inner & 4);
          if (++st == kKvStages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    int qs = 0, st = 0;
    uint32_t qph = 0, ph = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int qt = it % q_tiles;
      const int h = (it / q_tiles) % H;
      const int b = it / (q_tiles * H);
      // this warpgroup's 64 rows: 8 KB of the main part, 2 KB of the tail
      uint8_t* q_rows = sQ + qs * kTileBytes + wg * (64 * 128);
      uint8_t* q_tail = sQ + qs * kTileBytes + kMainBytes + wg * (64 * 2 * kTail);
      mbar_wait(&q_full[qs], qph);
      if (q_scale != 1.f) {  // q <- bf16(f32(q) * q_scale), once per item
        uint4* p = reinterpret_cast<uint4*>(q_rows) + (tid & 127) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) scale_16_bytes(p + i, q_scale);
        if (kTail) scale_16_bytes(reinterpret_cast<uint4*>(q_tail) + (tid & 127), q_scale);
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }
      const uint64_t dq = smem_desc(smem_u32(q_rows), 16, 1024);
      const uint64_t dq_tail = smem_desc<3>(smem_u32(q_tail), 16, 256);

      float o[32];       // output columns 0-63
      float o_tail[8];   // output columns 64-79 (d = 80)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) o_tail[i] = 0.f;
      float m[2] = {neg_inf(), neg_inf()};  // running row max (rows g and g+8)
      float l[2] = {0.f, 0.f};              // this thread's share of the row sums

      for (int j = 0; j < kv_tiles; ++j) {
        // S = Q K^T: 64 rows x 128 keys, k16 steps over d
        mbar_wait(&k_full[st], ph);
        uint8_t* k_tile = sK + st * kTileBytes;
        const uint64_t dk = smem_desc(smem_u32(k_tile), 16, 1024);
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k16_ss<0>(s, dq + 2 * kk, dk + 2 * kk, kk);  // +32 bytes per step
        }
        if (kTail) {
          wgmma_m64n128k16_ss<0>(s, dq_tail, smem_desc<3>(smem_u32(k_tile + kMainBytes), 16, 256),
                                 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
        if (j == kv_tiles - 1 && lane == 0) mbar_arrive(&q_empty[qs]);  // Q read for the last time

        // scale to base 2, mask keys past n_valid, online softmax update
        const int k0 = j * kKeys;
        const bool ragged = k0 + kKeys > n_valid;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
          const float x = ragged && key >= n_valid ? neg_inf() : s[i] * scale_log2;
          s[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
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
        uint32_t pa[8][4];  // P in bf16 as the A fragments of eight k16 steps
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e;
            const int r = e & 1;
            const float p0 = exp2f(s[i] - m[r]);
            const float p1 = exp2f(s[i + 1] - m[r]);
            rs[r] += p0 + p1;
            pa[kk][e] = pack_bf16(p0, p1);
          }
        }
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        if (kTail) {
#pragma unroll
          for (int i = 0; i < 8; ++i) o_tail[i] *= alpha[(i >> 1) & 1];
        }

        // O += P V: eight k16 steps over the keys, V MN-major (transposed)
        mbar_wait(&v_full[st], ph);
        uint8_t* v_tile = sV + st * kTileBytes;
        const uint64_t dv = smem_desc(smem_u32(v_tile), 16, 1024);
        const uint64_t dv_tail = smem_desc<3>(smem_u32(v_tile + kMainBytes), 16, 256);
        fence_operands(o);
        if (kTail) fence_operands(o_tail);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_rs<1>(o, pa[kk], dv + 128 * kk, 1);  // +2048 bytes per step
          if (kTail) wgmma_m64n16k16_rs<1>(o_tail, pa[kk], dv_tail + 32 * kk, 1);  // +512
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
        if (kTail) fence_operands(o_tail);
        if (lane == 0) mbar_arrive(&kv_empty[st]);
        if (++st == kKvStages) {
          st = 0;
          ph ^= 1;
        }
      }

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      const long long ra = static_cast<long long>(qt) * kQRows + wg * 64 + warp * 16 + g;
      uint16_t* oa = out + b * so.b + h * so.h + ra * so.n + tq * 2;
      uint16_t* ob = oa + 8 * so.n;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        if (ra < N) {
          *reinterpret_cast<uint32_t*>(oa + dn * 8) =
              pack_bf16(o[4 * dn] * inv[0], o[4 * dn + 1] * inv[0]);
        }
        if (ra + 8 < N) {
          *reinterpret_cast<uint32_t*>(ob + dn * 8) =
              pack_bf16(o[4 * dn + 2] * inv[1], o[4 * dn + 3] * inv[1]);
        }
      }
#pragma unroll
      for (int dn = 0; dn < kTail / 8; ++dn) {
        if (ra < N) {
          *reinterpret_cast<uint32_t*>(oa + 64 + dn * 8) =
              pack_bf16(o_tail[4 * dn] * inv[0], o_tail[4 * dn + 1] * inv[0]);
        }
        if (ra + 8 < N) {
          *reinterpret_cast<uint32_t*>(ob + 64 + dn * 8) =
              pack_bf16(o_tail[4 * dn + 2] * inv[1], o_tail[4 * dn + 3] * inv[1]);
        }
      }
      if (++qs == 2) {
        qs = 0;
        qph ^= 1;
      }
    }
  }
}

template <int D>
void launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                 Strides sk, Strides sv, Strides so, int B, int N, int H, int n_valid,
                 float sl2, float q_scale, cudaStream_t stream) {
  const int smem = (kBM + 4 * kBN) * (D + 8) * static_cast<int>(sizeof(uint16_t));
  cudaFuncSetAttribute(attention_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N + kBM - 1) / kBM, H, B);
  attention_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), sq, sk, sv, so, N,
      n_valid, sl2, q_scale);
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* out, Strides sq,
                Strides sk, Strides sv, Strides so, int B, int N, int H, int n_valid,
                float sl2, float q_scale, cudaStream_t stream) {
  const dim3 grid((N + kF32Rows - 1) / kF32Rows, H, B);
  attention_f32<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, sv, so, N, n_valid,
      sl2, q_scale);
}

// The 4-D tensor maps of a (B, H, rows, D) bf16 operand given by element
// strides: dims (cols, token, head, batch), or (cols, head, token, batch)
// when the head stride is the smaller one (*tok_inner false), so that the
// strides grow outwards. A dimension of size 1 gets the stride it would
// have in a packed tensor. Box: 128 tokens of one head. `map` holds
// columns 0-63 (128-byte swizzle); at D = 80 `tail` holds columns 64-79
// (32-byte swizzle).
int encode_operand(CUtensorMap* map, CUtensorMap* tail, const void* base, Strides s, int B,
                   int H, int N, int D, int rows, bool* tok_inner) {
  const long long sn = N > 1 ? s.n : D;
  const long long sh = H > 1 ? s.h : sn * N;
  const long long sb = B > 1 ? s.b : (sn * N > sh * H ? sn * N : sh * H);
  *tok_inner = sn <= sh;
  uint64_t dims[4] = {64, static_cast<uint64_t>(*tok_inner ? rows : H),
                      static_cast<uint64_t>(*tok_inner ? H : rows), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(*tok_inner ? sn : sh) * 2,
                               static_cast<uint64_t>(*tok_inner ? sh : sn) * 2,
                               static_cast<uint64_t>(sb) * 2};
  uint32_t box[4] = {64, *tok_inner ? 128u : 1u, *tok_inner ? 1u : 128u, 1};
  int err = encode_tensor_map(map, base, 4, dims, strides, box);
  if (err != 0 || D == 64) {
    *tail = *map;  // unread at D = 64
    return err;
  }
  dims[0] = box[0] = D - 64;
  return encode_tensor_map(tail, static_cast<const uint16_t*>(base) + 64, 4, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, Strides sq,
                 Strides sk, Strides sv, Strides so, int B, int N, int H, int n_valid,
                 float sl2, float q_scale, cudaStream_t stream) {
  // fresh maps on every call: the caching allocator hands the same pointers
  // out again with other shapes
  CUtensorMap mq, mk, mv, tq, tk, tv;
  bool inner_q, inner_k, inner_v;
  int err = encode_operand(&mq, &tq, q, sq, B, H, N, D, N, &inner_q);
  if (err == 0) err = encode_operand(&mk, &tk, k, sk, B, H, N, D, n_valid, &inner_k);
  if (err == 0) err = encode_operand(&mv, &tv, v, sv, B, H, N, D, n_valid, &inner_v);
  if (err != 0) return err;
  const long long items = static_cast<long long>((N + kQRows - 1) / kQRows) * H * B;
  const int sms = sm_count();
  constexpr int smem = WgTile<D>::kSmem;
  cudaFuncSetAttribute(attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attention_wgmma<D><<<items < sms ? static_cast<int>(items) : sms, kWgThreads, smem, stream>>>(
      mq, mk, mv, tq, tk, tv, static_cast<uint16_t*>(out), so, B, N, H, n_valid,
      int(inner_q) | (int(inner_k) << 1) | (int(inner_v) << 2), sl2, q_scale);
  return static_cast<int>(cudaGetLastError());
}

// the routes' codes, as reported through route_ran
constexpr int kRouteWgmma = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteSimt = 2;

int route_of(int D, int is_bf16) {
  if (!is_bf16) return kRouteSimt;
  return D == 64 || D == 80 ? kRouteWgmma : kRouteMmaSync;
}

int launch(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
           Strides sv, Strides so, int B, int N, int H, int D, int n_valid,
           int scale_log2_bits, int q_scale_bits, int is_bf16, int* route_ran, void* stream) {
  float sl2, q_scale;
  memcpy(&sl2, &scale_log2_bits, sizeof(sl2));
  memcpy(&q_scale, &q_scale_bits, sizeof(q_scale));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int route = route_of(D, is_bf16);
  *route_ran = route;
  if (route == kRouteWgmma) {
    return D == 64
        ? launch_wgmma<64>(q, k, v, out, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, st)
        : launch_wgmma<80>(q, k, v, out, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, st);
  }
#define MVP_ATTN_CASE(DIM, LAUNCH)                                                      \
  case DIM:                                                                             \
    LAUNCH<DIM>(q, k, v, out, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, st); \
    break;
  if (route == kRouteMmaSync) {
    switch (D) {
      MVP_ATTN_CASE(16, launch_bf16)
      MVP_ATTN_CASE(32, launch_bf16)
      MVP_ATTN_CASE(128, launch_bf16)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (D) {
      MVP_ATTN_CASE(16, launch_f32)
      MVP_ATTN_CASE(32, launch_f32)
      MVP_ATTN_CASE(64, launch_f32)
      MVP_ATTN_CASE(80, launch_f32)
      MVP_ATTN_CASE(128, launch_f32)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef MVP_ATTN_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. qkv: contiguous (B, N, 3, H, D); out: contiguous (B, N, H*D), same
// dtype (is_bf16: 1 bfloat16, 0 float32). scale_log2_bits: the float
// softmax scale * log2(e), passed as its 32-bit pattern. *route_ran: the
// route taken (0 wgmma, 1 mma_sync, 2 simt), set before the launch.
extern "C" int mvp_fused_qkv_attention(const void* qkv, void* out, int B, int N, int H,
                                       int D, int n_valid, int scale_log2_bits, int is_bf16,
                                       int* route_ran, void* stream) {
  const long long hd = static_cast<long long>(H) * D;
  const Strides in{N * 3 * hd, D, 3 * hd};
  const Strides so{N * hd, D, hd};
  const size_t esize = is_bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const float one = 1.f;
  int one_bits;
  memcpy(&one_bits, &one, sizeof(one_bits));
  return launch(base, base + hd * esize, base + 2 * hd * esize, out, in, in, in, so, B, N,
                H, D, n_valid, scale_log2_bits, one_bits, is_bf16, route_ran, stream);
}

// K2. q, k, v, out: (B, H, N, D) by element strides (batch, head, token),
// last dimension contiguous, every row 16-byte aligned; same dtype. Keys and
// values at index >= n_valid (1 <= n_valid <= N) are excluded: K2 and K3
// pass N; the bench's splash route (K9) passes its count of valid keys.
// q_scale_bits: the float q_scale (q is taken as q * q_scale, rounded to
// q's dtype, before the scores; 1 for K2 and K3, the softmax scale for K9).
// is_bf16 and route_ran as for K1.
extern "C" int mvp_vit_attention(const void* q, const void* k, const void* v, void* out,
                                 int B, int N, int H, int D, int n_valid,
                                 long long q_sb, long long q_sh, long long q_sn,
                                 long long k_sb, long long k_sh,
                                 long long k_sn, long long v_sb, long long v_sh,
                                 long long v_sn, long long o_sb, long long o_sh,
                                 long long o_sn, int scale_log2_bits, int q_scale_bits,
                                 int is_bf16, int* route_ran, void* stream) {
  return launch(q, k, v, out, Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn},
                Strides{v_sb, v_sh, v_sn}, Strides{o_sb, o_sh, o_sn}, B, N, H, D, n_valid,
                scale_log2_bits, q_scale_bits, is_bf16, route_ran, stream);
}
