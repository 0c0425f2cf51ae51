// Softmax attention backward for Hopper (sm_90a): dQ, dK and dV of the
// attention that csrc/vit_attention.cu's strided entry (mvp_vit_attention)
// computes, from its residual, the per-row logsumexp.
//
// Replaces the backward kernels of the two jax library kernels the JAX
// package reaches:
//   * K10, the backward of K3 (ops/attention.py `_flash_attention`, the jax
//     library's TPU flash kernel): its `_flash_attention_dkv_kernel` and
//     `_flash_attention_dq_kernel` (jax/experimental/pallas/ops/tpu/
//     flash_attention.py, pallas_call at :1121 and :1456), which `jax.grad`
//     runs through the library's custom_vjp;
//   * K11, the backward of K9 (launch_script/bench_attn.py
//     `splash_attention`, the splash library kernel): its
//     `_splash_attention_bwd_dkv` and `_splash_attention_bwd_dq`. It is
//     K10's kernels with n_valid < N (the splash mask keeps the keys below
//     n_valid) on q' = bf16(q * q_scale), which the caller rounds.
//
// What it computes, for operands (B, H, N, d) given by element strides with
// the last dimension contiguous: with S = q' k^T (keys < n_valid), P =
// exp(S * scale - lse) (lse: the forward's natural logsumexp per row, f32
// (B, H, N) contiguous) and di = rowsum(dO * O) (f32 (B, H, N), computed by
// the caller, as the library computes it in XLA outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di) * scale,
//   dK = dS^T q', dQ' = dS K.
// Keys and values at index >= n_valid are never read; their dK and dV rows
// are written as 0. Query rows >= N do not exist; rows in [n_valid, N) are
// queries like any other.
//
// Two kernels, as in the library (blocks of the card run in no order, so a
// sum over queries and one over keys cannot share a block without atomics):
//   * attention_dkv: one block per (key tile of 64, head, batch); each of its
//     four warps owns 16 keys and loops over the query tiles: S^T = K Q^T,
//     P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//   * attention_dq: one block per (query tile of 64, head, batch); each warp
//     owns 16 queries and loops over the key tiles: S = Q K^T, P, dP = dO
//     V^T, dS, dQ += dS K.
// Every product is a warp-level mma.sync over tiles in shared memory (the
// tiles are copied in with 16-byte loads, one block barrier before and
// after each): P and dS go through a per-warp staging tile in shared memory
// to become the A operand of the next product.
//
// Routes (by dtype, as the forward's):
//   * bf16: mma.sync m16n8k16 with f32 accumulation; P is rounded to bf16
//     before the dV product (as the forward rounds it before PV), dS to bf16
//     before the dK and dQ products; S, P and dP stay f32.
//   * f32: 3xTF32 on mma.sync m16n8k8 (the forward's tf32x3 split, split on
//     the fly here), every 16-deep product from a zero accumulator and added
//     in f32, so the result keeps f32 accuracy.
// Head dims 16, 32, 64, 80 and 128 (K3 meets 80 in RADIO-v2, K9 64).
//
// What bounds it on an H100: the five products are 10 * B*H*N*n_valid*d
// FLOP against ~8 * B*H*N*d elements of traffic, far above the ridge at the
// probing shapes: tensor-core operations (and this design recomputes S and
// dP in both kernels, 14 in all). This first design is simple: scalar
// shared-memory fragment loads, no cp.async ring, no wgmma; a faster one is
// later work.
//
// Plain C interface for ctypes: pointers, ints and 64-bit strides; the
// softmax scale arrives as the bit pattern of a float. Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_sync.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // the rows a block owns: keys (dkv) or queries (dq)

// the operand type's layout constants: padded rows (in elements) of the
// d-wide tiles and of the staging tile
template <typename T>
struct Elem;
template <>
struct Elem<uint16_t> {  // bf16
  static constexpr int kPad = 8;
};
template <>
struct Elem<float> {
  static constexpr int kPad = 4;
};

// the inner loop's tile (queries in dkv, keys in dq): 32 at d = 128 keeps the
// f32 accumulators of two d-wide products and two score tiles in registers
template <int D>
struct Inner {
  static constexpr int kTile = D > 80 ? 32 : 64;
};

template <typename T, int D>
struct Smem {
  static constexpr int kLd = D + Elem<T>::kPad;                     // d-wide rows
  static constexpr int kLdS = Inner<D>::kTile + Elem<T>::kPad;     // staging rows
  static constexpr int kElems = 2 * kRows * kLd + 2 * Inner<D>::kTile * kLd +
                                kWarps * 16 * kLdS;
  static constexpr int kBytes = kElems * static_cast<int>(sizeof(T)) +
                                2 * Inner<D>::kTile * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  const __nv_bfloat16 r = __float2bfloat16_rn(x);
  *p = *reinterpret_cast<const uint16_t*>(&r);
}
// two neighbouring elements of one row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// rows [row0, row0 + rows) of a (.., N, D) operand (row stride `sn`) into a
// shared tile with rows of `ld`; rows at or past `limit` are zeros and never
// read
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long sn, int row0,
                                          int rows, int limit) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  constexpr int CH = D / V;
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) x = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + c * V);
    *reinterpret_cast<uint4*>(dst + r * ld + c * V) = x;
  }
}

// C (16 x 8*NT) += A (16 x K) B (K x 8*NT) for one warp, every operand in
// shared memory. A: rows of `lda`. B: kKMajor, B(k, n) = b[k * ldb + n] (a
// row-major (K, n) tile: dO, Q, K as the right factor); else B(k, n) =
// b[n * ldb + k] (a row-major (n, K) tile read transposed: Q, K, dO, V as
// the right factor of a product with their transpose).
template <int NT, int K, bool kKMajor>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const uint16_t* a, int lda,
                                         const uint16_t* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kb = 0; kb < K; kb += 16) {
    uint32_t af[4];
    af[0] = ld_u32(a + g * lda + kb + 2 * tq);
    af[1] = ld_u32(a + (g + 8) * lda + kb + 2 * tq);
    af[2] = ld_u32(a + g * lda + kb + 2 * tq + 8);
    af[3] = ld_u32(a + (g + 8) * lda + kb + 2 * tq + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      uint32_t b0, b1;
      if (kKMajor) {
        const uint16_t* p = b + (kb + 2 * tq) * ldb + n;
        b0 = pack_u16(p[0], p[ldb]);
        b1 = pack_u16(p[8 * ldb], p[9 * ldb]);
      } else {
        const uint16_t* p = b + n * ldb + kb + 2 * tq;
        b0 = ld_u32(p);
        b1 = ld_u32(p + 8);
      }
      mma_16816(c[nt], af, b0, b1);
    }
  }
}

// the same in 3xTF32: each 16-deep step (two k8 products) from a zero
// accumulator, added to C in f32
template <int NT, int K, bool kKMajor>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* a, int lda,
                                         const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kb = 0; kb < K; kb += 16) {
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = kb + 8 * s + tq;
      split_tf32(a[g * lda + k], a_hi[s][0], a_lo[s][0]);
      split_tf32(a[(g + 8) * lda + k], a_hi[s][1], a_lo[s][1]);
      split_tf32(a[g * lda + k + 4], a_hi[s][2], a_lo[s][2]);
      split_tf32(a[(g + 8) * lda + k + 4], a_hi[s][3], a_lo[s][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      float x[2][2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k = kb + 8 * s + tq;
        x[s][0] = kKMajor ? b[k * ldb + n] : b[n * ldb + k];
        x[s][1] = kKMajor ? b[(k + 4) * ldb + n] : b[n * ldb + k + 4];
      }
      float t[4];
      mma_3xtf32<true>(t, a_hi[0], a_lo[0], split_pair(x[0][0]), split_pair(x[0][1]));
      mma_3xtf32<false>(t, a_hi[1], a_lo[1], split_pair(x[1][0]), split_pair(x[1][1]));
      add_f32<false>(c[nt], t);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  }
}

// a warp's 16-row accumulator (C layout) into rows of a strided operand:
// row r0 + g and r0 + g + 8 while below `limit`, and zeros for the rows in
// [zero_from, N)
template <typename T, int NT>
__device__ __forceinline__ void write_rows(T* dst, long long sn, const float (&c)[NT][4],
                                           int r0, int N, int zero_from) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= N) continue;
    const bool keep = row < zero_from;
    T* p = dst + row * sn + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      store2(p + nt * 8, keep ? c[nt][2 * half] : 0.f, keep ? c[nt][2 * half + 1] : 0.f);
    }
  }
}

// K10/K11, dK and dV. Shared memory: K and V of the block's 64 keys, Q and
// dO of one query tile, lse2 and di of its queries, one 16-row staging tile
// per warp.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                  Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                  int H, int N, int n_valid, float scale, float scale_log2) {
  constexpr int LD = Smem<T, D>::kLd;
  constexpr int LDS = Smem<T, D>::kLdS;
  constexpr int BQ = Inner<D>::kTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;
  T* sO = sQ + BQ * LD;  // dO
  T* sP = sO + BQ * LD;
  float* sL = reinterpret_cast<float*>(sP + kWarps * 16 * LDS);  // lse2 of the tile's queries
  float* sD = sL + BQ;                                            // di

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* ob = dout + b * sdo.b + h * sdo.h;
  T* sPw = sP + warp * 16 * LDS;

  float acc_k[D / 8][4], acc_v[D / 8][4];
  zero(acc_k);
  zero(acc_v);
  if (k0 < n_valid) {  // a tile wholly past n_valid only writes zeros
    load_rows<T, D>(sK, LD, k + b * sk.b + h * sk.h, sk.n, k0, kRows, n_valid);
    load_rows<T, D>(sV, LD, v + b * sv.b + h * sv.h, sv.n, k0, kRows, n_valid);
    for (int q0 = 0; q0 < N; q0 += BQ) {
      __syncthreads();  // the previous tile's Q and dO are read
      load_rows<T, D>(sQ, LD, qb, sq.n, q0, BQ, N);
      load_rows<T, D>(sO, LD, ob, sdo.n, q0, BQ, N);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < N;
        sL[i] = in ? lse[bh * N + q0 + i] * 1.4426950408889634f : 0.f;
        sD[i] = in ? di[bh * N + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T: this warp's 16 keys x BQ queries; P^T in place
      float s[BQ / 8][4];
      zero(s);
      warp_mma<BQ / 8, D, false>(s, sK + warp * 16 * LD, LD, sQ, LD);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * tq + (e & 1);
          s[nt][e] = q0 + col < N ? exp2f(s[nt][e] * scale_log2 - sL[col]) : 0.f;
        }
      }
      // dP^T = V dO^T
      float dp[BQ / 8][4];
      zero(dp);
      warp_mma<BQ / 8, D, false>(dp, sV + warp * 16 * LD, LD, sO, LD);
      // dV += P^T dO, P^T staged (rounded to T)
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          store(sPw + (g + 8 * (e >> 1)) * LDS + nt * 8 + 2 * tq + (e & 1), s[nt][e]);
        }
      }
      __syncwarp();
      warp_mma<D / 8, BQ, true>(acc_v, sPw, LDS, sO, LD);
      __syncwarp();  // the staging tile is read
      // dS^T = P^T * (dP^T - di) * scale, staged; dK += dS^T Q
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * tq + (e & 1);
          store(sPw + (g + 8 * (e >> 1)) * LDS + col,
                s[nt][e] * (dp[nt][e] - sD[col]) * scale);
        }
      }
      __syncwarp();
      warp_mma<D / 8, BQ, true>(acc_k, sPw, LDS, sQ, LD);
    }
  }
  const int r0 = k0 + warp * 16;
  write_rows<T, D / 8>(dk + b * sdk.b + h * sdk.h, sdk.n, acc_k, r0, N, n_valid);
  write_rows<T, D / 8>(dv + b * sdv.b + h * sdv.h, sdv.n, acc_v, r0, N, n_valid);
}

// K10/K11, dQ'. Shared memory: Q and dO of the block's 64 queries, K and V
// of one key tile, one 16-row staging tile per warp (lse2 and di of a
// thread's two rows stay in registers).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, T* __restrict__ dq, Strides sq, Strides sk,
                 Strides sv, Strides sdo, Strides sdq, int H, int N, int n_valid, float scale,
                 float scale_log2) {
  constexpr int LD = Smem<T, D>::kLd;
  constexpr int LDS = Smem<T, D>::kLdS;
  constexpr int BK = Inner<D>::kTile;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + kRows * LD;  // dO
  T* sK = sO + kRows * LD;
  T* sV = sK + BK * LD;
  T* sP = sV + BK * LD;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* sPw = sP + warp * 16 * LDS;

  load_rows<T, D>(sQ, LD, q + b * sq.b + h * sq.h, sq.n, q0, kRows, N);
  load_rows<T, D>(sO, LD, dout + b * sdo.b + h * sdo.h, sdo.n, q0, kRows, N);
  const int r0 = q0 + warp * 16;
  float l2[2], dd[2];  // lse2 and di of rows r0 + g and r0 + g + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    l2[half] = row < N ? lse[bh * N + row] * 1.4426950408889634f : 0.f;
    dd[half] = row < N ? di[bh * N + row] : 0.f;
  }

  float acc[D / 8][4];
  zero(acc);
  for (int k0 = 0; k0 < n_valid; k0 += BK) {
    __syncthreads();  // the previous tile's K and V are read (and Q, dO landed)
    load_rows<T, D>(sK, LD, kb, sk.n, k0, BK, n_valid);
    load_rows<T, D>(sV, LD, vb, sv.n, k0, BK, n_valid);
    __syncthreads();

    // S = Q K^T: this warp's 16 queries x BK keys; P in place, 0 past n_valid
    float s[BK / 8][4];
    zero(s);
    warp_mma<BK / 8, D, false>(s, sQ + warp * 16 * LD, LD, sK, LD);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tq + (e & 1);
        s[nt][e] = key < n_valid ? exp2f(s[nt][e] * scale_log2 - l2[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T
    float dp[BK / 8][4];
    zero(dp);
    warp_mma<BK / 8, D, false>(dp, sO + warp * 16 * LD, LD, sV, LD);
    // dS = P * (dP - di) * scale, staged (rounded to T); dQ' += dS K
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store(sPw + (g + 8 * (e >> 1)) * LDS + nt * 8 + 2 * tq + (e & 1),
              s[nt][e] * (dp[nt][e] - dd[e >> 1]) * scale);
      }
    }
    __syncwarp();
    warp_mma<D / 8, BK, true>(acc, sPw, LDS, sK, LD);
    __syncwarp();  // the staging tile is read before the next tile writes it
  }
  write_rows<T, D / 8>(dq + b * sdq.b + h * sdq.h, sdq.n, acc, r0, N, N);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* di, void* dq, void* dk, void* dv, const Strides* s, int B, int H, int N,
           int n_valid, float scale, cudaStream_t stream) {
  constexpr int smem = Smem<T, D>::kBytes;
  const float sl2 = scale * 1.4426950408889634f;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  cudaFuncSetAttribute(attention_dkv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attention_dkv<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv), s[0],
      s[1], s[2], s[3], s[5], s[6], H, N, n_valid, scale, sl2);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  cudaFuncSetAttribute(attention_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attention_dq<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), s[0], s[1], s[2], s[3], s[4],
      H, N, n_valid, scale, sl2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10 and K11. q (q' = bf16(q * q_scale) for K11, rounded by the caller), k,
// v, dout, and the outputs dq (dQ'), dk, dv: (B, H, N, D) by element strides
// (strides[7][3]: batch, head, token for q, k, v, dout, dq, dk, dv), last
// dimension contiguous, rows 16-byte aligned, one dtype (is_bf16: 1
// bfloat16, 0 float32). lse, di: contiguous (B, H, N) f32, the forward's
// natural logsumexp per row and rowsum(dO * O). Keys >= n_valid (1 <= n_valid
// <= N) are never read and get dk = dv = 0. scale_bits: the float softmax
// scale as its 32-bit pattern. D in {16, 32, 64, 80, 128}.
extern "C" int mvp_attention_backward(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* di,
                                      void* dq, void* dk, void* dv, const long long* strides,
                                      int B, int N, int H, int D, int n_valid, int scale_bits,
                                      int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float scale;
  memcpy(&scale, &scale_bits, sizeof(scale));
  Strides s[7];
  for (int i = 0; i < 7; ++i) {
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
#define MVP_BWD_CASE(T, DIM) \
  case DIM:                  \
    return launch<T, DIM>(q, k, v, dout, l, d, dq, dk, dv, s, B, H, N, n_valid, scale, st);
  if (is_bf16) {
    switch (D) {
      MVP_BWD_CASE(uint16_t, 16)
      MVP_BWD_CASE(uint16_t, 32)
      MVP_BWD_CASE(uint16_t, 64)
      MVP_BWD_CASE(uint16_t, 80)
      MVP_BWD_CASE(uint16_t, 128)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    MVP_BWD_CASE(float, 16)
    MVP_BWD_CASE(float, 32)
    MVP_BWD_CASE(float, 64)
    MVP_BWD_CASE(float, 80)
    MVP_BWD_CASE(float, 128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVP_BWD_CASE
}
