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
//     K10 with n_valid < N (the splash mask keeps the keys below n_valid) on
//     q' = bf16(q * q_scale), which the caller rounds.
//
// What it computes, for operands (B, H, N, d) given by element strides with
// the last dimension contiguous: with S = q' k^T (keys < n_valid), P =
// exp(S * scale - lse) (lse: the forward's natural logsumexp per row) and
// di = rowsum(dO * O) (computed by the caller, as the library computes it
// in XLA outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di) * scale,
//   dK = dS^T q', dQ' = dS K.
// Keys and values at index >= n_valid are never read; their dK and dV rows
// are written as 0. Query rows >= N do not exist; rows in [n_valid, N) are
// queries like any other. Rounding (bf16): P is rounded to bf16 before the
// dV product (as the forward rounds it before PV), dS before the dK and dQ
// products; S, P and dP stay f32.
//
// What bounds it on an H100: the five products, 10 * B*H*N*n_valid*d FLOP,
// against ~8 * B*H*N*d elements of traffic: far above the ridge at the
// probing shapes, so tensor-core operations (K10 bf16, B=2, H=12, N=8192,
// d=64: 1.04 ms at 989 TFLOP/s; f32 on tf32x3 at a third of 495).
//
// The design, one pass on every route: a block owns a tile of keys of one
// (batch, head) and walks every query tile. Per query tile it forms
// S^T = K Q^T, P^T, dP^T = V dO^T, dV += P^T dO, dS^T and dK += dS^T Q with
// its keys' dK and dV in registers, and dQ's share of its keys, dS K, which
// it adds into an f32 accumulator in device memory with vector atomics
// (blocks run in no order, and each adds to every query row). Nothing is
// computed twice (the earlier design's two kernels each formed S and dP:
// 14 units of B*H*N*n_valid*d FLOP against these 10). A finishing pass rounds
// the accumulator to dq's dtype and applies q_scale. dQ is therefore not
// bit-reproducible from run to run (the atomics add in varying order); dK
// and dV are.
//
// Routes (by dtype and head dim, as the forward's; reported through
// route_ran; ops/vit_attention.py `backward_route` mirrors the choice):
//   * 0, wgmma: bf16 at d in {64, 80} (K10 at K3's bf16 launch, K11). Blocks
//     of 128 keys: two consumer warpgroups of 64 keys and a producer
//     warpgroup, one thread of which loads the block's K and V once by TMA
//     and keeps a ring of query tiles in flight (Q, dO by TMA, their lse and
//     di by bulk copies, each stage behind a full and an empty mbarrier).
//     S^T and dP^T are wgmma m64n64k16 with both operands in shared memory
//     (K-major); P^T and dS^T leave the accumulators as bf16 register A
//     fragments for dV and dK (`rs`, dO and Q read MN-major with the
//     transpose bit). dS^T is also stored to a swizzled shared tile that
//     the dQ product reads as an MN-major A; one warpgroup a query tile (in
//     turn) takes dQ over all 128 keys, so the atomics add once per 128 keys.
//     d = 80 splits each row into 64 columns (128-byte swizzle) and 16
//     (32-byte swizzle), as the forward does.
//   * 1, mma_sync: bf16 at d in {16, 32, 128}; 2, tf32x3: f32 at every head
//     dim. Blocks of 64 keys: four warps of 16 keys (eight at f32 up to
//     d = 80, two a 16 keys, each taking half of a query tile, so that two
//     warps an SM sub-partition hide the dependent products' latency), every
//     thread copying its share of the next query tiles into a two-stage
//     cp.async ring behind mbarriers. bf16 fragments come from padded rows
//     through ldmatrix (plain or transposed). f32 runs 3xTF32 on mma.sync
//     m16n8k8 (each product as lo*hi + hi*lo + hi*hi, every 16-deep step
//     from a zero accumulator and added in f32, as the forward's tf32x3
//     route): a pre-pass splits q, k, v and dO once into (hi, lo) pairs,
//     which the kernel reads with 64-bit loads from rows whose columns are
//     XOR-swizzled so that both the row-wise and the column-wise fragment
//     loads are free of bank conflicts; only P and dS, which live in
//     registers, are split in the kernel. dS^T goes through a shared tile
//     to become the A operand of dQ, which the warps share out.
//
// Plain C interface for ctypes: pointers, ints and 64-bit strides; the
// softmax scale and q_scale arrive as the bit patterns of floats. Returns
// cudaGetLastError() after the launches (or the tensor maps' error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPadRows = 64;  // lse and di rows are padded to a multiple of this

// ------------------------------------------------------------------ common

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// two neighbouring columns of one query row into dQ's f32 accumulator
__device__ __forceinline__ void add_dq(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// rows [row0, row0 + rows) of a (B, H, N, D) output, all past n_valid: zeros
template <typename T>
__device__ void zero_rows(T* dst, Strides s, int row0, int rows, int N, int D) {
  for (int i = threadIdx.x; i < rows * D / 2; i += blockDim.x) {
    const int r = row0 + i / (D / 2);
    if (r < N) store2(dst + r * s.n + 2 * (i % (D / 2)), 0.f, 0.f);
  }
}

// P^T and dS^T of one score (key `key`, query q): P is 0 past N or n_valid
struct Softmax {
  float scale, scale_log2;
  int N, n_valid;
  __device__ __forceinline__ float p(float s, float lse, int q, int key) const {
    return q < N && key < n_valid ? exp2f(s * scale_log2 - lse * kLog2e) : 0.f;
  }
  __device__ __forceinline__ float ds(float p, float dp, float di) const {
    return p * (dp - di) * scale;
  }
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const uint16_t* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// The prologue, one warp a query row (b, h, n) of `rows` = B*H*N: the row's
// lse and di = rowsum(dO * O) (f32) into stats (2, B*H, n_pad), whose
// padding the caller zeroed; with q_scale != 1 also q' = round(q * q_scale)
// into qs, contiguous (B, H, N, D).
template <typename T>
__global__ void prep_rows(const T* __restrict__ q, const T* __restrict__ out,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          T* __restrict__ qs, float* __restrict__ stats, Strides sq, Strides so,
                          Strides sdo, int H, int N, int D, int n_pad, float q_scale,
                          long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x / 32;
  for (long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) / 32;
       row < rows; row += warps) {
    const int n = static_cast<int>(row % N);
    const long long bh = row / N;
    const int h = static_cast<int>(bh % H);
    const long long b = bh / H;
    const T* o = out + b * so.b + h * so.h + n * so.n;
    const T* g = dout + b * sdo.b + h * sdo.h + n * sdo.n;
    float acc = 0.f;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 x = load2(o + c), y = load2(g + c);
      acc += x.x * y.x + x.y * y.y;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) {
      stats[bh * n_pad + n] = lse[row];
      stats[(rows / N + bh) * n_pad + n] = acc;
    }
    if (qs != nullptr) {
      const T* x = q + b * sq.b + h * sq.h + n * sq.n;
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 v = load2(x + c);
        store2(qs + row * D + c, v.x * q_scale, v.y * q_scale);
      }
    }
  }
}

// The finishing pass: dq = round(round(acc) * q_scale) in T (once rounded
// when q_scale is 1), acc the contiguous (B, H, N, D) f32 accumulator, dq by
// element strides; four columns a step.
template <typename T>
__global__ void finish_dq(const float4* __restrict__ acc, T* __restrict__ dq, Strides s, int H,
                          int N, int D, float q_scale, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(4 * i % D);
    long long r = 4 * i / D;
    const int n = static_cast<int>(r % N);
    r /= N;
    const int h = static_cast<int>(r % H);
    const long long b = r / H;
    const float4 v = acc[i];
    float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (sizeof(T) == 2) x[e] = __bfloat162float(__float2bfloat16_rn(x[e]));
      if (q_scale != 1.f) x[e] *= q_scale;
    }
    T* p = dq + b * s.b + h * s.h + n * s.n + c;
    store2(p, x[0], x[1]);
    store2(p + 2, x[2], x[3]);
  }
}

// ------------------------------------------------------------ wgmma route

constexpr int kWgThreads = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int kWgKeys = 128;     // keys per block, 64 per consumer warpgroup
constexpr int kWgQ = 64;         // queries per tile
constexpr int kWgStages = 3;     // query-tile ring depth

template <int D>
struct WgTile {
  static constexpr int kTail = D - 64;             // columns past 64: 0 or 16
  static constexpr int kKMain = kWgKeys * 128;     // 64 columns of 128 keys (16 KB)
  static constexpr int kKV = kKMain + kWgKeys * 2 * kTail;  // one K or V tile
  static constexpr int kQMain = kWgQ * 128;        // 64 columns of 64 queries (8 KB)
  static constexpr int kQ = kQMain + kWgQ * 2 * kTail;      // one Q or dO tile
  // a stage: Q, dO, then the lse and di of its queries, 1 KB aligned
  static constexpr int kStage = (2 * kQ + 2 * kWgQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kDs = kWgKeys * kWgQ * 2;   // one dS^T tile (keys x queries, bf16)
  static constexpr int kSmem = 2 * kKV + kWgStages * kStage + 2 * kDs +
                               (1 + 2 * kWgStages) * 8 + 1024;
};

// one tile of `box` rows: the 64-column part at dst, at d = 80 the 16-column
// tail `main_bytes` after it
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, int main_bytes, const CUtensorMap* map,
                                          const CUtensorMap* tail, uint64_t* bar, int tok,
                                          int h, int b, bool tok_inner) {
  const int c1 = tok_inner ? tok : h;
  const int c2 = tok_inner ? h : tok;
  tma_load_4d(dst, map, bar, 0, c1, c2, b);
  if (D == 80) tma_load_4d(dst + main_bytes, tail, bar, 0, c1, c2, b);
}

// tok_inner: bit 0 q, 1 k, 2 v, 3 dO (the token coordinate precedes the head
// coordinate in that operand's maps). stats: (2, B*H, n_pad) f32, the lse
// and di of every query, padded with zeros. dq_acc: (B, H, N, D) f32, zeroed
// by the caller.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    attention_bwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap tail_q,
                        const __grid_constant__ CUtensorMap tail_k,
                        const __grid_constant__ CUtensorMap tail_v,
                        const __grid_constant__ CUtensorMap tail_o,
                        const float* __restrict__ stats, float* __restrict__ dq_acc,
                        uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, Strides sdk,
                        Strides sdv, int N, int n_valid, int n_pad, int tok_inner, Softmax sm) {
  using T = WgTile<D>;
  constexpr int kTail = T::kTail;
  const int k0 = blockIdx.x * kWgKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const long long bh = static_cast<long long>(b) * H + h;
  uint16_t* dkb = dk + b * sdk.b + h * sdk.h;
  uint16_t* dvb = dv + b * sdv.b + h * sdv.h;
  if (k0 >= n_valid) {  // a tile wholly past n_valid only writes zeros
    zero_rows(dkb, sdk, k0, kWgKeys, N, D);
    zero_rows(dvb, sdv, k0, kWgKeys, N, D);
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = sK + T::kKV;
  uint8_t* sStage = sV + T::kKV;
  uint8_t* sDs = sStage + kWgStages * T::kStage;  // [2] dS^T tiles
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDs + 2 * T::kDs);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + kWgStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int q_tiles = (N + kWgQ - 1) / kWgQ;

  if (tid >= 2 * 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      mbar_expect_tx(kv_full, 2 * T::kKV);
      load_rows<D>(sK, T::kKMain, &map_k, &tail_k, kv_full, k0, h, b, tok_inner & 2);
      load_rows<D>(sV, T::kKMain, &map_v, &tail_v, kv_full, k0, h, b, tok_inner & 4);
      const float* lse = stats + bh * n_pad;
      const float* di = stats + (static_cast<long long>(gridDim.z) * H + bh) * n_pad;
      int st = 0;
      uint32_t ph = 0;
      for (int j = 0; j < q_tiles; ++j) {
        const int q0 = j * kWgQ;
        uint8_t* s = sStage + st * T::kStage;
        mbar_wait(&q_empty[st], ph ^ 1);
        mbar_expect_tx(&q_full[st], 2 * T::kQ + 2 * kWgQ * 4);
        load_rows<D>(s, T::kQMain, &map_q, &tail_q, &q_full[st], q0, h, b, tok_inner & 1);
        load_rows<D>(s + T::kQ, T::kQMain, &map_o, &tail_o, &q_full[st], q0, h, b,
                     tok_inner & 8);
        bulk_load(s + 2 * T::kQ, lse + q0, kWgQ * 4, &q_full[st]);
        bulk_load(s + 2 * T::kQ + kWgQ * 4, di + q0, kWgQ * 4, &q_full[st]);
        if (++st == kWgStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroups: warpgroup wg owns keys k0 + 64 wg + [0, 64); this
  // thread's accumulator rows are keys key0 and key0 + 8, its columns
  // 8 jj + 2 tq (+ 1)
  setmaxnreg_inc<232>();
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int key0 = k0 + 64 * wg + 16 * warp + g;
  // K and V rows of this warpgroup (K-major A of S^T, dP^T), the whole K
  // tile (MN-major B of dQ)
  const uint64_t a_k = smem_desc(smem_u32(sK + wg * 64 * 128), 16, 1024);
  const uint64_t a_v = smem_desc(smem_u32(sV + wg * 64 * 128), 16, 1024);
  const uint64_t a_k_tail = smem_desc<3>(smem_u32(sK + T::kKMain + wg * 64 * 32), 16, 256);
  const uint64_t a_v_tail = smem_desc<3>(smem_u32(sV + T::kKMain + wg * 64 * 32), 16, 256);
  const uint64_t b_k = smem_desc(smem_u32(sK), 16, 1024);
  const uint64_t b_k_tail = smem_desc<3>(smem_u32(sK + T::kKMain), 16, 256);

  float acc_dk[32], acc_dv[32], tail_dk[8], tail_dv[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tail_dk[i] = tail_dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < q_tiles; ++j) {
    const int q0 = j * kWgQ;
    uint8_t* s = sStage + st * T::kStage;
    const float* s_lse = reinterpret_cast<const float*>(s + 2 * T::kQ);
    const float* s_di = s_lse + kWgQ;
    // Q and dO: K-major B of S^T and dP^T, MN-major B of dK and dV
    const uint64_t b_q = smem_desc(smem_u32(s), 16, 1024);
    const uint64_t b_o = smem_desc(smem_u32(s + T::kQ), 16, 1024);
    const uint64_t b_q_tail = smem_desc<3>(smem_u32(s + T::kQMain), 16, 256);
    const uint64_t b_o_tail = smem_desc<3>(smem_u32(s + T::kQ + T::kQMain), 16, 256);
    mbar_wait(&q_full[st], ph);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, k16 steps over d
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_ss<0, 0>(sc, a_k + 2 * kk, b_q + 2 * kk, kk);  // +32 bytes per step
    }
    if (kTail) wgmma_m64n64k16_ss<0, 0>(sc, a_k_tail, b_q_tail, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(dp, a_v + 2 * kk, b_o + 2 * kk, kk);
    if (kTail) wgmma_m64n64k16_ss<0, 0>(dp, a_v_tail, b_o_tail, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // P^T and dS^T as bf16 A fragments (accumulator element 4 jj + 2 r + t:
    // key key0 + 8 r, query 8 jj + 2 tq + t; A fragment jj / 2, 2 (jj & 1) + r)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int q = q0 + 8 * jj + 2 * tq;
      const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * jj + 2 * tq);
      const float2 d = *reinterpret_cast<const float2*>(s_di + 8 * jj + 2 * tq);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * jj + 2 * r;
        const float p0 = sm.p(sc[i], l.x, q, key0 + 8 * r);
        const float p1 = sm.p(sc[i + 1], l.y, q + 1, key0 + 8 * r);
        pa[jj >> 1][2 * (jj & 1) + r] = pack_bf16(p0, p1);
        da[jj >> 1][2 * (jj & 1) + r] =
            pack_bf16(sm.ds(p0, dp[i], d.x), sm.ds(p1, dp[i + 1], d.y));
      }
    }

    // dS^T into this tile's shared tile for dQ (rows of 64 queries, 128-byte
    // swizzle: chunk jj of row r at chunk jj ^ (r & 7))
    uint8_t* ds_tile = sDs + (j & 1) * T::kDs;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * wg + 16 * warp + g + 8 * r;
        *reinterpret_cast<uint32_t*>(ds_tile + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * tq) =
            da[jj >> 1][2 * (jj & 1) + r];
      }
    }
    fence_proxy_async();

    // dV += P^T dO and dK += dS^T Q: four k16 steps over the queries
    fence_operands(acc_dk);
    fence_operands(acc_dv);
    if (kTail) {
      fence_operands(tail_dk);
      fence_operands(tail_dv);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16_rs<1>(acc_dv, pa[kk], b_o + 128 * kk, 1);  // +2048 bytes per step
      if (kTail) wgmma_m64n16k16_rs<1>(tail_dv, pa[kk], b_o_tail + 32 * kk, 1);  // +512
      wgmma_m64n64k16_rs<1>(acc_dk, da[kk], b_q + 128 * kk, 1);
      if (kTail) wgmma_m64n16k16_rs<1>(tail_dk, da[kk], b_q_tail + 32 * kk, 1);
    }
    wgmma_commit();

    // dQ += dS K over the block's 128 keys, by warpgroup j & 1 in turn
    // (named barrier 1 + (j & 1): the other warpgroup's half of dS^T stored)
    if (wg == (j & 1)) {
      named_barrier(1 + (j & 1), 256);
      float acc_dq[32], tail_dq[8];
      const uint64_t a_ds = smem_desc(smem_u32(ds_tile), 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n64k16_ss<1, 1>(acc_dq, a_ds + 128 * kk, b_k + 128 * kk, kk);
        if (kTail) wgmma_m64n16k16_ss<1, 1>(tail_dq, a_ds + 128 * kk, b_k_tail + 32 * kk, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc_dq);
      if (kTail) fence_operands(tail_dq);
      if (lane == 0) mbar_arrive(&q_empty[st]);
      // this thread's query rows q0 + 16 warp + g (+ 8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 16 * warp + g + 8 * r;
        if (q >= N) continue;
        float* row = dq_acc + (bh * N + q) * D + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          add_dq(row + 8 * jj, acc_dq[4 * jj + 2 * r], acc_dq[4 * jj + 2 * r + 1]);
        }
#pragma unroll
        for (int jj = 0; jj < kTail / 8; ++jj) {
          add_dq(row + 64 + 8 * jj, tail_dq[4 * jj + 2 * r], tail_dq[4 * jj + 2 * r + 1]);
        }
      }
    } else {
      named_barrier_arrive(1 + (j & 1), 256);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&q_empty[st]);
    }
    fence_operands(acc_dk);
    fence_operands(acc_dv);
    if (kTail) {
      fence_operands(tail_dk);
      fence_operands(tail_dv);
    }
    if (++st == kWgStages) {
      st = 0;
      ph ^= 1;
    }
  }

  // dK and dV rows key0 and key0 + 8: zeros past n_valid, nothing past N
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= N) continue;
    const bool keep = key < n_valid;
    uint16_t* pk = dkb + key * sdk.n + 2 * tq;
    uint16_t* pv = dvb + key * sdv.n + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      store2(pk + 8 * jj, keep ? acc_dk[i] : 0.f, keep ? acc_dk[i + 1] : 0.f);
      store2(pv + 8 * jj, keep ? acc_dv[i] : 0.f, keep ? acc_dv[i + 1] : 0.f);
    }
#pragma unroll
    for (int jj = 0; jj < kTail / 8; ++jj) {
      const int i = 4 * jj + 2 * r;
      store2(pk + 64 + 8 * jj, keep ? tail_dk[i] : 0.f, keep ? tail_dk[i + 1] : 0.f);
      store2(pv + 64 + 8 * jj, keep ? tail_dv[i] : 0.f, keep ? tail_dv[i + 1] : 0.f);
    }
  }
}

// The 4-D tensor maps of a (B, H, rows, D) bf16 operand given by element
// strides, as vit_attention.cu's encode_operand, with boxes of `box` tokens
// of one head: dims (cols, token, head, batch), or (cols, head, token, batch)
// when the head stride is the smaller one (*tok_inner false). `map` holds
// columns 0-63 (128-byte swizzle); at D = 80 `tail` holds columns 64-79
// (32-byte swizzle).
int encode_rows(CUtensorMap* map, CUtensorMap* tail, const void* base, Strides s, int B, int H,
                int N, int D, int rows, int box, bool* tok_inner) {
  const long long sn = N > 1 ? s.n : D;
  const long long sh = H > 1 ? s.h : sn * N;
  const long long sb = B > 1 ? s.b : (sn * N > sh * H ? sn * N : sh * H);
  *tok_inner = sn <= sh;
  uint64_t dims[4] = {64, static_cast<uint64_t>(*tok_inner ? rows : H),
                      static_cast<uint64_t>(*tok_inner ? H : rows), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(*tok_inner ? sn : sh) * 2,
                               static_cast<uint64_t>(*tok_inner ? sh : sn) * 2,
                               static_cast<uint64_t>(sb) * 2};
  uint32_t bx[4] = {64, *tok_inner ? static_cast<uint32_t>(box) : 1u,
                    *tok_inner ? 1u : static_cast<uint32_t>(box), 1};
  int err = encode_tensor_map(map, base, 4, dims, strides, bx);
  if (err != 0 || D == 64) {
    *tail = *map;  // unread at D = 64
    return err;
  }
  dims[0] = bx[0] = D - 64;
  return encode_tensor_map(tail, static_cast<const uint16_t*>(base) + 64, 4, dims, strides, bx,
                           CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const float* stats, float* dq_acc, void* dk, void* dv, const Strides* s, int B,
                 int H, int N, int n_valid, int n_pad, Softmax sm, cudaStream_t stream) {
  // fresh maps on every call: the caching allocator hands the same pointers
  // out again with other shapes
  CUtensorMap mq, mk, mv, mo, tq, tk, tv, to;
  bool in_q, in_k, in_v, in_o;
  int err = encode_rows(&mq, &tq, q, s[0], B, H, N, D, N, kWgQ, &in_q);
  if (err == 0) err = encode_rows(&mk, &tk, k, s[1], B, H, N, D, n_valid, kWgKeys, &in_k);
  if (err == 0) err = encode_rows(&mv, &tv, v, s[2], B, H, N, D, n_valid, kWgKeys, &in_v);
  if (err == 0) err = encode_rows(&mo, &to, dout, s[3], B, H, N, D, N, kWgQ, &in_o);
  if (err != 0) return err;
  constexpr int smem = WgTile<D>::kSmem;
  cudaFuncSetAttribute(attention_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + kWgKeys - 1) / kWgKeys, H, B);
  attention_bwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, tq, tk, tv, to, stats, dq_acc, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), s[5], s[6], N, n_valid, n_pad,
      int(in_q) | (int(in_k) << 1) | (int(in_v) << 2) | (int(in_o) << 3), sm);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- mma_sync and tf32x3

constexpr int kMmaKeys = 64;   // keys per block, 16 per warp
constexpr int kMmaStages = 2;  // query-tile ring depth

// Shared rows: bf16 rows of D + 8 halves (ldmatrix's eight 16-byte rows then
// fall in distinct banks); f32 rows of D (hi, lo) pairs, column c of row r
// at c ^ 4 ((r ^ r >> 1) & 3): a half-warp's 64-bit loads of rows g,
// columns tq (S^T, dP^T: K, V, Q, dO) and of rows 2tq (+1) or tq (+4),
// columns g (dV, dK, dQ: dO, Q, K) then touch 16 distinct pairs of banks.
template <typename T, int D>
struct MmaTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  // queries per tile: a warp holds two 16 x BQ / kSplit score tiles and two
  // 16 x D accumulators; f32 also keeps Q and dO pairs of two stages in
  // shared memory
  static constexpr int kBQ = kF32 ? (D <= 32 ? 64 : D <= 80 ? 32 : 16) : (D <= 80 ? 64 : 32);
  // f32 at d <= 80: two warps share each 16 keys, each taking half of a
  // query tile, so that eight consumer warps (two per SM sub-partition) hide
  // the latency of 3xTF32's dependent products; their dK and dV are summed
  // at the end
  static constexpr int kSplit = kF32 && D <= 80 ? 2 : 1;
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = kBQ / kSplit;           // a warp's queries of a tile
  static constexpr int kLd = kF32 ? D : D + 8;  // elements (pairs for f32) per row
  static constexpr int kElem = kF32 ? 8 : 2;    // bytes per element in shared memory
  static constexpr int kKV = kMmaKeys * kLd * kElem;      // one K or V tile
  static constexpr int kQ = kBQ * kLd * kElem;            // one Q or dO tile
  static constexpr int kStage = 2 * kQ + 2 * kBQ * 4;     // Q, dO, lse, di
  static constexpr int kLdS = kBQ + 8;                    // dS^T rows (elements of T)
  static constexpr int kDs = kMmaKeys * kLdS * static_cast<int>(sizeof(T));
  static constexpr int kSmem = 2 * kKV + kMmaStages * kStage + 2 * kDs + kMmaStages * 8;
  // dQ's m16 tiles and n8 tiles, shared out over the warps: kWarps / kMT
  // warps a query tile, the n8 tiles split as evenly as they go
  static constexpr int kMT = kBQ / 16;
  static constexpr int kNTQ = (D / 8 + kWarps / kMT - 1) / (kWarps / kMT);  // at most
  static_assert(kWarps % kMT == 0, "dQ's m16 tiles must share the warps out evenly");
  static_assert(kSplit == 1 || kMmaKeys * 2 * D * 4 <= kMmaStages * kStage,
                "the stages must hold the halves' dK and dV for the final sum");
};

// the lane, read anew at each call, so that the shared offsets derived from
// it are recomputed inside the loop that uses them rather than hoisted out
// of the query-tile loop and held in registers
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return lane;
}

template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (c ^ (4 * ((r ^ (r >> 1)) & 3)));
}

// a pair as the two 32-bit halves of an A fragment element
__device__ __forceinline__ void pair_parts(float2 p, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(p.x);
  lo = __float_as_uint(p.y);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  }
}

// C (16 x 8 NT) = A (16 rows from `ar0` of a, K deep) B^T (8 NT rows from
// `br0` of b), both with the reduction dimension along their rows: S^T =
// K Q^T, dP^T = V dO^T
template <int NT, int K, int LD>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const uint16_t* a, int ar0,
                                         const uint16_t* b, int br0) {
  const int lane = lane_id();
  zero(c);
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (ar0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * kc + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (br0 + 16 * np + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kc +
                      8 * ((lane >> 3) & 1));
      mma_16816(c[2 * np], af, bf[0], bf[1]);
      mma_16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NT, int K, int LD>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const float2* a, int ar0,
                                         const float2* b, int br0) {
  const int lane = lane_id(), g = lane >> 2, tq = lane & 3;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < K / 8; kk += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = 8 * (kk + s) + tq;
      pair_parts(a[swz<LD>(ar0 + g, k)], ah[s][0], al[s][0]);
      pair_parts(a[swz<LD>(ar0 + g + 8, k)], ah[s][1], al[s][1]);
      pair_parts(a[swz<LD>(ar0 + g, k + 4)], ah[s][2], al[s][2]);
      pair_parts(a[swz<LD>(ar0 + g + 8, k + 4)], ah[s][3], al[s][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = br0 + 8 * nt + g;
      float t[4];
      mma_3xtf32<true>(t, ah[0], al[0], b[swz<LD>(n, 8 * kk + tq)],
                       b[swz<LD>(n, 8 * kk + tq + 4)]);
      mma_3xtf32<false>(t, ah[1], al[1], b[swz<LD>(n, 8 * kk + 8 + tq)],
                        b[swz<LD>(n, 8 * kk + 12 + tq)]);
      add_f32<false>(c[nt], t);
    }
  }
}

// C (16 x D) += X (16 x BQ, this warp's accumulator layout: P^T or dS^T) B
// (BQ rows from `br0` of b x D): dV += P^T dO, dK += dS^T Q. bf16: X rounded
// as the A fragments; f32: queries 2tq, 2tq + 1 of each 8-step in the A
// fragment's positions tq, tq + 4, and B's rows read in the same order.
template <int NTD, int BQ, int LD>
__device__ __forceinline__ void mma_acc(float (&c)[NTD][4], const float (&x)[BQ / 8][4],
                                        const uint16_t* b, int br0) {
  const int lane = lane_id();
#pragma unroll
  for (int kc = 0; kc < BQ / 16; ++kc) {
    uint32_t af[4];
    af[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    af[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    af[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    af[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int np = 0; np < NTD / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (br0 + 16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                            16 * np + 8 * (lane >> 4));
      mma_16816(c[2 * np], af, bf[0], bf[1]);
      mma_16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NTD, int BQ, int LD>
__device__ __forceinline__ void mma_acc(float (&c)[NTD][4], const float (&x)[BQ / 8][4],
                                        const float2* b, int br0) {
  const int lane = lane_id(), g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kc = 0; kc < BQ / 8; kc += 2) {
    uint32_t xh[2][4], xl[2][4];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      split_tf32(x[kc + cc][0], xh[cc][0], xl[cc][0]);  // key row g,     query 2tq
      split_tf32(x[kc + cc][2], xh[cc][1], xl[cc][1]);  // key row g + 8, query 2tq
      split_tf32(x[kc + cc][1], xh[cc][2], xl[cc][2]);  // key row g,     query 2tq + 1
      split_tf32(x[kc + cc][3], xh[cc][3], xl[cc][3]);  // key row g + 8, query 2tq + 1
    }
    const int r0 = br0 + 8 * kc + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int n = 8 * nt + g;
      float t[4];
      mma_3xtf32<true>(t, xh[0], xl[0], b[swz<LD>(r0, n)], b[swz<LD>(r0 + 1, n)]);
      mma_3xtf32<false>(t, xh[1], xl[1], b[swz<LD>(r0 + 8, n)], b[swz<LD>(r0 + 9, n)]);
      add_f32<false>(c[nt], t);
    }
  }
}

// C (16 x 8 n) = dS (queries m0 + [0, 16) of the dS^T tile ds, rows of
// LDS, 64 keys) K (64 key rows of b, columns from n0): dQ's share of the
// block's keys; n = NTQ n8 tiles (bf16), the first `count` of them (f32)
template <int NTQ, int LD, int LDS>
__device__ __forceinline__ void mma_dq(float (&c)[NTQ][4], const uint16_t* ds, int m0,
                                       const uint16_t* b, int n0, int) {
  const int lane = lane_id();
  zero(c);
#pragma unroll
  for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4_trans(af, ds + (16 * kc + (lane & 7) + 8 * (lane >> 4)) * LDS + m0 +
                          8 * ((lane >> 3) & 1));
#pragma unroll
    for (int np = 0; np < NTQ / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + n0 +
                            16 * np + 8 * (lane >> 4));
      mma_16816(c[2 * np], af, bf[0], bf[1]);
      mma_16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NTQ, int LD, int LDS>
__device__ __forceinline__ void mma_dq(float (&c)[NTQ][4], const float* ds, int m0,
                                       const float2* b, int n0, int count) {
  const int lane = lane_id(), g = lane >> 2, tq = lane & 3;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < kMmaKeys / 8; kk += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* row = ds + (8 * (kk + s) + tq) * LDS + m0 + g;
      split_tf32(row[0], ah[s][0], al[s][0]);
      split_tf32(row[8], ah[s][1], al[s][1]);
      split_tf32(row[4 * LDS], ah[s][2], al[s][2]);
      split_tf32(row[4 * LDS + 8], ah[s][3], al[s][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NTQ; ++nt) {
      if (nt >= count) break;
      const int n = n0 + 8 * nt + g;
      const int k = 8 * kk + tq;
      float t[4];
      mma_3xtf32<true>(t, ah[0], al[0], b[swz<LD>(k, n)], b[swz<LD>(k + 4, n)]);
      mma_3xtf32<false>(t, ah[1], al[1], b[swz<LD>(k + 8, n)], b[swz<LD>(k + 12, n)]);
      add_f32<false>(c[nt], t);
    }
  }
}

// the index in a shared tile of column c (in elements; pairs for f32) of
// row r
template <typename T, int D>
__device__ __forceinline__ int tile_index(int r, int c) {
  return MmaTile<T, D>::kF32 ? swz<D>(r, c) : r * (D + 8) + c;
}

// The operand rows a block reads: bf16 straight from the strided operands;
// f32 from the pre-pass's contiguous (B, H, rows, D) pairs.
template <typename T>
struct Rows {
  const void* base;
  Strides s;  // bf16: the operand's element strides; f32: unused
  int rows;   // f32: rows per head in the pairs buffer
  __device__ __forceinline__ const uint8_t* row(long long bh, int b, int h, int r, int D) const {
    if (sizeof(T) == 4) {
      return static_cast<const uint8_t*>(base) + ((bh * rows + r) * D) * 8;
    }
    return static_cast<const uint8_t*>(base) + (b * s.b + h * s.h + r * s.n) * 2;
  }
};

// rows [r0, r0 + n) of `src` into a shared tile by cp.async, 16 bytes at a
// time (chunks first, first + step, ... of them by this thread); rows at or
// past `limit` are zeros, their source not read
template <typename T, int D>
__device__ __forceinline__ void copy_rows(uint8_t* tile, const Rows<T>& src, long long bh, int b,
                                          int h, int r0, int n, int limit, int first, int step) {
  using M = MmaTile<T, D>;
  constexpr int kChunks = D * M::kElem / 16;        // per row
  constexpr int kPerChunk = 16 / M::kElem;          // elements per chunk
  for (int i = first; i < n * kChunks; i += step) {
    const int r = i / kChunks, c = (i % kChunks) * kPerChunk;
    const bool in = r0 + r < limit;
    const uint8_t* g = src.row(bh, b, h, in ? r0 + r : 0, D) + c * M::kElem;
    cp_async16_zfill(tile + tile_index<T, D>(r, c) * M::kElem, g, in);
  }
}

// K10/K11 on mma.sync: T uint16_t (bf16) or float (tf32x3). q, k, v, dO:
// bf16 by strides, or f32 pairs (q, dO: N rows; k, v: n_valid rows).
template <typename T, int D>
__global__ void __launch_bounds__(MmaTile<T, D>::kThreads, 1)
    attention_bwd_mma(Rows<T> q, Rows<T> k, Rows<T> v, Rows<T> dout,
                      const float* __restrict__ stats, float* __restrict__ dq_acc,
                      T* __restrict__ dk, T* __restrict__ dv, Strides sdk, Strides sdv, int N,
                      int n_valid, int n_pad, Softmax sm) {
  using M = MmaTile<T, D>;
  using E = std::conditional_t<M::kF32, float2, uint16_t>;  // a shared element
  constexpr int BQ = M::kBQ;
  constexpr int W = M::kWarps;
  constexpr int NT = M::kCols / 8;  // n8 tiles of this warp's S^T
  constexpr int NTD = D / 8;        // n8 tiles of dK, dV
  const int k0 = blockIdx.x * kMmaKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const long long bh = static_cast<long long>(b) * H + h;
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  if (k0 >= n_valid) {
    zero_rows(dkb, sdk, k0, kMmaKeys, N, D);
    zero_rows(dvb, sdv, k0, kMmaKeys, N, D);
    return;
  }
  extern __shared__ __align__(16) uint8_t smem_mma[];
  uint8_t* sK = smem_mma;
  uint8_t* sV = sK + M::kKV;
  uint8_t* sStage = sV + M::kKV;
  T* sDs = reinterpret_cast<T*>(sStage + kMmaStages * M::kStage);  // [2] dS^T tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sDs + 2 * kMmaKeys * M::kLdS);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmaStages; ++s) mbar_init(&full[s], M::kThreads);
    fence_barrier_init();
  }
  const float* lse = stats + bh * n_pad;
  const float* di = stats + (static_cast<long long>(gridDim.z) * H + bh) * n_pad;
  const int q_tiles = (N + BQ - 1) / BQ;
  // The ring: every thread copies its share of query tile j (Q, dO, their
  // lse and di) into stage j % kMmaStages and arrives once on its full
  // barrier when its copies land. A stage is refilled after the tile's
  // block-wide barrier, by when every warp has read it. (A producer warp of
  // its own would make nine warps at f32, for which ptxas caps a thread at
  // 168 registers and spills.)
  auto fill = [&](int j) {
    const int q0 = j * BQ;
    uint8_t* s = sStage + (j % kMmaStages) * M::kStage;
    copy_rows<T, D>(s, q, bh, b, h, q0, BQ, N, threadIdx.x, M::kThreads);
    copy_rows<T, D>(s + M::kQ, dout, bh, b, h, q0, BQ, N, threadIdx.x, M::kThreads);
    for (int i = threadIdx.x; i < BQ / 2; i += M::kThreads) {  // lse, then di
      const float* src = i < BQ / 4 ? lse + q0 + 4 * i : di + q0 + 4 * (i - BQ / 4);
      cp_async16(s + 2 * M::kQ + 16 * i, src);
    }
    cp_async_arrive(&full[j % kMmaStages]);
  };
  // the block's K and V
  copy_rows<T, D>(sK, k, bh, b, h, k0, kMmaKeys, n_valid, threadIdx.x, M::kThreads);
  copy_rows<T, D>(sV, v, bh, b, h, k0, kMmaKeys, n_valid, threadIdx.x, M::kThreads);
  cp_async_commit();
  __syncthreads();  // the barriers' initialisation
  for (int j = 0; j < kMmaStages && j < q_tiles; ++j) fill(j);
  cp_async_wait<0>();  // K and V (the fills are in no group)
  __syncthreads();

  // warp w takes keys k0 + 16 (w % 4) + [0, 16) and the
  // queries c0 + [0, kCols) of each tile; accumulator element (nt, e): key
  // row g + 8 (e >> 1), query column c0 + 8 nt + 2 tq + (e & 1)
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kr = 16 * (warp % 4);  // this warp's first key row in the tile
  const int c0 = M::kCols * (warp / 4);
  const int key0 = k0 + kr + g;
  // dQ: warp w takes queries m0 + [0, 16) and n8 tiles [nq0, nq1)
  constexpr int G = W / M::kMT;  // warps a dQ m16 tile
  const int m0 = 16 * (warp % M::kMT);
  const int nq0 = (warp / M::kMT) * NTD / G, nq1 = (warp / M::kMT + 1) * NTD / G;
  const E* cK = reinterpret_cast<const E*>(sK);
  const E* cV = reinterpret_cast<const E*>(sV);
  float acc_dk[NTD][4], acc_dv[NTD][4];
  zero(acc_dk);
  zero(acc_dv);
  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < q_tiles; ++j) {
    const int q0 = j * BQ;
    const uint8_t* s = sStage + st * M::kStage;
    const E* cQ = reinterpret_cast<const E*>(s);
    const E* cO = reinterpret_cast<const E*>(s + M::kQ);
    const float* s_lse = reinterpret_cast<const float*>(s + 2 * M::kQ);
    const float* s_di = s_lse + BQ;
    mbar_wait(&full[st], ph);

    float sc[NT][4], dp[NT][4];
    mma_rows<NT, D, M::kLd>(sc, cK, kr, cQ, c0);
    mma_rows<NT, D, M::kLd>(dp, cV, kr, cO, c0);
    // P^T in sc, dS^T in dp
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = c0 + 8 * nt + 2 * tq;
      const float2 l = *reinterpret_cast<const float2*>(s_lse + c);
      const float2 d = *reinterpret_cast<const float2*>(s_di + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1);
        sc[nt][e] = sm.p(sc[nt][e], e & 1 ? l.y : l.x, q0 + c + (e & 1), key);
        dp[nt][e] = sm.ds(sc[nt][e], dp[nt][e], e & 1 ? d.y : d.x);
      }
    }
    mma_acc<NTD, M::kCols, M::kLd>(acc_dv, sc, cO, c0);
    mma_acc<NTD, M::kCols, M::kLd>(acc_dk, dp, cQ, c0);

    // dS^T into this tile's shared tile (rows of keys); past the barrier
    // every warp is done with the stage, which takes tile j + kMmaStages; dQ
    T* ds_tile = sDs + (j & 1) * kMmaKeys * M::kLdS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        store2(ds_tile + (kr + g + 8 * r) * M::kLdS + c0 + 8 * nt + 2 * tq, dp[nt][2 * r],
               dp[nt][2 * r + 1]);
      }
    }
    __syncthreads();
    if (j + kMmaStages < q_tiles) fill(j + kMmaStages);
    float acc_dq[M::kNTQ][4];
    mma_dq<M::kNTQ, M::kLd, M::kLdS>(acc_dq, ds_tile, m0, cK, 8 * nq0, nq1 - nq0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = q0 + m0 + g + 8 * r;
      if (qr >= N) continue;
      float* row = dq_acc + (bh * N + qr) * D + 8 * nq0 + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < M::kNTQ; ++nt) {
        if (nt < nq1 - nq0) add_dq(row + 8 * nt, acc_dq[nt][2 * r], acc_dq[nt][2 * r + 1]);
      }
    }
    if (++st == kMmaStages) {
      st = 0;
      ph ^= 1;
    }
  }

  if (M::kSplit > 1) {  // the second half's dK and dV into the first's, through the stages
    float* sum = reinterpret_cast<float*>(sStage) + (warp % 4) * 2 * NTD * 4 * 32 + lane;
    __syncthreads();  // every warp is done with the stages
    if (warp >= 4) {
#pragma unroll
      for (int i = 0; i < NTD * 4; ++i) {
        sum[32 * i] = acc_dk[i / 4][i % 4];
        sum[32 * (NTD * 4 + i)] = acc_dv[i / 4][i % 4];
      }
    }
    __syncthreads();
    if (warp >= 4) return;
#pragma unroll
    for (int i = 0; i < NTD * 4; ++i) {
      acc_dk[i / 4][i % 4] += sum[32 * i];
      acc_dv[i / 4][i % 4] += sum[32 * (NTD * 4 + i)];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= N) continue;
    const bool keep = key < n_valid;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int c = 8 * nt + 2 * tq;
      store2(dkb + key * sdk.n + c, keep ? acc_dk[nt][2 * r] : 0.f,
             keep ? acc_dk[nt][2 * r + 1] : 0.f);
      store2(dvb + key * sdv.n + c, keep ? acc_dv[nt][2 * r] : 0.f,
             keep ? acc_dv[nt][2 * r + 1] : 0.f);
    }
  }
}

// the pre-pass (f32) and the kernel
template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, void* pairs,
               const float* stats, float* dq_acc, void* dk, void* dv, const Strides* s, int B,
               int H, int N, int n_valid, int n_pad, Softmax sm, cudaStream_t stream) {
  Rows<T> rq{q, s[0], N}, rk{k, s[1], n_valid}, rv{v, s[2], n_valid}, ro{dout, s[3], N};
  if (sizeof(T) == 4) {  // (hi, lo) pairs of q, k, v and dO, once
    float2* p = static_cast<float2*>(pairs);
    const long long head = static_cast<long long>(B) * H * D;
    const int sms = sm_count();
    rq.base = p;
    launch_split_pairs(static_cast<const float*>(q), s[0], p, B, H, N, D, sms, stream);
    p += head * N;
    ro.base = p;
    launch_split_pairs(static_cast<const float*>(dout), s[3], p, B, H, N, D, sms, stream);
    p += head * N;
    rk.base = p;
    launch_split_pairs(static_cast<const float*>(k), s[1], p, B, H, n_valid, D, sms, stream);
    p += head * n_valid;
    rv.base = p;
    launch_split_pairs(static_cast<const float*>(v), s[2], p, B, H, n_valid, D, sms, stream);
  }
  constexpr int smem = MmaTile<T, D>::kSmem;
  cudaFuncSetAttribute(attention_bwd_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N + kMmaKeys - 1) / kMmaKeys, H, B);
  attention_bwd_mma<T, D><<<grid, MmaTile<T, D>::kThreads, smem, stream>>>(
      rq, rk, rv, ro, stats, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), s[5], s[6], N,
      n_valid, n_pad, sm);
  return static_cast<int>(cudaGetLastError());
}

// the routes' codes, as reported through route_ran (the forward's)
constexpr int kRouteWgmma = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteTf32x3 = 2;

int route_of(int D, int is_bf16) {
  if (!is_bf16) return kRouteTf32x3;
  return D == 64 || D == 80 ? kRouteWgmma : kRouteMmaSync;
}

template <typename T>
int launch_prep(const void* q, const void* out, const void* dout, const void* lse, void* qs,
                float* stats, const Strides* s, int B, int H, int N, int D, int n_pad,
                float q_scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * N;
  const long long want = (rows + 7) / 8;  // eight warps a block
  const int blocks = static_cast<int>(want < 16LL * sm_count() ? want : 16LL * sm_count());
  prep_rows<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<T*>(qs), stats, s[0], s[7], s[3], H, N, D,
      n_pad, q_scale, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_finish(const float* dq_acc, void* dq, Strides s, int B, int H, int N, int D,
                  float q_scale, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * N * D / 4;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sm_count() ? want : 8LL * sm_count());
  finish_dq<T><<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(dq_acc),
                                           static_cast<T*>(dq), s, H, N, D, q_scale, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10 and K11. q, k, v, the forward's output out, its gradient dout, and
// the outputs dq, dk, dv: (B, H, N, D) by element strides (strides[8][3]:
// batch, head, token for q, k, v, dout, dq, dk, dv, out), last dimension
// contiguous, rows 16-byte aligned, one dtype (is_bf16: 1 bfloat16, 0
// float32). The scores see q' = round(q * q_scale) (K11's bf16(q * scale);
// q itself when q_scale is 1). lse: contiguous (B, H, N) f32, the forward's
// natural logsumexp of each row. Scratch, allocated by the caller: stats,
// contiguous (2, B, H, n_pad) f32 zeros, n_pad = N rounded up to a multiple
// of 64 (the prologue writes lse and di = rowsum(dO * O) there); qs, (B, H,
// N, D) in the dtype for q' (null when q_scale is 1); pairs, float32's
// (2 N + 2 n_valid) * B*H*D float2 (null for bfloat16); dq_acc, contiguous
// (B, H, N, D) f32 zeros. dq = round(round(dQ') * q_scale) in the dtype
// (once rounded when q_scale is 1). Keys >= n_valid (1 <= n_valid <= N)
// are never read and get dk = dv = 0. scale_bits, q_scale_bits: the
// floats' 32-bit patterns. D in {16, 32, 64, 80, 128}. *route_ran: the
// route taken (0 wgmma, 1 mma_sync, 2 tf32x3), set before the launches.
extern "C" int mvp_attention_backward(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* stats, void* qs, void* pairs, void* dq_acc,
                                      void* dq, void* dk, void* dv, const long long* strides,
                                      int B, int N, int H, int D, int n_valid, int scale_bits,
                                      int q_scale_bits, int is_bf16, int* route_ran,
                                      void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int route = route_of(D, is_bf16);
  *route_ran = route;
  float scale, q_scale;
  memcpy(&scale, &scale_bits, sizeof(scale));
  memcpy(&q_scale, &q_scale_bits, sizeof(q_scale));
  if ((route == kRouteTf32x3 && pairs == nullptr) || ((q_scale != 1.f) != (qs != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Softmax sm{scale, scale * kLog2e, N, n_valid};
  Strides s[8];
  for (int i = 0; i < 8; ++i) {
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(stats);
  float* acc = static_cast<float*>(dq_acc);
  const int n_pad = (N + kPadRows - 1) / kPadRows * kPadRows;
  int err = is_bf16 ? launch_prep<uint16_t>(q, out, dout, lse, qs, rows, s, B, H, N, D, n_pad,
                                            q_scale, st)
                    : launch_prep<float>(q, out, dout, lse, qs, rows, s, B, H, N, D, n_pad,
                                         q_scale, st);
  if (err != 0) return err;
  if (qs != nullptr) {  // the kernels read q' from qs
    q = qs;
    s[0] = Strides{static_cast<long long>(H) * N * D, static_cast<long long>(N) * D, D};
  }
#define MVP_BWD_MMA(T, DIM)                                                                   \
  case DIM:                                                                                   \
    err = launch_mma<T, DIM>(q, k, v, dout, pairs, rows, acc, dk, dv, s, B, H, N, n_valid,    \
                             n_pad, sm, st);                                                  \
    break;
  if (route == kRouteWgmma) {
    err = D == 64 ? launch_wgmma<64>(q, k, v, dout, rows, acc, dk, dv, s, B, H, N, n_valid,
                                     n_pad, sm, st)
                  : launch_wgmma<80>(q, k, v, dout, rows, acc, dk, dv, s, B, H, N, n_valid,
                                     n_pad, sm, st);
  } else if (route == kRouteMmaSync) {
    switch (D) {
      MVP_BWD_MMA(uint16_t, 16)
      MVP_BWD_MMA(uint16_t, 32)
      MVP_BWD_MMA(uint16_t, 128)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (D) {
      MVP_BWD_MMA(float, 16)
      MVP_BWD_MMA(float, 32)
      MVP_BWD_MMA(float, 64)
      MVP_BWD_MMA(float, 80)
      MVP_BWD_MMA(float, 128)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef MVP_BWD_MMA
  if (err != 0) return err;
  return is_bf16 ? launch_finish<uint16_t>(acc, dq, s[4], B, H, N, D, q_scale, st)
                 : launch_finish<float>(acc, dq, s[4], B, H, N, D, q_scale, st);
}
