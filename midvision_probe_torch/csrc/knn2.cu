// Exact 2-nearest-neighbour search under squared L2 for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel K4 (ops/matching.py:
// `_knn2_pallas` -> `_knn2_kernel`), the dense-feature matcher of the NAVI
// and ScanNet correspondence evaluations.
//
// What it computes: for every query row q_i of a (B, N, D) float32 batch
// and the (B, M, D) float32 targets of the same batch element,
//   d(i, j) = max(qn_i + tn_j - 2 * q_i . t_j, 0)
// and the two smallest (distance, index) pairs over j, ascending; equal
// distances keep the lower index (jax.lax.top_k's order). The norms qn and
// tn are computed by the caller, as in the JAX package. The dot product is
// the TPU kernel's 3-term bf16 split: each f32 operand x becomes
// hi = bf16(x) and lo = bf16(x - hi), and the kernel sums hi.hi + hi.lo +
// lo.hi in one f32 accumulator (lo.lo is below f32 resolution). Plain TF32
// keeps ~10 mantissa bits, too coarse for the ratio test on near-ties.
//
// What bounds it on an H100: at the ScanNet protocol's launch (B=4,
// N=M=19200, D=768) the three bf16 products are 3 * 2*B*N*M*D = 6.79e12
// FLOP (6.87 ms at 989 TFLOP/s) against 0.47 GB of f32 q and t (0.14 ms at
// 3.35 TB/s): it is bound by tensor-core operations. The N x M distance
// matrix never leaves the chip. The design:
//
// 1. `split_kernel` turns q and t into one bf16 plane each, once: per chunk
//    of 32 features the 32 hi values, then the 32 lo values, so that one
//    128-byte row holds both halves of a chunk; D is zero-padded to a
//    multiple of 32 (caller-allocated workspace, (rows, W) each). The main
//    loop then never converts. Splitting inside the main loop instead would
//    redo a query block's split for every target tile (75 times at
//    ScanNet's shape) and a target tile's for every query block.
// 2. `knn2_wgmma`: one block per 128 query rows of one batch element walks
//    every 256-target tile, warp-specialised. One producer thread keeps a
//    4-stage ring of 32-feature chunks in flight with TMA (3D tensor maps
//    over (B, rows, W), boxes of 128-byte rows, 128-byte swizzle; rows past
//    N or M arrive as zeros): the query block's rows (16 KB) and the target
//    tile's (32 KB), 48 KB a stage, each stage behind a full and an empty
//    mbarrier. Two consumer warpgroups each own 64 query rows and issue,
//    per 16 features, three wgmma.m64n256k16 (hi.hi, hi.lo, lo.hi: the
//    descriptors pick the hi or lo half of the swizzled rows; bf16 in, both
//    operands K-major, f32 accumulate into one 128-register accumulator),
//    keeping one chunk's products in flight while the next chunk's are
//    issued.
//    The reckoning: a wgmma reads 10 KB of shared memory for 0.5 MFLOP, 74
//    bytes a clock at the SM's share of the peak, under its 128; per chunk
//    the block pulls 48 KB from L2 for 6.3 MFLOP, so a deep ring of small
//    chunks rather than a shallow one of large chunks keeps the tensor
//    cores fed. The grid puts the query blocks of one
//    batch element next to each other, so the blocks that run together
//    walk that element's targets in step and share each target tile in L2.
//
// Running top-2: after the last chunk of a target tile each thread turns
// its accumulators into distances, in increasing target index, and inserts
// those below its row's second into a top-2 per accumulator row (a thread
// holds rows g and g + 8 of its warp's 16 at columns 8j + 2tq + {0, 1};
// strict '<', so a tie keeps the earlier, lower index). The tensor cores
// wait while both warpgroups run this epilogue, so it is kept short: the
// tile's target norms are loaded while the products run (one per consumer
// thread) and shared through shared memory, +inf past M, which also
// replaces the column mask; a distance no better than the row's second
// skips the insertion. A row is spread over the 4 lanes of a quad; at the
// end the quad merges its four top-2 lists with two __shfl_xor_sync
// rounds, ordering by (distance, index).
//
// Padded rows: query rows >= N and target rows >= M are zeros in shared
// memory; a target index >= M gets distance +inf and is never inserted,
// and a query row >= N is never stored.
//
// Plain C interface for ctypes: pointers and ints only; the function
// returns cudaGetLastError() after the launches (or the tensor-map
// encoding's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                          // query rows per block (2 x 64)
constexpr int kBN = 256;                          // targets per tile
constexpr int kBK = 32;                           // features per chunk: hi and lo, 128 bytes
constexpr int kStages = 4;                        // TMA ring depth
constexpr int kQBytes = kBM * 128;                // the query rows of a chunk: 16 KB
constexpr int kTBytes = kBN * 128;                // the target rows of a chunk: 32 KB
constexpr int kStageBytes = kQBytes + kTBytes;    // 48 KB
constexpr int kThreads = 384;                     // 2 consumer warpgroups + 1 producer
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 2 * kBN * 4 + 1024;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (da, ia) orders before (db, ib): smaller distance, then lower index
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// candidates arrive in increasing index: strict '<' keeps the lower index
// on a tie
__device__ __forceinline__ void insert(float d, int i, float& d1, int& i1, float& d2,
                                       int& i2) {
  if (d < d1) {
    d2 = d1;
    i2 = i1;
    d1 = d;
    i1 = i;
  } else if (d < d2) {
    d2 = d;
    i2 = i;
  }
}

// merge this lane's sorted top-2 with the one of lane (lane ^ mask)
__device__ __forceinline__ void merge_xor(int mask, float& d1, int& i1, float& d2,
                                          int& i2) {
  const float e1 = __shfl_xor_sync(0xffffffffu, d1, mask);
  const int j1 = __shfl_xor_sync(0xffffffffu, i1, mask);
  const float e2 = __shfl_xor_sync(0xffffffffu, d2, mask);
  const int j2 = __shfl_xor_sync(0xffffffffu, i2, mask);
  const bool mine = before(d1, i1, e1, j1);
  // second smallest of the union: the loser of the two firsts, or the
  // winner's second, whichever orders first
  const float ld = mine ? e1 : d1;
  const int li = mine ? j1 : i1;
  const float wd = mine ? d2 : e2;
  const int wi = mine ? i2 : j2;
  if (!mine) {
    d1 = e1;
    i1 = j1;
  }
  if (before(ld, li, wd, wi)) {
    d2 = ld;
    i2 = li;
  } else {
    d2 = wd;
    i2 = wi;
  }
}

// x (rows, D) f32 -> the (rows, W) bf16 plane: per chunk c of 32 features
// the 64 elements hi = bf16(x[32c:32c+32]), then lo = bf16(x - hi), zero
// past D. One thread per 4 features.
__global__ void split_kernel(const float* __restrict__ x, uint16_t* __restrict__ plane,
                             long long rows, int D, int W) {
  const int groups = W / 8;  // 4 features a group, W / 2 features a row
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * groups) return;
  const long long r = i / groups;
  const int f = static_cast<int>(i % groups) * 4;  // first feature of the group
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = f + e < D ? x[r * D + f + e] : 0.f;
    const __nv_bfloat16 vh = __float2bfloat16_rn(v);
    h[e] = __bfloat16_as_ushort(vh);
    l[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(vh)));
  }
  const long long o = r * W + (f / kBK) * 2 * kBK + f % kBK;
  *reinterpret_cast<uint2*>(plane + o) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  *reinterpret_cast<uint2*>(plane + o + kBK) =
      make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
}

__global__ void __launch_bounds__(kThreads, 1)
    knn2_wgmma(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_t, const float* __restrict__ qn,
               const float* __restrict__ tn, float* __restrict__ dist,
               int* __restrict__ idx, int N, int M, int W) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* tn_tile = reinterpret_cast<float*>(empty + kStages);  // [2][kBN], by tile parity
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int q0 = blockIdx.x * kBM;
  const int b = blockIdx.y;
  const int n_tiles = (M + kBN - 1) / kBN;
  const int chunks = W / (2 * kBK);

  if (tid >= 2 * 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tt = 0; tt < n_tiles; ++tt) {
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* s = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_3d(s, &map_q, &full[stage], c * 2 * kBK, q0, b);
          tma_load_3d(s + kQBytes, &map_t, &full[stage], c * 2 * kBK, tt * kBN, b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // two consumer warpgroups, 64 query rows each
  setmaxnreg_inc<232>();
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row group
  const int tq = lane & 3;  // thread in quad
  const int ra = q0 + wg * 64 + warp * 16 + g;  // this thread's two rows
  const int rb = ra + 8;
  const float qna = ra < N ? qn[static_cast<long long>(b) * N + ra] : 0.f;
  const float qnb = rb < N ? qn[static_cast<long long>(b) * N + rb] : 0.f;
  const float* tnb = tn + static_cast<long long>(b) * M;
  float a_d1 = pos_inf(), a_d2 = pos_inf(), b_d1 = pos_inf(), b_d2 = pos_inf();
  int a_i1 = 0x7fffffff, a_i2 = 0x7fffffff, b_i1 = 0x7fffffff, b_i2 = 0x7fffffff;

  int stage = 0;
  uint32_t phase = 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int tt = 0; tt < n_tiles; ++tt) {
    // this thread's target norm of the tile (+inf past M), loaded while the
    // products run and shared through shared memory after them
    const int my_col = tt * kBN + tid;
    const float my_tn = my_col < M ? __ldg(tnb + my_col) : pos_inf();
    int prev = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[stage], phase);
      const uint32_t s = smem_u32(smem + stage * kStageBytes);
      // hi at bytes 0-63 of a swizzled 128-byte row, lo at 64-127
      const uint32_t qh = s + wg * (64 * 128), ql = qh + 64;
      const uint32_t th = s + kQBytes, tl = th + 64;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t dqh = smem_desc(qh + 32 * ks, 16, 1024);
        const uint64_t dth = smem_desc(th + 32 * ks, 16, 1024);
        wgmma_m64n256k16_ss<0>(acc, dqh, dth, c + ks > 0);  // a new tile starts from 0
        wgmma_m64n256k16_ss<0>(acc, dqh, smem_desc(tl + 32 * ks, 16, 1024), 1);
        wgmma_m64n256k16_ss<0>(acc, smem_desc(ql + 32 * ks, 16, 1024), dth, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      if (c > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // the tile's dot products are complete. Two tn buffers by tile parity:
    // a thread writes one only after it (and so every consumer) has passed
    // the barrier that follows its reads of that buffer two tiles back.
    float* tnt = tn_tile + (tt & 1) * kBN;
    tnt[tid] = my_tn;
    named_barrier(1, 2 * 128);
    const int cb = tt * kBN + tq * 2;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 tn2 = *reinterpret_cast<const float2*>(tnt + 8 * j + tq * 2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float tnc = e ? tn2.y : tn2.x;  // +inf past M: never inserted
        const float da = fmaxf((qna + tnc) - 2.f * acc[4 * j + e], 0.f);
        const float db = fmaxf((qnb + tnc) - 2.f * acc[4 * j + 2 + e], 0.f);
        // the common case (no better than the row's second) skips insert
        if (da < a_d2) insert(da, cb + 8 * j + e, a_d1, a_i1, a_d2, a_i2);
        if (db < b_d2) insert(db, cb + 8 * j + e, b_d1, b_i1, b_d2, b_i2);
      }
    }
  }

  merge_xor(1, a_d1, a_i1, a_d2, a_i2);
  merge_xor(2, a_d1, a_i1, a_d2, a_i2);
  merge_xor(1, b_d1, b_i1, b_d2, b_i2);
  merge_xor(2, b_d1, b_i1, b_d2, b_i2);
  if (tq == 0) {
    if (ra < N) {
      const long long o = (static_cast<long long>(b) * N + ra) * 2;
      *reinterpret_cast<float2*>(dist + o) = make_float2(a_d1, a_d2);
      *reinterpret_cast<int2*>(idx + o) = make_int2(a_i1, a_i2);
    }
    if (rb < N) {
      const long long o = (static_cast<long long>(b) * N + rb) * 2;
      *reinterpret_cast<float2*>(dist + o) = make_float2(b_d1, b_d2);
      *reinterpret_cast<int2*>(idx + o) = make_int2(b_i1, b_i2);
    }
  }
}

// a (B, rows, W) bf16 plane as a 3D tensor map with boxes of one chunk (64
// elements, 128 bytes: hi and lo of 32 features) x box_rows rows of one
// batch element
int plane_map(CUtensorMap* map, const void* plane, int B, int rows, int W, int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(W), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(W) * 2,
                               static_cast<uint64_t>(rows) * W * 2};
  const uint32_t box[3] = {2 * kBK, static_cast<uint32_t>(box_rows), 1};
  return encode_tensor_map(map, plane, 3, dims, strides, box);
}

void launch_split(const float* x, uint16_t* plane, long long rows, int D, int W,
                  cudaStream_t stream) {
  const long long work = rows * (W / 8);
  const int threads = 256;
  split_kernel<<<static_cast<unsigned>((work + threads - 1) / threads), threads, 0, stream>>>(
      x, plane, rows, D, W);
}

}  // namespace

// Width W of the bf16 workspace planes for a given D: hi and lo of every
// 32-feature chunk, D padded to a multiple of 32.
extern "C" int mvp_knn2_plane_width(int D) { return (D + kBK - 1) / kBK * 2 * kBK; }

// q: contiguous (B, N, D) f32; t: contiguous (B, M, D) f32; qn (B, N) and
// tn (B, M) f32 squared row norms; workspace planes q_planes (B, N, W) and
// t_planes (B, M, W) bf16, 16-byte aligned, W = mvp_knn2_plane_width(D);
// dist (B, N, 2) f32 and idx (B, N, 2) int32 out. Needs N >= 1, M >= 2,
// D >= 1.
extern "C" int mvp_knn2(const void* q, const void* t, const void* qn, const void* tn,
                        void* q_planes, void* t_planes, void* dist, void* idx, int B, int N,
                        int M, int D, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M < 2 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = mvp_knn2_plane_width(D);
  auto* qp = static_cast<uint16_t*>(q_planes);
  auto* tp = static_cast<uint16_t*>(t_planes);
  launch_split(static_cast<const float*>(q), qp, static_cast<long long>(B) * N, D, W, st);
  launch_split(static_cast<const float*>(t), tp, static_cast<long long>(B) * M, D, W, st);
  CUtensorMap map_q, map_t;
  int err = plane_map(&map_q, qp, B, N, W, kBM);
  if (err == 0) err = plane_map(&map_t, tp, B, M, W, kBN);
  if (err != 0) return err;
  cudaFuncSetAttribute(knn2_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const dim3 grid((N + kBM - 1) / kBM, B);
  knn2_wgmma<<<grid, kThreads, kSmem, st>>>(map_q, map_t, static_cast<const float*>(qn),
                                            static_cast<const float*>(tn),
                                            static_cast<float*>(dist), static_cast<int*>(idx), N,
                                            M, W);
  return static_cast<int>(cudaGetLastError());
}
