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
// 3.35 TB/s): it is bound by tensor-core operations. The design keeps the
// N x M distance matrix out of device memory entirely and spends the issue
// slots on mma and little else:
//
// 1. `split_kernel` turns q and t into bf16 hi and lo planes once, with the
//    feature dimension zero-padded to a multiple of 32 (caller-allocated
//    workspace, (rows, Dp) each). The main loop then never converts.
// 2. `knn2_kernel`: one block (8 warps) per 128 query rows of one batch
//    element walks every 128-target tile. The hi/lo chunks (32 features)
//    of the query tile and of the target tile are fetched with cp.async
//    into one of two shared-memory stages (the next chunk is in flight
//    while the current one is consumed; rows padded to 40 halves, so every
//    ldmatrix phase is free of bank conflicts), loaded into mma fragments
//    with ldmatrix.x4 and multiplied with mma.sync m16n8k16 (bf16 in, f32
//    accumulate; the fragment layouts of csrc/vit_attention.cu). Each warp
//    owns 16 query rows x 128 targets.
//
// Running top-2: after the last chunk of a target tile each thread turns
// its accumulators into distances and inserts them, in increasing target
// index, into a top-2 per fragment row (strict '<', so a tie keeps the
// earlier, lower index). A fragment row is spread over the 4 lanes of a
// quad; at the end the quad merges its four top-2 lists with two
// __shfl_xor_sync rounds, ordering by (distance, index).
//
// Padded rows: target rows >= M and query rows >= N are never read (their
// shared-memory rows are zero-filled) and a target index >= M is never
// inserted.
//
// Plain C interface for ctypes: pointers and ints only; the function
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;   // query rows per block (16 per warp)
constexpr int kBN = 128;           // targets per tile
constexpr int kRows = kBM + kBN;   // staged rows per chunk: queries, then targets
constexpr int kKC = 32;            // features per chunk
constexpr int kLD = kKC + 8;       // padded shared-memory row, in halves
constexpr int kNT = kBN / 8;       // n-tiles per warp
constexpr int kVecPerRow = kKC / 8;  // 16-byte pieces of a row chunk
constexpr int kStageHalves = 2 * kRows * kLD;  // hi plane, then lo plane
constexpr int kSmemBytes = 2 * kStageHalves * 2;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// x (rows, D) f32 -> hi, lo (rows, Dp) bf16 with hi = bf16(x), lo =
// bf16(x - hi), zero past D. One thread per 4 output columns.
__global__ void split_kernel(const float* __restrict__ x, uint16_t* __restrict__ hi,
                             uint16_t* __restrict__ lo, long long rows, int D, int Dp) {
  const int groups = Dp / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * groups) return;
  const long long r = i / groups;
  const int c = static_cast<int>(i % groups) * 4;
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = c + e < D ? x[r * D + c + e] : 0.f;
    const __nv_bfloat16 vh = __float2bfloat16_rn(v);
    h[e] = __bfloat16_as_ushort(vh);
    l[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(vh)));
  }
  const long long o = r * Dp + c;
  *reinterpret_cast<uint2*>(hi + o) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  *reinterpret_cast<uint2*>(lo + o) = make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
}

__global__ void __launch_bounds__(kThreads, 2)
    knn2_kernel(const uint16_t* __restrict__ q_hi, const uint16_t* __restrict__ q_lo,
                const uint16_t* __restrict__ t_hi, const uint16_t* __restrict__ t_lo,
                const float* __restrict__ qn, const float* __restrict__ tn,
                float* __restrict__ dist, int* __restrict__ idx, int N, int M, int Dp) {
  extern __shared__ __align__(16) uint16_t smem[];  // [2 stages][hi, lo][kRows][kLD]

  const int q0 = blockIdx.x * kBM;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in quad
  const long long qoff = static_cast<long long>(b) * N * Dp;
  const long long toff = static_cast<long long>(b) * M * Dp;
  const float* tnb = tn + static_cast<long long>(b) * M;

  const int n_chunks = Dp / kKC;
  const int n_tiles = (M + kBN - 1) / kBN;
  const int steps = n_tiles * n_chunks;

  // stage step s = (target tile, feature chunk) into buffer `buf`
  auto issue = [&](int s, int buf) {
    const int t0 = (s / n_chunks) * kBN;
    const int k0 = (s % n_chunks) * kKC;
    uint16_t* dst_hi = smem + buf * kStageHalves;
    uint16_t* dst_lo = dst_hi + kRows * kLD;
    for (int i = tid; i < kRows * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int o = r * kLD + c;
      long long src = -1;
      if (r < kBM) {
        if (q0 + r < N) src = qoff + static_cast<long long>(q0 + r) * Dp + k0 + c;
      } else if (t0 + r - kBM < M) {
        src = toff + static_cast<long long>(t0 + r - kBM) * Dp + k0 + c;
      }
      if (src >= 0) {
        cp_async16(dst_hi + o, (r < kBM ? q_hi : t_hi) + src);
        cp_async16(dst_lo + o, (r < kBM ? q_lo : t_lo) + src);
      } else {
        *reinterpret_cast<uint4*>(dst_hi + o) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst_lo + o) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  issue(0, 0);
  cp_async_commit();

  const int ra = q0 + warp * 16 + g;  // this thread's two fragment rows
  const int rb = ra + 8;
  const float qna = ra < N ? qn[static_cast<long long>(b) * N + ra] : 0.f;
  const float qnb = rb < N ? qn[static_cast<long long>(b) * N + rb] : 0.f;
  float a_d1 = pos_inf(), a_d2 = pos_inf(), b_d1 = pos_inf(), b_d2 = pos_inf();
  int a_i1 = 0x7fffffff, a_i2 = 0x7fffffff, b_i1 = 0x7fffffff, b_i2 = 0x7fffffff;

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }

  // ldmatrix row addresses (in halves, within a plane): A, this warp's 16
  // rows, lanes 0-15 at k 0, lanes 16-31 at k 8; B, target rows of an
  // n-tile pair, matrices (n 0-7, k 0), (n 0-7, k 8), (n 8-15, k 0),
  // (n 8-15, k 8)
  const int a_row = (warp * 16 + (lane & 15)) * kLD + (lane >> 4) * 8;
  const int b_row = (kBM + (lane & 7) + ((lane >> 4) << 3)) * kLD + ((lane >> 3) & 1) * 8;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();  // this thread's copies of step s have landed
    __syncthreads();     // everyone's have; every warp is done with step s-1
    if (s + 1 < steps) issue(s + 1, (s + 1) & 1);
    cp_async_commit();

    const uint16_t* s_hi = smem + (s & 1) * kStageHalves;
    const uint16_t* s_lo = s_hi + kRows * kLD;
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, s_hi + a_row + kk * 16);
      ldmatrix_x4(al, s_lo + a_row + kk * 16);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, s_hi + b_row + np * 16 * kLD + kk * 16);
        ldmatrix_x4(bl, s_lo + b_row + np * 16 * kLD + kk * 16);
        mma_16816(acc[2 * np], ah, bh[0], bh[1]);
        mma_16816(acc[2 * np], ah, bl[0], bl[1]);
        mma_16816(acc[2 * np], al, bh[0], bh[1]);
        mma_16816(acc[2 * np + 1], ah, bh[2], bh[3]);
        mma_16816(acc[2 * np + 1], ah, bl[2], bl[3]);
        mma_16816(acc[2 * np + 1], al, bh[2], bh[3]);
      }
    }

    if (s % n_chunks == n_chunks - 1) {  // the tile's dot products are complete
      const int t0 = (s / n_chunks) * kBN;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t0 + nt * 8 + tq * 2 + e;
          if (col < M) {
            const float tnc = __ldg(tnb + col);
            insert(fmaxf((qna + tnc) - 2.f * acc[nt][e], 0.f), col, a_d1, a_i1, a_d2, a_i2);
            insert(fmaxf((qnb + tnc) - 2.f * acc[nt][2 + e], 0.f), col, b_d1, b_i1, b_d2,
                   b_i2);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
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

void launch_split(const float* x, uint16_t* hi, uint16_t* lo, long long rows, int D, int Dp,
                  cudaStream_t stream) {
  const long long work = rows * (Dp / 4);
  const int threads = 256;
  split_kernel<<<static_cast<unsigned>((work + threads - 1) / threads), threads, 0, stream>>>(
      x, hi, lo, rows, D, Dp);
}

}  // namespace

// Padded feature width of the hi/lo workspace planes for a given D.
extern "C" int mvp_knn2_padded_dim(int D) { return (D + kKC - 1) / kKC * kKC; }

// q: contiguous (B, N, D) f32; t: contiguous (B, M, D) f32; qn (B, N) and
// tn (B, M) f32 squared row norms; workspace planes q_hi, q_lo (B, N, Dp)
// and t_hi, t_lo (B, M, Dp) bf16, 16-byte aligned, Dp =
// mvp_knn2_padded_dim(D); dist (B, N, 2) f32 and idx (B, N, 2) int32 out.
// Needs N >= 1, M >= 2, D >= 1.
extern "C" int mvp_knn2(const void* q, const void* t, const void* qn, const void* tn,
                        void* q_hi, void* q_lo, void* t_hi, void* t_lo, void* dist,
                        void* idx, int B, int N, int M, int D, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M < 2 || D <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Dp = mvp_knn2_padded_dim(D);
  auto* qh = static_cast<uint16_t*>(q_hi);
  auto* ql = static_cast<uint16_t*>(q_lo);
  auto* th = static_cast<uint16_t*>(t_hi);
  auto* tl = static_cast<uint16_t*>(t_lo);
  launch_split(static_cast<const float*>(q), qh, ql, static_cast<long long>(B) * N, D, Dp, st);
  launch_split(static_cast<const float*>(t), th, tl, static_cast<long long>(B) * M, D, Dp, st);
  cudaFuncSetAttribute(knn2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  const dim3 grid((N + kBM - 1) / kBM, B);
  knn2_kernel<<<grid, kThreads, kSmemBytes, st>>>(qh, ql, th, tl, static_cast<const float*>(qn),
                                                 static_cast<const float*>(tn),
                                                 static_cast<float*>(dist), static_cast<int*>(idx),
                                                 N, M, Dp);
  return static_cast<int>(cudaGetLastError());
}
