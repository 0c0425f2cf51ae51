// The attention bench's clamped-exp2 attention for Hopper (sm_90a), forward
// only: one attention kernel template behind two entry points, and K8's
// int8 prologue (two kernels behind a third).
//
// Replaces two Pallas TPU kernels of the repository's attention bench
// (launch_script/bench_attn.py) and the XLA prologue of the second:
//   * K7 `wide_attention` (-> `_wide_kernel`), entry point
//     mvp_wide_attention, at every head dim that is a multiple of 8 up to
//     128 but 64 and 80 (its mma_sync route; d = 64 and 80 run on the wgmma
//     route, mvp_clamp_attention in vit_attention.cu): q, k, v read by
//     stride out of the (B, N, 3, H, d) bf16 qkv projection;
//   * K8 `int8_attention` (-> `_int8_kernel`), entry point
//     mvp_int8_attention, at d = 8, 16, 32 and 128 (d = 64 runs on the wgmma
//     route, mvp_int8_attention_wgmma in vit_attention.cu): q and k as the
//     int8 (B, H, N, d_pad) tensors of the prologue, v from the projection;
//   * K8's prologue (the JAX code's per-head scales and quantization,
//     computed outside its kernel), entry point mvp_quantize_qk: `amax_qk`
//     then `quantize_qk`, below.
// Both attention entry points write the (B, N, H*d) bf16 output token-major.
//
// What they compute, per (batch, head):
//   K7: q' = bf16(f32(q) * scale*log2(e)), s = q' k^T (f32 accumulation);
//   K8: s = f32(q8 k8^T) * c[h] (exact int32 accumulation: |s32| <= d*127^2
//       < 2^24 at d <= 128, so the conversion is exact), c[h] =
//       scale*log2(e)*qs[h]*ks[h] from the prologue;
//   then both: s = min(s, 110); columns >= n_valid are -inf (their keys and
//   values are never read: their shared-memory rows are zero-filled);
//   p = exp2(s) with NO max subtraction; l = max(sum of the f32 p, 1e-30);
//   o = (bf16(p) v) / l with f32 accumulation, rounded to bf16. Every query
//   row (padded rows too) is computed. A row whose every exp2 underflows
//   gets l = 1e-30 and o = 0. min(s, 110) keeps exp2(s) * n_valid inside
//   f32's range for any n_valid below 2^17.
//
// What bounds it on an H100: at the bench shape (B=64, N=1280, n_valid=1201,
// H=12, d=64) K7 does 4*B*H*N*n_valid*d = 3.02e11 bf16 tensor-core
// operations (0.306 ms at 989 TFLOP/s) and B*H*N*n_valid = 1.18e9 exp2 on
// the 16-per-clock MUFU (0.282 ms at 1.98 GHz on 132 SMs) against ~0.2 GB of
// qkv in and output out: bound by operations. The design: no running max
// means no rescaling of the accumulators, so each 64-key tile is consumed
// once and never revisited; scores stay in registers (mma.sync m16n8k16 bf16
// or m16n8k32 s8, f32/s32 accumulators), and bf16(p) goes straight from the
// score accumulators into the A fragments of the PV product. The next K/V
// tile is fetched with cp.async while the current one is consumed.
//
// Head dims: the kernel is instantiated at a padded width: QK^T's k-chunks
// are 32 bytes (16 bf16 or 32 s8) and the PV product's n-tiles 8 columns.
// K7 at head dim d runs the instance DK = DV = d rounded up to 16; the
// columns >= d of its q, k and v tiles are zero-filled in shared memory
// (cp.async with a source size of 0) and never written out. K8's q8 and k8
// rows are zero-padded in device memory by the prologue to d_pad, a
// multiple of 32 bytes (DK = d_pad), and its v tile as K7's (DV = d rounded
// up to 16). Zero products add nothing: the scores are exact.
//
// `width` (heads per kernel instance on the TPU) and `stagger` (the TPU
// kernel's QK-ahead software pipeline) schedule the work and do not change
// the function. Here a block takes 64 query rows of `heads_per_block` =
// width/d consecutive heads in turn; with `stagger` the first K/V tile (and
// the Q tile) of the next head is fetched while the last tile of the current
// head is consumed, without it the pipeline drains at every head boundary.
//
// int8 fragments: the s8 m16n8k32 A/B fragments hold four consecutive k
// elements per register at the byte offsets where the bf16 m16n8k16
// fragments hold two, so both paths load their QK^T fragments with the same
// 32-bit shared-memory loads on byte offsets (no ldmatrix).
//
// The prologue (K8 at every head dim): the JAX code's per-head scales are
// the max |x| of q and of k over the valid rows of the whole batch, a
// reduction across every block; so two kernels, each a pass over the
// (B, N, 3, H, d) projection that reads 16 bytes (8 bf16 of one head) per
// thread, one block per (batch, role, head):
//   * amax_qk: max |x| over the rows < n_valid, on the bf16 bit patterns
//     (|x| is the pattern with its sign bit cleared, and non-negative floats
//     order as unsigned integers, so the max is exact and independent of
//     order; a NaN stays the largest), reduced in the block, then one
//     atomicMax per block on the head's slot. Rows >= n_valid are never read;
//   * quantize_qk: s = max(amax, 1e-8) * f32(1/127) (the f32 reciprocal
//     multiply that XLA makes of the JAX code's `/ 127.0`), q8 =
//     clamp(rint(x / s), -127, 127) with an IEEE division (rint: half to
//     even, as jnp.round), written head-major (B, H, N, d_pad) with zeros in
//     the pad, so that one TMA box of the wgmma route is one contiguous 2-D
//     tile; and c[h] = scale*log2(e)*qs[h]*ks[h].
// At the bench shape the two passes move 236 MB + 378 MB: bound by bytes,
// 0.183 ms at 3.35 TB/s.
//
// Plain C interface for ctypes: every argument is a pointer or an int (the
// scale arrives as the bit pattern of a float); each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;  // 4 warps, 16 query rows each
constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per K/V tile

// byte strides of a (B, H, N, d) operand (last dimension contiguous)
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory, of which the first `bytes` (0 or 16) are read
// from gmem and the rest are zero
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c += a * b, m16n8k16: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, m16n8k32: a 16x32 s8 (row), b 32x8 s8 (col), c 16x8 s32 (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 in one register -> each times `c` in f32, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float c) {
  const float lo = __uint_as_float(x << 16);
  const float hi = __uint_as_float(x & 0xffff0000u);
  return pack_bf16(lo * c, hi * c);
}

// One block per (q-tile of 64 rows, group of G heads, batch). Shared memory:
// two Q buffers (one per head in flight) and two stages of K and V. Q and K
// rows are DK elements of 2 bytes (bf16) or 1 byte (int8), padded by 16 bytes
// so that the eight fragment rows of a warp start on distinct 4-bank groups
// (row strides of 4, 12, 20 or 28 words modulo 32); V rows are DV bf16,
// padded by 8 halves. qk_bytes: the bytes of a q/k row held in device memory
// (the rest of the DK columns is zero-filled); dv: the head dim of v and of
// the output (DV rounded down to it).
template <int DK, int DV, bool kInt8>
__global__ void __launch_bounds__(kThreads)
    clamp_attention(const uint8_t* __restrict__ q, const uint8_t* __restrict__ k,
                    const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                    const float* __restrict__ c, Strides sq, Strides sk, Strides sv,
                    int qk_bytes, int dv, int H, int N, int n_valid, int G, int stagger,
                    float scale_log2) {
  constexpr int ESZ = kInt8 ? 1 : 2;  // bytes per q/k element
  constexpr int RQ = DK * ESZ + 16;   // padded q/k row, bytes
  constexpr int CQ = DK * ESZ / 16;   // 16-byte chunks per q/k row
  constexpr int KC = DK * ESZ / 32;   // 32-byte k-chunks of QK^T (16 bf16 or 32 s8)
  constexpr int LV = DV + 8;          // padded v row, halves
  constexpr int CV = DV / 8;          // 16-byte chunks per v row
  constexpr int DN = DV / 8;          // n-tiles of P V
  constexpr int NT = kBN / 8;         // n-tiles of the score tile

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sQ = smem;                  // [2][kBM][RQ]
  uint8_t* sK = sQ + 2 * kBM * RQ;     // [2][kBN][RQ]
  uint16_t* sV = reinterpret_cast<uint16_t*>(sK + 2 * kBN * RQ);  // [2][kBN][LV]

  const int q0 = blockIdx.x * kBM;
  const int h0 = blockIdx.y * G;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int n_tiles = (n_valid + kBN - 1) / kBN;
  const int total = G * n_tiles;
  const int cq = qk_bytes / 16;  // chunks of a q/k row read from device memory
  const int cv = dv / 8;         // chunks of a v row read from device memory

  // item i = (head h0 + i / n_tiles, key tile i % n_tiles), K/V stage i & 1
  auto fetch = [&](int i) {
    const int j = i / n_tiles, t = i % n_tiles, h = h0 + j;
    if (t == 0) {
      const uint8_t* qb = q + b * sq.b + h * sq.h;
      uint8_t* dQ = sQ + (j & 1) * kBM * RQ;
      for (int x = tid; x < kBM * CQ; x += kThreads) {
        const int r = x / CQ, ch = x % CQ;
        uint8_t* dst = dQ + r * RQ + ch * 16;
        if (q0 + r < N) {
          cp_async16(dst, qb + (q0 + r) * sq.n + (ch < cq ? ch * 16 : 0), ch < cq ? 16 : 0);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    const int k0 = t * kBN;
    const uint8_t* kb = k + b * sk.b + h * sk.h;
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(v) + b * sv.b + h * sv.h;
    uint8_t* dK = sK + (i & 1) * kBN * RQ;
    uint16_t* dV = sV + (i & 1) * kBN * LV;
    for (int x = tid; x < kBN * CQ; x += kThreads) {
      const int r = x / CQ, ch = x % CQ;
      uint8_t* dst = dK + r * RQ + ch * 16;
      if (k0 + r < n_valid) {
        cp_async16(dst, kb + (k0 + r) * sk.n + (ch < cq ? ch * 16 : 0), ch < cq ? 16 : 0);
      } else {  // never read keys past n_valid
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int x = tid; x < kBN * CV; x += kThreads) {
      const int r = x / CV, ch = x % CV;
      uint16_t* dst = dV + r * LV + ch * 8;
      if (k0 + r < n_valid) {
        cp_async16(dst, vb + (k0 + r) * sv.n + (ch < cv ? ch * 16 : 0), ch < cv ? 16 : 0);
      } else {  // never read values past n_valid
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  uint32_t qf[KC][4];
  float o[DN][4];
  float l[2];
  float c_h = 0.f;

  fetch(0);
  cp_async_commit();
  for (int i = 0; i < total; ++i) {
    const int j = i / n_tiles, t = i % n_tiles;
    const bool ahead = i + 1 < total && (stagger || (i + 1) % n_tiles != 0);
    if (ahead) {
      fetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (t == 0) {  // a new head: its q fragments, fresh accumulators
      const uint8_t* qw = sQ + (j & 1) * kBM * RQ + warp * 16 * RQ;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        qf[kc][0] = ld_u32(qw + g * RQ + kc * 32 + tq * 4);
        qf[kc][1] = ld_u32(qw + (g + 8) * RQ + kc * 32 + tq * 4);
        qf[kc][2] = ld_u32(qw + g * RQ + kc * 32 + 16 + tq * 4);
        qf[kc][3] = ld_u32(qw + (g + 8) * RQ + kc * 32 + 16 + tq * 4);
        if (!kInt8) {  // q' = bf16(f32(q) * scale * log2(e))
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[kc][e] = scale_bf16x2(qf[kc][e], scale_log2);
        }
      }
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
      }
      l[0] = l[1] = 0.f;
      if (kInt8) c_h = c[h0 + j];
    }
    const uint8_t* cK = sK + (i & 1) * kBN * RQ;
    const uint16_t* cV = sV + (i & 1) * kBN * LV;

    // S = Q K^T for this warp's 16 rows x 64 keys, in base 2
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t* kr = cK + (nt * 8 + g) * RQ + tq * 4;
      if (kInt8) {
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          mma_s8(acc, qf[kc], ld_u32(kr + kc * 32), ld_u32(kr + kc * 32 + 16));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = static_cast<float>(acc[e]) * c_h;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          mma_bf16(s[nt], qf[kc], ld_u32(kr + kc * 32), ld_u32(kr + kc * 32 + 16));
        }
      }
    }

    // clamp, mask, exp2 (no max subtraction), row sums of the f32 p
    const int k0 = t * kBN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tq * 2 + (e & 1);
        float x = s[nt][e] > 110.f ? 110.f : s[nt][e];  // NaN passes, as min()
        x = key < n_valid ? x : neg_inf();
        const float p = exp2f(x);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += bf16(P) V; the score accumulators sit in the A-fragment layout
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const uint16_t* vr = cV + (kc * 16 + tq * 2) * LV + g;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const uint16_t* vp = vr + dn * 8;
        mma_bf16(o[dn], pa, pack_u16(vp[0], vp[LV]), pack_u16(vp[8 * LV], vp[9 * LV]));
      }
    }

    if (t == n_tiles - 1) {  // the head is done: o / max(l, 1e-30)
      float lr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 2);
        lr[r] = fmaxf(lr[r], 1e-30f);
      }
      const long long out_sn = static_cast<long long>(H) * dv;
      const int ra = q0 + warp * 16 + g;
      const int rb = ra + 8;
      uint16_t* ob = out + b * static_cast<long long>(N) * out_sn + (h0 + j) * dv;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int col = dn * 8 + tq * 2;
        if (dn * 8 >= dv) break;  // the padded columns are not written
        if (ra < N) {
          *reinterpret_cast<uint32_t*>(ob + ra * out_sn + col) =
              pack_bf16(o[dn][0] / lr[0], o[dn][1] / lr[0]);
        }
        if (rb < N) {
          *reinterpret_cast<uint32_t*>(ob + rb * out_sn + col) =
              pack_bf16(o[dn][2] / lr[1], o[dn][3] / lr[1]);
        }
      }
    }
    __syncthreads();  // the next fetch refills this stage
    if (i + 1 < total && !ahead) {
      fetch(i + 1);
      cp_async_commit();
    }
  }
}

template <int DK, int DV, bool kInt8>
int launch_d(const void* q, const void* k, const void* v, void* out, const float* c,
             Strides sq, Strides sk, Strides sv, int qk_bytes, int dv, int B, int N, int H,
             int n_valid, int G, int stagger, float sl2, cudaStream_t stream) {
  constexpr int RQ = DK * (kInt8 ? 1 : 2) + 16;
  const int smem = 4 * kBM * RQ + 2 * kBN * (DV + 8) * 2;
  cudaFuncSetAttribute(clamp_attention<DK, DV, kInt8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + kBM - 1) / kBM, H / G, B);
  clamp_attention<DK, DV, kInt8><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), c, sq, sk, sv, qk_bytes,
      dv, H, N, n_valid, G, stagger, sl2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int N, int H, int n_valid, int G) {
  return B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N || G <= 0 || H % G;
}

// ------------------------------------------------------------ K8's prologue
constexpr int kPrologueThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

// the largest of eight |bf16| bit patterns (two per 32-bit word)
__device__ __forceinline__ uint32_t max_abs_bits(uint4 x, uint32_t m2) {
  m2 = __vmaxu2(m2, x.x & 0x7fff7fffu);
  m2 = __vmaxu2(m2, x.y & 0x7fff7fffu);
  m2 = __vmaxu2(m2, x.z & 0x7fff7fffu);
  return __vmaxu2(m2, x.w & 0x7fff7fffu);
}

__device__ __forceinline__ uint4 ld_stream(const uint16_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// One block per (head of q or k, batch): blockIdx.y = role * H + h (role 0
// q, 1 k), blockIdx.z = batch. amax[role * H + h]: the max |x| as an f32
// bit pattern, zeroed before the launch. cpr_log2: log2 of D / 8, the
// 16-byte chunks of one head's row.
__global__ void __launch_bounds__(kPrologueThreads)
    amax_qk(const uint16_t* __restrict__ qkv, unsigned* __restrict__ amax, int N, int H, int D,
            int n_valid, int cpr_log2) {
  const int role = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z;
  const long long hd = static_cast<long long>(H) * D;
  const uint16_t* base = qkv + (static_cast<long long>(b) * N * 3 + role) * hd + h * D;
  const int items = n_valid << cpr_log2;
  const int mask = (1 << cpr_log2) - 1;
  uint32_t m2 = 0;
  for (int i0 = threadIdx.x; i0 < items; i0 += kUnroll * kPrologueThreads) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kPrologueThreads;
      x[u] = i < items ? ld_stream(base + (i >> cpr_log2) * 3 * hd + (i & mask) * 8)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m2 = max_abs_bits(x[u], m2);
  }
  unsigned m = max(m2 & 0xffffu, m2 >> 16);
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[kPrologueThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kPrologueThreads / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) atomicMax(&amax[blockIdx.y], m << 16);  // bf16 -> f32 bits
  }
}

// the scale of one head: max(amax, 1e-8) * f32(1/127); NaN stays NaN, as in
// torch.clamp_min and jnp.maximum
__device__ __forceinline__ float head_scale(unsigned amax_bits) {
  const float a = __uint_as_float(amax_bits);
  return (a < 1e-8f ? 1e-8f : a) * (1.0f / 127.0f);
}

__device__ __forceinline__ uint32_t quantize4(uint32_t w0, uint32_t w1, float s) {
  const float x[4] = {__uint_as_float(w0 << 16), __uint_as_float(w0 & 0xffff0000u),
                      __uint_as_float(w1 << 16), __uint_as_float(w1 & 0xffff0000u)};
  uint32_t r = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = fminf(fmaxf(rintf(__fdiv_rn(x[e], s)), -127.f), 127.f);
    r |= (static_cast<uint32_t>(static_cast<int>(y)) & 0xffu) << (8 * e);
  }
  return r;
}

// Grid as amax_qk's. q8, k8: (B, H, N, DP) int8, DP a multiple of 32
// covering D; cpr_log2: log2 of DP / 8 (8-byte output chunks per row);
// c: (H,) f32, scale*log2(e)*qs*ks (sl2 = the f32 scale*log2(e)).
__global__ void __launch_bounds__(kPrologueThreads)
    quantize_qk(const uint16_t* __restrict__ qkv, const unsigned* __restrict__ amax,
                int8_t* __restrict__ q8, int8_t* __restrict__ k8, float* __restrict__ c, int N,
                int H, int D, int DP, int cpr_log2, float sl2) {
  const int role = blockIdx.y / H, h = blockIdx.y % H, b = blockIdx.z;
  const long long hd = static_cast<long long>(H) * D;
  const uint16_t* base = qkv + (static_cast<long long>(b) * N * 3 + role) * hd + h * D;
  int8_t* dst = (role == 0 ? q8 : k8) + (static_cast<long long>(b) * H + h) * N * DP;
  const float s = head_scale(amax[blockIdx.y]);
  if (role == 0 && b == 0 && threadIdx.x == 0) {
    c[h] = sl2 * s * head_scale(amax[H + h]);
  }
  const int items = N << cpr_log2;
  const int mask = (1 << cpr_log2) - 1;
  const int real = D / 8;  // chunks of a row that hold data; the rest is the pad
  for (int i0 = threadIdx.x; i0 < items; i0 += kUnroll * kPrologueThreads) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kPrologueThreads;
      x[u] = i < items && (i & mask) < real  // the pad reads nothing
                 ? ld_stream(base + (i >> cpr_log2) * 3 * hd + (i & mask) * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kPrologueThreads;
      if (i < items) {
        *reinterpret_cast<uint2*>(dst + static_cast<long long>(i) * 8) =
            (i & mask) < real
                ? make_uint2(quantize4(x[u].x, x[u].y, s), quantize4(x[u].z, x[u].w, s))
                : make_uint2(0u, 0u);
      }
    }
  }
}

int log2_of(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return (1 << r) == x ? r : -1;
}

}  // namespace

// K7 at D a multiple of 8 in [8, 128] (the wrapper sends 64 and 80 to the
// wgmma route). qkv: contiguous (B, N, 3, H, D) bf16; out: contiguous
// (B, N, H*D) bf16. heads_per_block: width / D (divides H); stagger: 0 or 1.
// scale_log2_bits: the float scale * log2(e), passed as its 32-bit pattern.
// *route_ran: 1 (mma_sync, the code of vit_attention.cu's route table), set
// before the launch.
extern "C" int mvp_wide_attention(const void* qkv, void* out, int B, int N, int H, int D,
                                  int n_valid, int heads_per_block, int stagger,
                                  int scale_log2_bits, int* route_ran, void* stream) {
  *route_ran = 1;
  if (bad_shape(B, N, H, n_valid, heads_per_block) || D < 8 || D > 128 || D % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float sl2;
  memcpy(&sl2, &scale_log2_bits, sizeof(sl2));
  const long long hd = 2LL * H * D;  // one role's bytes per token
  const Strides s{N * 3 * hd, 2LL * D, 3 * hd};
  const char* base = static_cast<const char*>(qkv);
  const char* q = base;
  const char* k = base + hd;
  const char* v = base + 2 * hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = heads_per_block;
#define MVP_WIDE_CASE(DP)                                                                  \
  case DP:                                                                                 \
    return launch_d<DP, DP, false>(q, k, v, out, nullptr, s, s, s, 2 * D, D, B, N, H,     \
                                   n_valid, G, stagger, sl2, st);
  switch ((D + 15) / 16 * 16) {
    MVP_WIDE_CASE(16)
    MVP_WIDE_CASE(32)
    MVP_WIDE_CASE(48)
    MVP_WIDE_CASE(64)
    MVP_WIDE_CASE(80)
    MVP_WIDE_CASE(96)
    MVP_WIDE_CASE(112)
    MVP_WIDE_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MVP_WIDE_CASE
}

// K8 at D in {8, 16, 32, 128} (the wrapper sends 64 to the wgmma route). q8,
// k8: contiguous (B, H, N, DP) int8 from mvp_quantize_qk (DP: D rounded up
// to a multiple of 32, the pad zero); qkv: contiguous (B, N, 3, H, D) bf16
// (v is read from it); c: (H,) f32 on the device, scale*log2(e)*qs*ks; out:
// contiguous (B, N, H*D) bf16. heads_per_block: width / D (divides H).
// *route_ran: 1 (mma_sync), set before the launch.
extern "C" int mvp_int8_attention(const void* q8, const void* k8, const void* qkv,
                                  const void* c, void* out, int B, int N, int H, int D,
                                  int DP, int n_valid, int heads_per_block, int* route_ran,
                                  void* stream) {
  *route_ran = 1;
  if (bad_shape(B, N, H, n_valid, heads_per_block) || DP != (D + 31) / 32 * 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long hd = static_cast<long long>(H) * D;
  const Strides s8{static_cast<long long>(H) * N * DP, static_cast<long long>(N) * DP, DP};
  const Strides sv{N * 3 * hd * 2, 2LL * D, 3 * hd * 2};
  const char* v = static_cast<const char*>(qkv) + 2 * hd * 2;
  const float* cf = static_cast<const float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = heads_per_block;
  switch (D) {
    case 8:
    case 16:
      return launch_d<32, 16, true>(q8, k8, v, out, cf, s8, s8, sv, DP, D, B, N, H, n_valid,
                                    G, 0, 0.f, st);
    case 32:
      return launch_d<32, 32, true>(q8, k8, v, out, cf, s8, s8, sv, DP, D, B, N, H, n_valid,
                                    G, 0, 0.f, st);
    case 128:
      return launch_d<128, 128, true>(q8, k8, v, out, cf, s8, s8, sv, DP, D, B, N, H,
                                      n_valid, G, 0, 0.f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8's prologue at D in {8, 16, 32, 64, 128}. qkv: contiguous (B, N, 3, H,
// D) bf16; amax: (2 * H,) 32-bit scratch (zeroed here); q8, k8: contiguous
// (B, H, N, DP) int8, DP = D rounded up to a multiple of 32; c: (H,) f32.
// scale_log2_bits: the float scale * log2(e), passed as its 32-bit pattern.
extern "C" int mvp_quantize_qk(const void* qkv, void* amax, void* q8, void* k8, void* c, int B,
                               int N, int H, int D, int DP, int n_valid, int scale_log2_bits,
                               void* stream) {
  const int d_log2 = log2_of(D / 8);
  const int dp_log2 = log2_of(DP / 8);
  if (bad_shape(B, N, H, n_valid, 1) || D % 8 || D > 128 || d_log2 < 0 || dp_log2 < 0 ||
      DP != (D + 31) / 32 * 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float sl2;
  memcpy(&sl2, &scale_log2_bits, sizeof(sl2));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(amax, 0, 2 * sizeof(unsigned) * H, st);
  const dim3 grid(1, 2 * H, B);
  const uint16_t* x = static_cast<const uint16_t*>(qkv);
  amax_qk<<<grid, kPrologueThreads, 0, st>>>(x, static_cast<unsigned*>(amax), N, H, D,
                                             n_valid, d_log2);
  quantize_qk<<<grid, kPrologueThreads, 0, st>>>(
      x, static_cast<const unsigned*>(amax), static_cast<int8_t*>(q8),
      static_cast<int8_t*>(k8), static_cast<float*>(c), N, H, D, DP, dp_log2, sl2);
  return static_cast<int>(cudaGetLastError());
}
