// ViT softmax attention for Hopper (sm_90a), the forward: three kernels
// (routes) behind two entry points, and two more entry points that run the
// attention bench's clamped exp2 attention (launch_script/bench_attn.py: no
// running max) on the wgmma route's kernel in its clamped mode (see that
// route below): mvp_clamp_attention, K7 (`wide_attention`), and
// mvp_int8_attention_wgmma, K8 (`int8_attention`, QK^T in int8).
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
//   * 2, tf32x3: fp32 at every head dim, on the tensor cores with each
//     operand split into two TF32 halves (three products per product), so
//     that the result keeps fp32 accuracy; its design is described above
//     the kernel.
//
// The JAX kernels' max-free exp2 softmax, +110 clamp and 1e-30 normaliser
// floor work around the TPU's vector unit; these kernels use the exact
// max-subtracted online softmax instead.
//
// Head dims: 16, 32, 64, 80, 128.
//
// The backward's residual: the strided entry (K2, K3, K9) writes each row's
// natural logsumexp (m + log2 l, times ln 2, from the online softmax's
// running max and sum) when its caller passes an lse buffer, as the jax
// library's flash forward saves l and m for its backward kernels;
// attention_bwd.cu (K10, K11) reads it. Every frozen launch passes null and
// writes nothing more.
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
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps per block on the mma_sync route
constexpr int kBM = 64;        // mma_sync route: query rows per block (16 per warp)
constexpr int kBN = 64;        // mma_sync route: keys per KV tile

// the natural logsumexp of a row's scores (q' k^T * scale) from the online
// softmax's running max m and sum l, both in base 2 of the scaled scores:
// the residual that attention_bwd.cu's backward reads
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m + log2f(l)) * 0.69314718055994531f;
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
                   float q_scale, float* __restrict__ lse) {
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
  if (lse != nullptr && tq == 0) {
    float* lb = lse + (static_cast<long long>(b) * gridDim.y + h) * N;
    if (ra < N) lb[ra] = row_lse(m[0], l[0]);
    if (rb < N) lb[rb] = row_lse(m[1], l[1]);
  }
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

// tf32x3 route (fp32, every head dim): f32 accuracy from the tensor cores.
// Each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// each product is taken as lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 (the
// dropped lo*lo term is ~2^-22 of the product), for S = Q K^T and for
// O = P V alike. The tensor cores round their f32 accumulation toward zero,
// which biases a long running sum (on the card that alone put the output
// ~1e-5 off at N = 4097): every 16-deep product (two k8 steps) therefore
// starts from a zero accumulator and is added to S or O in f32 with
// round-to-nearest.
//
// The split is the costly part: split in registers, every warp of a block
// split the same K and V tile again (on the card the split alone took half
// of the kernel's time). So a pre-pass (`split_pairs`, mma_sync.cuh) splits
// K and V once into (hi, lo) pairs, in a scratch buffer the caller
// provides, and the attention kernel reads each pair with one 64-bit shared
// load; only Q (once per block) and P (in registers) are split in the kernel.
//
// One block per (q-tile of 112 rows, head, batch): seven consumer warps of
// 16 query rows and one producer warp (eight warps, two per SM
// sub-partition, so that a thread may hold up to 255 registers) that fills
// a kF32Stages-deep ring of K and V pair tiles with cp.async, each stage
// behind a full mbarrier (the producer's copies arrive on it as they land)
// and an empty one (one arrival per consumer warp), so no block barrier is
// taken per tile. Rows are padded to D + 4 pairs (K) and D + 2 pairs (V): the
// 64-bit fragment loads of K (rows g, columns tq) and of V (rows 2tq and
// 2tq + 1, columns g) then touch distinct banks in each half-warp. Q stays
// in registers, pre-scaled and split once per block. The score accumulator
// of an m16n8k8 tile holds keys (2tq, 2tq + 1) where the A fragment of the PV
// product wants (tq, tq + 4): the PV product instead takes keys in the
// order 2tq -> tq, 2tq + 1 -> tq + 4 and reads the V rows in the same
// order, which leaves the sum over keys unchanged and needs no shuffle.
constexpr int kF32Warps = 7;                       // consumer warps
constexpr int kF32Rows = 16 * kF32Warps;           // query rows per block
constexpr int kF32Threads = 32 * (kF32Warps + 1);  // and one producer warp
constexpr int kF32Stages = 2;                      // K/V ring depth

template <int D>
struct F32Tile {
  static constexpr int kKeys = D > 80 ? 32 : 64;  // keys per K/V tile
  static constexpr int kLdK = D + 4;              // padded K row, pairs
  static constexpr int kLdV = D + 2;              // padded V row, pairs
  static constexpr int kPairs = kKeys * (kLdK + kLdV);  // one stage of K and V
  static constexpr int kSmem = kF32Stages * kPairs * 8 + 2 * kF32Stages * 8;
};

// q by element strides; kp, vp: the (hi, lo) pairs of k and v from
// split_pairs, contiguous (B, H, n_valid, D): no key at or past n_valid is
// in them. The rows of a ragged last tile past n_valid keep what an earlier
// tile left in shared memory (finite pairs, or the zeros written below):
// their scores are masked to -inf, so P is 0 there and 0 * V adds nothing.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    attention_tf32x3(const float* __restrict__ q, const float2* __restrict__ kp,
                     const float2* __restrict__ vp, float* __restrict__ out, Strides sq,
                     Strides so, int H, int N, int n_valid, float scale_log2, float q_scale,
                     float* __restrict__ lse) {
  constexpr int KN = F32Tile<D>::kKeys;
  constexpr int LK = F32Tile<D>::kLdK;
  constexpr int LV = F32Tile<D>::kLdV;
  constexpr int STAGE = F32Tile<D>::kPairs;
  constexpr int KS = D / 8;   // k8 steps of Q K^T; n8 tiles of the output
  constexpr int NT = KN / 8;  // n8 tiles of the scores; k8 steps of P V
  extern __shared__ __align__(16) float2 smem_pairs[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_pairs + kF32Stages * STAGE);
  uint64_t* empty = full + kF32Stages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kv_tiles = (n_valid + KN - 1) / KN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full[s], 32);  // one cp.async arrival per producer lane
      mbar_init(&empty[s], kF32Warps);
    }
    fence_barrier_init();
  }
  // rows past n_valid in a ragged last tile: zeros until a copy fills them
  for (int i = threadIdx.x; i < kF32Stages * STAGE; i += kF32Threads) {
    smem_pairs[i] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  if (warp == kF32Warps) {  // producer warp
    constexpr int C2 = D / 2;  // 16-byte chunks (two pairs) per row
    const long long head = (static_cast<long long>(b) * H + h) * n_valid * D;
    int st = 0;
    uint32_t ph = 0;
    for (int j = 0; j < kv_tiles; ++j) {
      mbar_wait(&empty[st], ph ^ 1);
      const int k0 = j * KN;
      const int rows = n_valid - k0 < KN ? n_valid - k0 : KN;
      float2* dK = smem_pairs + st * STAGE;
      float2* dV = dK + KN * LK;
      for (int i = lane; i < rows * C2; i += 32) {
        const int r = i / C2, c = i % C2;
        const long long src = head + static_cast<long long>(k0 + r) * D + 2 * c;
        cp_async16(dK + r * LK + 2 * c, kp + src);
        cp_async16(dV + r * LV + 2 * c, vp + src);
      }
      cp_async_arrive(&full[st]);
      if (++st == kF32Stages) {
        st = 0;
        ph ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warps: rows r0 and r0 + 8 of this thread's fragments
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = blockIdx.x * kF32Rows + warp * 16 + g;
  const float* qb = q + b * sq.b + h * sq.h;
  uint32_t q_hi[KS][4], q_lo[KS][4];  // A fragments of Q' = q * q_scale * scale_log2
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1);
      const int col = 8 * kk + tq + 4 * (e >> 1);
      const float x = row < N ? qb[row * sq.n + col] * q_scale * scale_log2 : 0.f;
      split_tf32(x, q_hi[kk][e], q_lo[kk][e]);
    }
  }
  float o[KS][4];
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  float m[2] = {neg_inf(), neg_inf()};  // running row max (rows r0, r0 + 8)
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums

  int st = 0;
  uint32_t ph = 0;
  for (int j = 0; j < kv_tiles; ++j) {
    mbar_wait(&full[st], ph);
    const float2* cK = smem_pairs + st * STAGE;
    const float2* cV = cK + KN * LK;

    // S = Q' K^T (base 2): 16 rows x KN keys, 16 columns of d at a time
    float s[NT][4];
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2* kr = cK + (nt * 8 + g) * LK + kk * 8 + tq;
        float t[4];
        mma_3xtf32<true>(t, q_hi[kk], q_lo[kk], kr[0], kr[4]);
        mma_3xtf32<false>(t, q_hi[kk + 1], q_lo[kk + 1], kr[8], kr[12]);
        if (kk == 0) {
          add_f32<true>(s[nt], t);
        } else {
          add_f32<false>(s[nt], t);
        }
      }
    }

    // mask keys past n_valid, online softmax update
    const int k0 = j * KN;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tq * 2 + (e & 1);
        if (key >= n_valid) s[nt][e] = neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
    for (int dn = 0; dn < KS; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V, 16 keys at a time; keys 2tq and 2tq + 1 of each 8-key step
    // in the A fragment's positions tq and tq + 4
#pragma unroll
    for (int kc = 0; kc < NT; kc += 2) {
      uint32_t p_hi[2][4], p_lo[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        split_tf32(s[kc + c][0], p_hi[c][0], p_lo[c][0]);  // row g,     key 2tq
        split_tf32(s[kc + c][2], p_hi[c][1], p_lo[c][1]);  // row g + 8, key 2tq
        split_tf32(s[kc + c][1], p_hi[c][2], p_lo[c][2]);  // row g,     key 2tq + 1
        split_tf32(s[kc + c][3], p_hi[c][3], p_lo[c][3]);  // row g + 8, key 2tq + 1
      }
      const float2* vr = cV + (kc * 8 + 2 * tq) * LV + g;
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        float t[4];
        mma_3xtf32<true>(t, p_hi[0], p_lo[0], vr[dn * 8], vr[LV + dn * 8]);
        mma_3xtf32<false>(t, p_hi[1], p_lo[1], vr[8 * LV + dn * 8], vr[9 * LV + dn * 8]);
        add_f32<false>(o[dn], t);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    if (++st == kF32Stages) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (lse != nullptr && tq == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * N;
    if (r0 < N) lb[r0] = row_lse(m[0], l[0]);
    if (r0 + 8 < N) lb[r0 + 8] = row_lse(m[1], l[1]);
  }
  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
    const int col = dn * 8 + tq * 2;
    if (r0 < N) {
      *reinterpret_cast<float2*>(ob + r0 * so.n + col) =
          make_float2(o[dn][0] / l[0], o[dn][1] / l[0]);
    }
    if (r0 + 8 < N) {
      *reinterpret_cast<float2*>(ob + (r0 + 8) * so.n + col) =
          make_float2(o[dn][2] / l[1], o[dn][3] / l[1]);
    }
  }
}

// ---------------------------------------------------------------- wgmma route
// bf16 at d = 64 and d = 80, in two softmax modes (kClamp, a template
// argument): the exact max-subtracted online softmax (K1, K2, K3, K9), and
// the attention bench's clamped exp2 attention (K7, `wide_attention`:
// s = min(q'k^T, 110), p = exp2(s) with no running max and so no rescale of
// the accumulators, l = max(sum of the f32 p, 1e-30), o = (bf16(p) v) / l;
// q' = bf16(q * scale * log2(e)) is the q_scale pass below with scale_log2
// unused), and that mode with QK^T in int8 (K8, kInt8, described above the
// kernel). A persistent block walks work items of 128 query rows of one
// (batch, head): units of G heads of one query tile (G = 1 but for K7's and K8's
// width / d), the query tile fastest so that concurrent blocks share K and V
// in L2, a unit's G heads in turn. Warpgroups 0 and 1 consume 64 query rows each;
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
// only. G: heads per unit of the walk (divides H; 1 but in the clamped mode,
// where it is a compile-time 1 so that the exact mode's walk is a plain
// grid-stride loop).
//
// kInt8 (with kClamp, at d = 64): K8, the clamped mode with QK^T in int8.
// q and k arrive as the prologue's head-major int8 (B, H, N, 64) tensors:
// tiles of 128 rows of 64 bytes (8 KB) through maps with 64-byte swizzle,
// K-major for both operands (8-bit wgmma cannot transpose), V as in the
// bf16 modes. S = Q K^T is wgmma m64n128k32 s8 x s8 -> s32, two k32 steps;
// |s32| <= 64 * 127^2 < 2^22, so int_as_float(s32 + 0x4B400000) - 1.5*2^23
// is f32(s32) exactly, on the integer and FMA pipes (I2F would share the
// quarter-rate unit with exp2); then times c[h] (`c`, read in this mode
// only), clamp and mask as the clamped mode, and exp2 as the MUFU computes
// it, subnormal results flushed to 0 (ex2.approx.ftz; exp2f adds a rescale
// around it for them: a p below 2^-126 moves an output by at most n_valid *
// 2^-126 * max|v| / max(l, 1e-30), 1.4e-5 * max|v| at the bench's 1201).
// The exp2s, not the tensor cores, bound K8 (one per score at 16 a clock
// per SM against int8 QK^T at twice the bf16 rate), so the mode has its own
// tile loop: one commit group per tile (the previous tile's PV and this
// tile's QK^T) and the two consumer warpgroups taking turns to issue it, so
// that one's exp2s run while the tensor cores serve the other.
template <int D, bool kClamp, bool kInt8 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    attention_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap tail_q,
                    const __grid_constant__ CUtensorMap tail_k,
                    const __grid_constant__ CUtensorMap tail_v, uint16_t* __restrict__ out,
                    Strides so, int B, int N, int H, int n_valid, int G, int tok_inner,
                    float scale_log2, float q_scale, const float* __restrict__ c,
                    float* __restrict__ lse) {
  static_assert(!kInt8 || (kClamp && D == 64), "the int8 mode is K8's: clamped, d = 64");
  constexpr int kTail = WgTile<D>::kTail;
  constexpr int kTileBytes = WgTile<D>::kBytes;  // one V tile (and Q or K but in int8)
  constexpr int kQKBytes = kInt8 ? kQRows * 64 : kTileBytes;  // one Q or K tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;                       // [2] tiles
  uint8_t* sK = sQ + 2 * kQKBytes;          // [kKvStages] tiles
  uint8_t* sV = sK + kKvStages * kQKBytes;  // [kKvStages] tiles
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
  const int heads = kClamp ? G : 1;  // per unit of the walk
  const int units = q_tiles * (H / heads) * B;

  if (tid >= 2 * 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      int qs = 0, st = 0;
      uint32_t qph = 0, ph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int qt = u % q_tiles;
        const int h0 = (u / q_tiles) % (H / heads) * heads;
        const int b = u / (q_tiles * (H / heads));
        for (int h = h0; h < h0 + heads; ++h) {
          mbar_wait(&q_empty[qs], qph ^ 1);
          mbar_expect_tx(&q_full[qs], kQKBytes);
          load_tile<D>(sQ + qs * kQKBytes, &map_q, &tail_q, &q_full[qs], qt * kQRows, h, b,
                       tok_inner & 1);
          if (++qs == 2) {
            qs = 0;
            qph ^= 1;
          }
          for (int j = 0; j < kv_tiles; ++j) {
            mbar_wait(&kv_empty[st], ph ^ 1);
            mbar_expect_tx(&k_full[st], kQKBytes);
            load_tile<D>(sK + st * kQKBytes, &map_k, &tail_k, &k_full[st], j * kKeys, h, b,
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
    if (kInt8 && wg == 1) named_barrier_arrive(3, 256);  // warpgroup 0 issues first
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int qt = u % q_tiles;
      const int h0 = (u / q_tiles) % (H / heads) * heads;
      const int b = u / (q_tiles * (H / heads));
      for (int h = h0; h < h0 + heads; ++h) {
        // this warpgroup's 64 rows: 8 KB of the main part, 2 KB of the tail
        // (int8: 4 KB)
        uint8_t* q_rows = sQ + qs * kQKBytes + wg * (kInt8 ? 64 * 64 : 64 * 128);
        uint8_t* q_tail = sQ + qs * kQKBytes + kMainBytes + wg * (64 * 2 * kTail);
        const float c_h = kInt8 ? c[h] : 0.f;
        mbar_wait(&q_full[qs], qph);
        if (!kInt8 && q_scale != 1.f) {  // q <- bf16(f32(q) * q_scale), once per item
          uint4* p = reinterpret_cast<uint4*>(q_rows) + (tid & 127) * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) scale_16_bytes(p + i, q_scale);
          if (kTail) scale_16_bytes(reinterpret_cast<uint4*>(q_tail) + (tid & 127), q_scale);
          fence_proxy_async();
          named_barrier(1 + wg, 128);
        }
        const uint64_t dq = kInt8 ? smem_desc<2>(smem_u32(q_rows), 16, 512)
                                  : smem_desc(smem_u32(q_rows), 16, 1024);
        const uint64_t dq_tail = smem_desc<3>(smem_u32(q_tail), 16, 256);

        float o[32];       // output columns 0-63
        float o_tail[8];   // output columns 64-79 (d = 80)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) o_tail[i] = 0.f;
        // running row max (rows g and g+8); the clamped mode subtracts none
        float m[2] = {kClamp ? 0.f : neg_inf(), kClamp ? 0.f : neg_inf()};
        float l[2] = {0.f, 0.f};  // this thread's share of the row sums

        if constexpr (kInt8) {
          // One commit group per tile: O += P V of the previous tile and
          // S = Q K^T of this one, then one wait (the first tile's group has
          // no PV, a last group no QK^T). The two consumer warpgroups take
          // turns to issue their groups (named barriers 3 and 4: a
          // warpgroup waits for its turn and hands the next one to the other
          // right after its issue), so that the tensor cores run one
          // warpgroup's products while the other computes its exp2.
          uint32_t acc[64];   // S of the current tile, s32
          uint32_t pa[8][4];  // P of the previous tile, the A fragments of its PV
          int st_prev = 0;
          uint32_t ph_prev = 0;
          auto turn = [&]() {
            named_barrier(3 + wg, 256);
            fence_operands(o);
            wgmma_fence();
          };
          auto issue_pv = [&]() {
            mbar_wait(&v_full[st_prev], ph_prev);
            const uint64_t dv = smem_desc(smem_u32(sV + st_prev * kTileBytes), 16, 1024);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs<1>(o, pa[kk], dv + 128 * kk, 1);
          };
          auto issue_qk = [&]() {
            mbar_wait(&k_full[st], ph);
            const uint64_t dk = smem_desc<2>(smem_u32(sK + st * kQKBytes), 16, 512);
            wgmma_m64n128k32_s8_ss(acc, dq, dk, 0);
            wgmma_m64n128k32_s8_ss(acc, dq + 2, dk + 2, 1);  // +32 bytes
          };
          auto hand_over_and_wait = [&]() {
            wgmma_commit();
            named_barrier_arrive(3 + (wg ^ 1), 256);
            wgmma_wait<0>();
            fence_operands(o);
            fence_operands(acc);
          };
          // f32(s32) * c[h], clamp at 110, mask keys past n_valid, exp2 (the
          // MUFU's, subnormal results flushed to 0), row sums, bf16(P)
          auto softmax = [&](int j) {
            if (j == kv_tiles - 1 && lane == 0) mbar_arrive(&q_empty[qs]);  // Q read
            const int k0 = j * kKeys;
            const bool ragged = k0 + kKeys > n_valid;
            float rs[2] = {0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float p[2];
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                  const int i = 8 * kk + 2 * e + t;
                  const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
                  float x = (__int_as_float(static_cast<int>(acc[i]) + 0x4B400000) -
                             12582912.f) * c_h;
                  x = x > 110.f ? 110.f : x;  // NaN passes, as min()
                  x = ragged && key >= n_valid ? neg_inf() : x;
                  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p[t]) : "f"(x));
                }
                rs[e & 1] += p[0] + p[1];
                pa[kk][e] = pack_bf16(p[0], p[1]);
              }
            }
            l[0] += rs[0];
            l[1] += rs[1];
            st_prev = st;
            ph_prev = ph;
            if (++st == kKvStages) {
              st = 0;
              ph ^= 1;
            }
          };
          turn();
          issue_qk();
          hand_over_and_wait();
          softmax(0);
          for (int j = 1; j < kv_tiles; ++j) {
            turn();
            issue_pv();
            issue_qk();
            hand_over_and_wait();
            if (lane == 0) mbar_arrive(&kv_empty[st_prev]);
            softmax(j);
          }
          turn();
          issue_pv();
          hand_over_and_wait();
          if (lane == 0) mbar_arrive(&kv_empty[st_prev]);
        } else {
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
              wgmma_m64n128k16_ss<0>(
                  s, dq_tail, smem_desc<3>(smem_u32(k_tile + kMainBytes), 16, 256), 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_operands(s);
            // Q read for the last time
            if (j == kv_tiles - 1 && lane == 0) mbar_arrive(&q_empty[qs]);

            const int k0 = j * kKeys;
            const bool ragged = k0 + kKeys > n_valid;
            float alpha[2];
            if constexpr (kClamp) {
              // clamp at 110 (q' is in base 2 already), mask keys past n_valid;
              // no running max: m stays 0 and alpha 1
#pragma unroll
              for (int i = 0; i < 64; ++i) {
                const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
                const float x = s[i] > 110.f ? 110.f : s[i];  // NaN passes, as min()
                s[i] = ragged && key >= n_valid ? neg_inf() : x;
              }
              alpha[0] = alpha[1] = 1.f;
            } else {
              // scale to base 2, mask keys past n_valid, online softmax update
              float mx[2] = {m[0], m[1]};
#pragma unroll
              for (int i = 0; i < 64; ++i) {
                const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
                const float x = ragged && key >= n_valid ? neg_inf() : s[i] * scale_log2;
                s[i] = x;
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
              }
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                alpha[r] = exp2f(m[r] - mx[r]);
                m[r] = mx[r];
              }
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
            if constexpr (!kClamp) {
#pragma unroll
              for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
              if (kTail) {
#pragma unroll
                for (int i = 0; i < 8; ++i) o_tail[i] *= alpha[(i >> 1) & 1];
              }
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
        }

        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          if (kClamp) l[r] = fmaxf(l[r], 1e-30f);  // a row of underflows gets o = 0
          inv[r] = 1.f / l[r];
        }
        // the output of row r (0: g, 1: g + 8); the clamped mode divides
        auto fin = [&](float x, int r) { return kClamp ? x / l[r] : x * inv[r]; };
        const long long ra = static_cast<long long>(qt) * kQRows + wg * 64 + warp * 16 + g;
        if (!kClamp && lse != nullptr && tq == 0) {
          float* lb = lse + (static_cast<long long>(b) * H + h) * N;
          if (ra < N) lb[ra] = row_lse(m[0], l[0]);
          if (ra + 8 < N) lb[ra + 8] = row_lse(m[1], l[1]);
        }
        uint16_t* oa = out + b * so.b + h * so.h + ra * so.n + tq * 2;
        uint16_t* ob = oa + 8 * so.n;
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          if (ra < N) {
            *reinterpret_cast<uint32_t*>(oa + dn * 8) =
                pack_bf16(fin(o[4 * dn], 0), fin(o[4 * dn + 1], 0));
          }
          if (ra + 8 < N) {
            *reinterpret_cast<uint32_t*>(ob + dn * 8) =
                pack_bf16(fin(o[4 * dn + 2], 1), fin(o[4 * dn + 3], 1));
          }
        }
#pragma unroll
        for (int dn = 0; dn < kTail / 8; ++dn) {
          if (ra < N) {
            *reinterpret_cast<uint32_t*>(oa + 64 + dn * 8) =
                pack_bf16(fin(o_tail[4 * dn], 0), fin(o_tail[4 * dn + 1], 0));
          }
          if (ra + 8 < N) {
            *reinterpret_cast<uint32_t*>(ob + 64 + dn * 8) =
                pack_bf16(fin(o_tail[4 * dn + 2], 1), fin(o_tail[4 * dn + 3], 1));
          }
        }
        if (++qs == 2) {
          qs = 0;
          qph ^= 1;
        }
      }
    }
    if (kInt8 && wg == 0) named_barrier(3, 256);  // the last hand-over of warpgroup 1
  }
}

template <int D>
void launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                 Strides sk, Strides sv, Strides so, int B, int N, int H, int n_valid,
                 float sl2, float q_scale, float* lse, cudaStream_t stream) {
  const int smem = (kBM + 4 * kBN) * (D + 8) * static_cast<int>(sizeof(uint16_t));
  cudaFuncSetAttribute(attention_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N + kBM - 1) / kBM, H, B);
  attention_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), sq, sk, sv, so, N,
      n_valid, sl2, q_scale, lse);
}

// the pre-pass over k and v into `pairs` (2 * B*H*n_valid*D float2: k's
// pairs, then v's), then the attention kernel
template <int D>
void launch_tf32x3(const void* q, const void* k, const void* v, void* out, void* pairs,
                   Strides sq, Strides sk, Strides sv, Strides so, int B, int N, int H,
                   int n_valid, float sl2, float q_scale, float* lse, cudaStream_t stream) {
  float2* kp = static_cast<float2*>(pairs);
  float2* vp = kp + static_cast<long long>(B) * H * n_valid * D;
  const int sms = sm_count();
  launch_split_pairs(static_cast<const float*>(k), sk, kp, B, H, n_valid, D, sms, stream);
  launch_split_pairs(static_cast<const float*>(v), sv, vp, B, H, n_valid, D, sms, stream);
  constexpr int smem = F32Tile<D>::kSmem;
  cudaFuncSetAttribute(attention_tf32x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((N + kF32Rows - 1) / kF32Rows, H, B);
  attention_tf32x3<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), kp, vp, static_cast<float*>(out), sq, so, H, N, n_valid,
      sl2, q_scale, lse);
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

// the persistent launch of attention_wgmma over the encoded maps
template <int D, bool kClamp, bool kInt8 = false>
int run_wgmma(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
              const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* out,
              Strides so, int B, int N, int H, int n_valid, int G, int tok_inner, float sl2,
              float q_scale, const float* c, float* lse, cudaStream_t stream) {
  const long long units = static_cast<long long>((N + kQRows - 1) / kQRows) * (H / G) * B;
  const int sms = sm_count();
  constexpr int smem = WgTile<D>::kSmem;
  cudaFuncSetAttribute(attention_wgmma<D, kClamp, kInt8>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attention_wgmma<D, kClamp, kInt8>
      <<<units < sms ? static_cast<int>(units) : sms, kWgThreads, smem, stream>>>(
          mq, mk, mv, tq, tk, tv, static_cast<uint16_t*>(out), so, B, N, H, n_valid, G,
          tok_inner, sl2, q_scale, c, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kClamp = false>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, Strides sq,
                 Strides sk, Strides sv, Strides so, int B, int N, int H, int n_valid,
                 float sl2, float q_scale, float* lse, cudaStream_t stream, int G = 1) {
  // fresh maps on every call: the caching allocator hands the same pointers
  // out again with other shapes
  CUtensorMap mq, mk, mv, tq, tk, tv;
  bool inner_q, inner_k, inner_v;
  int err = encode_operand(&mq, &tq, q, sq, B, H, N, D, N, &inner_q);
  if (err == 0) err = encode_operand(&mk, &tk, k, sk, B, H, N, D, n_valid, &inner_k);
  if (err == 0) err = encode_operand(&mv, &tv, v, sv, B, H, N, D, n_valid, &inner_v);
  if (err != 0) return err;
  return run_wgmma<D, kClamp>(mq, mk, mv, tq, tk, tv, out, so, B, N, H, n_valid, G,
                              int(inner_q) | (int(inner_k) << 1) | (int(inner_v) << 2), sl2,
                              q_scale, nullptr, lse, stream);
}

// The 4-D tensor map of a contiguous head-major (B, H, N, 64) int8 operand
// with `rows` tokens: dims (bytes, token, head, batch), box 128 tokens of
// one head, 64-byte swizzle.
int encode_int8_operand(CUtensorMap* map, const void* base, int B, int H, int N, int rows) {
  const uint64_t dims[4] = {64, static_cast<uint64_t>(rows), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {64, 64ull * N, 64ull * N * H};
  const uint32_t box[4] = {64, 128, 1, 1};
  return encode_tensor_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

// the routes' codes, as reported through route_ran
constexpr int kRouteWgmma = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteTf32x3 = 2;

int route_of(int D, int is_bf16) {
  if (!is_bf16) return kRouteTf32x3;
  return D == 64 || D == 80 ? kRouteWgmma : kRouteMmaSync;
}

int launch(const void* q, const void* k, const void* v, void* out, void* pairs, void* lse_out,
           Strides sq, Strides sk, Strides sv, Strides so, int B, int N, int H, int D,
           int n_valid, int scale_log2_bits, int q_scale_bits, int is_bf16, int* route_ran,
           void* stream) {
  float sl2, q_scale;
  memcpy(&sl2, &scale_log2_bits, sizeof(sl2));
  memcpy(&q_scale, &q_scale_bits, sizeof(q_scale));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int route = route_of(D, is_bf16);
  *route_ran = route;
  if (route == kRouteTf32x3 && pairs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma) {
    return D == 64
        ? launch_wgmma<64>(q, k, v, out, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, lse,
                           st)
        : launch_wgmma<80>(q, k, v, out, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, lse,
                           st);
  }
#define MVP_ATTN_CASE(DIM, LAUNCH)                                                      \
  case DIM:                                                                             \
    LAUNCH<DIM>(q, k, v, out, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, lse, st); \
    break;
  if (route == kRouteMmaSync) {
    switch (D) {
      MVP_ATTN_CASE(16, launch_bf16)
      MVP_ATTN_CASE(32, launch_bf16)
      MVP_ATTN_CASE(128, launch_bf16)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
#define MVP_TF32_CASE(DIM)                                                                 \
  case DIM:                                                                                \
    launch_tf32x3<DIM>(q, k, v, out, pairs, sq, sk, sv, so, B, N, H, n_valid, sl2, q_scale, \
                       lse, st);                                                           \
    break;
    switch (D) {
      MVP_TF32_CASE(16)
      MVP_TF32_CASE(32)
      MVP_TF32_CASE(64)
      MVP_TF32_CASE(80)
      MVP_TF32_CASE(128)
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef MVP_TF32_CASE
  }
#undef MVP_ATTN_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. qkv: contiguous (B, N, 3, H, D); out: contiguous (B, N, H*D), same
// dtype (is_bf16: 1 bfloat16, 0 float32). pairs: float32's scratch for the
// (hi, lo) pairs of k and v, 2 * B*H*n_valid*D float2 (null for bfloat16).
// scale_log2_bits: the float softmax scale * log2(e), passed as its 32-bit
// pattern. *route_ran: the route taken (0 wgmma, 1 mma_sync, 2 tf32x3), set
// before the launch.
extern "C" int mvp_fused_qkv_attention(const void* qkv, void* out, void* pairs, int B, int N,
                                       int H, int D, int n_valid, int scale_log2_bits,
                                       int is_bf16, int* route_ran, void* stream) {
  const long long hd = static_cast<long long>(H) * D;
  const Strides in{N * 3 * hd, D, 3 * hd};
  const Strides so{N * hd, D, hd};
  const size_t esize = is_bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const float one = 1.f;
  int one_bits;
  memcpy(&one_bits, &one, sizeof(one_bits));
  return launch(base, base + hd * esize, base + 2 * hd * esize, out, pairs, nullptr, in, in, in,
                so, B, N, H, D, n_valid, scale_log2_bits, one_bits, is_bf16, route_ran, stream);
}

// K2. q, k, v, out: (B, H, N, D) by element strides (batch, head, token),
// last dimension contiguous, every row 16-byte aligned; same dtype. Keys and
// values at index >= n_valid (1 <= n_valid <= N) are excluded: K2 and K3
// pass N; the bench's splash route (K9) passes its count of valid keys.
// q_scale_bits: the float q_scale (q is taken as q * q_scale, rounded to
// q's dtype, before the scores; 1 for K2 and K3, the softmax scale for K9).
// pairs, is_bf16 and route_ran as for K1. lse: null, or a contiguous
// (B, H, N) f32 output for every row's natural logsumexp of its scores
// (q' k^T * scale over the keys < n_valid), the residual of the backward
// (attention_bwd.cu); null on every frozen launch.
extern "C" int mvp_vit_attention(const void* q, const void* k, const void* v, void* out,
                                 void* pairs, void* lse, int B, int N, int H, int D,
                                 int n_valid,
                                 long long q_sb, long long q_sh, long long q_sn,
                                 long long k_sb, long long k_sh,
                                 long long k_sn, long long v_sb, long long v_sh,
                                 long long v_sn, long long o_sb, long long o_sh,
                                 long long o_sn, int scale_log2_bits, int q_scale_bits,
                                 int is_bf16, int* route_ran, void* stream) {
  return launch(q, k, v, out, pairs, lse, Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn},
                Strides{v_sb, v_sh, v_sn}, Strides{o_sb, o_sh, o_sn}, B, N, H, D, n_valid,
                scale_log2_bits, q_scale_bits, is_bf16, route_ran, stream);
}

// K8 on the wgmma route (the attention bench's `int8_attention` at d = 64;
// csrc/bench_attn.cu keeps d = 8, 16, 32 and 128 on mma_sync): the clamped
// exp2 attention with QK^T in int8. q8, k8: contiguous (B, H, N, 64) int8
// from bench_attn.cu's mvp_quantize_qk; qkv: contiguous (B, N, 3, H, 64)
// bf16 (v is read from it); c: (H,) f32 on the device, scale*log2(e)*qs*ks;
// out: contiguous (B, N, H*64) bf16. heads_per_block: width / 64 (divides
// H), as for K7. *route_ran: 0 (wgmma), set before the launch.
extern "C" int mvp_int8_attention_wgmma(const void* q8, const void* k8, const void* qkv,
                                        const void* c, void* out, int B, int N, int H, int D,
                                        int n_valid, int heads_per_block, int* route_ran,
                                        void* stream) {
  *route_ran = kRouteWgmma;
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N || heads_per_block <= 0 ||
      H % heads_per_block || D != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long hd = static_cast<long long>(H) * D;
  const Strides in{N * 3 * hd, D, 3 * hd};
  const Strides so{N * hd, D, hd};
  CUtensorMap mq, mk, mv, tv;
  bool inner_v;
  int err = encode_int8_operand(&mq, q8, B, H, N, N);
  if (err == 0) err = encode_int8_operand(&mk, k8, B, H, N, n_valid);
  if (err == 0) {
    err = encode_operand(&mv, &tv, static_cast<const uint16_t*>(qkv) + 2 * hd, in, B, H, N, D,
                         n_valid, &inner_v);
  }
  if (err != 0) return err;
  // the tail maps are unread at d = 64; q8 and k8 are token-inner
  return run_wgmma<64, true, true>(mq, mk, mv, mq, mk, tv, out, so, B, N, H, n_valid,
                                   heads_per_block, 3 | (int(inner_v) << 2), 1.f, 1.f,
                                   static_cast<const float*>(c), nullptr,
                                   static_cast<cudaStream_t>(stream));
}

// K7 on the wgmma route (the attention bench's `wide_attention` at d = 64
// and 80; csrc/bench_attn.cu keeps d = 32 and 128 on mma_sync): the clamped
// exp2 attention. qkv: contiguous (B, N, 3, H, D) bf16; out: contiguous
// (B, N, H*D) bf16. heads_per_block: width / D (divides H), the G heads of
// one query tile that a block walks in turn (the TPU kernel's heads per
// kernel instance); the TPU kernel's `stagger` (loading the next head's
// tiles while the current one is consumed) has no argument here: the
// producer warpgroup always runs ahead across heads. scale_log2_bits: the
// float scale * log2(e); *route_ran: 0 (wgmma), set before the launch.
extern "C" int mvp_clamp_attention(const void* qkv, void* out, int B, int N, int H, int D,
                                   int n_valid, int heads_per_block, int scale_log2_bits,
                                   int* route_ran, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || n_valid <= 0 || n_valid > N || heads_per_block <= 0 ||
      H % heads_per_block || (D != 64 && D != 80)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float q_scale;  // q' = bf16(q * scale * log2(e)): the scores are in base 2
  memcpy(&q_scale, &scale_log2_bits, sizeof(q_scale));
  const long long hd = static_cast<long long>(H) * D;
  const Strides in{N * 3 * hd, D, 3 * hd};
  const Strides so{N * hd, D, hd};
  const uint16_t* base = static_cast<const uint16_t*>(qkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *route_ran = kRouteWgmma;
  return D == 64 ? launch_wgmma<64, true>(base, base + hd, base + 2 * hd, out, in, in, in, so,
                                          B, N, H, n_valid, 1.f, q_scale, nullptr, st,
                                          heads_per_block)
                 : launch_wgmma<80, true>(base, base + hd, base + 2 * hd, out, in, in, in, so,
                                          B, N, H, n_valid, 1.f, q_scale, nullptr, st,
                                          heads_per_block);
}
