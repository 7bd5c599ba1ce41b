// Online-softmax attention with GQA (K5), for head dims 16, 64 and 128.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::flash_attention
// (body _kernel).  For q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], group
// G = Hq / Hkv, query head h reading KV head h / G:
//
//   s[r, c]   = D^-0.5 (q[r] . k[c])            products and sums in f32
//   s[r, c]   = -1e30 where causal and r < c    (the mask row >= col, aligned
//                                                top-left as the TPU kernel's)
//   out[r]    = sum_c exp(s[r, c] - m[r]) v[c] / max(l[r], 1e-30)
//
// with m the row max and l the row sum, accumulated online in f32 and the
// output rounded once to the input type.  A masked score contributes
// exp(-1e30 - m) = 0, exactly as in the TPU kernel's blocks, so skipping key
// tiles above the diagonal computes the same function.  Every row sees key
// 0, so m is finite after the first tile.  Sq and Sk are any lengths (the
// TPU wrapper's block divisibility is a tiling detail, not the function).
//
// Bound on the card.  A causal prefill at Sq = Sk = S does 4 B Hq D S(S+1)/2
// operations (QK^T and PV) on 2 B (Hq + 2 Hkv) S D-element reads and
// writes: at B=8, Hq=32, S=4096, D=64 that is 0.55 TFLOP against 0.34 GB,
// 0.56 ms at 989 TFLOP/s (bf16 tensor cores) and 0.10 ms at 3.35 TB/s:
// operations bound it.  A decode step (Sq = 1) reads the whole K/V prefix
// once for the G query heads of a group: bytes bound it (68 MB, 0.02 ms, at
// B=8, Hkv=8, Sk=4097, D=64).
//
// Design.
//  * bf16 prefill (Sq > 1), on the tensor cores (FlashAttention-2's shape,
//    mma.sync m16n8k16 bf16 -> f32).  One CTA of 8 warps per (128-row query
//    tile, query head, batch); each warp owns 16 rows.  The Q tile is
//    staged once by cp.async and held in registers as A fragments
//    (ldmatrix).  K/V tiles of 64 keys are double-buffered in shared memory
//    by 16-byte cp.async, rows padded by 16 bytes so that the 8 row
//    addresses of each ldmatrix fall in 8 distinct bank groups; K feeds
//    QK^T through ldmatrix, V feeds PV through ldmatrix.trans.  S
//    accumulates in f32 and is scaled there by D^-0.5 log2(e) (exp2 in
//    place of exp; at D = 128 the scale is no power of two, so it is not
//    folded into a bf16 q).  The per-row (m, l) live in registers; P is
//    rounded to bf16 in registers and fed straight back as the A operand
//    of PV; O accumulates in f32.  Causal CTAs stop at the diagonal, warps
//    skip tiles wholly above their rows and mask only the tiles that cross
//    them; query tiles run heaviest first (reverse order on the slowest
//    grid axis) to even out the causal imbalance.  Registers: O D/2, S 32,
//    Q D/4 a thread (ptxas: D = 128 215, one CTA an SM; D = 64 held to 128
//    for two CTAs an SM, spilling 56 bytes, which ran faster on the H100
//    than one CTA an SM without the spill).  Each warp reads the whole K
//    and V tile through ldmatrix for its 16 rows: at 128 B a clock per SM
//    that shared-memory traffic takes about twice the tile's mma time, so
//    this form stops near half the tensor-core peak; wgmma (one read per
//    64-row warpgroup, B straight from shared memory) is the next step.
//  * f32 prefill, on the CUDA cores (TF32 cannot hold the 2e-5 check):
//    64 query rows a CTA, each row split over max(1, D/32) adjacent
//    threads that own interleaved float4 slices of q and of the f32
//    accumulator and combine their partial dots by shuffles; K/V tiles of
//    32 keys staged in shared memory as f32.  Speed is not its aim.
//  * Decode (Sq = 1), both types, split over the keys ("flash-decoding"):
//    one CTA per (key chunk, up to 8 query heads of a KV group, KV head,
//    batch).  It reads its chunk once, in double-buffered 16-byte cp.async
//    tiles, for all its query heads (scores: each key's D split over 2 or
//    4 adjacent lanes, so the work follows the heads the group has; P.V:
//    each thread 8 dims of one head over a share of the keys), on the CUDA
//    cores in f32 (bytes bound it), and writes a partial (m, l, acc[D])
//    in f32 to scratch the wrapper allocates; a second kernel merges the
//    partials of each (batch, head) in chunk order.  No atomics: the
//    output is the same bit for bit from run to run.  The wrapper sizes
//    the chunks so that about 8 x 132 CTAs run.
//  * All forms take element strides for the batch, head and sequence axes
//    (the D axis is unit-stride), so decode reads the cache prefix as a
//    view.  16-byte loads need a 16-byte-aligned base and those strides in
//    whole 16-byte units; the wrapper copies an operand that lacks either.
//  * Offsets are 64-bit.  The output is contiguous [B, Hq, Sq, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // elements; the D axis has stride 1
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ------------------------------------------------------------ small helpers
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as a cast in torch / JAX
}

// 16 bytes of T at p (shared memory) as f32
__device__ __forceinline__ void load16_f32(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16_f32(const bf16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------- bf16 prefill (mma.sync)
template <int D>
struct PrefillBf16 {
  static constexpr int BQ = 128;       // query rows a CTA, 16 a warp
  static constexpr int BK = 64;        // keys a tile
  static constexpr int THREADS = 256;  // 8 warps
  static constexpr int PITCH = D + 8;  // shared row pitch in elements: 16 bytes of padding
  static constexpr int CPR = D / 8;    // 16-byte chunks a row
  // Q tile + two stages of (K, V)
  static constexpr int SMEM = (BQ + 4 * BK) * PITCH * (int)sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(256, D <= 64 ? 2 : 1)
flash_attn_prefill_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out, Strides qs, Strides ks,
                        Strides vs, int hq, int group, int sq, int sk, int causal,
                        float scale_log2) {
  extern __shared__ __align__(16) unsigned char flash_smem[];
  using C = PrefillBf16<D>;
  constexpr int BQ = C::BQ, BK = C::BK, PITCH = C::PITCH, CPR = C::CPR;
  bf16* q_sh = reinterpret_cast<bf16*>(flash_smem);
  bf16* kv_sh = q_sh + BQ * PITCH;  // stage s: K at 2s, V at 2s + 1 (BK x PITCH each)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ih = blockIdx.x;
  const long long ib = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int ikv = ih / group;
  const bf16* qb = q + ib * qs.b + ih * qs.h;
  const bf16* kb = k + ib * ks.b + ikv * ks.h;
  const bf16* vb = v + ib * vs.b + ikv * vs.h;

  for (int e = tid; e < BQ * CPR; e += C::THREADS) {
    const int r = e / CPR, c = e % CPR;
    const bool in = q0 + r < sq;
    cp_async16(q_sh + r * PITCH + c * 8, in ? qb + (long long)(q0 + r) * qs.s + c * 8 : qb, in);
  }
  cp_async_commit();

  const int kend = causal ? min(sk, q0 + BQ) : sk;  // the tile's last row sees keys < q0 + BQ
  const int ntiles = (kend + BK - 1) / BK;
  auto load_kv = [&](int t) {
    bf16* k_dst = kv_sh + (2 * (t & 1)) * BK * PITCH;
    bf16* v_dst = k_dst + BK * PITCH;
    for (int e = tid; e < BK * CPR; e += C::THREADS) {
      const int j = e / CPR, c = e % CPR;
      const long long key = (long long)t * BK + j;
      const bool in = key < sk;  // rows past Sk are zeros: P is 0 there, and 0 * 0 stays 0
      cp_async16(k_dst + j * PITCH + c * 8, in ? kb + key * ks.s + c * 8 : kb, in);
      cp_async16(v_dst + j * PITCH + c * 8, in ? vb + key * vs.s + c * 8 : vb, in);
    }
    cp_async_commit();
  };
  load_kv(0);
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();

  // Q as A fragments: rows warp*16 + (lane & 15), columns 8 * (lane >> 4) of each 16
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], q_sh + (warp * 16 + (lane & 15)) * PITCH + kk * 16 + (lane >> 4) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  // this thread's rows are r0 = row_lo + g and r0 + 8; l is its own partial sum
  const int g = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + warp * 16;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    if (!causal || k0 <= row_lo + 15) {  // else every key of the tile is above this warp's rows
      const bf16* k_sh = kv_sh + (2 * (t & 1)) * BK * PITCH;
      const bf16* v_sh = k_sh + BK * PITCH;
      float s[BK / 8][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          // keys np*16 + (lane & 7) + 8 (lane >> 4), columns kk*16 + 8 ((lane >> 3) & 1)
          uint32_t kf[4];
          ldmatrix_x4(kf, k_sh + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > row_lo);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2;
          if (edge) {
            const int col = k0 + nt * 8 + tig * 2 + (e & 1);
            const int row = row_lo + g + (e >> 1) * 8;
            if (col >= sk || (causal && col > row)) x = NEG_INF;
          }
          s[nt][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      // the four threads of a quad hold one row pair
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - m0);
        s[nt][1] = exp2f(s[nt][1] - m0);
        s[nt][2] = exp2f(s[nt][2] - m1);
        s[nt][3] = exp2f(s[nt][3] - m1);
        ps0 += s[nt][0] + s[nt][1];
        ps1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] *= a0;
        o[i][1] *= a0;
        o[i][2] *= a1;
        o[i][3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // P's accumulator tiles 2kk and 2kk + 1 are the A fragment of keys kk*16..+15
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          // keys kk*16 + (lane & 15), columns dp*16 + 8 (lane >> 4), transposed
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_sh + (kk * 16 + (lane & 15)) * PITCH + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = row_lo + g, r1 = r0 + 8;
  bf16* ob = out + (ib * hq + ih) * (long long)sq * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + tig * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + col) =
          pack_bf16(o[i][0] / d0, o[i][1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + col) =
          pack_bf16(o[i][2] / d1, o[i][3] / d1);
  }
}

// ------------------------------------------------- f32 prefill (CUDA cores)
template <int D>
struct PrefillF32 {
  static constexpr int ROWS = 64;                   // query rows a CTA
  static constexpr int TPR = D >= 64 ? D / 32 : 1;  // threads a row
  static constexpr int THREADS = ROWS * TPR;
  static constexpr int DPT = D / TPR;  // dims a thread: float4 chunks part, part + TPR, ...
  static constexpr int BK = 32;        // keys a staged tile
};

template <int D>
__global__ void __launch_bounds__(PrefillF32<D>::THREADS)
flash_attn_prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, Strides qs,
                       Strides ks, Strides vs, int hq, int group, int sq, int sk, int causal,
                       float scale) {
  using C = PrefillF32<D>;
  constexpr int TPR = C::TPR, DPT = C::DPT, BK = C::BK, NCH = DPT / 4;
  __shared__ __align__(16) float k_tile[BK][D];
  __shared__ __align__(16) float v_tile[BK][D];
  const int tid = threadIdx.x, part = tid % TPR;
  const int ih = blockIdx.x;
  const long long ib = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::ROWS;
  const int ikv = ih / group;
  const int row = q0 + tid / TPR;
  const bool live = row < sq;

  float qv[DPT], acc[DPT];
  {
    const float* qrow = q + ib * qs.b + ih * qs.h + (long long)(live ? row : 0) * qs.s;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(qrow + 4 * (part + TPR * i));
      qv[4 * i] = x.x * scale, qv[4 * i + 1] = x.y * scale;  // q scaled in f32, as the TPU kernel
      qv[4 * i + 2] = x.z * scale, qv[4 * i + 3] = x.w * scale;
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;
  const float* kb = k + ib * ks.b + ikv * ks.h;
  const float* vb = v + ib * vs.b + ikv * vs.h;
  const int kend = causal ? min(sk, q0 + C::ROWS) : sk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D / 4; e += C::THREADS) {
      const int j = e / (D / 4), c = e % (D / 4);
      const long long key = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < sk) {
        kx = *reinterpret_cast<const float4*>(kb + key * ks.s + 4 * c);
        vx = *reinterpret_cast<const float4*>(vb + key * vs.s + 4 * c);
      }
      *reinterpret_cast<float4*>(&k_tile[j][4 * c]) = kx;
      *reinterpret_cast<float4*>(&v_tile[j][4 * c]) = vx;
    }
    __syncthreads();

    float s[BK];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][4 * (part + TPR * i)]);
        dot = fmaf(qv[4 * i], kk.x, dot);
        dot = fmaf(qv[4 * i + 1], kk.y, dot);
        dot = fmaf(qv[4 * i + 2], kk.z, dot);
        dot = fmaf(qv[4 * i + 3], kk.w, dot);
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int key = k0 + j;
      const bool ok = key < sk && (!causal || key <= row);
      s[j] = ok ? dot : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][4 * (part + TPR * i)]);
        acc[4 * i] = fmaf(s[j], vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(s[j], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[j], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[j], vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + ((ib * hq + ih) * (long long)sq + row) * D;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
      *reinterpret_cast<float4*>(orow + 4 * (part + TPR * i)) =
          make_float4(acc[4 * i] / denom, acc[4 * i + 1] / denom, acc[4 * i + 2] / denom,
                      acc[4 * i + 3] / denom);
  }
}

// ------------------------------------------------ decode, split over keys
template <typename T, int D>
struct Decode {
  static constexpr int THREADS = 128;                // 4 warps
  static constexpr int GH = 8;                       // query heads a CTA, at most
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // keys a tile
  static constexpr int EPC = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  static constexpr int CPR = D / EPC;                // chunks a row
  static constexpr int PITCH = D + EPC;              // shared row pitch: an odd number of chunks
  static constexpr int NC = D / 8;                   // 8-dim output groups a row
  static constexpr int HS = THREADS / BK;            // threads a key in the score step
  static constexpr int KV_BYTES = 4 * BK * PITCH * (int)sizeof(T);  // 2 stages x (K, V)
  static constexpr int SMEM = KV_BYTES + (GH * D + GH * BK + 3 * GH) * 4;
};

// One key's scores against the CTA's first NH query heads (q_sh [GH][D],
// scaled f32; heads past the group hold zeros): this thread's share of
// the D chunks, summed over the HS adjacent lanes of the key.
template <int NH, typename T, int D>
__device__ __forceinline__ void decode_scores(const T* krow, const float* q_sh, int sp,
                                              float* s_col, bool valid) {
  using C = Decode<T, D>;
  float dot[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) dot[h] = 0.0f;
#pragma unroll
  for (int i = 0; i < C::CPR / C::HS; ++i) {
    const int c = i * C::HS + sp;
    float kx[C::EPC];
    load16_f32(krow + c * C::EPC, kx);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float* qh = q_sh + h * D + c * C::EPC;
#pragma unroll
      for (int e = 0; e < C::EPC; ++e) dot[h] = fmaf(qh[e], kx[e], dot[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int o = 1; o < C::HS; o <<= 1) dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
    if (sp == 0) s_col[h * C::BK] = valid ? dot[h] : NEG_INF;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_attn_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ part, Strides qs,
                          Strides ks, Strides vs, int hq, int group, int n, int chunk,
                          int nchunks, float scale) {
  extern __shared__ __align__(16) unsigned char flash_smem[];
  using C = Decode<T, D>;
  constexpr int BK = C::BK, GH = C::GH, EPC = C::EPC, CPR = C::CPR, PITCH = C::PITCH, NC = C::NC,
                HS = C::HS;
  static_assert(GH == 8, "decode_scores is dispatched for 1, 2, 4 and 8 heads");
  T* kv_sh = reinterpret_cast<T*>(flash_smem);
  float* q_sh = reinterpret_cast<float*>(flash_smem + C::KV_BYTES);  // [GH][D], scaled
  float* p_sh = q_sh + GH * D;                                      // [GH][BK]: scores, then P
  float* m_sh = p_sh + GH * BK;
  float* l_sh = m_sh + GH;
  float* a_sh = l_sh + GH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ic = blockIdx.x % nchunks, hg = blockIdx.x / nchunks;
  const int ikv = blockIdx.y;
  const long long ib = blockIdx.z;
  const int g0 = hg * GH;
  const int ng = min(GH, group - g0);
  const int h0 = ikv * group + g0;  // this CTA's first query head
  const int c0 = ic * chunk;
  const int cend = min(n, c0 + chunk);
  const int ntiles = (cend - c0 + BK - 1) / BK;
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;

  auto load_kv = [&](int t) {
    T* k_dst = kv_sh + (2 * (t & 1)) * BK * PITCH;
    T* v_dst = k_dst + BK * PITCH;
    for (int e = tid; e < BK * CPR; e += C::THREADS) {
      const int j = e / CPR, c = e % CPR;
      const long long key = c0 + (long long)t * BK + j;
      const bool in = key < cend;  // zeros past the chunk: P is 0 there
      cp_async16(k_dst + j * PITCH + c * EPC, in ? kb + key * ks.s + c * EPC : kb, in);
      cp_async16(v_dst + j * PITCH + c * EPC, in ? vb + key * vs.s + c * EPC : vb, in);
    }
    cp_async_commit();
  };
  load_kv(0);
  for (int e = tid; e < GH * D; e += C::THREADS) {
    const int h = e / D, d = e % D;
    q_sh[e] = h < ng ? to_f32(q[ib * qs.b + (h0 + h) * qs.h + d]) * scale : 0.0f;
  }
  if (tid < GH) {
    m_sh[tid] = NEG_INF;
    l_sh[tid] = 0.0f;
  }

  // the PV step: thread = (8-dim group oc, head ph, key split pks)
  int ghp = 1;
  while (ghp < ng) ghp <<= 1;
  const int oc = tid % NC, slot = tid / NC;
  const int ph = slot % ghp, pks = slot / ghp, nks = (C::THREADS / NC) / ghp;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  // the score step: thread = (key sj, D-chunk share sp), HS adjacent lanes a key
  const int sj = tid / HS, sp = tid % HS;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_sh = kv_sh + (2 * (t & 1)) * BK * PITCH;
    const T* v_sh = k_sh + BK * PITCH;
    {
      const T* krow = k_sh + sj * PITCH;
      float* s_col = p_sh + sj;
      const bool valid = c0 + t * BK + sj < cend;
      if (ghp == 1)
        decode_scores<1, T, D>(krow, q_sh, sp, s_col, valid);
      else if (ghp == 2)
        decode_scores<2, T, D>(krow, q_sh, sp, s_col, valid);
      else if (ghp == 4)
        decode_scores<4, T, D>(krow, q_sh, sp, s_col, valid);
      else
        decode_scores<GH, T, D>(krow, q_sh, sp, s_col, valid);
    }
    __syncthreads();
    for (int h = warp; h < ng; h += C::THREADS / 32) {
      float* ph_row = p_sh + h * BK;
      const float x0 = ph_row[lane];
      const float x1 = BK > 32 ? ph_row[lane + 32] : NEG_INF;
      const float m_old = m_sh[h];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = BK > 32 ? expf(x1 - m_new) : 0.0f;
      ph_row[lane] = p0;
      if (BK > 32) ph_row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_sh[h] = alpha;
        l_sh[h] = l_sh[h] * alpha + psum;
        m_sh[h] = m_new;
      }
    }
    __syncthreads();
    if (ph < ng) {
      const float alpha = a_sh[ph];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= alpha;
      const float* prow = p_sh + ph * BK;
      for (int j = pks; j < BK; j += nks) {
        const float p = prow[j];
        const T* vrow = v_sh + j * PITCH + oc * 8;
#pragma unroll
        for (int c = 0; c < 8 / EPC; ++c) {
          float vx[EPC];
          load16_f32(vrow + c * EPC, vx);
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[c * EPC + e] = fmaf(p, vx[e], acc[c * EPC + e]);
        }
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage, its scores p_sh
  }

  // sum the key splits of each (head, dim group) in split order, then write
  // this chunk's (m, l, acc) of every head
  float* red = reinterpret_cast<float*>(flash_smem);  // [THREADS][8], over the K/V stages
#pragma unroll
  for (int i = 0; i < 8; ++i) red[tid * 8 + i] = acc[i];
  __syncthreads();
  if (ph < ng && pks == 0) {
    float sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = acc[i];
    for (int s = 1; s < nks; ++s) {
      const float* r = red + ((s * ghp + ph) * NC + oc) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum[i] += r[i];
    }
    float* dst = part + ((ib * hq + h0 + ph) * (long long)nchunks + ic) * (D + 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[2 + oc * 8 + i] = sum[i];
    if (oc == 0) {
      dst[0] = m_sh[ph];
      dst[1] = l_sh[ph];
    }
  }
}

// the partials of one (batch, head) in chunk order; one thread a dim
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_attn_decode_merge(const float* __restrict__ part, T* __restrict__ out, int nchunks) {
  const int d = threadIdx.x;
  const float* p = part + (long long)blockIdx.x * nchunks * (D + 2);
  float m = NEG_INF;
  for (int c = 0; c < nchunks; ++c) m = fmaxf(m, p[c * (D + 2)]);
  float l = 0.0f, a = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const float* pc = p + c * (D + 2);
    const float f = expf(pc[0] - m);
    l += pc[1] * f;
    a += pc[2 + d] * f;
  }
  out[(long long)blockIdx.x * D + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

// ------------------------------------------------------------------ launch
template <typename K>
int allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : 0;
}

template <typename T, int D>
int launch_decode(const T* q, const T* k, const T* v, T* out, float* part, Strides qs, Strides ks,
                  Strides vs, int b, int hq, int hkv, int n, int chunk, int nchunks, float scale,
                  cudaStream_t st) {
  using C = Decode<T, D>;
  const int group = hq / hkv;
  const int err = allow_smem(flash_attn_decode_partial<T, D>, C::SMEM);
  if (err) return err;
  const dim3 grid(nchunks * ((group + C::GH - 1) / C::GH), hkv, b);
  flash_attn_decode_partial<T, D><<<grid, C::THREADS, C::SMEM, st>>>(q, k, v, part, qs, ks, vs, hq,
                                                                     group, n, chunk, nchunks,
                                                                     scale);
  const int e1 = (int)cudaGetLastError();
  if (e1) return e1;
  flash_attn_decode_merge<T, D><<<b * hq, D, 0, st>>>(part, out, nchunks);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dim(const void* q, const void* k, const void* v, void* out, float* part, Strides qs,
               Strides ks, Strides vs, int b, int hq, int hkv, int sq, int sk, int causal,
               int dtype, float scale, int chunk, int nchunks, cudaStream_t st) {
  const int group = hq / hkv;
  if (sq == 1) {
    // row 0 of a causal call sees key 0 only
    const int n = causal ? 1 : sk;
    if (dtype == 1)
      return launch_decode<bf16, D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                    static_cast<const bf16*>(v), static_cast<bf16*>(out), part, qs,
                                    ks, vs, b, hq, hkv, n, chunk, nchunks, scale, st);
    return launch_decode<float, D>(static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(out), part, qs,
                                   ks, vs, b, hq, hkv, n, chunk, nchunks, scale, st);
  }
  if (dtype == 1) {
    using C = PrefillBf16<D>;
    const int err = allow_smem(flash_attn_prefill_bf16<D>, C::SMEM);
    if (err) return err;
    const dim3 grid(hq, b, (sq + C::BQ - 1) / C::BQ);
    flash_attn_prefill_bf16<D><<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), qs, ks, vs, hq, group, sq, sk, causal, scale * LOG2E);
  } else {
    using C = PrefillF32<D>;
    const dim3 grid(hq, b, (sq + C::ROWS - 1) / C::ROWS);
    flash_attn_prefill_f32<D><<<grid, C::THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), qs, ks, vs, hq, group, sq, sk, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success).  `dtype` is
// 0 for float32, 1 for bfloat16; `d` is 16, 64 or 128; strides are in
// elements ([b, h, s] for q, k and v; the D axis is unit-stride), each
// base 16-byte aligned and each stride of an axis longer than 1 a whole
// number of 16-byte units; the output is contiguous.  A decode call
// (sq == 1) splits its keys into `nchunks` chunks of `chunk` keys (a
// multiple of 64) and needs `part`, f32 scratch of
// b * hq * nchunks * (d + 2) values; a prefill call ignores the three.  The
// caller checks shapes, dtypes, devices, Hq % Hkv == 0, and b, Sq, Sk >= 1
// (b, Sq / 64 <= 65535) before calling.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 long long qsb, long long qsh, long long qss, long long ksb,
                                 long long ksh, long long kss, long long vsb, long long vsh,
                                 long long vss, int b, int hq, int hkv, int sq, int sk,
                                 int causal, int dtype, int d, float scale, void* part, int chunk,
                                 int nchunks, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const cudaStream_t st = (cudaStream_t)stream;
  float* p = static_cast<float*>(part);
  switch (d) {
    case 16:
      return launch_dim<16>(q, k, v, out, p, qs, ks, vs, b, hq, hkv, sq, sk, causal, dtype, scale,
                            chunk, nchunks, st);
    case 64:
      return launch_dim<64>(q, k, v, out, p, qs, ks, vs, b, hq, hkv, sq, sk, causal, dtype, scale,
                            chunk, nchunks, st);
    case 128:
      return launch_dim<128>(q, k, v, out, p, qs, ks, vs, b, hq, hkv, sq, sk, causal, dtype, scale,
                             chunk, nchunks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
