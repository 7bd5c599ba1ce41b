// Online-softmax attention with GQA (K5).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::flash_attention
// (body _kernel).  For q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], group
// G = Hq / Hkv, query head h reading KV head h / G:
//
//   s[r, c]   = (q[r] * D^-0.5) . k[c]       q scaled in f32, products in f32
//   s[r, c]   = -1e30 where causal and r < c   (the mask row >= col, aligned
//                                               top-left as the TPU kernel's)
//   out[r]    = sum_c exp(s[r, c] - m[r]) v[c] / max(l[r], 1e-30)
//
// with m the row max and l the row sum, accumulated online in f32 and the
// output rounded once to the input type.  A masked score contributes
// exp(-1e30 - m) = 0, exactly as in the TPU kernel's blocks, so skipping the
// key tiles above the diagonal computes the same function.  Every row sees
// key 0, so m is finite after the first tile.  Sq and Sk are any lengths
// (the TPU wrapper's block divisibility is a tiling detail, not part of the
// function).
//
// Bound on the card.  A causal prefill at Sq = Sk = S does 4 B Hq D S(S+1)/2
// operations (QK^T and PV) on 2 B (Hq + 2 Hkv) S D-element reads and
// writes: at B=8, Hq=32, S=4096, D=64 that is 0.55 TFLOP against 0.34 GB,
// 0.56 ms at 989 TFLOP/s (bf16 tensor cores) and 0.10 ms at 3.35 TB/s:
// operations bound it.  A decode step (Sq = 1) reads the whole K/V prefix
// once for Hq/Hkv query heads: bytes bound it (68 MB, 0.02 ms, at B=8,
// Hkv=8, Sk=4160).
//
// Design (simple and right first: f32 CUDA cores, no tensor cores).
//  * Prefill (Sq > 1): one CTA per (64-row query tile, query head, batch),
//    one thread per query row holding its scaled q row and its f32
//    accumulator in registers (~230 registers, so 4 CTAs an SM); K and V
//    tiles of 8 keys are staged in shared memory as f32 and read as
//    broadcasts (a short tile keeps the scores' registers few).  Causal
//    CTAs stop at the tile's last row.  This runs on the f32 FMA pipes,
//    far from the bf16 tensor-core bound: the tensor-core version (mma /
//    wgmma) is later work.
//  * Decode (Sq = 1): one CTA per (up to 4 query heads of one KV group,
//    KV head, batch), so the group shares one read of K and V; its 4 warps
//    take 32-key chunks in turn, stage each chunk in shared memory (row
//    pitch 65 floats: conflict-free both ways), score one key per lane,
//    keep their own online-softmax state and merge it at the end.
//  * Both take element strides for the batch, head and sequence axes (the
//    D axis is unit-stride), so the decode path reads the cache prefix as a
//    view; loads are scalar, so any alignment works.
//  * Offsets are 64-bit.  The output is contiguous [B, Hq, Sq, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr int D = 64;              // head dim: the only one built
constexpr int BQ = 64;             // prefill: query rows per CTA, one thread each
constexpr int BK = 8;              // prefill: keys per staged tile
constexpr int DBK = 32;            // keys per decode chunk (one a lane)
constexpr int DEC_WARPS = 4;       // decode: warps per CTA
constexpr int GH = 4;              // decode: query heads per CTA

struct Strides {
  long long b, h, s;  // elements; the D axis has stride 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as a cast in torch / JAX
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

template <typename T>
__global__ void __launch_bounds__(BQ)
flash_attn_prefill(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, Strides qs, Strides ks, Strides vs, int hq, int group,
                   int sq, int sk, int causal, float scale) {
  __shared__ __align__(16) float k_tile[BK][D];
  __shared__ __align__(16) float v_tile[BK][D];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int ih = blockIdx.y;
  const long long ib = blockIdx.z;
  const int ikv = ih / group;
  const int row = q0 + tid;
  const bool live = row < sq;

  float qv[D], acc[D];
  {
    const T* qrow = q + ib * qs.b + ih * qs.h + (long long)(live ? row : 0) * qs.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qv[d] = to_f32(qrow[d]) * scale;
      acc[d] = 0.0f;
    }
  }
  float m = NEG_INF, l = 0.0f;
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;
  const int kend = causal ? min(sk, q0 + BQ) : sk;  // the tile's last row sees keys < q0 + BQ

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * D; e += BQ) {
      const int j = e / D, d = e % D;
      const long long key = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < sk) {
        kx = to_f32(kb[key * ks.s + d]);
        vx = to_f32(vb[key * vs.s + d]);
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
    }
    __syncthreads();

    float s[BK];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][d]);
        dot = fmaf(qv[d], kk.x, dot);
        dot = fmaf(qv[d + 1], kk.y, dot);
        dot = fmaf(qv[d + 2], kk.z, dot);
        dot = fmaf(qv[d + 3], kk.w, dot);
      }
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
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][d]);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
      }
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((ib * hq + ih) * (long long)sq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / denom);
  }
}

template <typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32)
flash_attn_decode(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, Strides qs, Strides ks, Strides vs, int hq, int group,
                  int n, float scale) {
  __shared__ float q_sh[GH][D];
  __shared__ float tile[DEC_WARPS][DBK][D + 1];
  __shared__ float p_sh[DEC_WARPS][GH][DBK];
  __shared__ float m_sh[DEC_WARPS][GH];
  __shared__ float l_sh[DEC_WARPS][GH];
  __shared__ float acc_sh[DEC_WARPS][GH][D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = blockIdx.x * GH;
  const int ikv = blockIdx.y;
  const long long ib = blockIdx.z;
  const int ng = min(GH, group - g0);
  const int h0 = ikv * group + g0;  // first query head of this CTA

  for (int e = threadIdx.x; e < GH * D; e += DEC_WARPS * 32) {
    const int g = e / D, d = e % D;
    q_sh[g][d] = g < ng ? to_f32(q[ib * qs.b + (h0 + g) * qs.h + d]) * scale : 0.0f;
  }
  __syncthreads();

  float m[GH], l[GH], acc0[GH], acc1[GH];  // acc: dims lane and lane + 32
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = NEG_INF;
    l[g] = acc0[g] = acc1[g] = 0.0f;
  }
  const T* kb = k + ib * ks.b + ikv * ks.h;
  const T* vb = v + ib * vs.b + ikv * vs.h;
  float(*t)[D + 1] = tile[warp];

  for (int c0 = warp * DBK; c0 < n; c0 += DEC_WARPS * DBK) {
#pragma unroll 8
    for (int j = 0; j < DBK; ++j) {
      const long long key = c0 + j;
      const bool in = key < n;
      t[j][lane] = in ? to_f32(kb[key * ks.s + lane]) : 0.0f;
      t[j][lane + 32] = in ? to_f32(kb[key * ks.s + lane + 32]) : 0.0f;
    }
    __syncwarp();
    float s[GH];
#pragma unroll
    for (int g = 0; g < GH; ++g) s[g] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kx = t[lane][d];
#pragma unroll
      for (int g = 0; g < GH; ++g) s[g] = fmaf(q_sh[g][d], kx, s[g]);
    }
    const bool in = c0 + lane < n;
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float sg = in ? s[g] : NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float alpha = expf(m[g] - m_new);
      const float p = expf(sg - m_new);
      l[g] = l[g] * alpha + warp_sum(p);
      acc0[g] *= alpha;
      acc1[g] *= alpha;
      m[g] = m_new;
      p_sh[warp][g][lane] = p;
    }
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < DBK; ++j) {
      const long long key = c0 + j;
      const bool kin = key < n;
      t[j][lane] = kin ? to_f32(vb[key * vs.s + lane]) : 0.0f;
      t[j][lane + 32] = kin ? to_f32(vb[key * vs.s + lane + 32]) : 0.0f;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < DBK; ++j) {
      const float v0 = t[j][lane], v1 = t[j][lane + 32];
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float p = p_sh[warp][g][j];
        acc0[g] = fmaf(p, v0, acc0[g]);
        acc1[g] = fmaf(p, v1, acc1[g]);
      }
    }
    __syncwarp();  // the next chunk overwrites the tile and p
  }

#pragma unroll
  for (int g = 0; g < GH; ++g) {
    if (lane == 0) {
      m_sh[warp][g] = m[g];
      l_sh[warp][g] = l[g];
    }
    acc_sh[warp][g][lane] = acc0[g];
    acc_sh[warp][g][lane + 32] = acc1[g];
  }
  __syncthreads();
  // merge the warps' states: a warp that took no chunk holds m = -1e30,
  // l = 0, acc = 0 and adds exp(-1e30 - m) = 0 of them
  for (int e = threadIdx.x; e < GH * D; e += DEC_WARPS * 32) {
    const int g = e / D, d = e % D;
    if (g >= ng) continue;
    float mg = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mg = fmaxf(mg, m_sh[w][g]);
    float lg = 0.0f, ag = 0.0f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = expf(m_sh[w][g] - mg);
      lg += l_sh[w][g] * f;
      ag += acc_sh[w][g][d] * f;
    }
    out[(ib * hq + h0 + g) * D + d] = from_f32<T>(ag / fmaxf(lg, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
           Strides vs, int b, int hq, int hkv, int sq, int sk, int causal, float scale,
           cudaStream_t st) {
  const int group = hq / hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (sq == 1) {
    // row 0 of a causal call sees key 0 only
    const int n = causal ? 1 : sk;
    const dim3 grid((group + GH - 1) / GH, hkv, b);
    flash_attn_decode<T><<<grid, DEC_WARPS * 32, 0, st>>>(qp, kp, vp, op, qs, ks, vs, hq, group,
                                                          n, scale);
  } else {
    const dim3 grid((sq + BQ - 1) / BQ, hq, b);
    flash_attn_prefill<T><<<grid, BQ, 0, st>>>(qp, kp, vp, op, qs, ks, vs, hq, group, sq, sk,
                                               causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `dtype`
// is 0 for float32, 1 for bfloat16; strides are in elements ([b, h, s] for
// q, k and v; the D axis is unit-stride); the output is contiguous.  The
// caller checks shapes, dtypes, devices, D == 64, Hq % Hkv == 0, and
// b, Sq, Sk >= 1 (b, Hkv <= 65535) before calling.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 long long qsb, long long qsh, long long qss, long long ksb,
                                 long long ksh, long long kss, long long vsb, long long vsh,
                                 long long vss, int b, int hq, int hkv, int sq, int sk,
                                 int causal, int dtype, float scale, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, b, hq, hkv, sq, sk, causal, scale, st);
  return launch<float>(q, k, v, out, qs, ks, vs, b, hq, hkv, sq, sk, causal, scale, st);
}
