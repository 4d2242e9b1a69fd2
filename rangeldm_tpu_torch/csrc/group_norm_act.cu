// GroupNorm -> activation -> the next conv's azimuth wrap, forward and
// backward, in one pass each, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and SiLU to XLA,
// which fuses them. On the card the unfused PyTorch chain (under autocast:
// cast to f32, statistics, apply, SiLU, cast back, `F.pad(mode="circular")`
// before every 3x3 conv; the reverse in the backward) moves 36 bytes an
// element forward and about 54 backward in bf16, and is the largest group of
// device time in every cell. This pair moves each input once and writes each
// output once.
//
//   x     : (B, C, W, H) bf16 or f32, contiguous; slice (b, g) = the Cg = C/G
//           channels of group g of sample b, N = Cg*W*H contiguous values
//   v     = x + shift[b, c]                      (optional shift, f32 math)
//   mean, rstd of v over the slice               (f32, biased variance)
//   z     = v * (rstd * gamma[c]) + (beta[c] - mean * rstd * gamma[c])
//   y     = act(z), rounded once to x's dtype    (identity, SiLU or ReLU)
//   out   : (B, C, W, H), or (B, C, W + 2, H) with rows 0 and W + 1 holding
//           rows W - 1 and 0 (the circular pad of a 3x3 conv), so the conv
//           runs on it with padding (0, h_pad) and no copy.
// Backward (g: the gradient of out, in its layout, folded back here):
//   dz = dy * act'(z), A[b,c] = sum dz, Bs[b,c] = sum dz * xhat, X = sum xhat
//   S1 = sum_c gamma A, S2 = sum_c gamma Bs over the slice
//   dx = rstd * (gamma dz - S1 / N - xhat S2 / N)
//   dshift[b,c] = rstd * (gamma A - W H S1 / N - X S2 / N)
//   dgamma = sum_b Bs, dbeta = sum_b A (a second, tiny launch, fixed order)
//
// What bounds it: bytes (a few flops an element against 295 the card can do
// per byte). Design:
//   * one cluster of S blocks per slice (S = 1 when the slice fits one block's
//     share of shared memory, up to 8 where it does not: RangeDM's and the
//     VAE's full-resolution levels). Each block stages its chunk of x (and of
//     g in the backward, where both fit the block's share) in shared memory
//     once by 16-byte cp.async, so x is read from device memory once; what
//     is not staged is read from device memory (mostly L2) again instead
//   * statistics: per-thread Welford partials over 16-byte vectors, merged by
//     Chan's formula in a fixed tree (warp shuffles, then warps in order, then
//     the cluster's blocks in rank order over distributed shared memory), so
//     every block of a cluster computes bit-identical mean and rstd and two
//     runs agree bit for bit. No floating-point atomics anywhere
//   * threads of a block are split into one group per channel (portion) of
//     the chunk, so each thread applies one channel's scale and bias and the
//     backward's per-channel sums are group reductions
//   * the wrapped output's two extra rows are written by the threads that
//     produce rows 0 and W - 1, and the backward folds them back as it reads
//   * the wrapper (ops/group_norm.py `plan`) chooses S, the block size, the
//     vector width and the staging from the slice's shape.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"  // attn::opt_in

namespace cgrp = cooperative_groups;

// ops/group_norm.py `Plan`, field for field: how the wrapper cut a slice.
// Outside the unnamed namespace, so the C entry points that take it keep
// external linkage.
struct Split {
  int clusters, portions, portion, tpc, threads, vec, stage_x, stage_g;
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kMaxPortions = 64;
enum Act { kIdentity = 0, kSilu = 1, kRelu = 2 };

// what the kernels read: the slice's shape, the split, the call's options
struct Plan {
  int C, Cg, W, H;   // channels, channels a group, azimuth, beams
  int S;             // blocks (one cluster) a slice
  int Cl, P;         // channel portions a block, values a portion
  int tpc;           // threads a portion (a power of two)
  int act, wrap;
  int stage_x, stage_g;
  int pbf16, sbf16;  // gamma/beta and shift stored as bf16
  float eps;
};

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(float (&f)[V], const T* p) {
  using R = typename Raw<sizeof(T) * V>::type;
  R r = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  using R = typename Raw<sizeof(T) * V>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
  *reinterpret_cast<R*>(p) = r;
}

__device__ __forceinline__ float ld_param(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_param(void* p, long i, float v, int is_bf16) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// SiLU and its derivative by the fast exponential and reciprocal (a few
// ulp in float32): exact IEEE versions cost as much as the memory traffic
__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

__device__ __forceinline__ float act_fwd(float z, int act) {
  if (act == kSilu) return z * sigmoid(z);
  if (act == kRelu) return z > 0.f ? z : 0.f;
  return z;
}

// d act / dz, as PyTorch's silu_backward and threshold_backward take it
__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == kSilu) {
    const float s = sigmoid(z);
    return s * (1.f + z * (1.f - s));
  }
  if (act == kRelu) return z > 0.f ? 1.f : 0.f;
  return 1.f;
}

// Copy n values into shared memory: 16-byte cp.async where both ends and n
// allow it, else V-wide loads and stores. The caller waits and syncs.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src, long n) {
  constexpr int kPer16 = 16 / sizeof(T);
  const bool v16 = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % 16 == 0) &&
                   (n % kPer16 == 0);
  if (v16) {
    for (long i = threadIdx.x * kPer16; i < n; i += blockDim.x * kPer16) {
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + i));
    }
  } else {
    using R = typename Raw<sizeof(T) * V>::type;
    for (long i = threadIdx.x * V; i < n; i += blockDim.x * V)
      *reinterpret_cast<R*>(dst + i) = *reinterpret_cast<const R*>(src + i);
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Stat {
  float n, mean, m2;
};

// Chan's merge of two Welford partials
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

// lane 0 ends with the merge of the warp's 32 partials, in a fixed tree
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stat o{__shfl_down_sync(0xffffffffu, s.n, off),
           __shfl_down_sync(0xffffffffu, s.mean, off),
           __shfl_down_sync(0xffffffffu, s.m2, off)};
    s = merge(s, o);
  }
  return s;
}

// lanes at multiples of `width` end with the sum of their `width` lanes
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, width);
  return v;
}

// Where a block's thread sits: its portion k (a channel, or part of one),
// the channel c0 of the block's first portion and its own c, the offset of
// the portions in their channels, lane j in the portion's group of threads.
struct Where {
  int b, g, k, j, c0, c, off0;
  bool active;
};

__device__ __forceinline__ Where where(const Plan& p, int s) {
  Where w;
  const int groups = p.C / p.Cg;
  w.b = blockIdx.y / groups;
  w.g = blockIdx.y % groups;
  w.k = threadIdx.x / p.tpc;
  w.j = threadIdx.x % p.tpc;
  w.active = w.k < p.Cl;
  if (p.S <= p.Cg) {
    w.c0 = w.g * p.Cg + s * p.Cl;
    w.c = w.c0 + w.k;
    w.off0 = 0;
  } else {                       // one portion a block, part of a channel
    const int per = p.S / p.Cg;
    w.c0 = w.c = w.g * p.Cg + s / per;
    w.off0 = (s % per) * p.P;
  }
  return w;
}

// offset of channel c of sample b in a (B, C, W, H) or wrapped tensor, at
// row 0 of the image (row 1 of the wrapped layout)
__device__ __forceinline__ long channel_base(const Plan& p, int b, int c,
                                             bool wrapped) {
  const long bc = static_cast<long>(b) * p.C + c;
  return wrapped ? (bc * (p.W + 2) + 1) * p.H : bc * p.W * p.H;
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_act_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                          const void* gamma, const void* beta,
                          const void* shift, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Stat red[kMaxThreads / 32];
  __shared__ Stat part;
  __shared__ float stat[2];

  const int s = p.S > 1 ? static_cast<int>(cgrp::this_cluster().block_rank()) : 0;
  const long n_slice = static_cast<long>(p.Cg) * p.W * p.H;
  const long chunk = static_cast<long>(p.Cl) * p.P;
  const T* src = x + blockIdx.y * n_slice + s * chunk;
  if (p.stage_x) {
    T* sx = reinterpret_cast<T*>(smem);
    stage<T, V>(sx, src, chunk);
    cp_async_wait();
    __syncthreads();
    src = sx;
  }
  const Where w = where(p, s);
  const float shv =
      (shift != nullptr && w.active)
          ? ld_param(shift, static_cast<long>(w.b) * p.C + w.c, p.sbf16)
          : 0.f;
  const T* px = src + static_cast<long>(w.k) * p.P;

  Stat st{0.f, 0.f, 0.f};
  if (w.active) {
    for (int e = w.j * V; e < p.P; e += p.tpc * V) {
      float f[V];
      load_vec<T, V>(f, px + e);
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[i] += shv;
        m += f[i];
      }
      m *= 1.f / V;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) q = fmaf(f[i] - m, f[i] - m, q);
      st = merge(st, Stat{static_cast<float>(V), m, q});
    }
  }
  st = warp_merge(st);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat t = red[0];
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) t = merge(t, red[i]);
    part = t;
  }
  if (p.S > 1) {
    cgrp::cluster_group cluster = cgrp::this_cluster();
    cluster.sync();
    if (threadIdx.x == 0) {
      Stat t = *cluster.map_shared_rank(&part, 0);
      for (int r = 1; r < p.S; ++r) t = merge(t, *cluster.map_shared_rank(&part, r));
      stat[0] = t.mean;
      stat[1] = 1.f / sqrtf(fmaxf(t.m2 / t.n, 0.f) + p.eps);
    }
    cluster.sync();     // no block leaves while another reads its `part`
  } else {
    __syncthreads();
    if (threadIdx.x == 0) {
      stat[0] = part.mean;
      stat[1] = 1.f / sqrtf(fmaxf(part.m2 / part.n, 0.f) + p.eps);
    }
    __syncthreads();
  }
  const float mean = stat[0], rstd = stat[1];
  if (s == 0 && threadIdx.x == 0) {
    mean_out[blockIdx.y] = mean;
    rstd_out[blockIdx.y] = rstd;
  }
  if (!w.active) return;

  const float a = rstd * ld_param(gamma, w.c, p.pbf16);
  const float bb = fmaf(shv - mean, a, ld_param(beta, w.c, p.pbf16));
  T* o = out + channel_base(p, w.b, w.c, p.wrap) + w.off0;
  const long wrap_span = static_cast<long>(p.W) * p.H;
  for (int e = w.j * V; e < p.P; e += p.tpc * V) {
    float f[V];
    load_vec<T, V>(f, px + e);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = act_fwd(fmaf(f[i], a, bb), p.act);
    store_vec<T, V>(o + e, f);
    if (p.wrap) {
      const int row = (w.off0 + e) / p.H;
      if (row == 0) store_vec<T, V>(o + e + wrap_span, f);
      if (row == p.W - 1) store_vec<T, V>(o + e - wrap_span, f);
    }
  }
}

// dy of one vector: the gradient's own row plus, in the wrapped layout, the
// extra row that copied it (row 0 copies W - 1, row W + 1 copies 0)
template <typename T, int V>
__device__ __forceinline__ void load_dy(float (&d)[V], const T* pg, int e,
                                        const T* halo, const Plan& p,
                                        int off0) {
  load_vec<T, V>(d, pg + e);
  if (!p.wrap) return;
  const int pos = off0 + e;
  const int row = pos / p.H, col = pos - row * p.H;
  if (row == p.W - 1) {
    float h[V];
    load_vec<T, V>(h, halo + col);
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] += h[i];
  }
  if (row == 0) {
    float h[V];
    load_vec<T, V>(h, halo + static_cast<long>(p.W + 1) * p.H + col);
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] += h[i];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          T* __restrict__ dx, const void* gamma,
                          const void* beta, const void* shift,
                          const float* __restrict__ mean_in,
                          const float* __restrict__ rstd_in,
                          float* __restrict__ sums, void* dshift, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kMaxThreads / 32][3];
  __shared__ float psum[kMaxPortions][3];
  __shared__ float blk[2];
  __shared__ float tot[2];

  const int s = p.S > 1 ? static_cast<int>(cgrp::this_cluster().block_rank()) : 0;
  const long n_slice = static_cast<long>(p.Cg) * p.W * p.H;
  const long chunk = static_cast<long>(p.Cl) * p.P;
  const Where w = where(p, s);
  const T* xsrc = x + blockIdx.y * n_slice + s * chunk;
  T* sx = reinterpret_cast<T*>(smem);
  T* sg = sx + (p.stage_x ? chunk : 0);
  if (p.stage_x) stage<T, V>(sx, xsrc, chunk);
  if (p.stage_g) {
    // one contiguous run a portion: the wrapped layout's channels are apart
    for (int k = 0; k < p.Cl; ++k)
      stage<T, V>(sg + static_cast<long>(k) * p.P,
                  gy + channel_base(p, w.b, w.c0 + k, p.wrap) + w.off0, p.P);
  }
  if (p.stage_x || p.stage_g) {
    cp_async_wait();
    __syncthreads();
  }
  const T* px = (p.stage_x ? sx : xsrc) + static_cast<long>(w.k) * p.P;
  const T* pg = p.stage_g ? sg + static_cast<long>(w.k) * p.P
                          : gy + channel_base(p, w.b, w.c, p.wrap) + w.off0;
  const T* halo = gy + channel_base(p, w.b, w.c, true) - p.H;

  const float mean = mean_in[blockIdx.y], rstd = rstd_in[blockIdx.y];
  float shv = 0.f, ga = 0.f, be = 0.f;
  if (w.active) {
    if (shift != nullptr)
      shv = ld_param(shift, static_cast<long>(w.b) * p.C + w.c, p.sbf16);
    ga = ld_param(gamma, w.c, p.pbf16);
    be = ld_param(beta, w.c, p.pbf16);
  }
  const float a = rstd * ga;
  const float bb = fmaf(shv - mean, a, be);
  const float xb = (shv - mean) * rstd;      // xhat = x * rstd + xb

  float sa = 0.f, sb = 0.f, sxh = 0.f;
  if (w.active) {
    for (int e = w.j * V; e < p.P; e += p.tpc * V) {
      float f[V], d[V];
      load_vec<T, V>(f, px + e);
      load_dy<T, V>(d, pg, e, halo, p, w.off0);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dz = d[i] * act_grad(fmaf(f[i], a, bb), p.act);
        const float xh = fmaf(f[i], rstd, xb);
        sa += dz;
        sb = fmaf(dz, xh, sb);
        sxh += xh;
      }
    }
  }
  // per-portion sums: lanes, then the portion's warps in order
  const int width = p.tpc < 32 ? p.tpc : 32;
  sa = group_sum(sa, width);
  sb = group_sum(sb, width);
  sxh = group_sum(sxh, width);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (p.tpc < 32) {
    if (w.active && lane % width == 0) {
      psum[w.k][0] = sa;
      psum[w.k][1] = sb;
      psum[w.k][2] = sxh;
    }
    __syncthreads();
  } else {
    if (lane == 0) {
      red[warp][0] = sa;
      red[warp][1] = sb;
      red[warp][2] = sxh;
    }
    __syncthreads();
    if (threadIdx.x < p.Cl) {
      const int per = p.tpc / 32, w0 = threadIdx.x * per;
      float t0 = red[w0][0], t1 = red[w0][1], t2 = red[w0][2];
      for (int i = 1; i < per; ++i) {
        t0 += red[w0 + i][0];
        t1 += red[w0 + i][1];
        t2 += red[w0 + i][2];
      }
      psum[threadIdx.x][0] = t0;
      psum[threadIdx.x][1] = t1;
      psum[threadIdx.x][2] = t2;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < p.Cl; ++k) {
      const float gk = ld_param(gamma, w.c0 + k, p.pbf16);
      s1 = fmaf(gk, psum[k][0], s1);
      s2 = fmaf(gk, psum[k][1], s2);
    }
    blk[0] = s1;
    blk[1] = s2;
  }
  // the slice's S1, S2 and, where a channel spans blocks, its whole sums
  float chan[3] = {0.f, 0.f, 0.f};
  const bool owner = p.S <= p.Cg || (s % (p.S / p.Cg)) == 0;
  if (p.S > 1) {
    cgrp::cluster_group cluster = cgrp::this_cluster();
    cluster.sync();
    if (threadIdx.x == 0) {
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < p.S; ++r) {
        const float* o = cluster.map_shared_rank(blk, r);
        s1 += o[0];
        s2 += o[1];
      }
      tot[0] = s1;
      tot[1] = s2;
      if (p.S > p.Cg && owner) {
        for (int r = s; r < s + p.S / p.Cg; ++r) {
          const float* o = cluster.map_shared_rank(&psum[0][0], r);
          chan[0] += o[0];
          chan[1] += o[1];
          chan[2] += o[2];
        }
      }
    }
    cluster.sync();
  } else {
    __syncthreads();
    if (threadIdx.x == 0) {
      tot[0] = blk[0];
      tot[1] = blk[1];
    }
  }
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(n_slice);
  const float c1 = tot[0] * inv_n, c2 = tot[1] * inv_n;
  const float hw = static_cast<float>(p.W) * p.H;
  // per-channel outputs, by the block that holds the channel's first portion
  const int writer = p.S > p.Cg ? 0 : -1;
  if (owner && (writer == 0 ? threadIdx.x == 0 : threadIdx.x < p.Cl)) {
    const int k = writer == 0 ? 0 : threadIdx.x;
    const float A = writer == 0 ? chan[0] : psum[k][0];
    const float Bs = writer == 0 ? chan[1] : psum[k][1];
    const float X = writer == 0 ? chan[2] : psum[k][2];
    const int c = w.c0 + k;
    const long bc = static_cast<long>(w.b) * p.C + c;
    sums[2 * bc] = A;
    sums[2 * bc + 1] = Bs;
    if (dshift != nullptr) {
      const float gk = ld_param(gamma, c, p.pbf16);
      st_param(dshift, bc, rstd * (gk * A - hw * c1 - X * c2), p.sbf16);
    }
  }
  if (!w.active) return;

  T* o = dx + channel_base(p, w.b, w.c, false) + w.off0;
  for (int e = w.j * V; e < p.P; e += p.tpc * V) {
    float f[V], d[V];
    load_vec<T, V>(f, px + e);
    load_dy<T, V>(d, pg, e, halo, p, w.off0);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float dz = d[i] * act_grad(fmaf(f[i], a, bb), p.act);
      const float xh = fmaf(f[i], rstd, xb);
      d[i] = rstd * (ga * dz - c1 - xh * c2);
    }
    store_vec<T, V>(o + e, d);
  }
}

// dgamma[c] = sum_b Bs[b, c], dbeta[c] = sum_b A[b, c], b in order
__global__ void group_norm_act_bwd_params_kernel(const float* __restrict__ sums,
                                                 void* dgamma, void* dbeta,
                                                 int batch, int channels,
                                                 int is_bf16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float a = 0.f, bs = 0.f;
  for (int b = 0; b < batch; ++b) {
    const long bc = static_cast<long>(b) * channels + c;
    a += sums[2 * bc];
    bs += sums[2 * bc + 1];
  }
  st_param(dgamma, c, bs, is_bf16);
  st_param(dbeta, c, a, is_bf16);
}

// One cluster of S blocks a slice: grid (S, slices), cluster (S, 1, 1).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t* opted, int S, int slices,
                   int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = attn::opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, slices, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int V>
int fwd(const void* x, void* out, const void* gamma, const void* beta,
        const void* shift, float* mean, float* rstd, int slices,
        int threads, const Plan& p, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  const size_t smem = p.stage_x ? sizeof(T) * static_cast<size_t>(p.Cl) * p.P : 0;
  return static_cast<int>(launch(
      group_norm_act_fwd_kernel<T, V>, &opted, p.S, slices, threads, smem,
      stream, static_cast<const T*>(x), static_cast<T*>(out), gamma, beta,
      shift, mean, rstd, p));
}

template <typename T, int V>
int bwd(const void* x, const void* gy, void* dx, const void* gamma,
        const void* beta, const void* shift, const float* mean,
        const float* rstd, float* sums, void* dshift, int slices,
        int threads, const Plan& p, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  const size_t smem = sizeof(T) * static_cast<size_t>(p.Cl) * p.P *
                      ((p.stage_x ? 1 : 0) + (p.stage_g ? 1 : 0));
  return static_cast<int>(launch(
      group_norm_act_bwd_kernel<T, V>, &opted, p.S, slices, threads, smem,
      stream, static_cast<const T*>(x), static_cast<const T*>(gy),
      static_cast<T*>(dx), gamma, beta, shift, mean, rstd, sums, dshift, p));
}

bool valid(const Plan& p, int batch, int threads, int dtype, int vec) {
  const int vmax = dtype == 1 ? 8 : 4;
  return batch > 0 && p.C > 0 && p.Cg > 0 && p.C % p.Cg == 0 && p.W > 0 &&
         p.H > 0 && p.S >= 1 && p.S <= 8 && p.Cl >= 1 &&
         p.Cl <= kMaxPortions && p.tpc >= 1 && p.Cl * p.tpc <= threads &&
         threads % 32 == 0 && threads <= kMaxThreads && vec >= 1 &&
         vec <= vmax && (vec & (vec - 1)) == 0 && p.P % vec == 0 &&
         (!p.wrap || p.H % vec == 0) && (dtype == 0 || dtype == 1) &&
         static_cast<long>(p.Cl) * p.P * p.S ==
             static_cast<long>(p.Cg) * p.W * p.H;
}

Plan make_plan(const Split& s, int C, int groups, int W, int H, int act,
               int wrap, int pbf16, int sbf16, float eps) {
  Plan p;
  p.C = C;
  p.Cg = groups > 0 ? C / groups : 0;
  p.W = W;
  p.H = H;
  p.S = s.clusters;
  p.Cl = s.portions;
  p.P = s.portion;
  p.tpc = s.tpc;
  p.act = act;
  p.wrap = wrap;
  p.stage_x = s.stage_x;
  p.stage_g = s.stage_g;
  p.pbf16 = pbf16;
  p.sbf16 = sbf16;
  p.eps = eps;
  return p;
}

}  // namespace

// split: the wrapper's `Plan`. dtype: 0 = float32, 1 = bfloat16 (x and
// out); pbf16 / sbf16: gamma and beta / shift in bfloat16. shift may be
// null. Returns the cudaError_t of the launch.
extern "C" int group_norm_act_fwd(const void* x, void* out, const void* gamma,
                                  const void* beta, const void* shift,
                                  void* mean, void* rstd, const Split* split,
                                  int batch, int C, int groups, int W, int H,
                                  int dtype, int pbf16, int sbf16, int act,
                                  int wrap, float eps, void* stream) {
  const Plan p = make_plan(*split, C, groups, W, H, act, wrap, pbf16, sbf16,
                           eps);
  const int threads = split->threads, vec = split->vec;
  if (groups <= 0 || C % groups != 0 || !valid(p, batch, threads, dtype, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  const int slices = batch * groups;
  if (dtype == 1) {
    switch (vec) {
      case 8: return fwd<bf16, 8>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
      case 4: return fwd<bf16, 4>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
      case 2: return fwd<bf16, 2>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
      default: return fwd<bf16, 1>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
    }
  }
  switch (vec) {
    case 4: return fwd<float, 4>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
    case 2: return fwd<float, 2>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
    default: return fwd<float, 1>(x, out, gamma, beta, shift, m, r, slices, threads, p, s);
  }
}

// gy in the forward output's layout (wrapped when wrap); sums: (B, C, 2)
// f32 scratch; dgamma / dbeta in the parameters' dtype; dshift (B, C) in the
// shift's dtype, or null.
extern "C" int group_norm_act_bwd(const void* x, const void* gy, void* dx,
                                  const void* gamma, const void* beta,
                                  const void* shift, const void* mean,
                                  const void* rstd, void* sums, void* dgamma,
                                  void* dbeta, void* dshift,
                                  const Split* split, int batch, int C,
                                  int groups, int W, int H, int dtype,
                                  int pbf16, int sbf16, int act, int wrap,
                                  float eps, void* stream) {
  const Plan p = make_plan(*split, C, groups, W, H, act, wrap, pbf16, sbf16,
                           eps);
  const int threads = split->threads, vec = split->vec;
  if (groups <= 0 || C % groups != 0 || !valid(p, batch, threads, dtype, vec) ||
      (p.stage_g && !p.stage_x))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* sm = static_cast<float*>(sums);
  const int slices = batch * groups;
  int err;
  if (dtype == 1) {
    switch (vec) {
      case 8: err = bwd<bf16, 8>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
      case 4: err = bwd<bf16, 4>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
      case 2: err = bwd<bf16, 2>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
      default: err = bwd<bf16, 1>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
    }
  } else {
    switch (vec) {
      case 4: err = bwd<float, 4>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
      case 2: err = bwd<float, 2>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
      default: err = bwd<float, 1>(x, gy, dx, gamma, beta, shift, m, r, sm, dshift, slices, threads, p, s); break;
    }
  }
  if (err != 0) return err;
  group_norm_act_bwd_params_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      sm, dgamma, dbeta, batch, C, pbf16);
  return static_cast<int>(cudaGetLastError());
}
