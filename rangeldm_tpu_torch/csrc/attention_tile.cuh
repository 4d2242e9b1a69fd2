// The tile core shared by the bf16 attention kernels (attention_fwd.cu,
// attention_bwd.cu) for Hopper (sm_90a): staging a head in shared memory,
// the 16 x 16 logits tile on the tensor cores, the exact row max and the
// rounded exponential packed straight into the next product's operand. At
// the end, the few helpers of the f32 kernels.
//
// Shared-memory layout: an operand of one head, (D = 8, T) in device memory,
// is kept d-major, 8 rows of `padded_stride(T)` bf16 values. The stride is
// T rounded up to 16 keys (whole 16-key tiles, the tail zero-filled) plus 8,
// so a row is an odd number of 16-byte units long: the 8 rows that one
// ldmatrix reads (16 bytes each, at one key offset) fall in 8 different
// 16-byte bank groups and the read has no bank conflict. ldmatrix.trans of
// such an 8 x 8 block gives the B operand of a logits product (k = d,
// n = key); ldmatrix without .trans gives the B operand of a product that
// sums over keys (k = key, n = d).
//
// Fragments follow the PTX layouts of mma.m16n8k8 / m16n8k16 (row.col):
// with g = lane / 4 and c = lane % 4, a thread holds rows g and g + 8 and
// columns 2c, 2c + 1 (and 2c + 8, 2c + 9 for the second half of a
// 16-column tile). A 16 x 16 f32 tile is two m16n8 accumulators, l[0] for
// columns 0-7 and l[1] for columns 8-15, each {(g, 2c), (g, 2c+1),
// (g+8, 2c), (g+8, 2c+1)}. Packed to bf16 pairs in the order
// {l[0][0..1], l[0][2..3], l[1][0..1], l[1][2..3]} it is exactly the A
// operand of m16n8k16 over those 16 columns (FlashAttention-2's register
// re-use: no trip through shared memory).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kD = 8;
constexpr int kTile = 16;            // keys (or queries) per tile; rows per warp
using bf16 = __nv_bfloat16;

// bf16 values per shared-memory row of a staged (8, seq) operand
__host__ __device__ inline int padded_stride(int seq) {
  return (seq + kTile - 1) / kTile * kTile + 8;
}

template <bool B>
struct Masked {
  static constexpr bool value = B;
};

// f(s0, Masked<false>) for every whole 16-wide tile, then f(s0, Masked<true>)
// for the ragged last one, if any.
template <typename F>
__device__ __forceinline__ void for_each_tile(int seq, F&& f) {
  const int full = seq & ~(kTile - 1);
  for (int s0 = 0; s0 < full; s0 += kTile) f(s0, Masked<false>{});
  if (full < seq) f(full, Masked<true>{});
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy an (8, seq) bf16 operand from device memory into 8 shared rows of
// `stride` values and zero the rest of each row. With `vec` (seq % 8 == 0 and
// a 16-byte aligned source) as 16-byte cp.async copies, else one value at a
// time. The caller waits (cp_async_wait) and synchronises.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int seq,
                                           int stride, bool vec) {
  if (vec) {
    const int chunks = seq >> 3;
    for (int i = threadIdx.x; i < kD * chunks; i += blockDim.x) {
      const int d = i / chunks, c = i - d * chunks;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + d * stride + c * 8)),
                   "l"(src + static_cast<size_t>(d) * seq + c * 8));
    }
  } else {
    for (int i = threadIdx.x; i < kD * seq; i += blockDim.x) {
      const int d = i / seq;
      dst[d * stride + i - d * seq] = src[i];
    }
  }
  const int tail = stride - seq;
  for (int i = threadIdx.x; i < kD * tail; i += blockDim.x) {
    const int d = i / tail;
    dst[d * stride + seq + i - d * tail] = __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The A operand (16 rows x 8 d) of rows row0 .. row0 + 15 of an (8, seq)
// operand in device memory; rows past seq are zero. Read once per warp.
__device__ __forceinline__ void load_a(uint32_t (&a)[2], const bf16* src,
                                       int seq, int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    uint32_t lo = 0, hi = 0;
    if (r < seq) {
      lo = __bfloat16_as_ushort(src[static_cast<size_t>(2 * c) * seq + r]);
      hi = __bfloat16_as_ushort(src[static_cast<size_t>(2 * c + 1) * seq + r]);
    }
    a[h] = lo | (hi << 16);
  }
}

// ldmatrix.x2 of the 8 x 16 block at column s0 of 8 staged rows: matrix 0
// holds columns s0 .. s0 + 7, matrix 1 columns s0 + 8 .. s0 + 15.
__device__ __forceinline__ uint32_t tile_addr(const bf16* rows, int stride,
                                              int s0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(rows + (lane & 7) * stride + s0 + ((lane >> 3) & 1) * 8);
}

// B operands of two m16n8k8 logits products (k = d, n = 16 columns)
__device__ __forceinline__ void ldsm_trans(uint32_t (&b)[2], const bf16* rows,
                                           int stride, int s0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(tile_addr(rows, stride, s0)));
}

// B operand of one m16n8k16 product over 16 columns (k = column, n = d)
__device__ __forceinline__ void ldsm(uint32_t (&b)[2], const bf16* rows,
                                     int stride, int s0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(tile_addr(rows, stride, s0)));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2],
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B operand of all ones: a product against it sums the A rows in f32
// (the TPU kernel's ones row under its PV product)
constexpr uint32_t kOnes = 0x3F803F80u;

// The 16 x 16 tile of 8-wide dot products of the warp's 16 rows (A operand
// a) with 16 staged columns at s0, in f32 on the tensor cores.
__device__ __forceinline__ void dot_tile(float (&l)[2][4],
                                         const uint32_t (&a)[2],
                                         const bf16* rows, int stride,
                                         int s0) {
  uint32_t b[2];
  ldsm_trans(b, rows, stride, s0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l[j][i] = 0.f;
    mma_k8(l[j], a, b[j]);
  }
}

// The base-2 logits tile: each dot times scale * log2(e), rounded on its own
// (__fmul_rn: no fused multiply-add with the max subtraction that follows).
// Masked: columns at or past seq become -inf, so they add nothing.
template <bool kMask>
__device__ __forceinline__ void logit_tile(float (&l)[2][4],
                                           const uint32_t (&a)[2],
                                           const bf16* rows, int stride,
                                           int s0, float logit_scale,
                                           int seq) {
  dot_tile(l, a, rows, stride, s0);
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[j][i] = __fmul_rn(l[j][i], logit_scale);
      if (kMask && s0 + 8 * j + 2 * c + (i & 1) >= seq) l[j][i] = -INFINITY;
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exact max over a row of the tile, per thread (rows g: m[0], g + 8: m[1])
__device__ __forceinline__ void tile_max(float (&m)[2], const float (&l)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    m[0] = fmaxf(m[0], fmaxf(l[j][0], l[j][1]));
    m[1] = fmaxf(m[1], fmaxf(l[j][2], l[j][3]));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 pair {lo, hi}, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float lo_of(uint32_t p) {
  return __uint_as_float(p << 16);
}

__device__ __forceinline__ float hi_of(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// element (j, i) of a tile packed by pack_tile, back in f32
__device__ __forceinline__ float unpacked(const uint32_t (&p)[4], int j,
                                          int i) {
  const uint32_t w = p[2 * j + (i >> 1)];
  return (i & 1) ? hi_of(w) : lo_of(w);
}

// f32 tile -> bf16 A operand of m16n8k16 over the tile's 16 columns
__device__ __forceinline__ void pack_tile(uint32_t (&p)[4],
                                          const float (&x)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    p[2 * j] = pack(x[j][0], x[j][1]);
    p[2 * j + 1] = pack(x[j][2], x[j][3]);
  }
}

// e = bf16(exp2(l - m)) for every element, m given per element, packed as
// the A operand of the next product. exp2(-inf) = 0 for masked columns.
__device__ __forceinline__ void exp_tile(uint32_t (&e)[4],
                                         const float (&l)[2][4],
                                         const float (&m)[2][4]) {
  float x[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = ex2(l[j][i] - m[j][i]);
  pack_tile(e, x);
}

// per-element offsets of a row statistic: m0 for row g, m1 for row g + 8
__device__ __forceinline__ void row_stat(float (&s)[2][4], float m0, float m1) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[j][0] = s[j][1] = m0;
    s[j][2] = s[j][3] = m1;
  }
}

// per-element values of a column statistic kept in shared memory (one f32
// per column): columns s0 + 8j + 2c and + 1 of the tile
__device__ __forceinline__ void col_stat(float (&s)[2][4], const float* stat,
                                         int s0) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(stat + s0 + 8 * j + 2 * c);
    s[j][0] = s[j][2] = v.x;
    s[j][1] = s[j][3] = v.y;
  }
}

// Write an m16n8 f32 accumulator (rows row0 + g, + 8; d = 2c, 2c + 1) to an
// (8, seq) bf16 operand in device memory, rows past seq left out.
__device__ __forceinline__ void store_rows(bf16* dst, int seq, int row0,
                                           const float (&acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + g + 8 * (i >> 1);
    if (r < seq)
      dst[static_cast<size_t>(2 * c + (i & 1)) * seq + r] = __float2bfloat16(acc[i]);
  }
}

// The f32 kernels run on the CUDA cores (TF32 would break their tolerance)
// and share only these helpers.

// Stage an (8, seq) f32 operand key-major, (seq, 8), each value times
// mul[t] if mul is given.
__device__ __forceinline__ void stage_keys_f32(float* dst, const float* src,
                                               int seq,
                                               const float* mul = nullptr) {
  for (int i = threadIdx.x; i < kD * seq; i += blockDim.x) {
    const int d = i / seq, t = i - d * seq;
    dst[t * kD + d] = mul ? src[i] * mul[t] : src[i];
  }
}

__device__ __forceinline__ void unpack8(float (&x)[kD], const float4* p) {
  const float4 lo = p[0], hi = p[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// sum_d a[d] * b[d], one fused multiply-add at a time in the order d = 0..7
__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) dot = fmaf(a[d], b[d], dot);
  return dot;
}

// above 48 KB dynamic shared memory must be opted into once per size
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t* opted) {
  if (smem <= *opted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *opted = smem;
  return err;
}

// 16-byte copies need seq % 8 == 0 (every row of every head starts on a
// 16-byte boundary) and 16-byte aligned base pointers
inline bool vec_ok(int seq, const void* p) {
  return seq % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace attn
