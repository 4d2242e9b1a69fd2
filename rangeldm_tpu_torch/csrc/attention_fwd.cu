// Fused small-head softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rangeldm_tpu/ops/attention.py::_attn_kernel
// (launched by fused_attention_t). Same layout and numerics:
//   q, k, v, out : (N = batch * heads, D = 8, T), f32 or bf16, contiguous
//   l[t, s] = (sum_d q[d, t] k[d, s]) * scale * log2(e)      in f32
//   m[t]    = max_s l[t, s]                                   in f32
//   e[t, s] = exp2(l[t, s] - m[t]), rounded to the input dtype
//   out[d, t] = (sum_s e[t, s] v[d, s]) / (sum_s e[t, s])     f32 sums
// Rounding e to bf16 before both sums is what the TPU kernel does (it casts
// e to the compute dtype before its PV matmul and takes the denominator
// from a ones row of the same product), so bf16 results agree with it.
//
// What bounds it on this card. Per (query, key) pair the work is 4 * D
// flops of products and one exponential. On the tensor cores the products
// take a few percent of the time; what is left is the exponential (ex2 on
// the special-function units, 16 per SM per clock: 0.13 ms for N = 512,
// T = 1024 on 132 SMs at 1.98 GHz) and the f32 elementwise work around it
// (scale, max, subtract, round) on the FP32 pipes. Bytes are minimal: q, k, v read
// once, out written once, nothing of the T x T logits in device memory.
// The first version of this kernel walked shared memory one scalar at a
// time (24 warp-wide loads per 32 pairs) and was bound by those loads.
//
// Design of the bf16 kernel (both user paths run it), from the tile core in
// attention_tile.cuh:
//   * one block per (head, 128 queries): 8 warps, each owning 16 queries
//     whose q fragment stays in registers; grid = (N, ceil(T / 128)).
//     8 warps stage a head half as often as 4 (utils/warps_sweep.py)
//   * the head's K and V staged once per block in shared memory, d-major
//     with a padded row stride (conflict-free ldmatrix), by 16-byte cp.async
//   * the logits tile (16 queries x 16 keys) is two mma.m16n8k8 products in
//     f32; the base-2 logit is rounded on its own before the max subtraction
//   * two passes over the keys: the first finds the exact row max (quad
//     shuffles), the second forms e = bf16(exp2(l - m)) in registers as the
//     A operand of mma.m16n8k16 against V (n = 8 = D) and against a ones
//     operand for the denominator, both summed in f32. No online softmax: it
//     would round e against a running max and change bf16 results
//   * ragged T: the last key tile is masked to -inf; query rows past T are
//     computed on zeros and not stored.
// The f32 kernel runs on the CUDA cores (TF32 tensor cores would break the
// f32 tolerance): one thread per query holding its q, the head's K and V
// staged key-major, (T, 8), and read as two broadcast float4 loads per key;
// the 8-wide products are sequential fused multiply-adds in f32.

#include "attention_tile.cuh"

namespace {

using attn::bf16;
using attn::kD;

constexpr int kWarps = 8;   // 16 rows each; utils/warps_sweep.py times 2-16
constexpr int kThreads32 = 128;

__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int seq,
                   float logit_scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = attn::padded_stride(seq);
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kD * stride;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  attn::stage_rows(sk, k + head, seq, stride, vec);
  attn::stage_rows(sv, v + head, seq, stride, vec);
  attn::cp_async_wait();
  __syncthreads();

  const int row0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * attn::kTile;
  if (row0 >= seq) return;                      // whole warp past T
  uint32_t qa[2];
  attn::load_a(qa, q + head, seq, row0);

  float m[2] = {-INFINITY, -INFINITY};
  attn::for_each_tile(seq, [&](int s0, auto masked) {
    float l[2][4];
    attn::logit_tile<decltype(masked)::value>(l, qa, sk, stride, s0,
                                              logit_scale, seq);
    attn::tile_max(m, l);
  });
  float mm[2][4];
  attn::row_stat(mm, attn::quad_max(m[0]), attn::quad_max(m[1]));

  float acc[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones[2] = {attn::kOnes, attn::kOnes};
  attn::for_each_tile(seq, [&](int s0, auto masked) {
    float l[2][4];
    attn::logit_tile<decltype(masked)::value>(l, qa, sk, stride, s0,
                                              logit_scale, seq);
    uint32_t e[4], vb[2];
    attn::exp_tile(e, l, mm);
    attn::ldsm(vb, sv, stride, s0);
    attn::mma_k16(acc, e, vb);
    attn::mma_k16(den, e, ones);
  });
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = acc[i] / den[i];
  attn::store_rows(out + head, seq, row0, acc);
}

__global__ void __launch_bounds__(kThreads32)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int seq, float logit_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sk = reinterpret_cast<float4*>(smem_raw);
  float4* sv = sk + 2 * seq;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  attn::stage_keys_f32(reinterpret_cast<float*>(sk), k + head, seq);
  attn::stage_keys_f32(reinterpret_cast<float*>(sv), v + head, seq);
  __syncthreads();

  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= seq) return;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = q[head + d * seq + t];

  float kr[kD], vr[kD];
  float m = -INFINITY;
  for (int s = 0; s < seq; ++s) {
    attn::unpack8(kr, sk + 2 * s);
    m = fmaxf(m, attn::dot8(qr, kr) * logit_scale);
  }

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float denom = 0.f;
  for (int s = 0; s < seq; ++s) {
    attn::unpack8(kr, sk + 2 * s);
    attn::unpack8(vr, sv + 2 * s);
    const float e = exp2f(attn::dot8(qr, kr) * logit_scale - m);
    denom += e;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = fmaf(e, vr[d], acc[d]);
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) out[head + d * seq + t] = acc[d] / denom;
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int n,
                int seq, float logit_scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kD) * attn::padded_stride(seq) *
                      sizeof(bf16);
  static size_t opted = 48 * 1024;
  cudaError_t err = attn::opt_in(attention_fwd_bf16, smem, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = attn::vec_ok(seq, k) && attn::vec_ok(seq, v);
  const int rows = kWarps * attn::kTile;
  const dim3 grid(n, (seq + rows - 1) / rows);
  attention_fwd_bf16<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), seq, logit_scale,
      vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int n,
               int seq, float logit_scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kD) * seq * sizeof(float);
  static size_t opted = 48 * 1024;
  cudaError_t err = attn::opt_in(attention_fwd_f32, smem, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n, (seq + kThreads32 - 1) / kThreads32);
  attention_fwd_f32<<<grid, kThreads32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), seq,
      logit_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int n, int d, int seq, int dtype,
                             float logit_scale, void* stream) {
  if (d != kD || n <= 0 || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, out, n, seq, logit_scale, s);
  if (dtype == 1) return launch_bf16(q, k, v, out, n, seq, logit_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
