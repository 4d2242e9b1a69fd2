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
// What bounds it on this card: with head_dim 8 each (query, key) pair costs
// 4 * 8 flops of matrix work but also one exponential. At T = 1024 a head
// needs 1 M exponentials against 33.5 MFLOP, and the bytes moved are only
// 4 * 8 * T values per head, so the work is bound by operations, not bytes:
// the matrix flops on tensor cores would take less time than the
// exponentials on the special-function units (16 per SM per clock).
// What the design does about it: nothing of the T x T score matrix goes to
// device memory, so bytes stay at the minimum (q, k, v read once, out
// written once); the products run on the CUDA cores in f32. This first
// version reads K and V from shared memory one value at a time (24 scalar
// loads per pair over the two passes), which is expected to limit it before
// the exponentials do; key-major K/V with vector loads, then tensor-core
// products with D padded to 16, are the next steps.
//
// Design (simple first):
//   * one block per (head, tile of kThreads queries); grid = (N, ceil(T / kThreads))
//   * the head's K and V (D * T values each) are staged once in shared
//     memory in the input dtype; every thread of a warp reads the same key
//     at once, so shared reads are broadcasts without bank conflicts
//   * one thread per query holds its 8-wide q, the running sums and the
//     8 output accumulators in registers
//   * two passes over the keys: the first finds the exact row max, the
//     second forms e with that max, so e is rounded exactly where the TPU
//     kernel rounds it (an online softmax would round it against a running
//     max and rescale, which changes bf16 results)
//   * queries past T (a ragged last tile) load shared memory and then idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 8;
constexpr int kThreads = 128;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int seq,
                     float logit_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kD * seq;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  const T* kh = k + head;
  const T* vh = v + head;
  for (int i = threadIdx.x; i < kD * seq; i += blockDim.x) {
    sk[i] = kh[i];
    sv[i] = vh[i];
  }
  __syncthreads();

  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= seq) return;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = Io<T>::load(q[head + d * seq + t]);

  float m = -INFINITY;
  for (int s = 0; s < seq; ++s) {
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], Io<T>::load(sk[d * seq + s]), dot);
    m = fmaxf(m, dot * logit_scale);
  }

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float denom = 0.f;
  for (int s = 0; s < seq; ++s) {
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], Io<T>::load(sk[d * seq + s]), dot);
    const float e = Io<T>::round(exp2f(dot * logit_scale - m));
    denom += e;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = fmaf(e, Io<T>::load(sv[d * seq + s]), acc[d]);
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) out[head + d * seq + t] = Io<T>::store(acc[d] / denom);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int n,
           int seq, float logit_scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kD) * seq * sizeof(T);
  // above 48 KB dynamic shared memory must be opted into once per size
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid(n, (seq + kThreads - 1) / kThreads);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, logit_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int n, int d, int seq, int dtype,
                             float logit_scale, void* stream) {
  if (d != kD || n <= 0 || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, n, seq, logit_scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, n, seq, logit_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
