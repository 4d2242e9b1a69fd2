// Fused small-head softmax attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rangeldm_tpu/ops/attention.py::_attn_bwd_kernel
// (launched by fused_attention_bwd_t). Same layout and numerics:
//   q, k, v, g, dq, dk, dv : (N = batch * heads, D = 8, T), f32 or bf16
//   l[t, s]  = (sum_d q[d, t] k[d, s]) * scale * log2(e)          in f32
//   m[t]     = max_s l[t, s]
//   eb[t, s] = exp2(l[t, s] - m[t]), rounded to the input dtype
//   inv_s[t] = 1 / sum_s eb[t, s]
//   dp[t, s] = sum_d g[d, t] v[d, s]                               in f32
//   gp[d, t] = g[d, t] * inv_s[t], rounded to the input dtype
//   dv[d, s] = sum_t gp[d, t] eb[t, s]
//   c[t]     = (sum_s dp[t, s] eb[t, s]) * inv_s[t]
//   dl[t, s] = (eb[t, s] (dp[t, s] - c[t])) * (inv_s[t] * scale), rounded
//   dq[d, t] = sum_s k[d, s] dl[t, s] ;  dk[d, s] = sum_t q[d, t] dl[t, s]
// All sums are f32. eb, gp and dl are rounded where the TPU kernel rounds
// them (it casts each to the compute dtype before a matmul), so bf16 results
// agree with it; p = eb * inv_s is never formed.
//
// What bounds it on this card: per (query, key) pair it does the four 8-wide
// products (l, dp, and the dq and dk or dv sums) of 10 * D flops in all,
// plus exponentials, while the bytes moved are 7 * D * T values per head
// (q, k, v, g read once, dq, dk, dv written once). At the flagship shapes
// the work is bound by operations, not bytes.
// What the design does about it: nothing of the T x T matrices goes to
// device memory; the products run on the CUDA cores in f32 out of shared
// memory. This first version reads shared memory one value at a time and
// recomputes l, eb and dp in both launches; vector loads, tensor-core
// products and a single fused pass are the next steps.
//
// Design (simple first), two launches on one stream:
//   A. rows: one block per (head, tile of kThreads queries), the head's K
//      and V in shared memory, one thread per query. Pass 1 finds the exact
//      row max m; pass 2 forms eb, its row sum and sum dp * eb; pass 3 forms
//      dl and accumulates dq. Each thread writes its row's m, inv_s and c in
//      f32 to the workspace stats (N, 3, T).
//   B. columns: one block per (head, tile of kThreads keys), the head's Q, G,
//      gp and the row statistics in shared memory, one thread per key. It
//      loops over the queries, recomputes eb and dl exactly as launch A did
//      (same operations in the same order), and accumulates dv and dk.
// Two launches need no atomics, and each output is written once. Ragged T
// is masked: threads past T load shared memory and then idle.

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

// The base-2 logit of one pair. __fmul_rn keeps the product rounded on its
// own (no fused multiply-add with the max subtraction), as on the TPU.
template <typename T>
__device__ __forceinline__ float logit(const float* a, const T* b, int stride,
                                       int col, float logit_scale) {
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) dot = fmaf(a[d], Io<T>::load(b[d * stride + col]), dot);
  return __fmul_rn(dot, logit_scale);
}

template <typename T>
__device__ __forceinline__ float dot8(const float* a, const T* b, int stride,
                                      int col) {
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) dot = fmaf(a[d], Io<T>::load(b[d * stride + col]), dot);
  return dot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   T* __restrict__ dq, float* __restrict__ stats, int seq,
                   float logit_scale, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kD * seq;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  for (int i = threadIdx.x; i < kD * seq; i += blockDim.x) {
    sk[i] = k[head + i];
    sv[i] = v[head + i];
  }
  __syncthreads();

  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= seq) return;

  float qr[kD], gr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = Io<T>::load(q[head + d * seq + t]);
    gr[d] = Io<T>::load(g[head + d * seq + t]);
  }

  float m = -INFINITY;
  for (int s = 0; s < seq; ++s) m = fmaxf(m, logit(qr, sk, seq, s, logit_scale));

  float sum = 0.f, sum_dp = 0.f;
  for (int s = 0; s < seq; ++s) {
    const float eb = Io<T>::round(exp2f(logit(qr, sk, seq, s, logit_scale) - m));
    sum += eb;
    sum_dp = fmaf(dot8(gr, sv, seq, s), eb, sum_dp);
  }
  const float inv_s = 1.f / sum;
  const float c = sum_dp * inv_s;
  const float dl_scale = inv_s * scale;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  for (int s = 0; s < seq; ++s) {
    const float eb = Io<T>::round(exp2f(logit(qr, sk, seq, s, logit_scale) - m));
    const float dp = dot8(gr, sv, seq, s);
    const float dl = Io<T>::round(__fmul_rn(eb * (dp - c), dl_scale));
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = fmaf(Io<T>::load(sk[d * seq + s]), dl, acc[d]);
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) dq[head + d * seq + t] = Io<T>::store(acc[d]);
  float* st = stats + static_cast<size_t>(blockIdx.x) * 3 * seq;
  st[t] = m;
  st[seq + t] = inv_s;
  st[2 * seq + t] = c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_cols(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g,
                   const float* __restrict__ stats, T* __restrict__ dk,
                   T* __restrict__ dv, int seq, float logit_scale,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);   // m, inv_s, c: 3 * T
  T* sq = reinterpret_cast<T*>(sm + 3 * seq);
  T* sg = sq + kD * seq;
  T* sgp = sg + kD * seq;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  const float* st = stats + static_cast<size_t>(blockIdx.x) * 3 * seq;
  for (int i = threadIdx.x; i < 3 * seq; i += blockDim.x) sm[i] = st[i];
  for (int i = threadIdx.x; i < kD * seq; i += blockDim.x) {
    sq[i] = q[head + i];
    const T gv = g[head + i];
    sg[i] = gv;
    sgp[i] = Io<T>::store(Io<T>::load(gv) * st[seq + i % seq]);
  }
  __syncthreads();

  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= seq) return;

  float kr[kD], vr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    kr[d] = Io<T>::load(k[head + d * seq + s]);
    vr[d] = Io<T>::load(v[head + d * seq + s]);
  }
  const float* sinv = sm + seq;
  const float* sc = sm + 2 * seq;

  float adk[kD], adv[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) adk[d] = adv[d] = 0.f;
  for (int t = 0; t < seq; ++t) {
    // the same operands in the same order as launch A, so eb and dl are
    // bit-identical to the values that went into dq
    const float eb = Io<T>::round(exp2f(logit(kr, sq, seq, t, logit_scale) - sm[t]));
    const float dp = dot8(vr, sg, seq, t);
    const float dl = Io<T>::round(__fmul_rn(eb * (dp - sc[t]), sinv[t] * scale));
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      adv[d] = fmaf(Io<T>::load(sgp[d * seq + t]), eb, adv[d]);
      adk[d] = fmaf(Io<T>::load(sq[d * seq + t]), dl, adk[d]);
    }
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk[head + d * seq + s] = Io<T>::store(adk[d]);
    dv[head + d * seq + s] = Io<T>::store(adv[d]);
  }
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g,
           void* dq, void* dk, void* dv, float* stats, int n, int seq,
           float logit_scale, float scale, cudaStream_t stream) {
  const size_t smem_rows = 2 * static_cast<size_t>(kD) * seq * sizeof(T);
  const size_t smem_cols = 3 * static_cast<size_t>(seq) * sizeof(float) +
                           3 * static_cast<size_t>(kD) * seq * sizeof(T);
  static size_t opted_rows = 48 * 1024, opted_cols = 48 * 1024;
  cudaError_t err = opt_in(attention_bwd_rows<T>, smem_rows, &opted_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = opt_in(attention_bwd_cols<T>, smem_cols, &opted_cols);
  if (err != cudaSuccess) return static_cast<int>(err);

  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const dim3 grid(n, (seq + kThreads - 1) / kThreads);
  attention_bwd_rows<T><<<grid, kThreads, smem_rows, stream>>>(
      qp, kp, vp, gp, static_cast<T*>(dq), stats, seq, logit_scale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_cols<T><<<grid, kThreads, smem_cols, stream>>>(
      qp, kp, vp, gp, stats, static_cast<T*>(dk), static_cast<T*>(dv), seq,
      logit_scale, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats is an f32 workspace of
// n * 3 * seq values. logit_scale = scale * log2(e). Returns the
// cudaError_t of the launches.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* g, void* dq, void* dk, void* dv,
                             void* stats, int n, int d, int seq, int dtype,
                             float logit_scale, float scale, void* stream) {
  if (d != kD || n <= 0 || seq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(stats);
  if (dtype == 0)
    return launch<float>(q, k, v, g, dq, dk, dv, ws, n, seq, logit_scale, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, ws, n, seq, logit_scale,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
