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
// What bounds it on this card. Per (query, key) pair: five 8-wide products
// (l, dp, dv, dq, dk; 10 * D flops), three exponentials (two in the rows
// launch, one in the columns launch) and some fifteen f32 elementwise
// operations (scale, max, subtract, round, dl). On the tensor cores the
// products are a few percent of the time; the floor is the exponentials on
// the special-function units (16 per SM per clock: 0.39 ms for N = 512,
// T = 1024 on 132 SMs at 1.98 GHz) and the elementwise work on the FP32
// pipes. Bytes are minimal: q, k, v, g read once, dq, dk, dv written once,
// plus the (N, 3, T) f32 row statistics. The first version walked shared memory one
// scalar at a time (about 67 warp-wide loads per 32 pairs) and was bound by
// those loads.
//
// Design of the bf16 kernels (both user paths run them), from the tile core
// in attention_tile.cuh, two launches on one stream, no atomics, each output
// written once, so two calls give bit-identical outputs:
//   A. rows: one block per (head, 128 queries), 8 warps of 16 queries
//      holding their q and g fragments; the head's K and V staged once per
//      block.
//      Pass 1: the exact row max of the logits tile (mma.m16n8k8).
//      Pass 2: eb = bf16(exp2(l - m)) packed in registers as the A operand
//      of mma.m16n8k16 against a ones operand (sum eb) and against V
//      (o = eb v^T). sum_s dp eb is formed as sum_d g[d, t] o[t, d], the
//      same sum regrouped (FlashAttention's rowsum(dO * O)), so pass 2
//      needs no dp. m, inv_s and c go to the f32 workspace (N, 3, T).
//      Pass 3: eb again, dp = g^T v (m16n8k8), dl, then dq += dl k^T
//      (m16n8k16 with dl packed as its A operand).
//   B. columns: one block per (head, 128 keys), warps of 16 keys holding
//      their k and v fragments; the head's Q, G, gp = bf16(g * inv_s) and
//      the per-query m, c and inv_s * scale staged once per block (gp and
//      inv_s * scale formed while staging). For each 16-query tile:
//      l^T = k^T q and dp^T = v^T g (m16n8k8), eb^T and dl^T, then
//      dv += eb^T gp^T and dk += dl^T q^T (m16n8k16).
// Bit-identity of the two launches: launch B forms eb and dl with the same
// f32 operations on the same operands as launch A (m, c and inv_s from the
// workspace; __fmul_rn keeps every product rounded on its own). Its dots
// come from the transposed product, whose k dimension is still d: each
// tensor-core dot sums the same eight exact bf16 products in the same k
// order, so eb and dl, and with them the dl behind dk and the dl behind dq,
// are bit-identical as long as the tensor core's sum depends only on the
// k-ordered products, which the transposition does not change. This is a
// property of the hardware, not checked by a test.
// Ragged T: the last key tile of launch A is masked to -inf; padded queries
// in launch B have zero q, g, gp, m, c and inv_s * scale, so they add zero.
// The staged operands use padded d-major rows (see attention_tile.cuh).
//
// The f32 kernels run on the CUDA cores (TF32 tensor cores would break the
// f32 tolerances): the same two launches and workspace, one thread per query
// (A) or key (B), operands staged key-major, (T, 8), and read as two
// broadcast float4 loads per key; launch B recomputes eb and dl with the
// same operations in the same order as launch A, so they are bit-identical.

#include "attention_tile.cuh"

namespace {

using attn::bf16;
using attn::kD;

constexpr int kWarps = 8;   // 16 rows each; utils/warps_sweep.py times 2-16
constexpr int kThreads32 = 128;

__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_rows_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        bf16* __restrict__ dq, float* __restrict__ stats,
                        int seq, float logit_scale, float scale, bool vec) {
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
  uint32_t qa[2], ga[2];
  attn::load_a(qa, q + head, seq, row0);
  attn::load_a(ga, g + head, seq, row0);

  // pass 1: exact row max
  float m[2] = {-INFINITY, -INFINITY};
  attn::for_each_tile(seq, [&](int s0, auto masked) {
    float l[2][4];
    attn::logit_tile<decltype(masked)::value>(l, qa, sk, stride, s0,
                                              logit_scale, seq);
    attn::tile_max(m, l);
  });
  m[0] = attn::quad_max(m[0]);
  m[1] = attn::quad_max(m[1]);
  float mm[2][4];
  attn::row_stat(mm, m[0], m[1]);

  // pass 2: sum eb and o = eb v^T
  float o[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones[2] = {attn::kOnes, attn::kOnes};
  attn::for_each_tile(seq, [&](int s0, auto masked) {
    float l[2][4];
    attn::logit_tile<decltype(masked)::value>(l, qa, sk, stride, s0,
                                              logit_scale, seq);
    uint32_t e[4], vb[2];
    attn::exp_tile(e, l, mm);
    attn::ldsm(vb, sv, stride, s0);
    attn::mma_k16(o, e, vb);
    attn::mma_k16(den, e, ones);
  });
  // o[2h + i] and ga[h] hold d = 2c + i of row g + 8h
  float inv[2], c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    inv[h] = 1.f / den[2 * h];
    const float part = fmaf(attn::lo_of(ga[h]), o[2 * h],
                            attn::hi_of(ga[h]) * o[2 * h + 1]);
    c[h] = attn::quad_sum(part) * inv[h];
  }
  float cc[2][4], dls[2][4];
  attn::row_stat(cc, c[0], c[1]);
  attn::row_stat(dls, __fmul_rn(inv[0], scale), __fmul_rn(inv[1], scale));

  // pass 3: dl and dq
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  attn::for_each_tile(seq, [&](int s0, auto masked) {
    float l[2][4], dp[2][4], dl[2][4];
    attn::logit_tile<decltype(masked)::value>(l, qa, sk, stride, s0,
                                              logit_scale, seq);
    uint32_t e[4], da[4], kb[2];
    attn::exp_tile(e, l, mm);
    attn::dot_tile(dp, ga, sv, stride, s0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dl[j][i] = __fmul_rn(
            __fmul_rn(attn::unpacked(e, j, i), __fsub_rn(dp[j][i], cc[j][i])),
            dls[j][i]);
    attn::pack_tile(da, dl);
    attn::ldsm(kb, sk, stride, s0);
    attn::mma_k16(acc, da, kb);
  });
  attn::store_rows(dq + head, seq, row0, acc);

  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    float* st = stats + static_cast<size_t>(blockIdx.x) * 3 * seq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = row0 + (lane >> 2) + 8 * h;
      if (t < seq) {
        st[t] = m[h];
        st[seq + t] = inv[h];
        st[2 * seq + t] = c[h];
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_cols_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ stats, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int seq, float logit_scale,
                        float scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = attn::padded_stride(seq);
  float* sm = reinterpret_cast<float*>(smem_raw);   // m, c, inv_s * scale
  float* sc = sm + stride;
  float* sdls = sc + stride;
  bf16* sq = reinterpret_cast<bf16*>(sdls + stride);
  bf16* sg = sq + kD * stride;
  bf16* sgp = sg + kD * stride;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  const float* st = stats + static_cast<size_t>(blockIdx.x) * 3 * seq;
  attn::stage_rows(sq, q + head, seq, stride, vec);
  attn::stage_rows(sg, g + head, seq, stride, vec);
  for (int t = threadIdx.x; t < stride; t += blockDim.x) {
    const bool in = t < seq;
    sm[t] = in ? st[t] : 0.f;
    sdls[t] = in ? st[seq + t] : 0.f;               // inv_s for now
    sc[t] = in ? st[2 * seq + t] : 0.f;
  }
  attn::cp_async_wait();
  __syncthreads();
  // gp = bf16(g * inv_s), then inv_s * scale in place; one thread per query
  for (int t = threadIdx.x; t < stride; t += blockDim.x) {
    const float inv = sdls[t];
#pragma unroll
    for (int d = 0; d < kD; ++d)
      sgp[d * stride + t] =
          __float2bfloat16(__fmul_rn(__bfloat162float(sg[d * stride + t]), inv));
    sdls[t] = __fmul_rn(inv, scale);
  }
  __syncthreads();

  const int col0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * attn::kTile;
  if (col0 >= seq) return;                      // whole warp past T
  uint32_t ka[2], va[2];
  attn::load_a(ka, k + head, seq, col0);
  attn::load_a(va, v + head, seq, col0);

  float adk[4] = {0.f, 0.f, 0.f, 0.f}, adv[4] = {0.f, 0.f, 0.f, 0.f};
  // padded queries add zero, so every query tile runs unmasked
  for (int t0 = 0; t0 < seq; t0 += attn::kTile) {
    float l[2][4], dp[2][4], dl[2][4], mm[2][4], cc[2][4], dls[2][4];
    attn::dot_tile(l, ka, sq, stride, t0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) l[j][i] = __fmul_rn(l[j][i], logit_scale);
    attn::col_stat(mm, sm, t0);
    uint32_t e[4], da[4], b[2];
    attn::exp_tile(e, l, mm);
    attn::dot_tile(dp, va, sg, stride, t0);
    attn::col_stat(cc, sc, t0);
    attn::col_stat(dls, sdls, t0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dl[j][i] = __fmul_rn(
            __fmul_rn(attn::unpacked(e, j, i), __fsub_rn(dp[j][i], cc[j][i])),
            dls[j][i]);
    attn::pack_tile(da, dl);
    attn::ldsm(b, sgp, stride, t0);
    attn::mma_k16(adv, e, b);
    attn::ldsm(b, sq, stride, t0);
    attn::mma_k16(adk, da, b);
  }
  attn::store_rows(dk + head, seq, col0, adk);
  attn::store_rows(dv + head, seq, col0, adv);
}

// The f32 kernels.

using attn::dot8;
using attn::stage_keys_f32;
using attn::unpack8;

// The base-2 logit of one pair. __fmul_rn keeps the product rounded on its
// own (no fused multiply-add with the max subtraction), as on the TPU.
__device__ __forceinline__ float logit32(const float* a, const float* b,
                                         float logit_scale) {
  return __fmul_rn(dot8(a, b), logit_scale);
}

__global__ void __launch_bounds__(kThreads32)
attention_bwd_rows_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       float* __restrict__ dq, float* __restrict__ stats,
                       int seq, float logit_scale, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sk = reinterpret_cast<float4*>(smem_raw);
  float4* sv = sk + 2 * seq;

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  stage_keys_f32(reinterpret_cast<float*>(sk), k + head, seq);
  stage_keys_f32(reinterpret_cast<float*>(sv), v + head, seq);
  __syncthreads();

  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  if (t >= seq) return;

  float qr[kD], gr[kD], kr[kD], vr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = q[head + d * seq + t];
    gr[d] = g[head + d * seq + t];
  }

  float m = -INFINITY;
  for (int s = 0; s < seq; ++s) {
    unpack8(kr, sk + 2 * s);
    m = fmaxf(m, logit32(qr, kr, logit_scale));
  }

  float sum = 0.f, sum_dp = 0.f;
  for (int s = 0; s < seq; ++s) {
    unpack8(kr, sk + 2 * s);
    unpack8(vr, sv + 2 * s);
    const float eb = exp2f(logit32(qr, kr, logit_scale) - m);
    sum += eb;
    sum_dp = fmaf(dot8(gr, vr), eb, sum_dp);
  }
  const float inv_s = 1.f / sum;
  const float c = sum_dp * inv_s;
  const float dl_scale = inv_s * scale;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  for (int s = 0; s < seq; ++s) {
    unpack8(kr, sk + 2 * s);
    unpack8(vr, sv + 2 * s);
    const float eb = exp2f(logit32(qr, kr, logit_scale) - m);
    const float dp = dot8(gr, vr);
    const float dl = __fmul_rn(eb * (dp - c), dl_scale);
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = fmaf(kr[d], dl, acc[d]);
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) dq[head + d * seq + t] = acc[d];
  float* st = stats + static_cast<size_t>(blockIdx.x) * 3 * seq;
  st[t] = m;
  st[seq + t] = inv_s;
  st[2 * seq + t] = c;
}

__global__ void __launch_bounds__(kThreads32)
attention_bwd_cols_f32(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ stats, float* __restrict__ dk,
                       float* __restrict__ dv, int seq, float logit_scale,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sq = reinterpret_cast<float4*>(smem_raw);  // (T, 8) each
  float4* sg = sq + 2 * seq;
  float4* sgp = sg + 2 * seq;
  float* sm = reinterpret_cast<float*>(sgp + 2 * seq);   // m, inv_s, c: 3 * T

  const size_t head = static_cast<size_t>(blockIdx.x) * kD * seq;
  const float* st = stats + static_cast<size_t>(blockIdx.x) * 3 * seq;
  for (int i = threadIdx.x; i < 3 * seq; i += blockDim.x) sm[i] = st[i];
  stage_keys_f32(reinterpret_cast<float*>(sq), q + head, seq);
  stage_keys_f32(reinterpret_cast<float*>(sg), g + head, seq);
  stage_keys_f32(reinterpret_cast<float*>(sgp), g + head, seq, st + seq);
  __syncthreads();

  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= seq) return;

  float kr[kD], vr[kD], qr[kD], gr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    kr[d] = k[head + d * seq + s];
    vr[d] = v[head + d * seq + s];
  }
  const float* sinv = sm + seq;
  const float* sc = sm + 2 * seq;

  float adk[kD], adv[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) adk[d] = adv[d] = 0.f;
  for (int t = 0; t < seq; ++t) {
    // the same operands in the same order as the rows launch, so eb and dl
    // are bit-identical to the values that went into dq
    unpack8(qr, sq + 2 * t);
    unpack8(gr, sg + 2 * t);
    const float eb = exp2f(logit32(kr, qr, logit_scale) - sm[t]);
    const float dp = dot8(vr, gr);
    const float dl = __fmul_rn(eb * (dp - sc[t]), sinv[t] * scale);
    const float4 lo = sgp[2 * t], hi = sgp[2 * t + 1];
    const float gp[kD] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      adv[d] = fmaf(gp[d], eb, adv[d]);
      adk[d] = fmaf(qr[d], dl, adk[d]);
    }
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk[head + d * seq + s] = adk[d];
    dv[head + d * seq + s] = adv[d];
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const void* g,
                void* dq, void* dk, void* dv, float* stats, int n, int seq,
                float logit_scale, float scale, cudaStream_t stream) {
  const size_t stride = attn::padded_stride(seq);
  const size_t smem_rows = 2 * kD * stride * sizeof(bf16);
  const size_t smem_cols = 3 * stride * sizeof(float) +
                           3 * kD * stride * sizeof(bf16);
  static size_t opted_rows = 48 * 1024, opted_cols = 48 * 1024;
  cudaError_t err = attn::opt_in(attention_bwd_rows_bf16, smem_rows, &opted_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attn::opt_in(attention_bwd_cols_bf16, smem_cols, &opted_cols);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  const int rows = kWarps * attn::kTile;
  const dim3 grid(n, (seq + rows - 1) / rows);
  attention_bwd_rows_bf16<<<grid, kWarps * 32, smem_rows, stream>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dq), stats, seq, logit_scale, scale,
      attn::vec_ok(seq, k) && attn::vec_ok(seq, v));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_cols_bf16<<<grid, kWarps * 32, smem_cols, stream>>>(
      qp, kp, vp, gp, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      seq, logit_scale, scale, attn::vec_ok(seq, q) && attn::vec_ok(seq, g));
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, float* stats, int n, int seq,
               float logit_scale, float scale, cudaStream_t stream) {
  const size_t smem_rows = 2 * static_cast<size_t>(kD) * seq * sizeof(float);
  const size_t smem_cols = 3 * static_cast<size_t>(seq) * sizeof(float) +
                           3 * static_cast<size_t>(kD) * seq * sizeof(float);
  static size_t opted_rows = 48 * 1024, opted_cols = 48 * 1024;
  cudaError_t err = attn::opt_in(attention_bwd_rows_f32, smem_rows, &opted_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attn::opt_in(attention_bwd_cols_f32, smem_cols, &opted_cols);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  const dim3 grid(n, (seq + kThreads32 - 1) / kThreads32);
  attention_bwd_rows_f32<<<grid, kThreads32, smem_rows, stream>>>(
      qp, kp, vp, gp, static_cast<float*>(dq), stats, seq, logit_scale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_cols_f32<<<grid, kThreads32, smem_cols, stream>>>(
      qp, kp, vp, gp, stats, static_cast<float*>(dk), static_cast<float*>(dv),
      seq, logit_scale, scale);
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
    return launch_f32(q, k, v, g, dq, dk, dv, ws, n, seq, logit_scale, scale, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, g, dq, dk, dv, ws, n, seq, logit_scale, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
