// Block-diagonal multi-head attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `blockdiag_mha_bwd` (fdtpu/kernels/blockdiag_attention.py,
// `_bd_bwd_kernel`).  Contract, per (batch b, head h), with q (B, T, D) merged heads,
// k (B, H, Dh, T) transposed keys, v (B, H, T, Dh) and g (B, T, D) the cotangent of the
// forward's merged output:
//
//     W  = softmax(q_h k_h * scale)          recomputed, always shifted by the row max
//     dW = g_h v_hᵀ                          r_i = Σ_j W_ij dW_ij
//     dS = W ⊙ (dW − r) * scale
//     dq_h = dS k_hᵀ     dk_h = q_hᵀ dS  (in the (Dh, T) layout)     dv_h = Wᵀ g_h
//
// with scale = 1/sqrt(Dh) and every score, exp, sum and product accumulated in float32.
// Outputs dq (B, T, D), dk (B, H, Dh, T), dv (B, H, T, Dh) are in the input type (float32
// or bfloat16); for bfloat16, dS and W are rounded to bfloat16 before the three products,
// as the TPU kernel casts them to the input type.  The row max is over the real keys, as
// the TPU kernel's backward masks its padded columns to -inf.
//
// Design: two launches and no atomics, so the result is deterministic.
//   * Row pass, one block per (b, h, tile of 64 query rows), 8 warps, K and V of the
//     (b, h) staged in shared memory as float32 (Dh, T) exactly as the forward kernel
//     does.  A warp takes one query row at a time; its lanes stride over the keys three
//     times: the row max m_i; then l_i = Σ exp(s_ij − m_i) and Σ exp(s_ij − m_i) dW_ij,
//     which give r_i; then dq_i = Σ_j dS_ij k_j.  Warp shuffles reduce each pass.  The row
//     statistics (m_i, 1/l_i, r_i) go to float32 scratch (3, B, H, T) for the next pass.
//   * Column pass, one block per (b, h, tile of 64 keys), 8 warps, q_h and g_h of the
//     (b, h) staged in shared memory as float32 (Dh, T).  A warp takes one key j at a
//     time; its lanes stride over the query rows, recompute W_ij and dS_ij from the row
//     statistics (read from scratch, consecutive lanes on consecutive rows) and
//     accumulate dv_j = Σ_i W_ij g_i and dk_j = Σ_i dS_ij q_i.
//   Keeping dq in one pass and dk/dv in the other is what removes the atomics: each
//   output element is summed by one warp.  Both passes stage 2·Dh·T floats, the forward's
//   shared-memory footprint, so this kernel takes every T the forward takes.
//
// What bounds it on an H100: at the training shape (B=64, T=187, H=12, Dh=6) one call
// needs 10*B*H*T^2*Dh = 1.61 GFLOP of float32 multiply-add (five products) and B*H*T^2 =
// 26.9M exps, and moves 24.1 MB (q, k, v, g read, dq, dk, dv written): operations bound
// it, at 0.024 ms (PERF.md).  Dh = 6 fits no tensor-core tile, so this kernel uses the
// CUDA cores and recomputes the scores three times in the row pass and once in the
// column pass; a single fused pass and wgmma/TMA are for a later redesign.
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes);
// both launches run on the caller's stream, in order; nothing is allocated here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The value the TPU kernel multiplies with after casting to the input type.
__device__ __forceinline__ float as_input(float x, const float*) { return x; }
__device__ __forceinline__ float as_input(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
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

template <int MAXDH>
__device__ __forceinline__ float dot_col(const float (&a)[MAXDH], const float* cols, int head_dim,
                                         int seq, int j) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < MAXDH; ++d)
    if (d < head_dim) s = fmaf(a[d], cols[d * seq + j], s);
  return s;
}

// Row pass: dq and the row statistics (m, 1/l, r).
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads)
    blockdiag_mha_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                           float* __restrict__ stats, int batch, int seq, int n_head,
                           int head_dim, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                   // (Dh, T): ks[d * seq + j] = k[b, h, d, j]
  float* vs = smem + head_dim * seq;  // (Dh, T): vs[d * seq + j] = v[b, h, j, d]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d_model = n_head * head_dim;
  const size_t kv_offset = ((size_t)b * n_head + h) * (size_t)head_dim * seq;
  const T* kbh = k + kv_offset;
  const T* vbh = v + kv_offset;
  for (int i = threadIdx.x; i < head_dim * seq; i += kThreads) {
    ks[i] = load_f32(kbh + i);
    const int j = i / head_dim;
    const int d = i - j * head_dim;
    vs[d * seq + j] = load_f32(vbh + i);
  }
  __syncthreads();

  const size_t plane = (size_t)batch * n_head * seq;  // one statistic for every (b, h, i)
  float* stat_row = stats + ((size_t)b * n_head + h) * seq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int row = row0 + r;
    if (row >= seq) break;  // uniform across the warp
    const size_t io = ((size_t)b * seq + row) * d_model + (size_t)h * head_dim;
    float qr[MAXDH], gr[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) {
      qr[d] = d < head_dim ? load_f32(q + io + d) : 0.f;
      gr[d] = d < head_dim ? load_f32(g + io + d) : 0.f;
    }

    float m = -INFINITY;
    for (int j = lane; j < seq; j += 32) m = fmaxf(m, dot_col(qr, ks, head_dim, seq, j) * scale);
    m = warp_max(m);

    float l = 0.f, pdw = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float p = expf(dot_col(qr, ks, head_dim, seq, j) * scale - m);
      l += p;
      pdw = fmaf(p, dot_col(gr, vs, head_dim, seq, j), pdw);
    }
    const float inv_l = 1.f / warp_sum(l);
    const float rsum = warp_sum(pdw) * inv_l;

    float acc[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) acc[d] = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float w = expf(dot_col(qr, ks, head_dim, seq, j) * scale - m) * inv_l;
      const float ds = as_input(w * (dot_col(gr, vs, head_dim, seq, j) - rsum) * scale, q);
#pragma unroll
      for (int d = 0; d < MAXDH; ++d)
        if (d < head_dim) acc[d] = fmaf(ds, ks[d * seq + j], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) {
      if (d < head_dim) {
        const float a = warp_sum(acc[d]);
        if (lane == d) store_f32(dq + io + d, a);
      }
    }
    if (lane == 0) {
      stat_row[row] = m;
      stat_row[plane + row] = inv_l;
      stat_row[2 * plane + row] = rsum;
    }
  }
}

// Column pass: dk and dv from the row statistics.
template <typename T, int MAXDH>
__global__ void __launch_bounds__(kThreads)
    blockdiag_mha_bwd_cols(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dk,
                           T* __restrict__ dv, const float* __restrict__ stats, int batch,
                           int seq, int n_head, int head_dim, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // (Dh, T): qs[d * seq + i] = q[b, i, h*Dh + d]
  float* gs = smem + head_dim * seq;  // (Dh, T): gs[d * seq + i] = g[b, i, h*Dh + d]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d_model = n_head * head_dim;
  const T* qb = q + (size_t)b * seq * d_model + (size_t)h * head_dim;
  const T* gb = g + (size_t)b * seq * d_model + (size_t)h * head_dim;
  for (int idx = threadIdx.x; idx < head_dim * seq; idx += kThreads) {
    const int i = idx / head_dim;
    const int d = idx - i * head_dim;
    qs[d * seq + i] = load_f32(qb + (size_t)i * d_model + d);
    gs[d * seq + i] = load_f32(gb + (size_t)i * d_model + d);
  }
  __syncthreads();

  const size_t plane = (size_t)batch * n_head * seq;
  const float* m_row = stats + ((size_t)b * n_head + h) * seq;
  const float* inv_l_row = m_row + plane;
  const float* r_row = m_row + 2 * plane;
  const size_t kv_offset = ((size_t)b * n_head + h) * (size_t)head_dim * seq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kRowsPerBlock;
  for (int c = warp; c < kRowsPerBlock; c += kWarps) {
    const int col = col0 + c;
    if (col >= seq) break;  // uniform across the warp
    float kc[MAXDH], vc[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) {
      kc[d] = d < head_dim ? load_f32(k + kv_offset + (size_t)d * seq + col) : 0.f;
      vc[d] = d < head_dim ? load_f32(v + kv_offset + (size_t)col * head_dim + d) : 0.f;
    }
    float dk_acc[MAXDH], dv_acc[MAXDH];
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) dk_acc[d] = dv_acc[d] = 0.f;
    for (int i = lane; i < seq; i += 32) {
      const float w = expf(dot_col(kc, qs, head_dim, seq, i) * scale - m_row[i]) * inv_l_row[i];
      const float ds = as_input(w * (dot_col(vc, gs, head_dim, seq, i) - r_row[i]) * scale, q);
      const float wc = as_input(w, q);
#pragma unroll
      for (int d = 0; d < MAXDH; ++d) {
        if (d < head_dim) {
          dk_acc[d] = fmaf(ds, qs[d * seq + i], dk_acc[d]);
          dv_acc[d] = fmaf(wc, gs[d * seq + i], dv_acc[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < MAXDH; ++d) {
      if (d < head_dim) {
        const float a = warp_sum(dk_acc[d]);
        const float e = warp_sum(dv_acc[d]);
        if (lane == d) {
          store_f32(dk + kv_offset + (size_t)d * seq + col, a);
          store_f32(dv + kv_offset + (size_t)col * head_dim + d, e);
        }
      }
    }
  }
}

template <typename T, int MAXDH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, float* stats, int batch, int seq, int n_head,
                   int head_dim, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)head_dim * seq;
  auto rows = blockdiag_mha_bwd_rows<T, MAXDH>;
  auto cols = blockdiag_mha_bwd_cols<T, MAXDH>;
  if (smem > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq + kRowsPerBlock - 1) / kRowsPerBlock, n_head, batch);
  const float scale = 1.0f / sqrtf((float)head_dim);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  rows<<<grid, kThreads, smem, stream>>>(qt, kt, vt, gt, static_cast<T*>(dq), stats, batch, seq,
                                         n_head, head_dim, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<grid, kThreads, smem, stream>>>(qt, kt, vt, gt, static_cast<T*>(dk), static_cast<T*>(dv),
                                         stats, batch, seq, n_head, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const void* g,
                              void* dq, void* dk, void* dv, float* stats, int batch, int seq,
                              int n_head, int head_dim, cudaStream_t stream) {
  if (head_dim <= 8)
    return launch<T, 8>(q, k, v, g, dq, dk, dv, stats, batch, seq, n_head, head_dim, stream);
  if (head_dim <= 16)
    return launch<T, 16>(q, k, v, g, dq, dk, dv, stats, batch, seq, n_head, head_dim, stream);
  if (head_dim <= 32)
    return launch<T, 32>(q, k, v, g, dq, dk, dv, stats, batch, seq, n_head, head_dim, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `stats` is float32 scratch of 3*B*H*T elements.
// `device` is the CUDA ordinal the tensors live on.  Returns the cudaError_t of the
// launches (0 = success).  The caller checks shapes, contiguity and shared-memory size.
extern "C" int fdtpu_blockdiag_mha_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv, void* stats,
                                       int dtype, int batch, int seq, int n_head, int head_dim,
                                       int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, g, dq, dk, dv, st, batch, seq, n_head,
                                         head_dim, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, batch, seq, n_head,
                                                 head_dim, s);
  return (int)cudaErrorInvalidValue;
}
