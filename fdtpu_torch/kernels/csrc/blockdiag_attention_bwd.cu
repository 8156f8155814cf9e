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
// What bounds it on an H100: at the training shape (B=64, T=187, H=12, Dh=6) one call
// needs 10*B*H*T^2*Dh = 1.61 GFLOP of float32 multiply-add (five products) and B*H*T^2 =
// 26.9M exps, and moves 24.1 MB (q, k, v, g read, dq, dk, dv written): operations bound
// it, at 0.024 ms (PERF.md).  Dh = 6 fits no tensor-core tile and plain TF32 misses the
// float32 tolerance, so it runs on the CUDA cores.
//
// Design: one launch, one block per (b, h), no atomics, no shuffles; each output element
// is summed by one thread in a fixed order, so the result is deterministic.
//   * Phase 1, a thread per query row (192 threads cover T = 187): q_i pre-scaled by
//     log2(e)/sqrt(Dh) and g_i in registers; K and V staged as records [k | v]
//     (blockdiag_common.cuh), read as broadcasts of 16-byte vectors.  One pass over the
//     keys finds the row max m_i, l_i = Σ exp2(s_ij − m_i) and Σ exp2(s_ij − m_i) dW_ij
//     with an online rescale once per chunk of 8 keys (two dot products a pair); a second
//     pass accumulates dq_i = Σ_j dS_ij k_j.  The statistics (m_i, 1/l_i, r_i) go to
//     shared memory.
//   * Phase 2, after a barrier, a thread per key: k_j and v_j in registers; q (pre-scaled
//     as in phase 1, so s_ij is the same float) and g staged as records [q | g]; the
//     thread walks the rows, reads the statistics as broadcasts, and accumulates
//     dk_j = Σ_i dS_ij q_i and dv_j = Σ_i W_ij g_i.
//   exp2 on the pre-scaled scores throughout, through ex2.approx.ftz: every exponent is
//   relative to the row max, so a flushed weight is under 2^-126 of the largest one.
//   Where T exceeds a tile (256 records at Dh <= 8, 16 KB), keys and rows stream through
//   the two tile buffers; a buffer that already holds the tile it needs is not staged
//   again, so at T = 187 each of q, k, v, g is staged once.  The statistics take 12 bytes
//   a row in shared memory; only where they and the two tiles overflow it (T > 16,640 at
//   any Dh) does the launch keep them in the caller's float32 (B, H, 3, T) scratch in
//   device memory instead, written and read back by the same block.
//
// Built with nvcc into a shared library with a plain C interface (loaded with ctypes);
// the kernel runs on the caller's stream, does not synchronize and allocates nothing.

#include "blockdiag_common.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // bytes of shared memory a Hopper block may use

// The value the TPU kernel multiplies with after casting to the input type.
__device__ __forceinline__ float as_input(float x, const float*) { return x; }
__device__ __forceinline__ float as_input(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// One (b, h)'s operands and the two tile buffers, each remembering the tile it holds.
template <typename T, int DH>
struct Head {
  const T *q, *k, *v, *g;  // q, g at row 0 of the head; k, v at the head's slab
  int seq, head_dim, d_model;
  float q_scale;
  float* keys;  // records [k_j | v_j]
  float* rows;  // records [q_j * q_scale | g_j]
  int keys_at = -1, rows_at = -1;

  // Make `keys` hold keys [j0, j0 + n); the caller has passed a barrier since their last use.
  __device__ __forceinline__ bool stage_keys(int j0, int n) {
    if (keys_at == j0) return false;
    stage<T, DH>(keys, n, head_dim, k + j0, 1, (size_t)seq, 1.f, v + (size_t)j0 * head_dim,
                 (size_t)head_dim, 1);
    keys_at = j0;
    return true;
  }
  __device__ __forceinline__ bool stage_rows(int i0, int n) {
    if (rows_at == i0) return false;
    const size_t at = (size_t)i0 * d_model;
    stage<T, DH>(rows, n, head_dim, q + at, (size_t)d_model, 1, q_scale, g + at,
                 (size_t)d_model, 1);
    rows_at = i0;
    return true;
  }
};

// Phase 1, pass 1: C keys into the row's online (max, sum, Σ p·dW).
template <int DH, int C>
__device__ __forceinline__ void row_stats(const float* rec, const float (&qr)[DH],
                                          const float (&gr)[DH], float& m, float& l,
                                          float& pdw) {
  constexpr int SD = Width<DH>::SD, E = Width<DH>::E;
  float s[C], dw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float kc[DH], vc[DH];
    load_vec<DH>(rec + c * E, kc);
    load_vec<DH>(rec + c * E + SD, vc);
    s[c] = dot<DH>(qr, kc);
    dw[c] = dot<DH>(gr, vc);
  }
  float mx = m;
#pragma unroll
  for (int c = 0; c < C; ++c) mx = fmaxf(mx, s[c]);
  const float corr = exp2_<true>(m - mx);  // 0 on the first chunk (m = -inf)
  m = mx;
  l *= corr;
  pdw *= corr;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float p = exp2_<true>(s[c] - mx);
    l += p;
    pdw = fmaf(p, dw[c], pdw);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxThreads)
    blockdiag_mha_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ scratch, int seq, int n_head, int head_dim,
                             float q_scale, float ds_scale) {
  constexpr int SD = Width<DH>::SD, E = Width<DH>::E, C = Width<DH>::C;
  constexpr int KT = tile<DH>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int buf = min(seq, KT);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nt = blockDim.x;
  const int d_model = n_head * head_dim;
  const size_t bh = (size_t)b * n_head + h;
  const size_t kv_offset = bh * (size_t)head_dim * seq;
  const size_t io = (size_t)b * seq * d_model + (size_t)h * head_dim;
  Head<T, DH> hd{q + io, k + kv_offset, v + kv_offset, g + io, seq, head_dim, d_model, q_scale,
                 smem, smem + (size_t)buf * E};
  // Row statistics: m (log2 units), 1/l, r.
  float* st = scratch ? scratch + bh * 3 * seq : smem + (size_t)2 * buf * E;
  float* st_m = st;
  float* st_il = st + seq;
  float* st_r = st + 2 * seq;

  // Phase 1: dq and the row statistics, a row a thread.
  for (int r0 = 0; r0 < seq; r0 += nt) {
    const int row = r0 + threadIdx.x;
    const size_t at = (size_t)min(row, seq - 1) * d_model;
    float qr[DH], gr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[d] = d < head_dim ? load_f32(hd.q + at + d) * q_scale : 0.f;
      gr[d] = d < head_dim ? load_f32(hd.g + at + d) : 0.f;
    }
    float m = -INFINITY, l = 0.f, pdw = 0.f;
    for (int j0 = 0; j0 < seq; j0 += KT) {
      const int n = min(KT, seq - j0);
      __syncthreads();
      if (hd.stage_keys(j0, n)) __syncthreads();
      int j = 0;
      for (; j + C <= n; j += C) row_stats<DH, C>(hd.keys + (size_t)j * E, qr, gr, m, l, pdw);
      for (; j < n; ++j) row_stats<DH, 1>(hd.keys + (size_t)j * E, qr, gr, m, l, pdw);
    }
    const float il = 1.f / l;
    const float rs = pdw * il;
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j0 = 0; j0 < seq; j0 += KT) {
      const int n = min(KT, seq - j0);
      __syncthreads();
      if (hd.stage_keys(j0, n)) __syncthreads();
      for (int j = 0; j < n; ++j) {
        float kc[DH], vc[DH];
        load_vec<DH>(hd.keys + (size_t)j * E, kc);
        load_vec<DH>(hd.keys + (size_t)j * E + SD, vc);
        const float w = exp2_<true>(dot<DH>(qr, kc) - m) * il;
        const float ds = as_input(w * (dot<DH>(gr, vc) - rs) * ds_scale, q);
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, kc[d], acc[d]);
      }
    }
    if (row < seq) {
      T* out = dq + io + (size_t)row * d_model;
#pragma unroll
      for (int d = 0; d < DH; ++d)
        if (d < head_dim) store_f32(out + d, acc[d]);
      st_m[row] = m;
      st_il[row] = il;
      st_r[row] = rs;
    }
  }

  // Phase 2: dk and dv, a key a thread.
  const float inv_q_scale = 1.f / q_scale;  // the staged q is pre-scaled
  for (int c0 = 0; c0 < seq; c0 += nt) {
    const int key = c0 + threadIdx.x;
    const int j = min(key, seq - 1);
    float kc[DH], vc[DH], dk_acc[DH], dv_acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      kc[d] = d < head_dim ? load_f32(hd.k + (size_t)d * seq + j) : 0.f;
      vc[d] = d < head_dim ? load_f32(hd.v + (size_t)j * head_dim + d) : 0.f;
      dk_acc[d] = dv_acc[d] = 0.f;
    }
    for (int i0 = 0; i0 < seq; i0 += KT) {
      const int n = min(KT, seq - i0);
      __syncthreads();  // the statistics are written; the buffer's last readers are done
      if (hd.stage_rows(i0, n)) __syncthreads();
      for (int i = 0; i < n; ++i) {
        float qi[DH], gi[DH];
        load_vec<DH>(hd.rows + (size_t)i * E, qi);
        load_vec<DH>(hd.rows + (size_t)i * E + SD, gi);
        const float w = exp2_<true>(dot<DH>(kc, qi) - st_m[i0 + i]) * st_il[i0 + i];
        const float ds = as_input(w * (dot<DH>(vc, gi) - st_r[i0 + i]) * ds_scale, q);
        const float wc = as_input(w, q);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk_acc[d] = fmaf(ds, qi[d], dk_acc[d]);
          dv_acc[d] = fmaf(wc, gi[d], dv_acc[d]);
        }
      }
    }
    if (key < seq) {
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        if (d < head_dim) {
          store_f32(dk + kv_offset + (size_t)d * seq + key, dk_acc[d] * inv_q_scale);
          store_f32(dv + kv_offset + (size_t)key * head_dim + d, dv_acc[d]);
        }
      }
    }
  }
}

// Bytes of shared memory the kernel takes; with `stats_in_smem` the statistics are in it.
template <int DH>
size_t smem_bytes(int seq, bool stats_in_smem) {
  const size_t bufs = 2 * sizeof(float) * Width<DH>::E * (size_t)min(seq, tile<DH>());
  return bufs + (stats_in_smem ? 3 * sizeof(float) * (size_t)seq : 0);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, float* scratch, int batch, int seq, int n_head,
                   int head_dim, cudaStream_t stream) {
  // The statistics stay in shared memory where they fit; else in the caller's scratch.
  const bool stats_in_smem = smem_bytes<DH>(seq, true) <= kMaxSmem;
  const size_t smem = smem_bytes<DH>(seq, stats_in_smem);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = blockdiag_mha_bwd_kernel<T, DH>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = min(kMaxThreads, (seq + 31) / 32 * 32);
  const dim3 grid(n_head, batch);
  const float q_scale = kLog2e / sqrtf((float)head_dim);
  const float ds_scale = 1.0f / sqrtf((float)head_dim);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      stats_in_smem ? nullptr : scratch, seq, n_head, head_dim, q_scale, ds_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const void* g,
                              void* dq, void* dk, void* dv, float* scratch, int batch, int seq,
                              int n_head, int head_dim, cudaStream_t stream) {
  if (head_dim <= 6)
    return launch<T, 6>(q, k, v, g, dq, dk, dv, scratch, batch, seq, n_head, head_dim, stream);
  if (head_dim <= 8)
    return launch<T, 8>(q, k, v, g, dq, dk, dv, scratch, batch, seq, n_head, head_dim, stream);
  if (head_dim <= 16)
    return launch<T, 16>(q, k, v, g, dq, dk, dv, scratch, batch, seq, n_head, head_dim, stream);
  if (head_dim <= 32)
    return launch<T, 32>(q, k, v, g, dq, dk, dv, scratch, batch, seq, n_head, head_dim, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `scratch` is float32 of 3*B*H*T elements; the kernel
// keeps the row statistics there only where they do not fit in shared memory.  `device` is
// the CUDA ordinal the tensors live on.  Returns the cudaError_t of the launch (0 =
// success).  The caller checks shapes, contiguity and the sequence ceiling.
extern "C" int fdtpu_blockdiag_mha_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv,
                                       void* scratch, int dtype, int batch, int seq, int n_head,
                                       int head_dim, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(scratch);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, g, dq, dk, dv, st, batch, seq, n_head,
                                         head_dim, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, g, dq, dk, dv, st, batch, seq, n_head,
                                                 head_dim, s);
  return (int)cudaErrorInvalidValue;
}
